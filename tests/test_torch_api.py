"""Parity of the port's typed API (`repro_torch.core`: specs, planner,
decoder object, legacy `viterbi_decode` shim) with the JAX package's on the
CPU: the rows of tests/test_api.py for the eight ported methods.

The problem is tests/test_api.py's (Erdos-Renyi, K = 48, T = 96), made by
the JAX package; its numpy arrays go to both packages.  Tolerance: paths and
scores bitwise equal; planner decisions equal field for field, `why` string
included.
"""

import dataclasses
import warnings

import numpy as np
import jax
import pytest
import torch

from repro.core import (ResourceBudget as JBudget, decoder_state_bytes as
                        j_state_bytes, erdos_renyi_hmm as j_er, plan as j_plan,
                        random_emissions as j_rand,
                        viterbi_decode as j_decode)
from repro.core import BandConstraint as JBand
from repro.core import LexiconConstraint as JLexicon
from repro_torch.core import (
    BATCH_METHODS, METHODS, SPEC_BY_METHOD, AssocSpec, BandConstraint,
    BeamStaticMPSpec, BeamStaticSpec, CheckpointSpec, DecodePlan, FlashBSSpec,
    FlashSpec, FusedSpec, LexiconConstraint, ResourceBudget, VanillaSpec,
    ViterbiDecoder, decoder_state_bytes, plan, spec_from_tunables,
    spec_state_bytes, viterbi_decode, viterbi_decode_batch, viterbi_decode_hmm)


# The plain versions run many small ops: one intra-op thread keeps the
# test workers from spinning against each other's JAX compiles.
torch.set_num_threads(1)

@pytest.fixture(scope="module")
def problem():
    """(port tensors (log_pi, log_A, em), the same as numpy arrays)."""
    k1, k2 = jax.random.split(jax.random.key(42))
    hmm = j_er(k1, 48, edge_prob=0.3)
    arrays = tuple(np.array(x) for x in (hmm.log_pi, hmm.log_A,
                                         j_rand(k2, 96, 48)))
    return tuple(torch.from_numpy(x) for x in arrays), arrays


# ---------------------------------------------------------------------------
# specs: registry, validation, hashability
# ---------------------------------------------------------------------------

def test_every_method_has_a_spec():
    """Every method of the JAX package, the streaming two included, has a
    spec whose legacy form and fields equal the JAX spec's."""
    from repro.core import METHODS as J_METHODS
    from repro.core import spec_from_tunables as j_spec_from_tunables
    assert set(SPEC_BY_METHOD) == set(METHODS)
    assert METHODS == tuple(J_METHODS)
    for method, cls in SPEC_BY_METHOD.items():
        assert cls.method == method
        assert dataclasses.is_dataclass(cls)
    for method in ("online", "online_beam"):
        kw = dict(stream_chunk=16, max_lag=8, chunk=32, bt=4)
        spec, ignored = spec_from_tunables(method, kw)
        spec_j, ignored_j = j_spec_from_tunables(method, kw)
        assert type(spec).__name__ == type(spec_j).__name__
        assert dataclasses.asdict(spec) == dataclasses.asdict(spec_j)
        assert ignored == ignored_j


@pytest.mark.parametrize("bad", [
    lambda: FlashSpec(parallelism=0),
    lambda: FlashSpec(parallelism=-2),
    lambda: FlashSpec(lanes=0),
    lambda: FlashBSSpec(beam_width=0),
    lambda: FlashBSSpec(chunk=0),
    lambda: BeamStaticSpec(beam_width=-1),
    lambda: BeamStaticMPSpec(parallelism=0),
    lambda: CheckpointSpec(seg_len=0),
    lambda: FusedSpec(bt=0),
    lambda: ResourceBudget(memory_bytes=0),
    lambda: ResourceBudget(latency_hint="speed"),
])
def test_nonsense_rejected_eagerly(bad):
    with pytest.raises(ValueError):
        bad()


def test_unknown_tunables_fail_loudly():
    with pytest.raises(TypeError):
        VanillaSpec(beam_width=4)
    with pytest.raises(TypeError):
        FlashSpec(beam_width=4)
    with pytest.raises(TypeError):
        FlashBSSpec(seg_len=3)
    with pytest.raises(TypeError):
        AssocSpec(parallelism=2)


def test_specs_hashable_and_frozen():
    a = FlashBSSpec(parallelism=4, beam_width=64)
    b = FlashBSSpec(parallelism=4, beam_width=64)
    c = FlashBSSpec(parallelism=4, beam_width=32)
    assert a == b and hash(a) == hash(b)
    assert a != c
    assert {a: 1, c: 2}[b] == 1          # usable as a cache key
    with pytest.raises(dataclasses.FrozenInstanceError):
        a.beam_width = 16


@pytest.mark.parametrize("method,kw", [
    ("flash", {"parallelism": 4, "beam_width": 9, "seg_len": 2}),
    ("flash_bs", {"chunk": 16, "lanes": None, "bt": 2}),
    ("checkpoint", {"seg_len": 12, "parallelism": 3}),
    ("beam_static_mp", {"beam_width": 16, "chunk": 8}),
    ("assoc", {"lanes": 2}),
])
def test_spec_from_tunables_matches_jax(method, kw):
    from repro.core import spec_from_tunables as j_spec_from_tunables
    spec, ignored = spec_from_tunables(method, kw)
    spec_j, ignored_j = j_spec_from_tunables(method, kw)
    assert type(spec).__name__ == type(spec_j).__name__
    assert dataclasses.asdict(spec) == dataclasses.asdict(spec_j)
    assert set(ignored) == set(ignored_j)
    with pytest.raises(ValueError):
        spec_from_tunables("nope", {})


# ---------------------------------------------------------------------------
# legacy shim: deprecation warning on ignored tunables
# ---------------------------------------------------------------------------

def test_legacy_ignored_tunable_warns(problem):
    (lp, la, em), _ = problem
    with pytest.warns(DeprecationWarning, match="beam_width"):
        viterbi_decode(em, lp, la, method="vanilla", beam_width=8)
    with pytest.warns(DeprecationWarning, match="seg_len"):
        viterbi_decode(em, lp, la, method="flash", parallelism=4, seg_len=10)
    with pytest.raises(TypeError, match="constraint"):
        viterbi_decode(em, lp, la, method="fused",
                       constraint=BandConstraint((0,), 1))


def test_legacy_consumed_tunables_do_not_warn(problem):
    (lp, la, em), _ = problem
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        viterbi_decode(em, lp, la, method="flash_bs", parallelism=4,
                       beam_width=16, chunk=16)


# ---------------------------------------------------------------------------
# planner: cost model and ladder against the JAX planner
# ---------------------------------------------------------------------------

def test_cost_model_matches_jax():
    for method in METHODS + ("online", "online_beam", "sieve", "sieve_mp"):
        for K, T, P, B in ((48, 96, 4, 16), (512, 512, 8, 128),
                           (1024, 4096, 16, 256)):
            assert decoder_state_bytes(method, K, T, P=P, B=B) == \
                j_state_bytes(method, K, T, P=P, B=B), method
    with pytest.raises(ValueError):
        decoder_state_bytes("nope", 8, 8)
    assert (spec_state_bytes(FlashBSSpec(parallelism=2, beam_width=64),
                             512, 512)
            == decoder_state_bytes("flash_bs", 512, 512, P=2, B=64))


def _constraints(T):
    """(port, JAX) constraint pairs: none, a band covering the horizon, a
    band too short for it, a lexicon."""
    centers = tuple(int(c) for c in np.linspace(0, 63, T))
    words = (((0, 1, 2),), ((3, 4),))
    return [(None, None),
            (BandConstraint(centers, 4), JBand(centers, 4)),
            (BandConstraint(centers[:T // 2], 4), JBand(centers[:T // 2], 4)),
            (LexiconConstraint(words), JLexicon(words))]


@pytest.mark.parametrize("K,T", [(64, 128), (512, 512)])
def test_plan_matches_jax_over_a_grid(K, T):
    """The same spec (class and fields), `why` and bytes as the JAX planner
    for every budget, batch, latency hint and constraint of the grid."""
    n = 0
    for c, c_j in _constraints(T) if K == 64 else [(None, None)]:
        for kb in (None, 1 << 14, 1024, 64, 8, 2, 1, 1 / 1024):
            for batch in (None, 8):
                for hint in (None, "latency", "memory"):
                    cap = None if kb is None else int(kb * 1024)
                    p = plan(K, T, ResourceBudget(cap, hint), batch=batch,
                             constraint=c)
                    p_j = j_plan(K, T, JBudget(cap, hint), batch=batch,
                                 constraint=c_j)
                    assert isinstance(p, DecodePlan)
                    assert type(p.spec).__name__ == type(p_j.spec).__name__
                    fields = {f: v for f, v in dataclasses.asdict(
                        p.spec).items() if f != "constraint"}
                    fields_j = {f: v for f, v in dataclasses.asdict(
                        p_j.spec).items() if f != "constraint"}
                    assert fields == fields_j
                    assert (p.spec.constraint is c
                            and p_j.spec.constraint is c_j)
                    assert (p.why, p.state_bytes, p.K, p.T, p.batch) == \
                        (p_j.why, p_j.state_bytes, p_j.K, p_j.T, p_j.batch)
                    n += 1
    assert n >= 48
    assert plan(K, T, 1024).why == j_plan(K, T, 1024).why      # int budget


def test_plan_ladder_rows():
    """The ladder rows of tests/test_api.py."""
    assert plan(512, 512, ResourceBudget(64 * 1024)).spec == \
        FlashSpec(parallelism=8)
    assert plan(512, 512, ResourceBudget(8 * 1024)).spec == \
        FlashSpec(parallelism=1)
    pfloor = plan(512, 512, 1)
    assert pfloor.spec == FlashBSSpec(parallelism=1, beam_width=16)
    assert pfloor.why.startswith("floor") and "exceeds budget" in pfloor.why
    with pytest.raises(ValueError, match="batch"):
        plan(512, 512, 1024, batch=0)
    budgets = [2 ** b for b in range(8, 22)]
    footprints = [plan(512, 512, b).state_bytes for b in budgets]
    assert footprints == sorted(footprints)
    batched = plan(512, 512, 64 * 1024, batch=8)
    assert batched.state_bytes == 8 * spec_state_bytes(batched.spec, 512, 512)
    assert batched.spec.batch_method in BATCH_METHODS
    assert plan(512, 512).spec == FlashSpec(parallelism=16)
    assert plan(512, 512, ResourceBudget(1 << 20, "memory")).spec == \
        FlashSpec(parallelism=1)


# ---------------------------------------------------------------------------
# bit-identity: legacy shim vs ViterbiDecoder vs JAX, every method
# ---------------------------------------------------------------------------

# modest tunables so beams take their real code paths at K = 48
_TUNABLES = {
    "vanilla": {}, "checkpoint": {"seg_len": 12},
    "flash": {"parallelism": 4},
    "flash_bs": {"parallelism": 4, "beam_width": 16, "chunk": 16},
    "beam_static": {"beam_width": 16},
    "beam_static_mp": {"beam_width": 16, "parallelism": 4},
    "assoc": {}, "fused": {},
    "online": {"stream_chunk": 16, "max_lag": 32},
    "online_beam": {"beam_width": 16, "chunk": 16, "stream_chunk": 16},
}


@pytest.mark.parametrize("method", METHODS)
def test_decoder_bit_identical_to_legacy(problem, method):
    """The legacy shim and the decoder run the same spec; the JAX parity of
    each (method, tunables) pair is in tests/test_torch_flash.py and
    tests/test_torch_batch.py."""
    (lp, la, em), _ = problem
    kw = _TUNABLES[method]
    p_legacy, s_legacy = viterbi_decode(em, lp, la, method=method, **kw)
    spec, ignored = spec_from_tunables(method, kw)
    assert not ignored
    dec = ViterbiDecoder(spec, lp, la, device="cpu")
    p_spec, s_spec = dec.decode(em)
    assert torch.equal(p_legacy, p_spec) and float(s_legacy) == float(s_spec)


@pytest.mark.parametrize("method", BATCH_METHODS)
def test_decode_batch_bit_identical_to_legacy_batch(problem, method):
    (lp, la, em), _ = problem
    T = em.shape[0]
    ems = torch.stack([em, em.flip(0), em * 0.5])
    lengths = np.asarray([T, T // 2, T // 3], np.int32)
    kw = _TUNABLES[method]
    p_legacy, s_legacy = viterbi_decode_batch(ems, lp, la, lengths,
                                              method=method, **kw)
    spec, _ = spec_from_tunables(method, kw)
    p_spec, s_spec = ViterbiDecoder(spec, lp, la, device="cpu").decode_batch(
        ems, lengths)
    assert torch.equal(p_legacy, p_spec) and torch.equal(s_legacy, s_spec)


def test_legacy_shim_matches_jax_shim(problem):
    """One method through both packages' shims (the rest: see above)."""
    (lp, la, em), arrays = problem
    p, s = viterbi_decode(em, lp, la, method="flash_bs", parallelism=4,
                          beam_width=16, chunk=16)
    p_j, s_j = j_decode(arrays[2], arrays[0], arrays[1], method="flash_bs",
                        parallelism=4, beam_width=16, chunk=16)
    assert np.array_equal(p.numpy(), np.asarray(p_j))
    assert np.float32(s) == np.float32(s_j)


def test_decode_batch_ragged_matches_single(problem):
    (lp, la, em), _ = problem
    T = em.shape[0]
    dec = ViterbiDecoder(FlashSpec(parallelism=4), lp, la, device="cpu")
    paths, scores = dec.decode_batch(torch.stack([em, em]), [T, T // 2])
    for i, L in enumerate([T, T // 2]):
        p1, s1 = dec.decode(em[:L])
        assert torch.equal(paths[i, :L], p1) and float(scores[i]) == float(s1)


def test_decode_batch_rejects_unbatchable_spec(problem):
    (lp, la, em), _ = problem
    for spec in (AssocSpec(), CheckpointSpec(), BeamStaticSpec(),
                 BeamStaticMPSpec()):
        dec = ViterbiDecoder(spec, lp, la, device="cpu")
        with pytest.raises(ValueError, match="no batched path"):
            dec.decode_batch(em[None])


def test_decode_hmm_shim():
    from repro_torch.core import erdos_renyi_hmm, sample_observations
    hmm = erdos_renyi_hmm(np.random.default_rng(3), 12, 6, device="cpu")
    _, obs = sample_observations(np.random.default_rng(4), hmm, 20)
    p, s = viterbi_decode_hmm(obs, hmm, method="flash", parallelism=2)
    p_v, s_v = viterbi_decode(hmm.emissions(obs), hmm.log_pi, hmm.log_A,
                              method="vanilla")
    assert float(s) == float(s_v) and p.shape == (20,)
