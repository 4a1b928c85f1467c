"""Parity of the port's core (`repro_torch.core`: HMM substrate, numpy
reference, vanilla, batch, specs, decoder) with the JAX package's on the CPU.

The batch cases are the `vanilla` and `fused` cases of tests/test_batch.py.
Inputs are made with numpy from a seed and handed to both packages.
Tolerance: paths and scores are bitwise equal to JAX's, except where the JAX
test itself compares scores with rtol=1e-6 (path_score's sums), which is
kept.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import (ViterbiDecoder as JDecoder, FusedSpec as JFused,
                        VanillaSpec as JVanilla, path_score as j_path_score,
                        spec_from_tunables as j_spec_from_tunables,
                        viterbi_decode_batch as j_decode_batch,
                        viterbi_vanilla as j_vanilla,
                        viterbi_vanilla_masked as j_vanilla_masked)
from repro.core import reference as j_reference
from repro_torch.core import (HMM, NEG_INF, BATCH_METHODS, BandConstraint,
                              FlashBSSpec, FusedSpec,
                              ResourceBudget, VanillaSpec, ViterbiDecoder,
                              as_decode_spec, erdos_renyi_hmm,
                              left_to_right_hmm, path_score, random_emissions,
                              relative_error, sample_observations,
                              spec_from_tunables, viterbi_decode_batch,
                              viterbi_vanilla, viterbi_vanilla_batched,
                              viterbi_vanilla_masked)
from repro_torch.core import reference

CPU = torch.device("cpu")
K, TMAX = 32, 40
LENGTHS = np.array([TMAX, 17, 1, 33, TMAX], np.int32)  # ragged incl. T=1, max
SPECS = {"vanilla": (VanillaSpec, JVanilla), "fused": (FusedSpec, JFused)}


@pytest.fixture(scope="module")
def batch_problem():
    g = np.random.default_rng(123)
    hmm = erdos_renyi_hmm(g, K, edge_prob=0.4, device=CPU)
    em = random_emissions(g, len(LENGTHS) * TMAX, K, device=CPU).reshape(
        len(LENGTHS), TMAX, K)
    return hmm, em


def _np(hmm):
    return hmm.log_pi.numpy(), hmm.log_A.numpy()


def _assert_matches_jax_and_loop(hmm, em, lengths, method):
    paths, scores = viterbi_decode_batch(em, hmm.log_pi, hmm.log_A, lengths,
                                         method=method)
    assert paths.shape == em.shape[:2] and paths.dtype == torch.int32
    assert scores.shape == (em.shape[0],)
    lp, la = _np(hmm)
    paths_j, scores_j = j_decode_batch(em.numpy(), lp, la,
                                       jnp.asarray(lengths), method=method)
    assert np.array_equal(paths.numpy(), np.asarray(paths_j)), method
    assert np.array_equal(scores.numpy(), np.asarray(scores_j)), method
    spec = SPECS[method][0]()
    for i, L in enumerate(lengths):
        p, s = spec.run(hmm.log_pi, hmm.log_A, em[i, :int(L)])
        assert torch.equal(paths[i, :int(L)], p), (method, i)
        assert float(scores[i]) == float(s), (method, i)


# ---------------------------------------------------------------------------
# batch (cases of tests/test_batch.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["vanilla", "fused"])
def test_batch_matches_jax_and_loop_ragged(batch_problem, method):
    hmm, em = batch_problem
    _assert_matches_jax_and_loop(hmm, em, LENGTHS, method)


@pytest.mark.parametrize("method", ["vanilla", "fused"])
def test_batch_all_equal_lengths_and_default(batch_problem, method):
    hmm, em = batch_problem
    equal = np.full((em.shape[0],), TMAX, np.int32)
    _assert_matches_jax_and_loop(hmm, em, equal, method)
    p0, s0 = viterbi_decode_batch(em, hmm.log_pi, hmm.log_A, method=method)
    p1, s1 = viterbi_decode_batch(em, hmm.log_pi, hmm.log_A, equal,
                                  method=method)
    assert torch.equal(p0, p1) and torch.equal(s0, s1)


@pytest.mark.parametrize("method", ["vanilla", "fused"])
def test_batch_T1_edge(batch_problem, method):
    hmm, em = batch_problem
    em1 = em[:, :1]
    paths, scores = viterbi_decode_batch(em1, hmm.log_pi, hmm.log_A,
                                         method=method)
    lp, la = _np(hmm)
    for i in range(em1.shape[0]):
        p, s = j_vanilla(lp, la, em1[i].numpy())
        assert np.array_equal(paths[i].numpy(), np.asarray(p))
        assert float(scores[i]) == float(s)


def test_batch_pad_tail_repeats_final_state(batch_problem):
    hmm, em = batch_problem
    paths, _ = viterbi_decode_batch(em, hmm.log_pi, hmm.log_A, LENGTHS,
                                    method="fused")
    for i, L in enumerate(LENGTHS):
        assert torch.all(paths[i, int(L):] == paths[i, int(L) - 1])


def test_batch_unknown_method_raises(batch_problem):
    hmm, em = batch_problem
    with pytest.raises(ValueError):
        viterbi_decode_batch(em, hmm.log_pi, hmm.log_A, method="nope")


@pytest.mark.parametrize("kw", [dict(method="flash"), dict(method="flash_bs"),
                                dict(mesh=object()),
                                dict(method="flash",
                                     constraint=BandConstraint((0,), 1))])
def test_batch_unported_paths_raise(batch_problem, kw):
    """A `mesh` that is not a `core.mesh.Mesh` raises TypeError, before
    anything is decoded (the sharded route itself is held to the unsharded
    call in tests/test_torch_distributed.py).  The other three cases raised
    until FLASH and FLASH-BS were ported; each is now held to the JAX batch,
    bitwise (a one-step band from the same arguments on both sides)."""
    hmm, em = batch_problem
    if "mesh" in kw:
        with pytest.raises(TypeError, match="core.mesh.Mesh"):
            viterbi_decode_batch(em, hmm.log_pi, hmm.log_A, **kw)
        assert set(BATCH_METHODS) == {"vanilla", "flash", "flash_bs", "fused"}
        return
    from repro.core import BandConstraint as JBand
    j_kw = dict(kw)
    if "constraint" in kw:
        j_kw["constraint"] = JBand(kw["constraint"].centers,
                                   kw["constraint"].width)
    paths, scores = viterbi_decode_batch(em, hmm.log_pi, hmm.log_A, LENGTHS,
                                         **kw)
    lp, la = _np(hmm)
    paths_j, scores_j = j_decode_batch(em.numpy(), lp, la,
                                       jnp.asarray(LENGTHS), **j_kw)
    assert np.array_equal(paths.numpy(), np.asarray(paths_j)), kw
    assert np.array_equal(scores.numpy(), np.asarray(scores_j)), kw


@pytest.mark.parametrize("method,kw", [
    ("flash", dict(parallelism=3, lanes=None)),
    ("flash_bs", dict(beam_width=8, parallelism=4, chunk=12)),
])
def test_batch_flash_methods_match_jax_ragged(batch_problem, method, kw):
    """Ragged FLASH and FLASH-BS batches (lengths include 1 and T) against
    JAX's, bitwise; exact FLASH also against the looped single decode."""
    hmm, em = batch_problem
    paths, scores = viterbi_decode_batch(em, hmm.log_pi, hmm.log_A, LENGTHS,
                                         method=method, **kw)
    lp, la = _np(hmm)
    paths_j, scores_j = j_decode_batch(em.numpy(), lp, la,
                                       jnp.asarray(LENGTHS), method=method,
                                       **kw)
    assert np.array_equal(paths.numpy(), np.asarray(paths_j))
    assert np.array_equal(scores.numpy(), np.asarray(scores_j))
    if method == "flash":
        for i, L in enumerate(LENGTHS):
            p, s = viterbi_vanilla(hmm.log_pi, hmm.log_A, em[i, :int(L)])
            assert torch.equal(paths[i, :int(L)], p) and float(scores[i]) == \
                float(s)


def test_batch_rejects_a_constraint_that_is_not_one(batch_problem):
    hmm, em = batch_problem
    with pytest.raises(TypeError, match="ConstraintSpec"):
        viterbi_decode_batch(em, hmm.log_pi, hmm.log_A, constraint=object())


@pytest.mark.parametrize("name", ["parallelism", "lanes", "beam_width",
                                  "chunk", "data_axis"])
def test_batch_rejects_unported_tunables(batch_problem, name):
    """As in the JAX package, the FLASH and FLASH-BS tunables change nothing
    for `fused`, and `data_axis` without a `mesh` changes nothing (JAX's
    call takes it and ignores it), bitwise against JAX's call too."""
    hmm, em = batch_problem
    value = "model" if name == "data_axis" else 4
    base = viterbi_decode_batch(em, hmm.log_pi, hmm.log_A, LENGTHS)
    out = viterbi_decode_batch(em, hmm.log_pi, hmm.log_A, LENGTHS,
                               **{name: value})
    assert torch.equal(base[0], out[0]) and torch.equal(base[1], out[1])
    if name == "data_axis":
        lp, la = _np(hmm)
        paths_j, scores_j = j_decode_batch(em.numpy(), lp, la,
                                           jnp.asarray(LENGTHS),
                                           data_axis=value)
        assert np.array_equal(out[0].numpy(), np.asarray(paths_j))
        assert np.array_equal(out[1].numpy(), np.asarray(scores_j))


@pytest.mark.parametrize("bad", [[0, 17, 33, 1, 5], [1, TMAX + 1, 3, 4, 5],
                                 [-2, 1, 1, 1, 1]])
@pytest.mark.parametrize("method", ["vanilla", "fused"])
def test_batch_lengths_out_of_range_raise(batch_problem, bad, method):
    hmm, em = batch_problem
    with pytest.raises(ValueError, match="lengths must lie"):
        viterbi_decode_batch(em, hmm.log_pi, hmm.log_A,
                             np.asarray(bad, np.int32), method=method)


@pytest.mark.parametrize("method", ["vanilla", "fused"])
def test_batch_pad_frames_do_not_leak(batch_problem, method):
    hmm, em = batch_problem
    dirty = em.clone()
    for i, L in enumerate(LENGTHS):
        dirty[i, int(L):] = 1e3
    clean = viterbi_decode_batch(em, hmm.log_pi, hmm.log_A, LENGTHS,
                                 method=method)
    dirt = viterbi_decode_batch(dirty, hmm.log_pi, hmm.log_A, LENGTHS,
                                method=method)
    assert torch.equal(clean[0], dirt[0]) and torch.equal(clean[1], dirt[1])


# ---------------------------------------------------------------------------
# vanilla oracles and the numpy reference copy
# ---------------------------------------------------------------------------

def test_vanilla_matches_jax(batch_problem):
    hmm, em = batch_problem
    lp, la = _np(hmm)
    p, s = viterbi_vanilla(hmm.log_pi, hmm.log_A, em[0])
    p_j, s_j = j_vanilla(lp, la, em[0].numpy())
    assert p.dtype == torch.int32
    assert np.array_equal(p.numpy(), np.asarray(p_j)) and float(s) == float(s_j)
    pad = torch.arange(TMAX) >= 17
    p, s = viterbi_vanilla_masked(hmm.log_pi, hmm.log_A, em[1], pad)
    p_j, s_j = j_vanilla_masked(lp, la, em[1].numpy(), pad.numpy())
    assert np.array_equal(p.numpy(), np.asarray(p_j)) and float(s) == float(s_j)
    ps, ss = viterbi_vanilla_batched(hmm.log_pi, hmm.log_A, em[:2])
    assert torch.equal(ps[0], viterbi_vanilla(hmm.log_pi, hmm.log_A, em[0])[0])
    assert ss.shape == (2,)


def test_reference_copy_matches_jax_and_brute_force():
    g = np.random.default_rng(9)
    lp, la = (g.standard_normal(4).astype(np.float32),
              g.standard_normal((4, 4)).astype(np.float32))
    em = g.standard_normal((5, 4)).astype(np.float32)
    p, s = reference.viterbi_numpy(lp, la, em)
    p_j, s_j = j_reference.viterbi_numpy(lp, la, em)
    assert np.array_equal(p, p_j) and s == s_j
    p_b, s_b = reference.brute_force(lp, la, em)
    assert np.array_equal(p, p_b)
    np.testing.assert_allclose(s, s_b, rtol=1e-5)
    assert reference.path_score_numpy(lp, la, em, p) == \
        j_reference.path_score_numpy(lp, la, em, p)


# ---------------------------------------------------------------------------
# HMM substrate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", ["erdos_renyi", "left_to_right"])
def test_generators_are_row_stochastic_and_seeded(make):
    def build(rng):
        if make == "erdos_renyi":
            return erdos_renyi_hmm(rng, 24, 10, edge_prob=0.2, device=CPU)
        return left_to_right_hmm(rng, 24, 10, device=CPU)

    hmm = build(np.random.default_rng(0))
    assert hmm.num_states == 24 and hmm.num_obs == 10
    for t in (hmm.log_A, hmm.log_B):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(torch.logsumexp(t.double(), 1).numpy(), 0,
                                   atol=1e-5)
    assert torch.all(hmm.log_A >= NEG_INF)
    again = build(np.random.default_rng(0))
    assert torch.equal(hmm.log_A, again.log_A)
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    assert torch.equal(build(g1).log_A, build(g2).log_A)
    if make == "left_to_right":
        assert float(hmm.log_pi[0]) == 0.0 and torch.all(hmm.log_pi[1:] == NEG_INF)
        assert float(hmm.log_A[5, 4]) == NEG_INF     # no backward transitions


def test_from_numpy_path_score_and_sampling():
    g = np.random.default_rng(4)
    lp = np.log(g.dirichlet(np.ones(6))).astype(np.float32)
    la = np.log(g.dirichlet(np.ones(6), 6)).astype(np.float32)
    lb = np.log(g.dirichlet(np.ones(3), 6)).astype(np.float32)
    hmm = HMM.from_numpy(lp, la, lb, device="cpu")
    assert torch.equal(hmm.log_A, torch.from_numpy(la))
    states, obs = sample_observations(np.random.default_rng(1), hmm, 12)
    assert states.shape == obs.shape == (12,)
    assert int(obs.max()) < 3 and int(states.max()) < 6
    em = hmm.emissions(obs)
    assert em.shape == (12, 6)
    s = path_score(hmm.log_pi, hmm.log_A, em, states)
    s_j = j_path_score(jnp.asarray(lp), jnp.asarray(la), jnp.asarray(em.numpy()),
                       jnp.asarray(states.numpy()))
    np.testing.assert_allclose(float(s), float(s_j), rtol=1e-6)
    assert relative_error(-2.0, -2.0) == 0.0


def test_entry_points_raise_without_gpu_unless_cpu_requested():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        erdos_renyi_hmm(np.random.default_rng(0), 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HMM.from_numpy(np.zeros(2), np.zeros((2, 2)), np.zeros((2, 2)))


# ---------------------------------------------------------------------------
# specs and the decoder object
# ---------------------------------------------------------------------------

def test_spec_validation_is_eager():
    with pytest.raises(ValueError):
        FusedSpec(bt=0)
    with pytest.raises(ValueError):
        FusedSpec(bt=True)
    with pytest.raises(TypeError):
        FusedSpec(beam_width=8)                 # unknown tunable
    with pytest.raises(TypeError):
        VanillaSpec(bt=8)
    with pytest.raises(TypeError, match="ConstraintSpec"):
        FusedSpec(constraint=object())
    with pytest.raises(ValueError):
        ResourceBudget(memory_bytes=0)
    with pytest.raises(ValueError):
        ResourceBudget(latency_hint="fast")
    assert FusedSpec(bt=4) == FusedSpec(bt=4)
    assert hash(FusedSpec(bt=4)) == hash(FusedSpec(bt=4))
    with pytest.raises(dataclasses.FrozenInstanceError):
        FusedSpec().bt = 2


def test_spec_from_tunables_matches_jax():
    kw = dict(bt=4, beam_width=8, lanes=None)
    spec, ignored = spec_from_tunables("fused", kw)
    spec_j, ignored_j = j_spec_from_tunables("fused", kw)
    assert spec == FusedSpec(bt=4) and spec_j == JFused(bt=4)
    assert ignored == ignored_j == ("beam_width", "lanes")
    assert spec_from_tunables("vanilla", {})[0] == VanillaSpec()
    with pytest.raises(ValueError):
        spec_from_tunables("nope", {})
    fbs, ignored = spec_from_tunables("flash_bs", {"beam_width": 16})
    fbs_j, _ = j_spec_from_tunables("flash_bs", {"beam_width": 16})
    assert fbs == FlashBSSpec(beam_width=16) and not ignored
    assert dataclasses.asdict(fbs) == dataclasses.asdict(fbs_j)
    online, ignored = spec_from_tunables("online", {"max_lag": 4, "bt": 2})
    online_j, ignored_j = j_spec_from_tunables("online", {"max_lag": 4,
                                                          "bt": 2})
    assert dataclasses.asdict(online) == dataclasses.asdict(online_j)
    assert online.max_lag == 4 and ignored == ignored_j == ("bt",)
    with pytest.raises(TypeError):
        spec_from_tunables("fused", {"constraint": None})
    assert as_decode_spec(spec) is spec
    with pytest.raises(TypeError):
        as_decode_spec("fused")


@pytest.mark.parametrize("method", ["vanilla", "fused"])
def test_decoder_matches_jax_decoder(batch_problem, method):
    hmm, em = batch_problem
    lp, la = _np(hmm)
    spec, spec_j = (cls() for cls in SPECS[method])
    dec = ViterbiDecoder(spec, lp, la, device="cpu")
    dec_j = JDecoder(spec_j, lp, la)
    p, s = dec.decode(em[0].numpy())
    p_j, s_j = dec_j.decode(em[0].numpy())
    assert np.array_equal(p.numpy(), np.asarray(p_j)) and float(s) == float(s_j)
    paths, scores = dec.decode_batch(em.numpy(), LENGTHS)
    paths_j, scores_j = dec_j.decode_batch(em.numpy(), LENGTHS)
    assert np.array_equal(paths.numpy(), np.asarray(paths_j))
    assert np.array_equal(scores.numpy(), np.asarray(scores_j))
    assert dec.device == CPU and "K=32" in repr(dec)
    with pytest.raises(ValueError, match="lengths must lie"):
        dec.decode_batch(em.numpy(), np.zeros(len(LENGTHS), np.int32))
