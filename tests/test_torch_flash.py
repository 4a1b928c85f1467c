"""Parity of the port's paper algorithms (`repro_torch.core`: FLASH,
FLASH-BS, checkpoint, static beams, associative scan) with the JAX
package's on the CPU.

The problems are those of tests/test_core_viterbi.py (Erdos-Renyi, K = 48,
T = 96), a left-to-right HMM of the same size (tie-heavy: off-band
transitions are NEG_INF) and the hypothesis strategies of
tests/test_property.py (K in {8, 24}, T in {9, 32, 57}).  The JAX package
makes each problem; its numpy arrays go to both packages.  The port's beam
transitions run the beam kernel's plain version and its associative scan the
tropical kernel's, because the tensors lie on the CPU.  Tolerance: paths and
scores are bitwise equal.
"""

import numpy as np
import jax
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

from repro.core import (beam_static_mp_viterbi as j_bs_mp,
                        beam_static_viterbi as j_bs,
                        erdos_renyi_hmm as j_er, flash_bs_viterbi as j_fbs,
                        flash_viterbi as j_flash, left_to_right_hmm as j_l2r,
                        random_emissions as j_rand,
                        viterbi_assoc as j_assoc,
                        viterbi_checkpoint as j_ckpt)
from repro_torch.core import (beam_static_mp_viterbi, beam_static_viterbi,
                              flash_bs_viterbi, flash_viterbi, pad_state_space,
                              plan_padding, viterbi_assoc, viterbi_checkpoint)
from repro_torch.core.assoc import associative_scan

# The plain versions run many small ops: one intra-op thread keeps the
# test workers from spinning against each other's JAX compiles.
torch.set_num_threads(1)

#: (port function, JAX function, keyword arguments) of every case
CASES = {
    "flash_P1": (flash_viterbi, j_flash, dict(parallelism=1)),
    "flash_P4": (flash_viterbi, j_flash, dict(parallelism=4)),
    "flash_P7": (flash_viterbi, j_flash, dict(parallelism=7)),
    "flash_lanes2": (flash_viterbi, j_flash, dict(parallelism=8, lanes=2)),
    "flash_whole_layer": (flash_viterbi, j_flash,
                          dict(parallelism=8, lanes=None)),
    "flash_bs_B4": (flash_bs_viterbi, j_fbs,
                    dict(beam_width=4, parallelism=4, chunk=16)),
    "flash_bs_B16": (flash_bs_viterbi, j_fbs,
                     dict(beam_width=16, parallelism=4, chunk=16)),
    "flash_bs_full_padded": (flash_bs_viterbi, j_fbs,
                             dict(beam_width=64, parallelism=4, chunk=20,
                                  lanes=None)),
    "checkpoint": (viterbi_checkpoint, j_ckpt, {}),
    "beam_static_B16": (beam_static_viterbi, j_bs, dict(B=16)),
    "beam_static_B48": (beam_static_viterbi, j_bs, dict(B=48)),
    "beam_static_mp_B16": (beam_static_mp_viterbi, j_bs_mp,
                           dict(beam_width=16, parallelism=4)),
    "assoc": (viterbi_assoc, j_assoc, {}),
}


def _arrays(hmm, em):
    return np.array(hmm.log_pi), np.array(hmm.log_A), np.array(em)


@pytest.fixture(scope="module", params=["erdos_renyi", "left_to_right"])
def problem(request):
    """(numpy log_pi, log_A, em) of a K = 48, T = 96 problem."""
    k1, k2 = jax.random.split(jax.random.key(42))
    if request.param == "erdos_renyi":
        hmm = j_er(k1, 48, edge_prob=0.3)
    else:
        hmm = j_l2r(k1, 48, 16)
    return _arrays(hmm, j_rand(k2, 96, 48))


def _assert_same(case, arrays):
    _assert_pair(*CASES[case], arrays, case)


def _assert_pair(fn, j_fn, kw, arrays, case):
    path, score = fn(*(torch.from_numpy(x) for x in arrays), **kw)
    path_j, score_j = j_fn(*arrays, **kw)
    assert path.dtype == torch.int32 and path.shape == (arrays[2].shape[0],)
    assert np.array_equal(path.numpy(), np.asarray(path_j)), case
    assert np.float32(score) == np.float32(score_j), case


@pytest.mark.parametrize("case", sorted(CASES))
def test_decoder_matches_jax(problem, case):
    _assert_same(case, problem)


@pytest.mark.parametrize("T", [1, 2])
def test_short_sequences_match_jax(T):
    """T = 1 and 2 are edge cases of every padding rule."""
    k1, k2 = jax.random.split(jax.random.key(T))
    arrays = _arrays(j_er(k1, 24, edge_prob=0.3), j_rand(k2, T, 24))
    for case in ("flash_P4", "flash_bs_B16", "checkpoint",
                 "beam_static_mp_B16") + (("assoc",) if T > 1 else ()):
        _assert_same(case, arrays)


def test_padding_helpers_match_jax():
    from repro.core.flash import plan_padding as j_plan
    from repro.core.flash_bs import pad_state_space as j_pad
    for T in (1, 2, 9, 57, 96, 511):
        for P in (1, 3, 8):
            assert plan_padding(T, P) == j_plan(T, P)
    g = np.random.default_rng(0)
    lp, la, em = (g.standard_normal(s).astype(np.float32)
                  for s in ((10,), (10, 10), (2, 5, 10)))
    out = pad_state_space(*(torch.from_numpy(x) for x in (lp, la, em)), 4)
    out_j = j_pad(lp, la, em, 4)
    assert out[3] == out_j[3] == 12
    for x, y in zip(out[:3], out_j[:3]):
        assert np.array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13])
def test_associative_scan_groups_as_jax(n):
    """The scan's tree, seen through the non-associative combine a + 2b:
    any other grouping gives other values."""
    from jax import lax
    out = associative_scan(lambda a, b: a + 2 * b,
                           torch.arange(n, dtype=torch.float64))
    out_j = lax.associative_scan(lambda a, b: a + 2 * b,
                                 np.arange(n, dtype=np.float64))
    assert np.array_equal(out.numpy(), np.asarray(out_j))


# ---------------------------------------------------------------------------
# hypothesis strategies of tests/test_property.py
# ---------------------------------------------------------------------------

_SETTINGS = dict(max_examples=4, deadline=None,
                 suppress_health_check=[HealthCheck.too_slow])


@st.composite
def problems(draw):
    K = draw(st.sampled_from([8, 24]))
    T = draw(st.sampled_from([9, 32, 57]))
    p = draw(st.sampled_from([0.3, 0.8]))
    seed = draw(st.integers(0, 2**16))
    return K, T, p, seed


def _mk(K, T, p, seed):
    k1, k2 = jax.random.split(jax.random.key(seed))
    return _arrays(j_er(k1, K, edge_prob=p), j_rand(k2, T, K))


@given(problems(), st.sampled_from([1, 2, 4]))
@settings(**_SETTINGS)
def test_flash_matches_jax_property(prob, P):
    _assert_pair(flash_viterbi, j_flash, dict(parallelism=P), _mk(*prob),
                 f"flash P={P} {prob}")


@given(problems(), st.sampled_from([4, None]))
@settings(**_SETTINGS)
def test_flash_bs_matches_jax_property(prob, beam):
    kw = dict(beam_width=beam or prob[0], parallelism=2, chunk=8)
    _assert_pair(flash_bs_viterbi, j_fbs, kw, _mk(*prob),
                 f"flash_bs {kw} {prob}")


# ---------------------------------------------------------------------------
# the FLASH-BS passes' plain versions against JAX's, per sequence under vmap
# ---------------------------------------------------------------------------

def _pass_problem(name):
    """numpy (log_pi, log_A, em (6, 32, K_pad)) padded with sentinel states
    by JAX's `pad_state_space` at chunk 16: Erdos-Renyi K = 48, the
    tie-heavy left-to-right K = 48, and a ragged K = 40 (K_pad = 48)."""
    from repro.core.flash_bs import pad_state_space as j_pad
    K = 40 if name == "ragged" else 48
    k1, k2 = jax.random.split(jax.random.key(7))
    hmm = j_l2r(k1, K, 16) if name == "left_to_right" else j_er(
        k1, K, edge_prob=0.3)
    em = np.asarray(j_rand(k2, 6 * 32, K)).reshape(6, 32, K)
    return tuple(np.array(x) for x in j_pad(hmm.log_pi, hmm.log_A, em,
                                              16)[:3])


@pytest.mark.parametrize("B", [4, 16])
@pytest.mark.parametrize("name", ["erdos_renyi", "left_to_right", "ragged"])
def test_bs_initial_pass_ref_matches_jax(name, B):
    """Six sequences of Tp = 32 steps, P = 4 (boundaries 7, 15, 23): whole,
    pad from step 8 and from step 24 (the boundary crossings fall on pad
    steps), one real step, and two scattered pad patterns; bitwise against
    `_bs_initial_pass` under `jax.vmap`, at the JAX chunk and as one
    selection."""
    from repro.core.flash_bs import _bs_initial_pass as j_init
    from repro_torch.kernels import ref
    lp, la, em = _pass_problem(name)
    bnd = np.array([7, 15, 23])
    pad = np.zeros((6, 32), bool)
    pad[1, 8:] = pad[2, 24:] = pad[3, 1:] = True
    g = np.random.default_rng(B)
    pad[4:, 1:] = g.random((2, 31)) < 0.4
    out_j = jax.jit(jax.vmap(lambda e, p: j_init(lp, la, e, p, bnd, B, 16)))(
        em, pad)
    for chunk in (16, None):
        out = ref.bs_initial_pass_ref(*(torch.from_numpy(x) for x in (
            lp, la, em, pad)), bnd, B, chunk)
        assert out[0].dtype == out[1].dtype == torch.int32
        for x, y in zip(out, out_j):
            assert np.array_equal(x.numpy(), np.asarray(y)), chunk


@pytest.mark.parametrize("B", [4, 16])
@pytest.mark.parametrize("name", ["erdos_renyi", "left_to_right", "ragged"])
def test_bs_segment_decode_ref_matches_jax(name, B):
    """24 tiles of s = 8 steps (the midpoint carry starts at step 4): whole,
    pad from the midpoint step, pad from step 1 and scattered pads; entry
    and exit states drawn at random (an exit off the beam takes the
    fallback), a third of them first tiles; bitwise against
    `_bs_segment_decode` under `jax.vmap`."""
    from repro.core.flash_bs import _bs_segment_decode as j_seg
    from repro_torch.kernels import ref
    lp, la, em = _pass_problem(name)
    em = em.reshape(24, 8, -1)
    K = la.shape[0]
    g = np.random.default_rng(B + 1)
    pad = np.zeros((24, 8), bool)
    pad[6:12, 4:] = pad[12:18, 1:] = True
    pad[18:, 1:] = g.random((6, 7)) < 0.4
    entry, exit_state = (g.integers(0, K, 24).astype(np.int32)
                         for _ in range(2))
    is_first = np.arange(24) % 3 == 0
    lp_j, la_j = jax.numpy.asarray(lp), jax.numpy.asarray(la)
    mid_j = jax.jit(jax.vmap(
        lambda e, p, en, ex, f: j_seg(lp_j, la_j, e, p, en, ex, f, B, 16)))(
        em, pad, entry, exit_state, is_first)
    t = torch.from_numpy
    for chunk in (16, None):
        mid = ref.bs_segment_decode_ref(
            t(lp), t(la), t(em), t(pad), t(entry).long(),
            t(exit_state).long(), t(is_first), B, chunk)
        assert mid.dtype == torch.int32
        assert np.array_equal(mid.numpy(), np.asarray(mid_j)), chunk


def _integer_problem(T, K, seed):
    """Integer-valued log_pi, log_A and em in [-3, 0] (numpy float32): the
    sums are exact, so most maxima, and the backtrack's argmaxes, tie."""
    g = np.random.default_rng(seed)
    return tuple(g.integers(-3, 1, s).astype(np.float32)
                 for s in ((K,), (K, K), (T, K)))


@pytest.mark.parametrize("K", [5, 24])
@pytest.mark.parametrize("T", [1, 2, 3, 64, 257])
def test_assoc_matches_jax_on_ties(T, K):
    """`viterbi_assoc` (its backtrack: the tropical argmax table walked by
    the backtrack kernel's plain versions) bitwise equal to JAX's reverse
    `lax.scan` of argmax calls, on tie-heavy integer inputs; T = 1 has no
    step to walk."""
    _assert_pair(viterbi_assoc, j_assoc, {}, _integer_problem(T, K, T + K),
                 f"assoc T={T} K={K}")


def test_assoc_backtrack_is_one_table_and_one_walk(monkeypatch):
    """The backtrack makes one argmax call of the tropical kernel and one of
    the backtrack kernel, whatever T: no per-step loop."""
    from repro_torch.core import assoc
    calls = {"args": 0, "values": 0, "walk": 0}

    def trop(a, b, with_args=True):
        calls["args" if with_args else "values"] += 1
        return assoc_trop(a, b, with_args)

    def walk(psi, dT):
        calls["walk"] += 1
        return assoc_walk(psi, dT)

    assoc_trop, assoc_walk = (assoc.tropical_matmul_batch,
                              assoc.viterbi_backtrack_batch)
    monkeypatch.setattr(assoc, "tropical_matmul_batch", trop)
    monkeypatch.setattr(assoc, "viterbi_backtrack_batch", walk)
    for T in (1, 64, 257):
        calls.update(args=0, values=0, walk=0)
        lp, A, em = (torch.from_numpy(x) for x in _integer_problem(T, 8, T))
        path, _ = viterbi_assoc(lp, A, em)
        assert path.shape == (T,)
        assert calls["args"] == (T > 1) and calls["walk"] == 1, (T, calls)
        # the scan's levels: about 2 log2(T) values-only launches
        assert calls["values"] <= 2 * max(1, T - 1).bit_length(), (T, calls)
