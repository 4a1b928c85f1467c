"""Parity of the port's kernel tier (`repro_torch.kernels`) with the JAX
package's (`repro.kernels`) on the CPU.

The cases are the viterbi cases of tests/test_kernels.py.  Inputs are made
once with numpy from a seed and handed to both packages; the JAX side runs
its Pallas kernel in interpret mode (or its ref fallback where K % 128 != 0),
the port runs its kernels' plain versions, because the tensors lie on the
CPU.  Tolerance: psi, paths, delta_T and scores are bitwise equal.
"""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.core import viterbi_vanilla as j_vanilla
from repro_torch.core import erdos_renyi_hmm, left_to_right_hmm, random_emissions
from repro_torch.core import viterbi_vanilla
from repro_torch.kernels import ops, ref
from repro_torch.kernels import viterbi_dp as vdp

CPU = torch.device("cpu")


def _normal(seed, *shapes):
    g = np.random.default_rng(seed)
    return [g.standard_normal(s).astype(np.float32) for s in shapes]


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _eq(torch_x, jax_x):
    return np.array_equal(torch_x.numpy(), np.asarray(jax_x))


def _hmm(seed, K, **kw):
    """A port-generated HMM as (port tensors, numpy arrays)."""
    hmm = erdos_renyi_hmm(np.random.default_rng(seed), K, device=CPU, **kw)
    return hmm, (hmm.log_pi.numpy(), hmm.log_A.numpy())


@pytest.mark.parametrize("T,K", [(16, 128), (33, 128), (24, 256), (7, 384)])
def test_viterbi_forward_kernel(T, K):
    A, em, d0 = _normal(T * 31 + K, (K, K), (T, K), (K,))
    psi, dT = ops.viterbi_forward(_t(A), _t(em), _t(d0))
    psi_j, dT_j = jops.viterbi_forward(A, em, d0)
    assert psi.dtype == torch.int32 and psi.shape == (T, K)
    assert _eq(psi, psi_j)
    assert _eq(dT, dT_j)


@pytest.mark.parametrize("K", [100, 200])
def test_viterbi_forward_unaligned_k(K):
    """K % 128 != 0 takes JAX's XLA fallback; the port has no fallback."""
    A, em, d0 = _normal(K, (K, K), (12, K), (K,))
    psi, dT = ops.viterbi_forward(_t(A), _t(em), _t(d0))
    psi_j, dT_j = jops.viterbi_forward(A, em, d0)
    assert _eq(psi, psi_j) and _eq(dT, dT_j)


@pytest.mark.parametrize("T", [7, 13, 31, 97])
def test_viterbi_forward_prime_lengths(T):
    K = 128
    A, em, d0 = _normal(T, (K, K), (T, K), (K,))
    psi, dT = ops.viterbi_forward(_t(A), _t(em), _t(d0))
    psi_j, dT_j = jops.viterbi_forward(A, em, d0)
    assert psi.shape == (T, K)
    assert _eq(psi, psi_j) and _eq(dT, dT_j)


def test_viterbi_forward_empty_and_chunk_step():
    K = 128
    A, em, d0 = _normal(8, (K, K), (5, K), (K,))
    psi, dT = ops.viterbi_forward(_t(A), _t(em[:0]), _t(d0))
    assert psi.shape == (0, K) and torch.equal(dT, _t(d0))
    psi, dT = ops.viterbi_chunk_step(_t(A), _t(em), _t(d0))
    psi_j, dT_j = jops.viterbi_chunk_step(A, em, d0)
    assert _eq(psi, psi_j) and _eq(dT, dT_j)


def test_viterbi_decode_fused_prime_length_matches_vanilla():
    hmm, (lp, la) = _hmm(97, 128, edge_prob=0.4)
    em = random_emissions(np.random.default_rng(97), 97, 128, device=CPU)
    p, s = ops.viterbi_decode_fused(hmm.log_pi, hmm.log_A, em)
    p_j, s_j = jops.viterbi_decode_fused(lp, la, em.numpy())
    assert _eq(p, p_j) and float(s) == float(s_j)
    p_v, s_v = viterbi_vanilla(hmm.log_pi, hmm.log_A, em)
    assert torch.equal(p, p_v)
    np.testing.assert_allclose(float(s), float(s_v), rtol=1e-6)


@pytest.mark.parametrize("K,lengths", [(128, [20, 7, 1, 20]),
                                       (100, [20, 4, 1, 11])])
def test_viterbi_forward_batch_ragged(K, lengths):
    """Ragged batch (K = 100 is JAX's fallback path): the whole psi, identity
    pad rows included, and delta_T bitwise equal to JAX's; each row equal to
    the port's own single-sequence pass on its prefix."""
    B, T = len(lengths), 20
    A, em, d0 = _normal(3 + K, (K, K), (B, T, K), (B, K))
    psi, dT = ops.viterbi_forward_batch(_t(A), _t(em), _t(d0), lengths)
    psi_j, dT_j = jops.viterbi_forward_batch(A, em, d0, jnp.asarray(lengths))
    assert _eq(psi, psi_j) and _eq(dT, dT_j)
    eye = torch.arange(K, dtype=torch.int32)
    for i, L in enumerate(lengths):
        p1, d1 = ops.viterbi_forward(_t(A), _t(em[i, :L]), _t(d0[i]))
        assert torch.equal(psi[i, :L], p1) and torch.equal(dT[i], d1), i
        assert torch.equal(psi[i, L:], eye.expand(T - L, K)), i


def test_viterbi_forward_batch_left_to_right_ties():
    """The serve model: off-band transitions and log_pi are NEG_INF, so most
    maxima tie exactly; the lowest index must win as in jnp.argmax."""
    B, T, K = 3, 24, 128
    hmm = left_to_right_hmm(np.random.default_rng(5), K, 16, device=CPU)
    em_full = 2.0 * _normal(5, (B, T + 1, K))[0]
    d0 = hmm.log_pi.numpy()[None] + em_full[:, 0]
    lengths = [T, 9, 0]
    psi, dT = ops.viterbi_forward_batch(hmm.log_A, _t(em_full)[:, 1:], _t(d0),
                                        lengths)
    psi_j, dT_j = jops.viterbi_forward_batch(hmm.log_A.numpy(), em_full[:, 1:],
                                             d0, jnp.asarray(lengths))
    assert _eq(psi, psi_j) and _eq(dT, dT_j)
    assert torch.equal(dT[2], _t(d0[2]))          # nfeed = 0: frozen


def test_viterbi_slot_step_nfeed_zero():
    S, block, K = 4, 8, 128
    A, em, d = _normal(11, (K, K), (S, block, K), (S, K))
    nfeed = [8, 0, 3, 0]
    psi, d2 = ops.viterbi_slot_step(_t(A), _t(em), _t(d), nfeed)
    psi_j, d2_j = jops.viterbi_slot_step(A, em, d, jnp.asarray(nfeed))
    assert _eq(psi, psi_j) and _eq(d2, d2_j)
    assert torch.equal(d2[1], _t(d[1])) and torch.equal(d2[3], _t(d[3]))


def test_viterbi_decode_fused_batch_matches_loop():
    B, T, K = 4, 19, 128
    lengths = [19, 8, 1, 13]
    hmm, (lp, la) = _hmm(6, K, edge_prob=0.4)
    em = random_emissions(np.random.default_rng(6), B * T, K,
                          device=CPU).reshape(B, T, K)
    paths, scores = ops.viterbi_decode_fused_batch(hmm.log_pi, hmm.log_A, em,
                                                   lengths)
    paths_j, scores_j = jops.viterbi_decode_fused_batch(
        lp, la, em.numpy(), jnp.asarray(lengths))
    assert _eq(paths, paths_j) and _eq(scores, scores_j)
    for i, L in enumerate(lengths):
        p, s = ops.viterbi_decode_fused(hmm.log_pi, hmm.log_A, em[i, :L])
        assert torch.equal(paths[i, :L], p), i
        assert float(scores[i]) == float(s), i


def test_viterbi_decode_fused_batch_T1():
    hmm, (lp, la) = _hmm(7, 128)
    em = random_emissions(np.random.default_rng(7), 3, 128,
                          device=CPU).reshape(3, 1, 128)
    paths, scores = ops.viterbi_decode_fused_batch(hmm.log_pi, hmm.log_A, em)
    paths_j, scores_j = jops.viterbi_decode_fused_batch(lp, la, em.numpy())
    assert paths.dtype == torch.int32
    assert _eq(paths, paths_j) and _eq(scores, scores_j)


def test_viterbi_decode_fused_matches_vanilla():
    hmm, (lp, la) = _hmm(5, 128, edge_prob=0.4)
    em = random_emissions(np.random.default_rng(5), 33, 128, device=CPU)
    p1, s1 = ops.viterbi_decode_fused(hmm.log_pi, hmm.log_A, em)
    p2, s2 = viterbi_vanilla(hmm.log_pi, hmm.log_A, em)
    p_j, s_j = j_vanilla(lp, la, em.numpy())
    assert torch.equal(p1, p2) and _eq(p1, p_j)
    assert float(s1) == float(s2) == float(s_j)


def test_backtrack_ref_follows_psi():
    """paths[T] is the lowest-index argmax; each earlier state is psi's entry."""
    psi = torch.tensor([[[1, 0, 2], [2, 2, 0]]], dtype=torch.int32)
    dT = torch.tensor([[1.0, 3.0, 3.0]])
    paths, scores = vdp.viterbi_backtrack_batch(psi, dT)
    assert paths.tolist() == [[2, 2, 1]] and scores.tolist() == [3.0]
    assert torch.equal(paths, ref.viterbi_backtrack_ref(psi, dT)[0])


def test_wrappers_on_cpu_use_plain_versions_and_count_nothing():
    K = 16
    A, em, d0 = _normal(1, (K, K), (2, 5, K), (2, K))
    vdp.reset_launches()
    psi, dT = vdp.viterbi_forward_batch(_t(A), _t(em), _t(d0))
    vdp.viterbi_backtrack_batch(psi, dT)
    psi_m, dT_m = vdp.viterbi_forward_batch_masked(_t(A), _t(em), _t(d0))
    centers = torch.tensor([3, 4, 5, 6, 7], dtype=torch.int32)
    vdp.viterbi_banded_forward(_t(A), _t(d0[0]), _t(em[0]), centers,
                               centers - 2, 2)
    assert vdp.launches == {"viterbi_fwd_batch": 0,
                            "viterbi_fwd_batch_masked": 0,
                            "viterbi_banded_fwd": 0,
                            "viterbi_backtrack_batch": 0}
    psi_r, dT_r = ref.viterbi_forward_ref(_t(A), _t(em), _t(d0))
    assert torch.equal(psi, psi_r) and torch.equal(dT, dT_r)
    assert torch.equal(psi_m, psi_r) and torch.equal(dT_m, dT_r)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    K = 16
    A, em, d0 = (_t(x) for x in _normal(2, (K, K), (2, 5, K), (2, K)))
    with pytest.raises(ValueError, match="float32"):
        vdp.viterbi_forward_batch(A.double(), em, d0)
    with pytest.raises(ValueError, match="log_A"):
        vdp.viterbi_forward_batch(A[:8], em, d0)
    with pytest.raises(ValueError, match="delta0"):
        vdp.viterbi_forward_batch(A, em, d0[:1])
    with pytest.raises(ValueError, match="pad"):
        vdp.viterbi_forward_batch(A, em, d0, torch.zeros(2, 4))
    with pytest.raises(ValueError, match="devices"):
        vdp.viterbi_forward_batch(A, em.to("meta"), d0)
    with pytest.raises(ValueError, match="int32"):
        vdp.viterbi_backtrack_batch(torch.zeros(2, 5, K, dtype=torch.int64), d0)
    K5 = torch.zeros(5, K)
    with pytest.raises(ValueError, match="tmask"):
        vdp.viterbi_forward_batch_masked(A, em, d0, tmask=K5)
    with pytest.raises(ValueError, match="smask"):
        vdp.viterbi_forward_batch_masked(A, em, d0, smask=K5[:4])
    with pytest.raises(ValueError, match="float32"):
        vdp.viterbi_forward_batch_masked(A, em, d0, smask=K5.double())
    c = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        vdp.viterbi_banded_forward(A, d0[0], em[0], c.long(), c, 1)
    with pytest.raises(ValueError, match="centers"):
        vdp.viterbi_banded_forward(A, d0[0], em[0], c[:4], c[:4], 1)
    with pytest.raises(ValueError, match="T >= 1"):
        vdp.viterbi_banded_forward(A, d0[0], em[0, :0], c[:0], c[:0], 1)


# ---------------------------------------------------------------------------
# constraint-masked forward kernel and banded decode
# ---------------------------------------------------------------------------

def _penalty(g, shape, p_masked):
    """A {0, NEG_INF} float32 penalty with about p_masked of it masked."""
    return np.where(g.random(shape) < p_masked, np.float32(-1.0e9),
                    np.float32(0.0)).astype(np.float32)


@pytest.mark.parametrize("masks", ["t", "s", "ts"])
@pytest.mark.parametrize("K", [128, 100])
def test_viterbi_forward_batch_masked_matches_jax(K, masks):
    """K = 128 runs JAX's Pallas masked kernel (interpret), K = 100 its ref
    fallback.  Ragged lengths include 1 and 0 (pad steps ignore smask)."""
    B, T = 4, 20
    g = np.random.default_rng(K + len(masks))
    A, em, d0 = _normal(K + 7, (K, K), (B, T, K), (B, K))
    tmask = _penalty(g, (K, K), 0.6) if "t" in masks else None
    smask = _penalty(g, (T, K), 0.5) if "s" in masks else None
    lengths = [T, 7, 1, 0]
    psi, dT = ops.viterbi_forward_batch_masked(
        _t(A), _t(em), _t(d0), lengths, tmask=tmask, smask=smask)
    psi_j, dT_j = jops.viterbi_forward_batch_masked(
        A, em, d0, jnp.asarray(lengths), tmask=tmask, smask=smask)
    assert _eq(psi, psi_j) and _eq(dT, dT_j)
    pad = torch.arange(T)[None, :] >= torch.tensor(lengths)[:, None]
    psi_r, dT_r = ref.viterbi_forward_masked_pen_ref(
        _t(A), _t(em), _t(d0), pad, None if tmask is None else _t(tmask),
        None if smask is None else _t(smask))
    assert torch.equal(psi, psi_r) and torch.equal(dT, dT_r)
    # the same bits as the unmasked pass over pre-masked operands
    A2 = A if tmask is None else A + tmask
    em2 = em if smask is None else em + smask[None]
    psi_p, dT_p = ops.viterbi_forward_batch(_t(A2), _t(em2), _t(d0), lengths)
    assert torch.equal(psi, psi_p) and torch.equal(dT, dT_p)


def test_viterbi_forward_batch_masked_empty_T():
    K = 16
    A, em, d0 = _normal(4, (K, K), (2, 0, K), (2, K))
    psi, dT = ops.viterbi_forward_batch_masked(_t(A), _t(em), _t(d0),
                                               tmask=np.zeros((K, K),
                                                              np.float32))
    assert psi.shape == (2, 0, K) and torch.equal(dT, _t(d0))


@pytest.mark.parametrize("case", ["clipped_low", "clipped_high", "middle",
                                  "T1", "width0", "wide"])
def test_viterbi_decode_banded_matches_jax(case):
    """Bands clipped at state 0 and at K-1, a single step, a zero width and
    a band wider than K, against JAX's windowed scan and the dense oracle."""
    from repro_torch.core import BandConstraint, constrain_inputs
    K = 40
    T = 1 if case == "T1" else 30
    hmm, (lp, la) = _hmm(21, K, edge_prob=1.0)
    em = random_emissions(np.random.default_rng(21), T, K, device=CPU)
    g = np.random.default_rng(22)
    width = {"width0": 0, "wide": 30}.get(case, 5)
    centers = {
        "clipped_low": g.integers(-4, 4, size=T),
        "clipped_high": g.integers(K - 4, K + 4, size=T),
    }.get(case, g.integers(0, K, size=T))
    centers = tuple(int(c) for c in centers)
    p, s = ops.viterbi_decode_banded(hmm.log_pi, hmm.log_A, em, centers,
                                     width=width)
    assert p.dtype == torch.int32 and p.shape == (T,)
    p_j, s_j = jops.viterbi_decode_banded(lp, la, em.numpy(), centers,
                                          width=width)
    assert _eq(p, p_j) and float(s) == float(s_j)
    band = BandConstraint(centers=tuple(max(c, 0) for c in centers),
                          width=width)
    p_o, s_o = viterbi_vanilla(*constrain_inputs(band, hmm.log_pi, hmm.log_A,
                                                 em))
    assert torch.equal(p, p_o) and float(s) == float(s_o)
    with pytest.raises(ValueError, match="horizon"):
        ops.viterbi_decode_banded(hmm.log_pi, hmm.log_A, em, centers[:T - 1],
                                  width=width)


def test_viterbi_decode_fused_masked_matches_jax():
    K, T = 128, 17
    hmm, (lp, la) = _hmm(8, K, edge_prob=1.0)
    em = random_emissions(np.random.default_rng(8), T, K, device=CPU)
    g = np.random.default_rng(9)
    t_pen = _penalty(g, (K, K), 0.7)
    pi_pen = _penalty(g, (K,), 0.5)
    s_pen = _penalty(g, (T, K), 0.3)
    p, s = ops.viterbi_decode_fused_masked(hmm.log_pi, hmm.log_A, em,
                                           t_pen=t_pen, pi_pen=pi_pen,
                                           s_pen=s_pen)
    p_j, s_j = jops.viterbi_decode_fused_masked(lp, la, em.numpy(),
                                                t_pen=t_pen, pi_pen=pi_pen,
                                                s_pen=s_pen)
    assert _eq(p, p_j) and float(s) == float(s_j)
    p1, s1 = ops.viterbi_decode_fused_masked(hmm.log_pi, hmm.log_A, em[:1],
                                             s_pen=s_pen[:1])
    p1_j, s1_j = jops.viterbi_decode_fused_masked(lp, la, em.numpy()[:1],
                                                  s_pen=s_pen[:1])
    assert _eq(p1, p1_j) and float(s1) == float(s1_j)


# ---------------------------------------------------------------------------
# beam transition and tropical product (cases of tests/test_kernels.py)
# ---------------------------------------------------------------------------

def _beam_inputs(K, B):
    g = np.random.default_rng(K + B)
    A, em, scores = (g.standard_normal(s).astype(np.float32)
                     for s in ((K, K), (K,), (B,)))
    return A, em, scores, g.permutation(K)[:B].astype(np.int32)


@pytest.mark.parametrize("K,B,chunk", [(512, 64, 128), (300, 32, 128),
                                       (128, 128, 128), (256, 16, 64)])
def test_beam_step_matches_jax(K, B, chunk):
    """The plain version against JAX's Pallas kernel (interpret mode), its
    oracle and FLASH-BS's `_beam_transition`, all bitwise."""
    from repro.core.flash_bs import _beam_transition
    from repro.kernels import ref as jref
    A, em, scores, states = _beam_inputs(K, B)
    out = ops.beam_step(*(_t(x) for x in (A, em, scores, states)),
                        chunk=chunk)
    out_j = jops.beam_step(A, em, scores, states, chunk=chunk)
    assert out[1].dtype == out[2].dtype == torch.int32
    for x, y in zip(out, out_j):
        assert _eq(x, y)
    for x, y in zip(ref.beam_step_ref(*(_t(x) for x in (A, em, scores,
                                                        states))),
                    jref.beam_step_ref(A, em, scores, states)):
        assert _eq(x, y)
    if K % chunk == 0:
        for x, y in zip(out, _beam_transition(A, em, scores, states, chunk,
                                              B)):
            assert _eq(x, y)


def test_beam_step_batch_left_to_right_chain_matches_jax():
    """12 chained steps of a tie-heavy left-to-right beam (K = 256, B = 128)
    from a one-hot beam: the first step's candidates come from -4e9
    sentinel slots, and most later ones are NEG_INF sums that tie, so the
    merge order decides the bits."""
    from repro.core.flash_bs import _beam_transition
    from repro.kernels import beam_stream as jbs
    from repro_torch.kernels import beam_stream as bs
    K, B, N = 256, 128, 3
    A = left_to_right_hmm(np.random.default_rng(5), K, 16,
                          device=CPU).log_A.numpy()
    g = np.random.default_rng(6)
    scores = np.full((N, B), -4e9, np.float32)
    scores[:, 0] = 0.0
    states = np.zeros((N, B), np.int32)
    s, st = _t(scores), _t(states)
    for _ in range(12):
        em = g.standard_normal((N, K)).astype(np.float32)
        s, st, f = bs.beam_step_batch(_t(A), _t(em), s, st, 128)
        for n in range(N):
            out_j = _beam_transition(A, em[n], scores[n], states[n], 128, B)
            kern_j = jbs.beam_step(A, em[n], scores[n], states[n], chunk=128,
                                   interpret=True)
            for x, y in zip((s[n], st[n], f[n]), out_j):
                assert _eq(x, y)
            assert _eq(st[n], kern_j[1]) and _eq(f[n], kern_j[2])
            scores[n], states[n] = np.asarray(out_j[0]), np.asarray(out_j[1])
    assert int((s <= -1e9).sum()) > N * B // 2    # most of the beam ties


@pytest.mark.parametrize("I,K,J", [(8, 16, 128), (64, 128, 256),
                                   (37, 100, 200), (1, 512, 512),
                                   (128, 64, 384)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tropical_matmul_matches_jax(I, K, J, dtype):
    """Bitwise in both dtypes: a bf16 sum is rounded to bf16 (nearest even)
    before the max, which is what XLA's bf16 add does on the CPU."""
    g = np.random.default_rng(I * 1000 + J)
    a, b = (g.standard_normal(s).astype(np.float32) for s in ((I, K), (K, J)))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    v, arg = ops.tropical_matmul(_t(a).to(tdt), _t(b).to(tdt))
    v_j, arg_j = jops.tropical_matmul(jnp.asarray(a).astype(jdt),
                                      jnp.asarray(b).astype(jdt))
    assert v.dtype == tdt and arg.dtype == torch.int32
    assert np.array_equal(v.float().numpy(), np.asarray(v_j, np.float32))
    assert _eq(arg, arg_j)


def test_tropical_matmul_batch_is_each_product():
    from repro.core.assoc import _tropical_matmul as j_combine
    from repro_torch.kernels import tropical as tr
    a, b = _normal(11, (5, 7, 9), (5, 9, 6))
    vals, args = tr.tropical_matmul_batch(_t(a), _t(b))
    assert vals.shape == args.shape == (5, 7, 6)
    assert _eq(vals, j_combine(a, b))
    for n in range(5):
        v, g = ref.tropical_matmul_ref(_t(a[n]), _t(b[n]))
        assert torch.equal(vals[n], v) and torch.equal(args[n], g)


def test_new_wrappers_on_cpu_count_nothing_and_reject_bad_args():
    from repro_torch import kernels
    from repro_torch.kernels import beam_stream as bs
    from repro_torch.kernels import tropical as tr
    kernels.reset_launches()
    A, em, scores, states = (_t(x) for x in _beam_inputs(64, 8))
    bs.beam_step_batch(A, em[None], scores[None], states[None], 32)
    tr.tropical_matmul_batch(A[None], A[None])
    assert set(kernels.launch_counts()) == {
        "viterbi_fwd_batch", "viterbi_fwd_batch_masked", "viterbi_banded_fwd",
        "viterbi_backtrack_batch", "beam_step_batch", "bs_initial_pass_batch",
        "bs_segment_decode_batch", "bs_chunk_batch", "tropical_matmul_batch"}
    assert not any(kernels.launch_counts().values())
    with pytest.raises(ValueError, match="divide"):
        bs.beam_step_batch(A, em[None], scores[None], states[None], 48)
    with pytest.raises(ValueError, match="beam width"):
        bs.beam_step_batch(A[:4, :4], em[None, :4], scores[None],
                           states[None], 4)
    with pytest.raises(ValueError, match="int32"):
        bs.beam_step_batch(A, em[None], scores[None], states[None].long(), 32)
    with pytest.raises(ValueError, match="devices"):
        bs.beam_step_batch(A, em[None].to("meta"), scores[None],
                           states[None], 32)
    with pytest.raises(ValueError, match="float32 or both bfloat16"):
        tr.tropical_matmul_batch(A[None], A[None].bfloat16())
    with pytest.raises(ValueError, match="must be"):
        tr.tropical_matmul_batch(A[None], A[None, :8])


# ---------------------------------------------------------------------------
# the beam kernel's single selection and its pass entries
# ---------------------------------------------------------------------------

def _single_selection(A, em, scores, states):
    """numpy oracle of one beam transition as one stable selection: the B
    best of [B sentinels (-4e9, 0, 0)] ++ [every target's best candidate],
    by value descending, then position ascending."""
    N, B = scores.shape
    K = A.shape[1]
    cand = (scores[:, :, None] + A[states]) + em[:, None, :]     # f32 adds
    best, frm = cand.max(axis=1), cand.argmax(axis=1)            # first slot
    vals = np.concatenate([np.full((N, B), -4e9, np.float32), best], axis=1)
    st = np.concatenate([np.zeros((N, B), np.int64),
                         np.broadcast_to(np.arange(K), (N, K))], axis=1)
    fr = np.concatenate([np.zeros((N, B), np.int64), frm], axis=1)
    pos = np.arange(B + K)
    out = [[], [], []]
    for n in range(N):
        top = np.lexsort((pos, -vals[n]))[:B]
        for o, x in zip(out, (vals[n], st[n], fr[n])):
            o.append(x[top])
    return (np.stack(out[0]).astype(np.float32),
            np.stack(out[1]).astype(np.int32),
            np.stack(out[2]).astype(np.int32))


def _chunk_case(case):
    """(A (K, K), emissions for 6 steps (6, N, K), scores, states) at K =
    256: a tie-heavy left-to-right beam from a one-hot beam (NEG_INF sums
    tie), a beam half filled with sentinel slots, and a ragged K = 40
    padded with sentinel/2 states as `pad_state_space` pads it, under a
    beam of 64: fewer targets than slots rise above -4e9, so the padded
    targets tie the sentinels at exactly -4e9 and the sentinels win."""
    g = np.random.default_rng(["left_to_right", "sentinel_beam",
                               "ragged"].index(case))
    K, N = 256, 3
    if case == "left_to_right":
        A = left_to_right_hmm(np.random.default_rng(5), K, 16,
                              device=CPU).log_A.numpy()
        B = 64
        scores = np.full((N, B), -4e9, np.float32)
        scores[:, 0] = 0.0
        states = np.zeros((N, B), np.int32)
    else:
        A = g.standard_normal((K, K)).astype(np.float32)
        B = 128 if case == "sentinel_beam" else 64
        scores = g.standard_normal((N, B)).astype(np.float32)
        states = np.stack([g.permutation(K)[:B] for _ in range(N)]
                          ).astype(np.int32)
        if case == "sentinel_beam":
            scores[:, B // 2:] = -4e9
            states[:, B // 2:] = 0
    em = (2.0 * g.standard_normal((6, N, K))).astype(np.float32)
    if case == "ragged":
        A[:, 40:] = A[40:] = np.float32(-2e9)
        em[..., 40:] = np.float32(-2e9)
    return A, em, scores, states


@pytest.mark.parametrize("case", ["left_to_right", "sentinel_beam", "ragged"])
@pytest.mark.parametrize("chunk", [8, 32, 128, "K"])
def test_beam_transition_does_not_depend_on_chunk(chunk, case):
    """The chunked, sentinel-seeded merge is the single stable selection over
    [B sentinels] ++ [all targets] for every chunk size, bitwise: the
    property the beam kernel's one selection per step rests on.  Six
    chained steps each."""
    A, em, scores, states = _chunk_case(case)
    C = A.shape[0] if chunk == "K" else chunk
    s, st = _t(scores), _t(states)
    for e in em:
        out = ref.beam_transition_ref(_t(A), _t(e), s, st, C)
        want = _single_selection(A, e, s.numpy(), st.numpy())
        for x, y in zip(out, want):
            assert _eq(x, y)
        s, st = out[0], out[1]
    if case == "left_to_right":
        assert int((s <= -1e9).sum()) > 0     # NEG_INF sums in the beam
    if case == "ragged":
        assert int((s == -4e9).sum()) == 3 * 24   # sentinels beat the ties


def test_pass_wrappers_on_cpu_count_nothing_and_reject_bad_args():
    """The two pass entries run their plain versions on the CPU and count no
    launch; bad arguments raise before anything runs."""
    from repro_torch import kernels
    from repro_torch.kernels import beam_stream as bs
    K, N, T, B = 32, 3, 6, 4
    A, em, lp = (_t(x) for x in _normal(9, (K, K), (N, T, K), (K,)))
    pad = torch.zeros((N, T), dtype=torch.bool)
    kernels.reset_launches()
    out = bs.bs_initial_pass_batch(lp, A, em, pad, [1, 3], B)
    for x, y in zip(out, ref.bs_initial_pass_ref(lp, A, em, pad, [1, 3], B)):
        assert torch.equal(x, y)
    entry = torch.tensor([0, 5, 7])
    first = torch.tensor([True, False, False])
    mid = bs.bs_segment_decode_batch(lp, A, em, pad, entry, entry, first, B)
    assert torch.equal(mid, ref.bs_segment_decode_ref(lp, A, em, pad, entry,
                                                      entry, first, B))
    assert mid.shape == (N,) and out[0].shape == (N, 2)
    assert not any(kernels.launch_counts().values())
    with pytest.raises(ValueError, match="beam width"):
        bs.bs_initial_pass_batch(lp, A, em, pad, [1], K + 1)
    with pytest.raises(ValueError, match="log_pi"):
        bs.bs_initial_pass_batch(lp[:4], A, em, pad, [1], B)
    with pytest.raises(ValueError, match="em must be"):
        bs.bs_initial_pass_batch(lp, A, em[..., :4], pad, [1], B)
    with pytest.raises(ValueError, match="pad must be"):
        bs.bs_initial_pass_batch(lp, A, em, pad[:, :2], [1], B)
    with pytest.raises(ValueError, match="bool"):
        bs.bs_initial_pass_batch(lp, A, em, pad.float(), [1], B)
    with pytest.raises(ValueError, match="float32"):
        bs.bs_initial_pass_batch(lp, A.double(), em, pad, [1], B)
    with pytest.raises(ValueError, match="devices"):
        bs.bs_initial_pass_batch(lp, A, em.to("meta"), pad, [1], B)
    with pytest.raises(ValueError, match="s >= 2"):
        bs.bs_segment_decode_batch(lp, A, em[:, :1], pad[:, :1], entry,
                                   entry, first, B)
    with pytest.raises(ValueError, match="entry, exit_state and is_first"):
        bs.bs_segment_decode_batch(lp, A, em, pad, entry[:2], entry, first, B)
    with pytest.raises(ValueError, match="int64"):
        bs.bs_segment_decode_batch(lp, A, em, pad, entry.int(), entry, first,
                                   B)
    with pytest.raises(ValueError, match="is_first must be bool"):
        bs.bs_segment_decode_batch(lp, A, em, pad, entry, entry, first.int(),
                                   B)



# ---------------------------------------------------------------------------
# the beam kernel's chunk mode (streaming beam decode)
# ---------------------------------------------------------------------------

def _jax_beam_chunk(lp, A, em, scores, states, first, B, chunk):
    """JAX's `_beam_init` (a first beam) and `_beam_chunk_scan` over the
    rest of the chunk, as `OnlineBeamDecoder.feed` runs them, one beam:
    (scores, states, hist_states, hist_froms) as numpy, a seed row's
    from-slots 0."""
    from repro.core.online import _beam_chunk_scan, _beam_init
    hist_st, hist_f = [], []
    if first:
        scores, states = _beam_init(lp, em[0], B, chunk)
        hist_st.append(np.asarray(states))
        hist_f.append(np.zeros(B, np.int32))
        em = em[1:]
    if em.shape[0]:
        scores, states, sts, froms = _beam_chunk_scan(A, em, scores, states,
                                                      B, chunk)
        hist_st += list(np.asarray(sts))
        hist_f += list(np.asarray(froms))
    return (np.asarray(scores), np.asarray(states), np.stack(hist_st),
            np.stack(hist_f))


def _padded_model(K, chunk, kind, seed):
    """(log_pi, log_A) padded to a multiple of `chunk` with -2e9, as
    `OnlineBeamDecoder` pads them.  "left_to_right": NEG_INF off the band
    and a one-hot log_pi; "constrained": an Erdos-Renyi model plus the
    penalties of a lexicon whose words chain four states, so real scores
    sit at multiples of NEG_INF and tie each other, the padded states and
    the sentinels."""
    from repro_torch.core import LexiconConstraint
    from repro_torch.core.constraints import init_penalty, transition_penalty
    g = np.random.default_rng(seed)
    if kind == "left_to_right":
        hmm = left_to_right_hmm(g, K, 16, device=CPU)
        lp, A = hmm.log_pi.numpy(), hmm.log_A.numpy()
    else:
        hmm = erdos_renyi_hmm(g, K, edge_prob=0.3, device=CPU)
        lp, A = hmm.log_pi.numpy(), hmm.log_A.numpy()
        if kind == "constrained":
            words = tuple((tuple(range(w, min(w + 4, K))),)
                          for w in range(0, K, 4))
            c = LexiconConstraint(words)
            lp = lp + init_penalty(c, K)
            A = A + transition_penalty(c, K)
    K_pad = -(-K // chunk) * chunk
    A = np.pad(A, ((0, K_pad - K), (0, K_pad - K)),
               constant_values=np.float32(-2e9))
    lp = np.pad(lp, (0, K_pad - K), constant_values=np.float32(-2e9))
    return lp.astype(np.float32), A.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "left_to_right", "constrained"])
@pytest.mark.parametrize("K,B,chunk", [(200, 16, 128), (200, 128, 128),
                                       (200, 200, 128), (64, 8, 16),
                                       (3, 2, 3)])
def test_beam_chunk_ref_matches_jax(kind, K, B, chunk):
    """`ref.beam_chunk_ref` against JAX's `_beam_init` + `_beam_chunk_scan`
    (src/repro/core/online.py:434-450), bitwise: N = 3 beams, the first
    seeding, the others carrying, over three chained chunks (C = 1, 5, 9)
    each continuing from the last one's output.  At K = 200 with chunk 128
    every padded state's seed is -2e9 + -2e9 = -4e9, exactly the sentinel's
    score, and its transitions tie the sentinel slots too."""
    N = 3
    lp, A = _padded_model(K, chunk, kind, seed=K + B)
    K_pad = A.shape[0]
    g = np.random.default_rng(K * B)
    carry, tied = None, 0
    for c, C in enumerate((1, 5, 9)):
        em = (2.0 * g.standard_normal((N, C, K_pad))).astype(np.float32)
        em[..., K:] = np.float32(-2e9)
        first = np.array([c == 0, c == 0, c == 0])
        if carry is None:
            scores = np.zeros((N, B), np.float32)
            states = np.zeros((N, B), np.int32)
        else:
            scores, states = carry
            first[0] = True          # a new session joins a carried batch
        out = ref.beam_chunk_ref(_t(lp), _t(A), _t(em), _t(scores),
                                 _t(states), _t(first), B, chunk)
        assert [tuple(x.shape) for x in out] == [(N, B), (N, B), (N, C, B),
                                                 (N, C, B)]
        for n in range(N):
            want = _jax_beam_chunk(lp, A, em[n], scores[n], states[n],
                                   bool(first[n]), B, chunk)
            for x, y in zip(out, want):
                assert _eq(x[n], y)
        carry = (out[0].numpy(), out[1].numpy())
        tied += int((carry[0] <= -1e9).sum())
    if kind == "left_to_right" or (kind == "constrained" and B >= 128):
        assert tied > 0      # NEG_INF sums and sentinel slots in the beams


@pytest.mark.parametrize("chunk", [8, 16, 32, 64])
def test_beam_chunk_ref_does_not_depend_on_kchunk(chunk):
    """Where K needs no padding (K = 64), the chunk mode's result is the
    same for every chunk size, as the kernel's one selection per step
    assumes, and equals the one-selection oracle step by step."""
    lp, A = _padded_model(64, 64, "left_to_right", seed=3)
    g = np.random.default_rng(4)
    em = (2.0 * g.standard_normal((2, 12, 64))).astype(np.float32)
    first = torch.tensor([True, True])
    zeros = (torch.zeros((2, 16)), torch.zeros((2, 16), dtype=torch.int32))
    out = ref.beam_chunk_ref(_t(lp), _t(A), _t(em), *zeros, first, 16, chunk)
    want = ref.beam_chunk_ref(_t(lp), _t(A), _t(em), *zeros, first, 16, 64)
    for x, y in zip(out, want):
        assert torch.equal(x, y)
    seed_s, seed_st = ref._stream_top_b(_t(lp + em[:, 0]), 16)
    s, st = seed_s.numpy(), seed_st.numpy()
    assert np.array_equal(out[2][:, 0].numpy(), st)
    for t in range(1, 12):
        s, st, f = _single_selection(A, em[:, t], s, st)
        assert np.array_equal(out[2][:, t].numpy(), st)
        assert np.array_equal(out[3][:, t].numpy(), f)


def test_bs_chunk_batch_on_cpu_counts_nothing_and_rejects_bad_args():
    """The chunk entry runs its plain version on the CPU, counts no launch,
    and checks its arguments as `beam_step_batch` does."""
    from repro_torch import kernels
    from repro_torch.kernels import beam_stream as bs
    K, N, C, B = 32, 2, 4, 8
    A, em, lp = (_t(x) for x in _normal(12, (K, K), (N, C, K), (K,)))
    sc = torch.zeros((N, B))
    st = torch.zeros((N, B), dtype=torch.int32)
    first = torch.tensor([True, False])
    kernels.reset_launches()
    out = bs.bs_chunk_batch(lp, A, em, sc, st, first, B, 16)
    for x, y in zip(out, ref.beam_chunk_ref(lp, A, em, sc, st, first, B, 16)):
        assert torch.equal(x, y)
    assert not any(kernels.launch_counts().values())
    bad = [("em must be", dict(em=em[:, :0])),
           ("em must be", dict(em=em[..., :4])),
           ("scores and states", dict(sc=sc[:, :4])),
           ("is_first", dict(first=first[:1])),
           ("divide", dict(chunk=12)),
           ("beam width", dict(B=K + 1)),
           ("float32", dict(A=A.double())),
           ("int32", dict(st=st.long())),
           ("bool", dict(first=first.int())),
           ("devices", dict(em=em.to("meta")))]
    args = dict(lp=lp, A=A, em=em, sc=sc, st=st, first=first, B=B, chunk=16)
    for match, kw in bad:
        a = {**args, **kw}
        if "B" in kw:
            a["sc"] = torch.zeros((N, a["B"]))
            a["st"] = torch.zeros((N, a["B"]), dtype=torch.int32)
        with pytest.raises(ValueError, match=match):
            bs.bs_chunk_batch(a["lp"], a["A"], a["em"], a["sc"], a["st"],
                              a["first"], a["B"], a["chunk"])

# --- the cluster forward kernel's reduction, emulated in plain torch -------
#
# `csrc/viterbi_dp.cu` splits each sequence's target columns across the C
# CTAs of a cluster (CTA r owns [r W, (r + 1) W), W = ceil(K / C)) and each
# column's sources into contiguous k ranges (the parts of a CTA's threads,
# each cut again into a thread's chains), scanned upward with a strict '>'
# and combined in ascending k order, a later range winning only if strictly
# greater.  No GPU here, so these tests hold the algorithm: the emulation
# below must equal the plain version and JAX's kernel bit for bit on inputs
# where ties decide psi.


def _first_max(s):
    """The lowest index of the max over dim 1 and the value found there: an
    upward scan with a strict '>'.  s (B, n, w) -> (value, index) (B, w)."""
    best = s.max(dim=1, keepdim=True).values
    n = s.shape[1]
    pos = torch.arange(n).view(1, n, 1).expand_as(s)
    idx = torch.where(s == best, pos, n).min(dim=1, keepdim=True).values
    return s.gather(1, idx)[:, 0], idx[:, 0]


def _cluster_forward(A, em, d0, pad, C, ranges, smask=None):
    """The kernel's forward pass with clusters of C CTAs, each column's
    sources cut into the contiguous `ranges` [(k0, k1), ...] (ascending,
    covering [0, K)); A is what a CTA's slice holds (log_A, or log_A + tmask
    added once), smask (T, K) is added to em before the max is.  Pad steps
    (pad (B, T) bool) keep delta and write the identity row."""
    B, T, K = em.shape
    W = -(-K // C)
    eye = torch.arange(K, dtype=torch.int32)
    psi = torch.empty((B, T, K), dtype=torch.int32)
    delta = d0.clone()
    for t in range(T):
        new = torch.empty_like(delta)
        arg_t = torch.empty((B, K), dtype=torch.int32)
        e = em[:, t] if smask is None else em[:, t] + smask[t]
        for r in range(C):
            c0, c1 = min(r * W, K), min((r + 1) * W, K)
            if c0 == c1:            # a CTA that owns no column
                continue
            best = arg = None
            for k0, k1 in ranges:
                v, i = _first_max(delta[:, k0:k1, None] + A[k0:k1, c0:c1])
                if best is None:
                    best, arg = v, i + k0
                else:               # a later range wins only if greater
                    take = v > best
                    best = torch.where(take, v, best)
                    arg = torch.where(take, i + k0, arg)
            new[:, c0:c1] = best + e[:, c0:c1]
            arg_t[:, c0:c1] = arg.to(torch.int32)
        is_pad = pad[:, t, None]
        psi[:, t] = torch.where(is_pad, eye, arg_t)
        delta = torch.where(is_pad, delta, new)
    return psi, delta


def _even_ranges(K, P):
    """[0, K) cut into P contiguous ranges of ceil(K / P) (the last ones
    shorter or empty, and empty ones dropped)."""
    Kp = -(-K // P)
    return [(k, min(k + Kp, K)) for k in range(0, K, Kp)]


def _csrc_constant(source, name):
    """The value of `constexpr int <name> = <n>;` in csrc/<source>."""
    text = (Path(vdp.__file__).parent / "csrc" / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


# the forward kernel's launch constants, read from its sources
_CLUSTER = _csrc_constant("cluster.cuh", "kCluster")
_FWD_THREADS = _csrc_constant("viterbi_dp.cu", "kFwdThreads")
_CHAINS = _csrc_constant("viterbi_dp.cu", "kChains")


def _kernel_ranges(K, C=_CLUSTER, threads=_FWD_THREADS, chains=_CHAINS):
    """The k ranges of one column in `viterbi_fwd_cluster_kernel`, in
    order: the parts of the CTA's threads (threads // Wp of them, Wp = W
    rounded up to a warp, at most `threads`), each cut into `chains` chains
    of (k1 - k0) // chains sources, the last chain taking the rest."""
    W = -(-K // C)
    Wp = min(-(-max(W, 1) // 32) * 32, threads)
    out = []
    for k0, k1 in _even_ranges(K, threads // Wp):
        m = (k1 - k0) // chains
        if m == 0:
            out.append((k0, k1))
        else:
            out += [(k0 + u * m, k0 + (u + 1) * m) for u in range(chains - 1)]
            out.append((k0 + (chains - 1) * m, k1))
    return out


_EMU_T, _EMU_LENGTHS = 12, [12, 1, 0, 9]


def _tie_heavy(kind, K):
    """A tie-heavy problem at K states, as numpy: the serve's left-to-right
    model (off-band transitions and log_pi NEG_INF), alone or under a
    lexicon of four-state words (tmask, smask and the initial penalty from
    `compiled_penalties`).  Returns (A, em, d0, tmask, smask)."""
    from repro_torch.core import LexiconConstraint, compiled_penalties
    g = np.random.default_rng(1000 + K + len(kind))
    B, T = len(_EMU_LENGTHS), _EMU_T
    hmm = left_to_right_hmm(g, K, 16, device=CPU)
    lp, A = hmm.log_pi.numpy(), hmm.log_A.numpy()
    em = (2.0 * g.standard_normal((B, T + 1, K))).astype(np.float32)
    if kind == "left_to_right":
        return A, em[:, 1:], lp[None] + em[:, 0], None, None
    words = tuple((tuple(range(s, min(s + 4, K))),) for s in range(0, K, 4))
    t_pen, pi_pen, s_pen = compiled_penalties(LexiconConstraint(words), K,
                                              T + 1)
    d0 = (lp + pi_pen)[None] + (em[:, 0] + s_pen[0])
    return A, em[:, 1:], d0, t_pen, s_pen[1:]


_JAX_FORWARD = {}


def _jax_forward(kind, K):
    """JAX's `viterbi_forward_batch` (its Pallas kernel in interpret mode
    where K % 128 == 0, else its ref fallback) over the pre-masked inputs,
    and its masked kernel over the unfused ones; cached per problem."""
    key = (kind, K)
    if key not in _JAX_FORWARD:
        A, em, d0, tm, sm = _tie_heavy(kind, K)
        lengths = jnp.asarray(_EMU_LENGTHS)
        A2 = A if tm is None else A + tm
        em2 = em if sm is None else em + sm[None]
        plain = jops.viterbi_forward_batch(A2, em2, d0, lengths)
        masked = (None if tm is None else jops.viterbi_forward_batch_masked(
            A, em, d0, lengths, tmask=tm, smask=sm))
        _JAX_FORWARD[key] = (plain, masked)
    return _JAX_FORWARD[key]


def _emulate(kind, K, C, ranges):
    """The emulated kernel on the problem, with log_A + tmask pre-added as
    the masked instances' slices hold it; also returns the plain version's
    result and the inputs."""
    A, em, d0, tm, sm = _tie_heavy(kind, K)
    pad = torch.arange(_EMU_T)[None, :] >= torch.tensor(_EMU_LENGTHS)[:, None]
    tmask = None if tm is None else _t(tm)
    smask = None if sm is None else _t(sm)
    A_slice = _t(A) if tmask is None else _t(A) + tmask
    got = _cluster_forward(A_slice, _t(em), _t(d0), pad, C, ranges, smask)
    want = ref.viterbi_forward_masked_pen_ref(_t(A), _t(em), _t(d0), pad,
                                              tmask, smask)
    return got, want


@pytest.mark.parametrize("kind", ["left_to_right", "lexicon"])
@pytest.mark.parametrize("K", [1, 3, 100, 512])
@pytest.mark.parametrize("P", [1, 2, 4, 7])
@pytest.mark.parametrize("C", [1, 8, 16])
def test_cluster_reduction_matches_plain_and_jax(C, P, K, kind):
    """C column slices, each column's sources in P contiguous parts: psi
    and delta_T equal the plain version and JAX's kernel bitwise, ragged
    lengths 12, 1, 0 and 9 included."""
    (psi, dT), (psi_r, dT_r) = _emulate(kind, K, C, _even_ranges(K, P))
    assert torch.equal(psi, psi_r) and torch.equal(dT, dT_r)
    (psi_j, dT_j), _ = _jax_forward(kind, K)
    assert _eq(psi, psi_j) and _eq(dT, dT_j)


@pytest.mark.parametrize("K", [1, 3, 100, 512, 665, 672, 1024, 1500])
def test_kernel_split_matches_plain(K):
    """The kernel's own split (its cluster size, thread parts cut into
    chains; K = 665 is the largest resident K, 672 the global instance, 1024
    and 1500 the smoke's global shapes) on the tie-heavy lexicon problem."""
    ranges = _kernel_ranges(K)
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    (psi, dT), (psi_r, dT_r) = _emulate("lexicon", K, _CLUSTER, ranges)
    assert torch.equal(psi, psi_r) and torch.equal(dT, dT_r)


@pytest.mark.parametrize("K", [3, 100, 128, 512])
def test_pre_added_tmask_slice_matches_unfused_masked_kernel(K):
    """The masked instances score cur[k] + (log_A + tmask)[k, j] from a slice
    to which tmask was added once: the same psi and delta_T as JAX's masked
    kernel, which adds tmask inside the kernel, and as the plain version."""
    (psi, dT), (psi_r, dT_r) = _emulate("lexicon", K, _CLUSTER,
                                        _kernel_ranges(K))
    _, (psi_j, dT_j) = _jax_forward("lexicon", K)
    assert _eq(psi, psi_j) and _eq(dT, dT_j)
    assert torch.equal(psi, psi_r) and torch.equal(dT, dT_r)


# --- the banded kernel (one cluster per window) ---------------------------
#
# `viterbi_banded_fwd` runs the forward template's step over a Kb-wide
# window: the window's columns split across the cluster's CTAs, each
# column's sources cut into the template's parts and chains, scanned with a
# strict '>' and combined in ascending order, each step's block of log_A
# read from L2.  The CPU runs the plain version, so these tests hold the
# arithmetic: the decode against JAX's windowed scan at the map-matching
# width and the degenerate ones, and the kernel's split emulated.


def _banded_case(case):
    """(K, T, width, centers) of a banded decode case."""
    widths = {"map_matching": 96, "idle_ctas": 4, "kb_is_k": 40, "width0": 0,
              "narrow": 2, "T1": 5, "clipped": 5}
    K = 233 if case == "map_matching" else 40
    T = 1 if case == "T1" else 7
    centers = tuple(int(c) for c in np.linspace(-20, K + 20, T))
    return K, T, widths[case], centers


@pytest.mark.parametrize("case", ["map_matching", "idle_ctas", "kb_is_k",
                                  "width0", "narrow", "T1", "clipped"])
def test_viterbi_decode_banded_edges_match_jax(case):
    """The map-matching width (Kb = 193), Kb = 9 (W = 2: three CTAs own no
    column), Kb = K (every start 0), width 0 (Kb = 1), Kb = 5 (CTAs that own
    no column), a single step and a band clipped at both ends: path and
    score bitwise equal to JAX's windowed scan, psi and delta_w to the plain
    version's."""
    K, T, width, centers = _banded_case(case)
    hmm, (lp, la) = _hmm(31 + K, K, edge_prob=1.0)
    em = random_emissions(np.random.default_rng(32 + T), T, K, device=CPU)
    p, s = ops.viterbi_decode_banded(hmm.log_pi, hmm.log_A, em, centers,
                                     width=width)
    p_j, s_j = jops.viterbi_decode_banded(lp, la, em.numpy(), centers,
                                          width=width)
    assert _eq(p, p_j) and float(s) == float(s_j)
    Kb = min(2 * width + 1, K)
    c, starts = ops.band_windows(centers, K, width)
    if case == "kb_is_k":
        assert Kb == K and not starts.any()
    psi, dw = vdp.viterbi_banded_forward(hmm.log_A, hmm.log_pi, em, c,
                                         starts, width)
    assert psi.shape == (T - 1, Kb) and dw.shape == (Kb,)
    psi_r, dw_r = ref.viterbi_banded_forward_ref(hmm.log_A, hmm.log_pi, em,
                                                 c, starts, width)
    assert torch.equal(psi, psi_r) and torch.equal(dw, dw_r)


def _cluster_banded(A, lp, em, c, starts, width, C, ranges):
    """The banded kernel's forward pass emulated: at each step the window's
    Kb columns in C slices of W = ceil(Kb / C), each column's sources cut
    into the contiguous `ranges` (ascending, covering [0, Kb)), each range
    scanned with a strict '>', the ranges combined in ascending order, a
    later one winning only if strictly greater; then best + (em + pen)."""
    T, K = em.shape
    Kb = min(2 * width + 1, K)
    W = -(-Kb // C)
    idx = starts.long()[:, None] + torch.arange(Kb)
    pen = torch.where((idx - c.long()[:, None]).abs() <= width,
                      torch.tensor(0.0), torch.tensor(-1.0e9))
    em_w = em.gather(1, idx) + pen
    delta = lp[idx[0]] + em_w[0]
    psi = torch.empty((T - 1, Kb), dtype=torch.int32)
    for t in range(1, T):
        a = A[idx[t - 1][:, None], idx[t][None, :]]
        new = torch.empty(Kb)
        for r in range(C):
            c0, c1 = min(r * W, Kb), min((r + 1) * W, Kb)
            if c0 == c1:            # a CTA that owns no column
                continue
            best = arg = None
            for k0, k1 in ranges:
                v, i = _first_max((delta[k0:k1, None] + a[k0:k1, c0:c1])[None])
                v, i = v[0], i[0] + k0
                if best is None:
                    best, arg = v, i
                else:               # a later range wins only if greater
                    take = v > best
                    best = torch.where(take, v, best)
                    arg = torch.where(take, i, arg)
            new[c0:c1] = best + em_w[t, c0:c1]
            psi[t - 1, c0:c1] = arg.to(torch.int32)
        delta = new
    return psi, delta


def _tie_heavy_band(kind, K, T, width):
    """A tie-heavy banded problem: the serve's left-to-right model (off-band
    transitions and log_pi NEG_INF), alone or with a lexicon of four-state
    words folded into log_A (log_A + tmask, as a constrained decode's
    inputs), under a band that sweeps the states clipped at both ends.
    Returns numpy (log_pi, log_A, em) and the centers."""
    from repro_torch.core import LexiconConstraint, compiled_penalties
    g = np.random.default_rng(2000 + K + width + len(kind))
    hmm = left_to_right_hmm(g, K, 8, device=CPU)
    lp, A = hmm.log_pi.numpy(), hmm.log_A.numpy()
    if kind == "lexicon":
        words = tuple((tuple(range(s, min(s + 4, K))),)
                      for s in range(0, K, 4))
        t_pen, pi_pen, _ = compiled_penalties(LexiconConstraint(words), K, T)
        A, lp = A + t_pen, lp + pi_pen
    em = (2.0 * g.standard_normal((T, K))).astype(np.float32)
    centers = tuple(int(x) for x in np.linspace(-8, K + 8, T))
    return lp, A, em, centers


def _check_banded_emulation(kind, K, T, width, C, ranges):
    lp, A, em, centers = _tie_heavy_band(kind, K, T, width)
    c, starts = ops.band_windows(centers, K, width)
    psi, dw = _cluster_banded(_t(A), _t(lp), _t(em), c, starts, width, C,
                              ranges)
    psi_r, dw_r = ref.viterbi_banded_forward_ref(_t(A), _t(lp), _t(em), c,
                                                 starts, width)
    assert torch.equal(psi, psi_r) and torch.equal(dw, dw_r)
    p_j, s_j = jops.viterbi_decode_banded(lp, A, em, centers, width=width)
    loc, sc = ref.viterbi_backtrack_ref(psi[None], dw[None])
    assert _eq(starts + loc[0], p_j) and float(sc[0]) == float(s_j)
    return psi


@pytest.mark.parametrize("kind", ["left_to_right", "lexicon"])
@pytest.mark.parametrize("P", [1, 2, 4, 7])
@pytest.mark.parametrize("C", [1, 8, 16])
def test_banded_cluster_reduction_matches_plain_and_jax(C, P, kind):
    """The window's columns in C slices, each column's sources in P
    contiguous parts, on tie-heavy models: psi and delta_w bitwise equal to
    the plain version, the decoded path and score to JAX's windowed scan."""
    K, T, width = 64, 12, 12
    Kb = 2 * width + 1
    psi = _check_banded_emulation(kind, K, T, width, C, _even_ranges(Kb, P))
    if kind == "left_to_right":     # ties decide psi: the lowest index wins
        assert int((psi == 0).sum()) > psi.numel() // 4


@pytest.mark.parametrize("width", [0, 2, 4, 8, 12, 96, 127, 227])
def test_banded_kernel_split_matches_plain_and_jax(width):
    """The kernel's own split over the window (its cluster size, thread
    parts cut into chains) at Kb = 1, 5, 9 and 17 (7, 3, 3 and 2 CTAs that
    own no column), 25, the map-matching 193, 255 and 455, on the lexicon
    model."""
    Kb = 2 * width + 1
    K = max(64, Kb + 20)
    ranges = _kernel_ranges(Kb)
    assert ranges[0][0] == 0 and ranges[-1][1] == Kb
    _check_banded_emulation("lexicon", K, 6, width, _CLUSTER, ranges)


# --- the tropical product: argmax and values-only instances ---------------


def _trop_inputs(seed, kind, *shapes):
    g = np.random.default_rng(seed)
    if kind == "integer":           # small integers: most maxima tie
        return [g.integers(-3, 4, s).astype(np.float32) for s in shapes]
    return [g.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("kind", ["normal", "integer"])
@pytest.mark.parametrize("N,I,K,J", [(5, 7, 9, 6), (3, 64, 64, 64),
                                     (2, 65, 33, 70)])
def test_tropical_values_only_matches_jax_assoc_combine(N, I, K, J, kind):
    """`with_args=False` (the assoc scan's combine) returns no argmax and
    the same vals as the argmax instance, bitwise equal to JAX's values-only
    `_tropical_matmul`, in float32."""
    from repro.core.assoc import _tropical_matmul as j_combine
    from repro_torch.kernels import tropical as tr
    a, b = _trop_inputs(N * 100 + I, kind, (N, I, K), (N, K, J))
    vals, args = tr.tropical_matmul_batch(_t(a), _t(b), with_args=False)
    assert args is None and vals.shape == (N, I, J)
    assert _eq(vals, j_combine(a, b))
    v_args, _ = tr.tropical_matmul_batch(_t(a), _t(b))
    assert torch.equal(vals, v_args)


@pytest.mark.parametrize("kind", ["normal", "integer"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("I,K,J", [(65, 33, 70), (3, 5, 7), (130, 100, 131)])
def test_tropical_ragged_tiles_and_ties_match_jax(I, K, J, dtype, kind):
    """Shapes that no tile of the kernel (64 x 64 outputs, chunks of 32
    along K) or of the JAX wrapper divides, on normal and tie-heavy integer
    inputs: vals and the clamped argmax bitwise equal to JAX's
    `ops.tropical_matmul` (its Pallas kernel in interpret mode)."""
    a, b = _trop_inputs(I * 7 + J, kind, (I, K), (K, J))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    v, arg = ops.tropical_matmul(_t(a).to(tdt), _t(b).to(tdt))
    v_j, arg_j = jops.tropical_matmul(jnp.asarray(a).astype(jdt),
                                      jnp.asarray(b).astype(jdt))
    assert v.dtype == tdt and arg.dtype == torch.int32
    assert np.array_equal(v.float().numpy(), np.asarray(v_j, np.float32))
    assert _eq(arg, arg_j)
    if kind == "integer":           # ties: the lowest k wins
        assert int((arg == 0).sum()) > 0


# --- the backtrack kernel (one cluster per sequence) ----------------------
#
# `viterbi_backtrack_batch` cuts the walk into pieces: CTA r of a cluster
# owns psi rows [r R, (r + 1) R), R = ceil(T / C), cut into S sub-blocks;
# each sub-block's map (the state at its first row for every state after
# its last) is composed for all K states, the CTA's whole map from those,
# and the first thread of each sub-block stitches its end state from the
# argmax through the later CTAs' whole maps and its CTA's later sub-blocks,
# then walks its rows.  The CPU runs the plain version, so these tests hold
# that schedule, emulated here, and the kernel's block argmax, bitwise.

_BT_THREADS = _csrc_constant("viterbi_dp.cu", "kBtThreads")
_BT_MAX_SUB = _csrc_constant("viterbi_dp.cu", "kBtMaxSub")
_NO_INDEX = np.iinfo(np.int32).max


def _bt_better(v, i, bv, bi):
    return v > bv or (v == bv and i < bi)


def _warp_reduce(v, i):
    """The kernel's shuffle tree over one warp's (value, index) pairs: at
    each distance m lane l takes lane l ^ m's pair if it is better."""
    for m in (16, 8, 4, 2, 1):
        v, i = zip(*[(v[l ^ m], i[l ^ m])
                     if _bt_better(v[l ^ m], i[l ^ m], v[l], i[l])
                     else (v[l], i[l]) for l in range(32)])
    return v[0], i[0]


def _block_argmax(d, threads=_BT_THREADS):
    """The kernel's argmax of one delta_T row: thread x scans x, x +
    threads, ... upward with a strict '>' (its first entry taken whatever
    its value), each warp reduces by shuffles, then warp 0 over the warps'
    results (lanes past the last warp hold no entry)."""
    d = np.asarray(d, np.float32)
    vals, idx = [-np.inf] * threads, [_NO_INDEX] * threads
    for x in range(threads):
        for k in range(x, len(d), threads):
            if idx[x] == _NO_INDEX or d[k] > vals[x]:
                vals[x], idx[x] = d[k], k
    part = [_warp_reduce(vals[w:w + 32], idx[w:w + 32])
            for w in range(0, threads, 32)]
    pad = 32 - len(part)
    return _warp_reduce([p[0] for p in part] + [-np.inf] * pad,
                        [p[1] for p in part] + [_NO_INDEX] * pad)[1]


def _bt_subblocks(T):
    """Every sub-block count the kernel can take at T steps: powers of two
    up to kBtMaxSub and R (it takes the largest whose maps fit)."""
    R = -(-T // _CLUSTER)
    most = 1
    while 2 * most <= min(_BT_MAX_SUB, R):
        most *= 2
    return [1 << e for e in range(most.bit_length())]


def _cluster_backtrack(psi, dT, S, C=_CLUSTER):
    """The kernel's schedule on numpy psi (B, T, K) and dT (B, K) with S
    sub-blocks a CTA: (paths (B, T + 1), scores (B,))."""
    B, T, K = psi.shape
    R = -(-T // C)
    row0 = [min(c * R, T) for c in range(C + 1)]
    paths = np.full((B, T + 1), -1, np.int32)
    scores = np.empty(B, np.float32)
    for b in range(B):
        q_last = _block_argmax(dT[b])
        maps, whole, blocks = {}, {}, {}
        for r in range(C):                       # compose, then whole maps
            r0, n = row0[r], row0[r + 1] - row0[r]
            Ls = -(-n // S)
            nsub = 0 if Ls == 0 else -(-n // Ls)
            blocks[r] = [(r0 + j * Ls, r0 + min((j + 1) * Ls, n))
                         for j in range(nsub)]
            for j, (s0, s1) in enumerate(blocks[r]):
                f = np.arange(K)
                for t in range(s1 - 1, s0 - 1, -1):
                    f = psi[b, t][f]
                maps[r, j] = f
            if n:
                F = np.arange(K)
                for j in range(nsub - 1, -1, -1):
                    F = maps[r, j][F]
                whole[r] = F
        for r in range(C):                       # stitch, then fill
            for j, (s0, s1) in enumerate(blocks[r]):
                q = q_last
                for c in range(C - 1, r, -1):
                    if c in whole:
                        q = whole[c][q]
                for i in range(len(blocks[r]) - 1, j, -1):
                    q = maps[r, i][q]
                for t in range(s1 - 1, s0 - 1, -1):
                    q = psi[b, t, q]
                    paths[b, t] = q
        paths[b, T] = q_last
        scores[b] = dT[b, q_last]
    return paths, scores


def _backtrack_case(kind, T, K):
    """(psi, dT) as numpy: uniformly random states in [0, K) ("random"), or
    those with identity rows: the pad tails of lengths T, 1 and 0 and every
    fifth row ("identity_rows")."""
    g = np.random.default_rng(T * 1000 + K + len(kind))
    B = 2 if kind == "random" else 3
    psi = g.integers(0, K, (B, T, K)).astype(np.int32)
    if kind == "identity_rows":
        eye = np.arange(K, dtype=np.int32)
        for b, length in enumerate((T, 1, 0)):
            psi[b, length:] = eye
        psi[:, ::5] = eye
    dT = g.integers(-2, 3, (B, K)).astype(np.float32)   # ties in the argmax
    return psi, dT


@pytest.mark.parametrize("kind", ["random", "identity_rows"])
@pytest.mark.parametrize("K", [1, 3, 64, 193, 512])
@pytest.mark.parametrize("T", [0, 1, 2, 7, 8, 9, 63, 64, 511, 4095])
def test_cluster_backtrack_matches_plain(T, K, kind):
    """The kernel's schedule (its cluster size and every sub-block count it
    can take, from its sources): compose, whole maps, stitch and fill give
    paths and scores bitwise equal to the plain version, on random-state
    psi (where a wrong composition shows) and psi with identity rows, T
    smaller than the cluster and than the sub-blocks included."""
    psi, dT = _backtrack_case(kind, T, K)
    paths_r, scores_r = ref.viterbi_backtrack_ref(_t(psi), _t(dT))
    for S in _bt_subblocks(T):
        paths, scores = _cluster_backtrack(psi, dT, S)
        assert np.array_equal(paths, paths_r.numpy()), S
        assert np.array_equal(scores.view(np.int32),
                              scores_r.numpy().view(np.int32)), S


def _tie_rows(kind, K):
    """delta_T rows on which the argmax is all ties."""
    g = np.random.default_rng(K)
    if kind == "all_equal":
        return [np.full(K, 0.5, np.float32)]
    if kind == "boundary_ties":    # the max at x and x + 1, x + 32, ...
        rows = []
        for x in (0, 31, 32, 511, 512):
            d = np.full(K, -1.0, np.float32)
            d[[k for k in (x, x + 1, x + 32, x + 512) if k < K]] = 2.0
            rows.append(d)
        return rows
    if kind == "inf":
        d = g.integers(-2, 3, K).astype(np.float32)
        d[g.integers(0, K, 3)] = np.inf
        d2 = np.full(K, -np.inf, np.float32)
        d3 = d2.copy()
        d3[-1] = 0.0
        return [d, d2, d3]
    if kind == "neg_inf":          # constraints' NEG_INF = -1e9 ties
        d = np.full(K, -1e9, np.float32)
        d2 = d.copy()
        d2[g.integers(0, K, 4)] = -1e9 + 64.0
        return [d, d2]
    return [g.integers(-1, 1, K).astype(np.float32)]   # "integer"


@pytest.mark.parametrize("threads", [_BT_THREADS, 64, 32])
@pytest.mark.parametrize("kind", ["all_equal", "boundary_ties", "inf",
                                  "neg_inf", "integer"])
def test_block_argmax_matches_plain(kind, threads):
    """The kernel's argmax combine (strided upward scans with a strict '>',
    then shuffle trees preferring the larger value and, between equal ones,
    the lower index) equals the plain version's lowest-index argmax on
    tie-heavy rows, at the kernel's block size and at smaller ones (more
    entries a thread, ties across thread boundaries)."""
    for K in (1, 3, 33, 64, 512, 513, 1500):
        for d in _tie_rows(kind, K):
            psi = torch.zeros((1, 0, K), dtype=torch.int32)
            want = int(ref.viterbi_backtrack_ref(psi, _t(d)[None])[0][0, 0])
            assert _block_argmax(d, threads) == want == int(np.argmax(d)), K
