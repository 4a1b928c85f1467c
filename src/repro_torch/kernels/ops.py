"""Public wrappers around the fused Viterbi kernels, as in `repro.kernels.ops`.

Same functions, signatures and results as the JAX package's ops, without the
TPU's fit rules (`_kernel_fits` and `_kernel_fits_masked`: 12 MiB of VMEM,
K % 128): the Hopper kernels take any K >= 1, and no shape falls back to
another path.  ``bt`` stays in the signatures for parity; it has no effect
on the card, whose kernels run the whole time loop in one block per
sequence.  The TPU's ``interpret`` and ``vmem_limit_bytes`` have no
counterpart.  `tropical_matmul` and `beam_step` keep the JAX wrappers'
padding (and the argmax clamp) so that their results match bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .beam_stream import beam_step_batch
from .ref import BEAM_SENTINEL, NEG_INF
from .tropical import tropical_matmul_batch
from .viterbi_dp import viterbi_backtrack_batch
from .viterbi_dp import viterbi_banded_forward as _banded_fwd
from .viterbi_dp import viterbi_forward as _fwd
from .viterbi_dp import viterbi_forward_batch as _fwd_batch
from .viterbi_dp import viterbi_forward_batch_masked as _fwd_batch_masked


def _pad_mask(T: int, lengths, device: torch.device) -> torch.Tensor:
    """(B, T) float32, 1.0 where step t >= lengths[b] (a tropical identity)."""
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=device)
    steps = torch.arange(T, dtype=torch.int32, device=device)
    return (steps[None, :] >= lengths[:, None]).to(torch.float32)


def viterbi_forward(log_A: torch.Tensor, em: torch.Tensor,
                    delta0: torch.Tensor, *, bt: int = 8):
    """Fused Viterbi forward pass.

    em covers steps 1..T (delta0 is step 0). Returns (psi (T,K) i32, delta_T).
    """
    T, K = em.shape
    if T == 0:
        return torch.zeros((0, K), dtype=torch.int32, device=em.device), delta0
    return _fwd(log_A, em, delta0)


def viterbi_forward_batch(log_A: torch.Tensor, em: torch.Tensor,
                          delta0: torch.Tensor, lengths=None, *, bt: int = 8):
    """Batched fused forward pass over (B, T, K) emissions with ragged lengths.

    One kernel launch covers the whole batch.  `lengths[i]` counts the *real*
    rows of `em[i]` (delta0 is step 0 and always real); the remaining rows run
    as tropical-identity steps, so per-sequence results are bit-identical to
    `viterbi_forward` on the unpadded prefix.

    Returns (psi (B, T, K) int32, delta_T (B, K)).  psi rows at padded steps
    are the identity permutation.
    """
    B, T, K = em.shape
    if T == 0:
        return (torch.zeros((B, 0, K), dtype=torch.int32, device=em.device),
                delta0)
    pad = None if lengths is None else _pad_mask(T, lengths, em.device)
    return _fwd_batch(log_A, em, delta0, pad)


def viterbi_chunk_step(log_A: torch.Tensor, em_chunk: torch.Tensor,
                       delta: torch.Tensor, *, bt: int = 8):
    """One streaming DP advance: carry delta through a (C, K) emission chunk.

    Returns (psi (C, K) int32, delta' (K,)).
    """
    return viterbi_forward(log_A, em_chunk, delta, bt=bt)


def viterbi_slot_step(log_A: torch.Tensor, em: torch.Tensor,
                      delta: torch.Tensor, nfeed, *, bt: int = 8):
    """One inflight-batching advance: carry S slot deltas through a block.

    `em` is (S, block, K) with slot s holding `nfeed[s]` real emission rows
    (0 <= nfeed[s] <= block) followed by arbitrary padding.  Slots with
    `nfeed[s] == 0` run the whole block as tropical-identity steps: their
    delta comes back bit-identical and their psi rows are the identity.

    Returns (psi (S, block, K) int32, delta' (S, K)).
    """
    return viterbi_forward_batch(log_A, em, delta, nfeed, bt=bt)


def viterbi_decode_fused(log_pi: torch.Tensor, log_A: torch.Tensor,
                         em: torch.Tensor, *, bt: int = 8):
    """Full Viterbi decode: the fused forward kernel, then the backtrack kernel.

    Returns (path (T,) int32, score).
    """
    delta0 = log_pi + em[0]
    psi, delta_T = viterbi_forward(log_A, em[1:], delta0, bt=bt)
    paths, scores = viterbi_backtrack_batch(psi[None], delta_T[None])
    return paths[0], scores[0]


def viterbi_decode_fused_batch(log_pi: torch.Tensor, log_A: torch.Tensor,
                               em: torch.Tensor, lengths=None, *, bt: int = 8):
    """Batched full Viterbi decode: one forward launch, one backtrack launch.

    Args:
      em:      (B, T, K) emissions, row i real for the first lengths[i] steps.
      lengths: optional (B,) int true lengths (None means full length).

    Returns:
      (paths (B, T) int32, scores (B,)).  paths[i, t] for t >= lengths[i]
      repeat the sequence's final decoded state (the identity backpointers of
      the pad steps); slice to [:lengths[i]] for the true decode.
    """
    delta0 = log_pi[None, :] + em[:, 0, :]
    if em.shape[1] == 1:
        q = delta0.argmax(dim=1).to(torch.int32)
        return q[:, None], delta0.amax(dim=1)
    if lengths is not None:
        lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                  device=em.device)
        lengths = (lengths - 1).clamp(min=0)
    psi, delta_T = viterbi_forward_batch(log_A, em[:, 1:], delta0, lengths,
                                         bt=bt)
    return viterbi_backtrack_batch(psi, delta_T)


def _penalty(pen, like: torch.Tensor) -> torch.Tensor | None:
    """A compiled {0, NEG_INF} penalty (numpy or tensor) as a tensor of
    `like`'s dtype and device."""
    if pen is None:
        return None
    return torch.as_tensor(pen, dtype=like.dtype, device=like.device)


def viterbi_forward_batch_masked(log_A: torch.Tensor, em: torch.Tensor,
                                 delta0: torch.Tensor, lengths=None, *,
                                 tmask=None, smask=None, bt: int = 8):
    """Constraint-masked batched forward pass: one masked-kernel launch.

    `tmask` (K, K) / `smask` (T, K) are additive f32 penalties ({0, NEG_INF},
    compiled by `core.constraints`); `smask` row t masks `em[:, t]` and is
    shared across the batch.  Results are bit-identical to
    `viterbi_forward_batch(log_A + tmask, em + smask, ...)` without the
    masked operands ever being materialised.
    """
    B, T, K = em.shape
    tmask = _penalty(tmask, em)
    smask = _penalty(smask, em)
    if T == 0:
        return (torch.zeros((B, 0, K), dtype=torch.int32, device=em.device),
                delta0)
    pad = None if lengths is None else _pad_mask(T, lengths, em.device)
    return _fwd_batch_masked(log_A, em, delta0, pad, tmask, smask)


def viterbi_decode_fused_masked(log_pi: torch.Tensor, log_A: torch.Tensor,
                                em: torch.Tensor, *, t_pen=None, pi_pen=None,
                                s_pen=None, bt: int = 8):
    """Constrained fused decode: penalty adds fused into the DP step.

    The penalties come from `core.constraints.compiled_penalties`; every add
    here reproduces `constrain_inputs`' elementwise adds operand for operand,
    so the result is bit-identical to `viterbi_decode_fused` over the
    pre-masked inputs.  Returns (path (T,) int32, score).
    """
    if pi_pen is not None:
        log_pi = log_pi + _penalty(pi_pen, log_pi)
    em0 = em[0]
    smask = None
    if s_pen is not None:
        s_pen = _penalty(s_pen, em)
        em0 = em0 + s_pen[0]
        smask = s_pen[1:]
    delta0 = log_pi + em0
    psi, delta_T = viterbi_forward_batch_masked(
        log_A, em[None, 1:], delta0[None], tmask=t_pen, smask=smask, bt=bt)
    paths, scores = viterbi_backtrack_batch(psi, delta_T)
    return paths[0], scores[0]


def viterbi_decode_fused_batch_masked(log_pi: torch.Tensor,
                                      log_A: torch.Tensor, em: torch.Tensor,
                                      lengths=None, *, t_pen=None,
                                      pi_pen=None, s_pen=None, bt: int = 8):
    """Constrained batched fused decode (ragged lengths, shared schedule).

    The per-step penalty indexes *absolute* step t, so ragged tails never
    reach the later rows; pad steps stay tropical identities.  Bit-identical
    to `viterbi_decode_fused_batch` over pre-masked inputs.
    """
    if pi_pen is not None:
        log_pi = log_pi + _penalty(pi_pen, log_pi)
    em0 = em[:, 0, :]
    smask = None
    if s_pen is not None:
        s_pen = _penalty(s_pen, em)
        em0 = em0 + s_pen[0][None]
        smask = s_pen[1:]
    delta0 = log_pi[None, :] + em0
    if em.shape[1] == 1:
        q = delta0.argmax(dim=1).to(torch.int32)
        return q[:, None], delta0.amax(dim=1)
    if lengths is not None:
        lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                  device=em.device)
        lengths = (lengths - 1).clamp(min=0)
    psi, delta_T = viterbi_forward_batch_masked(
        log_A, em[:, 1:], delta0, lengths, tmask=t_pen, smask=smask, bt=bt)
    return viterbi_backtrack_batch(psi, delta_T)


def band_windows(centers, K: int, width: int):
    """(centers clipped into [0, K-1], window starts clipped into
    [0, K - Kb]) as (T,) int32 CPU tensors, Kb = min(2*width + 1, K)."""
    Kb = min(2 * width + 1, K)
    c = np.clip(np.asarray(centers, np.int64), 0, K - 1)
    starts = np.clip(c - width, 0, K - Kb)
    return (torch.from_numpy(c.astype(np.int32)),
            torch.from_numpy(starts.astype(np.int32)))


def viterbi_decode_banded(log_pi: torch.Tensor, log_A: torch.Tensor,
                          em: torch.Tensor, centers, *, width: int):
    """Banded Viterbi decode: O(T * Kb^2) work, Kb = 2*width+1 window.

    At step t only states within `width` of `centers[t]` (clipped into
    [0, K-1]) are legal: the `BandConstraint` semantics.  The DP slides a
    contiguous Kb window over the state axis, so K-wide rows are never
    materialised: live state is the Kb frontier plus T windows of local
    backpointers (`core.constraints.banded_state_bytes`).  One launch of the
    banded kernel runs the forward pass; the backtrack kernel walks the local
    (T-1, Kb) backpointers, and the window starts map them back to states.

    Bit-identity with the dense masked decode holds because (a) the window
    always contains the whole allowed band, (b) the in-window penalty add is
    the same `em + s_pen` elementwise add the dense path performs, and (c)
    out-of-band states sit >= ~1e9 below every in-band score (NEG_INF is a
    finite sentinel), so they can neither win nor tie a max/argmax, and the
    contiguous window preserves dense argmax tie order.  Requires in-band
    states to keep feasible paths (dense `log_A`); with sparse transitions,
    pre-mask `log_A` instead.

    `centers` must cover the horizon (at least T entries; extra ones are
    ignored).  Returns (path (T,) int32 of *global* state ids, score).
    """
    T, K = em.shape
    w = int(width)
    if T == 0:
        raise ValueError("viterbi_decode_banded needs T >= 1")
    if len(centers) < T:
        raise ValueError(f"the band's {len(centers)} centers do not cover "
                         f"the horizon T={T}")
    c, starts = band_windows(centers[:T], K, w)
    c_dev, starts_dev = c.to(em.device), starts.to(em.device)
    psi, delta_w = _banded_fwd(log_A, log_pi, em, c_dev, starts_dev, w)
    loc, scores = viterbi_backtrack_batch(psi[None], delta_w[None])
    return (starts_dev + loc[0]).to(torch.int32), scores[0]


def _pad_to(x: torch.Tensor, axis: int, mult: int, value) -> torch.Tensor:
    """Pad `axis` of `x` up to a multiple of `mult` with `value`."""
    n = x.shape[axis]
    target = -(-n // mult) * mult
    if target == n:
        return x
    shape = list(x.shape)
    shape[axis] = target - n
    fill = torch.full(shape, value, dtype=x.dtype, device=x.device)
    return torch.cat([x, fill], dim=axis)


def tropical_matmul(a: torch.Tensor, b: torch.Tensor):
    """(max, +) product with argmax, arbitrary shapes: (I, K) x (K, J) ->
    (vals (I, J), args (I, J) int32).

    Pads with NEG_INF to the JAX wrapper's tiles (a pad column can only win
    on a pad row) and clamps the argmax to K - 1, as the JAX wrapper does;
    one launch of the batched kernel with N = 1.
    """
    I, K = a.shape
    J = b.shape[1]
    bi = 8 if I < 64 else 64
    bk = 8 if K < 16 else 16
    bj = 128 if J < 256 else 256
    ap = _pad_to(_pad_to(a, 0, bi, NEG_INF), 1, bk, NEG_INF)
    bp = _pad_to(_pad_to(b, 0, bk, NEG_INF), 1, bj, NEG_INF)
    vals, args = tropical_matmul_batch(ap[None].contiguous(),
                                       bp[None].contiguous())
    args = args[0].clamp(max=K - 1)
    return vals[0, :I, :J], args[:I, :J]


def beam_step(log_A: torch.Tensor, em_t: torch.Tensor, scores: torch.Tensor,
              states: torch.Tensor, *, chunk: int = 256):
    """One dynamic-beam transition, arbitrary K (padded to the chunk).

    As the JAX wrapper: ``chunk = min(chunk, ceil(K / 128) * 128)``, and
    log_A and em_t are padded to a multiple of it with -4e9.  One launch of
    the batched beam kernel with N = 1.  Returns (new_scores, new_states,
    from_slots), each (B,).
    """
    K = log_A.shape[0]
    chunk = min(chunk, -(-K // 128) * 128)
    Ap = _pad_to(_pad_to(log_A, 0, chunk, BEAM_SENTINEL), 1, chunk,
                 BEAM_SENTINEL).contiguous()
    em_p = _pad_to(em_t, 0, chunk, BEAM_SENTINEL)
    s, st, f = beam_step_batch(Ap, em_p[None], scores[None].contiguous(),
                               states[None].contiguous(), chunk)
    return s[0], st[0], f[0]


#: The analysis gate's findings this module makes by design
#: (`analysis.findings` has the grammar; PERF.md records the measured
#: ratios).
FLASHPROVE_WAIVERS = {
    "PV104:dispatch:cuda:constrained[": (
        "the band's centers and window starts travel to the card as int64 "
        "(T each) and the global path is their int64 sum before its int32 "
        "cast, beside the (T - 1, Kb) psi the banded model counts: 1.16x "
        "the model at (K, T, width) = (64, 256, 8) and (128, 384, 8)"),
}

__all__ = ["viterbi_forward", "viterbi_forward_batch", "viterbi_chunk_step",
           "viterbi_slot_step", "viterbi_decode_fused",
           "viterbi_decode_fused_batch", "viterbi_forward_batch_masked",
           "viterbi_decode_fused_masked", "viterbi_decode_fused_batch_masked",
           "viterbi_decode_banded", "band_windows", "tropical_matmul",
           "beam_step"]
