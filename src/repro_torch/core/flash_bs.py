"""FLASH-BS Viterbi: the dynamic beam search variant (paper Sec. V-C), as in
`repro.core.flash_bs`.

The paper keeps the running top-B candidates in a pair of double-buffered
min-heaps so that the K-vector of scores is never materialised.  The JAX
package streams target states in chunks of C instead: each (B x C) candidate
block is reduced per target over the beam and merged into the running top-B
(stable `lax.top_k` over B + C entries, seeded with B sentinel entries).
Here every beam transition is one launch of the hand-written beam kernel
(`kernels.beam_stream.beam_step_batch`) over all beams in flight: every
sequence of a batch in the initial pass, every tile of every sequence in a
layer of the wavefront.  The seeding top-B of a beam (no transition yet) and
the bookkeeping between steps are plain PyTorch.

The divide-and-conquer wavefront is shared with `flash.py`; only the
per-tile DP differs.  A tile's pinned exit state may be absent from the
child's final beam under narrow beams; the tile then falls back to the best
beam element (the paper's beam approximation, Fig. 9).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels.beam_stream import beam_step_batch
from ..kernels.ref import BEAM_SENTINEL, merge_top_b
from .flash import pad_time, pin_bounds, plan_padding, wavefront

_SENTINEL = BEAM_SENTINEL   # below any reachable (even unreachable-edge) score


def pad_state_space(log_pi, log_A, em, chunk: int):
    """Pad K up to a multiple of `chunk` with sentinel states.

    Fake states get sentinel/2 emissions and in/out transitions so they can
    never displace real candidates from the beam.  `em` may be (T, K) or
    batched (..., T, K); the state axis is always last.  Returns
    (log_pi, log_A, em, K_pad).
    """
    K = log_A.shape[0]
    K_pad = int(math.ceil(K / chunk)) * chunk
    if K_pad != K:
        fill = _SENTINEL / 2
        em = torch.cat([em, em.new_full((*em.shape[:-1], K_pad - K), fill)],
                       dim=-1)
        log_A = torch.cat([log_A, log_A.new_full((K, K_pad - K), fill)], 1)
        log_A = torch.cat([log_A, log_A.new_full((K_pad - K, K_pad), fill)])
        log_pi = torch.cat([log_pi, log_pi.new_full((K_pad - K,), fill)])
    return log_pi, log_A, em, K_pad


# ---------------------------------------------------------------------------
# Streaming top-B and the per-step bookkeeping
# ---------------------------------------------------------------------------

def _stream_top_b(values: torch.Tensor, chunk: int, B: int):
    """Top-B of (M, K_pad) scores, merged C at a time into a running top-B
    seeded with B sentinels.  Returns (scores (M, B), states (M, B) int32)
    sorted descending, the lower state first among ties."""
    M, K_pad = values.shape
    dev = values.device
    run = (torch.full((M, B), _SENTINEL, dtype=values.dtype, device=dev),
           torch.zeros((M, B), dtype=torch.int32, device=dev))
    for c0 in range(0, K_pad, chunk):
        st = torch.arange(c0, c0 + chunk, dtype=torch.int32,
                          device=dev).expand(M, chunk)
        run = merge_top_b(run, (values[:, c0:c0 + chunk], st), B)
    return run


def _pad_identity(is_pad, scores, states, ns, nst, nfrom):
    """Pad steps are tropical identities: beam unchanged, self backpointers.

    (A full carry-freeze would be wrong: mid/div assignments that fire on a
    pad step must still see identity backpointers, as in `flash._dp_step`.)
    """
    B = scores.shape[1]
    eye = torch.arange(B, dtype=torch.int32, device=scores.device)
    keep = is_pad[:, None]
    return (torch.where(keep, scores, ns), torch.where(keep, states, nst),
            torch.where(keep, eye, nfrom))


def _beam_step(log_A, em_t, is_pad, scores, states, chunk: int):
    """One beam transition of every beam (one kernel launch), then the pad
    identity.  Returns (scores, states, from_slots int64)."""
    ns, nst, nfrom = beam_step_batch(log_A, em_t, scores, states, chunk)
    ns, nst, nfrom = _pad_identity(is_pad, scores, states, ns, nst, nfrom)
    return ns, nst, nfrom.long()


# ---------------------------------------------------------------------------
# Initial pass (beam over the full sequence, tracking P-1 division states)
# ---------------------------------------------------------------------------

def _bs_initial_pass(log_pi, log_A, em, pad, boundaries: np.ndarray,
                     B: int, chunk: int):
    """em (Bt, Tp, K_pad), pad (Bt, Tp) -> (q_bounds (Bt, nb),
    q_last (Bt,), score (Bt,))."""
    Bt, Tp, _ = em.shape
    nb = len(boundaries)
    scores, states = _stream_top_b(log_pi + em[:, 0], chunk, B)
    div = torch.zeros((Bt, B, nb), dtype=torch.int32, device=em.device)
    for t in range(1, Tp):
        ns, nst, nfrom = _beam_step(log_A, em[:, t], pad[:, t], scores,
                                    states, chunk)
        if nb:   # follow the slots; a crossed boundary takes the old state
            div = div.gather(1, nfrom[:, :, None].expand(-1, -1, nb))
            for i in np.flatnonzero(boundaries + 1 == t):
                div[:, :, int(i)] = states.gather(1, nfrom)
        scores, states = ns, nst
    score, b_best = scores.max(dim=1)
    rows = torch.arange(Bt, device=em.device)
    return div[rows, b_best].long(), states[rows, b_best].long(), score


# ---------------------------------------------------------------------------
# Per-tile beam DP
# ---------------------------------------------------------------------------

def _bs_segment_decode(log_pi, log_A, em_seg, pad_seg, entry, exit_state,
                       is_first, B: int, chunk: int):
    """The pruned beam DP over M tiles -> their midpoint states (M,)."""
    s = em_seg.shape[1]
    tm = s // 2 - 1
    init = torch.where(is_first[:, None], log_pi, log_A[entry]) + em_seg[:, 0]
    scores, states = _stream_top_b(init, chunk, B)
    mid = None        # all zeros until the midpoint step: nothing to carry
    for tl in range(1, s):
        ns, nst, nfrom = _beam_step(log_A, em_seg[:, tl], pad_seg[:, tl],
                                    scores, states, chunk)
        if tl == tm + 1:
            mid = states.gather(1, nfrom)
        elif tl > tm + 1:
            mid = mid.gather(1, nfrom)
        scores, states = ns, nst
    # the exit state may have fallen off the beam: fall back to the best slot
    hit = states == exit_state[:, None]
    idx = torch.where(hit.any(dim=1), hit.int().argmax(dim=1),
                      scores.argmax(dim=1))
    return mid.gather(1, idx[:, None])[:, 0]


# ---------------------------------------------------------------------------
# Full decoder
# ---------------------------------------------------------------------------

def _flash_bs_padded(log_pi, log_A, em, pad, P: int, lanes, B: int,
                     chunk: int):
    """FLASH-BS over a batch: em (Bt, Tp, K_pad), pad (Bt, Tp).

    Returns (q_star (Bt, Tp) int64, score (Bt,))."""
    Tp = em.shape[1]
    boundaries = (np.arange(1, P) * (Tp // P) - 1).astype(np.int64)
    q_bounds, q_last, score = _bs_initial_pass(log_pi, log_A, em, pad,
                                               boundaries, B, chunk)
    q_star = pin_bounds(q_bounds, q_last, Tp, boundaries)

    def decode_tiles(em_seg, pad_seg, entry, exit_state, is_first):
        return _bs_segment_decode(log_pi, log_A, em_seg, pad_seg, entry,
                                  exit_state, is_first, B, chunk)

    return wavefront(decode_tiles, em, pad, q_star, P, lanes), score


def flash_bs_batch(log_pi, log_A, em, pad, beam_width: int, P: int, lanes,
                   chunk: int):
    """FLASH-BS over a padded batch em (Bt, T, K), pad (Bt, T) -> (paths
    (Bt, T) int32, scores (Bt,)); `lanes` already resolved."""
    T, K = em.shape[1:]
    B = int(min(beam_width, K))
    chunk = int(min(chunk, K))   # chunk == K degenerates to static beam search
    log_pi, log_A, em, _ = pad_state_space(log_pi, log_A, em, chunk)
    Tp, _ = plan_padding(T, P)
    em_p, pad_p = pad_time(em, pad, Tp)
    q, s = _flash_bs_padded(log_pi, log_A.contiguous(), em_p, pad_p, P,
                            lanes, B, chunk)
    return q[:, :T].to(torch.int32), s


def flash_bs_viterbi(log_pi, log_A, em, beam_width: int = 128,
                     parallelism: int = 8, lanes: int | None = -1,
                     chunk: int = 128):
    """FLASH-BS Viterbi decode (dynamic beam search).

    Returns (path (T,) int32, score).  With beam_width >= K this is exact
    (ties aside); narrower beams trade accuracy for time and memory (paper
    Fig. 9).
    """
    T, K = em.shape
    P = int(parallelism)
    if lanes == -1:
        lanes = P
    if T == 1:
        chunk = int(min(chunk, K))
        log_pi, _, em, _ = pad_state_space(log_pi, log_A, em, chunk)
        d0 = log_pi + em[0]
        q = d0.argmax()
        return q.to(torch.int32)[None], d0[q]
    pad = torch.zeros((1, T), dtype=torch.bool, device=em.device)
    path, score = flash_bs_batch(log_pi, log_A, em[None], pad, beam_width, P,
                                 lanes, chunk)
    return path[0], score[0]


__all__ = ["flash_bs_viterbi", "pad_state_space"]
