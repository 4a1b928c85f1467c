"""FLASH-BS Viterbi: the dynamic beam search variant (paper Sec. V-C), as in
`repro.core.flash_bs`.

The paper keeps the running top-B candidates in a pair of double-buffered
min-heaps so that the K-vector of scores is never materialised.  The JAX
package streams target states in chunks of C instead: each (B x C) candidate
block is reduced per target over the beam and merged into the running top-B
(stable `lax.top_k` over B + C entries, seeded with B sentinel entries).
The merge is stable and the chunks come in target order, so the result does
not depend on C: it is the stable top-B of the B sentinels followed by every
target's best candidate.  C only sets the padded state count K_pad.

Here each pass is one launch of the hand-written beam kernel over all beams
in flight, with the time loop, the pad identity and the division / midpoint
bookkeeping inside it: the initial pass over every sequence of a batch
(`kernels.beam_stream.bs_initial_pass_batch`), then one launch per layer of
the wavefront (or per `lanes` group) over every tile of every sequence
(`bs_segment_decode_batch`).

The divide-and-conquer wavefront is shared with `flash.py`; only the
per-tile DP differs.  A tile's pinned exit state may be absent from the
child's final beam under narrow beams; the tile then falls back to the best
beam element (the paper's beam approximation, Fig. 9).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels.beam_stream import (bs_initial_pass_batch,
                                   bs_segment_decode_batch)
from ..kernels.ref import BEAM_SENTINEL
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
# The two beam passes: one kernel launch each
# ---------------------------------------------------------------------------

def _bs_initial_pass(log_pi, log_A, em, pad, boundaries: np.ndarray, B: int):
    """The beam over every full sequence of the batch, tracking the P-1
    division states: em (Bt, Tp, K_pad), pad (Bt, Tp) -> (q_bounds (Bt, nb),
    q_last (Bt,), score (Bt,)), the states as int64."""
    q_bounds, q_last, score = bs_initial_pass_batch(log_pi, log_A, em, pad,
                                                    boundaries, B)
    return q_bounds.long(), q_last.long(), score


def _bs_segment_decode(log_pi, log_A, em_seg, pad_seg, entry, exit_state,
                       is_first, B: int):
    """The pruned beam DP over M tiles -> their midpoint states (M,)."""
    return bs_segment_decode_batch(log_pi, log_A, em_seg, pad_seg, entry,
                                   exit_state, is_first, B)


# ---------------------------------------------------------------------------
# Full decoder
# ---------------------------------------------------------------------------

def _flash_bs_padded(log_pi, log_A, em, pad, P: int, lanes, B: int):
    """FLASH-BS over a batch: em (Bt, Tp, K_pad), pad (Bt, Tp).

    Returns (q_star (Bt, Tp) int64, score (Bt,))."""
    Tp = em.shape[1]
    boundaries = (np.arange(1, P) * (Tp // P) - 1).astype(np.int64)
    q_bounds, q_last, score = _bs_initial_pass(log_pi, log_A, em, pad,
                                               boundaries, B)
    q_star = pin_bounds(q_bounds, q_last, Tp, boundaries)

    def decode_tiles(em_seg, pad_seg, entry, exit_state, is_first):
        return _bs_segment_decode(log_pi, log_A, em_seg, pad_seg, entry,
                                  exit_state, is_first, B)

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
                            lanes, B)
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


#: The analysis gate's findings this module makes by design (`analysis.findings`
#: has the grammar; PERF.md records the measured ratios).
FLASHPROVE_WAIVERS = {
    "PV104:dispatch:*:flash_bs": (
        "the emissions padded to Tp steps and K_pad states, a (Tp, K_pad) "
        "float32 copy the O(P B) beam model leaves out; on the CPU the beam "
        "passes' plain versions also gather (lanes, K, K) score blocks"),
    "PV103:dispatch:cpu:flash_bs:batch": (
        "the plain beam passes gather and broadcast a (batch x lanes, K, K) "
        "score block for one time step on the CPU: a per-step working set, "
        "not retained state; the kernels on the card never materialise it "
        "and the beam carry the planner models stays O(lanes x B)"),
    "PV104:memory:cuda:flash_bs": (
        "the (Tp, K_pad) padded emissions copy, 1 MB at (K, T) = (512, 511), "
        "on the card's allocator: 66.7x the model, over JAX's 64"),
}

__all__ = ["flash_bs_viterbi", "pad_state_space"]
