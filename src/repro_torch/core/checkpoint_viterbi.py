"""Checkpoint Viterbi [Tarnas & Hughey 1998], as in
`repro.core.checkpoint_viterbi`.

Baseline #2 of the paper: keep the delta vector only at the start of every
segment of ~sqrt(T) steps (checkpoints), then re-run each segment during
backtracking.  Space O(K sqrt(T)), time 2x the vanilla forward pass.  Plain
PyTorch loops over a (num_segments, seg_len, K) view: the JAX module holds no
Pallas kernel.  T is padded up to num_segments * seg_len with identity steps,
which leave delta, backpointers and the decoded prefix unchanged; step 0 is
one of them, since delta0 already covers it.
"""

from __future__ import annotations

import math

import torch

from .flash import _dp_step


def _run_segment(log_A, delta, em_s, mask_s):
    """The DP over one segment: (delta after it, its (seg_len, K) psis)."""
    psis = []
    for t in range(em_s.shape[0]):
        delta, psi = _dp_step(log_A, delta[None], em_s[t][None], mask_s[t][None])
        delta = delta[0]
        psis.append(psi[0])
    return delta, torch.stack(psis)


def _checkpoint_decode(log_pi, log_A, em_padded, pad_mask, seg_len: int):
    Tp, K = em_padded.shape
    n_seg = Tp // seg_len
    em_seg = em_padded.reshape(n_seg, seg_len, K)
    mask_seg = pad_mask.reshape(n_seg, seg_len).clone()
    mask_seg[0, 0] = True                # t = 0 is covered by delta0

    # forward: keep delta at each segment start
    delta = log_pi + em_padded[0]
    entries = []
    for i in range(n_seg):
        entries.append(delta)
        delta, _ = _run_segment(log_A, delta, em_seg[i], mask_seg[i])
    score, q = delta.max(dim=0)

    # backward: re-run each segment, then backtrack inside it
    states = [None] * n_seg
    for i in range(n_seg - 1, -1, -1):
        _, psis = _run_segment(log_A, entries[i], em_seg[i], mask_seg[i])
        seg = torch.empty((seg_len,), dtype=torch.long, device=em_padded.device)
        for t in range(seg_len - 1, -1, -1):
            seg[t] = q                   # the decoded state AT step t
            q = psis[t, q]
        states[i] = seg
    return torch.cat(states).to(torch.int32), score


def viterbi_checkpoint(log_pi, log_A, em, seg_len: int | None = None):
    """Checkpoint Viterbi decode. Returns ((T,) int32 path, score)."""
    T, K = em.shape
    if seg_len is None:
        seg_len = max(1, int(math.ceil(math.sqrt(T))))
    Tp = int(math.ceil(T / seg_len)) * seg_len
    em_p = torch.cat([em, em.new_zeros((Tp - T, K))])
    mask = torch.arange(Tp, device=em.device) >= T
    path, score = _checkpoint_decode(log_pi, log_A, em_p, mask, seg_len)
    return path[:T], score


#: The analysis gate's findings this module makes by design (`analysis.findings`
#: has the grammar; PERF.md records the measured ratios).
FLASHPROVE_WAIVERS = {
    "PV102:dispatch:*:checkpoint": (
        "each replayed segment backtracks on the host, indexing its psi with "
        "the previous state, a 0-d tensor: one sync a step"),
    "PV104:dispatch:*:checkpoint": (
        "the emissions padded to whole segments, a (T, K) float32 copy the "
        "sqrt(T) K model leaves out, dominate; a step's (K, K) scores and "
        "the segment's int64 psi add to it: 6.5-12x on the dispatch grid"),
    "PV104:memory:cuda:checkpoint": (
        "the same (T, K) padded copy and (K, K) scores on the card's "
        "allocator: 24.3x the model at (K, T) = (512, 511), over JAX's 16; "
        "both grow faster than the model's sqrt(T) K"),
}

__all__ = ["viterbi_checkpoint"]
