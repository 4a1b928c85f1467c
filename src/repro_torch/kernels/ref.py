"""Plain PyTorch versions of the port's kernels.

Each function is the semantic specification its CUDA kernel is held against
(on the card by `chip_smoke.py`) and what the kernel wrappers run for tensors
that lie on the CPU.  They mirror `repro.kernels.ref`: psi is int32 and every
argmax takes the lowest index among equal maxima, as `jnp.argmax` does
(`torch.max(dim=...)` and `torch.argmax` return the first maximal index).

Leading batch dimensions broadcast: ``em`` may be (T, K) or (B, T, K) with
``delta0`` (K,) or (B, K).
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1.0e9
#: the running top-B's seed value in the beam transition
BEAM_SENTINEL = -4.0e9


def _step(delta: torch.Tensor, log_A: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor]:
    scores = delta.unsqueeze(-1) + log_A          # (..., K_src, K_dst)
    best, psi = scores.max(dim=-2)                # first index among ties
    return best, psi.to(torch.int32)


def viterbi_forward_ref(log_A: torch.Tensor, em: torch.Tensor,
                        delta0: torch.Tensor):
    """Reference for the forward kernel: (psi (..., T, K) int32, delta_T)."""
    T = em.shape[-2]
    psi = torch.empty(em.shape, dtype=torch.int32, device=em.device)
    delta = delta0
    for t in range(T):
        best, psi[..., t, :] = _step(delta, log_A)
        delta = best + em[..., t, :]
    return psi, delta


def viterbi_forward_masked_ref(log_A: torch.Tensor, em: torch.Tensor,
                               delta0: torch.Tensor, pad: torch.Tensor):
    """Reference for the kernel's tropical-identity pad steps.

    `pad` is a (..., T) bool mask; masked steps freeze delta and emit identity
    backpointers, so the result is bit-identical to running the unmasked
    recursion on the unpadded prefix.
    """
    T, K = em.shape[-2:]
    eye = torch.arange(K, dtype=torch.int32, device=em.device)
    psi = torch.empty(em.shape, dtype=torch.int32, device=em.device)
    delta = delta0
    for t in range(T):
        best, step_psi = _step(delta, log_A)
        is_pad = pad[..., t, None]
        psi[..., t, :] = torch.where(is_pad, eye, step_psi)
        delta = torch.where(is_pad, delta, best + em[..., t, :])
    return psi, delta


def viterbi_forward_masked_pen_ref(log_A: torch.Tensor, em: torch.Tensor,
                                   delta0: torch.Tensor, pad: torch.Tensor,
                                   tmask: torch.Tensor | None = None,
                                   smask: torch.Tensor | None = None):
    """Reference for the constraint-masked forward kernel.

    `tmask` (K, K) and `smask` (T, K), shared across a batch, are additive
    {0, NEG_INF} penalties.  The reference is the pad-masked recursion over
    the pre-masked inputs, ``log_A + tmask`` and ``em + smask``: the same
    adds the kernel makes per score and per row, so both give the same bits.
    """
    if tmask is not None:
        log_A = log_A + tmask
    if smask is not None:
        em = em + smask
    return viterbi_forward_masked_ref(log_A, em, delta0, pad)


def viterbi_banded_forward_ref(log_A: torch.Tensor, log_pi: torch.Tensor,
                               em: torch.Tensor, centers: torch.Tensor,
                               starts: torch.Tensor, width: int):
    """Reference for the banded forward kernel (the step loop of the JAX
    package's `viterbi_decode_banded`).

    At step t the DP holds the Kb = min(2*width + 1, K) states from
    ``starts[t]`` on; state ``starts[t] + j`` gets the penalty 0 if it lies
    within `width` of ``centers[t]``, else NEG_INF, added to its emission.
    em (T, K), centers and starts (T,) int -> (psi (T-1, Kb) int32 of local
    window indices, delta_w (Kb,)).
    """
    T, K = em.shape
    Kb = min(2 * width + 1, K)
    idx = starts.long()[:, None] + torch.arange(Kb, device=em.device)  # (T, Kb)
    pen = torch.zeros(idx.shape, dtype=em.dtype, device=em.device)
    pen[(idx - centers.long()[:, None]).abs() > width] = NEG_INF
    em_w = em.gather(1, idx) + pen
    psi = torch.empty((T - 1, Kb), dtype=torch.int32, device=em.device)
    delta = log_pi[idx[0]] + em_w[0]
    for t in range(1, T):
        a_sub = log_A[idx[t - 1][:, None], idx[t][None, :]]
        best, psi[t - 1] = _step(delta, a_sub)
        delta = best + em_w[t]
    return psi, delta


def viterbi_backtrack_ref(psi: torch.Tensor, delta_T: torch.Tensor):
    """Reference for the backtrack kernel.

    psi (B, T, K) int32 and delta_T (B, K) -> (paths (B, T + 1) int32,
    scores (B,)).  The last state is the lowest-index argmax of delta_T; the
    rest follow psi backwards, so identity rows (pad steps) repeat a state.
    """
    B, T, _ = psi.shape
    q_last = delta_T.argmax(dim=1)
    paths = torch.empty((B, T + 1), dtype=torch.int32, device=psi.device)
    paths[:, T] = q_last
    q = q_last[:, None]
    for t in range(T - 1, -1, -1):
        q = psi[:, t].gather(1, q).long()
        paths[:, t] = q[:, 0]
    return paths, delta_T.gather(1, q_last[:, None])[:, 0]


def top_b(values: torch.Tensor, B: int) -> torch.Tensor:
    """Indices of the B largest entries along the last axis, highest first,
    the lower index first among equal values (the stable order of
    `jax.lax.top_k`; `torch.topk` promises no order among ties)."""
    return torch.sort(values, dim=-1, descending=True, stable=True).indices[
        ..., :B]


def merge_top_b(run: tuple, new: tuple, B: int) -> tuple:
    """Merge a chunk into a running top-B, as one step of the chunked
    `lax.top_k` loops of `core/flash_bs.py`.

    `run` and `new` are tuples of (..., n) tensors whose first entry holds
    the values; the result keeps the B best of ``run ++ new`` in the order
    (value descending, position ascending), so a running entry beats a
    chunk entry of equal value.
    """
    cat = [torch.cat([r, n], dim=-1) for r, n in zip(run, new)]
    idx = top_b(cat[0], B)
    return tuple(x.gather(-1, idx) for x in cat)


def beam_transition_ref(log_A: torch.Tensor, em: torch.Tensor,
                        scores: torch.Tensor, states: torch.Tensor,
                        chunk: int):
    """Reference for the beam kernel: N independent FLASH-BS transitions.

    log_A (K, K) with chunk | K, em (N, K), scores (N, B), states (N, B)
    int32 -> (new_scores, new_states, from_slots), each (N, B).  For target
    c, ``cand[b, c] = (scores[b] + log_A[states[b], c]) + em[c]``, reduced
    over the slots (lowest slot on ties); each chunk of targets is merged
    into a running top-B seeded with B entries (BEAM_SENTINEL, 0, 0).  This
    is `core/flash_bs.py::_beam_transition` of the JAX package, batched.
    """
    N, B = scores.shape
    K = log_A.shape[1]
    run = (torch.full((N, B), BEAM_SENTINEL, dtype=scores.dtype,
                      device=scores.device),
           torch.zeros((N, B), dtype=torch.int32, device=scores.device),
           torch.zeros((N, B), dtype=torch.int32, device=scores.device))
    rows_of = states.long()
    for c0 in range(0, K, chunk):
        rows = log_A[:, c0:c0 + chunk][rows_of]                 # (N, B, C)
        cand = scores[..., None] + rows + em[:, None, c0:c0 + chunk]
        best, from_b = cand.max(dim=1)                          # first slot
        tgt = torch.arange(c0, c0 + chunk, dtype=torch.int32,
                           device=scores.device).expand(N, chunk)
        run = merge_top_b(run, (best, tgt, from_b.to(torch.int32)), B)
    return run


def _stream_top_b(values: torch.Tensor, B: int, chunk: int | None = None):
    """Top-B of (M, K_pad) scores, merged `chunk` at a time (None: all at
    once) into a running top-B seeded with B (BEAM_SENTINEL, 0) entries.
    Returns (scores (M, B), states (M, B) int32) sorted descending, the lower
    state first among ties: `core/flash_bs.py::_stream_top_b` of the JAX
    package, batched."""
    M, K_pad = values.shape
    chunk = K_pad if chunk is None else chunk
    dev = values.device
    run = (torch.full((M, B), BEAM_SENTINEL, dtype=values.dtype, device=dev),
           torch.zeros((M, B), dtype=torch.int32, device=dev))
    for c0 in range(0, K_pad, chunk):
        st = torch.arange(c0, c0 + chunk, dtype=torch.int32,
                          device=dev).expand(M, chunk)
        run = merge_top_b(run, (values[:, c0:c0 + chunk], st), B)
    return run


def beam_chunk_ref(log_pi: torch.Tensor, log_A: torch.Tensor,
                   em: torch.Tensor, scores: torch.Tensor,
                   states: torch.Tensor, is_first: torch.Tensor, B: int,
                   chunk: int):
    """Reference for the beam kernel's chunk mode: N streaming beams, each
    advanced through C rows of emissions.

    log_pi (K,), log_A (K, K) with chunk | K, em (N, C, K), scores (N, B),
    states (N, B) int32, is_first (N,) bool.  A beam flagged `is_first`
    seeds from ``log_pi + em[:, 0]`` (the stable top-B of `_stream_top_b`)
    and ignores its `scores` and `states`; the others take a transition on
    row 0 from the carried beam.  Every remaining row is one
    `beam_transition_ref`.  Returns (scores (N, B), states (N, B), hist_states
    (N, C, B), hist_froms (N, C, B)): the final beam and, for every row t,
    the beam's states after it and their slot backpointers into the beam
    before it (a seed row's are 0).  This is `_beam_init` followed by the
    `lax.scan` of `_beam_chunk_scan` (src/repro/core/online.py:434-450),
    batched over N.
    """
    N, C, _ = em.shape
    seed_s, seed_st = _stream_top_b(log_pi + em[:, 0], B, chunk)
    sc, st, fr = beam_transition_ref(log_A, em[:, 0], scores, states, chunk)
    first = is_first[:, None]
    sc, st = torch.where(first, seed_s, sc), torch.where(first, seed_st, st)
    fr = torch.where(first, 0, fr)
    hist_st = torch.empty((N, C, B), dtype=torch.int32, device=em.device)
    hist_f = torch.empty((N, C, B), dtype=torch.int32, device=em.device)
    hist_st[:, 0], hist_f[:, 0] = st, fr
    for t in range(1, C):
        sc, st, fr = beam_transition_ref(log_A, em[:, t], sc, st, chunk)
        hist_st[:, t], hist_f[:, t] = st, fr
    return sc, st, hist_st, hist_f


def _beam_pass_step(log_A, em_t, is_pad, scores, states, chunk: int):
    """One beam transition of every beam, then the pad identity: a pad step
    keeps the beam and points every slot at itself.  (A full carry-freeze
    would be wrong: mid/div assignments that fire on a pad step must still
    see identity backpointers.)  Returns (scores, states, from_slots
    int64)."""
    ns, nst, nfrom = beam_transition_ref(log_A, em_t, scores, states, chunk)
    eye = torch.arange(scores.shape[1], dtype=torch.int32,
                       device=scores.device)
    keep = is_pad[:, None]
    return (torch.where(keep, scores, ns), torch.where(keep, states, nst),
            torch.where(keep, eye, nfrom).long())


def bs_initial_pass_ref(log_pi, log_A, em, pad, boundaries, B: int,
                        chunk: int | None = None):
    """Reference for the FLASH-BS initial pass: the beam over each whole
    (padded) sequence, tracking the P-1 division states.

    em (N, Tp, K_pad), pad (N, Tp) bool, `boundaries` a static sequence of
    step indices; `chunk` (a divisor of K_pad, None: K_pad) groups the
    targets of each merge and does not change the result.  Returns
    (q_bounds (N, nb) int32, q_last (N,) int32, score (N,)): the division
    states, last state and score of the first best slot.  This is
    `core/flash_bs.py::_bs_initial_pass` of the JAX package, batched.
    """
    N, Tp, K_pad = em.shape
    chunk = K_pad if chunk is None else chunk
    bnd = [int(b) for b in boundaries]
    scores, states = _stream_top_b(log_pi + em[:, 0], B, chunk)
    div = torch.zeros((N, B, len(bnd)), dtype=torch.int32, device=em.device)
    for t in range(1, Tp):
        ns, nst, nfrom = _beam_pass_step(log_A, em[:, t], pad[:, t], scores,
                                         states, chunk)
        if bnd:   # follow the slots; a crossed boundary takes the old state
            div = div.gather(1, nfrom[:, :, None].expand(-1, -1, len(bnd)))
            for i, b in enumerate(bnd):
                if b + 1 == t:
                    div[:, :, i] = states.gather(1, nfrom)
        scores, states = ns, nst
    score, b_best = scores.max(dim=1)                  # first best slot
    rows = torch.arange(N, device=em.device)
    return div[rows, b_best], states[rows, b_best], score


def bs_segment_decode_ref(log_pi, log_A, em_seg, pad_seg, entry, exit_state,
                          is_first, B: int, chunk: int | None = None):
    """Reference for the FLASH-BS tile decode: the pruned beam DP over M
    tiles of s >= 2 steps.

    em_seg (M, s, K_pad), pad_seg (M, s) bool, entry / exit_state (M,) the
    pinned states before and at the end of each tile, is_first (M,) bool
    (the tile starts at step 0: seed from log_pi, else from
    ``log_A[entry]``).  The midpoint state is followed from step s // 2 on;
    at the end the first slot holding `exit_state` gives it, or the first
    best slot if the exit state fell off the beam.  Returns the midpoint
    states (M,) int32.  This is `core/flash_bs.py::_bs_segment_decode` of
    the JAX package, batched; `chunk` as in `bs_initial_pass_ref`.
    """
    s, K_pad = em_seg.shape[1:]
    chunk = K_pad if chunk is None else chunk
    tm = s // 2 - 1
    init = torch.where(is_first[:, None], log_pi,
                       log_A[entry.long()]) + em_seg[:, 0]
    scores, states = _stream_top_b(init, B, chunk)
    mid = None        # all zeros until the midpoint step: nothing to carry
    for tl in range(1, s):
        ns, nst, nfrom = _beam_pass_step(log_A, em_seg[:, tl], pad_seg[:, tl],
                                         scores, states, chunk)
        if tl == tm + 1:
            mid = states.gather(1, nfrom)
        elif tl > tm + 1:
            mid = mid.gather(1, nfrom)
        scores, states = ns, nst
    hit = states == exit_state[:, None]
    idx = torch.where(hit.any(dim=1), hit.int().argmax(dim=1),
                      scores.argmax(dim=1))
    return mid.gather(1, idx[:, None])[:, 0]


def beam_step_ref(log_A: torch.Tensor, em_t: torch.Tensor,
                  scores: torch.Tensor, states: torch.Tensor):
    """The JAX package's oracle for `beam_step` (`repro.kernels.ref`): one
    stable top-B over all K targets, with no sentinel seed.

    It differs from `beam_transition_ref` only where a candidate ties the
    -4e9 sentinel; the kernel is held to `beam_transition_ref`.
    """
    B = scores.shape[0]
    cand = scores[:, None] + log_A[states.long()] + em_t[None, :]   # (B, K)
    best, from_b = cand.max(dim=0)
    top = top_b(best, B)
    return best[top], top.to(torch.int32), from_b[top].to(torch.int32)


def tropical_matmul_ref(a: torch.Tensor, b: torch.Tensor):
    """Reference for the tropical kernel: (..., I, K) x (..., K, J) ->
    ((..., I, J) max values, (..., I, J) int32 lowest argmax over K).

    Each sum is formed in f32 and rounded to the operands' dtype (bf16 or
    f32) before the max, as XLA's elementwise add does on the CPU.  Rows of
    A are taken in blocks so that the (rows, K, J) intermediate stays below
    about 2**25 entries.
    """
    I, K = a.shape[-2:]
    J = b.shape[-1]
    lead = a.shape[:-2]
    rows = max(1, (1 << 25) // max(1, K * J * math.prod(lead)))
    vals = torch.empty((*lead, I, J), dtype=a.dtype, device=a.device)
    args = torch.empty((*lead, I, J), dtype=torch.int32, device=a.device)
    bf = b.float()[..., None, :, :]
    for i0 in range(0, I, rows):
        s = (a[..., i0:i0 + rows, :].float()[..., :, :, None] + bf).to(a.dtype)
        v, g = s.max(dim=-2)                                    # first index
        vals[..., i0:i0 + rows, :] = v
        args[..., i0:i0 + rows, :] = g.to(torch.int32)
    return vals, args


__all__ = ["viterbi_forward_ref", "viterbi_forward_masked_ref",
           "viterbi_forward_masked_pen_ref", "viterbi_banded_forward_ref",
           "viterbi_backtrack_ref", "top_b", "merge_top_b",
           "beam_transition_ref", "beam_chunk_ref", "bs_initial_pass_ref",
           "bs_segment_decode_ref", "beam_step_ref", "tropical_matmul_ref",
           "BEAM_SENTINEL"]
