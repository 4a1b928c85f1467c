"""Wrappers of the FLASH-BS beam kernel in ``csrc/beam_stream.cu``.

The kernel replaces the Pallas TPU kernel `_beam_step_kernel` and its merge
`_select_top_b` (src/repro/kernels/beam_stream.py:36, :60, :121).  It is
one template with four entries:

  * `bs_initial_pass_batch` -- the FLASH-BS initial pass of N sequences in
    one launch: the seeding top-B, every beam transition of the time loop,
    the pad identity and the division-state bookkeeping;
  * `bs_segment_decode_batch` -- one layer of the wavefront: the tile
    decodes of M tiles in one launch, with the midpoint bookkeeping and the
    exit-state fallback;
  * `beam_step_batch` -- one transition of N given beams, the counterpart of
    the TPU `beam_step`;
  * `bs_chunk_batch` -- N streaming beams through a chunk of C emission rows
    in one launch: the seed of a new beam, a transition a row, every row's
    slot states and slot backpointers (the `lax.scan` of `_beam_chunk_scan`,
    src/repro/core/online.py:443, which is not Pallas).

Each beam is owned by a thread-block cluster; the source comment in the .cu
file says what bounds the kernel on the card and what its design does about
it.  For tensors on the CPU a wrapper runs its plain version in `ref.py`;
for CUDA tensors it launches the kernel (building it at first use) or
raises.  `launches` counts kernel launches, and only those.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build
from . import ref as _ref
from .viterbi_dp import SMEM_BYTES, _check_cuda, _on_cuda, _require, _stream

#: kernel launches since the last `reset_launches()`
launches = {"beam_step_batch": 0, "bs_initial_pass_batch": 0,
            "bs_segment_decode_batch": 0, "bs_chunk_batch": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def pass_instance(K: int, B: int, book: int) -> str:
    """The template instance a launch at these sizes takes: "resident" (each
    block holds its column slice of log_A in shared memory) or "global"
    (the slice is read from L2).  `book` is the int32 words of bookkeeping
    per beam slot (the division states, 1 for a midpoint, 0 for a step).
    Raises if not even the global instance fits.  Loads the library."""
    lib = build.load("beam_stream")
    if lib.beam_pass_smem_bytes(K, B, book, 1) <= SMEM_BYTES:
        return "resident"
    need = lib.beam_pass_smem_bytes(K, B, book, 0)
    _require(need <= SMEM_BYTES,
             f"a beam of B={B} over K={K} states with {book} bookkeeping "
             f"words per slot needs {need} bytes of shared memory, more than "
             f"a block's {SMEM_BYTES}")
    return "global"


def _launch(entry: str, dev: torch.device, *args) -> None:
    with torch.cuda.device(dev):
        err = getattr(build.load("beam_stream"), entry)(*args, _stream(dev))
    _check_cuda(err, entry)
    launches[entry] += 1


def _model_args(log_pi, log_A, B: int) -> int:
    """Checks log_pi, log_A and B; returns K."""
    _require(log_A.dim() == 2 and log_A.shape[0] == log_A.shape[1],
             f"log_A must be (K, K), got {tuple(log_A.shape)}")
    K = log_A.shape[0]
    _require(log_pi is None or log_pi.shape == (K,),
             f"log_pi must be ({K},)")
    _require(1 <= B <= K, f"the beam width B={B} must lie in [1, K={K}]")
    return K


def _pass_args(log_pi, log_A, em, pad, B: int, what: str) -> bool:
    """Checks the arguments shared by the two pass entries; True if they lie
    on CUDA."""
    K = _model_args(log_pi, log_A, B)
    _require(em.dim() == 3 and em.shape[2] == K,
             f"{what} must be (N, T, {K}), got {tuple(em.shape)}")
    N, T = em.shape[:2]
    _require(T >= 1, f"{what} must have T >= 1 steps")
    _require(pad.shape == (N, T), f"pad must be ({N}, {T})")
    _require(all(t.dtype == torch.float32 for t in (log_pi, log_A, em)),
             "log_pi, log_A and em must be float32")
    _require(pad.dtype == torch.bool, "pad must be bool")
    if not _on_cuda(log_pi, log_A, em, pad):
        return False
    _require(log_pi.is_contiguous() and log_A.is_contiguous(),
             "log_pi and log_A must be contiguous")
    _require(em.stride(2) == 1, f"{what} must have unit stride along K")
    _require(pad.stride(1) == 1, "pad must have unit stride along T")
    return True


def bs_initial_pass_batch(log_pi: torch.Tensor, log_A: torch.Tensor,
                          em: torch.Tensor, pad: torch.Tensor, boundaries,
                          B: int):
    """The FLASH-BS initial pass of N sequences, one launch.

    Args:
      log_pi: (K,) float32 initial scores; K = K_pad, padded already.
      log_A:  (K, K) float32 transitions, contiguous.
      em:     (N, Tp, K) float32 emissions, any strides but unit along K.
      pad:    (N, Tp) bool, True on tropical-identity (pad) steps.
      boundaries: (nb,) integer step indices of the division points; the
              state at step b is recorded when step b + 1 is taken.
      B:      beam width, 1 <= B <= K.

    Returns:
      (q_bounds (N, nb) int32, q_last (N,) int32, score (N,) float32),
      bit-identical to `ref.bs_initial_pass_ref`.
    """
    bnd = np.asarray(boundaries, dtype=np.int64).reshape(-1)
    if not _pass_args(log_pi, log_A, em, pad, B, "em"):
        return _ref.bs_initial_pass_ref(log_pi, log_A, em, pad, bnd, B)
    N, T, K = em.shape
    nb = len(bnd)
    resident = pass_instance(K, B, nb) == "resident"
    dev = em.device
    q_bounds = torch.empty((N, nb), dtype=torch.int32, device=dev)
    q_last = torch.empty((N,), dtype=torch.int32, device=dev)
    score = torch.empty((N,), dtype=torch.float32, device=dev)
    if N == 0:
        return q_bounds, q_last, score
    bnd_d = torch.from_numpy(bnd.astype(np.int32)).to(dev)
    _launch("bs_initial_pass_batch", dev, log_pi.data_ptr(), log_A.data_ptr(),
            em.data_ptr(), em.stride(0), em.stride(1), pad.data_ptr(),
            pad.stride(0), bnd_d.data_ptr(), nb, N, T, K, B, int(resident),
            q_bounds.data_ptr(), q_last.data_ptr(), score.data_ptr())
    return q_bounds, q_last, score


def bs_segment_decode_batch(log_pi: torch.Tensor, log_A: torch.Tensor,
                            em_seg: torch.Tensor, pad_seg: torch.Tensor,
                            entry: torch.Tensor, exit_state: torch.Tensor,
                            is_first: torch.Tensor, B: int):
    """The FLASH-BS tile decodes of M tiles of s >= 2 steps, one launch.

    Args:
      log_pi, log_A: as for `bs_initial_pass_batch`.
      em_seg:  (M, s, K) float32 emissions of each tile, unit stride along K.
      pad_seg: (M, s) bool pad steps.
      entry, exit_state: (M,) int64 pinned states before and at the end of
               each tile.
      is_first: (M,) bool, the tile starts at step 0 (seed from log_pi, not
               from ``log_A[entry]``).
      B:       beam width.

    Returns:
      the midpoint states (M,) int32, bit-identical to
      `ref.bs_segment_decode_ref`.
    """
    on_cuda = _pass_args(log_pi, log_A, em_seg, pad_seg, B, "em_seg")
    M, s, K = em_seg.shape
    _require(s >= 2, "tiles must have s >= 2 steps")
    _require(entry.shape == exit_state.shape == is_first.shape == (M,),
             f"entry, exit_state and is_first must be ({M},)")
    _require(entry.dtype == exit_state.dtype == torch.int64,
             "entry and exit_state must be int64")
    _require(is_first.dtype == torch.bool, "is_first must be bool")
    if not on_cuda:
        return _ref.bs_segment_decode_ref(log_pi, log_A, em_seg, pad_seg,
                                          entry, exit_state, is_first, B)
    _require(all(t.device == em_seg.device and t.is_contiguous()
                 for t in (entry, exit_state, is_first)),
             "entry, exit_state and is_first must be contiguous, on the "
             "device of em_seg")
    resident = pass_instance(K, B, 1) == "resident"
    dev = em_seg.device
    mid = torch.empty((M,), dtype=torch.int32, device=dev)
    if M == 0:
        return mid
    _launch("bs_segment_decode_batch", dev, log_pi.data_ptr(),
            log_A.data_ptr(), em_seg.data_ptr(), em_seg.stride(0),
            em_seg.stride(1), pad_seg.data_ptr(), pad_seg.stride(0),
            entry.data_ptr(), exit_state.data_ptr(), is_first.data_ptr(), M,
            s, K, B, int(resident), mid.data_ptr())
    return mid


def beam_step_batch(log_A: torch.Tensor, em: torch.Tensor,
                    scores: torch.Tensor, states: torch.Tensor, chunk: int):
    """N independent beam transitions of width B over K targets.

    Args:
      log_A:  (K, K) float32 transitions, contiguous; K a multiple of chunk.
      em:     (N, K) float32 emissions of the step, one row per beam; any
              row stride, unit stride along K (``em_tiles[:, t]`` is taken
              as is).
      scores: (N, B) float32 beam scores, contiguous, 1 <= B <= K.
      states: (N, B) int32 beam states, contiguous, each in [0, K).
      chunk:  targets merged into the running top-B at a time; the result
              does not depend on it (the kernel selects once over all K).

    Returns:
      (new_scores (N, B) float32, new_states (N, B) int32,
       from_slots (N, B) int32), bit-identical to `ref.beam_transition_ref`.
    """
    _require(scores.dim() == 2, "scores must be (N, B)")
    N, B = scores.shape
    K = _model_args(None, log_A, B)
    _require(em.shape == (N, K), f"em must be ({N}, {K})")
    _require(states.shape == (N, B), f"states must be ({N}, {B})")
    _require(isinstance(chunk, int) and chunk >= 1 and K % chunk == 0,
             f"chunk={chunk} must divide K={K}")
    _require(all(t.dtype == torch.float32 for t in (log_A, em, scores)),
             "log_A, em and scores must be float32")
    _require(states.dtype == torch.int32, "states must be int32")
    if not _on_cuda(log_A, em, scores, states):
        return _ref.beam_transition_ref(log_A, em, scores, states, chunk)

    _require(all(t.is_contiguous() for t in (log_A, scores, states)),
             "log_A, scores and states must be contiguous")
    _require(em.stride(1) == 1, "em must have unit stride along K")
    pass_instance(K, B, 0)     # a single step reads log_A from L2
    dev = em.device
    out_s = torch.empty((N, B), dtype=torch.float32, device=dev)
    out_st = torch.empty((N, B), dtype=torch.int32, device=dev)
    out_f = torch.empty((N, B), dtype=torch.int32, device=dev)
    if N == 0:
        return out_s, out_st, out_f
    _launch("beam_step_batch", dev, log_A.data_ptr(), em.data_ptr(),
            em.stride(0), scores.data_ptr(), states.data_ptr(), N, K, B,
            out_s.data_ptr(), out_st.data_ptr(), out_f.data_ptr())
    return out_s, out_st, out_f


def bs_chunk_batch(log_pi: torch.Tensor, log_A: torch.Tensor,
                   em: torch.Tensor, scores: torch.Tensor,
                   states: torch.Tensor, is_first: torch.Tensor, B: int,
                   chunk: int):
    """N streaming beams through a chunk of C >= 1 emission rows, one launch.

    Args:
      log_pi: (K,) float32 initial scores, contiguous; K = K_pad.
      log_A:  (K, K) float32 transitions, contiguous; K a multiple of chunk.
      em:     (N, C, K) float32 emissions, any strides but unit along K.
      scores: (N, B) float32 carried beam scores, contiguous, 1 <= B <= K.
      states: (N, B) int32 carried beam states, contiguous, each in [0, K).
      is_first: (N,) bool, contiguous: the beam seeds from
              ``log_pi + em[:, 0]`` (its scores and states are not read)
              instead of taking a transition on row 0.  A first beam with
              C = 1 is the seed alone.
      B:      beam width.
      chunk:  targets merged into the running top-B at a time; the result
              does not depend on it (the kernel selects once over all K).

    Returns:
      (scores (N, B) float32, states (N, B) int32, hist_states (N, C, B)
       int32, hist_froms (N, C, B) int32), bit-identical to
      `ref.beam_chunk_ref`.
    """
    K = _model_args(log_pi, log_A, B)
    _require(em.dim() == 3 and em.shape[2] == K and em.shape[1] >= 1,
             f"em must be (N, C >= 1, {K}), got {tuple(em.shape)}")
    N, C = em.shape[:2]
    _require(scores.shape == states.shape == (N, B),
             f"scores and states must be ({N}, {B})")
    _require(is_first.shape == (N,), f"is_first must be ({N},)")
    _require(isinstance(chunk, int) and chunk >= 1 and K % chunk == 0,
             f"chunk={chunk} must divide K={K}")
    _require(all(t.dtype == torch.float32
                 for t in (log_pi, log_A, em, scores)),
             "log_pi, log_A, em and scores must be float32")
    _require(states.dtype == torch.int32, "states must be int32")
    _require(is_first.dtype == torch.bool, "is_first must be bool")
    if not _on_cuda(log_pi, log_A, em, scores, states, is_first):
        return _ref.beam_chunk_ref(log_pi, log_A, em, scores, states,
                                   is_first, B, chunk)
    _require(all(t.is_contiguous()
                 for t in (log_pi, log_A, scores, states, is_first)),
             "log_pi, log_A, scores, states and is_first must be contiguous")
    _require(em.stride(2) == 1, "em must have unit stride along K")
    resident = pass_instance(K, B, 0) == "resident"
    dev = em.device
    out_s = torch.empty((N, B), dtype=torch.float32, device=dev)
    out_st = torch.empty((N, B), dtype=torch.int32, device=dev)
    hist = torch.empty((2, N, C, B), dtype=torch.int32, device=dev)
    if N == 0:
        return out_s, out_st, hist[0], hist[1]
    _launch("bs_chunk_batch", dev, log_pi.data_ptr(), log_A.data_ptr(),
            em.data_ptr(), em.stride(0), em.stride(1), scores.data_ptr(),
            states.data_ptr(), is_first.data_ptr(), N, C, K, B,
            int(resident), out_s.data_ptr(), out_st.data_ptr(),
            hist[0].data_ptr(), hist[1].data_ptr())
    return out_s, out_st, hist[0], hist[1]


__all__ = ["beam_step_batch", "bs_initial_pass_batch",
           "bs_segment_decode_batch", "bs_chunk_batch", "pass_instance",
           "launches", "reset_launches"]
