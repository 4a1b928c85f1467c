"""Wrapper of the beam-transition kernel in ``csrc/beam_stream.cu``.

`beam_step_batch` replaces the Pallas TPU kernel `_beam_step_kernel` and its
merge `_select_top_b` (src/repro/kernels/beam_stream.py:36, :60, :121): N
independent FLASH-BS transitions in one launch, one block per beam.  The
source comment in the .cu file says what bounds it on the card and what its
design does about that.

For tensors on the CPU the wrapper runs the plain version
`ref.beam_transition_ref`; for CUDA tensors it launches the kernel
(building it at first use) or raises.  `launches` counts kernel launches,
and only those.
"""

from __future__ import annotations

import torch

from . import build
from . import ref as _ref
from .viterbi_dp import _check_cuda, _on_cuda, _require, _stream

#: kernel launches since the last `reset_launches()`
launches = {"beam_step_batch": 0}

#: a block's shared memory on the card (227 KB)
SMEM_BYTES = 232448


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


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
      chunk:  targets merged into the running top-B at a time.

    Returns:
      (new_scores (N, B) float32, new_states (N, B) int32,
       from_slots (N, B) int32), bit-identical to `ref.beam_transition_ref`.
    """
    _require(log_A.dim() == 2 and log_A.shape[0] == log_A.shape[1],
             f"log_A must be (K, K), got {tuple(log_A.shape)}")
    K = log_A.shape[0]
    _require(em.dim() == 2 and em.shape[1] == K, f"em must be (N, {K})")
    N = em.shape[0]
    _require(scores.dim() == 2 and scores.shape[0] == N,
             f"scores must be ({N}, B)")
    B = scores.shape[1]
    _require(states.shape == (N, B), f"states must be ({N}, {B})")
    _require(1 <= B <= K, f"the beam width B={B} must lie in [1, K={K}]")
    _require(isinstance(chunk, int) and chunk >= 1 and K % chunk == 0,
             f"chunk={chunk} must divide K={K}")
    _require(all(t.dtype == torch.float32 for t in (log_A, em, scores)),
             "log_A, em and scores must be float32")
    _require(states.dtype == torch.int32, "states must be int32")
    if not _on_cuda(log_A, em, scores, states):
        return _ref.beam_transition_ref(log_A, em, scores, states, chunk)

    _require((B + chunk) * 12 <= SMEM_BYTES,
             f"(B + chunk) * 12 = {(B + chunk) * 12} bytes exceed a block's "
             f"{SMEM_BYTES} bytes of shared memory")
    _require(all(t.is_contiguous() for t in (log_A, scores, states)),
             "log_A, scores and states must be contiguous")
    _require(em.stride(1) == 1, "em must have unit stride along K")
    dev = em.device
    out_s = torch.empty((N, B), dtype=torch.float32, device=dev)
    out_st = torch.empty((N, B), dtype=torch.int32, device=dev)
    out_f = torch.empty((N, B), dtype=torch.int32, device=dev)
    if N == 0:
        return out_s, out_st, out_f
    lib = build.load("beam_stream")
    with torch.cuda.device(dev):
        err = lib.beam_step_batch(
            log_A.data_ptr(), em.data_ptr(), em.stride(0), scores.data_ptr(),
            states.data_ptr(), N, K, B, chunk, out_s.data_ptr(),
            out_st.data_ptr(), out_f.data_ptr(), _stream(dev))
    _check_cuda(err, "beam_step_batch")
    launches["beam_step_batch"] += 1
    return out_s, out_st, out_f


__all__ = ["beam_step_batch", "launches", "reset_launches"]
