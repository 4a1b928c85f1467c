"""Wrappers of the fused Viterbi kernels in ``csrc/viterbi_dp.cu``.

`viterbi_forward_batch` replaces the Pallas TPU kernel `_viterbi_fwd_kernel`
(src/repro/kernels/viterbi_dp.py:45, :74) and `viterbi_forward` is its B = 1
view (:237).  `viterbi_backtrack_batch` replaces the XLA reverse-scan
backtracks of `repro.kernels.ops` (ops.py:177-182, 213-220).  The source
comment in the .cu file says what bounds each kernel on the card and what
its design does about it.

Each wrapper checks device, dtype, shape and strides and raises on what the
kernel does not take.  For tensors on the CPU it runs the plain version in
`ref.py`; for CUDA tensors it launches its kernel (building it at first use)
or raises.  `launches` counts kernel launches, and only those.
"""

from __future__ import annotations

import torch

from . import build
from . import ref as _ref

#: kernel launches per kernel since the last `reset_launches()`
launches = {"viterbi_fwd_batch": 0, "viterbi_backtrack_batch": 0}

#: largest K whose two f32 delta rows fit in one block's 227 KB shared memory
MAX_K = 232448 // 8


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """False for CPU tensors, True for CUDA ones; raises on anything else."""
    dev = tensors[0].device
    _require(all(t.device == dev for t in tensors),
             f"tensors on different devices: {[str(t.device) for t in tensors]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def _check_cuda(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def viterbi_forward_batch(log_A: torch.Tensor, em: torch.Tensor,
                          delta0: torch.Tensor, pad: torch.Tensor | None = None):
    """Batched fused forward pass.

    Args:
      log_A:  (K, K) float32 transition log-probs, contiguous.
      em:     (B, T, K) float32 emissions for steps 1..T; any batch and time
              strides, unit stride along K (``em[:, 1:]`` is taken as is).
      delta0: (B, K) float32 initial DP states, contiguous.
      pad:    optional (B, T) float32, contiguous; entries > 0.5 mark
              tropical-identity steps (delta frozen, identity backpointers).

    Returns:
      (psi (B, T, K) int32, delta_T (B, K) float32).
    """
    _require(em.dim() == 3, f"em must be (B, T, K), got {tuple(em.shape)}")
    B, T, K = em.shape
    _require(K >= 1, "K must be >= 1")
    _require(log_A.shape == (K, K), f"log_A must be ({K}, {K})")
    _require(delta0.shape == (B, K), f"delta0 must be ({B}, {K})")
    tensors = [log_A, em, delta0] + ([] if pad is None else [pad])
    _require(all(t.dtype == torch.float32 for t in tensors),
             "log_A, em, delta0 and pad must be float32")
    if pad is not None:
        _require(pad.shape == (B, T), f"pad must be ({B}, {T})")
    if not _on_cuda(*tensors):
        if pad is None:
            return _ref.viterbi_forward_ref(log_A, em, delta0)
        return _ref.viterbi_forward_masked_ref(log_A, em, delta0, pad > 0.5)

    _require(K <= MAX_K, f"K={K} exceeds the kernel's limit of {MAX_K}")
    _require(log_A.is_contiguous() and delta0.is_contiguous()
             and (pad is None or pad.is_contiguous()),
             "log_A, delta0 and pad must be contiguous")
    _require(em.stride(2) == 1, "em must have unit stride along K")
    dev = em.device
    psi = torch.empty((B, T, K), dtype=torch.int32, device=dev)
    delta_T = torch.empty((B, K), dtype=torch.float32, device=dev)
    if B == 0:
        return psi, delta_T
    lib = build.load("viterbi_dp")
    with torch.cuda.device(dev):
        err = lib.viterbi_fwd_batch(
            log_A.data_ptr(), em.data_ptr(), em.stride(0), em.stride(1),
            delta0.data_ptr(), None if pad is None else pad.data_ptr(),
            B, T, K, psi.data_ptr(), delta_T.data_ptr(), _stream(dev))
    _check_cuda(err, "viterbi_fwd_batch")
    launches["viterbi_fwd_batch"] += 1
    return psi, delta_T


def viterbi_forward(log_A: torch.Tensor, em: torch.Tensor,
                    delta0: torch.Tensor, pad: torch.Tensor | None = None):
    """Single-sequence fused forward pass (B = 1 view of the batched kernel).

    em (T, K), delta0 (K,), pad optional (T,) -> (psi (T, K) int32, delta_T (K,)).
    """
    psi, delta_T = viterbi_forward_batch(
        log_A, em[None], delta0[None], None if pad is None else pad[None])
    return psi[0], delta_T[0]


def viterbi_backtrack_batch(psi: torch.Tensor, delta_T: torch.Tensor):
    """Batched backtrack over forward-pass backpointers.

    psi (B, T, K) int32 and delta_T (B, K) float32, both contiguous ->
    (paths (B, T + 1) int32, scores (B,) float32).  The last state is the
    lowest-index argmax of delta_T[b]; identity rows repeat a state.
    """
    _require(psi.dim() == 3, f"psi must be (B, T, K), got {tuple(psi.shape)}")
    B, T, K = psi.shape
    _require(K >= 1, "K must be >= 1")
    _require(delta_T.shape == (B, K), f"delta_T must be ({B}, {K})")
    _require(psi.dtype == torch.int32 and delta_T.dtype == torch.float32,
             "psi must be int32 and delta_T float32")
    if not _on_cuda(psi, delta_T):
        return _ref.viterbi_backtrack_ref(psi, delta_T)

    _require(psi.is_contiguous() and delta_T.is_contiguous(),
             "psi and delta_T must be contiguous")
    dev = psi.device
    paths = torch.empty((B, T + 1), dtype=torch.int32, device=dev)
    scores = torch.empty((B,), dtype=torch.float32, device=dev)
    if B == 0:
        return paths, scores
    lib = build.load("viterbi_dp")
    with torch.cuda.device(dev):
        err = lib.viterbi_backtrack_batch(
            psi.data_ptr(), delta_T.data_ptr(), B, T, K, paths.data_ptr(),
            scores.data_ptr(), _stream(dev))
    _check_cuda(err, "viterbi_backtrack_batch")
    launches["viterbi_backtrack_batch"] += 1
    return paths, scores


__all__ = ["viterbi_forward", "viterbi_forward_batch",
           "viterbi_backtrack_batch", "launches", "reset_launches", "MAX_K"]
