"""Wrapper of the tropical (max, +) product kernel in ``csrc/tropical.cu``.

`tropical_matmul_batch` replaces the Pallas TPU kernel `_tropical_kernel`
behind `tropical_matmul` (src/repro/kernels/tropical.py:30, :66), batched
over N independent products so that one launch combines every pair of one
level of the associative scan.  With ``with_args=False`` it is the
values-only combine of that scan (`_tropical_matmul`,
src/repro/core/assoc.py:18): the same vals, no argmax written; with the
argmax, one launch writes `assoc`'s backtrack table (the lowest-index argmax
of ``deltas[t] + log_A[:, q]`` for every t and q).  The source
comment in the .cu file says what bounds it on the card and what its design
(64 x 64 output tiles, register micro-tiles, a cp.async ring) does about
that.

For tensors on the CPU the wrapper runs the plain version
`ref.tropical_matmul_ref`; for CUDA tensors it launches the kernel
(building it at first use) or raises; for fake tensors (the dry run's) it
returns empty outputs and charges the launch (`work.charge`).  `launches`
counts kernel launches, and only those.
"""

from __future__ import annotations

import torch

from . import build
from . import ref as _ref
from . import work as _work
from .viterbi_dp import _check_cuda, _on_cuda, _require, _stream

#: kernel launches since the last `reset_launches()`
launches = {"tropical_matmul_batch": 0}

DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def tropical_matmul_batch(a: torch.Tensor, b: torch.Tensor,
                          with_args: bool = True):
    """N (max, +) products: (N, I, K) x (N, K, J).

    Both operands float32 or both bfloat16, contiguous on the card.  In
    bfloat16 each sum is rounded to bfloat16 before the max.

    Returns:
      (vals (N, I, J) of the operands' dtype, args (N, I, J) int32, the
      lowest k attaining each max), bit-identical to `ref.tropical_matmul_ref`;
      args is None when `with_args` is False (the same vals, no argmax).
    """
    _require(a.dim() == 3 and b.dim() == 3,
             f"a and b must be (N, I, K) and (N, K, J), got "
             f"{tuple(a.shape)} and {tuple(b.shape)}")
    N, I, K = a.shape
    _require(b.shape[:2] == (N, K), f"b must be ({N}, {K}, J)")
    J = b.shape[2]
    _require(K >= 1, "K must be >= 1")
    _require(a.dtype == b.dtype and a.dtype in DTYPES,
             "a and b must both be float32 or both bfloat16")
    if _work.fake(a, b):
        shapes = [((N, I, J), a.dtype)] + (
            [((N, I, J), torch.int32)] if with_args else [])
        outs = _work.fake_outputs(
            a, "tropical_matmul_batch",
            _work.tropical_work(N, I, K, J, a.element_size(), with_args),
            *shapes, launched=N * I * J > 0)
        return outs[0], outs[1] if with_args else None
    if not _on_cuda(a, b):
        vals, args = _ref.tropical_matmul_ref(a, b)
        return vals, args if with_args else None

    _require(a.is_contiguous() and b.is_contiguous(),
             "a and b must be contiguous")
    dev = a.device
    vals = torch.empty((N, I, J), dtype=a.dtype, device=dev)
    args = (torch.empty((N, I, J), dtype=torch.int32, device=dev)
            if with_args else None)
    if vals.numel() == 0:
        return vals, args
    lib = build.load("tropical")
    with torch.cuda.device(dev):
        err = lib.tropical_matmul_batch(
            a.data_ptr(), b.data_ptr(), int(a.dtype == torch.bfloat16), N, I,
            K, J, vals.data_ptr(), None if args is None else args.data_ptr(),
            _stream(dev))
    _check_cuda(err, "tropical_matmul_batch")
    launches["tropical_matmul_batch"] += 1
    return vals, args


__all__ = ["tropical_matmul_batch", "launches", "reset_launches"]
