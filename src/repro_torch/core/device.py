"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for another device.  A
missing GPU is an error, never a silent move to the CPU.
"""

from __future__ import annotations

import contextlib

import torch
from torch._subclasses.fake_tensor import FakeTensor


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def on_card(t: torch.Tensor) -> bool:
    """Whether `t` takes the card's path: a CUDA tensor, or a fake tensor
    (shapes without storage: the dry run's stand-in for one, whichever
    device it names)."""
    return t.is_cuda or isinstance(t, FakeTensor)


@contextlib.contextmanager
def host_metadata(*tensors: torch.Tensor):
    """A block that reads host metadata (a batch's lengths) with every
    dispatch mode set aside, so that the dry run's fake-tensor mode
    (`launch.dryrun`) leaves a host tensor its values (under the mode even
    a host tensor's ``.numpy()`` reads no values).  A fake tensor among
    `tensors` (a device tensor in the dry run) has none: RuntimeError, a
    host read on the card's path."""
    from torch.utils._python_dispatch import _disable_current_modes
    for t in tensors:
        if isinstance(t, FakeTensor):
            raise RuntimeError(f"host read of a device tensor of shape "
                               f"{tuple(t.shape)}")
    with _disable_current_modes():
        yield


def host_tensor(x, dtype: torch.dtype) -> torch.Tensor:
    """``torch.as_tensor(x, dtype=dtype)`` with every dispatch mode set
    aside: host metadata (numpy, a list, a host tensor) stays a host tensor
    under the dry run's fake-tensor mode."""
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        return torch.as_tensor(x, dtype=dtype)


__all__ = ["resolve_device", "on_card", "host_metadata", "host_tensor"]
