"""Gradient compression with error feedback (int8 accumulation buffers),
as `repro.optim.compression`.

The gradient-accumulation loop adds microbatch gradients into int8 buffers
with one absmax scale a leaf and a float32 error-feedback residual.

A leaf here is a tensor or a list of tensors: the pieces of one leaf of
JAX's layout, which stacks the layers on axis 0 where the port holds one
tensor a layer (`models.convert.jax_leaf_groups`).  The pieces share one
scale, the absmax over all of them, so the buffers equal JAX's on its
stacked leaf (quantizing each layer on its own would be another
algorithm).  Rounding is half to even in both packages (`torch.round`,
`jnp.round`).

`ef_accumulate` is `ef_add`, then the scale of the residual's absmax
(`absmax`, `scale_of`), then `ef_requantize`.  The tensor-parallel train
step holds a rank's block of a leaf sharded over "model": it runs the
three apart, so that each leaf's absmax is taken over the model axis
between them (one scale a JAX leaf, not a block).
"""

from __future__ import annotations

import torch


def _pieces(x) -> list:
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _like(x, pieces: list):
    return pieces if isinstance(x, (list, tuple)) else pieces[0]


def absmax(x) -> torch.Tensor:
    """The largest |value| of a leaf's pieces, a 0-d float32 tensor."""
    return torch.stack([p.abs().amax().float() for p in _pieces(x)]).amax()


def scale_of(amax: torch.Tensor) -> torch.Tensor:
    """The int8 scale of an absmax."""
    return torch.clamp_min(amax, 1e-12) / 127.0


def _round(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(
        torch.int8)


def quantize(x):
    """Symmetric int8 quantisation of a leaf with one scale.  Returns (q,
    scale): q in the leaf's form, scale a 0-d float32 tensor."""
    scale = scale_of(absmax(x))
    return _like(x, [_round(p, scale) for p in _pieces(x)]), scale


def dequantize(q, scale):
    return _like(q, [p.float() * scale for p in _pieces(q)])


@torch.no_grad()
def ef_accumulate(acc_q, acc_scale, residual, grad):
    """Error-feedback accumulate: acc += grad, storing acc in int8.
    ``full = dequantize(acc) + grad + residual`` is requantized with its
    own scale and the residual keeps what int8 lost.  `acc_q` and
    `residual` (float32) are updated in place; returns (acc_q, new scale,
    residual)."""
    ef_add(acc_q, acc_scale, residual, grad)
    scale = scale_of(absmax(residual))
    ef_requantize(acc_q, residual, scale)
    return acc_q, scale, residual


@torch.no_grad()
def ef_add(acc_q, acc_scale, residual, grad) -> None:
    """The residual, in place, becomes ``dequantize(acc) + grad +
    residual``."""
    for q, r, g in zip(_pieces(acc_q), _pieces(residual), _pieces(grad)):
        r.add_((q.float() * acc_scale).add_(g))   # (deq + g) + residual


@torch.no_grad()
def ef_requantize(acc_q, residual, scale) -> None:
    """acc = the residual rounded at `scale`; the residual keeps what int8
    lost (both in place)."""
    for q, r in zip(_pieces(acc_q), _pieces(residual)):
        q.copy_(_round(r, scale))
        r.sub_(q.float() * scale)


def init_ef_state(groups) -> dict:
    """Zero buffers for the leaves `groups` (one tensor or list of pieces
    each): {"q": int8, "scale": 0-d float32, "residual": float32}, one
    entry a leaf."""
    def zeros(x, dtype):
        return _like(x, [torch.zeros(p.shape, dtype=dtype, device=p.device)
                         for p in _pieces(x)])
    return {"q": [zeros(x, torch.int8) for x in groups],
            "scale": [torch.zeros((), dtype=torch.float32,
                                  device=_pieces(x)[0].device)
                      for x in groups],
            "residual": [zeros(x, torch.float32) for x in groups]}


__all__ = ["quantize", "dequantize", "ef_accumulate", "ef_add",
           "ef_requantize", "absmax", "scale_of", "init_ef_state"]
