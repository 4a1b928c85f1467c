"""RG-LRU recurrent block (Griffin / RecurrentGemma) on PyTorch, as in
`repro.models.rglru`.

The recurrence is elementwise-diagonal and input-gated:
    r_t = sigmoid(x_t W_r + b_r)          (recurrence gate)
    i_t = sigmoid(x_t W_i + b_i)          (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

A prefill evaluates it as a log-depth scan over the combine ((a1, b1),
(a2, b2)) -> (a1 a2, a2 b1 + b2): Hillis-Steele, ceil(log2 S) elementwise
passes over the whole sequence, where JAX's `lax.associative_scan` builds
its own tree (so the two add in other orders: float32 rounding apart).  A
decode step carries (h, conv tail) state, O(1) a step, no KV cache.

Block structure (Griffin recurrent block): two input branches
  y = W_out( GeLU(x W_gate) * RGLRU(conv1d_4(x W_x)) ).

Under `sharding.tensor_parallel.model_parallel` the weights are this rank's
blocks (`tensor_parallel.block_layout`), and the block is Megatron's, as
JAX's partitioner runs it: W_gate and W_x column-parallel on one input,
the conv and the recurrence on the rank's ff columns (elementwise over
them), W_r and W_i (ff their input axis) through `tensor_parallel.
row_products` (partial products summed over "model" in one collective,
rounded once, cut to the rank's columns), their biases and Lambda as the
rank's span (`tensor_parallel.own`), and W_out row-parallel.  The widths
come from the blocks' shapes alone.  A decode step runs the same way on
the rank's columns of the state (`init_state` builds that block under the
context: the sharded serving step).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..sharding import tensor_parallel
from .common import Layout, act_fn

_C = 8.0


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_model: int
    d_rnn: int          # recurrence width (RecurrentGemma: d_rnn = d_model)
    conv_width: int = 4


def rglru_layout(cfg: RGLRUConfig) -> Layout:
    d, r = cfg.d_model, cfg.d_rnn
    return {
        "w_x": ((d, r), ("model_d", "ff"), "normal"),
        "w_gate": ((d, r), ("model_d", "ff"), "normal"),
        "conv_w": ((cfg.conv_width, r), (None, "ff"), "normal"),
        "conv_b": ((r,), ("ff",), "zeros"),
        "w_rg": ((r, r), ("ff", None), "normal"),
        "b_rg": ((r,), (None,), "zeros"),
        "w_ig": ((r, r), ("ff", None), "normal"),
        "b_ig": ((r,), (None,), "zeros"),
        "lam": ((r,), (None,), "rglru_a"),
        "w_out": ((r, d), ("ff", "model_d"), "normal"),
    }


def _causal_conv1d(x, w, b, state=None):
    """x: (B, S, R), w: (W, R) depthwise. state: (B, W-1, R) tail or None.
    Returns (out, the last W-1 inputs).  Taps add in JAX's order, 0 + sum
    over i ascending, which bf16 rounding sees."""
    W, S = w.shape[0], x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, W - 1, 0))
    else:
        xp = torch.cat([state, x], dim=1)
    out = sum(xp[:, i:i + S] * w[i] for i in range(W))
    return out + b, xp[:, -(W - 1):]


def _softplus(x):
    """jax.nn.softplus, ``logaddexp(x, 0)`` (F.softplus's threshold of 20
    would change values)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gates(params, u):
    """(a, gated input) in float32; each sigmoid in the activation dtype,
    then cast, as JAX computes them (on the rank's columns under
    `tensor_parallel.model_parallel`)."""
    own = tensor_parallel.own
    pr, pi = tensor_parallel.row_products((u, params["w_rg"]),
                                          (u, params["w_ig"]))
    r = torch.sigmoid(pr + own(params["b_rg"])).float()
    i = torch.sigmoid(pi + own(params["b_ig"])).float()
    log_a = -_C * _softplus(own(params["lam"])).float() * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i * u.float())
    return a, gated


def rglru_scan(params, u):
    """Full-sequence RG-LRU by a log-depth scan. u: (B, S, R) -> (h (B, S,
    R) in u's dtype, the last h (B, R) float32)."""
    a, b = _gates(params, u)
    S, d = u.shape[1], 1
    while d < S:          # after the pass of offset d, b[t] folds t-2d+1..t
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < S:
            a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b.to(u.dtype), b[:, -1].float()


def rglru_step(params, u, h_prev):
    """One decode step. u: (B, 1, R), h_prev: (B, R) float32."""
    a, b = _gates(params, u)
    h = a[:, 0] * h_prev + b[:, 0]
    return h[:, None, :].to(u.dtype), h


def block_forward(params, x, cfg: RGLRUConfig, state=None):
    """Griffin recurrent block. state: None (a prefill from scratch) or
    {"h": (B, R) float32, "conv": (B, W-1, R)}.  Returns (y, new_state).
    As in JAX, a state with S > 1 keeps its conv tail and scans from h = 0.
    Tensor-parallel under `tensor_parallel.model_parallel` (module
    docstring)."""
    gate, u = tensor_parallel.column(x, params["w_gate"], params["w_x"])
    gate = act_fn("gelu")(gate)
    conv_state = None if state is None else state["conv"]
    u, conv_tail = _causal_conv1d(u, params["conv_w"], params["conv_b"],
                                  conv_state)
    if state is None or x.shape[1] > 1:
        h_seq, h_last = rglru_scan(params, u)
    else:
        h_seq, h_last = rglru_step(params, u, state["h"])
    y = tensor_parallel.row(gate * h_seq, params["w_out"])
    return y, {"h": h_last, "conv": conv_tail}


def init_state(cfg: RGLRUConfig, batch: int, dtype=torch.bfloat16,
               device=None):
    """An empty state {h, conv tail}: its d_rnn columns, or under
    `tensor_parallel.model_parallel` the rank's span of them (the columns
    `column` gives it of u)."""
    r = tensor_parallel.span(cfg.d_rnn, "d_rnn")[1]
    return {"h": torch.zeros((batch, r), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, r),
                                dtype=dtype, device=device)}


__all__ = ["RGLRUConfig", "rglru_layout", "block_forward", "init_state",
           "rglru_scan", "rglru_step"]
