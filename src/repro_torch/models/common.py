"""Shared model building blocks on PyTorch, as in `repro.models.common`:
param tables, norms, MLPs, rotary.

Parameters come from *layout tables* `{name: (shape, logical_axes,
init_kind)}`, the JAX package's own tables.  The same table yields the init
values, the parameter count, the meta tensors of `abstract_params` and the
`core.mesh.PartitionSpec` tree of `param_specs` (through
`sharding.rules`), so they cannot drift apart.  Trees from the table are in
JAX's layout: layers stacked on axis 0 where JAX stacks them.

Every op keeps JAX's dtypes: a norm computes in float32 and casts back to
the input's dtype, and ``x @ W`` on bfloat16 operands returns bfloat16.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..sharding import tensor_parallel
from ..sharding.rules import ShardingRules, spec_tree_from_layout

Layout = dict  # {name: (shape, logical_axes, init_kind) | nested Layout}


# ---------------------------------------------------------------------------
# Param tables
# ---------------------------------------------------------------------------

def _init_tensor(shape, kind: str, dtype: torch.dtype,
                 generator: torch.Generator | None, device) -> torch.Tensor:
    """One leaf, drawn as `repro.models.common._init_array` draws it: normal
    leaves scale by 1/sqrt(shape[0]) (so a stacked (L, d_in, d_out) leaf
    scales by 1/sqrt(L), as in JAX), embeddings by 0.02; the draw is in
    float32, scaled in place (no second float32 copy of the leaf), then
    cast.  ``rglru_a`` draws nothing: JAX's float64 inverse-softplus values,
    spaced for a stable RG-LRU decay, broadcast to `shape`."""
    if kind == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if kind in ("normal", "embed"):
        if kind == "normal":
            fan_in = shape[0] if len(shape) > 1 else shape[-1]
            scale = 1.0 / math.sqrt(max(fan_in, 1))
        else:
            scale = 0.02
        draw = torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=device)
        return draw.mul_(scale).to(dtype)
    if kind == "rglru_a":  # see rglru.py: softplus^-1 spaced for stable decay
        u = np.linspace(0.9, 0.999, shape[-1])
        val = np.log(np.expm1(-np.log(u) / (8.0 / 256)))   # inverse softplus
        row = torch.from_numpy(val.astype(np.float32)).to(device=device,
                                                          dtype=dtype)
        return row.expand(shape).contiguous()
    raise ValueError(f"unknown init kind {kind!r}")


def init_params(layout: Layout, dtype: torch.dtype = torch.bfloat16, *,
                generator: torch.Generator | None = None, device=None):
    """Materialise a nested dict of tensors from a layout table, leaves drawn
    in the table's order from `generator` (which must live on `device`)."""
    def build(lay):
        return {name: (build(val) if isinstance(val, dict)
                       else _init_tensor(val[0], val[2], dtype, generator,
                                         device))
                for name, val in lay.items()}
    return build(layout)


def abstract_params(layout: Layout, dtype: torch.dtype = torch.bfloat16):
    """The tree of a layout as tensors on the ``meta`` device: shapes and
    dtypes, no memory."""
    def build(lay):
        return {name: (build(v) if isinstance(v, dict)
                       else torch.empty(v[0], dtype=dtype, device="meta"))
                for name, v in lay.items()}
    return build(layout)


def param_specs(rules: ShardingRules, layout: Layout):
    """The PartitionSpec tree of a layout under `rules`
    (`sharding.rules.spec_tree_from_layout`, under JAX's name)."""
    return spec_tree_from_layout(rules, layout)


def param_count(layout: Layout) -> int:
    def cnt(lay):
        return sum(cnt(v) if isinstance(v, dict) else int(np.prod(v[0]))
                   for v in lay.values())
    return cnt(layout)


# ---------------------------------------------------------------------------
# Core ops
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")   # jax.nn.gelu(approximate=True)


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


def glu_mlp(params, x, act: str = "silu"):
    """Gated MLP (SwiGLU/GeGLU): (x W_g * act) * (x W_i) W_o.  Under
    `tensor_parallel.model_parallel` the weights are this rank's ff
    columns: W_g and W_i column-parallel on one input (one sum of its
    gradient), W_o row-parallel (one sum)."""
    xg, xi = tensor_parallel.column(x, params["wg"], params["wi"])
    return tensor_parallel.row(act_fn(act)(xg) * xi, params["wo"])


def mlp(params, x, act: str = "gelu"):
    """Plain MLP: act(x W_i) W_o, tensor-parallel as `glu_mlp`."""
    (xi,) = tensor_parallel.column(x, params["wi"])
    return tensor_parallel.row(act_fn(act)(xi), params["wo"])


def glu_mlp_layout(d: int, f: int) -> Layout:
    return {"wg": ((d, f), ("model_d", "ff"), "normal"),
            "wi": ((d, f), ("model_d", "ff"), "normal"),
            "wo": ((f, d), ("ff", "model_d"), "normal")}


def mlp_layout(d: int, f: int) -> Layout:
    return {"wi": ((d, f), ("model_d", "ff"), "normal"),
            "wo": ((f, d), ("ff", "model_d"), "normal")}


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, device=x.device)       # (hd/2,)
    angles = positions[..., :, None, None].float() * freqs     # (...,S,1,hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def _chunk_nll(hs, embed_t, ts, ms):
    """(sum of the chunk's masked NLL, sum of its mask), float32."""
    logits = (hs @ embed_t).float()                         # (B, c, V)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, ts.long()[..., None])[..., 0]
    return ((logz - gold) * ms).sum(), ms.sum()


def chunked_cross_entropy(hidden, embed_t, targets, mask, chunk: int = 512,
                          mask_count=None):
    """CE over huge vocabularies without materialising (B, S, V) at once,
    as JAX's `chunked_cross_entropy`.

    hidden: (B, S, D); embed_t: (D, V) output head; targets / mask: (B, S).
    The chunks of `chunk` positions run in order; each chunk's logits
    (the product in hidden's dtype cast to float32, JAX's order: product
    first, cast after; JAX's leading ``logits_fn`` argument is dropped, as
    every caller passes that cast) are recomputed in backward
    (`torch.utils.checkpoint`, as JAX's ``jax.checkpoint(body)``), so the
    live logits stay at (B, chunk, V).  S must be a multiple of `chunk`
    (JAX's reshape fails otherwise); ValueError if not.

    The masked NLL's sum is divided by max(`mask_count`, 1): by default
    this batch's own mask sum; the sharded train step passes the count of
    the global batch, so that a rank's result is its share of the global
    mean (shares of unequal counts do not average to it).
    """
    B, S, D = hidden.shape
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"loss chunk {chunk}")
    tot = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, S, chunk):
        nll, m = checkpoint(_chunk_nll, hidden[:, i:i + chunk],
                            embed_t, targets[:, i:i + chunk],
                            mask[:, i:i + chunk], use_reentrant=False)
        tot, cnt = tot + nll, cnt + m
    if mask_count is not None:
        cnt = mask_count
    return tot / torch.clamp_min(cnt, 1.0)


__all__ = [
    "Layout", "init_params", "abstract_params", "param_specs", "param_count",
    "chunked_cross_entropy",
    "rms_norm", "layer_norm", "act_fn", "glu_mlp", "mlp", "glu_mlp_layout",
    "mlp_layout", "rope_frequencies", "apply_rope",
]
