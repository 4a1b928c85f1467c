"""Mixture-of-Experts layer on PyTorch, as in `repro.models.moe`: top-k
routing, capacity-bounded dispatch into a dense (E, C, d) buffer, the
experts as one batched product, and a weighted combine.

The routing is JAX's, decision for decision:
  * the top K experts of each token are the first K of a stable
    descending sort of its router probabilities, so among equal
    probabilities the lower expert index comes first (`jax.lax.top_k` is
    stable; `torch.topk` promises no tie order);
  * each (token, slot) assignment is ranked within its expert by an
    exclusive cumsum in flat (token, slot) order, and assignments ranked
    at or past the capacity C = max(1, int(N K cf / E)) are dropped (at a
    decode step N is the batch, so C is often 1);
  * each token's K weighted expert outputs are added slot after slot into
    a float32 buffer that starts at zero, in a fixed order (JAX's scatter
    add, without `index_add_`'s atomics).
Every expert runs on its whole capacity buffer, used or not (the dense
dispatch), so a decode step reads every expert's weights.  Shared experts
(DeepSeek-V2) run densely beside the routed ones.

Under `sharding.tensor_parallel.model_parallel` (the sharded train step)
a rank holds its block of E / m experts and its columns of the shared
experts' ff: every rank routes as above, runs its experts on the slots of
the assignments routed to them, and sums each assignment's expert output
over "model" before the combine (one rank adds a non-zero: exact); the
shared experts run column- then row-parallel.

Inside `global_routing(mesh, axes)` (the sharded train step) each rank
holds its rows of a global batch, the ranks of `axes` in global row order,
and a layer routes as JAX's SPMD layer routes the global batch: C from the
global token count, each assignment ranked within its expert after the
assignments of the ranks before it (one all-gather of the per-expert counts
a layer call), and the aux loss's top-1 fractions from the global counts.
A rank's aux is its share, E sum_e (its summed probabilities_e / N global)
x ce_e global, so the shares sum to JAX's aux; the counts carry no
gradient.  Outside it a layer routes its own tokens, as JAX's unsharded
layer.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F

from ..sharding import tensor_parallel
from .common import Layout, act_fn

#: (mesh, axes) of the data group that routes as one batch, while
#: `global_routing` is active (a module global, not a context variable:
#: layers recomputed in backward may run on autograd's own threads)
_DATA_GROUP = None


@contextlib.contextmanager
def global_routing(mesh, axes):
    """Route every MoE layer run inside the block (its recomputation in
    backward included) over the tokens of the ranks along `axes` of
    `mesh`, each holding as many tokens, in rank order."""
    global _DATA_GROUP
    saved, _DATA_GROUP = _DATA_GROUP, (mesh, axes)
    try:
        yield
    finally:
        _DATA_GROUP = saved


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    capacity_factor: float = 1.0
    router_dtype: str = "float32"
    num_groups: int = 1      # >1: rank and capacity per contiguous token group


def moe_layout(d: int, cfg: MoEConfig) -> Layout:
    lay: Layout = {
        "router": ((d, cfg.num_experts), ("model_d", None), "normal"),
        "wg": ((cfg.num_experts, d, cfg.d_ff_expert),
               ("experts", "model_d", "expert_ff"), "normal"),
        "wi": ((cfg.num_experts, d, cfg.d_ff_expert),
               ("experts", "model_d", "expert_ff"), "normal"),
        "wo": ((cfg.num_experts, cfg.d_ff_expert, d),
               ("experts", "expert_ff", "model_d"), "normal"),
    }
    if cfg.num_shared:
        f = cfg.d_ff_expert * cfg.num_shared
        lay["shared"] = {
            "wg": ((d, f), ("model_d", "ff"), "normal"),
            "wi": ((d, f), ("model_d", "ff"), "normal"),
            "wo": ((f, d), ("ff", "model_d"), "normal"),
        }
    return lay


def moe_forward(params, x, cfg: MoEConfig, act: str = "silu"):
    """x: (B, S, D) -> ((B, S, D), aux load-balance loss).  With
    ``num_groups`` G > 1 the B S tokens split into G contiguous groups,
    each routed with its own ranks and capacity."""
    B, S, D = x.shape
    G = cfg.num_groups
    if G == 1:
        return _moe_dense(params, x, cfg, act)
    if _DATA_GROUP is not None:
        raise ValueError("token groups are not routed over a data group")
    if (B * S) % G:
        raise ValueError(f"{B * S} tokens do not split into {G} groups")
    outs, auxs = zip(*(_moe_dense(params, xs[None], cfg, act)
                       for xs in x.reshape(G, B * S // G, D)))
    return torch.cat(outs).reshape(B, S, D), torch.stack(auxs).mean()


def _one_hot(idx, n: int):
    """``F.one_hot(idx, n)`` (int64) without its check of the indices'
    range, which reads them on the host: a sync on the card."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def route(probs, cfg: MoEConfig):
    """The routing of N tokens' router probabilities (N, E): (top_p, top_e
    (N, K), flat_e (N K,), each (token, slot) assignment's rank within its
    expert (N K,), the capacity C, the aux loss); an assignment is kept
    when its rank is below C.  Over a data group (`global_routing`) the
    ranks, C and the aux are the global batch's (the aux this rank's
    share), and a rank's dispatch buffer has a row for every global slot."""
    N, E = probs.shape
    K = cfg.top_k
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :K], top_e[:, :K]              # (N, K)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)        # renormalise
    flat_e = top_e.reshape(N * K)
    onehot = _one_hot(flat_e, E).to(torch.int32)           # (N K, E)
    # rank within expert: position of each (token, slot) among its expert's
    ranks = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    first = _one_hot(top_e[:, 0], E)
    if _DATA_GROUP is None:
        C = max(1, int(N * K * cfg.capacity_factor / E))
        # load-balance aux loss (Switch-style)
        me = probs.mean(dim=0)
        ce = first.to(probs.dtype).mean(dim=0)
    else:
        mesh, axes = _DATA_GROUP
        n = N * mesh.axis_size(axes)                       # global tokens
        C = max(1, int(n * K * cfg.capacity_factor / E))
        with torch.no_grad():
            counts = torch.stack([onehot.sum(dim=0),
                                  first.sum(dim=0)])[None]  # (1, 2, E)
            every = mesh.all_gather(counts, axes)          # (ranks, 2, E)
            ranks = ranks + every[:mesh.index(axes), 0].sum(dim=0)
            ce = every[:, 1].sum(dim=0).to(probs.dtype) / n
        me = probs.sum(dim=0) / n
    aux = E * (me * ce).sum()
    rank = ranks.gather(1, flat_e[:, None])[:, 0]
    return top_p, top_e, flat_e, rank, C, aux


def _moe_dense(params, x, cfg: MoEConfig, act: str = "silu"):
    B, S, D = x.shape
    N = B * S
    K = cfg.top_k

    xt = x.reshape(N, D)
    rdt = getattr(torch, cfg.router_dtype)
    probs = torch.softmax(xt.to(rdt) @ params["router"].to(rdt), dim=-1)
    top_p, top_e, flat_e, rank, C, aux = route(probs, cfg)
    keep = rank < C

    # this rank's experts lo .. lo + El (all E outside Megatron compute);
    # each kept assignment to one of them gets its slot, every other one
    # goes to the overflow bin C, which is cut off
    lo, El = tensor_parallel.experts(cfg.num_experts)
    mine = keep & (flat_e >= lo) & (flat_e < lo + El)
    local = torch.where(mine, flat_e - lo, 0)
    slot = torch.where(mine, rank, C)
    buf = torch.zeros((El, C + 1, D), dtype=xt.dtype, device=x.device)
    # each token's row once a slot (backward: K rows summed a token, not
    # an indexed accumulate, which takes atomics on the card); under
    # Megatron compute the rows come from one float32 copy of xt, whose
    # gradient (this rank's experts' share) is summed over "model"
    buf[local, slot] = tensor_parallel.copy_in(xt).repeat_interleave(
        K, dim=0).to(xt.dtype)
    buf = buf[:, :C]

    # expert FFN, batched over the rank's experts
    g = act_fn(act)(torch.bmm(buf, params["wg"]))
    h = g * torch.bmm(buf, params["wi"])
    y = F.pad(torch.bmm(h, params["wo"]), (0, 0, 0, 1))    # (El, C + 1, D)

    # combine: each assignment's expert output (summed over "model", where
    # one rank holds its expert and the others add zeros), weighted by its
    # router prob where kept, the K slots of a token added in slot order
    ye = tensor_parallel.summed(y[local, slot])             # (N K, D)
    w = torch.where(keep, top_p.reshape(N * K), 0.0)
    contrib = (ye.float() * w[:, None]).reshape(N, K, D)
    out = torch.zeros((N, D), dtype=torch.float32, device=x.device)
    for k in range(K):
        out = out + contrib[:, k]

    if cfg.num_shared:
        sp = params["shared"]
        sg, si = tensor_parallel.column(xt, sp["wg"], sp["wi"])
        out = out + tensor_parallel.row(act_fn(act)(sg) * si,
                                        sp["wo"]).float()

    return out.to(x.dtype).reshape(B, S, D), aux


__all__ = ["MoEConfig", "moe_layout", "moe_forward", "route",
           "global_routing"]
