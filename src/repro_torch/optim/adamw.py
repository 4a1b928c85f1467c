"""AdamW on tensors, as `repro.optim.adamw`, with its ZeRO-1 specs.

The update is JAX's arithmetic, leaf by leaf in float32 (not
`torch.optim.AdamW`, which applies the decay as ``p * (1 - lr wd)``
first):

    g = g * scale                        (global-norm clipping)
    m = b1 m + (1 - b1) g
    v = b2 v + (1 - b2) g^2
    delta = (m / b1c) / (sqrt(v / b2c) + eps) + wd p
    p = (p - lr delta) cast back to p's dtype

Weight decay applies to every leaf, norms and embeddings included.  The
schedule, the clip scale and the bias corrections b1c = 1 - b1^t and b2c =
1 - b2^t are 0-d float32 tensors computed on the device from the int32
step tensor, so a step makes no host sync.  `update` works in place on the
parameters and the moments (JAX's train step donates the state).

A tree is a nested dict / list of tensors.  `zero1_specs` and
`opt_state_specs` take PartitionSpec and shape trees in JAX's layout
(`model.param_specs`, `model.abstract_params`): the first / second moments
carry additional sharding over the data axes (ZeRO-1), the largest
still-replicated axis that the data size divides.  The sharded train step
reads them (`sharding.placement`): each rank holds its block of m and v and
updates that region of each weight with `update_regions`, whose global norm
comes from the gradients summed over the data axes: whole ones, or, under
Megatron compute, the blocks of the leaves sharded over "model" (their
squares summed over it) and each replicated leaf once (`global_norm`'s
`sharded`).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils._pytree import tree_leaves, tree_map

from ..core.mesh import PartitionSpec as P


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay at `step` (an int tensor), float32 on
    its device."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init_state(params) -> dict:
    """Zero float32 moments in the parameters' tree and a 0-d int32 step,
    on the parameters' device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _zip(*trees):
    """The leaves of like trees side by side, matched by key (dicts) or
    position (lists), whatever the trees' key orders."""
    first = trees[0]
    if isinstance(first, dict):
        for k in first:
            yield from _zip(*(t[k] for t in trees))
    elif isinstance(first, (list, tuple)):
        for items in zip(*trees, strict=True):
            yield from _zip(*items)
    else:
        yield trees


def global_norm(tree, sharded=None, sum_sharded=None) -> torch.Tensor:
    """sqrt of the sum over the leaves of their float32 sums of squares (a
    0-d float32 tensor; the leaves summed in the tree's order).  With
    `sharded` (a bool for each of the tree's leaves: whether it is a rank's
    block of a leaf sharded over "model"), the blocks' squares are summed,
    then summed over the ranks by `sum_sharded` (a 0-d tensor in, the sum
    out), and the other leaves', the same on every rank, added once."""
    norms = [torch.linalg.vector_norm(l, dtype=torch.float32)
             for l in tree_leaves(tree)]
    if sharded is None:
        return torch.stack(norms).square().sum().sqrt()

    def squares(pick):
        part = [n for n, s in zip(norms, sharded, strict=True) if s == pick]
        if not part:
            return torch.zeros((), dtype=torch.float32,
                               device=norms[0].device)
        return torch.stack(part).square().sum()
    return (sum_sharded(squares(True)) + squares(False)).sqrt()


def _apply(cfg: AdamWConfig, p, g, m, v, scale, lr, b1c, b2c) -> None:
    """The update of one leaf (or one region of it), in place."""
    g = g.float() * scale
    m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
    v.copy_(cfg.b2 * v + (1 - cfg.b2) * g.square())
    pf = p.float()
    delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
        + cfg.weight_decay * pf
    p.copy_(pf - lr * delta)


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: dict, params):
    """One AdamW step over matching trees of gradients (any float dtype),
    moments and parameters.  The parameters and ``state["m"]``,
    ``state["v"]`` are updated in place.  Returns (params, new state,
    metrics {"grad_norm", "lr"}: 0-d float32 tensors)."""
    step, metrics = update_regions(
        cfg, grads, _zip(params, grads, state["m"], state["v"]),
        state["step"])
    return params, {"m": state["m"], "v": state["v"], "step": step}, metrics


@torch.no_grad()
def update_regions(cfg: AdamWConfig, grads, regions, step: torch.Tensor,
                   gnorm: torch.Tensor | None = None):
    """The AdamW step of `update` over `regions`: the global norm (`gnorm`,
    or `global_norm` of the whole gradient tree `grads`) and the clip scale
    from it, then each (weights
    to update in place, their gradient, their m, their v) that `regions`
    yields: every leaf (`update`), or ZeRO-1's region of each leaf a rank
    holds the moments of, with `grads` summed over the data axes so that
    every rank computes the same scale (`sharding.placement.
    TrainPlacement.regions`).  Returns (the new step, metrics
    {"grad_norm", "lr"})."""
    step = step + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                        max=1.0)
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    for p, g, m, v in regions:
        _apply(cfg, p, g, m, v, scale, lr, b1c, b2c)
    return step, {"grad_norm": gnorm, "lr": lr}


def zero1_specs(param_spec_tree, param_shape_tree, data_axes=("data",),
                data_size: int = 16):
    """ZeRO-1: shard each moment buffer's largest replicated axis over
    data.  param_spec_tree / param_shape_tree: matching trees of
    PartitionSpec and shapes (or meta tensors).  Returns the moment
    buffers' spec tree."""
    axis_name = data_axes if len(data_axes) > 1 else data_axes[0]

    def one(spec, shape):
        shape = tuple(getattr(shape, "shape", shape))
        spec_t = tuple(spec) + (None,) * (len(shape) - len(spec))
        cand, size = None, 0
        for i, (s, n) in enumerate(zip(spec_t, shape)):
            if s is None and n % data_size == 0 and n > size:
                cand, size = i, n
        if cand is None:
            return P(*spec_t)
        new = list(spec_t)
        new[cand] = axis_name
        return P(*new)

    def walk(spec, shape):
        if isinstance(spec, dict):
            return {k: walk(v, shape[k]) for k, v in spec.items()}
        return one(spec, shape)
    return walk(param_spec_tree, param_shape_tree)


def opt_state_specs(param_spec_tree, param_shape_tree, data_axes=("data",),
                    data_size: int = 16):
    mom = zero1_specs(param_spec_tree, param_shape_tree, data_axes, data_size)
    return {"m": mom, "v": mom, "step": P()}


__all__ = ["AdamWConfig", "schedule", "init_state", "update",
           "update_regions", "global_norm", "zero1_specs", "opt_state_specs"]
