"""Train-step factory, as `repro.train.train_step`: loss -> grads (with
optional microbatch accumulation, plain or in int8 error-feedback buffers)
-> AdamW update.

``make_train_step(model, tcfg)`` returns ``train_step(state, batch) ->
(state, metrics)``.  The state is a nested dict of tensors,
``{"params": model.tree(), "opt": {"m", "v", "step"}}`` in the port's
per-layer layout (`models.convert.train_state_from_jax` /
`train_state_to_numpy` carry JAX's across), so `CheckpointManager` saves
it as it is.  The step updates the state in place (JAX's step donates it)
and returns it; its ``params`` are the model's own weights.  A state whose
weights are other tensors (one restored from a checkpoint) is loaded into
the model first.  Metrics are 0-d float32 tensors on the device:
``loss``, ``grad_norm`` and ``lr``; the step makes no host sync.

Each microbatch's gradients come from `torch.autograd.grad` (the weights'
dtype, bf16 for the real configs) and are added into float32 buffers, as
JAX adds them into float32 zeros; `.grad` accumulation over several
backward calls would sum in the weights' dtype.  With ``compress_accum``
the buffers are int8 with a float32 residual, one scale a leaf of JAX's
stacked layout (`optim.compression`); like JAX's, they live for one step,
and the residual's memory takes the dequantized gradients at its end.

`abstract_train_state` and `train_state_specs` describe the state in JAX's
stacked layout (meta tensors, PartitionSpec trees).

``make_train_step(model, tcfg, mesh, rules)`` is the sharded step, JAX's
SPMD step on a mesh of ranks (`core.mesh.Mesh`): it computes the unsharded
step on the global batch.  The state holds this rank's block of every leaf
of ``train_state_specs(model, rules, data size)``
(`sharding.placement.shard_train_state`; the moments ZeRO-1's blocks), and
the batch this rank's rows of it (`data.pipeline.SyntheticTokenPipeline.
sharded_batch`: in each microbatch the data ranks' rows in global order).
The mesh has a "model" axis (ValueError otherwise).  A step:
  1. the model takes the rank's blocks as they are, with no gather and no
     copy (every family computes on them:
     `sharding.tensor_parallel.computes_on_blocks`);
  2. all-reduces the microbatches' mask counts over the data axes and
     runs forward and backward on the rank's rows, the cross entropy
     divided by the global count and MoE routed over the global batch
     (`models.moe.global_routing`), so a rank's loss is its share, inside
     `tensor_parallel.model_parallel`: Megatron compute over "model"
     (column-, then row-parallel products, one pair of sums a block, the
     embedding and the cross entropy vocab-parallel, MoE's experts, MLA's
     heads, the RG-LRU's columns and the mLSTM's heads on the rank's
     blocks; the sLSTM's recurrence whole on every rank), so its gradients
     are the blocks' and every model rank's loss is the same;
  3. sums the float32 gradients over the data axes (one collective after
     the plain accumulation, one a microbatch before the int8 error
     feedback), the replicated leaves whose gradients are a rank's share
     (MQA's wk and wv; the RG-LRU's b_rg, b_ig and lam; the mLSTM's b_if:
     `TrainPlacement.leaf_roles`) over "model" first; the int8 scale of a
     leaf sharded over "model" is its absmax over "model", one scale a JAX
     leaf;
  4. takes the global norm and the clip scale from the summed gradients
     (the blocks' squares summed over "model", each replicated leaf once),
     and updates the region of each weight that the rank's moments cover
     (`optim.adamw.update_regions`);
  5. gathers each weight's block whole again over the data axes, and
     leaves the model holding no weights (meta tensors), so that a rank
     holds only its blocks between steps;
  6. reports the loss as the sum of the ranks' shares over the data axes.
A rank that fails fails its collectives' peers.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._pytree import (tree_flatten, tree_leaves, tree_map,
                                tree_unflatten)

from ..models.convert import jax_leaf_groups
from ..models.moe import global_routing
from ..optim import adamw, compression
from ..sharding import tensor_parallel
from ..sharding.placement import TrainPlacement
from ..sharding.rules import SINGLE_POD_RULES


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: adamw.AdamWConfig = adamw.AdamWConfig()
    accum_steps: int = 1
    compress_accum: bool = False     # int8 + error-feedback accumulation


def _trainable(model) -> dict:
    """The model's weights, made trainable, as its tree."""
    for p in model.parameters():
        p.requires_grad_(True)
    return model.tree()


def init_train_state(model, generator: torch.Generator | None = None, *,
                     device=None) -> dict:
    """Draw `model`'s weights (`model.init(generator, device=device)`;
    device None: ``cuda``), make them trainable, and zero AdamW's state."""
    params = _trainable(model.init(generator, device=device))
    return {"params": params, "opt": adamw.init_state(params)}


def abstract_train_state(model) -> dict:
    """The state's shapes and dtypes in JAX's layout, as meta tensors."""
    params = model.abstract_params()

    def f32(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")
    return {"params": params,
            "opt": {"m": tree_map(f32, params), "v": tree_map(f32, params),
                    "step": torch.empty((), dtype=torch.int32,
                                        device="meta")}}


def train_state_specs(model, rules, data_size: int) -> dict:
    """The state's PartitionSpec tree in JAX's layout, ZeRO-1 moments."""
    pspecs = model.param_specs(rules)
    shapes = model.abstract_params()
    data_axes = rules.axis("batch")
    if data_axes is None:
        data_axes = ("data",)
    if isinstance(data_axes, str):
        data_axes = (data_axes,)
    return {"params": pspecs,
            "opt": adamw.opt_state_specs(pspecs, shapes, data_axes,
                                         data_size)}


def _bind(model, params: dict) -> dict:
    """`params` as the model's own trainable weights."""
    own = model.tree()
    if not all(a is b for a, b in zip(tree_leaves(own),
                                      tree_leaves(params))):
        model.load(params)
    return _trainable(model)


def _micro(batch: dict, A: int) -> list[dict]:
    """The batch's A microbatches: rows i B/A .. (i + 1) B/A each, as JAX's
    reshape to (A, B / A, ...) splits it."""
    n = next(iter(batch.values())).shape[0]
    if n % A:
        raise ValueError(f"batch of {n} rows does not split into {A} "
                         f"microbatches")
    mb = n // A
    return [{k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            for i in range(A)]


def _grads_of(model, leaves, batch, mask_count=None):
    """(the loss detached, d loss / d each leaf)."""
    loss = model.loss(batch, mask_count=mask_count)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, grads)]


class _Flat(list):
    """float32 zeros shaped like `leaves`: views of one buffer, ``flat``,
    which the sharded step sums over the data axes in one collective."""

    def __init__(self, leaves):
        sizes = [p.numel() for p in leaves]
        self.flat = torch.zeros(sum(sizes), dtype=torch.float32,
                                device=leaves[0].device)
        super().__init__(part.view(p.shape) for part, p in zip(
            self.flat.split(sizes), leaves))


def _accumulated(model, tcfg: TrainConfig, leaves: list, spec,
                 batches: list, counts=None, reduce=None, amax=None):
    """(the microbatches' losses summed / A, the gradients summed / A in
    float32).  Without `reduce`, one process's step.  With it, the sharded
    step's: `counts[i]` is the global batch's mask count of microbatch i,
    and ``reduce(buffers)`` sums a `_Flat` over the data axes in place, once
    after the plain sum (which is linear), or each microbatch's gradient
    before its int8 error feedback (which quantises the global gradient,
    as JAX's SPMD step does).  ``amax(v)`` (tensor-parallel step) takes
    the JAX leaves' absmaxes over "model" before the int8 scales."""
    A = len(batches)
    device = leaves[0].device
    lsum = torch.zeros((), dtype=torch.float32, device=device)

    def grads_of(i, mb):
        return _grads_of(model, leaves, mb,
                         None if counts is None else counts[i])

    if not (tcfg.compress_accum and A > 1):
        acc = _Flat(leaves)
        for i, mb in enumerate(batches):
            loss, grads = grads_of(i, mb)
            for a, g in zip(acc, grads):
                a.add_(g)
            del grads
            lsum = lsum + loss
        if reduce:
            reduce(acc)
        return lsum / A, [a.div_(A) for a in acc]
    # int8 error-feedback accumulation, one scale a JAX leaf: the
    # buffers in the parameters' tree, grouped as JAX's leaves
    def zeros(dtype):
        return tree_unflatten([torch.zeros(p.shape, dtype=dtype,
                                           device=p.device)
                               for p in leaves], spec)
    qs, res = zeros(torch.int8), zeros(torch.float32)
    groups = list(zip(jax_leaf_groups(qs, model),
                      jax_leaf_groups(res, model)))
    scales = [torch.zeros((), dtype=torch.float32, device=device)] * len(
        groups)
    summed = _Flat(leaves) if reduce else None
    for i, mb in enumerate(batches):
        loss, grads = grads_of(i, mb)
        if reduce:
            for b, g in zip(summed, grads):
                b.copy_(g)
            reduce(summed)
            grads = summed
        grads = jax_leaf_groups(tree_unflatten(grads, spec), model)
        for (q, r), g, s in zip(groups, grads, scales):
            compression.ef_add(q, s, r, g)
        del grads
        amaxes = torch.stack([compression.absmax(r) for _, r in groups])
        if amax:
            amaxes = amax(amaxes)
        scales = [compression.scale_of(a) for a in amaxes.unbind()]
        for (q, r), s in zip(groups, scales):
            compression.ef_requantize(q, r, s)
        lsum = lsum + loss
    for (q, r), scale in zip(groups, scales):
        for qi, ri in zip(q, r):     # JAX's dequantize(q, s) / A
            torch.mul(qi.float(), scale, out=ri).div_(A)
    return lsum / A, tree_leaves(res)


def make_train_step(model, tcfg: TrainConfig, mesh=None,
                    rules=SINGLE_POD_RULES):
    """The train step of `model` (see the module docstring); with `mesh`,
    the sharded step on it under `rules`."""
    if mesh is not None:
        return _sharded_step(model, tcfg, mesh, rules)
    A = tcfg.accum_steps

    def train_step(state: dict, batch: dict):
        params = _bind(model, state["params"])
        leaves, spec = tree_flatten(params)
        if A > 1:
            loss, grads = _accumulated(model, tcfg, leaves, spec,
                                       _micro(batch, A))
        else:
            loss, grads = _grads_of(model, leaves, batch)
        params, opt, metrics = adamw.update(
            tcfg.opt, tree_unflatten(grads, spec), state["opt"], params)
        return {"params": params, "opt": opt}, {"loss": loss, **metrics}

    return train_step


def _release(model) -> None:
    """Leave `model` holding no weights (meta tensors of their shapes)."""
    model.load(tree_map(lambda t: t.detach().to("meta"), model.tree()))


def _aligned(tree, like) -> list:
    """The leaves of `like` (a tree with `tree`'s keys) in `tree`'s
    flattening order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _aligned(tree[k], like[k])]
    if isinstance(tree, list):
        return [x for a, b in zip(tree, like, strict=True)
                for x in _aligned(a, b)]
    return [like]


def _sharded_step(model, tcfg: TrainConfig, mesh, rules):
    """The SPMD step of JAX's ``jit(make_train_step(...))`` over a state
    placed by `train_state_specs` (`sharding.placement`); see the module
    docstring."""
    if "model" not in mesh.shape or \
            not tensor_parallel.computes_on_blocks(model):
        raise ValueError(f"the sharded step computes on the blocks over "
                         f"\"model\": {mesh} needs that axis and "
                         f"{model.cfg.name} a family that runs on its "
                         f"blocks")
    place = TrainPlacement(model, mesh, rules)
    axes = place.data_axes
    mesh.group(axes)       # every rank makes the data group's subgroups now
    roles = place.leaf_roles()

    def train_step(state: dict, batch: dict):
        blocks, opt = state["params"], state["opt"]
        with tensor_parallel.model_parallel(mesh, "model"):
            model.load(blocks)
        leaves, spec = tree_flatten(_trainable(model))
        batches = _micro(batch, tcfg.accum_steps)
        counts = mesh.all_reduce_sum(torch.stack([
            mb["mask"].to(leaves[0].device).float().sum()
            for mb in batches]), axes)
        kinds = _aligned(model.tree(), roles)
        partial = [i for i, r in enumerate(kinds) if r == "partial"]

        def reduce(buffers: _Flat) -> None:
            if partial:
                shares = torch.cat([buffers[i].view(-1) for i in partial])
                mesh.all_reduce_sum(shares, "model")
                for i, s in zip(partial, shares.split(
                        [buffers[i].numel() for i in partial])):
                    buffers[i].copy_(s.view_as(buffers[i]))
            mesh.all_reduce_sum(buffers.flat, axes)

        def amax(v):
            return mesh.all_reduce_max(v, "model")

        with global_routing(mesh, axes), \
                tensor_parallel.model_parallel(mesh, "model"):
            share, grads = _accumulated(model, tcfg, leaves, spec, batches,
                                        counts, reduce, amax)
        gnorm = adamw.global_norm(
            grads, [r == "block" for r in kinds],
            lambda x: mesh.all_reduce_sum(x, "model"))
        grads = tree_unflatten(grads, spec)
        step, metrics = adamw.update_regions(
            tcfg.opt, grads, place.regions(blocks, grads, opt["m"],
                                           opt["v"]), opt["step"], gnorm)
        place.rebuild(blocks)
        with tensor_parallel.model_parallel(mesh, "model"):
            _release(model)
        loss = mesh.all_reduce_sum(share, axes)
        return ({"params": blocks, "opt": {"m": opt["m"], "v": opt["v"],
                                           "step": step}},
                {"loss": loss, **metrics})

    return train_step


__all__ = ["TrainConfig", "init_train_state", "abstract_train_state",
           "train_state_specs", "make_train_step"]
