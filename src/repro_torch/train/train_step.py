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
stacked layout (meta tensors, PartitionSpec trees), the layout sharded
training will read (ROADMAP Queue 1 item 11d).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._pytree import (tree_flatten, tree_leaves, tree_map,
                                tree_unflatten)

from ..models.convert import jax_leaf_groups
from ..optim import adamw, compression


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


def make_train_step(model, tcfg: TrainConfig):
    A = tcfg.accum_steps

    def grads_of(leaves, batch):
        """(the loss detached, d loss / d each leaf)."""
        loss = model.loss(batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                                for p, g in zip(leaves, grads)]

    def micro(batch: dict) -> list[dict]:
        """The batch's A microbatches: rows i B/A .. (i + 1) B/A each, as
        JAX's reshape to (A, B / A, ...) splits it."""
        n = next(iter(batch.values())).shape[0]
        if n % A:
            raise ValueError(f"batch of {n} rows does not split into "
                             f"{A} microbatches")
        mb = n // A
        return [{k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                for i in range(A)]

    def accumulated(leaves: list, spec, batch: dict):
        lsum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        if not tcfg.compress_accum:
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in leaves]
            for mb in micro(batch):
                loss, grads = grads_of(leaves, mb)
                for a, g in zip(acc, grads):
                    a.add_(g)
                del grads
                lsum = lsum + loss
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
        scales = [torch.zeros((), dtype=torch.float32,
                              device=leaves[0].device)] * len(groups)
        for mb in micro(batch):
            loss, grads = grads_of(leaves, mb)
            grads = jax_leaf_groups(tree_unflatten(grads, spec), model)
            for i, ((q, r), g) in enumerate(zip(groups, grads)):
                _, scales[i], _ = compression.ef_accumulate(q, scales[i], r,
                                                            g)
            del grads
            lsum = lsum + loss
        for (q, r), scale in zip(groups, scales):
            for qi, ri in zip(q, r):     # JAX's dequantize(q, s) / A
                torch.mul(qi.float(), scale, out=ri).div_(A)
        return lsum / A, tree_leaves(res)

    def train_step(state: dict, batch: dict):
        params = _bind(model, state["params"])
        leaves, spec = tree_flatten(params)
        if A > 1:
            loss, grads = accumulated(leaves, spec, batch)
        else:
            loss, grads = grads_of(leaves, batch)
        params, opt, metrics = adamw.update(
            tcfg.opt, tree_unflatten(grads, spec), state["opt"], params)
        return {"params": params, "opt": opt}, {"loss": loss, **metrics}

    return train_step


__all__ = ["TrainConfig", "init_train_state", "abstract_train_state",
           "train_state_specs", "make_train_step"]
