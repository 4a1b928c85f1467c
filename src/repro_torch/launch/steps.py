"""One (arch x shape x mesh) cell: its step, abstract arguments and
shardings, as `repro.launch.steps`; and the sharded serving steps.

`make_serve_step(model, kind, mesh, rules)` is the port's counterpart of
JAX's ``jit(model.prefill)`` / ``jit(model.decode_step)`` with in / out
shardings, for every family (the transformer's, Griffin, xLSTM): each rank
runs the step on its blocks of the weights, its rows of the batch and its
block of the cache (`sharding.placement.ServePlacement`: a recurrent
state on the columns or heads the rank computes), tensor-parallel over
"model" (`sharding.tensor_parallel`; heads that do not split in head
groups, as the train step), MoE routed over the data axes as one batch
(`models.moe.global_routing`), and every rank returns the logits whole
(JAX's ``P(batch, None, None)``, of its rows).

Given an arch module and a shape name, `build_cell` constructs
  * the step: the train step (`train.make_train_step`, taking the port's
    ``(state, batch)``), or for a prefill / decode cell the sharded serving
    step on a world's mesh (`core.mesh.Mesh`), the model's own `prefill` /
    `decode_step` on a mesh shape;
  * its abstract arguments, meta tensors (nothing is allocated), JAX's: the
    parameters and training state in JAX's stacked layout first;
  * the in / out shardings, JAX's as `core.mesh.PartitionSpec` trees.
The mesh is a `core.mesh.ShapeMesh` (or `Mesh`): only its axis sizes are
read.  JAX's `lower_cell` lowers a cell through XLA for the dry run; it
has no counterpart here, and nothing lowers these cells.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

from ..core.mesh import Mesh
from ..core.mesh import PartitionSpec as P
from ..models import build_model
from ..models.moe import global_routing
from ..sharding import tensor_parallel
from ..sharding.placement import ServePlacement, serve_rules
from ..sharding.rules import MULTI_POD_RULES, SINGLE_POD_RULES
from ..train import (TrainConfig, abstract_train_state, make_train_step,
                     train_state_specs)
from .mesh import data_axis_size


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    fn: Callable            # the step
    args: tuple             # abstract args (meta tensors)
    in_shardings: tuple     # PartitionSpec trees
    out_shardings: Any
    donate: tuple = ()
    model: Any = None


def make_serve_step(model, kind: str, mesh, rules=SINGLE_POD_RULES):
    """The sharded serving step of `model` (any family: the transformer's,
    Griffin, xLSTM) on `mesh` (a `core.mesh.Mesh`) under `rules`
    (`serve_rules`'s for one sequence: the batch replicated):
    ``prefill(blocks, batch, max_len=None) -> (logits, cache)`` for
    ``kind="prefill"``, ``decode(blocks, tokens, cache) -> (logits,
    cache)`` for ``"decode"``.  `blocks` are the rank's blocks of the
    weights, `batch` / `tokens` its rows and `cache` its block
    (`ServePlacement`: a layer list, or a recurrent family's
    `hybrid.StateCache`); the logits come back whole on every rank of
    "model" (its rows), the cache as the rank's block, updated in place by
    a decode step.  The blocks are loaded under `tensor_parallel.
    model_parallel` (again only when another tree is passed) and the step
    runs under it and `moe.global_routing` over the batch's axes (the
    model's steps run under `torch.no_grad`).  Every subgroup the step
    uses (the data group, the head groups' runs of the attention heads,
    kv heads or mLSTM heads) is made here, on every rank in one order.
    ValueError for a mesh without "model": the step never falls back to a
    replicated or single-process one."""
    cfg = model.cfg
    if "model" not in mesh.shape:
        raise ValueError(f"the sharded serving step computes on the blocks "
                         f"over \"model\": {mesh} has no such axis")
    if kind not in ("prefill", "decode") or (kind == "decode"
                                             and cfg.encoder_only):
        raise ValueError(f"no {kind} step for {cfg.name}")
    axes = ServePlacement(model, mesh, rules).data_axes
    if axes is not None:
        mesh.group(axes)         # every rank makes the data group now
    for r in sorted(tensor_parallel.head_runs(cfg, mesh.axis_size("model"))):
        mesh.group("model", run=r)     # and the head groups' runs
    held = []

    def run(fn, blocks, *args):
        if not held or held[0] is not blocks:
            with tensor_parallel.model_parallel(mesh, "model"):
                model.load(blocks)
            held[:] = [blocks]
        with tensor_parallel.model_parallel(mesh, "model"), (
                global_routing(mesh, axes) if axes is not None
                else contextlib.nullcontext()):
            return fn(*args)

    if kind == "prefill":
        def prefill(blocks: dict, batch: dict, max_len: int | None = None):
            return run(model.prefill, blocks, batch, max_len)
        return prefill

    def decode(blocks: dict, tokens, cache: list):
        return run(model.decode_step, blocks, tokens, cache)
    return decode


def build_cell(arch_mod, shape: str, mesh) -> Cell | None:
    """The baseline Cell for (arch, shape) on this mesh, or None if
    skipped.  JAX's optimisation switches (``opts``), ``config_override``
    and ``tcfg`` are not taken: nothing here lowers a cell, so nothing
    would read them; the train step takes the default `TrainConfig`."""
    multi_pod = "pod" in mesh.shape
    spec = arch_mod.input_specs(shape, multi_pod=multi_pod)
    if spec is None:
        return None
    cfg = arch_mod.CONFIG
    model = build_model(cfg)
    rules = MULTI_POD_RULES if multi_pod else SINGLE_POD_RULES

    if spec.kind == "train":
        state_specs = train_state_specs(model, rules, data_axis_size(mesh))
        out_sh = (state_specs, {"loss": P(), "grad_norm": P(), "lr": P()})
        return Cell(arch=cfg.name, shape=shape, kind="train",
                    fn=make_train_step(model, TrainConfig()),
                    args=(abstract_train_state(model), spec.args["batch"]),
                    in_shardings=(state_specs, spec.shardings["batch"]),
                    out_shardings=out_sh, donate=(0,), model=model)

    params = model.abstract_params()
    params_sh = model.param_specs(rules)
    logits_sh = P(rules.axis("batch"), None, None)
    # on a world's mesh the sharded serving step (it takes a rank's
    # blocks of `args`, `ServePlacement`); on a mesh shape the model's own
    step_rules = serve_rules(rules, spec.batch)
    serve = (make_serve_step(model, spec.kind, mesh, step_rules)
             if isinstance(mesh, Mesh) else None)

    if spec.kind == "prefill":
        if getattr(cfg, "encoder_only", False):
            out_sh = (logits_sh, None)  # encoder: emissions only, no cache
        else:
            # prefill cache shardings == decode cache shardings
            out_sh = (logits_sh, model.cache_specs(rules))
        return Cell(arch=cfg.name, shape=shape, kind="prefill",
                    fn=serve or model.prefill,
                    args=(params, spec.args["batch"]),
                    in_shardings=(params_sh, spec.shardings["batch"]),
                    out_shardings=out_sh, model=model)

    # decode: long_500k (batch 1) replicates the batch
    if spec.batch == 1:
        logits_sh = P(None, None, None)
    cache_sh = spec.shardings["cache"]
    return Cell(arch=cfg.name, shape=shape, kind="decode",
                fn=serve or model.decode_step,
                args=(params, spec.args["tokens"], spec.args["cache"]),
                in_shardings=(params_sh, spec.shardings["tokens"], cache_sh),
                out_shardings=(logits_sh, cache_sh), donate=(2,),
                model=model)


__all__ = ["Cell", "build_cell", "make_serve_step"]
