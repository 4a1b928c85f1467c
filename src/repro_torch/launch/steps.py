"""One (arch x shape x mesh) cell: its step, abstract arguments and
shardings, as `repro.launch.steps`.

Given an arch module and a shape name, `build_cell` constructs
  * the step: the train step (`train.make_train_step`, taking the port's
    ``(state, batch)``), or the model's own `prefill` / `decode_step`;
  * its abstract arguments, meta tensors (nothing is allocated), JAX's: the
    parameters and training state in JAX's stacked layout first;
  * the in / out shardings, JAX's as `core.mesh.PartitionSpec` trees.
The mesh is a `core.mesh.ShapeMesh` (or `Mesh`): only its axis sizes are
read.  JAX's `lower_cell` lowers a cell through XLA for the dry run; it
has no counterpart here, and nothing lowers these cells.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from ..core.mesh import PartitionSpec as P
from ..models import build_model
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

    if spec.kind == "prefill":
        if getattr(cfg, "encoder_only", False):
            out_sh = (logits_sh, None)  # encoder: emissions only, no cache
        else:
            # prefill cache shardings == decode cache shardings
            out_sh = (logits_sh, model.cache_specs(rules))
        return Cell(arch=cfg.name, shape=shape, kind="prefill",
                    fn=model.prefill, args=(params, spec.args["batch"]),
                    in_shardings=(params_sh, spec.shardings["batch"]),
                    out_shardings=out_sh, model=model)

    # decode: long_500k (batch 1) replicates the batch
    if spec.batch == 1:
        logits_sh = P(None, None, None)
    cache_sh = spec.shardings["cache"]
    return Cell(arch=cfg.name, shape=shape, kind="decode",
                fn=model.decode_step,
                args=(params, spec.args["tokens"], spec.args["cache"]),
                in_shardings=(params_sh, spec.shardings["tokens"], cache_sh),
                out_shardings=(logits_sh, cache_sh), donate=(2,),
                model=model)


__all__ = ["Cell", "build_cell"]
