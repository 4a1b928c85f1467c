"""The dry run: every (arch x shape) cell on the production meshes, 16 x 16
and 2 x 16 x 16, without a card or a cluster, as `repro.launch.dryrun`
lowers and compiles each cell for 512 virtual XLA devices.

This process is rank 0 of a fake world of 256 or 512 ranks
(`launch.mesh.fake_world`: torch's ``fake`` process-group backend, whose
collectives return at once), and every device tensor is a fake tensor
(`torch._subclasses.FakeTensorMode`: shapes and dtypes, no storage), so
deepseek-v2 at its 60 layers costs no memory.  A train cell builds rank
0's blocks of the training state (`sharding.placement`) and its rows of
the global batch (`data.pipeline.shard_rows`), then runs one sharded train
step (`train.make_train_step(..., mesh=)`) under `launch.op_cost`, which
counts the step's flops, bytes, collectives, kernel launches and peak
memory op by op.  A row reports ``arg_bytes_per_device`` (the rank's state
and batch; ``state_bytes_per_device`` the state alone), the peak and the
rest of it (``temp_bytes_per_device``), whether the peak fits the card
(`roofline.HBM_BYTES`), the roofline row (`launch.roofline`) and the useful
flops (`launch.model_flops`).  The fake tensors name the CPU (`FAKE_DEVICE`);
the step takes the card's path on them (`core.device.on_card`), so a run on
the card's host and one on a CPU-only host count the same.

A prefill or decode cell builds rank 0's blocks of the weights
(`sharding.placement.ServePlacement`), its rows of the global batch
(tokens, a VLM's image embeddings or an encoder's frames; all of them for
one sequence, whose batch the rules replicate) and, for a decode cell, its
block of the cache, and runs the sharded serving step
(`launch.steps.make_serve_step`) under `OpCost` (`serve_cell`); its row
also reports ``cache_bytes_per_device``, and ``arg_bytes_per_device`` is
blocks + cache + inputs.  Every family serves so: Griffin's and xLSTM's
cache is a `models.hybrid.StateCache`, a rank's block of their recurrent
states (`ServePlacement`).

A host read of a fake tensor fails the row with the op's name and line
(`op_cost.HostRead`): a sync on the card's path.  ``skip`` is kept for the
arch's own `SKIPS`.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama_1_1b \\
        --shape train_4k [--multi-pod | --both-meshes] [--json out.jsonl]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

JAX's ``--opt`` (its optimisation switches) and ``--save-hlo`` have no
counterpart: the port has no switches to pass and no HLO to save.  A cell
takes 20-120 s of one CPU core, xlstm-350m's about an hour (its sLSTM scan
dispatches its ops a position); each process holds one world, so cells of
both meshes in one process re-make it between meshes.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import torch
from torch.utils._pytree import tree_map

from ..configs import ARCH_IDS, get_arch
from ..configs.base import SHAPES
from ..data.pipeline import shard_rows
from ..models import build_model
from ..models.convert import port_layout
from ..sharding.placement import (ServePlacement, data_axes, serve_rules,
                                  shard_train_state, state_bytes)
from ..sharding.rules import MULTI_POD_RULES, SINGLE_POD_RULES
from ..train import TrainConfig, abstract_train_state, make_train_step
from . import roofline as rl
from .mesh import fake_world, make_production_mesh
from .model_flops import useful_flops
from .op_cost import OpCost
from .steps import make_serve_step

#: the device the fake tensors name: the CPU, whose autograd runs on the
#: calling thread (with `op_cost` watching) in any build; the step takes the
#: card's path on fake tensors all the same (`core.device.on_card`)
FAKE_DEVICE = torch.device("cpu")


def fake_mode():
    """A fake-tensor mode that takes small real host tensors as inputs
    (the host-side tables a path builds with numpy)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def _fakes(tree, dev):
    """Fake empty tensors of a meta tree's shapes and dtypes on `dev`
    (inside the fake mode)."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device=dev), tree)


def _port_state(state: dict, model) -> dict:
    """A whole train state in JAX's layout, in the port's."""
    opt = state["opt"]
    return {"params": port_layout(state["params"], model),
            "opt": {"m": port_layout(opt["m"], model),
                    "v": port_layout(opt["v"], model), "step": opt["step"]}}


def train_cell(model, mesh, rules, batch: dict, tcfg: TrainConfig):
    """Rank 0's sharded train step of `model` on `mesh` (a mesh over a
    fake world) under `rules`, on its rows of the global `batch` (meta
    tensors of the global shapes), all on fake tensors: (the `OpCost` of
    the step, the rank's state bytes, its batch bytes).  Raises what the
    step raises (`op_cost.HostRead` at a host read)."""
    dev = FAKE_DEVICE
    axes = data_axes(rules, mesh)
    n = next(iter(batch.values())).shape[0]
    rows = len(shard_rows(n, mesh, tcfg.accum_steps, axes))
    with fake_mode():
        whole = _port_state(_fakes(abstract_train_state(model), dev), model)
        state = shard_train_state(whole, model, mesh, rules)
        del whole
        mine = {k: torch.empty((rows, *v.shape[1:]), dtype=v.dtype,
                               device=dev) for k, v in batch.items()}
        step = make_train_step(model, tcfg, mesh=mesh, rules=rules)
        cost = OpCost(mesh)
        cost.track(state, mine)
        with cost:
            step(state, mine)
    return cost, state_bytes(state), state_bytes(mine)


def serve_cell(model, mesh, rules, kind: str, inputs: dict, S: int,
               B: int, max_len: int | None = None):
    """Rank 0's sharded prefill or decode step of `model` on `mesh` (over a
    fake world) under `rules` (`serve_rules`'s for one sequence), all on
    fake tensors: a prefill of the global `inputs` (meta tensors: tokens,
    image embeddings or frames; its cache has room for `max_len`
    positions, None: their S, as JAX's), or one decode step of B tokens
    against a cache of S slots.
    Returns (the `OpCost` of the step, the rank's weight bytes, its cache
    bytes (0 for a prefill), its input bytes).  Raises what the step
    raises (`op_cost.HostRead` at a host read)."""
    dev = FAKE_DEVICE
    rules = serve_rules(rules, B)
    place = ServePlacement(model, mesh, rules)
    n = len(range(B)[place.rows(B)])
    with fake_mode():
        blocks = place.shard(port_layout(
            _fakes(model.abstract_params(), dev), model))
        step = make_serve_step(model, kind, mesh, rules)
        if kind == "prefill":
            mine = {k: torch.empty((n, *v.shape[1:]), dtype=v.dtype,
                                   device=dev) for k, v in inputs.items()}
            cache, call = [], (blocks, mine, max_len)
        else:
            mine = torch.empty((n, 1), dtype=torch.int32, device=dev)
            cache = place.init_cache(B, S, dev)
            call = (blocks, mine, cache)
        cost = OpCost(mesh)
        # a StateCache's entries and its `next` (a list subclass is one
        # leaf to the pytree walk)
        cost.track(blocks, mine, list(cache), getattr(cache, "next", None))
        with cost:
            step(*call)
    return cost, state_bytes(blocks), state_bytes(cache), state_bytes(mine)


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def cost_row(cost: OpCost, mesh, arch: str, shape: str, kind: str,
             useful: float, args: int, dt: float) -> dict:
    """An ``ok`` row of a cell that ran: its roofline row (`roofline.Roofline`)
    with the rank's argument, peak and temporary bytes, whether the peak
    fits the card, its ops, collectives and kernel launches."""
    roof = rl.analyze(cost, mesh_shape=dict(mesh.shape), arch=arch,
                      shape=shape, mesh_name=_mesh_name("pod" in mesh.shape),
                      model_flops=useful)
    row = roof.row()
    row.update({
        "status": "ok", "kind": kind, "trace_s": round(dt, 1),
        "arg_bytes_per_device": args,
        "peak_bytes_per_device": cost.peak,
        "temp_bytes_per_device": cost.peak - args,
        "fits": cost.peak <= rl.HBM_BYTES,
        "ops": cost.ops,
        "collectives": {k: list(v) for k, v in
                        cost.collective_rows().items()},
        "launches": {k: v[0] for k, v in cost.launches.items()},
    })
    return row


def run_cell(arch_id: str, shape: str, multi_pod: bool,
             verbose: bool = True) -> dict:
    """One cell on its production mesh: a row dict (``status`` "ok",
    "skip" for the arch's `SKIPS`, or "fail" with its ``error``)."""
    mesh_name = _mesh_name(multi_pod)
    arch_mod = get_arch(arch_id)
    kind, S, B = SHAPES[shape]
    base = {"arch": arch_id, "shape": shape, "mesh": mesh_name,
            "kind": kind}
    spec = arch_mod.input_specs(shape, multi_pod=multi_pod)
    if spec is None:
        reason = arch_mod.SKIPS.get(shape, "n/a")
        if verbose:
            print(f"SKIP  {arch_id:24s} {shape:12s} {mesh_name}: {reason}")
        return {**base, "status": "skip", "reason": reason}
    model = build_model(arch_mod.CONFIG)
    shape_mesh = make_production_mesh(multi_pod=multi_pod)
    mesh = fake_world(shape_mesh.size, multi_pod=multi_pod)
    rules = MULTI_POD_RULES if multi_pod else SINGLE_POD_RULES
    t0 = time.perf_counter()
    if kind == "train":
        cost, state_b, batch_b = train_cell(model, mesh, rules,
                                            spec.args["batch"], TrainConfig())
        cache_b = 0
    else:
        cost, state_b, cache_b, batch_b = serve_cell(
            model, mesh, rules, kind, spec.args.get("batch"), S, B)
    dt = time.perf_counter() - t0
    args = state_b + cache_b + batch_b
    row = cost_row(cost, mesh, arch_id, shape, kind,
                   useful_flops(model, kind, S, B), args, dt)
    row["state_bytes_per_device"] = state_b
    if kind != "train":
        row["cache_bytes_per_device"] = cache_b
    if verbose:
        print(f"OK    {arch_id:24s} {shape:12s} {mesh_name} kind={kind:7s} "
              f"trace={dt:6.1f}s "
              f"peak/dev={cost.peak / 2**30:6.2f}GiB "
              f"arg/dev={args / 2**30:6.2f}GiB "
              + (f"cache/dev={cache_b / 1e9:6.3f}GB " if kind != "train"
                 else "") +
              f"temp/dev={row['temp_bytes_per_device'] / 2**30:6.2f}GiB "
              f"fits={'yes' if row['fits'] else 'NO'} "
              f"dominant={row['dominant']:10s} "
              f"roofline={row['roofline_fraction']:.3f}")
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--json", default=None, help="append JSONL results here")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)

    archs = ARCH_IDS if (args.all or not args.arch) else [
        args.arch.replace("-", "_").replace(".", "_")]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results, failures = [], 0
    for mp in meshes:           # one world a mesh
        for arch in archs:
            for shape in shapes:
                try:
                    row = run_cell(arch, shape, mp)
                except Exception as e:
                    traceback.print_exc()
                    row = {"arch": arch, "shape": shape,
                           "mesh": _mesh_name(mp), "kind": SHAPES[shape][0],
                           "status": "fail", "error": repr(e)}
                failures += row["status"] == "fail"
                results.append(row)
                if args.json:
                    with open(args.json, "a") as f:
                        f.write(json.dumps(row) + "\n")
    ok = sum(r["status"] == "ok" for r in results)
    sk = sum(r["status"] == "skip" for r in results)
    print(f"\n=== dry-run: {ok} ok, {sk} skip, {failures} FAIL ===")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
