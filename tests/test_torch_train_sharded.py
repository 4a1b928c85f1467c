"""Parity of the port's sharded training (`make_train_step(..., mesh=)`,
`sharding.placement`, `data.pipeline.shard_rows` / `sharded_batch`, MoE's
`global_routing`, the loss's global normaliser, `optim.adamw.
update_regions`, `core.mesh` over a tuple of axes, and Megatron compute
over "model" for every family: the transformer family, dense, MoE and
MLA, Griffin and xLSTM, `sharding.tensor_parallel`)
with the JAX package's SPMD step and with the port's own single-process
step, on the CPU.

One gloo world of 8 CPU processes runs every sharded case of the file once,
on the (data 4, model 2) test mesh under SINGLE_POD_RULES and on the (pod
2, data 2, model 2) one under MULTI_POD_RULES; JAX's side runs at the same
time in its own subprocess with 8 virtual host devices, as
tests/test_distributed.py does: item 5 there (tinyllama SMOKE, the state
placed by `train_state_specs`, 6 steps at lr 5e-3), here in float32 on
numpy inputs, on both meshes; a second JAX subprocess runs each
tensor-parallel case's step (tinyllama, gemma, granite, danube, hubert,
llava, moonshot, deepseek-v2, recurrentgemma at its SMOKE's 5 layers and
at 4 units, xlstm, and tinyllama with ``compress_accum``) from the case's
weights on its batch, SPMD on both meshes and unsharded.
Tolerances:
  * exact: each rank's block of every leaf (weights, m, v) equals JAX's
    ``addressable_shards`` block on the same mesh position, shape and
    values; each rank's rows of a microbatch equal those JAX's reshape of
    the global batch gives its device; gathering a sharded state gives the
    state back; a rank's bytes at rest equal the specs' share;
  * item 5's 6 losses: finite and falling; the first two within rtol
    1e-5 of JAX's SPMD losses (measured 1.5e-7 and 1.7e-7), all six
    within 1.5x the largest gap between JAX's own SPMD losses and its own
    unsharded run's on the same inputs (measured 8.6e-3; the port's
    largest 8.4e-4).  At lr 5e-3 a step moves nearly every weight by
    +-lr, whose sign a rounding flips where a gradient is near 0, so
    any two faithful runs drift apart from the third step on (JAX's two
    runs differ by 1.7e-5 there, 2.9e-4 at the fourth); rtol 1e-5 on all
    six would fail JAX against itself;
  * item 5's state after its first step (gathered): each moment leaf
    within `ITEM5_BOUNDS` x the leaf's max |value| of JAX's SPMD state,
    each weight within its bound x lr where JAX's m is resolved (above
    1e-3 x its leaf's max) and within 2.05 lr anywhere.  m's and the
    weights' bounds are tests/test_torch_train.py's one-step bounds
    (measured 1.04e-4 and 6.4e-4); v's is 1.5x the measured 2.04e-4,
    which the port's unsharded step also shows against JAX's unsharded
    step on this input (2.05e-4: this cold first step squares a
    gradient that its warm step of tests/test_torch_train.py, bound 1e-4,
    does not);
  * the sharded step against the port's single-process step on the
    global batch (every family's SMOKE in float32, one step at
    accum_steps 2, a random 0.8 mask, so per-rank counts differ; plus
    tinyllama with ``compress_accum`` and recurrentgemma at 4 units, some
    of whose moments' ZeRO-1 axis is the layer axis at data size 4): the
    gaps of `STEP_GAPS` (loss and grad_norm relative, the first moment x max |m|,
    resolved weights x lr), 1.5x the measured, at least 2.4e-7 (two
    float32 ulps), and every weight within 2.05 lr.  Resolved weights lie
    at most one float32 ulp apart (1.19e-4 lr at 1e-3), xLSTM's 3.9e-3 lr
    (its float32 amplification, tests/test_torch_train.py's docstring).
    The tensor-parallel cases' row-parallel sums, vocab-parallel logsumexp,
    the sums of MoE's and MLA's input gradients, the RG-LRU's gate sums
    and the mLSTM's gate and norm sums over "model" order float32
    reductions otherwise than one process does:
    each keeps its bound while compute was replicated (`REPLICATED_GAPS`)
    where that holds, and elsewhere `STEP_GAPS` holds 1.5x JAX's own
    SPMD-vs-unsharded gap on the same weights and batch (`_JAX_TP_SCRIPT`;
    the port's gaps measured 7.3e-7-2.9e-5 in grad_norm and 8.4e-6-4.0e-5
    in the first moment, JAX's 2.0e-6-1.7e-4 and 1.8e-5-2.1e-4; moonshot's
    weights 2.4e-4 lr, JAX's 5.4e-4; with ``compress_accum`` both one int8
    quantum, 7.9e-3; recurrentgemma, whose RG-LRU amplifies float32
    rounding on JAX's init, 2.69e-5, 2.30e-4 and 9.06e-3 lr against JAX's
    7.12e-5, 5.95e-4 and 2.93e-2 lr, at 4 units 1.15e-6, 9.77e-5 and
    1.34e-3 lr against 7.83e-6, 1.94e-4 and 1.35e-3 lr), which
    `test_dense_step_within_jax_spmd_gap` applies to JAX's gaps of the run.
    xLSTM, whose float32 amplification on JAX's init is larger still,
    measured 2.58e-7, 2.86e-4, 1.64e-3 and 2.03e-2 lr against JAX's
    3.44e-7, 5.04e-3, 7.40e-3 and 1.52 lr (where 1.5x JAX's weights gap
    would pass anything below 2.05 lr): its `STEP_GAPS` are 1.5x its own
    gaps, each below 1.5x JAX's;
  * tensor-parallel cases: after the step every leaf no spec shards over
    "model" (the norms; MQA's wk and wv; MoE's router; MLA's wq_a, w_dkv
    and their norms; the RG-LRU's b_rg, b_ig and lam; the mLSTM's b_if,
    the sLSTM's conv and norm) is bitwise the same on the model ranks, and
    no rank gathers over "model" (`count_collectives`), but for xLSTM:
    exactly its sLSTM gate weights (w_gates, r_gates and b_gates, one
    gather of their blocks a forward pass) and its two fused w_up
    products (the exchange, one gather forward and one backward), so
    8 gathers a unit a microbatch (forward, the remat's recomputation,
    backward: 3 + 3 + 2) of the shapes those leaves give;
  * heads that do not split over "model" (`HEAD_CASES`: tinyllama, gemma,
    recurrentgemma, xlstm and llava SMOKE on (data 1, model 8); tinyllama
    and llava, kv 2 over 4, on (data 2, model 4); JAX's SPMD step of each
    in the same JAX subprocess): each rank computes its head group's
    heads.  Each gap lies within the case's `REPLICATED_GAPS` bound or
    1.5x JAX's own SPMD-vs-unsharded gap on that mesh, as the test meshes'
    cases, but for two gaps (`HEAD_ALTERNATIVES`), each held to one named
    alternative: llava's grad_norm on (2, 4) (1.71e-6 against 1.5x JAX's
    9.75e-7 there) within its `STEP_GAPS` bound on the test meshes,
    3.04e-6; xlstm's loss on (1, 8) (1.12e-6 from the float32 step)
    at least as close to the single-process step on float64 weights as
    the float32 single-process step is (2.58e-7 against 1.38e-6: the
    reference's own rounding);
  * MoE: the sharded step drops exactly the assignments the global batch
    drops at the global capacity (some, in every MoE case);
  * averaging the ranks' per-rank means (what the global normaliser
    replaces) misses the loss bound by more than 100x, so the loss test
    can fail.
"""

import dataclasses
import os
import re
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_arch as j_get_arch
from repro.models import build_model as j_build
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.core.mesh import Mesh, ShapeMesh, axes_of
from repro_torch.data.pipeline import (SyntheticTokenPipeline,
                                       TokenPipelineConfig, shard_rows)
from repro_torch.launch.mesh import (count_collectives, make_test_mesh,
                                     run_spmd)
from repro_torch.models import build_model, moe
from repro_torch.models.convert import (jax_pieces, train_state_from_jax,
                                        train_state_to_numpy)
from repro_torch.optim import AdamWConfig
from repro_torch.sharding.placement import (TrainPlacement, data_axes,
                                            gather_train_state,
                                            shard_train_state, state_bytes)
from repro_torch.sharding import tensor_parallel
from repro_torch.sharding.rules import MULTI_POD_RULES, SINGLE_POD_RULES
from repro_torch.train import TrainConfig, init_train_state, make_train_step

torch.set_num_threads(1)

_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = ("single", "multi")
#: item 5's global batch, and the family cases' (two microbatches of 4)
B, S, A = 8, 16, 2
ITEM5_STEPS = 6
ITEM5_OPT = dict(lr=5e-3, warmup_steps=1, total_steps=100)
#: item 5's first step: m, v bounds x the leaf's max |value|, the
#: weights' bound x lr (module docstring)
ITEM5_BOUNDS = (1.4e-4, 3.1e-4, 4.5e-3)
#: the family cases: (arch, compress_accum, layers)
CASES = tuple((a, False, None) for a in ARCH_IDS) + (
    ("tinyllama_1_1b", True, None), ("recurrentgemma_2b", False, 12))
#: the configs that run Megatron compute over "model" (the transformer
#: family: dense, MoE and MLA; Griffin; xLSTM), and their cases
TP_ARCHS = tuple(a for a in ARCH_IDS if tensor_parallel.computes_on_blocks(
    build_model(get_arch(a).SMOKE)))
TP_CASES = tuple(c for c in CASES if c[0] in TP_ARCHS)
#: case -> (loss rel, grad_norm rel, first moment x max |m|, resolved
#: weights x lr): 1.5x the largest measured over both meshes, at least
#: 2.4e-7 (module docstring)
STEP_GAPS = {
    "recurrentgemma_2b": (2.4e-7, 1.06e-4, 8.9e-4, 4.39e-2),
    "deepseek_v2_236b": (2.4e-7, 1.37e-5, 5.69e-5, 1.8e-4),
    "moonshot_v1_16b_a3b": (2.4e-7, 2.59e-4, 3.21e-4, 8.04e-4),
    "tinyllama_1_1b": (2.4e-7, 4.9e-6, 1.09e-4, 6.25e-4),
    "h2o_danube_3_4b": (2.4e-7, 9.53e-5, 2.08e-4, 1.8e-4),
    "granite_8b": (2.4e-7, 3.44e-6, 3.38e-5, 1.8e-4),
    "gemma_2b": (2.4e-7, 7.61e-6, 1.65e-4, 1.43e-3),
    "xlstm_350m": (3.9e-7, 4.3e-4, 2.5e-3, 3.1e-2),
    "hubert_xlarge": (2.4e-7, 3.41e-5, 2.77e-4, 1.8e-4),
    "llava_next_34b": (2.4e-7, 3.04e-6, 2.73e-5, 1.8e-4),
    "tinyllama_1_1b/compress": (2.4e-7, 1.25e-5, 1.18e-2, 1.8e-4),
    "recurrentgemma_2b/12": (2.4e-7, 1.17e-5, 2.9e-4, 2.02e-3),
}
#: the tensor-parallel cases' bounds while compute was replicated over
#: "model"; under Megatron compute each one is kept where it holds, and
#: where it misses, `STEP_GAPS` holds 1.5x JAX's own SPMD-vs-unsharded gap
#: on the same weights and batch (module docstring)
REPLICATED_GAPS = {
    "tinyllama_1_1b": (2.4e-7, 2.4e-7, 9.2e-7, 1.8e-4),
    "h2o_danube_3_4b": (2.4e-7, 2.4e-7, 1.45e-6, 1.8e-4),
    "granite_8b": (2.4e-7, 2.4e-7, 1.7e-6, 1.8e-4),
    "gemma_2b": (2.4e-7, 2.4e-7, 4.2e-7, 3.6e-4),
    "hubert_xlarge": (2.4e-7, 2.4e-7, 4.2e-7, 1.8e-4),
    "llava_next_34b": (2.4e-7, 3.7e-7, 1.6e-6, 1.8e-4),
    "tinyllama_1_1b/compress": (2.4e-7, 2.4e-7, 6.6e-7, 1.8e-4),
    "deepseek_v2_236b": (2.4e-7, 2.4e-7, 1.43e-6, 1.8e-4),
    "moonshot_v1_16b_a3b": (2.4e-7, 2.4e-7, 1.07e-6, 1.8e-4),
    "recurrentgemma_2b": (2.4e-7, 2.4e-7, 6.5e-7, 3.6e-4),
    "recurrentgemma_2b/12": (2.4e-7, 2.4e-7, 6.5e-7, 1.8e-4),
    "xlstm_350m": (2.4e-7, 5.2e-5, 1.45e-4, 5.9e-3),
}


#: the head cases' gaps (mesh, arch, index into loss, grad_norm, first
#: moment, weights) outside both bounds of their yardstick, each with the
#: one alternative it is held to: "step" its `STEP_GAPS` bound, "float64" no
#: farther from the float64-weights single-process step than the float32
#: one (module docstring)
HEAD_ALTERNATIVES = {("2x4", "llava_next_34b", 1): "step",
                     ("1x8", "xlstm_350m", 0): "float64"}
#: meshes whose "model" axis the heads of some SMOKE configs do not split
#: over (sizes, the name of the mesh in results), under SINGLE_POD_RULES
HEAD_MESHES = {"1x8": (1, 8), "2x4": (2, 4)}
#: the head-group cases: (mesh, arch) of an uncompressed SMOKE case whose
#: heads or kv heads do not split over the mesh's model ranks (tinyllama,
#: llava: 4 heads and 2 kv heads; gemma: 4 MQA heads; recurrentgemma: 4
#: local MQA heads; xlstm: 4 mLSTM heads)
HEAD_CASES = tuple(("1x8", a) for a in (
    "tinyllama_1_1b", "gemma_2b", "recurrentgemma_2b", "xlstm_350m",
    "llava_next_34b")) + (("2x4", "tinyllama_1_1b"),
                          ("2x4", "llava_next_34b"))


def _case_name(arch, compress, layers) -> str:
    return arch + ("/compress" if compress else "") + (
        f"/{layers}" if layers else "")


def _rules(name: str):
    return SINGLE_POD_RULES if name == "single" else MULTI_POD_RULES


def _case_cfg(arch, layers):
    cfg = dataclasses.replace(get_arch(arch).SMOKE, dtype=torch.float32)
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def _case_batch(cfg, seed: int) -> dict:
    """A numpy batch of (B, S) of the config's inputs, labels and a random
    0.8 mask."""
    rng = np.random.default_rng(seed)
    b = {"labels": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32),
         "mask": (rng.random((B, S)) < 0.8).astype(np.float32)}
    if not cfg.embed_inputs and not cfg.num_image_tokens:
        b["embeds"] = rng.standard_normal((B, S, cfg.d_model),
                                          dtype=np.float32)
        return b
    n = cfg.num_image_tokens
    b["tokens"] = rng.integers(0, cfg.vocab, (B, S - n), dtype=np.int32)
    if n:
        b["image_embeds"] = rng.standard_normal((B, n, cfg.d_model),
                                                dtype=np.float32)
    return b


def _case_tcfg(compress: bool) -> TrainConfig:
    return TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=1,
                                       total_steps=10),
                       accum_steps=A, compress_accum=compress)


def _item5_cfg():
    return dataclasses.replace(get_arch("tinyllama_1_1b").SMOKE,
                               dtype=torch.float32)


def _paths(tree, prefix: str = "") -> dict:
    """{JAX keystr path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}['{k}']"))
        return out
    return {prefix: tree}


def _blocks(state: dict, model) -> dict:
    """This rank's block of every leaf of a sharded state in JAX's layout,
    a stacked leaf the stack of the layers it holds, as numpy."""
    def one(x):
        if isinstance(x, list):
            return np.stack([t.numpy() for t in x if t.numel()])
        return x.numpy()
    out = {}
    for name, tree in (("params", state["params"]),
                       ("m", state["opt"]["m"]), ("v", state["opt"]["v"])):
        pieces = jax_pieces(tree, model)
        out.update({f"['{name}']{k}": one(v)
                    for k, v in _paths(pieces).items()})
    return out


def _step_gaps(ours, theirs, metrics, ref_metrics):
    """(loss rel, grad_norm rel, first moment x max |m|, resolved weights
    x lr, all weights x lr) of two train states in JAX's layout (numpy)."""
    loss = abs(metrics["loss"] - ref_metrics["loss"]) / abs(
        ref_metrics["loss"])
    gn = abs(metrics["grad_norm"] - ref_metrics["grad_norm"]) / \
        ref_metrics["grad_norm"]
    om, tm = _paths(ours["opt"]["m"]), _paths(theirs["opt"]["m"])
    mom = max(float(np.abs(om[k] - tm[k]).max()
                    / max(np.abs(tm[k]).max(), 1e-30)) for k in tm)
    lr = ref_metrics["lr"]
    op, tp = _paths(ours["params"]), _paths(theirs["params"])
    w_res = w_all = 0.0
    for k in tp:
        gap = np.abs(op[k] - tp[k]) / lr
        resolved = np.abs(tm[k]) > 1e-3 * np.abs(tm[k]).max()
        w_all = max(w_all, float(gap.max()))
        w_res = max(w_res, float(gap[resolved].max(initial=0.0)))
    return loss, gn, mom, w_res, w_all


class _DropCounter:
    """Counts the MoE assignments `moe.route` drops (rank at or past the
    capacity) while installed."""

    def __init__(self):
        self.dropped, self._route = 0, moe.route

    def __enter__(self):
        def counting(probs, cfg):
            out = self._route(probs, cfg)
            self.dropped += int((out[3] >= out[4]).sum())
            return out
        moe.route = counting
        return self

    def __exit__(self, *exc):
        moe.route = self._route


# ---------------------------------------------------------------------------
# the world of 8
# ---------------------------------------------------------------------------

def _item5(mesh, rules, x):
    """Item 5 on this rank: the placement check (m = the weights, v = 2 x
    them) and the 6 steps from JAX's init."""
    model = build_model(_item5_cfg())
    p = x["item5_params"]
    full = train_state_from_jax({"params": p, "opt": {
        "m": p, "v": jax.tree_util.tree_map(lambda a: 2 * a, p),
        "step": np.int32(0)}}, model, device="cpu")
    placed = shard_train_state(full, model, mesh, rules)
    out = {"blocks": _blocks(placed, model),
           "bytes": state_bytes(placed)}
    back = _paths(train_state_to_numpy(
        gather_train_state(placed, model, mesh, rules), model))
    want = _paths(train_state_to_numpy(full, model))
    out["round_trip"] = back.keys() == want.keys() and all(
        np.array_equal(back[k], want[k]) for k in want)
    state = shard_train_state(train_state_from_jax(
        {"params": p, "opt": {
            "m": jax.tree_util.tree_map(np.zeros_like, p),
            "v": jax.tree_util.tree_map(np.zeros_like, p),
            "step": np.int32(0)}}, model, device="cpu"), model, mesh, rules)
    step = make_train_step(model, TrainConfig(opt=AdamWConfig(**ITEM5_OPT)),
                           mesh=mesh, rules=rules)
    rows = shard_rows(B, mesh, 1, data_axes(rules, mesh))
    batch = {k: torch.from_numpy(v[rows]) for k, v in x["item5_batch"].items()}
    losses = []
    for i in range(ITEM5_STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        if i == 0:
            out["state1"] = train_state_to_numpy(state, model, mesh, rules)
    out["losses"] = losses
    out["released"] = all(t.is_meta for t in model.parameters())
    out["state"] = train_state_to_numpy(state, model, mesh, rules)
    return out


def _case(mesh, rules, x, arch, compress, layers):
    """One sharded step of a family case from the seeded weights; its
    state gathered, metrics, the MoE drops on this rank."""
    cfg = _case_cfg(arch, layers)
    model = build_model(cfg)
    state = init_train_state(model, torch.Generator().manual_seed(1),
                             device="cpu")
    rows = shard_rows(B, mesh, A, data_axes(rules, mesh))
    batch = {k: torch.from_numpy(v[rows])
             for k, v in x[f"batch/{arch}"].items()}
    out = {}
    if (arch, compress, layers) == ("tinyllama_1_1b", False, None):
        # the mean of the ranks' own means, a microbatch's own count each
        mb = len(rows) // A
        micro = [{k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                 for i in range(A)]
        with torch.no_grad():
            local = torch.stack([model.loss(b) for b in micro]).sum()
        axes = data_axes(rules, mesh)
        out["per_rank_mean"] = float(mesh.all_reduce_sum(
            local, axes)) / (A * mesh.axis_size(axes))
        out["mask_counts"] = [float(b["mask"].sum()) for b in micro]
    state = shard_train_state(state, model, mesh, rules)
    out["bytes"] = state_bytes(state)
    step = make_train_step(model, _case_tcfg(compress), mesh=mesh,
                           rules=rules)
    shapes = []                   # the shapes of the gathers over "model"
    gather = mesh.all_gather

    def logged(t, axes, dim=0, **kw):
        if "model" in axes_of(axes):
            shapes.append(tuple(t.shape))
        return gather(t, axes, dim, **kw)
    mesh.all_gather = logged
    with _DropCounter() as drops, count_collectives() as seen:
        state, m = step(state, batch)
    del mesh.all_gather
    out["model_gathers"] = sorted(shapes)
    out["dropped"] = drops.dropped
    data_group = mesh.group(data_axes(rules, mesh))
    gathers = [g for n, g in zip(seen, seen.groups) if n == "all_gather"]
    out["gathers"] = (len(gathers),
                      sum(g is not data_group for g in gathers))
    if arch in TP_ARCHS:
        specs = _paths(TrainPlacement(model, mesh, rules).pspecs)
        out["replicated"] = {
            k: v for k, v in _blocks(state, model).items()
            if "model" not in specs[k[k.index("]") + 1:]]}
    out["metrics"] = {k: float(v) for k, v in m.items()}
    out["state"] = train_state_to_numpy(state, model, mesh, rules)
    return out


def _world(device, x):
    """One rank of the world of 8: every sharded case of the file."""
    out = {}
    for name in MESHES:
        mesh = make_test_mesh(multi_pod=name == "multi")
        rules = _rules(name)
        axes = data_axes(rules, mesh)
        out[f"{name}/coord"] = mesh.coord
        out[f"{name}/index"] = mesh.index(axes)
        out[f"{name}/gathered"] = mesh.all_gather(
            torch.tensor([[dist.get_rank()]]), axes).flatten().tolist()
        out[f"{name}/sum"] = float(mesh.all_reduce_sum(
            torch.tensor([float(dist.get_rank())]), axes))
        out[f"{name}/rows"] = shard_rows(B, mesh, A, axes)
        pipe = SyntheticTokenPipeline(TokenPipelineConfig(
            vocab=256, seq_len=S, global_batch=B, seed=3))
        out[f"{name}/pipeline"] = pipe.sharded_batch(2, mesh, A, rules)
        out[f"{name}/item5"] = _item5(mesh, rules, x)
        for case in CASES:
            out[f"{name}/{_case_name(*case)}"] = _case(mesh, rules, x, *case)
    for name, shape in HEAD_MESHES.items():
        mesh = Mesh(shape, ("data", "model"))
        out[f"{name}/coord"] = mesh.coord
        for where, arch in HEAD_CASES:
            if where == name:
                out[f"{name}/{arch}"] = _case(mesh, SINGLE_POD_RULES, x,
                                              arch, False, None)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, out)
    return every


_JAX_HEAD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_arch
from repro.launch.mesh import data_axis_size, make_test_mesh
from repro.models import build_model
from repro.optim import adamw
from repro.sharding.rules import MULTI_POD_RULES, SINGLE_POD_RULES
from repro.train import TrainConfig, make_train_step, train_state_specs
"""

#: item 5 on both meshes, and JAX's unsharded run of it
_JAX_SCRIPT = _JAX_HEAD + r"""
B, A, STEPS = int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5])
lr, warm, total = (float(v) for v in sys.argv[6].split(","))
x = dict(np.load(sys.argv[1]))
cfg = dataclasses.replace(get_arch("tinyllama_1_1b").SMOKE, dtype=jnp.float32)
model = build_model(cfg)
params = model.init(jax.random.key(0))
tcfg = TrainConfig(opt=adamw.AdamWConfig(lr=lr, warmup_steps=int(warm),
                                         total_steps=int(total)))
out = {}
for name, multi, rules in (("single", False, SINGLE_POD_RULES),
                           ("multi", True, MULTI_POD_RULES)):
    mesh = make_test_mesh(multi_pod=multi)
    batch_axes = rules.axis("batch")
    positions = list(np.ndindex(mesh.devices.shape))
    def shards(arr):
        by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
        return [by_dev[mesh.devices[pos]] for pos in positions]
    with mesh:
        specs = train_state_specs(model, rules, data_axis_size(mesh))
        sh = jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s), specs,
                                    is_leaf=lambda s: isinstance(s, P))
        chk = {"params": params, "opt": {
            "m": params, "v": jax.tree_util.tree_map(lambda a: 2 * a, params),
            "step": jnp.int32(0)}}
        placed = jax.tree_util.tree_map(jax.device_put, chk, sh)
        for path, arr in jax.tree_util.tree_flatten_with_path(placed)[0]:
            key = jax.tree_util.keystr(path)
            if "step" in key:
                continue
            key = key.replace("['opt']", "", 1)
            for r, blk in enumerate(shards(arr)):
                out[f"{name}/block/{r}/{key}"] = blk
        micro = jax.jit(lambda b: b.reshape(A, B // A),
                        out_shardings=NamedSharding(mesh, P(None, batch_axes)))
        for r, blk in enumerate(shards(micro(jnp.arange(B)))):
            out[f"{name}/rows/{r}"] = blk.reshape(-1)
        state = jax.tree_util.tree_map(
            jax.device_put, {"params": params, "opt": adamw.init_state(params)},
            sh)
        batch = jax.device_put(
            {k: jnp.asarray(x[k]) for k in ("tokens", "labels", "mask")},
            NamedSharding(mesh, P(batch_axes, None)))
        step = jax.jit(make_train_step(model, tcfg), donate_argnums=0)
        losses = []
        for i in range(STEPS):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            if i == 0:
                for path, arr in jax.tree_util.tree_flatten_with_path(
                        state)[0]:
                    key = jax.tree_util.keystr(path)
                    out[f"{name}/step1/{key}"] = np.asarray(arr)
        out[f"{name}/losses"] = np.asarray(losses)
# JAX's own unsharded run on one device, on the same inputs
step = jax.jit(make_train_step(model, tcfg))
state = {"params": params, "opt": adamw.init_state(params)}
losses = []
for _ in range(STEPS):
    state, m = step(state, {k: jnp.asarray(x[k])
                            for k in ("tokens", "labels", "mask")})
    losses.append(float(m["loss"]))
out["unsharded/losses"] = np.asarray(losses)
np.savez(sys.argv[2], **out)
"""

#: the tensor-parallel cases' yardstick: each one's step, SPMD on both
#: meshes and unsharded, from the case's weights on the case's batch
_JAX_TP_SCRIPT = _JAX_HEAD + r"""
import re
A = int(sys.argv[3])
cases = dict(np.load(sys.argv[1]))
heads = {}
for item in sys.argv[5].split(","):
    mname, arch = item.split(":")
    heads.setdefault(arch, []).append(mname)
out = {}
def nest(flat):
    tree = {}
    for path, v in flat.items():
        keys = re.findall(r"\['([^']*)'\]", path)
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = jnp.asarray(v)
    return tree
def keep(prefix, state, metrics):
    for path, arr in jax.tree_util.tree_flatten_with_path(state)[0]:
        out[f"{prefix}/state/{jax.tree_util.keystr(path)}"] = np.asarray(arr)
    for k, v in metrics.items():
        out[f"{prefix}/metric/{k}"] = np.asarray(v)
for case in sys.argv[4].split(","):
    arch, compress, layers = case.split(":")
    jcfg = dataclasses.replace(get_arch(arch).SMOKE, dtype=jnp.float32)
    if layers:
        jcfg = dataclasses.replace(jcfg, num_layers=int(layers))
    jmodel = build_model(jcfg)
    weights = arch + (f"/{layers}" if layers else "")
    name = arch + ("/compress" if compress == "1" else "") + (
        f"/{layers}" if layers else "")
    jparams = nest({k[len(weights) + 7:]: v for k, v in cases.items()
                    if k.startswith(weights + "/params[")})
    step = jax.jit(make_train_step(jmodel, TrainConfig(
        opt=adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10),
        accum_steps=A, compress_accum=compress == "1")))
    cb = {k.split("/", 2)[2]: v for k, v in cases.items()
          if k.startswith(arch + "/batch/")}
    keep(f"dense/{name}/unsharded", *step(
        {"params": jparams, "opt": adamw.init_state(jparams)},
        {k: jnp.asarray(v) for k, v in cb.items()}))
    for mname, multi, rules in (("single", False, SINGLE_POD_RULES),
                                ("multi", True, MULTI_POD_RULES)):
        mesh = make_test_mesh(multi_pod=multi)
        with mesh:
            specs = train_state_specs(jmodel, rules, data_axis_size(mesh))
            sh = jax.tree_util.tree_map(
                lambda s: NamedSharding(mesh, s), specs,
                is_leaf=lambda s: isinstance(s, P))
            state = jax.tree_util.tree_map(
                jax.device_put,
                {"params": jparams, "opt": adamw.init_state(jparams)}, sh)
            batch = jax.device_put(
                {k: jnp.asarray(v) for k, v in cb.items()},
                NamedSharding(mesh, P(rules.axis("batch"))))
            keep(f"dense/{name}/{mname}", *step(state, batch))
    for mname in heads.get(name, ()):
        shape = tuple(int(n) for n in mname.split("x"))
        mesh = jax.sharding.Mesh(np.asarray(jax.devices()).reshape(shape),
                                 ("data", "model"))
        rules = SINGLE_POD_RULES
        with mesh:
            specs = train_state_specs(jmodel, rules, data_axis_size(mesh))
            sh = jax.tree_util.tree_map(
                lambda s: NamedSharding(mesh, s), specs,
                is_leaf=lambda s: isinstance(s, P))
            state = jax.tree_util.tree_map(
                jax.device_put,
                {"params": jparams, "opt": adamw.init_state(jparams)}, sh)
            batch = jax.device_put(
                {k: jnp.asarray(v) for k, v in cb.items()},
                NamedSharding(mesh, P(rules.axis("batch"))))
            keep(f"dense/{name}/{mname}", *step(state, batch))
np.savez(sys.argv[2], **out)
"""


def _jax(script, *args):
    """A JAX subprocess running `script` on `args` (CPU, 8 devices)."""
    return subprocess.Popen(
        [sys.executable, "-c", script, *map(str, args)],
        env=dict(os.environ, PYTHONPATH=_SRC, JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def run_all():
    """(inputs, every rank's results, JAX's, the single-process
    references)."""
    jcfg = dataclasses.replace(j_get_arch("tinyllama_1_1b").SMOKE,
                               dtype=jax.numpy.float32)
    params = jax.tree_util.tree_map(
        np.asarray, j_build(jcfg).init(jax.random.key(0)))
    rng = np.random.default_rng(5)
    item5_batch = {
        "tokens": rng.integers(0, jcfg.vocab, (B, S), dtype=np.int32),
        "labels": rng.integers(0, jcfg.vocab, (B, S), dtype=np.int32),
        "mask": np.ones((B, S), np.float32)}
    x = {"item5_params": params, "item5_batch": item5_batch}
    dense = {}
    for i, arch in enumerate(ARCH_IDS):
        x[f"batch/{arch}"] = _case_batch(_case_cfg(arch, None), 10 + i)
        if arch in TP_ARCHS:
            dense.update({f"{arch}/batch/{k}": v
                          for k, v in x[f"batch/{arch}"].items()})
    for arch, compress, layers in TP_CASES:
        if compress:          # the weights of the case without compression
            continue
        model = build_model(_case_cfg(arch, layers))
        init = init_train_state(model, torch.Generator().manual_seed(1),
                                device="cpu")
        name = _case_name(arch, compress, layers)
        dense.update({f"{name}/params{k}": v for k, v in _paths(
            train_state_to_numpy(init, model)["params"]).items()})
    with tempfile.TemporaryDirectory() as tmp:
        inputs = [os.path.join(tmp, f"{n}.npz") for n in ("in", "dense")]
        outs = [os.path.join(tmp, f"{n}_jax.npz") for n in ("in", "dense")]
        np.savez(inputs[0], **item5_batch)
        np.savez(inputs[1], **dense)
        opt = ",".join(str(ITEM5_OPT[k]) for k in ("lr", "warmup_steps",
                                                   "total_steps"))
        procs = [_jax(_JAX_SCRIPT, inputs[0], outs[0], B, A, ITEM5_STEPS,
                      opt),
                 _jax(_JAX_TP_SCRIPT, inputs[1], outs[1], A, ",".join(
                     f"{arch}:{int(compress)}:{layers or ''}"
                     for arch, compress, layers in TP_CASES), ",".join(
                     f"{m}:{arch}" for m, arch in HEAD_CASES))]
        try:
            world = run_spmd(_world, 8, device="cpu", args=(x,),
                             timeout_s=600)
            errs = [p.communicate(timeout=600)[1] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for p, err in zip(procs, errs):
            assert p.returncode == 0, err[-4000:]
        theirs = {k: v for f in outs for k, v in np.load(f).items()}
    refs = {}
    for case in CASES:
        arch, compress, layers = case
        model = build_model(_case_cfg(arch, layers))
        state = init_train_state(model, torch.Generator().manual_seed(1),
                                 device="cpu")
        step = make_train_step(model, _case_tcfg(compress))
        with _DropCounter() as drops:
            state, m = step(state, {k: torch.from_numpy(v) for k, v in
                                    x[f"batch/{arch}"].items()})
        refs[_case_name(*case)] = (train_state_to_numpy(state, model),
                                   {k: float(v) for k, v in m.items()},
                                   drops.dropped)
    for _, arch in HEAD_CASES:
        refs[f"{arch}/float64"] = _float64_metrics(arch, x[f"batch/{arch}"])
    return x, world, theirs, refs


def _float64_metrics(arch, batch) -> dict:
    """The single-process step's loss and grad_norm on the case's float32
    weights and batch widened to float64 (the products the model casts to
    float32 stay so)."""
    model = build_model(dataclasses.replace(_case_cfg(arch, None),
                                            dtype=torch.float64))
    state = init_train_state(model, torch.Generator().manual_seed(1),
                             device="cpu")
    narrow = init_train_state(build_model(_case_cfg(arch, None)),
                              torch.Generator().manual_seed(1), device="cpu")
    with torch.no_grad():
        for a, b in zip(jax.tree_util.tree_leaves(state["params"]),
                        jax.tree_util.tree_leaves(narrow["params"])):
            a.copy_(b.double())
    wide = {k: torch.from_numpy(v.astype(np.float64) if v.dtype ==
                                np.float32 and k != "mask" else v)
            for k, v in batch.items()}
    _, m = make_train_step(model, _case_tcfg(False))(state, wide)
    return {k: float(m[k]) for k in ("loss", "grad_norm")}


@pytest.fixture(scope="module")
def results():
    return run_all()


# ---------------------------------------------------------------------------
# the mesh, the placement and the rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MESHES)
def test_mesh_collectives_over_the_data_axes(results, name):
    """`Mesh.index`, `all_gather` and `all_reduce_sum` over the batch axes
    ("data", or ("pod", "data") row-major): each rank's index is its
    position over them, the gather lists the group's ranks in that order."""
    _, world, _, _ = results
    for rank, w in enumerate(world):
        c = w[f"{name}/coord"]
        if name == "single":
            assert w[f"{name}/index"] == c["data"]
            group = [d * 2 + c["model"] for d in range(4)]
        else:
            assert w[f"{name}/index"] == c["pod"] * 2 + c["data"]
            group = [p * 4 + d * 2 + c["model"] for p in range(2)
                     for d in range(2)]
        assert rank in group
        assert w[f"{name}/gathered"] == group
        assert w[f"{name}/sum"] == float(sum(group))


@pytest.mark.parametrize("name", MESHES)
def test_blocks_equal_jax_addressable_shards(results, name):
    """Every rank's block of every leaf (the weights; m = the weights and
    v = twice them, to tell the moments' blocks apart) equals JAX's shard
    on the device at the same mesh position: shape and values, exactly."""
    _, world, theirs, _ = results
    for r, w in enumerate(world):
        ours = w[f"{name}/item5"]["blocks"]
        keys = {k.split("/", 3)[3] for k in theirs
                if k.startswith(f"{name}/block/{r}/")}
        assert keys == set(ours)
        for k in keys:
            jb = theirs[f"{name}/block/{r}/{k}"]
            assert ours[k].shape == jb.shape, (r, k)
            assert np.array_equal(ours[k], jb), (r, k)


def _coord_mesh(shape, names, coord) -> ShapeMesh:
    """A mesh shape at one position: blocks cut without a world."""
    mesh = ShapeMesh(shape, names)
    mesh.coord = dict(coord)
    return mesh


def _mesh_shape(name: str):
    """(sizes, axis names) of the test mesh `name`."""
    return (((4, 2), ("data", "model")) if name == "single" else
            ((2, 2, 2), ("pod", "data", "model")))


def _share(mesh, shape, spec, itemsize: int) -> int:
    """Bytes of a leaf's block: its bytes over the ranks its spec shards
    it over."""
    n = int(np.prod(shape)) * itemsize
    for ax in spec:
        if ax is not None:
            n //= mesh.axis_size(ax)
    return n


@pytest.mark.parametrize("name", MESHES)
def test_gather_gives_the_state_back(results, name):
    """Gathering the placed state gives every rank the whole state,
    exactly; a rank holds the specs' share of each leaf and nothing more
    (float32 weights, m and v, and the 4-byte step)."""
    _, world, _, _ = results
    model = build_model(_item5_cfg())
    shapes = _paths(model.abstract_params())
    for w in world:
        assert w[f"{name}/item5"]["round_trip"]
        mesh = _coord_mesh(*_mesh_shape(name), w[f"{name}/coord"])
        place = TrainPlacement(model, mesh, _rules(name))
        ps, ms = _paths(place.pspecs), _paths(place.mspecs)
        want = 4 + sum(_share(mesh, t.shape, ps[k], 4)
                       + 2 * _share(mesh, t.shape, ms[k], 4)
                       for k, t in shapes.items())
        assert w[f"{name}/item5"]["bytes"] == want


@pytest.mark.parametrize("name", MESHES)
def test_rows_equal_jax_microbatch_rows(results, name):
    """`shard_rows` at accum_steps 2: each rank's rows of the global batch
    are the rows JAX's reshape to (A, B / A) puts on its device, in
    microbatch order; `sharded_batch` gives the pipeline's rows so."""
    _, world, theirs, _ = results
    pipe = SyntheticTokenPipeline(TokenPipelineConfig(
        vocab=256, seq_len=S, global_batch=B, seed=3))
    whole = pipe.batch(2)
    for r, w in enumerate(world):
        rows = w[f"{name}/rows"]
        assert np.array_equal(rows, theirs[f"{name}/rows/{r}"])
        for k, v in w[f"{name}/pipeline"].items():
            assert np.array_equal(v, whole[k][rows])


def test_rows_and_axes_refuse_what_does_not_split():
    mesh = ShapeMesh((4, 2), ("data", "model"))
    mesh.coord = {"data": 1, "model": 0}
    assert shard_rows(16, mesh, 2, ("data",)).tolist() == [2, 3, 10, 11]
    with pytest.raises(ValueError, match="does not split"):
        shard_rows(12, mesh, 2, ("data",))
    mp = ShapeMesh((2, 2, 2), ("pod", "data", "model"))
    with pytest.raises(ValueError, match="data-parallel ranks"):
        data_axes(SINGLE_POD_RULES, mp)
    assert data_axes(MULTI_POD_RULES, mp) == ("pod", "data")


# ---------------------------------------------------------------------------
# item 5 against JAX's SPMD step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MESHES)
def test_item5_losses_match_jax(results, name):
    """Item 5's 6 losses: finite, falling; the first two within rtol 1e-5
    of JAX's SPMD losses, all six within 1.5x JAX's own SPMD-to-unsharded
    gap (module docstring); every rank reports the same."""
    _, world, theirs, _ = results
    losses = np.asarray(world[0][f"{name}/item5"]["losses"])
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    spmd = theirs[f"{name}/losses"]
    np.testing.assert_allclose(losses[:2], spmd[:2], rtol=1e-5)
    drift = np.abs(spmd / theirs["unsharded/losses"] - 1).max()
    np.testing.assert_allclose(losses, spmd, rtol=1.5 * drift)
    assert all(w[f"{name}/item5"]["losses"] == losses.tolist()
               for w in world)


@pytest.mark.parametrize("name", MESHES)
def test_item5_state_matches_jax(results, name):
    """The gathered state after item 5's first step within `ITEM5_BOUNDS`
    of JAX's SPMD state (module docstring); between steps the model holds
    no weights."""
    _, world, theirs, _ = results
    m_tol, v_tol, p_tol = ITEM5_BOUNDS
    item5 = world[0][f"{name}/item5"]
    assert all(w[f"{name}/item5"]["released"] for w in world)
    ours = _paths(item5["state1"])
    jax_state = {k.split("/", 2)[2]: v for k, v in theirs.items()
                 if k.startswith(f"{name}/step1/")}
    assert set(ours) == set(jax_state)
    assert ours["['opt']['step']"] == jax_state["['opt']['step']"] == 1
    assert np.isfinite(np.concatenate([
        np.ravel(v) for v in _paths(item5["state"]).values()])).all()
    lr = ITEM5_OPT["lr"]
    for k, b in jax_state.items():
        a = ours[k]
        if k.startswith("['opt']['m']") or k.startswith("['opt']['v']"):
            tol = m_tol if "['m']" in k else v_tol
            assert np.abs(a - b).max() <= tol * np.abs(b).max(), k
        elif k.startswith("['params']"):
            m = jax_state[k.replace("['params']", "['opt']['m']", 1)]
            gap = np.abs(a - b) / lr
            resolved = np.abs(m) > 1e-3 * np.abs(m).max()
            assert gap.max() <= 2.05, k
            assert gap[resolved].max(initial=0.0) <= p_tol, k


# ---------------------------------------------------------------------------
# the sharded step against the port's single-process step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("case", CASES, ids=[_case_name(*c) for c in CASES])
def test_sharded_step_matches_single_process(results, name, case):
    """One step at accum_steps 2 from the same weights on the same global
    batch: the sharded step's gaps to the single-process step's within
    `STEP_GAPS`, every weight within 2.05 lr; lr and the step exact."""
    _, world, _, refs = results
    key = _case_name(*case)
    got = world[0][f"{name}/{key}"]
    ref_state, ref_m, _ = refs[key]
    gaps = _step_gaps(got["state"], ref_state, got["metrics"], ref_m)
    assert got["metrics"]["lr"] == ref_m["lr"]
    assert got["state"]["opt"]["step"] == ref_state["opt"]["step"] == 1
    assert gaps[4] <= 2.05, gaps
    assert all(g <= t for g, t in zip(gaps[:4], STEP_GAPS[key])), gaps


def _jax_run(theirs: dict, prefix: str):
    """(state, metrics) of one JAX run of `_JAX_TP_SCRIPT`, the state a
    nested dict."""
    state, metrics = {}, {}
    for k, v in theirs.items():
        if k.startswith(prefix + "/state/"):
            keys = re.findall(r"\['([^']*)'\]", k)
            node = state
            for name in keys[:-1]:
                node = node.setdefault(name, {})
            node[keys[-1]] = v
        elif k.startswith(prefix + "/metric/"):
            metrics[k.rsplit("/", 1)[1]] = float(v)
    return state, metrics


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("case", TP_CASES,
                         ids=[_case_name(*c) for c in TP_CASES])
def test_dense_step_within_jax_spmd_gap(results, name, case):
    """The yardstick of Megatron compute: JAX's SPMD step on this mesh
    against its unsharded step, on the case's weights and batch, measured
    in this run.  Each of the tensor-parallel step's gaps to the
    single-process step
    lies within the bound it had while compute was replicated, or else
    within 1.5x JAX's gap on that metric (the gaps from which `STEP_GAPS`
    was raised)."""
    _, world, theirs, refs = results
    key = _case_name(*case)
    spmd = _jax_run(theirs, f"dense/{key}/{name}")
    whole = _jax_run(theirs, f"dense/{key}/unsharded")
    assert spmd[1]["lr"] == whole[1]["lr"]
    jax_gaps = _step_gaps(spmd[0], whole[0], spmd[1], whole[1])[:4]
    ref_state, ref_m, _ = refs[key]
    ours = _step_gaps(world[0][f"{name}/{key}"]["state"], ref_state,
                      world[0][f"{name}/{key}"]["metrics"], ref_m)[:4]
    for g, old, j in zip(ours, REPLICATED_GAPS[key], jax_gaps):
        assert g <= old or g <= 1.5 * j, (ours, jax_gaps)


@pytest.mark.parametrize("where,arch", HEAD_CASES,
                         ids=[f"{m}/{a}" for m, a in HEAD_CASES])
def test_head_groups_step_within_jax_spmd_gap(results, where, arch):
    """Heads that do not split over "model" (module docstring's head
    cases, on (data 1, model 8) and (data 2, model 4)): each rank computes
    its head group's heads, replicated on the group's ranks.  One step's
    gaps to the single-process step lie within the case's bound while
    compute was replicated, or else within 1.5x JAX's own SPMD-vs-unsharded
    gap on the same mesh, weights and batch; only the two gaps named in
    `HEAD_ALTERNATIVES` may instead meet its one alternative (module
    docstring).  Every weight within 2.05 lr; lr and the
    step exact; every model rank reports the same loss."""
    _, world, theirs, refs = results
    spmd = _jax_run(theirs, f"dense/{arch}/{where}")
    whole = _jax_run(theirs, f"dense/{arch}/unsharded")
    assert spmd[1]["lr"] == whole[1]["lr"]
    jax_gaps = _step_gaps(spmd[0], whole[0], spmd[1], whole[1])[:4]
    ref_state, ref_m, _ = refs[arch]
    got = world[0][f"{where}/{arch}"]
    ours = _step_gaps(got["state"], ref_state, got["metrics"], ref_m)
    assert got["metrics"]["lr"] == ref_m["lr"]
    assert got["state"]["opt"]["step"] == 1
    assert ours[4] <= 2.05, ours
    wide = refs[f"{arch}/float64"]
    closer = [abs(got["metrics"][k] - wide[k])
              <= abs(ref_m[k] - wide[k]) for k in ("loss", "grad_norm")]
    for i, (g, old, j) in enumerate(zip(ours[:4], REPLICATED_GAPS[arch],
                                        jax_gaps)):
        alt = HEAD_ALTERNATIVES.get((where, arch, i))
        held = (alt == "float64" and closer[i]
                or alt == "step" and g <= STEP_GAPS[arch][i])
        assert g <= old or g <= 1.5 * j or held, (ours, jax_gaps, closer)
    assert len({w[f"{where}/{arch}"]["metrics"]["loss"]
                for w in world}) == 1


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("case", CASES, ids=[_case_name(*c) for c in CASES])
def test_dense_steps_gather_nothing_over_model(results, name, case):
    """`count_collectives` over every rank's step: a tensor-parallel case
    gathers over the data axes (ZeRO-1's rebuild), and none over "model"
    but xLSTM, whose gathers over it are exactly its sLSTM gate weights'
    blocks (w_gates, r_gates, b_gates: (2 d + 1, 4 d / 2), forward and
    the remat) and its fused w_up products' exchange (a row's (1, S,
    2 dp / 2) forward, the remat and backward, the mLSTM's and the
    sLSTM's): 8 a unit a microbatch (module docstring)."""
    _, world, _, _ = results
    cfg = _case_cfg(*case[::2])
    for w in world:
        got = w[f"{name}/{_case_name(*case)}"]
        n, over_model = got["gathers"]
        assert n > 0
        assert over_model == len(got["model_gathers"])
        if case[0] != "xlstm_350m":
            assert over_model == 0, (n, over_model)
            continue
        d, units = cfg.d_model, cfg.num_layers // 2
        dp = 2 * d
        dp_s = (d * 4 // 3 + 127) // 128 * 128
        want = sorted([(2 * d + 1, 4 * d // 2)] * (2 * units * A)
                      + [(1, S, dp)] * (3 * units * A)
                      + [(1, S, dp_s)] * (3 * units * A))
        assert got["model_gathers"] == want


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("case", TP_CASES,
                         ids=[_case_name(*c) for c in TP_CASES])
def test_replicated_leaves_equal_across_model_ranks(results, name, case):
    """After a tensor-parallel step, every leaf that no spec shards over
    "model" (weights, m and v: the norms, MQA's wk and wv, MoE's router,
    MLA's wq_a and w_dkv, the RG-LRU's b_rg, b_ig and lam, the mLSTM's
    b_if, the sLSTM's conv and norm) is bitwise the same on the model
    ranks of each data position."""
    _, world, _, _ = results
    key = _case_name(*case)
    columns = {}
    for w in world:
        where = tuple(v for k, v in w[f"{name}/coord"].items()
                      if k != "model")
        columns.setdefault(where, []).append(w[f"{name}/{key}"]["replicated"])
    for blocks in columns.values():
        assert len(blocks) == 2
        if case[0] == "xlstm_350m":
            for leaf in ("['ln_m']", "['ln_s']", "['m']['b_if']",
                         "['s']['conv_w']", "['s']['conv_b']",
                         "['s']['norm']"):
                for part in ("params", "m", "v"):
                    assert f"['{part}']['units']{leaf}" in blocks[0]
        elif case[0] == "recurrentgemma_2b":
            for leaf in ("['rec1']['ln_mix']", "['rec1']['mix']['b_rg']",
                         "['rec2']['mix']['b_ig']", "['rec1']['mix']['lam']",
                         "['attn']['mix']['wk']", "['attn']['mix']['wv']"):
                for part in ("params", "m", "v"):
                    assert f"['{part}']['units']{leaf}" in blocks[0]
        else:
            assert "['params']['layers']['ln_attn']" in blocks[0]
        if case[0] == "gemma_2b":
            assert "['params']['layers']['attn']['wk']" in blocks[0]
        if case[0] in ("moonshot_v1_16b_a3b", "deepseek_v2_236b"):
            assert "['params']['layers']['moe']['router']" in blocks[0]
        if case[0] == "deepseek_v2_236b":
            assert "['params']['layers']['attn']['w_dkv']" in blocks[0]
        assert blocks[0].keys() == blocks[1].keys()
        for k, v in blocks[0].items():
            assert np.array_equal(v, blocks[1][k]), k


@pytest.mark.parametrize("name", MESHES)
def test_ranks_hold_the_specs_share(results, name):
    """Every rank of every family case holds exactly the specs' share of
    the state (float32 weights, m and v, the 4-byte step): recurrentgemma
    at 4 units holds its conv moments as whole layers, a quarter of them."""
    _, world, _, _ = results
    for case in CASES:
        model = build_model(_case_cfg(case[0], case[2]))
        shapes = _paths(model.abstract_params())
        for w in world:
            mesh = _coord_mesh(*_mesh_shape(name), w[f"{name}/coord"])
            place = TrainPlacement(model, mesh, _rules(name))
            ps, ms = _paths(place.pspecs), _paths(place.mspecs)
            want = 4 + sum(_share(mesh, t.shape, ps[k], 4)
                           + 2 * _share(mesh, t.shape, ms[k], 4)
                           for k, t in shapes.items())
            assert w[f"{name}/{_case_name(*case)}"]["bytes"] == want, case
    assert TrainPlacement(build_model(_case_cfg("recurrentgemma_2b", 12)),
                          mesh, _rules(name)).layer_leaves()


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("arch", ["moonshot_v1_16b_a3b", "deepseek_v2_236b"])
def test_moe_drops_at_the_global_capacity(results, name, arch):
    """The global batch drops assignments at its capacity, and the data
    ranks of one model column together drop exactly those (each layer
    call, its recomputation in backward included)."""
    _, world, _, refs = results
    dropped = refs[arch][2]
    assert dropped > 0
    ranks = [w for w in world if w[f"{name}/coord"]["model"] == 0]
    assert sum(w[f"{name}/{arch}"]["dropped"] for w in ranks) == dropped


@pytest.mark.parametrize("name", MESHES)
def test_averaging_rank_means_misses_the_bound(results, name):
    """With unequal per-rank mask counts, the mean of the ranks' own means
    is not the global loss: it misses the loss bound by over 100x."""
    _, world, _, refs = results
    ref_loss = refs["tinyllama_1_1b"][1]["loss"]
    got = world[0][f"{name}/tinyllama_1_1b"]
    counts = {tuple(w[f"{name}/tinyllama_1_1b"]["mask_counts"])
              for w in world}
    assert len(counts) > 1
    gap = abs(got["per_rank_mean"] - ref_loss) / abs(ref_loss)
    assert gap > 100 * STEP_GAPS["tinyllama_1_1b"][0]
    assert abs(got["metrics"]["loss"] - ref_loss) / abs(ref_loss) <= \
        STEP_GAPS["tinyllama_1_1b"][0]


def test_sharded_step_needs_a_model_axis():
    """The sharded step computes on the blocks over "model", and refuses
    a mesh without that axis before any collective (no gather of the
    whole weights to fall back on)."""
    model = build_model(_case_cfg("xlstm_350m", None))
    with pytest.raises(ValueError, match="needs that axis"):
        make_train_step(model, _case_tcfg(False),
                        mesh=ShapeMesh((8,), ("data",)),
                        rules=SINGLE_POD_RULES)


def test_token_groups_refuse_global_routing():
    """A MoE config routed in token groups is not routed over a data
    group: the layer raises before any collective."""
    cfg = dataclasses.replace(get_arch("moonshot_v1_16b_a3b").SMOKE.moe,
                              num_groups=2)
    with moe.global_routing(object(), ("data",)):
        with pytest.raises(ValueError, match="data group"):
            moe.moe_forward({}, torch.zeros(1, 4, 8), cfg)


# ---------------------------------------------------------------------------
# the specs over every config
# ---------------------------------------------------------------------------

#: (arch, config) -> the leaves whose moments shard the layer axis at data
#: sizes 2 and 4 (none at 16)
LAYER_AXIS_LEAVES = {
    ("recurrentgemma_2b", "CONFIG"): [
        "/units/rec1/mix/conv_w", "/units/rec1/mix/conv_b",
        "/units/rec2/mix/conv_w", "/units/rec2/mix/conv_b"],
    ("xlstm_350m", "CONFIG"): [
        "/units/m/conv_w", "/units/m/conv_b", "/units/m/w_if",
        "/units/m/b_if", "/units/m/norm", "/units/s/b_gates"],
}
#: data size -> the same for the SMOKE configs
SMOKE_LAYER_AXIS_LEAVES = {
    2: {"xlstm_350m": ["/units/m/conv_b", "/units/m/norm",
                       "/units/s/b_gates"]}}


def _coord_meshes(data: int):
    """A (data, 2) mesh shape at each of its positions."""
    for d in range(data):
        for m in range(2):
            yield _coord_mesh((data, 2), ("data", "model"),
                              {"data": d, "model": m})


def _flat_state(np_state: dict) -> dict:
    """{path: array} of a train state in JAX's layout, as `_blocks` names
    its leaves."""
    out = {}
    for name, tree in (("params", np_state["params"]),
                       ("m", np_state["opt"]["m"]),
                       ("v", np_state["opt"]["v"])):
        out.update({f"['{name}']{k}": v for k, v in _paths(tree).items()})
    return out


@pytest.mark.parametrize("data", [2, 4, 16])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_blocks_tile_every_leaf(arch, data):
    """On the (data, 2) mesh: every position's blocks of a SMOKE state
    (weights, and m and v drawn at random), each put where the specs place
    it (along each sharded dimension at the position's row-major index over
    the dimension's axes x the block's extent), cover each element as
    often as the spec replicates it and give the state back exactly; the
    leaves whose ZeRO-1 axis is the layer axis are the listed ones, for
    the full config and the SMOKE."""
    for cfg_name in ("CONFIG", "SMOKE"):
        model = build_model(getattr(get_arch(arch), cfg_name))
        place = TrainPlacement(model, next(_coord_meshes(data)),
                               SINGLE_POD_RULES)
        if cfg_name == "CONFIG":
            want = (LAYER_AXIS_LEAVES.get((arch, cfg_name), [])
                    if data < 16 else [])
        else:
            want = SMOKE_LAYER_AXIS_LEAVES.get(data, {}).get(arch, [])
        assert place.layer_leaves() == want
    model = build_model(dataclasses.replace(get_arch(arch).SMOKE,
                                            dtype=torch.float32))
    state = init_train_state(model, torch.Generator().manual_seed(2),
                             device="cpu")
    g = torch.Generator().manual_seed(3)
    for name in ("m", "v"):
        for t in jax.tree_util.tree_leaves(state["opt"][name]):
            t.copy_(torch.rand(t.shape, generator=g))
    whole = _flat_state(train_state_to_numpy(state, model))
    specs = {f"['params']{k}": v for k, v in _paths(place.pspecs).items()}
    for name in ("m", "v"):
        specs.update({f"['{name}']{k}": v
                      for k, v in _paths(place.mspecs).items()})
    built = {k: np.zeros_like(v) for k, v in whole.items()}
    seen = {k: np.zeros(v.shape, np.int64) for k, v in whole.items()}
    for mesh in _coord_meshes(data):
        blocks = _blocks(TrainPlacement(model, mesh, SINGLE_POD_RULES)
                         .shard(state), model)
        assert blocks.keys() == whole.keys()
        for k, blk in blocks.items():
            spec = tuple(specs[k]) + (None,) * (blk.ndim - len(specs[k]))
            where = tuple(slice(None) if ax is None else slice(
                mesh.index(ax) * n, (mesh.index(ax) + 1) * n)
                for ax, n in zip(spec, blk.shape))
            built[k][where] = blk
            seen[k][where] += 1
    for k, v in whole.items():
        copies = 2 * data // int(np.prod(
            [next(_coord_meshes(data)).axis_size(ax)
             for ax in specs[k] if ax is not None]))
        assert (seen[k] == copies).all(), k
        assert np.array_equal(built[k], v), k
