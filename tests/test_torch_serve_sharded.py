"""Parity of the port's sharded prefill and decode steps
(`launch.steps.make_serve_step`, `sharding.placement.ServePlacement`,
`tensor_parallel.gather_vocab` / `gathered` / `all_max`, the decode paths
of `models.attention` on a rank's heads and MLA's slot-split latent, MoE's
`global_routing` at decode, the recurrent families' steps on a rank's
block of their states) with the port's own single-process steps, on the
CPU, float32, held to the JAX package's own SPMD-vs-unsharded gap.

One gloo world of 8 CPU processes runs every transformer-family SMOKE
(tinyllama, gemma, granite, danube, hubert, llava, moonshot, deepseek-v2),
recurrentgemma's and xLSTM's on the (data 4, model 2) test mesh under
SINGLE_POD_RULES and the (pod 2, data 2, model 2) one under
MULTI_POD_RULES: a prefill of a global batch of (B, S) = (8, 16) with room
for `MAX_LEN` positions, then `STEPS` decode steps fed the single-process
step's greedy tokens (hubert, an encoder: the prefill alone); tinyllama,
llava, recurrentgemma and xLSTM also on the head-group meshes (data 1,
model 8) and (data 2, model 4), where tinyllama's and llava's 2 kv heads
(and on (1, 8) their 4 heads), recurrentgemma's 4 attention heads and
xLSTM's 4 mLSTM heads on (1, 8) do not split; danube, recurrentgemma and
xLSTM with one sequence under long_500k's rules (`serve_rules`: the batch
replicated).  A JAX
subprocess with 8 virtual host devices runs JAX's ``jit(model.prefill)``
and ``jit(model.decode_step)`` on the same weights and inputs, SPMD with
in / out shardings from ``param_specs`` / ``cache_specs`` on each mesh
and unsharded, as tests/test_distributed.py compiles a decode cell.
Tolerances:
  * each step's logits (the rank's rows, gathered whole over "model") and
    the gathered cache after the prefill and after the last step: the
    largest |sharded - single-process| over max |single-process| within
    1.5x JAX's own SPMD-vs-unsharded gap of the same case on the same
    quantity (max over steps), and never below two float32 ulps
    (2.4e-7).  The port's row-parallel sums and MLA's split softmax order
    float32 reductions otherwise than one process does, as XLA's SPMD
    program does (measured: the port 4e-7-5e-6, JAX 1e-6-2e-5 (my CPU
    runs); the recurrent cases, on stacked block matrices rescaled to
    std 1/sqrt(d_in) (`RECURRENT`), the port 1.4e-6-4.2e-6 at 0.67-1.42x
    JAX's own, but one named alternative (`ALTERNATIVES`));
  * exact: the greedy tokens of every step; each rank's cache block has
    the shapes of `ServePlacement.init_cache`, and, where the kv heads
    split over "model", its bytes at rest equal the share of JAX's
    ``cache_specs``; a recurrent family's block holds what the rank
    computes, reckoned from the config: Griffin's rec states on its
    d_rnn / m columns and its MQA ring whole, xLSTM's mLSTM states on its
    head group's heads and conv tail on 2 d / m columns, the sLSTM's
    whole; the gathers over "model" a decode step: one (the logits),
    MLA's also its queries', one a layer, xLSTM's also 3 a unit (the
    mLSTM's and the sLSTM MLP's `fused` exchanges, the sLSTM gates'
    `whole`); MoE drops exactly the assignments the global batch drops
    at the global capacity (prefill and every step); danube's and
    recurrentgemma's rings wrap (the prompt is longer than their SMOKE
    window of 8), deepseek's decode crosses the boundary of rank 0's
    slots.
`make_serve_step` raises for a mesh without "model", for every family.
"""

import dataclasses
import math
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.core.mesh import Mesh, ShapeMesh
from repro_torch.launch.mesh import count_collectives, run_spmd
from repro_torch.launch.steps import build_cell, make_serve_step
from repro_torch.models import build_model, moe
from repro_torch.models.convert import (cache_from_jax, cache_to_numpy,
                                        to_numpy_tree)
from repro_torch.sharding.placement import (ServePlacement, serve_rules,
                                            state_bytes)
from repro_torch.sharding.rules import MULTI_POD_RULES, SINGLE_POD_RULES

torch.set_num_threads(1)

_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
#: the transformer family's SMOKE configs, then the recurrent families'
ARCHS = ("tinyllama_1_1b", "gemma_2b", "granite_8b", "h2o_danube_3_4b",
         "hubert_xlarge", "llava_next_34b", "moonshot_v1_16b_a3b",
         "deepseek_v2_236b", "recurrentgemma_2b", "xlstm_350m")
#: the recurrent families' SMOKE configs.  Their stacked block matrices
#: (the units' layers) are rescaled from JAX's init, std 1/sqrt(units) (1
#: for both SMOKEs), to std 1/sqrt(d_in), as chip_smoke.py's
#: `fan_in_weights` and tests/test_torch_lm.py's xLSTM case do: on JAX's
#: init both SMOKEs amplify float32 rounding through their recurrences
#: (xLSTM's JAX SPMD-vs-unsharded cache gap measured 1.0e-4 on (4, 2),
#: 2.1e-4 on (2, 2, 2), 1.0e-3 on (2, 4) and 2.9e-3 on (1, 8), my CPU
#: run), so the bound would measure that growth, not the placement
RECURRENT = ("recurrentgemma_2b", "xlstm_350m")
#: the global batch, the prompt, the cache's room and the decode steps:
#: MLA's 36 slots split 18 / 18 over model = 2, so that steps 3 and 4
#: (positions 18, 19) land on rank 1's slots
B, S, MAX_LEN, STEPS = 8, 16, 36, 4
#: mesh name -> (shape, axes, rules)
MESHES = {"single": ((4, 2), ("data", "model"), "SINGLE_POD_RULES"),
          "multi": ((2, 2, 2), ("pod", "data", "model"), "MULTI_POD_RULES"),
          "1x8": ((1, 8), ("data", "model"), "SINGLE_POD_RULES"),
          "2x4": ((2, 4), ("data", "model"), "SINGLE_POD_RULES")}
#: (case name, mesh, arch, global batch): the transformer family's, then
#: the recurrent families' (each case's batch is drawn from seed 10 + its
#: index)
CASES = tuple((f"{m}/{a}", m, a, B) for m in ("single", "multi")
              for a in ARCHS if a not in RECURRENT) + tuple(
    (f"{m}/{a}", m, a, B) for m in ("1x8", "2x4")
    for a in ("tinyllama_1_1b", "llava_next_34b")) + (
    ("single/h2o_danube_3_4b/b1", "single", "h2o_danube_3_4b", 1),) + tuple(
    (f"{m}/{a}", m, a, B) for m in MESHES for a in RECURRENT) + tuple(
    (f"single/{a}/b1", "single", a, 1) for a in RECURRENT)
DECODE_CASES = tuple(c for c in CASES if c[2] != "hubert_xlarge")
MOE_CASES = tuple(c[0] for c in CASES if c[2] in ("moonshot_v1_16b_a3b",
                                                  "deepseek_v2_236b"))
#: the cases whose gathered cache is held, where it misses 1.5x JAX's own
#: gap, to being at least as close to the single-process steps on float64
#: weights as the float32 single-process steps are (the reference's own
#: rounding).  recurrentgemma with one sequence: its cache gap measured
#: 1.96e-6 against JAX's 9.8e-7 (2.0x; the recurrent cases' ratios to
#: JAX's lie at 0.67-1.42 otherwise), its gap to float64 1.29e-6 against
#: the float32 single-process steps' 1.36e-6 (my CPU run)
ALTERNATIVES = ("single/recurrentgemma_2b/b1",)
#: JAX subprocesses that share the cases (each compiles its own)
JAX_PROCS = 2
#: two float32 ulps: the least bound of a relative gap
ULPS = 2.4e-7


def _cfg(arch):
    return dataclasses.replace(get_arch(arch).SMOKE, dtype=torch.float32)


def _rules(mesh_name: str, batch: int):
    return serve_rules({"SINGLE_POD_RULES": SINGLE_POD_RULES,
                        "MULTI_POD_RULES": MULTI_POD_RULES}[
                            MESHES[mesh_name][2]], batch)


def _batch(cfg, n: int, seed: int) -> dict:
    """A numpy batch of n rows: tokens (after a VLM's image embeddings,
    S counting both) or an encoder's frame embeddings."""
    rng = np.random.default_rng(seed)
    if not cfg.embed_inputs and not cfg.num_image_tokens:
        return {"embeds": rng.standard_normal((n, S, cfg.d_model),
                                              dtype=np.float32)}
    k = cfg.num_image_tokens
    b = {"tokens": rng.integers(0, cfg.vocab, (n, S - k), dtype=np.int32)}
    if k:
        b["image_embeds"] = rng.standard_normal((n, k, cfg.d_model),
                                                dtype=np.float32)
    return b


def _model(arch):
    """The case's weights from seed 1; a recurrent family's stacked block
    matrices rescaled to std 1/sqrt(d_in) (`RECURRENT`)."""
    model = build_model(_cfg(arch)).init(torch.Generator().manual_seed(1),
                                         device="cpu")
    if arch in RECURRENT:
        stacked = model.blocks[:len(model.blocks)
                               - getattr(model, "n_tail", 0)]
        with torch.no_grad():
            for block in stacked:
                for p in block.parameters():
                    if p.dim() >= 2:
                        p.mul_(math.sqrt(model.n_units / p.shape[-2]))
    return model


class _DropCounter:
    """Counts the MoE assignments `moe.route` drops while installed."""

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


def _cache_np(cache: list, cfg) -> dict:
    """The leaves of a cache in JAX's layout (`convert.cache_to_numpy`:
    stacked layers, a recurrent family's nested states and ``next``), by
    path."""
    return {k: np.array(v) for k, v in
            _paths(cache_to_numpy(cache, cfg)).items()}


def _reference(arch, n: int, seed: int) -> dict:
    """The single-process steps of a case: the batch, each step's logits,
    the greedy tokens, the cache after the prefill and the last step, the
    MoE drops of each step."""
    model = _model(arch)
    cfg = model.cfg
    batch = _batch(cfg, n, seed)
    out = {"batch": batch, "logits": [], "tokens": [], "drops": []}
    with _DropCounter() as d:
        logits, cache = model.prefill(
            {k: torch.from_numpy(v) for k, v in batch.items()},
            None if cfg.encoder_only else MAX_LEN)
    out["logits"].append(logits.numpy())
    out["drops"].append(d.dropped)
    if cfg.encoder_only:
        return out
    out["tree0"] = cache_to_numpy(cache, cfg)
    out["cache0"] = _cache_np(cache, cfg)
    for _ in range(STEPS):
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        out["tokens"].append(tok.numpy())
        with _DropCounter() as d:
            logits, cache = model.decode_step(tok, cache)
        out["logits"].append(logits.numpy())
        out["drops"].append(d.dropped)
    out["cache"] = _cache_np(cache, cfg)
    return out


def _float64_caches(arch, ref: dict) -> dict:
    """The single-process steps of a case on its weights cast to float64,
    fed the float32 steps' tokens: the cache after the prefill and after
    the last step (`ALTERNATIVES`)."""
    model = _model(arch).cast(torch.float64)
    _, cache = model.prefill(
        {k: torch.from_numpy(v) for k, v in ref["batch"].items()}, MAX_LEN)
    out = {"cache0": _cache_np(cache, model.cfg)}
    for tok in ref["tokens"]:
        _, cache = model.decode_step(torch.from_numpy(tok), cache)
    out["cache"] = _cache_np(cache, model.cfg)
    return out


def _gap(ours: dict, theirs: dict) -> float:
    """The largest |ours - theirs| over max |theirs| of like dicts of
    arrays (float leaves; integer leaves must be equal: inf otherwise)."""
    num = den = 0.0
    for k, t in theirs.items():
        o = ours[k]
        if not np.issubdtype(t.dtype, np.floating):
            if not np.array_equal(o, t):
                return float("inf")
            continue
        num = max(num, float(np.abs(o - t).max()))
        den = max(den, float(np.abs(t).max()))
    return num / max(den, 1e-30)


# ---------------------------------------------------------------------------
# the world of 8
# ---------------------------------------------------------------------------

def _case(mesh, rules, arch, n, ref, params) -> dict:
    """One case on this rank: the sharded prefill and decode steps from the
    single-process step's weights, fed its tokens."""
    model = build_model(_cfg(arch))
    cfg = model.cfg
    place = ServePlacement(model, mesh, rules)
    blocks = place.shard(params)
    rows = place.rows(n)
    mine = {k: torch.from_numpy(v[rows]) for k, v in ref["batch"].items()}
    out = {"rows": (rows.start, rows.stop), "coord": mesh.coord,
           "model_index": mesh.index("model"), "logits": [], "drops": [],
           "model_gathers": []}
    prefill = make_serve_step(model, "prefill", mesh, rules)
    with _DropCounter() as d:
        logits, cache = prefill(blocks, mine,
                                None if cfg.encoder_only else MAX_LEN)
    out["logits"].append(logits.numpy())
    out["drops"].append(d.dropped)
    if cfg.encoder_only:
        return out
    whole = cache_from_jax(ref["tree0"], cfg, device="cpu")
    back = _cache_np(place.gather_cache(place.shard_cache(whole)), cfg)
    out["round_trip"] = back.keys() == ref["cache0"].keys() and all(
        np.array_equal(back[k], v) for k, v in ref["cache0"].items())
    want = place.init_cache(n, MAX_LEN, device="meta")
    out["shapes"] = ([_shapes(c) for c in cache], [_shapes(c) for c in want])
    out["cache_bytes"] = state_bytes(cache)
    out["cache0"] = _cache_np(place.gather_cache(cache), cfg)
    decode = make_serve_step(model, "decode", mesh, rules)
    model_group = mesh.group("model")
    for tok in ref["tokens"]:
        with _DropCounter() as d, count_collectives() as seen:
            logits, cache = decode(blocks, torch.from_numpy(tok[rows]),
                                   cache)
        out["model_gathers"].append(sum(
            name == "all_gather" and g is model_group
            for name, g in zip(seen, seen.groups)))
        out["logits"].append(logits.numpy())
        out["drops"].append(d.dropped)
    out["cache"] = _cache_np(place.gather_cache(cache), cfg)
    return out


def _world(device, refs, params):
    """One rank of the world of 8: every case of the file."""
    out = {}
    meshes = {name: Mesh(shape, axes)
              for name, (shape, axes, _) in MESHES.items()}
    for name, m, arch, n in CASES:
        out[name] = _case(meshes[m], _rules(m, n), arch, n, refs[name],
                          params[arch])
    out["cells"] = {shape: build_cell(get_arch("tinyllama_1_1b"), shape,
                                      meshes["single"]).fn.__name__
                    for shape in ("prefill_32k", "decode_32k")}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, out)
    return every


#: JAX's side: each case's prefill and decode steps, SPMD on its mesh and
#: unsharded, on the same weights and inputs; the gaps of the SPMD run to
#: the unsharded one
_JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, re
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_arch
from repro.models import build_model
from repro.sharding.rules import MULTI_POD_RULES, SINGLE_POD_RULES
x = dict(np.load(sys.argv[1]))
MAX_LEN = int(sys.argv[3])
MESHES = {"single": ((4, 2), ("data", "model"), SINGLE_POD_RULES),
          "multi": ((2, 2, 2), ("pod", "data", "model"), MULTI_POD_RULES),
          "1x8": ((1, 8), ("data", "model"), SINGLE_POD_RULES),
          "2x4": ((2, 4), ("data", "model"), SINGLE_POD_RULES)}
def nest(flat):
    tree = {}
    for path, v in flat.items():
        keys = re.findall(r"\['([^']*)'\]", path)
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = jnp.asarray(v)
    return tree
def tree_of(prefix):
    return {k[len(prefix):]: v for k, v in x.items() if k.startswith(prefix)}
def gap(a, b):
    num = den = 0.0
    for u, v in zip(jax.tree_util.tree_leaves(a),
                    jax.tree_util.tree_leaves(b)):
        u, v = np.asarray(u), np.asarray(v)
        if not np.issubdtype(v.dtype, np.floating):
            continue
        num = max(num, float(np.abs(u - v).max()))
        den = max(den, float(np.abs(v).max()))
    return num / max(den, 1e-30)
UNSHARDED = {}
def run(model, params, batch, tokens, mesh=None, rules=None):
    cfg = model.cfg
    ml = None if cfg.encoder_only else MAX_LEN
    if mesh is None:     # one compile an arch (and batch shape)
        pre, dec = UNSHARDED.setdefault(cfg.name, (
            jax.jit(lambda p, b: model.prefill(p, b, ml)),
            jax.jit(model.decode_step)))
    else:
        def sh(tree):
            return jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s),
                                          tree,
                                          is_leaf=lambda s: isinstance(s, P))
        ba = rules.axis("batch")
        p_sh = sh(model.param_specs(rules))
        b_sh = {k: NamedSharding(mesh, P(ba, *([None] * (v.ndim - 1))))
                for k, v in batch.items()}
        l_sh = NamedSharding(mesh, P(ba, None, None))
        c_sh = None if cfg.encoder_only else sh(model.cache_specs(rules))
        pre = jax.jit(lambda p, b: model.prefill(p, b, ml),
                      in_shardings=(p_sh, b_sh), out_shardings=(l_sh, c_sh))
        dec = jax.jit(model.decode_step,
                      in_shardings=(p_sh, NamedSharding(mesh, P(ba, None)),
                                    c_sh), out_shardings=(l_sh, c_sh))
    logits, cache = pre(params, batch)
    outs, caches = [logits], [cache]
    for t in tokens:
        logits, cache = dec(params, jnp.asarray(t), cache)
        outs.append(logits)
    caches.append(cache)
    return ([np.asarray(o) for o in outs],
            [jax.tree_util.tree_map(np.asarray, c) for c in caches])
out = {}
for case in sys.argv[4].split(","):
    mname, arch = case.split("/")[:2]
    cfg = dataclasses.replace(get_arch(arch).SMOKE, dtype=jnp.float32)
    model = build_model(cfg)
    params = nest(tree_of(arch + "/params"))
    batch = {k: jnp.asarray(v) for k, v in tree_of(case + "/batch/").items()}
    tokens = [x[f"{case}/tokens/{i}"] for i in range(int(sys.argv[5]))
              if f"{case}/tokens/{i}" in x]
    ref, ref_c = run(model, params, batch, tokens)
    shape, axes, rules = MESHES[mname]
    if case.endswith("/b1"):
        rules = dataclasses.replace(rules, rules={**rules.rules,
                                                  "batch": None})
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()).reshape(shape), axes)
    with mesh:
        got, got_c = run(model, params, batch, tokens, mesh, rules)
    out[case + "/logits"] = np.asarray(max(
        float(np.abs(g - r).max() / np.abs(r).max())
        for g, r in zip(got, ref)))
    if not cfg.encoder_only:
        out[case + "/cache"] = np.asarray(max(
            gap(g, r) for g, r in zip(got_c, ref_c)))
np.savez(sys.argv[2], **out)
"""


def _shapes(entry: dict) -> dict:
    """The shape of each leaf of a cache entry, by path."""
    return {k: tuple(v.shape) for k, v in _paths(entry).items()}


def _paths(tree, prefix: str = "") -> dict:
    """{path: leaf} of a nested dict (and list) tree."""
    if isinstance(tree, (dict, list)):
        out = {}
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
            out.update(_paths(v, f"{prefix}[{k!r}]"))
        return out
    return {prefix: tree}


def run_all():
    """(the single-process references by case, every rank's results,
    JAX's gaps by case)."""
    params, refs, jax_in = {}, {}, {}
    for arch in ARCHS:
        model = _model(arch)
        params[arch] = model.tree()
        jax_in.update({f"{arch}/params{k}": v for k, v in
                       _paths(to_numpy_tree(model)).items()})
    for i, (name, _, arch, n) in enumerate(CASES):
        refs[name] = _reference(arch, n, 10 + i)
        if name in ALTERNATIVES:
            refs[name]["float64"] = _float64_caches(arch, refs[name])
        jax_in.update({f"{name}/batch/{k}": v
                       for k, v in refs[name]["batch"].items()})
        jax_in.update({f"{name}/tokens/{j}": t
                       for j, t in enumerate(refs[name]["tokens"])})
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.npz")
        np.savez(src, **jax_in)
        dsts = [os.path.join(tmp, f"out{i}.npz") for i in range(JAX_PROCS)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", _JAX_SCRIPT, src, dst, str(MAX_LEN),
             ",".join(c[0] for c in CASES[i::JAX_PROCS]), str(STEPS)],
            env=dict(os.environ, PYTHONPATH=_SRC, JAX_PLATFORMS="cpu"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for i, dst in enumerate(dsts)]
        try:
            world = run_spmd(_world, 8, device="cpu", args=(refs, params),
                             timeout_s=600)
            errs = [proc.communicate(timeout=600)[1] for proc in procs]
        finally:
            for proc in procs:
                proc.kill()
        for proc, err in zip(procs, errs):
            assert proc.returncode == 0, err[-4000:]
        theirs = {k: float(v) for dst in dsts
                  for k, v in np.load(dst).items()}
    return refs, world, theirs


@pytest.fixture(scope="module")
def results():
    return run_all()


def _ranks(world, name):
    return [w[name] for w in world]


def _rows(ref_logits, r):
    return ref_logits[r["rows"][0]:r["rows"][1]]


# ---------------------------------------------------------------------------
# the steps against the single-process steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_logits_within_jax_spmd_gap(results, case):
    """Every rank's logits of every step (its rows, whole over the
    vocabulary) against the single-process step's: within 1.5x JAX's own
    SPMD-vs-unsharded gap of the case, at least two float32 ulps."""
    refs, world, theirs = results
    ref = refs[case]["logits"]
    gap = max(float(np.abs(got - _rows(want, r)).max() / np.abs(want).max())
              for r in _ranks(world, case)
              for got, want in zip(r["logits"], ref))
    bound = max(1.5 * theirs[case + "/logits"], ULPS)
    assert gap <= bound, (gap, theirs[case + "/logits"])


@pytest.mark.parametrize("case", [c[0] for c in DECODE_CASES])
def test_cache_within_jax_spmd_gap(results, case):
    """The cache gathered from the ranks' blocks after the prefill and
    after the last step against the single-process cache: within 1.5x
    JAX's own SPMD-vs-unsharded cache gap, positions and ``next``
    exact; a case of `ALTERNATIVES` that misses it no farther from the
    float64 single-process steps than the float32 ones are."""
    refs, world, theirs = results
    ref = refs[case]
    bound = max(1.5 * theirs[case + "/cache"], ULPS)
    gap = max(_gap(r[when], ref[when]) for r in _ranks(world, case)
              for when in ("cache0", "cache"))
    if case in ALTERNATIVES and gap > bound:
        f64 = ref["float64"]
        ours = max(_gap(r[when], f64[when]) for r in _ranks(world, case)
                   for when in f64)
        theirs64 = max(_gap(ref[when], f64[when]) for when in f64)
        assert ours <= theirs64, (gap, bound, ours, theirs64)
        return
    assert gap <= bound, (gap, theirs[case + "/cache"])


@pytest.mark.parametrize("case", [c[0] for c in DECODE_CASES])
def test_greedy_tokens_equal(results, case):
    """The greedy token of every row after the prefill and after each
    decode step equals the single-process step's."""
    refs, world, _ = results
    for r in _ranks(world, case):
        for got, want in zip(r["logits"], refs[case]["logits"]):
            assert np.array_equal(got[:, -1].argmax(-1),
                                  _rows(want[:, -1].argmax(-1), r))


def _spec_share(model, mesh_shape: dict, rules, n: int) -> int:
    """A rank's bytes of a decode cache of `n` rows under JAX's
    ``cache_specs`` (its stacked layout): each leaf's bytes over the ranks
    its spec shards it over."""
    cache = model.init_cache(n, MAX_LEN, device="meta")
    specs = model.cache_specs(rules)
    size = ShapeMesh(tuple(mesh_shape.values()), tuple(mesh_shape))
    total = 0
    for name, spec in specs.items():
        nbytes = sum(c[name].numel() * c[name].element_size()
                     for c in cache)
        for ax in spec:
            if ax is not None:
                nbytes //= size.axis_size(ax)
        total += nbytes
    return total


def _recurrent_block(cfg, m: int, n: int) -> list[dict]:
    """A rank's block of a recurrent family's cache among `m` model ranks
    for its `n` rows, reckoned from the config: each entry's leaf shapes
    by path.  Griffin: a rec layer's h and conv tail on d_rnn / m columns,
    an attention layer's ring of min(window, MAX_LEN) slots with MQA's
    one kv head whole; xLSTM: a unit's mLSTM C, n and m on the heads of
    its head group (H / gcd(H, m) of them), its conv tail on 2 d / m
    columns, its sLSTM state and conv tail whole."""
    W = cfg.conv_width - 1
    if cfg.family == "griffin":
        r, C = cfg.d_rnn // m, min(cfg.window, MAX_LEN)
        rec = {"['h']": (n, r), "['conv']": (n, W, r)}
        attn = {"['k']": (n, C, cfg.hd), "['v']": (n, C, cfg.hd),
                "['pos']": (C,), "['next']": ()}
        units, tail = divmod(cfg.num_layers, 3)
        return [rec, rec, attn] * units + [rec] * tail
    d, H = cfg.d_model, cfg.num_heads
    h, hd = H // math.gcd(H, m), 2 * d // H
    unit = {"['m']['rec']['C']": (n, h, hd, hd),
            "['m']['rec']['n']": (n, h, hd), "['m']['rec']['m']": (n, h),
            "['m']['conv']": (n, W, 2 * d // m), "['s']['conv']": (n, W, d)}
    unit.update({f"['s']['rec']['{k}']": (n, d) for k in "cnmh"})
    return [unit] * (cfg.num_layers // 2)


@pytest.mark.parametrize("case", [c[0] for c in DECODE_CASES])
def test_cache_blocks_have_the_placement_shape(results, case):
    """Each rank's cache block after the prefill has the shapes of
    `ServePlacement.init_cache`.  Transformers: where the kv heads split
    over "model" (all but the head-group meshes), its bytes equal the
    share of JAX's ``cache_specs``; with head groups (tinyllama, llava: 2
    kv heads over 4 or 8) a rank holds its group's whole kv head, more
    than JAX's share.  Griffin and xLSTM: the block reckoned from the
    config (`_recurrent_block`: the rec columns, the mLSTM's head group,
    the sLSTM whole), its bytes theirs (float32 here) and ``next``'s,
    less than JAX's share, which splits the states over the batch alone
    (the whole cache of the rank's rows)."""
    _, world, _ = results
    _, m, arch, n = next(c for c in CASES if c[0] == case)
    shape, axes, _ = MESHES[m]
    model = build_model(_cfg(arch))
    mesh = dict(zip(axes, shape))
    rules = _rules(m, n)
    for r in _ranks(world, case):
        got, want = r["shapes"]
        assert got == want
        if arch in RECURRENT:
            rows = r["rows"][1] - r["rows"][0]
            block = _recurrent_block(model.cfg, mesh["model"], rows)
            assert got == block
            assert r["cache_bytes"] == 4 + 4 * sum(
                math.prod(v) for e in block for v in e.values())
            assert r["cache_bytes"] < state_bytes(
                model.init_cache(rows, MAX_LEN, device="meta"))
        elif m in ("single", "multi"):
            assert r["cache_bytes"] == _spec_share(model, mesh, rules, n)
        else:
            assert r["cache_bytes"] > _spec_share(model, mesh, rules, n)


@pytest.mark.parametrize("case", [c[0] for c in DECODE_CASES])
def test_cache_blocks_gather_back_to_the_cache(results, case):
    """Each rank's block of the single-process prefill's cache
    (`ServePlacement.shard_cache`), gathered over the ranks
    (`gather_cache`), is that cache exactly."""
    _, world, _ = results
    assert all(r["round_trip"] for r in _ranks(world, case))


@pytest.mark.parametrize("arch", ["granite_8b", "gemma_2b",
                                  "deepseek_v2_236b", "recurrentgemma_2b",
                                  "xlstm_350m"])
@pytest.mark.parametrize("coord", [(0, 1), (1, 0)])
def test_draw_gives_the_blocks_of_the_seeded_weights(arch, coord):
    """`ServePlacement.draw`, which draws the layout leaf by leaf and keeps
    the rank's blocks, gives bitwise the blocks that `shard` cuts from the
    whole weights `init` draws from the same seed."""
    mesh = ShapeMesh((2, 2), ("data", "model"))
    mesh.coord = dict(zip(("data", "model"), coord))
    cfg = get_arch(arch).SMOKE
    whole = build_model(cfg).init(torch.Generator().manual_seed(3),
                                  device="cpu")
    place = ServePlacement(build_model(cfg), mesh, SINGLE_POD_RULES)
    want = place.shard(whole.tree())
    got = place.draw(torch.Generator().manual_seed(3), "cpu")
    w, g = _paths(want), _paths(got)
    assert w.keys() == g.keys()
    assert all(torch.equal(w[k], g[k]) for k in w)


@pytest.mark.parametrize("case", [c[0] for c in DECODE_CASES
                                  if c[1] in ("single", "multi")])
def test_one_gather_over_model_a_step(results, case):
    """A decode step gathers over "model" once, the logits' vocab columns
    (`count_collectives`); MLA also gathers its absorbed queries, once a
    layer; xLSTM also 3 a unit: the mLSTM's w_up and the sLSTM MLP's w_up
    exchanged (`tensor_parallel.fused`) and the sLSTM's gate weights
    gathered whole (`tensor_parallel.whole`).  Griffin gathers nothing
    else: its RG-LRU gates sum over "model" (`row_products`)."""
    _, world, _ = results
    cfg = _cfg(next(c[2] for c in CASES if c[0] == case))
    want = 1 + (cfg.num_layers if cfg.mla else 0) + (
        3 * (cfg.num_layers // 2) if cfg.family == "xlstm" else 0)
    for r in _ranks(world, case):
        assert r["model_gathers"] == [want] * STEPS


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_drops_what_the_global_batch_drops(results, case):
    """The ranks of one model index together drop, at the prefill and at
    every decode step, exactly the assignments that the single-process
    step drops over the global batch at the global capacity (some at the
    prefill and at a step)."""
    refs, world, _ = results
    want = refs[case]["drops"]
    got = np.sum([r["drops"] for r in _ranks(world, case)
                  if r["model_index"] == 0], axis=0).tolist()
    assert got == want and want[0] > 0 and max(want[1:]) > 0


def test_danube_ring_wraps_and_deepseek_crosses_a_slot_boundary(results):
    """The cases reach what they are for: danube's prompt is longer than
    its SMOKE window, so its prefill cache is the rolled ring; deepseek's
    decode steps write positions on both ranks' slots (rank 0 holds
    slots 0..17, and the steps write positions 16..19)."""
    refs, world, _ = results
    window = _cfg("h2o_danube_3_4b").window
    assert S > window
    pos = refs["single/h2o_danube_3_4b"]["cache0"]["['pos']"][0]
    assert len(pos) == window and pos[0] != 0 and sorted(pos) == list(
        range(S - window, S))
    for r in _ranks(world, "single/deepseek_v2_236b"):
        got = r["cache"]["['pos']"][0]
        assert got[S:S + STEPS].tolist() == list(range(S, S + STEPS))
    assert S < MAX_LEN // 2 < S + STEPS


def test_recurrentgemma_ring_wraps(results):
    """Griffin's attention ring wraps: the prompt is longer than
    recurrentgemma's SMOKE window, so every attention layer's prefill
    cache is the rolled ring of the last `window` positions, and the
    decode steps overwrite its oldest slots in every rank's gathered
    cache."""
    refs, world, _ = results
    window = _cfg("recurrentgemma_2b").window
    assert S > window
    for case in ("single/recurrentgemma_2b", "1x8/recurrentgemma_2b"):
        for pos in refs[case]["cache0"]["['attn']['pos']"]:
            assert pos[0] != 0 and sorted(pos) == list(range(S - window, S))
        for r in _ranks(world, case):
            for pos in r["cache"]["['attn']['pos']"]:
                assert sorted(pos) == list(range(S + STEPS - window,
                                                 S + STEPS))


def test_one_sequence_replicates_the_batch(results):
    """Under long_500k's rules (``"batch": None``) every rank holds the
    one row, and every rank's logits are the whole batch's (danube,
    recurrentgemma, xLSTM)."""
    _, world, _ = results
    for case in [c[0] for c in CASES if c[3] == 1]:
        for r in _ranks(world, case):
            assert r["rows"] == (0, 1)
            assert all(lg.shape[0] == 1 for lg in r["logits"])


def test_build_cell_takes_the_serve_step_on_a_world(results):
    """On a world's mesh `build_cell`'s prefill and decode cells take the
    sharded serving steps; on a mesh shape the model's own."""
    _, world, _ = results
    for r in world:
        assert r["cells"] == {"prefill_32k": "prefill",
                              "decode_32k": "decode"}
    cell = build_cell(get_arch("tinyllama_1_1b"), "decode_32k",
                      ShapeMesh((16, 16), ("data", "model")))
    assert cell.fn.__name__ == "decode_step"


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "recurrentgemma_2b",
                                  "xlstm_350m"])
def test_serve_step_needs_a_model_axis(arch):
    """Every family's step raises on a mesh without "model" (it never
    falls back to a replicated or single-process step); an encoder has
    no decode step."""
    model = build_model(get_arch(arch).SMOKE)
    for kind in ("prefill", "decode"):
        with pytest.raises(ValueError, match="no such axis"):
            make_serve_step(model, kind, ShapeMesh((8,), ("data",)),
                            SINGLE_POD_RULES)
    with pytest.raises(ValueError, match="no decode step"):
        make_serve_step(build_model(get_arch("hubert_xlarge").SMOKE),
                        "decode", ShapeMesh((4, 2), ("data", "model")),
                        SINGLE_POD_RULES)
