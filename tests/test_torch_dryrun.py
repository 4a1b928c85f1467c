"""The dry run (`repro_torch.launch.dryrun`, `dryrun_viterbi`, `op_cost`,
`roofline`, `render_experiments`, `launch.mesh.fake_world`) and the kernel
wrappers' fake branch (`kernels.work`), on the CPU.

A fake world holds the process's one default group, so the cells that need
one run in a spawned process of their own (`_fake_side`); the real 8-rank
step they are held against runs in a gloo world of 8 (`run_spmd`).
Tolerances:
  * exact: `OpCost`'s counts of hand-sized ops (flops, fused and eager
    bytes, collectives, peak) against the arithmetic of its rules;
  * exact: a SMOKE train cell (tinyllama, float32, accum_steps 2, the
    (data 4, model 2) test mesh) on a fake world of 8 against rank 0 of a
    real 8-rank gloo step of the same cell: the collectives' calls and
    bytes by kind and axis, the flops, the fused and eager bytes;
  * tinyllama-1.1b's train_4k at full width on the 16 x 16 fake world:
    ``ok`` (its 4 kv heads do not split over 16 model ranks), the rank's
    state bytes exactly the specs' share (`chip_smoke.spec_share_bytes`'s
    arithmetic), its arguments that and its batch rows;
  * the 2-D FLASH cell (K = 4096, T = 512) ``ok``, its tropical launches
    counted: one a DP step of the initial walk and of each tile layer;
  * every kernel entry's fake branch: its outputs' shapes and dtypes those
    of the plain version on the CPU, one launch charged with
    `kernels.work`'s counts;
  * a decode cell reads ``fail`` with the reason, a `SKIPS` cell ``skip``;
    `render` of a two-row JSONL gives both rows.
"""

import concurrent.futures as cf
import dataclasses
import json
import multiprocessing as mp

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import get_arch
from repro_torch.kernels import beam_stream, ref, tropical, viterbi_dp, work
from repro_torch.launch import dryrun, dryrun_viterbi, render_experiments
from repro_torch.launch.mesh import make_test_mesh, run_spmd
from repro_torch.launch.op_cost import ALLOC_ROUND, OpCost
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.sharding.placement import data_axes, shard_train_state
from repro_torch.sharding.rules import SINGLE_POD_RULES
from repro_torch.train import (TrainConfig, abstract_train_state,
                               init_train_state, train_state_specs)

torch.set_num_threads(1)

#: the SMOKE cell: tinyllama in float32, a global batch of (B, S) as A
#: microbatches on the (data 4, model 2) test mesh
B, S, A = 8, 16, 2
TCFG = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10),
                   accum_steps=A)


def _smoke_cfg():
    return dataclasses.replace(get_arch("tinyllama_1_1b").SMOKE,
                               dtype=torch.float32)


def _smoke_batch_meta() -> dict:
    meta = {"tokens": torch.int32, "labels": torch.int32,
            "mask": torch.float32}
    return {k: torch.empty((B, S), dtype=d, device="meta")
            for k, d in meta.items()}


def _counts(cost) -> dict:
    return {"flops": cost.flops, "fused": cost.fused_bytes,
            "eager": cost.eager_bytes, "coll": cost.collective_rows()}


def _fake_side() -> dict:
    """Every cell that needs a fake world, in this (spawned) process."""
    from repro_torch.launch.mesh import fake_world
    torch.set_num_threads(1)
    out = {}
    mesh = fake_world(8)
    cost, state_b, batch_b = dryrun.train_cell(
        build_model(_smoke_cfg()), mesh, SINGLE_POD_RULES,
        _smoke_batch_meta(), TCFG)
    out["smoke"] = _counts(cost)
    out["train_4k"] = dryrun.run_cell("tinyllama_1_1b", "train_4k", False,
                                      verbose=False)
    mesh = fake_world(256)
    K, T = dryrun_viterbi.FLASH_2D
    cost = dryrun_viterbi.flash_2d_cell(mesh, K, T, "row")
    out["flash_2d"] = {"launches": dict(cost.launches),
                       "coll": cost.collective_rows(), "ops": cost.ops}
    return out


def _real_world(device):
    """Rank 0's `OpCost` of the SMOKE cell's real sharded step."""
    from repro_torch.data.pipeline import shard_rows
    from repro_torch.train import make_train_step
    mesh = make_test_mesh()
    model = build_model(_smoke_cfg())
    state = shard_train_state(
        init_train_state(model, torch.Generator().manual_seed(1),
                         device="cpu"), model, mesh, SINGLE_POD_RULES)
    rows = shard_rows(B, mesh, A, data_axes(SINGLE_POD_RULES, mesh))
    rng = np.random.default_rng(3)
    cfg = _smoke_cfg()
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32),
             "mask": np.ones((B, S), np.float32)}
    mine = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
    step = make_train_step(model, TCFG, mesh=mesh, rules=SINGLE_POD_RULES)
    cost = OpCost(mesh)
    with cost:
        step(state, mine)
    return _counts(cost)


@pytest.fixture(scope="module")
def sides():
    with cf.ProcessPoolExecutor(1, mp_context=mp.get_context("spawn")) as ex:
        fake = ex.submit(_fake_side)
        real = run_spmd(_real_world, 8, device="cpu", timeout_s=300)
        return fake.result(timeout=600), real


# ---------------------------------------------------------------------------
# op_cost on hand-sized ops
# ---------------------------------------------------------------------------

class _StubMesh:
    """The three collective methods of `core.mesh.Mesh` on one rank,
    dispatching no op: each returns the tensor it was made with."""

    def __init__(self, summed, gathered):
        self.summed, self.gathered = summed, gathered

    def axis_size(self, axes):
        return 4

    def all_reduce_sum(self, x, axes, run=None):
        return self.summed

    def all_reduce_max(self, x, axis):
        return self.summed

    def all_gather(self, x, axes, dim=0, run=None):
        return self.gathered


def _rounded(n: int) -> int:
    return -(-n // ALLOC_ROUND) * ALLOC_ROUND


def test_op_cost_counts_hand_sized_ops():
    """Each rule on one op (float32, 4 bytes an element; a (8, 16) 512 B,
    b (16, 4) 256 B): a product (2 m k n flops; inputs and output, fused
    and eager), an add (1 a output element, eager only), a sum (1 an input
    element; fused and eager), a copy of a transpose (no flops; fused and
    eager; the transpose a view, nothing), a cast to bf16 (no flops, eager
    only), a row gather (2x its output fused), a scatter of rows (2x its
    updates and its indices once, fused), an empty allocation (nothing),
    and the stub mesh's collectives (calls, input bytes, ring bytes: 2x
    an all-reduce, a gather's output; input and output in both byte
    counts); the arguments' and the peak's bytes, each storage rounded
    up to 512."""
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    idx = torch.tensor([0, 3, 5])                    # 24 B
    rows = torch.randn(3, 16)                        # 192 B
    mesh = _StubMesh(torch.randn(8, 4), torch.randn(16, 4))
    with OpCost(mesh) as cost:
        assert cost.track(a, b) == _rounded(512) + _rounded(256)
        y = a @ b                                    # 128 B
        z = y + y
        s = z.sum()                                  # 4 B
        t = a.t().contiguous()
        h = a.to(torch.bfloat16)                     # 256 B
        g = a.index_select(0, idx)                   # 192 B
        u = a.index_copy(0, idx, rows)               # 512 B
        e = torch.empty(1000)
        mesh.all_reduce_sum(y, "model")
        mesh.all_gather(y, "data", 0, 2)
    assert cost.flops == 2 * 8 * 16 * 4 + 32 + 32
    assert cost.fused_bytes == ((512 + 256 + 128) + (128 + 4) + (512 + 512)
                                + 2 * 192 + (2 * 192 + 24)
                                + (128 + 128) + (128 + 256))
    assert cost.eager_bytes == ((512 + 256 + 128) + 3 * 128 + (128 + 4)
                                + (512 + 512) + (512 + 256)
                                + (512 + 24 + 192) + (512 + 24 + 192 + 512)
                                + (128 + 128) + (128 + 256))
    assert cost.collective_rows() == {"all_gather over data/2": (1, 128),
                                      "all_reduce_sum over model": (1, 128)}
    assert {k: c[2] for k, c in cost.collectives.items()} == {
        ("all_gather", "data/2"): 256.0, ("all_reduce_sum", "model"): 256.0}
    assert cost.args == _rounded(512) + _rounded(256)
    live = [y, z, s, t, h, g, u, e]
    assert cost.peak == cost.live == cost.args + sum(
        _rounded(x.untyped_storage().nbytes()) for x in live)
    assert "all_gather" not in vars(mesh)


def test_op_cost_flags_a_host_read_of_a_fake_tensor():
    with FakeTensorMode():
        x = torch.empty(3)
        with OpCost():
            with pytest.raises(RuntimeError, match="host read"):
                float(x.sum())


# ---------------------------------------------------------------------------
# the fake world against a real one
# ---------------------------------------------------------------------------

def test_fake_cell_counts_equal_a_real_ranks(sides):
    """The SMOKE cell on a fake world of 8 and rank 0 of a real gloo world
    of 8 running the same step: the same collectives (calls and bytes by
    kind and axis), flops and bytes, exactly."""
    fake, real = sides
    assert fake["smoke"]["coll"] == real["coll"]
    assert any("over model" in k for k in real["coll"])
    for k in ("flops", "fused", "eager"):
        assert fake["smoke"][k] == real[k], k


def test_tinyllama_train_4k_places_and_fits(sides):
    """tinyllama-1.1b at full width, train_4k on 16 x 16: ``ok`` (4 kv
    heads over 16 model ranks, in head groups of 4 ranks); its state
    bytes are the specs' share, its arguments that and its 16 rows of
    4 096 tokens; it fits 80 GB; a gather over the kv heads' runs of 4."""
    fake, _ = sides
    row = fake["train_4k"]
    assert row["status"] == "ok", row
    model = build_model(get_arch("tinyllama_1_1b").CONFIG)
    specs = train_state_specs(model, SINGLE_POD_RULES, 16)

    def share(t, spec):
        if isinstance(t, dict):
            return sum(share(t[k], spec[k]) for k in t)
        n = t.numel() * t.element_size()
        for ax in spec:
            if ax is not None:
                n //= 16
        return n
    want = share(abstract_train_state(model), specs)
    assert row["state_bytes_per_device"] == want
    assert row["arg_bytes_per_device"] == want + 16 * 4096 * (4 + 4 + 4)
    assert row["fits"] and row["peak_bytes_per_device"] > want
    assert row["temp_bytes_per_device"] == (row["peak_bytes_per_device"]
                                            - row["arg_bytes_per_device"])
    assert row["collectives"]["all_gather over model/4"][0] > 0
    assert row["model_flops"] > 0 and row["dominant"] in (
        "compute", "memory", "collective")


def test_flash_2d_cell_counts_its_tropical_launches(sides):
    """The 2-D FLASH decoder at K = 4096, T = 512 on 16 x 16 runs on fake
    tensors: a tropical launch for each DP step (Tp - 1 of the initial
    walk, s - 1 of each tile layer of s = Tp / 16, ..., 2), charged with
    its work; over "model" two max-combines a step and one a layer (the
    tiles' seed rows)."""
    from repro_torch.core.flash import plan_padding
    fake, _ = sides
    got = fake["flash_2d"]
    K, T = dryrun_viterbi.FLASH_2D
    Tp = plan_padding(T, 16)[0]
    layers = []
    s = Tp // 16
    while s >= 2:
        layers.append(s)
        s //= 2
    steps = Tp - 1 + sum(s - 1 for s in layers)
    n, nbytes, ops = got["launches"]["tropical_matmul_batch"]
    assert n == steps
    # at least one task's (1, K / 16) x (K / 16, K) product a step
    assert ops >= steps * 2.0 * K * (K // 16) and nbytes > 0
    assert got["coll"]["all_reduce_max over model"][0] == \
        2 * n + len(layers)


# ---------------------------------------------------------------------------
# the kernel wrappers' fake branch
# ---------------------------------------------------------------------------

def _entries():
    """(entry, call on inputs, inputs) of every kernel entry, small."""
    g = torch.Generator().manual_seed(0)
    K, T, N, Bw = 8, 5, 3, 4
    A = torch.randn(K, K, generator=g)
    em = torch.randn(N, T, K, generator=g)
    d0 = torch.randn(N, K, generator=g)
    lp = torch.randn(K, generator=g)
    pad = torch.zeros(N, T, dtype=torch.bool)
    psi = torch.randint(0, K, (N, T, K), generator=g, dtype=torch.int32)
    sc = torch.randn(N, Bw, generator=g)
    st = torch.randint(0, K, (N, Bw), generator=g, dtype=torch.int32)
    ent = torch.zeros(N, dtype=torch.int64)
    first = torch.tensor([True, False, False])
    ta, tb = torch.randn(2, 3, K, generator=g), torch.randn(2, K, 6,
                                                            generator=g)
    cen = torch.full((T,), 3, dtype=torch.int32)
    starts = torch.full((T,), 1, dtype=torch.int32)
    return [
        ("viterbi_fwd_batch", viterbi_dp.viterbi_forward_batch,
         (A, em, d0)),
        ("viterbi_fwd_batch_masked", viterbi_dp.viterbi_forward_batch_masked,
         (A, em, d0, None, torch.zeros(K, K), torch.zeros(T, K))),
        ("viterbi_banded_fwd",
         lambda *a: viterbi_dp.viterbi_banded_forward(*a, 2),
         (A, lp, em[0], cen, starts)),
        ("viterbi_backtrack_batch", viterbi_dp.viterbi_backtrack_batch,
         (psi, d0)),
        ("beam_step_batch", lambda *a: beam_stream.beam_step_batch(*a, 4),
         (A, em[:, 0], sc, st)),
        ("bs_initial_pass_batch",
         lambda *a: beam_stream.bs_initial_pass_batch(*a, [1, 3], Bw),
         (lp, A, em, pad)),
        ("bs_segment_decode_batch",
         lambda *a: beam_stream.bs_segment_decode_batch(*a, Bw),
         (lp, A, em, pad, ent, ent, first)),
        ("bs_chunk_batch",
         lambda *a: beam_stream.bs_chunk_batch(*a, Bw, 4),
         (lp, A, em, sc, st, first)),
        ("tropical_matmul_batch", tropical.tropical_matmul_batch, (ta, tb)),
    ]


def _shapes(out):
    if isinstance(out, torch.Tensor):
        return [(tuple(out.shape), out.dtype)]
    return [s for o in out if o is not None for s in _shapes(o)]


@pytest.mark.parametrize("entry", [e[0] for e in _entries()])
def test_fake_branch_gives_the_plain_versions_shapes(entry):
    """On fake inputs a wrapper returns empty outputs of the shapes and
    dtypes its plain version returns on the CPU, runs nothing, and charges
    one launch with its work; the launch counter does not count it."""
    name, fn, args = next(e for e in _entries() if e[0] == entry)
    want = _shapes(fn(*args))
    seen = []
    counts = dict(viterbi_dp.launches, **beam_stream.launches,
                  **tropical.launches)
    mode = FakeTensorMode()
    fakes = [None if a is None else mode.from_tensor(a) for a in args]
    with mode, work.listening(lambda *c: seen.append(c)):
        out = fn(*fakes)
    assert _shapes(out) == want
    assert [c[0] for c in seen] == [name]
    assert seen[0][1] > 0 and seen[0][2] > 0
    assert counts == dict(viterbi_dp.launches, **beam_stream.launches,
                          **tropical.launches)


def test_work_counts_match_the_smokes_shapes():
    """`kernels.work` at the smoke's first shapes: the forward at (8, 511,
    512) moves its two (B, T, K) tensors and log_A, 2 K^2 operations a
    real step; a banded window whose starts are known touches fewer log_A
    entries than the most it could."""
    nbytes, ops = work.fwd_work(8, 511, 512, 8 * 511)
    assert nbytes == 4 * (2 * 8 * 511 * 512 + 512 * 512 + 2 * 8 * 512
                          + 8 * 511)
    assert ops == 2.0 * 8 * 511 * 512 * 512
    known = work.banded_work(64, 10, 9, list(range(10)))[0]
    assert known < work.banded_work(64, 10, 9)[0]


# ---------------------------------------------------------------------------
# rows without a world, and the tables
# ---------------------------------------------------------------------------

def test_serving_cells_fail_and_skips_skip():
    """A decode cell reads ``fail`` for want of a sharded serving step, not
    ``skip``; an arch's `SKIPS` cell reads ``skip`` with its reason."""
    row = dryrun.run_cell("tinyllama_1_1b", "decode_32k", False,
                          verbose=False)
    assert (row["status"], row["error"]) == ("fail", dryrun.SERVE_REASON)
    row = dryrun.run_cell("tinyllama_1_1b", "long_500k", True,
                          verbose=False)
    assert row["status"] == "skip"
    assert row["reason"] == get_arch("tinyllama_1_1b").SKIPS["long_500k"]


def test_render_two_rows(sides, tmp_path):
    """`render` of an ``ok`` row and a ``skip`` row: both in the dry-run
    table, the ``ok`` row's useful flops recomputed, and the single-pod
    roofline table holding the ``ok`` row alone."""
    fake, _ = sides
    ok = dict(fake["train_4k"], model_flops=0.0)
    skip = {"arch": "tinyllama_1_1b", "shape": "long_500k",
            "mesh": "16x16", "status": "skip", "reason": "full attention"}
    path = tmp_path / "rows.jsonl"
    path.write_text(json.dumps(ok) + "\n" + json.dumps(skip) + "\n")
    dry, roof, rows = render_experiments.render(str(path))
    assert len(rows) == 2
    assert "| tinyllama_1_1b | train_4k | 16x16 | train |" in dry
    assert "SKIP" in dry and "full attention" in dry
    lines = roof.splitlines()
    assert len(lines) == 3 and "train_4k" in lines[2]
    fixed = next(r for r in rows if r["status"] == "ok")
    assert fixed["model_flops"] == fake["train_4k"]["model_flops"] > 0
