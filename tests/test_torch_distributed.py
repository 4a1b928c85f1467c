"""Parity of the port's distributed layer (`repro_torch.core.distributed`,
`core.mesh` and `launch.mesh`, the ``mesh=`` routes of the batch decode,
the decoder and the alignment head, `checkpointing.reshard`) with the JAX
package, on the CPU.

One gloo world of 8 CPU processes (the (4, 2) test mesh, file rendezvous)
runs every sharded decode once per file and returns its results; JAX's side
runs at the same time in its own subprocess with 8 virtual host devices, as
tests/test_distributed.py does, on the same numpy inputs.  Tolerances: the
2-D decoder's score on the Erdos-Renyi model is held to `viterbi_numpy`
within the JAX test's 1e-3 relative error (its path exactly); everything
else is bitwise.
"""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import (NEG_INF, FusedSpec, LexiconConstraint,
                              erdos_renyi_hmm, random_emissions,
                              viterbi_decode_batch)
from repro_torch.core import reference
from repro_torch.core.distributed import (make_batched_flash_decoder,
                                          make_flash_viterbi_2d)
from repro_torch.checkpointing import reshard
from repro_torch.core.mesh import Mesh, PartitionSpec as P, ShapeMesh
from repro_torch.launch.mesh import (data_axis_size, make_production_mesh,
                                     make_test_mesh, run_spmd)
from repro_torch.serving import (AlignmentConfig, make_alignment_head,
                                 make_lexicon_align_head)

_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = torch.device("cpu")
K, T = 64, 96
B, TMAX = 8, 40
LENGTHS = np.array([TMAX, 17, 1, 33, TMAX, 9, 25, 2], np.int32)
METHODS = ("vanilla", "flash", "flash_bs", "fused")
TUNABLES = dict(parallelism=8, lanes=None, beam_width=128, chunk=128, bt=8)
LEXICON = tuple(((4 * w, 4 * w + 1, 4 * w + 2),) for w in range(K // 4))


def _tie_heavy_ltr() -> tuple[np.ndarray, np.ndarray]:
    """A left-to-right model whose self-loop, step and skip weights are 1/2,
    1/4 and 1/4: in float32 log(1/4) is exactly 2 log(1/2), so with integer
    emissions many paths score exactly the same."""
    d = np.arange(K)[None, :] - np.arange(K)[:, None]
    log_A = np.where(d == 0, np.log(0.5), np.where((d == 1) | (d == 2),
                                                   np.log(0.25), NEG_INF))
    log_pi = np.full(K, NEG_INF)
    log_pi[0] = 0.0
    return log_pi.astype(np.float32), log_A.astype(np.float32)


def _inputs() -> dict[str, np.ndarray]:
    """Every input of the file, drawn with numpy from one seed."""
    g = np.random.default_rng(3)
    er = erdos_renyi_hmm(g, K, edge_prob=0.4, device=CPU)
    ltr_pi, ltr_A = _tie_heavy_ltr()
    return {
        "er_pi": er.log_pi.numpy(), "er_A": er.log_A.numpy(),
        "er_em": random_emissions(g, T, K, device=CPU).numpy(),
        "ltr_pi": ltr_pi, "ltr_A": ltr_A,
        # emissions in {0, 1} on the tie-heavy model: exact ties everywhere,
        # on this draw also between sources of the two model shards
        "ltr_em": np.random.default_rng(2).integers(0, 2, (T, K)).astype(
            np.float32),
        "batch_em": random_emissions(g, B * TMAX, K, device=CPU).numpy()
        .reshape(B, TMAX, K),
    }


def _world(device, x):
    """One rank of the world of 8: every sharded decode of the file."""
    t = {k: torch.from_numpy(v).to(device) for k, v in x.items()}
    lengths = torch.from_numpy(LENGTHS)
    mesh = make_test_mesh()
    mesh_mp = make_test_mesh(multi_pod=True)
    out = {"mesh": dict(mesh.shape), "mesh_coord": mesh.coord,
           "data_axis_size": data_axis_size(mesh),
           "mesh_mp": dict(mesh_mp.shape),
           "data_axis_size_mp": data_axis_size(mesh_mp)}
    for model in ("er", "ltr"):
        for shard in ("row", "col"):
            dec = make_flash_viterbi_2d(mesh, T, K, shard=shard)
            path, score = dec(t[f"{model}_pi"], t[f"{model}_A"],
                              t[f"{model}_em"])
            out[f"2d_{model}_{shard}"] = (path.numpy(), score.numpy())
    lp, la, em = t["er_pi"], t["er_A"], t["batch_em"]
    for method in METHODS:
        paths, scores = make_batched_flash_decoder(mesh, method=method)(
            lp, la, em, lengths)
        out[f"batched_{method}"] = (paths.numpy(), scores.numpy())
        loop = [viterbi_decode_batch(em[i:i + 1, :int(L)], lp, la,
                                     method=method, **TUNABLES)
                for i, L in enumerate(LENGTHS)]
        out[f"looped_{method}"] = [(p[0].numpy(), s.numpy()) for p, s in loop]
    lex = LexiconConstraint(LEXICON)
    for method in ("flash", "fused"):
        for c in (None, lex):
            tag = f"{method}_{'lex' if c else 'plain'}"
            kw = dict(method=method, constraint=c)
            sharded = viterbi_decode_batch(em, lp, la, lengths, mesh=mesh,
                                           **kw)
            single = viterbi_decode_batch(em, lp, la, lengths, **kw)
            out[f"mesh_{tag}"] = [(a.numpy(), b.numpy())
                                  for a, b in (sharded, single)]
    heads = [make_alignment_head(lp, la, AlignmentConfig(method="flash"),
                                 mesh=m, device=device) for m in (mesh, None)]
    out["head5"] = [tuple(r.numpy() for r in h(em[:5], lengths[:5]))
                    for h in heads]
    heads = [make_lexicon_align_head(lp, la, LEXICON, cfg=FusedSpec(),
                                     mesh=m, device=device)
             for m in (mesh, None)]
    out["lexicon_head5"] = [tuple(r.numpy() for r in h(em[:5], lengths[:5]))
                            for h in heads]
    tree = {"w": torch.arange(8 * 6).reshape(8, 6), "b": [torch.arange(4)],
            "m": torch.arange(16).reshape(4, 4)}
    specs = {"w": P("data", "model"), "b": [P(None)], "m": P(None, "model")}
    out["reshard"] = {k: np.asarray(v[0] if isinstance(v, list) else v)
                      for k, v in reshard(tree, mesh, specs).items()}
    blocks = [None] * dist.get_world_size()
    dist.all_gather_object(blocks, (mesh.coord, out["reshard"]))
    out["reshard_all"] = blocks
    paths = [None] * dist.get_world_size()
    dist.all_gather_object(paths, out["2d_ltr_row"][0].tolist())
    out["2d_ranks_agree"] = all(p == paths[0] for p in paths)
    return out


_JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax.numpy as jnp
from repro.core import viterbi_decode_batch
from repro.core.distributed import make_flash_viterbi_2d
from repro.launch.mesh import make_test_mesh
x = dict(np.load(sys.argv[1]))
T, K = x["ltr_em"].shape
mesh = make_test_mesh()
out = {}
for shard in ("row", "col"):
    dec = make_flash_viterbi_2d(mesh, T, K, shard=shard)
    p, s = dec(jnp.asarray(x["ltr_pi"]), jnp.asarray(x["ltr_A"]),
               jnp.asarray(x["ltr_em"]))
    out[f"2d_ltr_{shard}_path"], out[f"2d_ltr_{shard}_score"] = p, s
for m in sys.argv[3].split(","):
    p, s = viterbi_decode_batch(jnp.asarray(x["batch_em"]), x["er_pi"],
                                x["er_A"], jnp.asarray(x["lengths"]),
                                method=m, parallelism=8, lanes=None,
                                beam_width=128, chunk=128, bt=8)
    out[f"batch_{m}_paths"], out[f"batch_{m}_scores"] = p, s
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


@pytest.fixture(scope="module")
def results():
    x = _inputs()
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(os.path.join(tmp, "in.npz"), lengths=LENGTHS, **x)
        jax_out = os.path.join(tmp, "jax.npz")
        proc = subprocess.Popen(
            [sys.executable, "-c", _JAX_SCRIPT, os.path.join(tmp, "in.npz"),
             jax_out, ",".join(METHODS)],
            env=dict(os.environ, PYTHONPATH=_SRC, JAX_PLATFORMS="cpu"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            world = run_spmd(_world, 8, device="cpu", args=(x,),
                             timeout_s=600)
            _, err = proc.communicate(timeout=900)
        finally:
            proc.kill()
        assert proc.returncode == 0, err[-4000:]
        jax = dict(np.load(jax_out))
    return x, world, jax


def test_mesh_builds(results):
    _, w, _ = results
    assert w["mesh"] == {"data": 4, "model": 2}
    assert w["data_axis_size"] == 4
    assert w["mesh_coord"] == {"data": 0, "model": 0}   # rank 0
    assert w["mesh_mp"] == {"pod": 2, "data": 2, "model": 2}
    assert w["data_axis_size_mp"] == 4


def test_production_mesh_is_a_shape():
    mesh = make_production_mesh()
    assert isinstance(mesh, ShapeMesh) and not isinstance(mesh, Mesh)
    assert mesh.shape == {"data": 16, "model": 16} and mesh.size == 256
    mp = make_production_mesh(multi_pod=True)
    assert mp.shape == {"pod": 2, "data": 16, "model": 16}
    assert data_axis_size(mp) == 32 and data_axis_size(mesh) == 16


@pytest.mark.parametrize("shard", ["row", "col"])
def test_viterbi_2d_exact(results, shard):
    """Erdos-Renyi p = 0.4 at (T, K) = (96, 64): the path equals
    `viterbi_numpy`'s, the score within the JAX test's 1e-3 relative."""
    x, w, _ = results
    npath, nscore = reference.viterbi_numpy(x["er_pi"], x["er_A"], x["er_em"])
    path, score = w[f"2d_er_{shard}"]
    assert np.array_equal(path, npath)
    assert abs(float(score) - nscore) < 1e-3 * abs(nscore)


def test_viterbi_2d_row_col_agree(results):
    _, w, _ = results
    assert np.array_equal(w["2d_er_row"][0], w["2d_er_col"][0])
    assert w["2d_ranks_agree"]


@pytest.mark.parametrize("shard", ["row", "col"])
def test_viterbi_2d_tie_heavy_matches_jax(results, shard):
    """On a left-to-right model with integer emissions (exact ties), each
    layout's path and score are bitwise JAX's 2-D decoder's: the row layout
    keeps the highest tying shard, as `lax.pmax` does."""
    _, w, jax = results
    path, score = w[f"2d_ltr_{shard}"]
    assert np.array_equal(path, jax[f"2d_ltr_{shard}_path"])
    assert score.tobytes() == jax[f"2d_ltr_{shard}_score"].tobytes()
    # the case reaches the tie rule: the layouts' paths differ, not scores
    assert not np.array_equal(w["2d_ltr_row"][0], w["2d_ltr_col"][0])
    assert w["2d_ltr_row"][1] == w["2d_ltr_col"][1]


@pytest.mark.parametrize("method", METHODS)
def test_batched_ragged_bit_identical(results, method):
    """The sharded ragged batch equals the looped unbatched decodes and
    JAX's `viterbi_decode_batch` on the same inputs, bitwise."""
    _, w, jax = results
    paths, scores = w[f"batched_{method}"]
    for i, (p, s) in enumerate(w[f"looped_{method}"]):
        L = int(LENGTHS[i])
        assert np.array_equal(paths[i, :L], p) and scores[i] == s[0]
    assert np.array_equal(paths, jax[f"batch_{method}_paths"])
    assert scores.tobytes() == jax[f"batch_{method}_scores"].tobytes()


@pytest.mark.parametrize("tag", ["flash_plain", "flash_lex", "fused_plain",
                                 "fused_lex"])
def test_sharded_batch_matches_single(results, tag):
    """`viterbi_decode_batch(mesh=)` equals the unsharded call bitwise, also
    under a `LexiconConstraint` (sharded: `constrain_inputs` then the plain
    route; unsharded `fused`: the masked route)."""
    _, w, _ = results
    (ps, ss), (p0, s0) = w[f"mesh_{tag}"]
    assert np.array_equal(ps, p0) and ss.tobytes() == s0.tobytes()


@pytest.mark.parametrize("head", ["head5", "lexicon_head5"])
def test_alignment_head_sharded(results, head):
    """A bucket of 5 on a data axis of 4: padded with dummies, sliced back,
    bitwise the unsharded head (FLASH, and the lexicon head on `fused`)."""
    _, w, _ = results
    (hp, hs), (p0, s0) = w[head]
    assert hp.shape == (5, TMAX) and hs.shape == (5,)
    assert np.array_equal(hp, p0) and hs.tobytes() == s0.tobytes()


def test_reshard_blocks(results):
    """Each rank holds its block: rows of w by data, columns by model."""
    _, w, _ = results
    full_w = np.arange(8 * 6).reshape(8, 6)
    full_m = np.arange(16).reshape(4, 4)
    coords = set()
    for coord, blocks in w["reshard_all"]:
        d, m = coord["data"], coord["model"]
        coords.add((d, m))
        assert np.array_equal(blocks["w"],
                              full_w[2 * d:2 * d + 2, 3 * m:3 * m + 3])
        assert np.array_equal(blocks["b"], np.arange(4))
        assert np.array_equal(blocks["m"], full_m[:, 2 * m:2 * m + 2])
    assert len(coords) == 8


def test_mesh_needs_a_process_group(tmp_path):
    """A mesh of the wrong type raises TypeError; a `Mesh` whose process
    group is gone raises instead of decoding unsharded."""
    em = torch.zeros((2, 3, 4))
    lp, la = torch.zeros(4), torch.zeros((4, 4))
    with pytest.raises(TypeError, match="Mesh"):
        viterbi_decode_batch(em, lp, la, mesh=make_production_mesh())
    with pytest.raises(RuntimeError, match="initialised"):
        Mesh((1,), ("data",))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        mesh = Mesh((1,), ("data",))
    finally:
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="never decodes unsharded"):
        viterbi_decode_batch(em, lp, la, mesh=mesh)
    assert not dist.is_initialized()


def test_run_spmd_raises_when_a_rank_fails():
    with pytest.raises(RuntimeError, match="rank 1 exited"):
        run_spmd(_fail_on_rank_1, 2, device="cpu", timeout_s=120)


def _fail_on_rank_1(device):
    if dist.get_rank() == 1:
        raise ValueError("injected")
    # rank 0 waits in a collective its peer never joins
    dist.barrier()
