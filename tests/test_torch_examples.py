"""The five Viterbi examples of the port (`examples/torch_*.py`) on the CPU:
each runs with ``--device cpu``, and its decode, handed the JAX example's
model (built as the JAX example builds it), is bitwise the JAX example's
decode; the planner's choices equal JAX's `plan`.

Tolerance: paths bitwise equal, scores equal as float32.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BandConstraint as JBand
from repro.core import FusedSpec as JFused
from repro.core import OnlineSpec as JOnline
from repro.core import ResourceBudget as JBudget
from repro.core import SPEC_BY_METHOD as JSPECS
from repro.core import ViterbiDecoder as JDecoder
from repro.core import constrain_inputs as j_constrain
from repro.core import erdos_renyi_hmm as j_er
from repro.core import plan as j_plan
from repro.core import random_emissions as j_rand
from repro.core import sample_observations as j_sample
from repro.core import viterbi_decode_batch as j_batch
from repro.core import viterbi_vanilla as j_vanilla
from repro.serving import StreamConfig as JStreamConfig
from repro.serving import StreamMux as JStreamMux
from repro_torch.core import BandConstraint, ResourceBudget, plan

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def load(name: str):
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def jax_spec(spec):
    fields = {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)
              if f.name != "constraint"}
    return JSPECS[spec.method](**fields)


def same(path, score, jpath, jscore) -> bool:
    return (np.array_equal(np.asarray(path), np.asarray(jpath))
            and np.float32(score) == np.float32(jscore))


def test_the_examples_import_no_jax():
    import ast
    for name in ("torch_quickstart", "torch_batch_decode",
                 "torch_adaptive_edge", "torch_streaming_decode",
                 "torch_map_matching", "torch_train_lm"):
        tree = ast.parse((ROOT / "examples" / f"{name}.py").read_text())
        roots = {a.name.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.Import) for a in n.names}
        roots |= {n.module.split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.level == 0}
        assert "repro_torch" in roots, name
        assert not roots & {"jax", "jaxlib", "repro"}, name


# ---------------------------------------------------------------------------
# quickstart and the planner
# ---------------------------------------------------------------------------

def test_quickstart_decodes_bitwise_the_jax_example():
    ex = load("torch_quickstart")
    K, T = 24, 40
    k_hmm, k_obs = jax.random.split(jax.random.key(0))
    hmm = j_er(k_hmm, K, num_obs=50, edge_prob=0.253)
    _, obs = j_sample(k_obs, hmm, T)
    em = hmm.emissions(obs)
    for spec in ex.SPECS:
        path, score = ex.decode(spec, t(hmm.log_pi), t(hmm.log_A), t(em), CPU)
        jpath, jscore = JDecoder(jax_spec(spec), hmm.log_pi,
                                 hmm.log_A).decode(em)
        assert same(path, score, jpath, jscore), ex.spec_name(spec)


def test_quickstart_runs_on_the_cpu():
    ex = load("torch_quickstart")
    out = ex.main(["--device", "cpu", "--states", "16", "--seq", "24"])
    assert set(out["results"]) == {ex.spec_name(s) for s in ex.SPECS}
    vanilla = out["results"]["VanillaSpec()"]
    for name, (path, score) in out["results"].items():
        assert path.shape == (24,) and path.dtype == np.int32
        if not name.startswith(("FlashBSSpec", "BeamStatic")):
            assert np.array_equal(path, vanilla[0]), name
    assert list(out["plans"]) == list(ex.BUDGETS_KB)


@pytest.mark.parametrize("K,T", [(512, 512), (24, 40)])
def test_planner_choices_equal_jaxs(K, T):
    for kb in (512, 64, 8, 4, 1):
        ours = plan(K, T, ResourceBudget(memory_bytes=kb * 1024))
        theirs = j_plan(K, T, JBudget(memory_bytes=kb * 1024))
        assert jax_spec(ours.spec) == theirs.spec, (K, T, kb)
        assert (ours.why, ours.state_bytes) == (theirs.why,
                                                theirs.state_bytes)


# ---------------------------------------------------------------------------
# batch_decode
# ---------------------------------------------------------------------------

def test_batch_decode_is_bitwise_the_jax_example():
    ex = load("torch_batch_decode")
    K, TMAX, B = ex.K, ex.TMAX, ex.B
    k_hmm, k_em = jax.random.split(jax.random.key(0))
    hmm = j_er(k_hmm, K, edge_prob=0.3)
    em = j_rand(k_em, B * TMAX, K).reshape(B, TMAX, K)
    rng = np.random.default_rng(0)
    lengths = np.sort(rng.integers(1, TMAX + 1, B))[::-1].copy()
    lengths[0] = TMAX
    jpaths, jscores = j_batch(em, hmm.log_pi, hmm.log_A,
                              jnp.asarray(lengths), method="fused")
    pi, A, e = t(hmm.log_pi), t(hmm.log_A), t(em)
    paths, scores = ex.decode_batch(pi, A, e, lengths)
    assert np.array_equal(paths.numpy(), np.asarray(jpaths))
    assert np.array_equal(scores.numpy(), np.asarray(jscores))
    looped = ex.decode_loop(pi, A, e, lengths, CPU)
    for i, L in enumerate(lengths):
        assert same(looped[i][0], looped[i][1], paths[i, :L], scores[i])
    done, stats = ex.serve(pi, A, e, lengths, CPU)
    assert stats["batches"] == 1
    for i, r in enumerate(done):
        assert same(r.result[0], r.result[1], paths[i, :lengths[i]],
                    scores[i])


def test_batch_decode_runs_on_the_cpu():
    out = load("torch_batch_decode").main(["--device", "cpu"])
    assert out["looped_equal"] and out["served_equal"]
    assert out["paths"].dtype == np.int32


# ---------------------------------------------------------------------------
# adaptive_edge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kb", [64, 8, 1])
def test_adaptive_edge_plans_and_decodes_as_jax(kb):
    ex = load("torch_adaptive_edge")
    K, T = 48, 64
    decode_plan = ex.choose(K, T, kb)
    jplan = j_plan(K, T, JBudget(memory_bytes=int(kb * 1024)))
    assert jax_spec(decode_plan.spec) == jplan.spec
    k1, k2 = jax.random.split(jax.random.key(0))
    hmm = j_er(k1, K)
    em = j_rand(k2, T, K)
    path, score = ex.decode(decode_plan.spec, t(hmm.log_pi), t(hmm.log_A),
                            t(em), CPU)
    jpath, jscore = JDecoder(jplan.spec, hmm.log_pi, hmm.log_A).decode(em)
    assert same(path, score, jpath, jscore)


def test_adaptive_edge_runs_on_the_cpu():
    out = load("torch_adaptive_edge").main(
        ["--device", "cpu", "--budget-kb", "2", "--states", "256",
         "--seq", "48"])
    assert out["path"].shape == (48,)
    assert out["plan"].spec.method == "flash_bs"


# ---------------------------------------------------------------------------
# streaming_decode
# ---------------------------------------------------------------------------

def test_streaming_decode_is_bitwise_the_jax_example():
    ex = load("torch_streaming_decode")
    K, T = ex.K, 128
    k_hmm, k_obs = jax.random.split(jax.random.key(0))
    hmm = j_er(k_hmm, K, num_obs=50, edge_prob=0.253)
    _, obs = j_sample(k_obs, hmm, ex.T)
    em = np.asarray(hmm.emissions(obs))[:T]
    pi, A = t(hmm.log_pi), t(hmm.log_A)
    path, score, sess = ex.stream_exact(pi, A, em, CPU,
                                        report=lambda line: None)
    jpath, jscore = j_vanilla(hmm.log_pi, hmm.log_A, jnp.asarray(em))
    assert same(path, score, jpath, jscore)
    (p1, s1), (p2, s2) = ex.mux_two(pi, A, em, CPU)
    assert same(p1, s1, jpath, jscore)
    jmux = JStreamMux(hmm.log_pi, hmm.log_A,
                      JStreamConfig(method="online_beam", beam_width=16,
                                    kchunk=64), blocks=(ex.CHUNK,))
    sid = jmux.open(block=ex.CHUNK)
    for start in range(0, T, ex.CHUNK):
        jmux.feed(sid, em[start:start + ex.CHUNK])
    jp2, js2 = jmux.finish(sid)
    assert same(p2, s2, jp2, js2)


def test_streaming_decode_runs_on_the_cpu():
    out = load("torch_streaming_decode").main(["--device", "cpu"])
    assert np.array_equal(out["path"], out["exact"][0])


# ---------------------------------------------------------------------------
# map_matching: the band, the mask and OnlineSpec(constraint=band)
# ---------------------------------------------------------------------------

def test_map_matching_is_bitwise_the_jax_example():
    ex = load("torch_map_matching")
    _, _, em, _, band = ex.make_model(7, CPU)
    # the JAX example's road-grid model, as it builds it
    pos = np.stack(np.meshgrid(np.arange(ex.G), np.arange(ex.G),
                               indexing="ij"), -1).reshape(ex.K, 2).astype(
        np.float32)
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    jA = jax.nn.log_softmax(jnp.asarray(-0.7 * d2), axis=1)
    jpi = jax.nn.log_softmax(jnp.zeros((ex.K,)))
    jband = JBand(centers=band.centers, width=band.width)
    assert isinstance(band, BandConstraint) and band.width == ex.WIDTH
    jem = jnp.asarray(em.numpy())
    pi, A = t(jpi), t(jA)

    p1, s1 = ex.decode_single(band, pi, A, em[0], CPU)
    jp1, js1 = JDecoder(JFused(constraint=jband), jpi, jA).decode(jem[0])
    assert same(p1, s1, jp1, js1)
    po, so = ex.oracle(band, pi, A, em[0])
    assert same(p1, s1, po, so)
    assert same(po, so, *j_vanilla(*j_constrain(jband, jpi, jA, jem[0])))

    lengths = np.asarray(ex.LENGTHS)
    pb, sb = ex.decode_batch(band, pi, A, em, ex.LENGTHS, CPU)
    jpb, jsb = JDecoder(JFused(constraint=jband), jpi, jA).decode_batch(
        jem, jnp.asarray(lengths))
    for i, L in enumerate(lengths):
        assert same(pb[i, :L], sb[i], np.asarray(jpb)[i, :L], jsb[i])

    p3, s3, committed = ex.decode_stream(band, pi, A, em[0], CPU)
    stream = JDecoder(JOnline(constraint=jband), jpi, jA).make_streaming()
    jcommitted = 0
    for t0 in range(0, ex.T, ex.STREAM_CHUNK):
        jcommitted += len(stream.feed(jem[0, t0:t0 + ex.STREAM_CHUNK]))
    _, js3 = stream.flush()
    assert same(p3, s3, stream.path, js3)
    assert committed == jcommitted


def test_map_matching_runs_on_the_cpu():
    out = load("torch_map_matching").main(["--device", "cpu"])
    assert np.array_equal(out["single"][0], out["stream"][0])


# ---------------------------------------------------------------------------
# the training example
# ---------------------------------------------------------------------------

def test_train_lm_runs_on_the_cpu(tmp_path, monkeypatch):
    """The default mode (tinyllama's SMOKE) for a few steps on the CPU,
    its checkpoints under the working directory's build/."""
    monkeypatch.chdir(tmp_path)
    ex = load("torch_train_lm")
    losses = ex.main(["--device", "cpu", "--steps", "4"])
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert (tmp_path / "build" / "lm_smoke" / "step_4").is_dir()
