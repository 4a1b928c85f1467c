"""Parity of the port's end-to-end forced-alignment step
(`repro_torch.serving.make_e2e_align_step`) with the JAX package's jitted
step on the CPU, and the port's serving example.

The hubert SMOKE encoder's weights are drawn by the JAX package and carried
across with `params_from_jax`; the left-to-right HMM has one state a class
(C = 24) and is carried with `HMM.from_numpy`; the frames are made once with
numpy from a seed.  Tolerances:
  * emissions: in float32 max |diff| <= 1e-5 x max |emission| (the
    encoder's logits differ by ulps grown through its products, see
    test_torch_models.py); in bfloat16 <= 0.08 x max |emission|;
  * the port's decode of JAX's own emissions: paths and scores bitwise
    JAX's ``jax.vmap(spec.run)``, for every spec;
  * the whole step in float32: paths equal, scores within rtol 1e-5.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.configs import get_arch as j_get_arch
from repro.models import build_model as j_build
from repro.serving.alignment import AlignmentConfig as JAlignmentConfig
from repro.serving.alignment import make_e2e_align_step as j_make_step
from repro_torch.configs import get_arch
from repro_torch.core import (HMM, CheckpointSpec, FlashBSSpec, FlashSpec,
                              FusedSpec, OnlineBeamSpec, OnlineSpec,
                              VanillaSpec)
from repro_torch.kernels import launch_counts, reset_launches
from repro_torch.models import build_model, params_from_jax
from repro_torch.serving import AlignmentConfig, make_e2e_align_step

torch.set_num_threads(1)

C, B, S = 24, 3, 16
ROOT = Path(__file__).resolve().parents[1]

#: each port spec beside the JAX spec it is held to: the default FLASH-BS
#: profile, a beam narrower than K, `fused`, exact FLASH, the oracle and a
#: spec with no batched path (decoded row by row, as JAX's vmap does)
SPECS = {
    "flash_bs": (AlignmentConfig(), JAlignmentConfig()),
    "flash_bs_narrow": (FlashBSSpec(beam_width=6, parallelism=4, chunk=8),
                        jcore.FlashBSSpec(beam_width=6, parallelism=4,
                                          chunk=8)),
    "fused": (FusedSpec(), jcore.FusedSpec()),
    "flash": (FlashSpec(parallelism=4), jcore.FlashSpec(parallelism=4)),
    "vanilla": (VanillaSpec(), jcore.VanillaSpec()),
    "checkpoint": (CheckpointSpec(), jcore.CheckpointSpec()),
}


def _setup(dtype: str):
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jcfg = dataclasses.replace(j_get_arch("hubert_xlarge").SMOKE, dtype=jd)
    cfg = dataclasses.replace(get_arch("hubert_xlarge").SMOKE, dtype=td)
    jmodel = j_build(jcfg)
    params = jmodel.init(jax.random.key(3))
    model = params_from_jax(params, cfg, device="cpu")
    jhmm = jcore.left_to_right_hmm(jax.random.key(1), C, 8)
    hmm = HMM.from_numpy(np.asarray(jhmm.log_pi), np.asarray(jhmm.log_A),
                         np.asarray(jhmm.log_B), device="cpu")
    x = np.random.default_rng(0).standard_normal((B, S, 64)).astype(
        np.float32)

    @jax.jit
    def j_emissions(p, frames):
        logits, _ = jmodel.prefill(p, {"embeds": frames.astype(jd)})
        return jax.nn.log_softmax(logits[..., :C], axis=-1)

    em = np.array(j_emissions(params, jnp.asarray(x)))
    return dict(jmodel=jmodel, params=params, model=model, jhmm=jhmm,
                hmm=hmm, x=x, em=em)


@pytest.fixture(scope="module")
def f32():
    return _setup("float32")


@pytest.fixture(scope="module")
def bf16():
    return _setup("bfloat16")


def _step(s, spec):
    return make_e2e_align_step(s["model"], s["hmm"], spec, C, device="cpu")


def test_emissions_match_jax_in_float32(f32):
    em = _step(f32, FusedSpec()).emissions({"embeds": f32["x"]})
    assert em.dtype == torch.float32 and em.shape == (B, S, C)
    err = np.abs(em.numpy() - f32["em"]).max()
    assert err <= 1e-5 * np.abs(f32["em"]).max(), err


def test_emissions_match_jax_in_bfloat16(bf16):
    em = _step(bf16, FusedSpec()).emissions({"embeds": bf16["x"]})
    assert em.dtype == torch.float32
    err = np.abs(em.numpy() - bf16["em"]).max()
    assert err <= 0.08 * np.abs(bf16["em"]).max(), err


@pytest.mark.parametrize("name", list(SPECS))
def test_decode_of_jax_emissions_is_bitwise_jax(f32, name):
    """The port's decode of JAX's emissions == JAX's vmapped ``spec.run``
    on them, paths and scores bitwise."""
    spec, j_spec = SPECS[name]
    j_spec = jcore.as_decode_spec(j_spec)
    jhmm = f32["jhmm"]
    paths_j, scores_j = jax.jit(jax.vmap(
        lambda e: j_spec.run(jhmm.log_pi, jhmm.log_A, e)))(f32["em"])
    paths, scores = _step(f32, spec).decode(torch.from_numpy(f32["em"]))
    assert paths.dtype == torch.int32 and paths.shape == (B, S)
    assert np.array_equal(paths.numpy(), np.asarray(paths_j))
    assert np.array_equal(scores.numpy(), np.asarray(scores_j))


@pytest.mark.parametrize("name", ["flash_bs", "fused"])
def test_step_matches_jax_jitted_step_in_float32(f32, name):
    """The whole step against ``jax.jit(make_e2e_align_step(...))``: the
    same paths; scores within rtol 1e-5."""
    spec, j_spec = SPECS[name]
    j_step = jax.jit(j_make_step(f32["jmodel"], None, f32["jhmm"], j_spec,
                                 C))
    paths_j, scores_j = j_step(f32["params"],
                               {"embeds": jnp.asarray(f32["x"])})
    paths, scores = _step(f32, spec)({"embeds": f32["x"]})
    assert np.array_equal(paths.numpy(), np.asarray(paths_j))
    np.testing.assert_allclose(scores.numpy(), np.asarray(scores_j),
                               rtol=1e-5)
    assert (np.diff(paths.numpy(), axis=1) >= 0).all()     # left-to-right


def test_flash_bs_step_is_one_batched_decode(f32, monkeypatch):
    """FLASH-BS decodes the whole batch in one `decode_batch` call: one
    initial pass and one tile pass a layer for every sequence at once."""
    from repro_torch.kernels import beam_stream
    calls = []
    for name in ("bs_initial_pass_batch", "bs_segment_decode_batch"):
        fn = getattr(beam_stream, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls.append((_name, a[2].shape[0]))
            return _fn(*a, **kw)
        monkeypatch.setattr(f"repro_torch.core.flash_bs.{name}", spy)
    reset_launches()
    _step(f32, AlignmentConfig()).decode(torch.from_numpy(f32["em"]))
    # S = 16, P = 8: Tp = 16, one layer of 8 tiles of 2 steps
    assert calls == [("bs_initial_pass_batch", B),
                     ("bs_segment_decode_batch", B * 8)]
    assert not any(launch_counts().values())   # CPU tensors: plain versions


@pytest.mark.parametrize("spec", [OnlineSpec(), OnlineBeamSpec()],
                         ids=["online", "online_beam"])
def test_streaming_specs_raise(f32, spec):
    with pytest.raises(ValueError, match="streaming"):
        _step(f32, spec)


def test_bad_sizes_raise(f32):
    model, hmm = f32["model"], f32["hmm"]
    with pytest.raises(ValueError, match="vocab"):
        make_e2e_align_step(model, hmm, FusedSpec(), model.cfg.vocab + 1,
                            device="cpu")
    with pytest.raises(ValueError, match="one a class"):
        make_e2e_align_step(model, hmm, FusedSpec(), C - 1, device="cpu")
    step = _step(f32, FusedSpec())
    with pytest.raises(ValueError, match="q_block"):      # S % 8 != 0
        step({"embeds": f32["x"][:, :12]})
    bare = build_model(model.cfg)
    with pytest.raises(ValueError, match="untied head"):
        make_e2e_align_step(bare, hmm, FusedSpec(), C, device="cpu")


def test_default_device_raises_on_a_cpu_only_host(f32):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_e2e_align_step(f32["model"], f32["hmm"], FusedSpec(), C)


def test_serving_example_runs_on_the_cpu(capsys):
    """examples/torch_forced_alignment_serving.py --device cpu: 12 requests
    in 3 batches, every path monotone and as long as its request."""
    import importlib.util
    path = ROOT / "examples" / "torch_forced_alignment_serving.py"
    spec = importlib.util.spec_from_file_location("torch_fa_example", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    done = example.main(["--device", "cpu"])
    assert len(done) == 12
    for r in done:
        path_r, score = r.result
        assert len(path_r) == len(r.payload) and np.isfinite(score)
        assert (np.diff(path_r) >= 0).all() and path_r.max() < example.STATES
    assert "served 12 alignment requests" in capsys.readouterr().out
