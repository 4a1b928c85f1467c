"""Parity of the port's training (`repro_torch.models` `loss` and its
backward, `optim`, `train`, `data`, `sharding`, `launch.model_flops`,
`launch.steps`, `launch.train`) with the JAX package's on the CPU.

Inputs are made with numpy from a seed; weights are drawn by the JAX
package and carried across with `params_from_jax` / `train_state_from_jax`,
results brought back to JAX's stacked layout with `jax_layout` /
`train_state_to_numpy`.  Tolerances:
  * exact: the specs (as tuples), the token pipeline's batches,
    `quantize` / `dequantize` / `ef_accumulate`, the useful-FLOPs counts,
    the train state's round trip and the CPU resume;
  * `schedule`: rtol 2.5e-7 (2 float32 ulps: the libraries' cos differ in
    the last bit at some steps; measured 1.3e-7);
  * each SMOKE model's float32 loss: rtol 1e-5 (measured 0 - 3.1e-7; MoE's
    aux term is 1e-3 of the loss, so a loss without it fails);
  * its float32 gradients: each leaf within 1e-4 x the leaf's max |g|
    (measured 2.8e-5 - 4.4e-5 over the transformers).  The recurrent
    families need more (`GRAD_BOUNDS`, 1.5x the measured): Griffin's
    2.73e-4 (an attention leaf), where both packages' float32 gradients
    lie up to 7.3e-4 (port) and 7.2e-4 (JAX) x max |g| from the port's
    float64 ones, so the gap is float32 rounding; xLSTM's 2.2e-3, the
    amplification of tests/test_torch_lm.py's docstring (|log i| ~ 120
    in the exponential gates; its float32 logits already differ by 4e-4);
  * bf16: the port's bf16 SMOKE loss lies within 1.5 x JAX's own bf16 -
    float32 distance of JAX's bf16 loss (measured at most 1.14x, granite);
  * one train step from the same warm state (one JAX step taken first):
    loss rtol 1e-5, grad_norm rtol `STEP_BOUNDS` (1.5x the measured), lr
    exact, each moment leaf within its bound x its max |value|, and each
    parameter within its bound x lr; an element whose gradient is at
    rounding level (JAX's |m| below 1e-3 x the leaf's max |m|) may flip the
    sign of its normalised step, so it is held to 2.05 x lr alone.  With
    ``compress_accum`` a gradient may sit one int8 quantum off JAX's (a
    rounding near a half-way point), which AdamW's normalisation turns
    into up to lr: the compressed step's bounds are measured the same way.
"""

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro.configs import get_arch as j_get_arch
from repro.data.pipeline import SyntheticTokenPipeline as JPipe
from repro.data.pipeline import TokenPipelineConfig as JPipeCfg
from repro.launch import model_flops as j_flops
from repro.launch.steps import build_cell as j_build_cell
from repro.models import build_model as j_build
from repro.optim import adamw as ja
from repro.optim import compression as jc
from repro.sharding import rules as jr
from repro.train import TrainConfig as JTrainConfig
from repro.train import abstract_train_state as j_abstract_state
from repro.train import init_train_state as j_init_state
from repro.train import make_train_step as j_make_step
from repro.train import train_state_specs as j_state_specs
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.core.mesh import PartitionSpec as P
from repro_torch.core.mesh import ShapeMesh
from repro_torch.data.pipeline import (EmissionPipelineConfig,
                                       HMMEmissionPipeline,
                                       SyntheticTokenPipeline,
                                       TokenPipelineConfig)
from repro_torch.launch import model_flops
from repro_torch.launch.steps import build_cell
from repro_torch.models import build_model, params_from_jax
from repro_torch.models import xlstm as xl
from repro_torch.models.common import chunked_cross_entropy
from repro_torch.models.convert import (jax_layout, train_state_from_jax,
                                        train_state_to_numpy)
from repro_torch.optim import adamw as ta
from repro_torch.optim import compression as tc
from repro_torch.sharding import rules as tr
from repro_torch.train import (TrainConfig, abstract_train_state,
                               init_train_state, make_train_step,
                               train_state_specs)

torch.set_num_threads(1)

#: per-leaf gradient bounds x max |g| where 1e-4 does not hold (docstring)
GRAD_BOUNDS = {"recurrentgemma_2b": 4.1e-4, "xlstm_350m": 3.3e-3}


def _batch(cfg, rng: np.random.Generator, B: int = 2, S: int = 16) -> dict:
    """A numpy batch of the config's inputs: tokens (after llava's image
    embeddings), or an encoder's frame embeddings; labels, a ragged mask."""
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


def _jax_batch(b: dict, dtype=jnp.float32) -> dict:
    return {k: jnp.asarray(v, dtype if v.dtype == np.float32 and k != "mask"
                           else None) for k, v in b.items()}


def _torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _configs(arch: str, jdtype, tdtype):
    return (dataclasses.replace(j_get_arch(arch).SMOKE, dtype=jdtype),
            dataclasses.replace(get_arch(arch).SMOKE, dtype=tdtype))


def _jax_params(arch: str, jcfg):
    key = jax.random.key(zlib.crc32(arch.encode()) % 2**31)
    return j_build(jcfg).init(key)


def _port_grads(model, batch: dict):
    """(loss, gradients in JAX's layout as numpy) of the port's model."""
    for p in model.parameters():
        p.requires_grad_(True)
    leaves, spec = tree_flatten(model.tree())
    loss = model.loss(batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), jax_layout(tree_unflatten(list(grads), spec),
                                     model)


def _leaf_gaps(ours, theirs):
    """{path: max |ours - theirs| / max |theirs|} over like trees."""
    out = {}
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ours),
                            jax.tree_util.tree_leaves(theirs)):
        b = np.asarray(b, np.float32)
        assert a.shape == b.shape, path
        out[jax.tree_util.keystr(path)] = (np.abs(a - b).max()
                                           / max(np.abs(b).max(), 1e-30))
    return out


# ---------------------------------------------------------------------------
# loss and backward, every family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_jax(arch):
    """SMOKE in float32 on a (2, 16) batch with a ragged mask: JAX's
    ``value_and_grad(model.loss)`` against the port's loss and its
    backward through `torch.autograd.grad` (each layer or unit recomputed
    under the config's "full" remat)."""
    jcfg, cfg = _configs(arch, jnp.float32, torch.float32)
    params = _jax_params(arch, jcfg)
    b = _batch(jcfg, np.random.default_rng(0))
    jloss, jgrads = jax.jit(jax.value_and_grad(j_build(jcfg).loss))(
        params, _jax_batch(b))
    model = params_from_jax(params, cfg, device="cpu")
    loss, grads = _port_grads(model, _torch_batch(b))
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert jax.tree_util.tree_structure(grads) == \
        jax.tree_util.tree_structure(jgrads)
    bound = GRAD_BOUNDS.get(arch, 1e-4)
    gaps = _leaf_gaps(grads, jgrads)
    assert max(gaps.values()) <= bound, {k: v for k, v in gaps.items()
                                         if v > bound}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bf16_loss_moves_as_far_as_jax(arch):
    """The same weights cast to bf16: the port's bf16 loss lies within 1.5x
    JAX's own bf16 - float32 distance of JAX's bf16 loss."""
    jcfg, cfg = _configs(arch, jnp.float32, torch.float32)
    params = _jax_params(arch, jcfg)
    b = _batch(jcfg, np.random.default_rng(0))
    losses = {}
    for name, jd, td in (("f32", jnp.float32, torch.float32),
                         ("bf16", jnp.bfloat16, torch.bfloat16)):
        jc_, c = _configs(arch, jd, td)
        jp = jax.tree_util.tree_map(lambda a: a.astype(jd), params)
        jl = jax.jit(j_build(jc_).loss)(jp, _jax_batch(b, jd))
        with torch.no_grad():
            tl = params_from_jax(params, c, device="cpu").loss(
                _torch_batch(b))
        losses[name] = (float(jl), float(tl))
    jax_moves = abs(losses["bf16"][0] - losses["f32"][0])
    assert abs(losses["bf16"][1] - losses["bf16"][0]) <= 1.5 * jax_moves, \
        losses


def test_moe_aux_term_is_in_the_loss():
    """moonshot's SMOKE: the port's loss is its cross entropy plus 0.01 x
    the layers' summed aux / num_layers, and the aux is not 0."""
    jcfg, cfg = _configs("moonshot_v1_16b_a3b", jnp.float32, torch.float32)
    model = params_from_jax(_jax_params("moonshot_v1_16b_a3b", jcfg), cfg,
                            device="cpu")
    batch = _torch_batch(_batch(cfg, np.random.default_rng(0)))
    with torch.no_grad():
        x = model._inputs(batch)
        pos = torch.arange(x.shape[1])
        aux = 0.0
        for layer in model.layers:
            x, a = layer.train_forward(x, pos)
            aux = aux + a
        from repro_torch.models.common import rms_norm
        ce = chunked_cross_entropy(rms_norm(x, model.ln_out), model._head(),
                                   batch["labels"], batch["mask"], chunk=8)
        loss = model.loss(batch)
    assert float(aux) > 0
    assert float(loss) == float(ce + 0.01 * aux / cfg.num_layers)


def test_xlstm_loss_skips_the_final_state_loop(monkeypatch):
    """The loss makes no `mlstm_step` call (JAX's XLA drops the final-state
    scan from its loss); a prefill makes S a unit."""
    _, cfg = _configs("xlstm_350m", jnp.float32, torch.float32)
    model = build_model(cfg).init(torch.Generator().manual_seed(0),
                                  device="cpu")
    calls = []
    step = xl.mlstm_step

    def counted(*a, **kw):
        calls.append(1)
        return step(*a, **kw)
    monkeypatch.setattr(xl, "mlstm_step", counted)
    batch = _torch_batch(_batch(cfg, np.random.default_rng(0)))
    model.loss(batch)
    assert not calls
    model.prefill({"tokens": batch["tokens"]})
    assert len(calls) == 16 * model.n_units


@pytest.mark.parametrize("window,invalid", [(None, False), (4, False),
                                            (None, True)])
def test_attention_backward_matches_jax_through_masked_blocks(window,
                                                              invalid):
    """Causal blockwise attention (S = 16 in blocks of 4: q block 0 sees
    three fully masked kv blocks, m starting at -inf), with a window of 4
    (whole blocks masked behind the window too) or invalid kv slots: the
    gradients of q, k and v are finite and within rtol 1e-5 / atol 1e-6 of
    JAX's ``jax.grad`` of its `blockwise_attention`."""
    from repro.models import attention as jatt
    from repro_torch.models import attention as tatt
    g = np.random.default_rng(8)
    q = g.standard_normal((2, 16, 3, 8)).astype(np.float32)
    k, v = (g.standard_normal((2, 16, 24)).astype(np.float32)
            for _ in range(2))
    w = g.standard_normal((2, 16, 3, 8)).astype(np.float32)
    kpos = np.arange(16, dtype=np.int32)
    if invalid:
        kpos[[1, 2, 3, 9]] = -1
    kw = dict(causal=True, window=window, q_offset=0, q_block=4,
              kv_block=4, scale=0.35)

    def heads(kv):
        return tuple(a.reshape(a.shape[0], a.shape[1], 3, 8) for a in kv)

    def jloss(q, k, v):
        out = jatt.blockwise_attention(q, (k, v), heads,
                                       kv_positions=jnp.asarray(kpos), **kw)
        return jnp.sum(out * w)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = tatt.blockwise_attention(tq, (tk, tv), heads,
                                   kv_positions=torch.from_numpy(kpos), **kw)
    tg = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                             (tq, tk, tv))
    for a, b in zip(tg, jg):
        assert bool(torch.isfinite(a).all())
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("policy", ["none", "dots", "full"])
def test_remat_policies_give_the_same_loss_and_grads(policy):
    """Recomputation changes what backward keeps, not the numbers: each
    policy's loss and gradients equal the plain call's, bitwise, on the
    CPU."""
    jcfg, cfg = _configs("granite_8b", jnp.float32, torch.float32)
    params = _jax_params("granite_8b", jcfg)
    batch = _torch_batch(_batch(cfg, np.random.default_rng(0)))
    out = {}
    for pol in ("none", policy):
        c = dataclasses.replace(cfg, remat_policy=pol)
        out[pol] = _port_grads(params_from_jax(params, c, device="cpu"),
                               batch)
    assert torch.equal(out["none"][0], out[policy][0])
    for a, b in zip(jax.tree_util.tree_leaves(out["none"][1]),
                    jax.tree_util.tree_leaves(out[policy][1])):
        assert np.array_equal(a, b)


def test_chunked_cross_entropy_needs_whole_chunks():
    h = torch.zeros(1, 12, 4)
    with pytest.raises(ValueError, match="multiple of the loss chunk"):
        chunked_cross_entropy(h, torch.zeros(4, 5),
                              torch.zeros(1, 12, dtype=torch.int32),
                              torch.ones(1, 12), chunk=8)


def test_an_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="unknown remat policy"):
        cfg = dataclasses.replace(get_arch("tinyllama_1_1b").SMOKE,
                                  remat_policy="some")
        build_model(cfg).init(device="cpu").loss(_torch_batch(
            _batch(cfg, np.random.default_rng(0))))


def test_serving_builds_no_graph_on_trainable_weights():
    """After `init_train_state` the weights are trainable, yet prefill and
    decode run under no_grad: their outputs hold no graph."""
    cfg = get_arch("tinyllama_1_1b").SMOKE
    model = build_model(cfg)
    state = init_train_state(model, device="cpu")
    assert all(p.requires_grad for p in model.parameters())
    assert state["params"]["embed"] is model.embed
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    logits, cache = model.prefill({"tokens": tokens}, max_len=16)
    assert not logits.requires_grad and not cache[0]["k"].requires_grad
    logits, _ = model.decode_step(tokens[:, :1], cache)
    assert not logits.requires_grad


# ---------------------------------------------------------------------------
# AdamW and int8 error feedback
# ---------------------------------------------------------------------------

def test_schedule_matches_jax():
    cfg = dict(lr=3e-3, warmup_steps=7, total_steps=40, min_lr_ratio=0.1)
    steps = np.arange(0, 46, dtype=np.int32)
    theirs = np.asarray(jax.vmap(lambda s: ja.schedule(
        ja.AdamWConfig(**cfg), s))(jnp.asarray(steps)))
    ours = ta.schedule(ta.AdamWConfig(**cfg), torch.from_numpy(steps))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=2.5e-7, atol=0)


def _random_tree(g: np.random.Generator) -> dict:
    return {"w": (g.standard_normal((6, 5)) * 2).astype(np.float32),
            "layers": {"a": g.standard_normal((3, 4)).astype(np.float32),
                       "b": (g.standard_normal((7,)) * 1e-3
                             ).astype(np.float32)},
            "s": g.standard_normal(()).astype(np.float32)}


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_update_and_global_norm_match_jax(clip):
    """Five AdamW steps on random trees (clipped and not): each parameter
    and moment leaf within 3e-6 x its max |value| of JAX's (float32
    rounding of the clip scale and the bias corrections, magnified where
    the moments of random gradients cancel: 1.95e-6 measured, on the
    scalar leaf's m), grad_norm within rtol 2e-6, lr exact; the global
    norm of a tree too."""
    g = np.random.default_rng(7)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip)
    jparams = jax.tree_util.tree_map(jnp.asarray, _random_tree(g))
    jstate = ja.init_state(jparams)
    params = jax.tree_util.tree_map(torch.from_numpy,
                                    jax.tree_util.tree_map(np.array,
                                                           jparams))
    state = ta.init_state(params)
    for _ in range(5):
        grads = _random_tree(g)
        jparams, jstate, jm = ja.update(
            ja.AdamWConfig(**cfg),
            jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        params, state, m = ta.update(
            ta.AdamWConfig(**cfg),
            jax.tree_util.tree_map(torch.from_numpy, grads), state, params)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=2e-6)
        assert float(m["lr"]) == float(jm["lr"])
        assert int(state["step"]) == int(jstate["step"])
        for ours, theirs in ((params, jparams), (state["m"], jstate["m"]),
                             (state["v"], jstate["v"])):
            for a, b in zip(jax.tree_util.tree_leaves(ours),
                            jax.tree_util.tree_leaves(theirs)):
                b = np.asarray(b)
                assert np.abs(a.numpy() - b).max() <= 3e-6 * np.abs(b).max()
    tree = _random_tree(g)
    np.testing.assert_allclose(
        float(ta.global_norm(jax.tree_util.tree_map(torch.from_numpy,
                                                    tree))),
        float(ja.global_norm(tree)), rtol=1e-6)


def _tie_heavy(g: np.random.Generator, shape) -> np.ndarray:
    """Values whose quotient by the absmax scale is often a half-way
    point: the absmax is 127 (scale 1), the others k + 0.5."""
    x = (g.integers(-127, 127, shape) + 0.5).astype(np.float32)
    x.flat[0] = 127.0
    return x


def test_quantize_and_dequantize_are_bitwise_jax():
    g = np.random.default_rng(3)
    for x in (g.standard_normal((5, 33)).astype(np.float32),
              _tie_heavy(g, (4, 40)), np.zeros((3,), np.float32)):
        q, s = tc.quantize(torch.from_numpy(x))
        jq, js = jc.quantize(jnp.asarray(x))
        assert q.dtype == torch.int8 and np.array_equal(q.numpy(),
                                                        np.asarray(jq))
        assert float(s) == float(js)
        assert np.array_equal(tc.dequantize(q, s).numpy(),
                              np.asarray(jc.dequantize(jq, js)))


def test_ef_accumulate_is_bitwise_jax():
    """Eight accumulations of random and tie-heavy gradients: q, scale and
    residual bitwise JAX's after each."""
    g = np.random.default_rng(4)
    q = torch.zeros((4, 40), dtype=torch.int8)
    s = torch.zeros(())
    r = torch.zeros((4, 40))
    jq, js, jr_ = jnp.zeros((4, 40), jnp.int8), jnp.zeros(()), \
        jnp.zeros((4, 40))
    for i in range(8):
        grad = (_tie_heavy(g, (4, 40)) if i % 2 else
                g.standard_normal((4, 40)).astype(np.float32))
        q, s, r = tc.ef_accumulate(q, s, r, torch.from_numpy(grad))
        jq, js, jr_ = jc.ef_accumulate(jq, js, jr_, jnp.asarray(grad))
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
        assert np.array_equal(r.numpy(), np.asarray(jr_))


def test_ef_takes_one_scale_a_stacked_leaf():
    """A JAX leaf stacks 3 layers whose gradients differ 1000x in size; the
    port holds the layers apart.  Accumulated as the pieces of one leaf,
    the buffers equal JAX's on the stacked leaf bitwise; quantizing the
    layers one by one would not (the small layer keeps far more levels)."""
    g = np.random.default_rng(5)
    shapes = (8, 6)
    ef = tc.init_ef_state([[torch.empty(shapes) for _ in range(3)]])
    (qs,), (s,), (rs,) = ef["q"], ef["scale"], ef["residual"]
    assert [q.dtype for q in qs] == [torch.int8] * 3 and s.shape == ()
    assert all(r.dtype == torch.float32 and not r.any() for r in rs)
    jq, js, jres = jnp.zeros((3, *shapes), jnp.int8), jnp.zeros(()), \
        jnp.zeros((3, *shapes))
    for _ in range(3):
        grads = [(g.standard_normal(shapes) * 10.0 ** -k).astype(np.float32)
                 for k in range(3)]
        qs, s, rs = tc.ef_accumulate(qs, s, rs,
                                     [torch.from_numpy(x) for x in grads])
        jq, js, jres = jc.ef_accumulate(jq, js, jres, jnp.asarray(
            np.stack(grads)))
    assert float(s) == float(js)
    assert np.array_equal(np.stack([q.numpy() for q in qs]), np.asarray(jq))
    assert np.array_equal(np.stack([r.numpy() for r in rs]),
                          np.asarray(jres))
    alone = [tc.quantize(r + q.float() * s)[0] for q, r in zip(qs, rs)]
    assert not np.array_equal(alone[2].numpy(), qs[2].numpy())


# ---------------------------------------------------------------------------
# specs and shapes
# ---------------------------------------------------------------------------

def _tuples(tree):
    """A spec tree with every PartitionSpec as a plain tuple."""
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tuples(v) for v in tree]
    return None if tree is None else tuple(tree)


def _jax_tuples(tree):
    return _tuples(jax.tree_util.tree_map(
        tuple, tree,
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_jax(arch):
    """For the full config under both rule tables: `param_specs`
    (`spec_tree_from_layout`), `train_state_specs` (ZeRO-1 moments at data
    sizes 16 and 32) and the abstract state's shapes; every input spec's
    shardings, single and multi-pod."""
    mod, jmod = get_arch(arch), j_get_arch(arch)
    model, jmodel = build_model(mod.CONFIG), j_build(jmod.CONFIG)
    for rules, jrules in ((tr.SINGLE_POD_RULES, jr.SINGLE_POD_RULES),
                          (tr.MULTI_POD_RULES, jr.MULTI_POD_RULES)):
        assert rules.rules == jrules.rules
        assert _tuples(tr.spec_tree_from_layout(rules, model.layout())) == \
            _jax_tuples(jr.spec_tree_from_layout(jrules, jmodel.layout()))
        assert _tuples(model.param_specs(rules)) == \
            _jax_tuples(jmodel.param_specs(jrules))
        for size in (16, 32):
            assert _tuples(train_state_specs(model, rules, size)) == \
                _jax_tuples(j_state_specs(jmodel, jrules, size))
    ours = jax.tree_util.tree_map(lambda t: (tuple(t.shape), t.is_meta),
                                  abstract_train_state(model))
    theirs = jax.tree_util.tree_map(lambda t: (tuple(t.shape), True),
                                    j_abstract_state(jmodel))
    assert ours == theirs
    for multi_pod in (False, True):
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            spec = mod.input_specs(shape, multi_pod=multi_pod)
            jspec = jmod.input_specs(shape, multi_pod=multi_pod)
            if spec is None:
                assert jspec is None
                continue
            assert _tuples(spec.shardings) == _jax_tuples(jspec.shardings)


def test_zero1_specs_shard_the_largest_free_axis():
    """tests/test_substrate.py's case, and a tuple of data axes."""
    out = ta.zero1_specs({"w": P(None, "model"), "b": P()},
                         {"w": (64, 128), "b": (7,)}, ("data",),
                         data_size=16)
    assert out["w"] == P("data", "model")
    assert out["b"] == P(None)       # 7 is not divisible: replicated
    out = ta.zero1_specs({"w": P()}, {"w": (64, 128)}, ("pod", "data"),
                         data_size=32)
    assert out["w"] == P(None, ("pod", "data"))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_useful_flops_equal_jax(arch):
    """Every config and kind at each shape's (S, B) and at (4096, 4)."""
    mod, jmod = get_arch(arch), j_get_arch(arch)
    for cfg_name in ("CONFIG", "SMOKE"):
        model = build_model(getattr(mod, cfg_name))
        jmodel = j_build(getattr(jmod, cfg_name))
        for kind in ("train", "prefill", "decode"):
            for S, B in ((4096, 4), (32_768, 32), (524_288, 1), (16, 2)):
                assert model_flops.useful_flops(model, kind, S, B) == \
                    j_flops.useful_flops(jmodel, kind, S, B)


def test_tinyllama_train_flops():
    """The yardstick phase 16c prints: 1.263e14 a step at (4096, 4)."""
    model = build_model(get_arch("tinyllama_1_1b").CONFIG)
    assert model.param_count() == 1_100_048_384
    assert round(model_flops.useful_flops(model, "train", 4096, 4) / 1e14,
                 3) == 1.263


def _jax_mesh(multi_pod: bool):
    shape = (1, 1, 1) if multi_pod else (1, 1)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(shape),
                             names)


@pytest.mark.parametrize("arch,shape", [
    ("tinyllama_1_1b", "train_4k"), ("gemma_2b", "decode_32k"),
    ("deepseek_v2_236b", "prefill_32k"), ("xlstm_350m", "long_500k"),
    ("recurrentgemma_2b", "decode_32k"), ("hubert_xlarge", "prefill_32k")])
def test_build_cell_matches_jax(arch, shape):
    """Kind, the abstract arguments' shapes (JAX's layout) and the in / out
    shardings as tuples, single and multi-pod (a JAX mesh of size 1 a
    axis, so JAX's data size is 1)."""
    for multi_pod in (False, True):
        sizes = (1, 1, 1) if multi_pod else (1, 1)
        names = ("pod", "data", "model") if multi_pod else ("data", "model")
        cell = build_cell(get_arch(arch), shape, ShapeMesh(sizes, names))
        jcell = j_build_cell(j_get_arch(arch), shape, _jax_mesh(multi_pod))
        assert cell.kind == jcell.kind and cell.donate == jcell.donate
        spec = lambda s: jax.tree_util.tree_map(
            lambda n: tuple(n.spec), s,
            is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
        assert _tuples(cell.in_shardings[0]) == _tuples(spec(
            jcell.in_shardings[0]))
        assert _tuples(cell.out_shardings[0]) == _tuples(spec(
            jcell.out_shardings[0]))
        if cell.kind == "decode":   # the port's cache is per layer
            continue
        ours = [tuple(a.shape) for a in jax.tree_util.tree_leaves(cell.args)]
        theirs = [tuple(a.shape)
                  for a in jax.tree_util.tree_leaves(jcell.args)]
        assert ours == theirs


# ---------------------------------------------------------------------------
# the data pipelines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["tokens", "embeds", "vlm"])
def test_token_pipeline_is_bitwise_jax(kind):
    cfg = dict(vocab=300, seq_len=24, global_batch=3, seed=11,
               num_image_tokens=5 if kind == "vlm" else 0, d_model=16,
               kind=kind)
    ours, theirs = (SyntheticTokenPipeline(TokenPipelineConfig(**cfg)),
                    JPipe(JPipeCfg(**cfg)))
    for step in (0, 1, 17):
        a, b = ours.batch(step), theirs.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_emission_pipeline_is_deterministic():
    from repro_torch.core import erdos_renyi_hmm
    hmm = erdos_renyi_hmm(np.random.default_rng(0), 12, device="cpu")
    pipe = HMMEmissionPipeline(EmissionPipelineConfig(12, 20, 3, seed=2),
                               hmm)
    a, b, c = pipe.batch(4), pipe.batch(4), pipe.batch(5)
    assert a["obs"].shape == (3, 20) and a["emissions"].shape == (3, 20, 12)
    assert torch.equal(a["obs"], b["obs"])
    assert torch.equal(a["emissions"], b["emissions"])
    assert not torch.equal(a["obs"], c["obs"])
    assert torch.equal(a["emissions"][1], hmm.emissions(a["obs"][1]))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

#: (arch, accum_steps, compress_accum) -> (grad_norm rtol, m, v bounds x
#: the leaf's max |value|, the parameters' bound x lr on elements with a
#: resolved gradient): 1.5x the measured
STEP_BOUNDS = {
    ("tinyllama_1_1b", 1, False): (2.8e-5, 1.4e-4, 1e-4, 4.5e-3),
    ("tinyllama_1_1b", 2, False): (3.2e-6, 3.8e-5, 3.4e-5, 1.8e-3),
    ("tinyllama_1_1b", 2, True): (2.9e-5, 1.2e-2, 6.3e-3, 0.85),
    ("moonshot_v1_16b_a3b", 2, False): (2.6e-5, 2.6e-5, 5.1e-5, 6e-4),
    ("recurrentgemma_2b", 1, False): (9.2e-6, 1.2e-4, 1.5e-4, 1e-2),
    ("recurrentgemma_2b", 2, True): (1.2e-4, 1.4e-2, 1.6e-2, 0.44),
}


@pytest.mark.parametrize("case", list(STEP_BOUNDS))
def test_train_step_matches_jax(case):
    """One step from a warm state in both packages: JAX's jitted step
    takes one step on a first batch, its state is carried across, then each
    takes a step on a second batch (B, S) = (4, 16)."""
    arch, A, compress = case
    gn_tol, m_tol, v_tol, p_tol = STEP_BOUNDS[case]
    jcfg, cfg = _configs(arch, jnp.float32, torch.float32)
    jmodel = j_build(jcfg)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jstep = jax.jit(j_make_step(jmodel, JTrainConfig(
        opt=ja.AdamWConfig(**kw), accum_steps=A, compress_accum=compress)))
    rng = np.random.default_rng(1)
    jstate, _ = jstep(j_init_state(jmodel, jax.random.key(3)),
                      _jax_batch(_batch(cfg, rng, B=4)))
    model = build_model(cfg)
    state = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate),
                                 model, device="cpu")
    step = make_train_step(model, TrainConfig(
        opt=ta.AdamWConfig(**kw), accum_steps=A, compress_accum=compress))
    b = _batch(cfg, rng, B=4)
    jstate, jm = jstep(jstate, _jax_batch(b))
    state, m = step(state, _torch_batch(b))
    assert state["params"]["ln_out"] is model.ln_out
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=gn_tol)
    assert float(m["lr"]) == float(jm["lr"])
    ours = train_state_to_numpy(state, model)
    theirs = jax.tree_util.tree_map(np.asarray, jstate)
    assert ours["opt"]["step"] == theirs["opt"]["step"] == 2
    for name, tol in (("m", m_tol), ("v", v_tol)):
        gaps = _leaf_gaps(ours["opt"][name], theirs["opt"][name])
        assert max(gaps.values()) <= tol, (name, gaps)
    lr = float(jm["lr"])
    for a, b_, jmom in zip(jax.tree_util.tree_leaves(ours["params"]),
                           jax.tree_util.tree_leaves(theirs["params"]),
                           jax.tree_util.tree_leaves(theirs["opt"]["m"])):
        gap = np.abs(a - b_) / lr
        resolved = np.abs(jmom) > 1e-3 * np.abs(jmom).max()
        assert gap.max() <= 2.05
        assert gap[resolved].max(initial=0.0) <= p_tol


def test_train_state_round_trip():
    jcfg, cfg = _configs("recurrentgemma_2b", jnp.bfloat16, torch.bfloat16)
    jstate = jax.tree_util.tree_map(np.asarray, j_init_state(
        j_build(jcfg), jax.random.key(0)))
    jstate["opt"]["m"] = jax.tree_util.tree_map(
        lambda a: np.full(a.shape, 0.5, np.float32), jstate["opt"]["m"])
    model = build_model(cfg)
    state = train_state_from_jax(jstate, model, device="cpu")
    back = train_state_to_numpy(state, model)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jstate)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jstate)):
        assert np.array_equal(a, np.asarray(b, np.float32)
                              if np.asarray(b).dtype.name == "bfloat16"
                              else b)


def test_accumulation_sums_in_float32():
    """At accum_steps 2 in bf16 the step's gradient is the mean of the two
    microbatches' bf16 gradients summed in float32 (as JAX's float32
    zeros), not a bf16 sum: checked through grad_norm against the two
    single-microbatch gradients."""
    cfg = get_arch("tinyllama_1_1b").SMOKE
    b = _torch_batch(_batch(cfg, np.random.default_rng(2), B=4))
    model = build_model(cfg).init(torch.Generator().manual_seed(0),
                                  device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    leaves = tree_flatten(model.tree())[0]
    halves = [torch.autograd.grad(model.loss(
        {k: v[i:i + 2] for k, v in b.items()}), leaves) for i in (0, 2)]
    want = torch.stack([torch.linalg.vector_norm(
        (g0.float() + g1.float()) / 2) for g0, g1 in zip(*halves)]
    ).square().sum().sqrt()
    state = init_train_state(model, torch.Generator().manual_seed(0),
                             device="cpu")
    _, m = make_train_step(model, TrainConfig(accum_steps=2))(state, b)
    assert float(m["grad_norm"]) == pytest.approx(float(want), rel=1e-6)


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------

LAUNCH_ARGS = ["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu"]


def test_training_loop_loss_decreases(tmp_path):
    """tests/test_system.py's run on the CPU."""
    from repro_torch.launch.train import main
    losses = main(LAUNCH_ARGS + ["--steps", "30", "--batch", "4", "--seq", "64",
                            "--lr", "1e-2", "--ckpt-dir", str(tmp_path),
                            "--ckpt-every", "10"])
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.3


def test_training_resume_is_bitwise(tmp_path):
    """tests/test_system.py's resume: on the CPU the resumed losses equal
    the uninterrupted run's exactly."""
    from repro_torch.launch.train import main
    args = LAUNCH_ARGS + ["--batch", "2", "--seq", "32", "--lr", "1e-3",
                     "--horizon", "10", "--ckpt-every", "5"]
    full = main(["--steps", "10", "--ckpt-dir", str(tmp_path / "a")] + args)
    part = main(["--steps", "5", "--ckpt-dir", str(tmp_path / "b")] + args)
    resumed = main(["--steps", "10", "--resume",
                    "--ckpt-dir", str(tmp_path / "b")] + args)
    assert part == full[:5]
    assert resumed == full[5:]


def test_training_loop_needs_a_device_or_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.launch.train import main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--smoke", "--steps", "1", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_train_state(build_model(get_arch("tinyllama_1_1b").SMOKE))
