"""Parity of the port's model substrate (`repro_torch.models`,
`repro_torch.configs`) with the JAX package's on the CPU.

Inputs are made once with numpy from a seed; weights are drawn by the JAX
package and carried across with `params_from_jax`, so both packages compute
with the same numbers.  Tolerances:
  * a single op (`rms_norm`, `mlp`, `apply_rope`, `blockwise_attention`,
    `gqa_forward`, one layer) in float32: rtol 1e-5, atol 1e-5 (the ops
    differ from XLA's by an ulp or so: the two libraries sum in other
    orders);
  * the whole SMOKE encoder's logits in float32: max |diff| <= 2e-5 x max
    |logit| (its stacked init draws with 1/sqrt(num_layers), as JAX's does,
    so each product grows the ulps; 2e-6 to 1.1e-5 over seeds 0-7);
  * in bfloat16: max |diff| <= 0.08 x max |logit| and mean |diff| <= 0.01 x
    max |logit| (XLA keeps a fused elementwise chain in float32 where the
    port rounds each op to bfloat16; 0.016-0.032 and 0.0021-0.0029 over
    seeds 0-7).
The layout, the parameter count and the round trip of the weights are
exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs import paper_hmm as j_paper_hmm
from repro.models import attention as ja
from repro.models import build_model as j_build
from repro.models import common as jc
from repro.models import transformer as jt
from repro_torch.configs import ARCH_IDS, PORTED_IDS, get_arch, paper_hmm
from repro_torch.models import (GriffinLM, ModelConfig, TransformerLM,
                                XLSTMLM, build_model, params_from_jax,
                                to_numpy_tree)
from repro_torch.models import attention as ta
from repro_torch.models import common as tc
from repro_torch.models import transformer as tt

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _close(ours, theirs, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(ours.detach().float().numpy(),
                               np.asarray(theirs, np.float32),
                               rtol=rtol, atol=atol)


def _rand(g, *shape, scale=1.0):
    return (g.standard_normal(shape) * scale).astype(np.float32)


def _both(tree):
    """(JAX tree, torch tree) of one numpy tree."""
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            jax.tree_util.tree_map(torch.from_numpy, tree))


def _smoke(dtype: str):
    """(JAX cfg, port cfg) of hubert SMOKE in `dtype`."""
    jd, td = DTYPES[dtype]
    return (dataclasses.replace(j_get_arch("hubert_xlarge").SMOKE, dtype=jd),
            dataclasses.replace(get_arch("hubert_xlarge").SMOKE, dtype=td))


# ---------------------------------------------------------------------------
# Ops
# ---------------------------------------------------------------------------

def test_rms_norm_matches_jax():
    g = np.random.default_rng(0)
    x, scale = _rand(g, 2, 16, 64, scale=3.0), _rand(g, 64, scale=0.1)
    (jx, js), (tx, ts) = _both((x, scale))
    _close(tc.rms_norm(tx, ts), jc.rms_norm(jx, js))
    out = tc.rms_norm(tx.to(torch.bfloat16), ts)
    assert out.dtype == torch.bfloat16     # computed in f32, cast back


def test_layer_norm_matches_jax():
    g = np.random.default_rng(1)
    x, scale, bias = _rand(g, 3, 32), _rand(g, 32), _rand(g, 32)
    (jx, js, jb), (tx, ts, tb) = _both((x, scale, bias))
    _close(tc.layer_norm(tx, ts, tb), jc.layer_norm(jx, js, jb))


@pytest.mark.parametrize("act,glu", [("gelu", False), ("silu", True),
                                     ("relu", False)])
def test_mlp_matches_jax(act, glu):
    """gelu is JAX's tanh approximation in both packages."""
    g = np.random.default_rng(2)
    x = _rand(g, 2, 16, 64, scale=2.0)
    p = {"wi": _rand(g, 64, 160, scale=0.125),
         "wo": _rand(g, 160, 64, scale=0.08)}
    if glu:
        p["wg"] = _rand(g, 64, 160, scale=0.125)
    (jx, jp), (tx, tp) = _both((x, p))
    j_fn, t_fn = (jc.glu_mlp, tc.glu_mlp) if glu else (jc.mlp, tc.mlp)
    _close(t_fn(tp, tx, act=act), j_fn(jp, jx, act=act))


def test_apply_rope_matches_jax():
    g = np.random.default_rng(3)
    x, pos = _rand(g, 2, 16, 4, 16), np.arange(5, 21)
    (jx, jpos), (tx, tpos) = _both((x, pos))
    _close(tc.apply_rope(tx, tpos, 500.0), jc.apply_rope(jx, jpos, 500.0))
    _close(tc.rope_frequencies(16), jc.rope_frequencies(16))


#: (S, Skv, q_block, kv_block, causal, window, invalid kv slots)
ATTN_CASES = [(16, 16, 16, 16, False, None, False),
              (32, 32, 8, 16, False, None, False),
              (32, 32, 8, 8, True, None, False),
              (32, 32, 16, 8, True, 5, False),
              (24, 32, 8, 16, False, 3, True)]


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_blockwise_attention_matches_jax(case):
    """Non-causal and causal, with a window, several q and kv blocks, and
    kv slots marked invalid (-1)."""
    S, Skv, qb, kb, causal, window, invalid = case
    g = np.random.default_rng(4)
    q = _rand(g, 2, S, 3, 8)
    k, v = _rand(g, 2, Skv, 24), _rand(g, 2, Skv, 24)
    kpos = np.arange(Skv)
    if invalid:
        kpos[g.permutation(Skv)[:5]] = -1
    (jq, jk, jv, jpos), (tq, tk, tv, tpos) = _both((q, k, v, kpos))
    kw = dict(causal=causal, window=window, q_block=qb, kv_block=kb,
              scale=0.3)

    def heads(kv):      # (B, kb, 24) -> (B, kb, 3, 8)
        return tuple(a.reshape(a.shape[0], a.shape[1], 3, 8) for a in kv)

    out_j = ja.blockwise_attention(jq, (jk, jv), heads, q_offset=2,
                                   kv_positions=jpos, **kw)
    out_t = ta.blockwise_attention(tq, (tk, tv), heads, q_offset=2,
                                   kv_positions=tpos, **kw)
    assert out_t.dtype == torch.float32
    _close(out_t, out_j)


def test_blockwise_attention_rejects_ragged_blocks():
    q = torch.zeros((1, 12, 2, 4))
    with pytest.raises(ValueError, match="q_block"):
        ta.blockwise_attention(q, (q, q), lambda kv: kv, causal=False,
                               window=None, q_offset=0,
                               kv_positions=torch.arange(12), q_block=8,
                               kv_block=4, scale=1.0)


#: (heads, kv heads, causal, rope, window)
GQA_CASES = [(4, 2, True, True, None), (4, 4, False, False, None),
             (4, 1, True, True, 6), (4, 2, False, True, None)]


@pytest.mark.parametrize("case", GQA_CASES, ids=str)
def test_gqa_forward_matches_jax(case):
    """GQA (h 4, hk 2), MHA, MQA with a window; rope on and off."""
    h, hk, causal, rope, window = case
    d, hd, S = 32, 8, 16
    kw = dict(d_model=d, num_heads=h, num_kv_heads=hk, head_dim=hd,
              causal=causal, use_rope=rope, window=window, q_block=8,
              kv_block=4)
    g = np.random.default_rng(5)
    x = _rand(g, 2, S, d)
    lay = ta.attn_layout(ta.AttnConfig(**kw))
    assert lay == ja.attn_layout(ja.AttnConfig(**kw))
    p = {n: _rand(g, *shape, scale=shape[0] ** -0.5)
         for n, (shape, _, _) in lay.items()}
    (jx, jp, jpos), (tx, tp, tpos) = _both((x, p, np.arange(S)))
    out_j, kv_j = ja.gqa_forward(jp, jx, jpos, ja.AttnConfig(**kw))
    out_t, kv_t = ta.gqa_forward(tp, tx, tpos, ta.AttnConfig(**kw))
    _close(out_t, out_j)
    _close(kv_t["k"], kv_j["k"])
    _close(kv_t["v"], kv_j["v"])


def test_layer_fwd_matches_jax():
    """One hubert SMOKE layer (plain gelu MLP, no rope, bidirectional)."""
    jcfg, cfg = _smoke("float32")
    lay = tt.layer_layout(cfg)
    g = np.random.default_rng(6)
    lp = jax.tree_util.tree_map(
        np.array, jc.init_params(jax.random.key(6), jt.layer_layout(jcfg),
                                   jnp.float32))
    lp["ln_attn"] = _rand(g, 64, scale=0.1)
    x = _rand(g, 2, 16, 64)
    (jlp, jx, jpos), (tlp, tx, tpos) = _both((lp, x, np.arange(16)))
    out_j, _, aux_j = jt._layer_fwd(jcfg, jlp, jx, jpos)
    out_t, _, aux_t = tt.layer_fwd(cfg, tlp, tx, tpos)
    assert float(aux_t) == float(aux_j) == 0.0    # a dense MLP: no aux
    assert jax.tree_util.tree_structure(lay) == \
        jax.tree_util.tree_structure(jt.layer_layout(jcfg))
    _close(out_t, out_j)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_prefill_matches_jax(dtype):
    """hubert SMOKE's encoder-only prefill: (B, S, vocab) float32 logits
    and no cache, against JAX's on the same weights."""
    jcfg, cfg = _smoke(dtype)
    params = j_build(jcfg).init(jax.random.key(3))
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg,
                            device="cpu")
    x = _rand(np.random.default_rng(7), 2, 16, 64)
    logits_j, _ = j_build(jcfg).prefill(params, {"embeds": jnp.asarray(x)})
    logits, cache = model.prefill({"embeds": torch.from_numpy(x)})
    assert cache is None and logits.dtype == torch.float32
    assert logits.shape == (2, 16, cfg.vocab)
    ref = np.asarray(logits_j)
    err = np.abs(logits.numpy() - ref)
    scale = np.abs(ref).max()
    if dtype == "float32":
        assert err.max() <= 2e-5 * scale, err.max()
    else:
        assert err.max() <= 0.08 * scale and err.mean() <= 0.01 * scale, \
            (err.max(), err.mean(), scale)


def test_encode_is_the_stack_then_the_output_norm():
    _, cfg = _smoke("float32")
    model = build_model(cfg).init(torch.Generator().manual_seed(1),
                                  device="cpu")
    x = torch.from_numpy(_rand(np.random.default_rng(8), 1, 8, 64))
    h, pos = x, torch.arange(8)
    for layer in model.layers:
        h = tt.layer_fwd(cfg, layer.tree(), h, pos)[0]
    assert torch.equal(model.encode(x), tc.rms_norm(h, model.ln_out))


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_param_count_matches_jax_from_the_layout(which):
    cfg = getattr(get_arch("hubert_xlarge"), which)
    model = build_model(cfg)
    n = model.param_count()
    assert n == j_build(getattr(j_get_arch("hubert_xlarge"), which)
                        ).param_count()
    assert list(model.parameters()) == []      # nothing allocated
    if which == "CONFIG":
        assert n == 944_497_920


@pytest.mark.parametrize("scan", [True, False])
def test_layout_matches_jax(scan):
    jcfg, cfg = _smoke("float32")
    jcfg = dataclasses.replace(jcfg, scan_layers=scan)
    cfg = dataclasses.replace(cfg, scan_layers=scan)
    assert tt.model_layout(cfg) == jt.model_layout(jcfg)


def test_init_draws_the_layout_kinds():
    """Zeros for the norms; normal leaves scaled by 1/sqrt(shape[0]) (the
    layer count for stacked leaves, as JAX's `_init_array` does), drawn in
    float32 and cast; the tree has JAX's shapes."""
    cfg = dataclasses.replace(get_arch("hubert_xlarge").SMOKE, num_layers=8)
    model = build_model(cfg).init(torch.Generator().manual_seed(0),
                                  device="cpu")
    tree = to_numpy_tree(model)
    shapes = jax.tree_util.tree_map(lambda a: a.shape, tree)
    j_shapes = jax.tree_util.tree_map(
        lambda a: a.shape,
        j_build(dataclasses.replace(j_get_arch("hubert_xlarge").SMOKE,
                                    num_layers=8)).abstract_params())
    assert shapes == j_shapes
    assert model.layers[0].attn["wq"].dtype == torch.bfloat16
    assert not tree["ln_out"].any() and not tree["layers"]["ln_attn"].any()
    wi = tree["layers"]["mlp"]["wi"]                 # (8, 64, 160)
    assert abs(wi.std() - 8 ** -0.5) < 0.01
    assert abs(tree["head"].std() - 64 ** -0.5) < 0.01
    again = build_model(cfg).init(torch.Generator().manual_seed(0),
                                  device="cpu")
    assert torch.equal(again.head, model.head)       # seeded


@pytest.mark.parametrize("dtype,scan", [("float32", True),
                                        ("bfloat16", True),
                                        ("float32", False)])
def test_params_from_jax_round_trip(dtype, scan):
    """JAX tree -> model -> tree is exact, and layer i holds slice i of the
    stacked leaves (a wrong layer order still gives finite numbers)."""
    jcfg, cfg = _smoke(dtype)
    jcfg = dataclasses.replace(jcfg, scan_layers=scan)
    cfg = dataclasses.replace(cfg, scan_layers=scan)
    params = j_build(jcfg).init(jax.random.key(4))
    model = params_from_jax(params, cfg, device="cpu")
    back = to_numpy_tree(model)
    leaves = jax.tree_util.tree_leaves(params)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(leaves, jax.tree_util.tree_leaves(back)):
        assert np.array_equal(np.asarray(a, np.float32), b)
    assert model.layers[1].attn["wv"].dtype == DTYPES[dtype][1]
    wv1 = (params["layers"]["attn"]["wv"][1] if scan
           else params["layers"]["l1"]["attn"]["wv"])
    assert np.array_equal(np.asarray(wv1, np.float32),
                          model.layers[1].attn["wv"].float().numpy())


def test_cast_copies_every_weight():
    _, cfg = _smoke("bfloat16")
    model = build_model(cfg).init(torch.Generator().manual_seed(2),
                                  device="cpu")
    f32 = model.cast(torch.float32)
    assert f32.cfg.dtype == torch.float32
    assert model.layers[0].mlp["wi"].dtype == torch.bfloat16
    for a, b in zip(model.parameters(), f32.parameters()):
        assert b.dtype == torch.float32 and torch.equal(a.float(), b)


# ---------------------------------------------------------------------------
# What waits, and the configs
# ---------------------------------------------------------------------------

def test_the_unported_paths_raise_naming_their_item():
    """Nothing waits: the training loss (item 11c) runs in every family
    (its parity with JAX: tests/test_torch_train.py).  An encoder has no
    decode step and no cache; an unknown family or arch raises; llava's
    image tokens and the recurrent families serve."""
    _, cfg = _smoke("float32")
    model = build_model(cfg)
    with pytest.raises(ValueError, match="encoder-only"):
        model.decode_step(None, None)
    with pytest.raises(ValueError, match="encoder-only"):
        model.init_cache(1, 8, device="cpu")
    for arch in ("hubert_xlarge", "tinyllama_1_1b", "recurrentgemma_2b",
                 "xlstm_350m", "llava_next_34b"):
        c = get_arch(arch).SMOKE
        m = build_model(c).init(torch.Generator().manual_seed(0),
                                device="cpu")
        n = c.num_image_tokens
        batch = {"labels": torch.zeros((1, 16), dtype=torch.int32),
                 "mask": torch.ones((1, 16))}
        if c.embed_inputs or n:
            batch["tokens"] = torch.zeros((1, 16 - n), dtype=torch.int32)
        else:
            batch["embeds"] = torch.zeros((1, 16, c.d_model))
        if n:
            batch["image_embeds"] = torch.zeros((1, n, c.d_model))
        loss = m.loss(batch)
        assert loss.shape == () and bool(torch.isfinite(loss))
    causal = get_arch("tinyllama_1_1b").SMOKE
    llava = build_model(dataclasses.replace(causal, num_image_tokens=4))
    llava.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    image = torch.zeros((1, 4, causal.d_model))
    logits, cache = llava.prefill({"tokens": tokens, "image_embeds": image},
                                  max_len=12)
    assert logits.shape == (1, 1, causal.vocab)
    assert int(cache[0]["next"]) == 8
    for family, cls in (("griffin", GriffinLM), ("xlstm", XLSTMLM)):
        smoke = get_arch({"griffin": "recurrentgemma_2b",
                          "xlstm": "xlstm_350m"}[family]).SMOKE
        assert isinstance(build_model(smoke), cls)
    with pytest.raises(ValueError, match="griffin family"):
        GriffinLM(get_arch("xlstm_350m").SMOKE)
    with pytest.raises(ValueError, match="even number of layers"):
        XLSTMLM(dataclasses.replace(get_arch("xlstm_350m").SMOKE,
                                    num_layers=3))
    with pytest.raises(ValueError, match="unknown family"):
        build_model(dataclasses.replace(cfg, family="rnn"))


def test_get_arch_knows_only_the_ported_ids():
    """Every arch id of the JAX package is ported: the encoder, the
    transformer family's causal LMs, llava, recurrentgemma and xlstm."""
    assert get_arch("hubert-xlarge").NUM_CLASSES == 504
    assert PORTED_IDS == ARCH_IDS
    for arch in ARCH_IDS:
        assert get_arch(arch).CONFIG.name
        assert get_arch(arch.replace("_", "-")) is get_arch(arch)
    assert get_arch("llava_next_34b").NUM_IMAGE_TOKENS == 2880
    with pytest.raises(ValueError, match="unknown arch"):
        get_arch("bert")


def test_configs_match_jax():
    """Each ported config module field for field JAX's (MoE configs
    compared as dicts), its SKIPS, hubert's NUM_CLASSES and llava's
    NUM_IMAGE_TOKENS; the paper's HMM workloads."""
    for arch in PORTED_IDS:
        mod, j_mod = get_arch(arch), j_get_arch(arch)
        assert mod.SKIPS == j_mod.SKIPS, arch
        for name in ("NUM_CLASSES", "NUM_IMAGE_TOKENS"):
            assert getattr(mod, name, None) == getattr(j_mod, name, None)
        for which in ("CONFIG", "SMOKE"):
            ours = dataclasses.asdict(getattr(mod, which))
            theirs = dataclasses.asdict(getattr(j_mod, which))
            assert ours.pop("dtype") == torch.bfloat16
            assert theirs.pop("dtype") == jnp.bfloat16
            assert ours == theirs, (arch, which)
    for name in ("DEFAULT", "FORCED_ALIGNMENT"):
        assert dataclasses.asdict(getattr(paper_hmm, name)) == \
            dataclasses.asdict(getattr(j_paper_hmm, name))
    for name in ("SWEEP_K", "SWEEP_T", "SWEEP_P_EDGE", "SWEEP_B"):
        assert getattr(paper_hmm, name) == getattr(j_paper_hmm, name)
    assert paper_hmm.FORCED_ALIGNMENT.seq_len == 256


def test_init_without_device_raises_on_a_cpu_only_host():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = TransformerLM(ModelConfig("m", "transformer", 1, 8, 2, 2, 16, 4))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax({}, model.cfg)


def test_bf16_moves_as_far_from_float32_as_in_jax():
    """The bf16 encoder's distance from the same weights in float32 is the
    JAX package's own: JAX's init draws stacked layers with 1/sqrt(L), each
    product grows its input, and bf16's rounding moves the emissions (at
    12 layers, d 128, seed 0: mean 0.0983 in JAX, 0.0988 here).  The port
    must move as far as JAX, no farther: mean |diff| within 0.8-1.25x JAX's
    and max |diff| within 0.5-2x."""
    base = dict(num_layers=12, d_model=128, num_heads=4, num_kv_heads=4,
                head_dim=32, d_ff=512, vocab=512, q_block=64, kv_block=64)
    jcfg, cfg = _smoke("bfloat16")
    jcfg = dataclasses.replace(jcfg, **base)
    cfg = dataclasses.replace(cfg, **base)
    params = j_build(jcfg).init(jax.random.key(0))
    x = _rand(np.random.default_rng(0), 2, 64, 128)

    def jax_em(dtype):
        c = dataclasses.replace(jcfg, dtype=dtype)
        p = jax.tree_util.tree_map(lambda a: a.astype(dtype), params)
        logits, _ = j_build(c).prefill(p, {"embeds": jnp.asarray(x, dtype)})
        return np.asarray(jax.nn.log_softmax(logits[..., :504], axis=-1))

    def port_em(model):
        logits, _ = model.prefill({"embeds": torch.from_numpy(x)})
        return torch.log_softmax(logits[..., :504], dim=-1).numpy()

    model = params_from_jax(params, cfg, device="cpu")
    ours = np.abs(port_em(model) - port_em(model.cast(torch.float32)))
    theirs = np.abs(jax_em(jnp.bfloat16) - jax_em(jnp.float32))
    assert 0.8 <= ours.mean() / theirs.mean() <= 1.25, \
        (ours.mean(), theirs.mean())
    assert 0.5 <= ours.max() / theirs.max() <= 2.0, (ours.max(), theirs.max())
