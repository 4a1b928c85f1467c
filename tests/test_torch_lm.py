"""Parity of the port's causal-LM serving (`repro_torch.models`: the GQA /
MQA / sliding-window caches and decode, `banded_blockwise`, MLA, MoE, the
causal `prefill`, `decode_step` and `init_cache`; `repro_torch.configs`:
the nine causal-LM configs, llava's image tokens, the recurrent families
(their modules: tests/test_torch_hybrid.py) and `configs.base`) with the
JAX package's on the CPU.

Inputs are made once with numpy from a seed; weights are drawn by the JAX
package and carried across with `params_from_jax`, caches with
`cache_from_jax`, so both packages compute on the same numbers.
Tolerances:
  * exact: `gqa_init_cache`, `gqa_prefill_cache` (data movement only),
    the cache round trips, the layouts, `param_count` and
    `active_param_count`, and the input specs' shapes;
  * a single op in float32 (`gqa_decode`, `banded_blockwise`,
    `mla_forward`, `mla_decode`, `moe_forward`): rtol 1e-5, atol 1e-5, the
    bound of tests/test_torch_models.py (the libraries sum in other
    orders);
  * each SMOKE model in float32: prefill and decode logits within 2e-5 x
    max |logit| (the encoder's bound in tests/test_torch_models.py; 3e-7
    to 1e-5 measured over the six transformers, 8e-6 over llava and
    recurrentgemma), the cache's keys, values, latents and recurrent
    states within 2e-5 x their max |value|, positions exact, the greedy
    tokens equal.  xLSTM's SMOKE needs more (`F32_BOUNDS`): JAX's init
    scales a stacked leaf by 1/sqrt(units), so its mLSTM gates reach |log
    i| ~ 120, and the exponential input gate turns an input's relative
    error e into a relative error of about |log i| e in the decay matrix
    (one block: 3e-7 in, 4.5e-6 out); measured 3.97e-4 x max |logit| and
    7.25e-4 x the cache's max (the sLSTM's h), the bounds 1.5x those;
  * in bfloat16: max |diff| <= 0.08 x max |logit| and mean |diff| <= 0.01
    x max |logit| (the encoder's bf16 bounds there; 0.007-0.051 and
    0.0018-0.0079 measured).  The SMOKE models take the weights and tokens
    of tests/test_models_smoke.py's consistency test (its keys).  MoE
    routing is discrete, and XLA's fused elementwise chains round bf16 at
    other points than the port's eager ops, so a near-tie between two
    experts can route differently in the two packages: with weights from
    another key (moonshot SMOKE, `jax.random.key(4)`) one bf16 decode step
    differed by 0.14 / 0.020 with the greedy tokens still equal; float32
    holds its bound there too;
  * xLSTM's SMOKE in bfloat16 is chaotic in JAX itself: JAX's bf16 logits
    differ from its float32 ones by 0.80-1.05 x max |logit| and pick
    other greedy tokens at the first step, so neither the logits nor the
    tokens can match JAX's bf16 ones.  `test_xlstm_bf16_moves_as_far_as_jax`
    instead decodes JAX's float32 greedy tokens in both packages and holds
    the port's bf16 distance from JAX's float32 logits to JAX's own bf16
    distance (the rule of tests/test_torch_models.py's
    `test_bf16_moves_as_far_from_float32_as_in_jax`: mean within 0.8-1.25x,
    max within 0.5-2x; measured 0.95x and 1.18x), and
    `test_xlstm_bf16_on_fan_in_weights_matches_jax` holds it to JAX's bf16
    logits by the bf16 rule above on block matrices rescaled to std
    1/sqrt(d_in), where it is not chaotic;
  * `test_decode_matches_full_forward_tinyllama`: JAX's own test ported,
    atol and rtol 2e-2 in bfloat16 (its bound).
MoE routing must pick JAX's experts: on exact router ties (zero router
weights) the lower expert index first, and with capacity drops at decode
size the same assignments dropped.
"""

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import smoke_batch as j_smoke_batch
from repro.models import attention as ja
from repro.models import build_model as j_build
from repro.models import moe as jm
from repro_torch.configs import PORTED_IDS, get_arch
from repro_torch.configs.base import SHAPES, smoke_batch
from repro_torch.models import (build_model, cache_from_jax, cache_to_numpy,
                                params_from_jax)
from repro_torch.models import attention as ta
from repro_torch.models import moe as tm
from repro_torch.models.convert import _jax_layout

torch.set_num_threads(1)

LM_IDS = [a for a in PORTED_IDS if a != "hubert_xlarge"]
#: (logits, cache) bounds x max |value| in float32 where 2e-5 does not hold
#: (the module docstring)
F32_BOUNDS = {"xlstm_350m": (6e-4, 1.1e-3)}
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


def _params(layout, g):
    """Random float32 weights of a layout (normal leaves scaled by
    1/sqrt(fan in), vectors near 0)."""
    def build(lay):
        return {n: (build(v) if isinstance(v, dict) else
                    _rand(g, *v[0], scale=(v[0][-2] ** -0.5 if len(v[0]) > 1
                                           else 0.1)))
                for n, v in lay.items()}
    return build(layout)


def _same_cache(port_cache, j_cache, cfg, rel=None):
    """The port's cache against JAX's: positions exact, floating leaves
    exact (rel None) or within rel x their max |value|."""
    ours = cache_to_numpy(port_cache, cfg)
    theirs = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32)
                                    if np.asarray(a).dtype.kind not in "iu"
                                    else np.asarray(a), j_cache)
    assert jax.tree_util.tree_structure(ours) == \
        jax.tree_util.tree_structure(theirs)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ours),
                            jax.tree_util.tree_leaves(theirs)):
        assert a.shape == b.shape, path
        if rel is None or b.dtype.kind in "iu":
            assert np.array_equal(a, b), path
        else:
            assert np.abs(a - b).max() <= rel * np.abs(b).max(), path


# ---------------------------------------------------------------------------
# GQA caches and decode
# ---------------------------------------------------------------------------

def _acfg(**kw):
    base = dict(d_model=32, num_heads=4, num_kv_heads=2, head_dim=8,
                q_block=8, kv_block=8)
    base.update(kw)
    return ja.AttnConfig(**base), ta.AttnConfig(**base)


@pytest.mark.parametrize("window,max_len", [(None, 16), (8, 16), (8, 5),
                                            (32, 16)])
def test_gqa_init_cache_matches_jax(window, max_len):
    """A window-sized ring when the layer has a window (C = min(max_len,
    window)), else max_len slots; empty slots at position -1."""
    jcfg, cfg = _acfg(window=window)
    theirs = ja.gqa_init_cache(jcfg, 3, max_len, jnp.float32)
    ours = ta.gqa_init_cache(cfg, 3, max_len, torch.float32, "cpu")
    for k in theirs:
        assert ours[k].dtype == {"k": torch.float32, "v": torch.float32}.get(
            k, torch.int32)
        assert np.array_equal(ours[k].numpy(), np.asarray(theirs[k])), k


#: (S, window, max_len): padded (S < C), exactly full, rolled by a nonzero
#: shift, trimmed without a window, and danube SMOKE's window 8 at S = 16
#: and 24 (shift 0)
PREFILL_CACHE_CASES = [(5, None, 12), (12, None, 12), (20, 8, 32),
                       (13, 8, 32), (30, None, 12), (16, 8, 32),
                       (24, 8, 32), (3, 8, 32), (11, 6, 9)]


@pytest.mark.parametrize("case", PREFILL_CACHE_CASES, ids=str)
def test_gqa_prefill_cache_matches_jax(case):
    S, window, max_len = case
    jcfg, cfg = _acfg(window=window)
    g = np.random.default_rng(10)
    kv = {"k": _rand(g, 2, S, 16), "v": _rand(g, 2, S, 16)}
    (jkv, jpos), (tkv, _) = _both((kv, np.arange(S, dtype=np.int32)))
    theirs = ja.gqa_prefill_cache(jcfg, jkv, jpos, max_len)
    ours = ta.gqa_prefill_cache(cfg, tkv, max_len)
    for k in theirs:
        assert np.array_equal(ours[k].numpy(), np.asarray(theirs[k])), k
    assert ours["pos"].dtype == ours["next"].dtype == torch.int32


@pytest.mark.parametrize("window,rope,hk", [(None, True, 2), (6, True, 2),
                                            (6, False, 1), (None, True, 4)])
def test_gqa_decode_matches_jax(window, rope, hk):
    """A prefill's cache, then 12 single-position steps (past the window of
    6: the ring wraps twice); each step's output and the whole cache
    against JAX's, which the port updates in place."""
    jcfg, cfg = _acfg(window=window, use_rope=rope, num_kv_heads=hk)
    g = np.random.default_rng(11)
    p = _params(ja.attn_layout(jcfg), g)
    S, max_len = 8, 24
    x = _rand(g, 2, S + 12, 32)
    (jp, jx), (tp, tx) = _both((p, x))
    pos = np.arange(S)
    _, jkv = ja.gqa_forward(jp, jx[:, :S], jnp.asarray(pos), jcfg)
    _, tkv = ta.gqa_forward(tp, tx[:, :S], torch.from_numpy(pos), cfg)
    jc = ja.gqa_prefill_cache(jcfg, jkv, jnp.asarray(pos), max_len)
    tc = ta.gqa_prefill_cache(cfg, tkv, max_len)
    j_decode = jax.jit(ja.gqa_decode, static_argnums=3)
    for t in range(S, S + 12):
        jo, jc = j_decode(jp, jx[:, t:t + 1], jc, jcfg)
        to, tc2 = ta.gqa_decode(tp, tx[:, t:t + 1], tc, cfg)
        assert tc2 is tc
        _close(to, jo)
        for k in ("pos", "next"):
            assert np.array_equal(tc[k].numpy(), np.asarray(jc[k])), (t, k)
        for k in ("k", "v"):
            _close(tc[k], jc[k])


# ---------------------------------------------------------------------------
# banded_blockwise and MLA
# ---------------------------------------------------------------------------

#: (S, q_block, kv_block, window): four bands of two q blocks, one band of
#: one q block, S not splitting into bands (one band), a window
BANDED_CASES = [(32, 4, 8, None), (16, 4, 4, None), (24, 8, 8, None),
                (32, 8, 8, 5)]


@pytest.mark.parametrize("case", BANDED_CASES, ids=str)
def test_banded_blockwise_matches_jax(case):
    S, qb, kb, window = case
    g = np.random.default_rng(12)
    q, k, v = _rand(g, 2, S, 3, 8), _rand(g, 2, S, 24), _rand(g, 2, S, 24)
    (jq, jk, jv, jpos), (tq, tk, tv, tpos) = _both((q, k, v, np.arange(S)))

    def heads(kv):
        return tuple(a.reshape(a.shape[0], a.shape[1], 3, 8) for a in kv)

    kw = dict(window=window, q_block=qb, kv_block=kb, scale=0.3, q_offset=0)
    _close(ta.banded_blockwise(tq, (tk, tv), heads, kv_positions=tpos, **kw),
           ja.banded_blockwise(jq, (jk, jv), heads, kv_positions=jpos, **kw))


@pytest.mark.parametrize("mla", [False, True])
def test_banded_schedule_through_the_forward_matches_jax(mla):
    """``causal_schedule="banded"`` through `gqa_forward` and
    `mla_forward` (S = 32 >= 4 q blocks of 8)."""
    extra = (dict(q_lora=24, kv_lora=16, rope_head_dim=4, v_head_dim=6)
             if mla else {})
    jcfg, cfg = _acfg(causal_schedule="banded", **extra)
    g = np.random.default_rng(13)
    p = _params(ja.attn_layout(jcfg), g)
    (jp, jx, jpos), (tp, tx, tpos) = _both((p, _rand(g, 2, 32, 32),
                                            np.arange(32)))
    jfwd, tfwd = ((ja.mla_forward, ta.mla_forward) if mla else
                  (ja.gqa_forward, ta.gqa_forward))
    _close(tfwd(tp, tx, tpos, cfg)[0], jfwd(jp, jx, jpos, jcfg)[0])


MLA_KW = dict(q_lora=24, kv_lora=16, rope_head_dim=4, v_head_dim=6)


def test_mla_layout_and_forward_match_jax():
    jcfg, cfg = _acfg(num_kv_heads=4, **MLA_KW)
    assert ta.attn_layout(cfg) == ja.attn_layout(jcfg)
    g = np.random.default_rng(14)
    p = _params(ja.attn_layout(jcfg), g)
    p["q_norm"], p["kv_norm"] = _rand(g, 24, scale=0.1), _rand(g, 16,
                                                             scale=0.1)
    (jp, jx, jpos), (tp, tx, tpos) = _both((p, _rand(g, 2, 16, 32),
                                            np.arange(16)))
    jo, jlat = ja.mla_forward(jp, jx, jpos, jcfg)
    to, tlat = ta.mla_forward(tp, tx, tpos, cfg)
    _close(to, jo)
    _close(tlat, jlat)
    assert tlat.shape == (2, 16, 16 + 4)


def test_mla_decode_matches_jax():
    """The absorbed-form decode over 6 steps from an initial cache."""
    jcfg, cfg = _acfg(num_kv_heads=4, **MLA_KW)
    g = np.random.default_rng(15)
    p = _params(ja.attn_layout(jcfg), g)
    (jp, jx), (tp, tx) = _both((p, _rand(g, 2, 6, 32)))
    jc = ja.mla_init_cache(jcfg, 2, 8, jnp.float32)
    tc = ta.mla_init_cache(cfg, 2, 8, torch.float32, "cpu")
    j_decode = jax.jit(ja.mla_decode, static_argnums=3)
    for t in range(6):
        jo, jc = j_decode(jp, jx[:, t:t + 1], jc, jcfg)
        to, tc = ta.mla_decode(tp, tx[:, t:t + 1], tc, cfg)
        _close(to, jo)
        _close(tc["latent"], jc["latent"])
        assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        assert int(tc["next"]) == int(jc["next"])


def test_mla_prefill_cache_keeps_every_position():
    lat = torch.zeros((1, 9, 5))
    c = ta.mla_prefill_cache(lat, 12)
    assert c["latent"].shape == (1, 12, 5) and int(c["next"]) == 9
    assert c["pos"].tolist() == list(range(9)) + [-1, -1, -1]
    with pytest.raises(ValueError, match="max_len"):
        ta.mla_prefill_cache(lat, 8)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

#: (B, S, experts, top_k, shared, num_groups, zero router): prefill size
#: (capacity above 1), decode size (B = 3: capacity 1, assignments
#: dropped), groups of 2, shared experts, exact router ties
MOE_CASES = [(2, 8, 8, 2, 0, 1, False), (3, 1, 8, 2, 0, 1, False),
             (2, 8, 8, 2, 1, 2, False), (2, 6, 16, 6, 2, 1, False),
             (2, 8, 8, 2, 0, 1, True), (4, 1, 8, 3, 1, 2, True),
             (8, 1, 64, 6, 0, 1, False)]


@pytest.mark.parametrize("case", MOE_CASES, ids=str)
def test_moe_forward_matches_jax(case):
    B, S, E, K, shared, G, zero = case
    kw = dict(num_experts=E, top_k=K, d_ff_expert=16, num_shared=shared,
              num_groups=G)
    jcfg, cfg = jm.MoEConfig(**kw), tm.MoEConfig(**kw)
    assert tm.moe_layout(32, cfg) == jm.moe_layout(32, jcfg)
    g = np.random.default_rng(16)
    p = _params(jm.moe_layout(32, jcfg), g)
    if zero:      # every router probability 1/E: ties everywhere
        p["router"] = np.zeros_like(p["router"])
    (jp, jx), (tp, tx) = _both((p, _rand(g, B, S, 32)))
    jo, jaux = jm.moe_forward(jp, jx, jcfg)
    to, taux = tm.moe_forward(tp, tx, cfg)
    _close(to, jo)
    _close(taux, jaux)


def test_moe_capacity_drops_assignments_as_jax():
    """Two equal tokens pick the same two of 4 experts at a capacity of
    1: only the first assignment to an expert in flat (token, slot) order
    survives, so the first token keeps both and the second loses both, as
    in JAX."""
    kw = dict(num_experts=4, top_k=2, d_ff_expert=8)
    jcfg, cfg = jm.MoEConfig(**kw), tm.MoEConfig(**kw)
    g = np.random.default_rng(17)
    p = _params(jm.moe_layout(16, jcfg), g)
    x = np.repeat(_rand(g, 1, 1, 16), 2, axis=0)  # two equal tokens: C = 1
    (jp, jx), (tp, tx) = _both((p, x))
    jo, _ = jm.moe_forward(jp, jx, jcfg)
    to, _ = tm.moe_forward(tp, tx, cfg)
    _close(to, jo)
    alone, _ = tm.moe_forward(tp, tx[:1], cfg)
    assert torch.allclose(to[0], alone[0])          # the first keeps both
    assert not torch.allclose(to[1], alone[0])      # the second loses both


def test_moe_group_count_must_divide_the_tokens():
    cfg = tm.MoEConfig(num_experts=4, top_k=1, d_ff_expert=8, num_groups=3)
    with pytest.raises(ValueError, match="groups"):
        tm.moe_forward({}, torch.zeros((2, 2, 8)), cfg)


# ---------------------------------------------------------------------------
# The models
# ---------------------------------------------------------------------------

_JAX = {}


def _jax_model(arch: str, dtype: str):
    """(JAX cfg, JAX model, JAX params, port model, batch) of `arch`'s
    SMOKE in `dtype`: the weights and the batch (numpy: tokens (2, 16), or
    (2, 16 - N_img) and llava's (2, N_img, d) image embeddings) of
    tests/test_models_smoke.py's consistency test, memoised."""
    key = (arch, dtype)
    if key not in _JAX:
        jd, td = DTYPES[dtype]
        jcfg = dataclasses.replace(j_get_arch(arch).SMOKE, dtype=jd)
        cfg = dataclasses.replace(get_arch(arch).SMOKE, dtype=td)
        jmodel = j_build(jcfg)
        k1, k2 = jax.random.split(
            jax.random.key(1 + zlib.crc32(arch.encode()) % 2**31))
        params = jmodel.init(k1)
        kw = ({"num_image_tokens": jcfg.num_image_tokens}
              if jcfg.num_image_tokens else {})
        jb = j_smoke_batch(jcfg, k2, batch=2, seq=16, **kw)
        batch = {"tokens": np.array(jb["tokens"], np.int32)}
        if "image_embeds" in jb:
            batch["image_embeds"] = np.array(jb["image_embeds"], np.float32)
        _JAX[key] = (jcfg, _Jitted(jmodel), params,
                     params_from_jax(params, cfg, device="cpu"), batch)
    return _JAX[key]


def _batches(batch: dict, jdtype):
    """(JAX batch, port batch) of a numpy batch: image embeddings in the
    JAX model's dtype (exact: they were drawn in it)."""
    jbatch = {k: jnp.asarray(v, jdtype if k == "image_embeds" else None)
              for k, v in batch.items()}
    return jbatch, {k: torch.from_numpy(v) for k, v in batch.items()}


class _Jitted:
    """A JAX model's prefill and decode_step under `jax.jit` (traced once
    a shape, where eager calls trace their layer scans anew each time)."""

    def __init__(self, jmodel):
        self.prefill = jax.jit(jmodel.prefill, static_argnames="max_len")
        self.decode_step = jax.jit(jmodel.decode_step)


def _tokens(cfg, B=2, S=16, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S),
                                                dtype=np.int32)


def _check_logits(ours, theirs, dtype, bound: float = 2e-5):
    ref = np.asarray(theirs, np.float32)
    err = np.abs(ours.numpy() - ref)
    scale = np.abs(ref).max()
    if dtype == "float32":
        assert err.max() <= bound * scale, err.max() / scale
    else:
        assert err.max() <= 0.08 * scale and err.mean() <= 0.01 * scale, \
            (err.max() / scale, err.mean() / scale)


#: every (arch, dtype) but xLSTM in bf16 (the module docstring)
SMOKE_CASES = [(a, d) for a in LM_IDS for d in DTYPES
               if (a, d) != ("xlstm_350m", "bfloat16")]


def _greedy_against_jax(jmodel, params, model, batch, dtype: str,
                       f32_bounds=(2e-5, 2e-5)):
    """A prefill (max_len 32) and 3 greedy decode steps in both packages:
    logits by `_check_logits`, the greedy tokens that feed the steps equal;
    in float32 the last step's greedy tokens too, and the caches within
    `f32_bounds`' second x their max |value|."""
    f32_logits, f32_cache = f32_bounds
    jbatch, tbatch = _batches(batch, jnp.bfloat16 if dtype == "bfloat16"
                              else jnp.float32)
    lj, cj = jmodel.prefill(params, jbatch, max_len=32)
    lt, ct = model.prefill(tbatch, max_len=32)
    assert lt.shape == (2, 1, model.cfg.vocab) and lt.dtype == torch.float32
    _check_logits(lt, lj, dtype, f32_logits)
    if dtype == "float32":
        _same_cache(ct, cj, model.cfg, rel=f32_cache)
    tj = jnp.argmax(lj[:, -1], -1)[:, None]
    tt = lt[:, -1].argmax(-1, keepdim=True)
    for _ in range(3):
        assert np.array_equal(np.asarray(tj), tt.numpy())
        lj, cj = jmodel.decode_step(params, tj, cj)
        lt, ct = model.decode_step(tt, ct)
        _check_logits(lt, lj, dtype, f32_logits)
        tj = jnp.argmax(lj[:, -1], -1)[:, None]
        tt = lt[:, -1].argmax(-1, keepdim=True)
    if dtype == "float32":
        assert np.array_equal(np.asarray(tj), tt.numpy())
        _same_cache(ct, cj, model.cfg, rel=f32_cache)


@pytest.mark.parametrize("arch,dtype", SMOKE_CASES)
def test_smoke_prefill_and_greedy_decode_match_jax(arch, dtype):
    """SMOKE's prefill (B, S) = (2, 16), max_len 32 (danube's and
    recurrentgemma's windows of 8: rings), then 3 greedy decode steps, as
    tests/test_models_smoke.py drives it: logits, caches and tokens against
    JAX's."""
    _, jmodel, params, model, batch = _jax_model(arch, dtype)
    _greedy_against_jax(jmodel, params, model, batch, dtype,
                        F32_BOUNDS.get(arch, (2e-5, 2e-5)))


def _fan_in(units: dict, n_units: int) -> dict:
    """JAX's stacked xLSTM units with each block matrix (a leaf of 3 axes:
    units, d_in, ...) rescaled from JAX's init std 1/sqrt(units) to
    1/sqrt(d_in), as chip_smoke.py's `fan_in_weights` does on the card; in
    float32 and cast back, so both packages take the same values."""
    def scale(a):
        if a.ndim < 3:
            return a
        f = np.float32(np.sqrt(n_units / a.shape[1]))
        return jnp.asarray(np.asarray(a, np.float32) * f, a.dtype)
    return jax.tree_util.tree_map(scale, units)


def test_xlstm_bf16_on_fan_in_weights_matches_jax():
    """xLSTM SMOKE in bf16 on its block matrices rescaled to std
    1/sqrt(d_in) (`_fan_in`), where it is not chaotic: the prefill and 3
    greedy steps as `test_smoke_prefill_and_greedy_decode_match_jax`,
    logits within `_check_logits`'s bf16 rule of JAX's bf16 logits
    (measured max 0.021-0.041 and mean 0.0042-0.0087 x max |logit|), the
    greedy tokens that feed the steps equal.  As there, the last step's
    tokens are compared in float32 only: here the port's bf16 logits of
    sequence 0 tie exactly (0.3984375) between tokens 31 and 128, which
    JAX's put 1.5 bf16 ulp apart."""
    jcfg, jmodel, params, _, batch = _jax_model("xlstm_350m", "bfloat16")
    params = dict(params, units=_fan_in(params["units"],
                                        jcfg.num_layers // 2))
    cfg = dataclasses.replace(get_arch("xlstm_350m").SMOKE,
                              dtype=torch.bfloat16)
    _greedy_against_jax(jmodel, params,
                        params_from_jax(params, cfg, device="cpu"), batch,
                        "bfloat16")


def test_xlstm_bf16_moves_as_far_as_jax():
    """xLSTM SMOKE in bf16 (the module docstring): both packages prefill
    the same batch and decode JAX's float32 greedy tokens for 3 steps; the
    port's bf16 logits lie as far from JAX's float32 ones as JAX's bf16
    logits do, no farther (mean |diff| within 0.8-1.25x JAX's, max within
    0.5-2x, over the prefill and the steps)."""
    arch = "xlstm_350m"
    jcfg, j16, params, model, batch = _jax_model(arch, "bfloat16")
    j32 = _Jitted(j_build(dataclasses.replace(jcfg, dtype=jnp.float32)))
    p32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), params)
    jbatch, tbatch = _batches(batch, jnp.bfloat16)
    l32, c32 = j32.prefill(p32, jbatch, max_len=32)
    l16, c16 = j16.prefill(params, jbatch, max_len=32)
    lt, ct = model.prefill(tbatch, max_len=32)
    outs = [(l32, l16, lt)]
    for _ in range(3):
        tok = jnp.argmax(l32[:, -1], -1)[:, None]
        l32, c32 = j32.decode_step(p32, tok, c32)
        l16, c16 = j16.decode_step(params, tok, c16)
        lt, ct = model.decode_step(torch.from_numpy(np.array(tok)), ct)
        outs.append((l32, l16, lt))
    ref, theirs, ours = (np.concatenate([np.asarray(o[i], np.float32)
                                         for o in outs]) for i in range(3))
    ours = np.abs(ours - ref)
    theirs = np.abs(theirs - ref)
    assert 0.8 <= ours.mean() / theirs.mean() <= 1.25, \
        (ours.mean(), theirs.mean())
    assert 0.5 <= ours.max() / theirs.max() <= 2.0, (ours.max(), theirs.max())


def test_danube_rolled_prefill_then_decode_matches_jax():
    """danube SMOKE with blocks of 4: a prefill of 12 positions into its
    window-8 ring is rolled by 4 (start 4), then 10 steps wrap it."""
    jcfg, _, params, _, _ = _jax_model("h2o_danube_3_4b", "float32")
    jcfg = dataclasses.replace(jcfg, q_block=4, kv_block=4)
    cfg = dataclasses.replace(get_arch("h2o_danube_3_4b").SMOKE,
                              dtype=torch.float32, q_block=4, kv_block=4)
    model = params_from_jax(params, cfg, device="cpu")
    jmodel = _Jitted(j_build(jcfg))
    toks = _tokens(cfg, S=22, seed=5)
    lj, cj = jmodel.prefill(params, {"tokens": jnp.asarray(toks[:, :12])},
                            max_len=24)
    lt, ct = model.prefill({"tokens": torch.from_numpy(toks[:, :12])},
                           max_len=24)
    assert ct[0]["pos"].tolist() == [8, 9, 10, 11, 4, 5, 6, 7]
    _same_cache(ct, cj, cfg, rel=2e-5)
    for t in range(12, 22):
        lj, cj = jmodel.decode_step(params, jnp.asarray(toks[:, t:t + 1]),
                                    cj)
        lt, ct = model.decode_step(torch.from_numpy(toks[:, t:t + 1]), ct)
        _check_logits(lt, lj, "float32")
    _same_cache(ct, cj, cfg, rel=2e-5)


@pytest.mark.parametrize("arch", ["granite_8b", "deepseek_v2_236b"])
def test_a_jax_cache_decodes_in_the_port_as_in_jax(arch):
    """JAX's prefill cache carried by `cache_from_jax` and stepped by the
    port's `decode_step` gives JAX's own decode_step logits."""
    _, jmodel, params, model, _ = _jax_model(arch, "float32")
    toks = _tokens(model.cfg, seed=3)
    _, cj = jmodel.prefill(params, {"tokens": jnp.asarray(toks)}, max_len=24)
    ct = cache_from_jax(cj, model.cfg, device="cpu")
    nxt = toks[:, :1]
    lj, cj = jmodel.decode_step(params, jnp.asarray(nxt), cj)
    lt, ct = model.decode_step(torch.from_numpy(nxt), ct)
    _check_logits(lt, lj, "float32")
    _same_cache(ct, cj, model.cfg, rel=2e-5)


@pytest.mark.parametrize("dtype,scan", [("bfloat16", True),
                                        ("float32", True),
                                        ("bfloat16", False)])
@pytest.mark.parametrize("arch", ["gemma_2b", "deepseek_v2_236b"])
def test_cache_round_trip(arch, dtype, scan):
    """JAX's cache -> the port's (one dict a layer) -> JAX's layout is
    exact (bfloat16 by its bits), for stacked and per-layer caches (JAX's
    prefill stacks its per-layer dicts only when it scans, so the
    per-layer cache is the stacked one's slices)."""
    jd, td = DTYPES[dtype]
    jcfg = dataclasses.replace(j_get_arch(arch).SMOKE, dtype=jd)
    cfg = dataclasses.replace(get_arch(arch).SMOKE, dtype=td,
                              scan_layers=scan)
    jmodel = j_build(jcfg)
    params = jmodel.init(jax.random.key(2))
    _, cj = jmodel.prefill(params, {"tokens": jnp.asarray(_tokens(cfg))},
                           max_len=20)
    if not scan:
        cj = [jax.tree_util.tree_map(lambda a: a[i], cj)
              for i in range(cfg.num_layers)]
    ct = cache_from_jax(cj, cfg, device="cpu")
    assert len(ct) == cfg.num_layers
    assert all(t.dtype == (torch.int32 if k in ("pos", "next") else td)
               for c in ct for k, t in c.items())
    _same_cache(ct, cj, cfg)
    again = cache_from_jax(cache_to_numpy(ct, cfg), cfg, device="cpu")
    for a, b in zip(ct, again):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_init_cache_matches_jax():
    for arch in ("h2o_danube_3_4b", "deepseek_v2_236b"):
        jcfg, cfg = j_get_arch(arch).SMOKE, get_arch(arch).SMOKE
        theirs = j_build(jcfg).init_cache(3, 20)
        ours = build_model(cfg).init_cache(3, 20, device="cpu")
        _same_cache(ours, theirs, cfg)
        assert ours[0]["pos"].shape == ((8,) if cfg.window else (20,))


def test_decode_matches_full_forward_tinyllama():
    """tests/test_models_smoke.py's check on the port: stepwise decode
    logits == teacher-forced logits (bf16, its tolerance)."""
    cfg = get_arch("tinyllama_1_1b").SMOKE
    model = build_model(cfg).init(torch.Generator().manual_seed(4),
                                  device="cpu")
    toks = torch.from_numpy(_tokens(cfg, B=1, S=8, seed=4))
    full_logits, _ = model.prefill({"tokens": toks}, max_len=16)
    _, cache = model.prefill({"tokens": toks[:, :7]}, max_len=16)
    step_logits, _ = model.decode_step(toks[:, 7:8], cache)
    np.testing.assert_allclose(step_logits[0, 0].numpy(),
                               full_logits[0, 0].numpy(), atol=2e-2,
                               rtol=2e-2)


def test_gemma_scales_its_embeddings_by_the_rounded_root():
    """sqrt(2048) rounds to 45.25 in bf16 before the multiply, as JAX's
    ``jnp.asarray(math.sqrt(d), dtype)`` does, and the head is the tied
    embedding's transpose."""
    cfg = dataclasses.replace(get_arch("gemma_2b").SMOKE, d_model=2048,
                              num_layers=1, vocab=8)
    model = build_model(cfg).init(torch.Generator().manual_seed(0),
                                  device="cpu")
    x = model._inputs({"tokens": torch.tensor([[3]])})
    assert torch.equal(x, model.embed[3][None, None] * torch.tensor(
        45.25, dtype=torch.bfloat16))
    assert model._head().shape == (2048, 8) and model.head is None


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", LM_IDS)
def test_layout_and_param_counts_match_jax(arch, which):
    """From the layouts alone, nothing allocated."""
    cfg = getattr(get_arch(arch), which)
    jmodel = j_build(getattr(j_get_arch(arch), which))
    model = build_model(cfg)
    assert model.layout() == jmodel.layout()
    assert model.param_count() == jmodel.param_count()
    assert model.active_param_count() == jmodel.active_param_count()
    assert list(model.parameters()) == []


def test_the_full_configs_have_their_published_sizes():
    counts = {a: build_model(get_arch(a).CONFIG).param_count()
              for a in LM_IDS}
    assert counts == {"tinyllama_1_1b": 1_100_048_384,
                      "granite_8b": 8_254_689_280,
                      "gemma_2b": 2_506_172_416,
                      "h2o_danube_3_4b": 3_961_839_360,
                      "moonshot_v1_16b_a3b": 28_057_995_264,
                      "deepseek_v2_236b": 239_375_569_920,
                      "recurrentgemma_2b": 2_894_574_080,
                      "xlstm_350m": 431_064_160,
                      "llava_next_34b": 34_388_917_248}


def _shape_dtype(a) -> tuple:
    return tuple(a.shape), str(a.dtype).removeprefix("torch.")


def _stacked_shape(items: list) -> tuple:
    """The (shape, dtype) of equal leaves stacked on a new axis 0."""
    (shape, dtype), = set(items)
    return (len(items), *shape), dtype


def test_input_specs_cell_count():
    """tests/test_models_smoke.py's count over every id: each (arch x
    shape) cell runnable or documented, each runnable one with JAX's kind,
    shapes and dtypes (the decode cache per layer or unit, JAX's stacked:
    compared in JAX's layout by `cache_to_numpy`'s mapping, `_jax_layout`),
    as meta tensors."""
    total = runnable = skipped = 0
    assert SHAPES == J_SHAPES
    for arch in PORTED_IDS:
        mod, j_mod = get_arch(arch), j_get_arch(arch)
        for shape in SHAPES:
            total += 1
            spec, j_spec = mod.input_specs(shape), j_mod.input_specs(shape)
            if spec is None:
                assert shape in mod.SKIPS and j_spec is None
                skipped += 1
                continue
            runnable += 1
            assert (spec.kind, spec.seq_len, spec.batch) == \
                (j_spec.kind, j_spec.seq_len, j_spec.batch)
            args = dict(spec.args)
            if spec.kind == "decode":
                cache = args.pop("cache")
                assert all(jax.tree_util.tree_leaves(_jax_layout(
                    cache, mod.CONFIG, lambda t: t.is_meta, all)))
                ours = _jax_layout(cache, mod.CONFIG, _shape_dtype,
                                   _stacked_shape)
                assert ours == jax.tree_util.tree_map(
                    _shape_dtype, j_spec.args["cache"]), (arch, shape)
            ours = jax.tree_util.tree_map(_shape_dtype, args)
            theirs = {k: v for k, v in j_spec.args.items() if k != "cache"}
            assert ours == jax.tree_util.tree_map(_shape_dtype, theirs)
            assert all(a.is_meta for a in jax.tree_util.tree_leaves(args))
    assert total == 40
    assert runnable == 32 and skipped == 8


def test_smoke_batch_draws_from_a_numpy_generator():
    cfg = get_arch("granite_8b").SMOKE
    a = smoke_batch(cfg, np.random.default_rng(0), device="cpu")
    b = smoke_batch(cfg, np.random.default_rng(0), device="cpu")
    assert a["tokens"].shape == (2, 16) and a["tokens"].dtype == torch.int32
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert int(a["tokens"].max()) < cfg.vocab
    e = smoke_batch(get_arch("hubert_xlarge").SMOKE,
                    np.random.default_rng(0), embeds=True, device="cpu")
    assert e["embeds"].shape == (2, 16, 64)
    assert e["embeds"].dtype == torch.bfloat16
    v = smoke_batch(get_arch("llava_next_34b").SMOKE,
                    np.random.default_rng(0), num_image_tokens=8,
                    device="cpu")
    assert v["tokens"].shape == (2, 8) and v["labels"].shape == (2, 16)
    assert v["image_embeds"].shape == (2, 8, 64)
    assert v["image_embeds"].dtype == torch.bfloat16


def test_no_cpu_fallback_for_the_cache_or_the_batch():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = build_model(get_arch("granite_8b").SMOKE)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init_cache(1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        smoke_batch(model.cfg, np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cache_from_jax({}, model.cfg)
