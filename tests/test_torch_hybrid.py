"""Parity of the port's recurrent families (`repro_torch.models.rglru`,
`xlstm`, `hybrid`: Griffin's RG-LRU block and xLSTM's mLSTM and sLSTM
blocks, their models' caches and conversion) with the JAX package's on the
CPU.

Inputs are made once with numpy from a seed and given to both packages;
the models' weights are drawn by the JAX package and carried across with
`params_from_jax`, caches with `cache_from_jax`.  Tolerances:
  * exact: the ``rglru_a`` init (bitwise JAX's, both dtypes), the causal
    conv in bfloat16 (the same ops, rounded at the same points), the
    layouts, the caches' shapes and positions, the round trips;
  * a single op or block in float32: rtol 1e-5, atol 1e-5, the bound of
    tests/test_torch_lm.py;
  * `rglru_scan` against JAX's `associative_scan`: the port's log-depth
    (Hillis-Steele) scan multiplies and adds in another order; measured
    max |diff| 6.0e-7 at S = 511 (3.0e-8, 1.8e-7, 4.8e-7 at S = 1, 7,
    64), inside the float32 bound above;
  * `mlstm_chunked` at S = 512: max |diff| within 7.6e-5 x max |value|,
    1.5x the measured 5.09e-5.  The cumulative log forget gate reaches
    |cumF| ~ 400 over 512 positions, so a cumsum's rounding (JAX's and
    torch's add in other orders) moves each decay exponent by ~1e-5, which
    exp turns into a relative error; against a float64 evaluation JAX is
    1.6e-5 and the port 4.1e-5 away (x max |value|);
  * in bfloat16, a block's outputs and states within 0.022 x their max
    |value|, 1.5x the largest measured (0.0038-0.0148 over the gates and
    the six block cases; XLA keeps a fused elementwise chain in float32
    where the port rounds each op to bfloat16);
  * the whole SMOKE models as tests/test_torch_lm.py holds them (xLSTM's
    float32 bounds of 6e-4 / 1.1e-3 x max |value| and why are in its
    docstring); the prefill and decode tests of every family's SMOKE are
    there (its `LM_IDS` take recurrentgemma and xlstm), these add the
    cache after every step, the chunked prefill (S = 512) and a JAX cache.
"""

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs.base import smoke_batch as j_smoke_batch
from repro.models import build_model as j_build
from repro.models import common as jcommon
from repro.models import rglru as jr
from repro.models import xlstm as jx
from repro_torch.configs import get_arch
from repro_torch.models import (StateCache, build_model, cache_from_jax,
                                cache_to_numpy, params_from_jax,
                                to_numpy_tree)
from repro_torch.models import common as tcommon
from repro_torch.models import rglru as tr
from repro_torch.models import xlstm as tx

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FAMILIES = {"griffin": "recurrentgemma_2b", "xlstm": "xlstm_350m"}
#: float32 bounds x max |value| of the SMOKE models' (logits, cache)
#: (tests/test_torch_lm.py's)
F32_BOUNDS = {"recurrentgemma_2b": (2e-5, 2e-5),
              "xlstm_350m": (6e-4, 1.1e-3)}


def _close(ours, theirs, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(ours.detach().float().numpy(),
                               np.asarray(theirs, np.float32),
                               rtol=rtol, atol=atol)


def _bf16_close(ours, theirs, rel=0.022):
    ref = np.asarray(theirs, np.float32)
    err = np.abs(ours.detach().float().numpy() - ref).max()
    assert err <= rel * np.abs(ref).max(), err / np.abs(ref).max()


def _rand(g, *shape, scale=1.0):
    return (g.standard_normal(shape) * scale).astype(np.float32)


def _both(tree, dtype: str = "float32"):
    """(JAX tree, torch tree) of one numpy tree, cast to `dtype`."""
    jd, td = DTYPES[dtype]
    return (jax.tree_util.tree_map(lambda a: jnp.asarray(a, jd), tree),
            jax.tree_util.tree_map(lambda a: torch.from_numpy(a).to(td),
                                   tree))


def _params(layout, g):
    """Random float32 weights of a layout: matrices scaled by 1/sqrt(fan
    in), vectors near 0, RG-LRU's ``lam`` JAX's init."""
    def build(lay):
        out = {}
        for n, v in lay.items():
            if isinstance(v, dict):
                out[n] = build(v)
            elif v[2] == "rglru_a":
                out[n] = np.asarray(jcommon._init_array(
                    None, v[0], "rglru_a", jnp.float32))
            else:
                out[n] = _rand(g, *v[0], scale=(v[0][-2] ** -0.5
                                                if len(v[0]) > 1 else 0.1))
        return out
    return build(layout)


RCFG = dict(d_model=32, d_rnn=48, conv_width=4)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_jax(with_state, dtype):
    g = np.random.default_rng(20)
    args = [_rand(g, 2, 9, 16), _rand(g, 4, 16, scale=0.5),
            _rand(g, 16, scale=0.1)]
    if with_state:
        args.append(_rand(g, 2, 3, 16))
    j, t = _both(args, dtype)
    jo, jtail = jr._causal_conv1d(*j)
    to, ttail = tr._causal_conv1d(*t)
    assert to.dtype == DTYPES[dtype][1]
    if dtype == "float32":
        _close(to, jo)
    else:      # the same bf16 ops in the same order: the same bits
        assert np.array_equal(to.float().numpy(), np.asarray(jo, np.float32))
    assert np.array_equal(ttail.float().numpy(), np.asarray(jtail,
                                                            np.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gates_match_jax(dtype):
    g = np.random.default_rng(21)
    cfg = jr.RGLRUConfig(**RCFG)
    p = _params(jr.rglru_layout(cfg), g)
    (jp, ju), (tp, tu) = _both((p, _rand(g, 2, 7, 48)), dtype)
    for ours, theirs in zip(tr._gates(tp, tu), jr._gates(jp, ju)):
        assert ours.dtype == torch.float32
        if dtype == "float32":
            _close(ours, theirs)
        else:
            _bf16_close(ours, theirs)


@pytest.mark.parametrize("S", [1, 7, 64, 511])
def test_rglru_scan_matches_associative_scan(S):
    """The log-depth scan against JAX's `associative_scan` (the module
    docstring's bound), and its last h against S steps of `rglru_step`."""
    g = np.random.default_rng(22)
    cfg = jr.RGLRUConfig(**RCFG)
    p = _params(jr.rglru_layout(cfg), g)
    (jp, ju), (tp, tu) = _both((p, _rand(g, 2, S, 48)))
    jh, jlast = jr.rglru_scan(jp, ju)
    th, tlast = tr.rglru_scan(tp, tu)
    _close(th, jh)
    _close(tlast, jlast)
    h = torch.zeros((2, 48))
    for t in range(S):
        _, h = tr.rglru_step(tp, tu[:, t:t + 1], h)
    _close(tlast, h)


def test_rglru_step_matches_jax():
    g = np.random.default_rng(23)
    cfg = jr.RGLRUConfig(**RCFG)
    p = _params(jr.rglru_layout(cfg), g)
    (jp, ju, jh), (tp, tu, th) = _both((p, _rand(g, 3, 1, 48),
                                        _rand(g, 3, 48)))
    for ours, theirs in zip(tr.rglru_step(tp, tu, th),
                            jr.rglru_step(jp, ju, jh)):
        _close(ours, theirs)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("step", [False, True])
def test_rglru_block_forward_matches_jax(step, dtype):
    """A prefill from scratch (S = 12), or one step against a state."""
    g = np.random.default_rng(24)
    jcfg, cfg = jr.RGLRUConfig(**RCFG), tr.RGLRUConfig(**RCFG)
    assert tr.rglru_layout(cfg) == jr.rglru_layout(jcfg)
    p = _params(jr.rglru_layout(jcfg), g)
    x = _rand(g, 2, 1 if step else 12, 32)
    state = ({"h": _rand(g, 2, 48), "conv": _rand(g, 2, 3, 48)} if step
             else None)
    (jp, jxx), (tp, txx) = _both((p, x), dtype)
    if step:
        jst = {"h": jnp.asarray(state["h"]),
               "conv": jnp.asarray(state["conv"], DTYPES[dtype][0])}
        tst = {"h": torch.from_numpy(state["h"]),
               "conv": torch.from_numpy(state["conv"]).to(DTYPES[dtype][1])}
    else:
        jst = tst = None
    jy, jnew = jr.block_forward(jp, jxx, jcfg, jst)
    ty, tnew = tr.block_forward(tp, txx, cfg, tst)
    check = _close if dtype == "float32" else _bf16_close
    check(ty, jy)
    check(tnew["h"], jnew["h"])
    assert tnew["h"].dtype == torch.float32
    check(tnew["conv"], jnew["conv"])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(64,), (3, 2560)])
def test_rglru_a_init_is_bitwise_jax(shape, dtype):
    """No random numbers: JAX's float64 values cast to the dtype and
    broadcast (a stacked leaf repeats the row)."""
    jd, td = DTYPES[dtype]
    theirs = np.asarray(jcommon._init_array(None, shape, "rglru_a", jd),
                        np.float32)
    ours = tcommon._init_tensor(shape, "rglru_a", td, None, "cpu")
    assert ours.dtype == td and ours.shape == shape
    assert np.array_equal(ours.float().numpy(), theirs)


def test_normal_init_scales_in_place_with_the_same_bits():
    """The float32 draw scaled in place, then cast: the bits of ``(draw *
    scale).to(dtype)`` from the same generator."""
    for dtype in (torch.float32, torch.bfloat16):
        ours = tcommon._init_tensor((3, 16, 8), "normal", dtype,
                                    torch.Generator().manual_seed(5), "cpu")
        draw = torch.randn((3, 16, 8), generator=torch.Generator()
                           .manual_seed(5), dtype=torch.float32)
        assert torch.equal(ours, (draw * (1.0 / 3 ** 0.5)).to(dtype))


# ---------------------------------------------------------------------------
# mLSTM and sLSTM
# ---------------------------------------------------------------------------

def _mlstm_inputs(g, B, S, H, hd):
    q, k, v = (_rand(g, B, S, H, hd) for _ in range(3))
    log_i = _rand(g, B, S, H)
    log_f = -np.logaddexp(0.0, -_rand(g, B, S, H)).astype(np.float32)
    return q, k, v, log_i, log_f


def test_mlstm_parallel_matches_jax():
    j, t = _both(_mlstm_inputs(np.random.default_rng(30), 2, 16, 4, 8))
    _close(tx.mlstm_parallel(*t), jx.mlstm_parallel(*j))


def test_mlstm_chunked_matches_jax_over_two_chunks():
    """S = 512: two chunks of 256 rows, each against every position (the
    module docstring's bound); the same numbers as the unchunked form."""
    j, t = _both(_mlstm_inputs(np.random.default_rng(31), 1, 512, 2, 4))
    ours = tx.mlstm_chunked(*t)
    _check_logits(ours, jx.mlstm_chunked(*j), 7.6e-5)
    assert torch.equal(ours, tx.mlstm_parallel(*t))


def test_mlstm_chunked_refuses_the_length_jax_cannot_reshape():
    j, t = _both(_mlstm_inputs(np.random.default_rng(32), 1, 511, 2, 4))
    with pytest.raises(TypeError):    # JAX: cannot reshape 256 rows to 511
        jx.mlstm_chunked(*j)
    with pytest.raises(ValueError, match="multiple of chunk"):
        tx.mlstm_chunked(*t)


def test_mlstm_step_and_final_state_match_jax():
    """Six steps from JAX's initial state (m = -1e30), then the state of a
    whole prefill (`_mlstm_final_state`), each leaf and output."""
    g = np.random.default_rng(33)
    j, t = _both(_mlstm_inputs(g, 2, 6, 4, 8))
    jst, tst = jx.init_mlstm_state(2, 4, 8), tx.init_mlstm_state(2, 4, 8)
    for s in range(6):
        jo, jst = jx.mlstm_step(*(a[:, s:s + 1] for a in j), jst)
        to, tst = tx.mlstm_step(*(a[:, s:s + 1] for a in t), tst)
        _close(to, jo)
        for n in jst:
            _close(tst[n], jst[n])
    jfin, tfin = jx._mlstm_final_state(*j), tx._mlstm_final_state(*t)
    for n in jfin:
        _close(tfin[n], jfin[n])
        _close(tfin[n], tst[n])


XCFG = dict(d_model=32, num_heads=4)


def test_slstm_scan_matches_jax():
    g = np.random.default_rng(34)
    cfg = jx.XLSTMConfig(**XCFG)
    p = _params(jx.slstm_layout(cfg), g)
    st = {"c": _rand(g, 2, 32), "n": np.abs(_rand(g, 2, 32)) + 1,
          "m": _rand(g, 2, 32), "h": _rand(g, 2, 32, scale=0.5)}
    (jp, jxx, jst), (tp, txx, tst) = _both((p, _rand(g, 2, 9, 32), st))
    jh, jfin = jx.slstm_scan(jp, jxx, jst)
    th, tfin = tx.slstm_scan(tp, txx, tst)
    _close(th, jh)
    for n in jfin:
        _close(tfin[n], jfin[n])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("block", ["mlstm", "slstm"])
@pytest.mark.parametrize("step", [False, True])
def test_xlstm_blocks_match_jax(block, step, dtype):
    """Each block from scratch (S = 10) or one step against a state: the
    output, the recurrent state and the conv tail."""
    g = np.random.default_rng(35)
    jcfg, cfg = jx.XLSTMConfig(**XCFG), tx.XLSTMConfig(**XCFG)
    lay = getattr(jx, f"{block}_layout")(jcfg)
    assert getattr(tx, f"{block}_layout")(cfg) == lay
    p = _params(lay, g)
    x = _rand(g, 2, 1 if step else 10, 32)
    (jp, jxx), (tp, txx) = _both((p, x), dtype)
    jst = tst = None
    if step:
        width = 64 if block == "mlstm" else 32
        if block == "mlstm":
            rec = {"C": _rand(g, 2, 4, 16, 16), "n": _rand(g, 2, 4, 16),
                   "m": _rand(g, 2, 4)}
        else:
            rec = {"c": _rand(g, 2, 32), "n": np.abs(_rand(g, 2, 32)) + 1,
                   "m": _rand(g, 2, 32), "h": _rand(g, 2, 32, scale=0.5)}
        conv = _rand(g, 2, 3, width)
        jd, td = DTYPES[dtype]
        jst = {"rec": jax.tree_util.tree_map(jnp.asarray, rec),
               "conv": jnp.asarray(conv, jd)}
        tst = {"rec": jax.tree_util.tree_map(torch.from_numpy, rec),
               "conv": torch.from_numpy(conv).to(td)}
    jy, jnew = getattr(jx, f"{block}_block")(jp, jxx, jcfg, jst)
    ty, tnew = getattr(tx, f"{block}_block")(tp, txx, cfg, tst)
    check = _close if dtype == "float32" else _bf16_close
    check(ty, jy)
    for n in jnew["rec"]:
        assert tnew["rec"][n].dtype == torch.float32
        check(tnew["rec"][n], jnew["rec"][n])
    check(tnew["conv"], jnew["conv"])


# ---------------------------------------------------------------------------
# The models
# ---------------------------------------------------------------------------

_JAX = {}


def _smoke(arch: str, dtype: str = "float32"):
    """(JAX model jitted, JAX params, port model, tokens (2, 16)) of
    `arch`'s SMOKE: the weights and tokens of tests/test_models_smoke.py's
    consistency test, memoised."""
    key = (arch, dtype)
    if key not in _JAX:
        jd, td = DTYPES[dtype]
        jcfg = dataclasses.replace(j_get_arch(arch).SMOKE, dtype=jd)
        cfg = dataclasses.replace(get_arch(arch).SMOKE, dtype=td)
        jmodel = j_build(jcfg)
        k1, k2 = jax.random.split(
            jax.random.key(1 + zlib.crc32(arch.encode()) % 2**31))
        params = jmodel.init(k1)
        toks = np.array(j_smoke_batch(jcfg, k2, batch=2, seq=16)["tokens"],
                        np.int32)
        jitted = (jax.jit(jmodel.prefill, static_argnames="max_len"),
                  jax.jit(jmodel.decode_step))
        _JAX[key] = (jitted, params, params_from_jax(params, cfg,
                                                     device="cpu"), toks)
    return _JAX[key]


def _check_logits(ours, theirs, bound):
    ref = np.asarray(theirs, np.float32)
    err = np.abs(ours.numpy() - ref).max()
    assert err <= bound * np.abs(ref).max(), err / np.abs(ref).max()


def _same_cache(port_cache, j_cache, cfg, rel=None):
    """The port's cache in JAX's layout against JAX's: integer leaves
    exact, floating ones exact (rel None) or within rel x their max
    |value|."""
    ours = cache_to_numpy(port_cache, cfg)
    theirs = jax.tree_util.tree_map(np.asarray, j_cache)
    assert jax.tree_util.tree_structure(ours) == \
        jax.tree_util.tree_structure(theirs)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ours),
                            jax.tree_util.tree_leaves(theirs)):
        assert a.shape == b.shape, path
        if b.dtype.kind in "iu":
            assert np.array_equal(a, b), path
            continue
        b = b.astype(np.float32)
        if rel is None:
            assert np.array_equal(a, b), path
        else:
            assert np.abs(a - b).max() <= rel * max(np.abs(b).max(), 1e-30), \
                (path, np.abs(a - b).max() / np.abs(b).max())


def _state_tensors(cache) -> list:
    """Every tensor of the cache but the attention layers' ``next`` (which
    `gqa_decode` replaces, as in the transformer's cache)."""
    return [t for entry in cache for path, t in
            jax.tree_util.tree_leaves_with_path(entry)
            if not ("pos" in entry and path[-1].key == "next")]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_smoke_cache_matches_jax_after_every_step(family):
    """SMOKE, float32: the prefill's cache and the cache after each of 4
    decode steps of JAX's greedy tokens (Griffin's window of 8 wraps its
    ring), every leaf against JAX's; the step updates the port's cache in
    place (the same list, entries and tensors) and advances ``next``."""
    arch = FAMILIES[family]
    (prefill, decode), params, model, toks = _smoke(arch)
    f32_logits, f32_cache = F32_BOUNDS[arch]
    lj, cj = prefill(params, {"tokens": jnp.asarray(toks)}, max_len=32)
    lt, ct = model.prefill({"tokens": torch.from_numpy(toks)}, max_len=32)
    assert isinstance(ct, StateCache) and int(ct.next) == 16
    _same_cache(ct, cj, model.cfg, rel=f32_cache)
    entries, states = list(ct), _state_tensors(ct)
    for step in range(4):
        tok = jnp.argmax(lj[:, -1], -1)[:, None]
        lj, cj = decode(params, tok, cj)
        out_logits, out = model.decode_step(torch.from_numpy(np.array(tok)),
                                            ct)
        assert out is ct and int(ct.next) == 17 + step
        _check_logits(out_logits, lj, f32_logits)
        _same_cache(ct, cj, model.cfg, rel=f32_cache)
    assert all(a is b for a, b in zip(entries, ct))
    assert all(a is b for a, b in zip(states, _state_tensors(ct)))


def test_xlstm_chunked_prefill_matches_jax():
    """xLSTM SMOKE's layers over S = 512 (two chunks of the parallel form,
    512 steps of each sequential loop), float32, B = 1; S = 511 raises in
    both packages.  The weights are `_params`' (each matrix scaled by
    1/sqrt(its d_in)): JAX's init scales a stacked leaf by 1/sqrt(units),
    and at S = 512 that model's logits lose every digit in float32 in both
    packages (1.41 x max |logit| from a float64 evaluation in JAX, 1.08 in
    the port).  Bounds as SMOKE's (measured here: 1.38e-5 x max |logit|,
    2.11e-5 x the cache's max)."""
    arch = "xlstm_350m"
    jcfg = dataclasses.replace(j_get_arch(arch).SMOKE, dtype=jnp.float32)
    jmodel = j_build(jcfg)
    params = _params(jmodel.layout(), np.random.default_rng(36))
    model = params_from_jax(params, dataclasses.replace(
        get_arch(arch).SMOKE, dtype=torch.float32), device="cpu")
    prefill = jax.jit(jmodel.prefill, static_argnames="max_len")
    toks = np.random.default_rng(36).integers(0, 256, (1, 512),
                                              dtype=np.int32)
    lj, cj = prefill(params, {"tokens": jnp.asarray(toks)}, max_len=512)
    lt, ct = model.prefill({"tokens": torch.from_numpy(toks)})
    _check_logits(lt, lj, F32_BOUNDS[arch][0])
    _same_cache(ct, cj, model.cfg, rel=F32_BOUNDS[arch][1])
    with pytest.raises(TypeError):
        prefill(params, {"tokens": jnp.asarray(toks[:, :511])}, max_len=511)
    with pytest.raises(ValueError, match="multiple of chunk"):
        model.prefill({"tokens": torch.from_numpy(toks[:, :511])})


@pytest.mark.parametrize("family", list(FAMILIES))
def test_a_jax_cache_decodes_in_the_port_as_in_jax(family):
    """JAX's prefill cache carried by `cache_from_jax` and stepped by the
    port's `decode_step` gives JAX's own decode_step logits and cache."""
    arch = FAMILIES[family]
    (prefill, decode), params, model, toks = _smoke(arch)
    f32_logits, f32_cache = F32_BOUNDS[arch]
    _, cj = prefill(params, {"tokens": jnp.asarray(toks)}, max_len=24)
    ct = cache_from_jax(cj, model.cfg, device="cpu")
    nxt = toks[:, :1]
    lj, cj = decode(params, jnp.asarray(nxt), cj)
    lt, ct = model.decode_step(torch.from_numpy(nxt), ct)
    _check_logits(lt, lj, f32_logits)
    _same_cache(ct, cj, model.cfg, rel=f32_cache)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_cache_round_trip(family, dtype):
    """JAX's cache -> the port's (one dict a layer or unit) -> JAX's layout
    is exact (bfloat16 by its bits), dtypes as the port's init_cache."""
    arch = FAMILIES[family]
    jd, td = DTYPES[dtype]
    jcfg = dataclasses.replace(j_get_arch(arch).SMOKE, dtype=jd)
    cfg = dataclasses.replace(get_arch(arch).SMOKE, dtype=td)
    jmodel = j_build(jcfg)
    params = jmodel.init(jax.random.key(2))
    toks = np.random.default_rng(37).integers(0, 256, (2, 16),
                                              dtype=np.int32)
    _, cj = jmodel.prefill(params, {"tokens": jnp.asarray(toks)}, max_len=20)
    ct = cache_from_jax(cj, cfg, device="cpu")
    empty = build_model(cfg).init_cache(2, 20, device="cpu")
    assert len(ct) == len(empty)
    pairs = list(zip(jax.tree_util.tree_leaves(list(ct)),
                     jax.tree_util.tree_leaves(list(empty))))
    assert all(a.dtype == b.dtype and a.shape == b.shape for a, b in pairs)
    _same_cache(ct, cj, cfg)
    again = cache_from_jax(cache_to_numpy(ct, cfg), cfg, device="cpu")
    assert torch.equal(again.next, ct.next)
    for a, b in zip(jax.tree_util.tree_leaves(list(ct)),
                    jax.tree_util.tree_leaves(list(again))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_init_cache_matches_jax(family):
    arch = FAMILIES[family]
    jcfg, cfg = j_get_arch(arch).SMOKE, get_arch(arch).SMOKE
    theirs = j_build(jcfg).init_cache(3, 20)
    ours = build_model(cfg).init_cache(3, 20, device="cpu")
    _same_cache(ours, theirs, cfg)
    meta = build_model(cfg).init_cache(3, 20, device="meta")
    assert meta.next.is_meta and all(
        t.is_meta for t in jax.tree_util.tree_leaves(list(meta)))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_weights_round_trip_and_cast(family):
    """JAX's tree -> the port -> JAX's tree is exact; `cast` copies every
    weight; the layout and counts are JAX's."""
    arch = FAMILIES[family]
    _, params, model, _ = _smoke(arch)
    jmodel = j_build(dataclasses.replace(j_get_arch(arch).SMOKE,
                                         dtype=jnp.float32))
    assert model.layout() == jmodel.layout()
    assert model.param_count() == jmodel.param_count() == \
        sum(p.numel() for p in model.parameters())
    back = to_numpy_tree(model)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(back)):
        assert np.array_equal(np.asarray(a), b)
    bf = model.cast(torch.bfloat16)
    assert bf.cfg.dtype == torch.bfloat16 and type(bf) is type(model)
    for a, b in zip(model.parameters(), bf.parameters()):
        assert b.dtype == torch.bfloat16 and torch.equal(a.bfloat16(), b)


def test_griffin_layers_follow_jax_units_and_tails():
    """Layer order (rec, rec, attn) x units, then the tail rec layers; the
    embedding scaled by sqrt(d) rounded to the dtype; the head tied."""
    _, params, model, _ = _smoke("recurrentgemma_2b")
    assert model.kinds == ["rec", "rec", "attn", "rec", "rec"]
    assert np.array_equal(model.blocks[2].tree()["mix"]["wq"].numpy(),
                          np.asarray(params["units"]["attn"]["mix"]["wq"][0]))
    assert np.array_equal(model.blocks[4].tree()["mix"]["w_x"].numpy(),
                          np.asarray(params["tail1"]["mix"]["w_x"]))
    x = model._embed(torch.tensor([[3]]))
    assert torch.equal(x, model.embed[3][None, None] * 8.0)


def test_xlstm_step_departs_from_its_prefill_in_jax_and_the_port_alike(
        monkeypatch):
    """A finding in the reference, which the port reproduces: JAX's mLSTM
    decode step normalises by max(|q . n|, exp(-m)) with n = sum of the
    gated keys, where the parallel form's n sums the gated scores q k /
    sqrt(hd), so a decode step after a prefill of S tokens does not give
    the logits of a prefill over S + 1 (float32, SMOKE's layers on
    `_params`' weights: measured 0.36097 x max |logit| at S = 16 in JAX,
    0.36097 in the port).
    The port's step and prefill each match JAX's, so its gap is JAX's; a
    step whose n sums k / sqrt(hd) (the k v product kept) closes it (4.3e-7
    measured), so the normaliser is the whole gap."""
    arch = "xlstm_350m"
    jcfg = dataclasses.replace(j_get_arch(arch).SMOKE, dtype=jnp.float32)
    jmodel = j_build(jcfg)
    params = _params(jmodel.layout(), np.random.default_rng(36))
    model = params_from_jax(params, dataclasses.replace(
        get_arch(arch).SMOKE, dtype=torch.float32), device="cpu")
    toks = np.random.default_rng(1).integers(0, 256, (2, 17), dtype=np.int32)
    prefill = jax.jit(jmodel.prefill)
    _, cj = prefill(params, {"tokens": jnp.asarray(toks[:, :16])})
    sj, _ = jax.jit(jmodel.decode_step)(params, jnp.asarray(toks[:, 16:]), cj)
    fj, _ = prefill(params, {"tokens": jnp.asarray(toks)})
    _, ct = model.prefill({"tokens": torch.from_numpy(toks[:, :16])})
    st, _ = model.decode_step(torch.from_numpy(toks[:, 16:]), ct)
    ft, _ = model.prefill({"tokens": torch.from_numpy(toks)})
    _check_logits(st, sj, 2e-5)
    _check_logits(ft, fj, 2e-5)
    gap_j = float(jnp.abs(sj - fj).max() / jnp.abs(fj).max())
    gap_t = float((st - ft).abs().max() / ft.abs().max())
    assert gap_j > 0.1 and abs(gap_t - gap_j) <= 1e-4 * gap_j, (gap_j, gap_t)
    step = tx.mlstm_step

    def scaled_n(q, k, v, log_i, log_f, state):
        r = q.shape[-1] ** 0.5
        return step(q, k / r, v * r, log_i, log_f, state)

    monkeypatch.setattr(tx, "mlstm_step", scaled_n)
    _, ct = model.prefill({"tokens": torch.from_numpy(toks[:, :16])})
    st, _ = model.decode_step(torch.from_numpy(toks[:, 16:]), ct)
    assert float((st - ft).abs().max() / ft.abs().max()) < 1e-5
