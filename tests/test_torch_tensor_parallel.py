"""Megatron compute over "model" (`sharding.tensor_parallel`, the pair of
sums `core.mesh.Mesh.reduce_from` / `copy_to`, and the tensor-parallel
paths of `models.attention.gqa_forward` / `mla_forward`,
`models.common.glu_mlp` / `mlp`, `models.moe`, `models.transformer`,
`models.rglru` and `models.xlstm`) against the port's unsharded functions,
on the CPU.  The sharded train
step that runs them is held against the single-process step and JAX's SPMD
step in tests/test_torch_train_sharded.py.

One gloo world of 2 CPU processes, a (data 1, model 2) mesh, runs every
case once on numpy inputs drawn from a seed; each rank holds the blocks its
specs give it.  Tolerances:
  * exact: `reduce_from` forward (the float32 sum of the two ranks' values;
    in bf16 that sum rounded once) and backward (the identity), `copy_to`
    forward (the identity) and backward (the float32 sum); the
    vocab-parallel embedding and its weight's gradient against
    `F.embedding`'s, in float32 and bf16; the cross entropy's value the same
    on both ranks; in bf16, `row`'s product and `column`'s input gradient
    as the two ranks' float32 partials summed and rounded once, and their
    other gradients as the plain bf16 products;
  * the vocab-parallel chunked cross entropy (a 0.8 mask, with and without
    `mask_count`) against `common.chunked_cross_entropy`: the value within
    rtol 1e-6 (measured 0), the gradients of the hidden states and of the
    head's block within 1e-6 x their largest |value| (float32 sums in
    another order; measured at most 1.4e-7);
  * exact: `row_products` (the RG-LRU's gate products) on two weights, in
    float32 and bf16: each rank's product is its columns of the two
    ranks' float32 partials summed and rounded once, its input's gradient
    the plain products of every column's gradient with its rows, and each
    weight's gradient its rows of the plain product with every column's
    gradient;
  * exact: `fused` (xLSTM's fused w_up) on integer inputs, in float32 and
    bf16: each rank's products are its span of each piece of the whole
    product, its input's gradient the whole gradient's product with the
    whole weight, its block's gradient its columns of the whole one;
    `whole` gives every rank the whole weight and, in backward, its
    columns of the gradient;
  * one layer, column- then row-parallel, against the unsharded `layer_fwd`
    for GQA (tinyllama), MQA (gemma), sliding-window attention (danube),
    MoE on the rank's experts (moonshot), MLA on the rank's heads
    (deepseek's attention before a dense MLP), MLA with MoE and shared
    experts (deepseek), against `GriffinLM.layer_fwd` for Griffin's
    recurrent layer and its local MQA attention layer (recurrentgemma),
    and against `XLSTMLM.block_fwd` for the mLSTM block on the rank's
    heads and the sLSTM block (xlstm): the output, MoE's aux loss (which
    the backward adds) and every gradient (the input's, each block's, each
    replicated leaf's, and the sum of the two ranks' shares of MQA's
    replicated wk and wv, of the RG-LRU's b_rg, b_ig and lam and of the
    mLSTM's b_if) within 1e-5 x their largest |value| (measured at most
    1.3e-6, the mLSTM's b_if);
  * exact: with every assignment routed to rank 0's experts, rank 1's
    share of the MoE exchange is zeros and the sum is rank 0's share.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.checkpointing.elastic import _block
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.core.mesh import Mesh, ShapeMesh
from repro_torch.launch.mesh import run_spmd
from repro_torch.models import GriffinLM, XLSTMLM, build_model, moe
from repro_torch.models.common import chunked_cross_entropy, init_params
from repro_torch.models import rglru as rg
from repro_torch.models import xlstm as xl
from repro_torch.models.attention import attn_layout
from repro_torch.models.transformer import layer_fwd, layer_layout
from repro_torch.sharding import tensor_parallel as tp
from repro_torch.sharding.rules import (SINGLE_POD_RULES,
                                        spec_tree_from_layout)

torch.set_num_threads(1)

#: the layer cases: GQA, MQA, sliding window, MoE, MLA (deepseek's
#: attention before a dense MLP), MLA with MoE and shared experts,
#: Griffin's recurrent layer and its local MQA attention layer, xLSTM's
#: mLSTM and sLSTM blocks
LAYER_ARCHS = ("tinyllama_1_1b", "gemma_2b", "h2o_danube_3_4b",
               "moonshot_v1_16b_a3b", "deepseek_v2_236b/mla",
               "deepseek_v2_236b", "recurrentgemma_2b/rec",
               "recurrentgemma_2b/attn", "xlstm_350m/m", "xlstm_350m/s")
#: the replicated leaves whose gradient on a rank is its share, by case
SHARED_LEAVES = {"gemma_2b": {"/attn/wk", "/attn/wv"},
                 "recurrentgemma_2b/rec": {"/mix/b_rg", "/mix/b_ig",
                                           "/mix/lam"},
                 "recurrentgemma_2b/attn": {"/mix/wk", "/mix/wv"},
                 "xlstm_350m/m": {"/m/b_if"}}
V, D = 24, 8                 # the embedding's and the loss's vocab and width
B, S, CHUNK = 2, 16, 8
#: `row_products`' case: input columns (B, S, 2 N), two (2 N, 2 N) weights
N = 6
#: `fused`'s case: an input (B, 5, FD), a weight (FD, 2 pieces x 2 FK)
#: whose block a rank holds (FD, 2 FK); `whole`'s: blocks (FD, 2 FK)
FD, FK = 8, 3


def _layer_cfg(arch):
    name, _, variant = arch.partition("/")
    cfg = dataclasses.replace(get_arch(name).SMOKE, dtype=torch.float32)
    return dataclasses.replace(cfg, moe=None) if variant == "mla" else cfg


def _griffin_kind(arch) -> str | None:
    """"rec" or "attn" for a Griffin layer case, else None."""
    name, _, variant = arch.partition("/")
    return variant if name == "recurrentgemma_2b" else None


def _xlstm_kind(arch) -> str | None:
    """"m" or "s" for an xLSTM block case, else None."""
    name, _, variant = arch.partition("/")
    return variant if name == "xlstm_350m" else None


def _layer_layout(arch):
    cfg = _layer_cfg(arch)
    kind = _griffin_kind(arch)
    if _xlstm_kind(arch) == "m":
        return {"ln_m": ((cfg.d_model,), (None,), "zeros"),
                "m": xl.mlstm_layout(XLSTMLM(cfg).xcfg)}
    if _xlstm_kind(arch) == "s":
        return {"ln_s": ((cfg.d_model,), (None,), "zeros"),
                "s": xl.slstm_layout(XLSTMLM(cfg).xcfg)}
    if kind is None:
        return layer_layout(cfg)
    model = GriffinLM(cfg)
    return model._layer(rg.rglru_layout(model.rcfg) if kind == "rec" else
                        attn_layout(cfg.attn_config()))


def _layer_run(arch, lp, h):
    """(the layer's output, MoE's aux loss or 0.0) over positions 0 .. S."""
    cfg = _layer_cfg(arch)
    kind = _griffin_kind(arch)
    if _xlstm_kind(arch):
        return XLSTMLM(cfg).block_fwd(_xlstm_kind(arch), lp, h,
                                      need_state=False)[0], 0.0
    if kind is None:
        y, _, aux = layer_fwd(cfg, lp, h, torch.arange(S))
        return y, aux
    return GriffinLM(cfg).layer_fwd(kind, lp, h, torch.arange(S))[0], 0.0


def _inputs() -> dict:
    rng = np.random.default_rng(7)
    x = {"sum_x": rng.standard_normal((2, 5, 7), dtype=np.float32),
         "sum_g": rng.standard_normal((2, 5, 7), dtype=np.float32),
         "table": rng.standard_normal((V, D), dtype=np.float32),
         "tokens": rng.permutation(np.arange(3 * V) % V).reshape(3, V),
         "emb_g": rng.standard_normal((3, V, D), dtype=np.float32),
         "hidden": rng.standard_normal((B, S, D), dtype=np.float32),
         "head": rng.standard_normal((D, V), dtype=np.float32) / 3,
         "targets": rng.integers(0, V, (B, S)),
         "mask": (rng.random((B, S)) < 0.8).astype(np.float32),
         "mm_x": rng.standard_normal((2, 3, 5, 16), dtype=np.float32),
         "mm_w": rng.standard_normal((2, 16, 8), dtype=np.float32),
         "mm_g": rng.standard_normal((3, 5, 8), dtype=np.float32),
         "mm_h": rng.standard_normal((3, 5, 8), dtype=np.float32),
         "mm_gc": rng.standard_normal((2, 3, 5, 16), dtype=np.float32),
         "rc_x": rng.standard_normal((B, 5, 2 * N), dtype=np.float32),
         "rc_w": rng.standard_normal((2, 2 * N, 2 * N), dtype=np.float32),
         "rc_g": rng.standard_normal((2, B, 5, 2 * N), dtype=np.float32),
         "fu_x": rng.integers(-3, 4, (B, 5, FD)).astype(np.float32),
         "fu_w": rng.integers(-3, 4, (FD, 4 * FK)).astype(np.float32),
         "fu_g": rng.integers(-3, 4, (B, 5, 4 * FK)).astype(np.float32),
         "wh_w": rng.integers(-3, 4, (3, FD, 4 * FK)).astype(np.float32),
         "wh_g": rng.integers(-3, 4, (3, FD, 4 * FK)).astype(np.float32)}
    for arch in LAYER_ARCHS:
        cfg = _layer_cfg(arch)
        g = torch.Generator().manual_seed(11)
        x[f"{arch}/lp"] = init_params(_layer_layout(arch), torch.float32,
                                      generator=g)
        if _griffin_kind(arch) == "rec":     # biases away from their zeros
            for name in ("b_rg", "b_ig"):
                x[f"{arch}/lp"]["mix"][name] = torch.from_numpy(
                    rng.standard_normal(cfg.d_rnn, dtype=np.float32))
        kind = _xlstm_kind(arch)
        if kind:            # biases, norms and pre-norm away from zeros
            lp = x[f"{arch}/lp"]
            for name in ("b_if", "norm", "b_gates", "conv_b"):
                if name in lp[kind]:
                    lp[kind][name] = torch.from_numpy(rng.standard_normal(
                        lp[kind][name].shape, dtype=np.float32) / 2)
            lp[f"ln_{kind}"] = torch.from_numpy(rng.standard_normal(
                cfg.d_model, dtype=np.float32) / 4)
        x[f"{arch}/x"] = rng.standard_normal((B, S, cfg.d_model),
                                             dtype=np.float32)
        x[f"{arch}/g"] = rng.standard_normal((B, S, cfg.d_model),
                                             dtype=np.float32)
    # the MoE exchange: every assignment routed to experts 0 .. E/2 - 1
    # (rank 0's), by router columns that score a positive feature
    cfg = _layer_cfg("moonshot_v1_16b_a3b")
    lp = init_params(layer_layout(cfg), torch.float32,
                     generator=torch.Generator().manual_seed(12))["moe"]
    half = cfg.moe.num_experts // 2
    lp["router"][0, :half] += 50.0
    lp["router"][0, half:] -= 50.0
    h = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    h[..., 0] = np.abs(h[..., 0]) + 1.0
    x["exchange"] = (lp, h)
    return x


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _specs(arch):
    return spec_tree_from_layout(SINGLE_POD_RULES, _layer_layout(arch))


def _cut(tree, specs, mesh):
    """This rank's blocks of a layer's weights, as trainable copies."""
    if isinstance(tree, dict):
        return {k: _cut(v, specs[k], mesh) for k, v in tree.items()}
    return _block(tree, mesh, specs).clone().requires_grad_(True)


def _grads(tree):
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    return tree.grad.numpy()


def _world(device, x):
    """One rank of the world of 2: every case; every rank's results."""
    mesh = Mesh((1, 2), ("data", "model"))
    r = mesh.coord["model"]
    out = {"rank": r}

    a = _t(x["sum_x"][r], True)
    y = mesh.reduce_from(a, "model")
    y.backward(_t(x["sum_g"][r]))
    out["reduce_from"] = (y.detach().numpy(), a.grad.numpy())
    out["reduce_from_bf16"] = mesh.reduce_from(
        a.detach().bfloat16(), "model").float().numpy()
    a = _t(x["sum_x"][r], True)
    y = mesh.copy_to(a, "model")
    y.backward(_t(x["sum_g"][r]))
    out["copy_to"] = (y.detach().numpy(), a.grad.numpy())

    rows = V // 2
    tokens = _t(x["tokens"])
    with tp.model_parallel(mesh, "model"):
        h = _t(x["mm_x"][r]).bfloat16().requires_grad_(True)
        w = _t(x["mm_w"][r]).bfloat16().requires_grad_(True)
        y = tp.row(h, w)
        y.backward(_t(x["mm_g"]).bfloat16())
        out["row_bf16"] = (y.detach().float().numpy(),
                           h.grad.float().numpy(), w.grad.float().numpy())
        h = _t(x["mm_h"]).bfloat16().requires_grad_(True)
        ws = [_t(x["mm_w"][r].T).bfloat16().requires_grad_(True),
              _t(x["mm_w"][1 - r].T).bfloat16().requires_grad_(True)]
        ys = tp.column(h, *ws)
        torch.autograd.backward(ys, [_t(g).bfloat16() for g in x["mm_gc"]])
        out["column_bf16"] = ([y.detach().float().numpy() for y in ys],
                              h.grad.float().numpy(),
                              [w.grad.float().numpy() for w in ws])
        for dtype in (torch.float32, torch.bfloat16):
            table = _t(x["table"][r * rows:(r + 1) * rows]).to(dtype)
            table.requires_grad_(True)
            e = tp.embedding(tokens, table)
            e.backward(_t(x["emb_g"]).to(dtype))
            out[f"embedding/{dtype}"] = (e.detach().float().numpy(),
                                         table.grad.float().numpy())

        for count in (None, float(x["mask"].sum()) + 3):
            h = _t(x["hidden"], True)
            head = _t(x["head"][:, r * rows:(r + 1) * rows], True)
            loss = tp.chunked_cross_entropy(
                h, head, _t(x["targets"]), _t(x["mask"]), chunk=CHUNK,
                mask_count=None if count is None else torch.tensor(count))
            loss.backward()
            out[f"ce/{count}"] = (loss.item(), h.grad.numpy(),
                                  head.grad.numpy())

        for dtype in (torch.float32, torch.bfloat16):
            cols = slice(r * N, (r + 1) * N)
            h = _t(x["rc_x"][..., cols]).to(dtype).requires_grad_(True)
            ws = [_t(w[cols]).to(dtype).requires_grad_(True)
                  for w in x["rc_w"]]
            ys = tp.row_products(*((h, w) for w in ws))
            torch.autograd.backward(
                ys, [_t(g[..., cols]).to(dtype) for g in x["rc_g"]])
            out[f"row_columns/{dtype}"] = (
                [y.detach().float().numpy() for y in ys],
                h.grad.float().numpy(), [w.grad.float().numpy() for w in ws])

        for dtype in (torch.float32, torch.bfloat16):
            h = _t(x["fu_x"]).to(dtype).requires_grad_(True)
            w = _t(x["fu_w"][:, r * 2 * FK:(r + 1) * 2 * FK]).to(dtype)
            w.requires_grad_(True)
            ys = tp.fused(h, w, 2)
            g = x["fu_g"]
            torch.autograd.backward(ys, [_t(g[..., j * 2 * FK + r * FK:
                                              j * 2 * FK + (r + 1) * FK]
                                            ).to(dtype) for j in range(2)])
            out[f"fused/{dtype}"] = ([y.detach().float().numpy() for y in ys],
                                     h.grad.float().numpy(),
                                     w.grad.float().numpy())
        ws = [_t(v[:, r * 2 * FK:(r + 1) * 2 * FK], True)
              for v in x["wh_w"]]
        ws[2] = _t(x["wh_w"][2, 0, r * 2 * FK:(r + 1) * 2 * FK], True)
        wholes = tp.whole(*ws)
        torch.autograd.backward(wholes, [_t(x["wh_g"][0]), _t(x["wh_g"][1]),
                                         _t(x["wh_g"][2, 0])])
        out["whole"] = ([t.detach().numpy() for t in wholes],
                        [t.grad.numpy() for t in ws])

        for arch in LAYER_ARCHS:
            blocks = _cut(x[f"{arch}/lp"], _specs(arch), mesh)
            h = _t(x[f"{arch}/x"], True)
            y, aux = _layer_run(arch, blocks, h)
            ((y * _t(x[f"{arch}/g"])).sum() + aux).backward()
            out[f"layer/{arch}"] = (y.detach().numpy(), h.grad.numpy(),
                                    _grads(blocks),
                                    float(torch.as_tensor(aux).detach()))

        cfg = _layer_cfg("moonshot_v1_16b_a3b")
        lp, h = x["exchange"]
        blocks = _cut(lp, _specs("moonshot_v1_16b_a3b")["moe"], mesh)
        shares = []
        reduce_from = mesh.reduce_from

        def recorded(t, *args):
            total = reduce_from(t, *args)
            shares.append((t.detach().clone(), total.detach().clone()))
            return total
        mesh.reduce_from = recorded
        with torch.no_grad():
            y, _ = moe.moe_forward(blocks, _t(h), cfg.moe, act=cfg.act)
        del mesh.reduce_from
        ((share, total),) = shares
        out["exchange"] = (share.numpy(), total.numpy(), y.numpy())
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, out)
    return every


@pytest.fixture(scope="module")
def results():
    x = _inputs()
    world = run_spmd(_world, 2, device="cpu", args=(x,), timeout_s=300)
    return x, sorted(world, key=lambda w: w["rank"])


def _close(a, b, tol):
    """max |a - b| within `tol` x max |b|."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * np.abs(b).max(), \
        np.abs(a - b).max() / np.abs(b).max()


# ---------------------------------------------------------------------------
# the pair of sums
# ---------------------------------------------------------------------------

def test_reduce_from_sums_forward_and_passes_gradients_through(results):
    x, world = results
    total = x["sum_x"][0] + x["sum_x"][1]
    for r, w in enumerate(world):
        y, grad = w["reduce_from"]
        assert np.array_equal(y, total)
        assert np.array_equal(grad, x["sum_g"][r])
        want = (torch.from_numpy(x["sum_x"][0]).bfloat16().float()
                + torch.from_numpy(x["sum_x"][1]).bfloat16().float())
        assert np.array_equal(w["reduce_from_bf16"],
                              want.bfloat16().float().numpy())


def test_copy_to_passes_forward_and_sums_gradients(results):
    x, world = results
    for r, w in enumerate(world):
        y, grad = w["copy_to"]
        assert np.array_equal(y, x["sum_x"][r])
        assert np.array_equal(grad, x["sum_g"][0] + x["sum_g"][1])


def _bf16(a):
    return torch.from_numpy(np.asarray(a)).bfloat16()


def test_bf16_row_parallel_product_is_rounded_once(results):
    """`row` on bf16 blocks: the two ranks' float32 products of the bf16
    operands summed in float32 and rounded once to bf16, bitwise; the
    gradients are the plain bf16 products of the rank's blocks."""
    x, world = results
    want = sum(_bf16(x["mm_x"][r]).float().reshape(-1, 16)
               @ _bf16(x["mm_w"][r]).float() for r in range(2))
    g = _bf16(x["mm_g"]).reshape(-1, 8)
    for r, w in enumerate(world):
        y, gx, gw = w["row_bf16"]
        assert np.array_equal(y.reshape(-1, 8),
                              want.bfloat16().float().numpy())
        assert np.array_equal(gx.reshape(-1, 16), (g @ _bf16(
            x["mm_w"][r]).t()).float().numpy())
        assert np.array_equal(gw, (_bf16(x["mm_x"][r]).reshape(-1, 16).t()
                                   @ g).float().numpy())


def test_bf16_column_parallel_gradient_is_rounded_once(results):
    """`column` on bf16 blocks: the plain products forward; the input's
    gradient is every product's float32 share on both ranks summed in
    float32 and rounded once to bf16, bitwise."""
    x, world = results
    h = _bf16(x["mm_h"]).reshape(-1, 8)
    gs = [_bf16(g).reshape(-1, 16) for g in x["mm_gc"]]
    shares = [sum(g.float() @ _bf16(x["mm_w"][(r + i) % 2]).float()
                  for i, g in enumerate(gs)) for r in range(2)]
    want = (shares[0] + shares[1]).bfloat16().float().numpy()
    for r, w in enumerate(world):
        ys, gx, gws = w["column_bf16"]
        for i, (y, g) in enumerate(zip(ys, gs)):
            wt = _bf16(x["mm_w"][(r + i) % 2].T)
            assert np.array_equal(y.reshape(-1, 16), (h @ wt).float().numpy())
            assert np.array_equal(gws[i], (h.t() @ g).float().numpy())
        assert np.array_equal(gx.reshape(-1, 8), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_columns_sum_then_slice(results, dtype):
    """`row_products` on two weights whose input axis is split: each rank's
    products are its columns of the two ranks' float32 partial products
    summed and rounded once; backward gathers every column's gradient, so
    the input's gradient is the plain products of all of them with the
    rank's rows and each weight's gradient the rank's rows of the plain
    product with all of them, bitwise (an identity backward would leave
    each rank its own columns' gradients alone)."""
    x, world = results

    def rows(a, r):
        return torch.from_numpy(np.ascontiguousarray(a[..., r * N:(r + 1) * N,
                                                       :])).to(dtype)
    hs = [torch.from_numpy(np.ascontiguousarray(
        x["rc_x"][..., r * N:(r + 1) * N])).to(dtype) for r in range(2)]
    gs = [torch.from_numpy(g).to(dtype).reshape(-1, 2 * N)
          for g in x["rc_g"]]
    for r, w in enumerate(world):
        ys, gx, gws = w[f"row_columns/{dtype}"]
        gx_want = 0
        for i, wt in enumerate(x["rc_w"]):
            total = sum(hs[q].float().reshape(-1, N) @ rows(wt, q).float()
                        for q in range(2))
            want = total.to(dtype)[:, r * N:(r + 1) * N].float()
            assert np.array_equal(ys[i].reshape(-1, N), want.numpy())
            gx_want = gx_want + gs[i] @ rows(wt, r).t()
            assert np.array_equal(gws[i], (hs[r].reshape(-1, N).t()
                                           @ gs[i]).float().numpy())
        assert np.array_equal(gx.reshape(-1, N), gx_want.float().numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_exchange_is_exact_both_ways(results, dtype):
    """`fused` on a fused weight of two pieces whose contiguous blocks the
    two ranks hold (rank 0 all of the first piece, rank 1 all of the
    second): each rank's products are its span of each piece of the whole
    product, its input's gradient the whole gradient (every rank's spans)
    times the whole weight, and its block's gradient its columns of the
    input times the whole gradient, bitwise (integer inputs, so every
    order of the sums gives the same values).  An exchange that kept the
    rank's own spans' gradients alone would miss each block's other half."""
    x, world = results
    h = torch.from_numpy(x["fu_x"]).to(dtype).float()
    w = torch.from_numpy(x["fu_w"]).to(dtype).float()
    g = torch.from_numpy(x["fu_g"]).to(dtype).float()
    prod = h @ w
    for r, got in enumerate(world):
        ys, gx, gw = got[f"fused/{dtype}"]
        for j in range(2):
            lo = j * 2 * FK + r * FK
            assert np.array_equal(ys[j], prod[..., lo:lo + FK].numpy())
        assert np.array_equal(gx, (g @ w.t()).numpy())
        cols = slice(r * 2 * FK, (r + 1) * 2 * FK)
        assert np.array_equal(gw, (h.reshape(-1, FD).t()
                                   @ g[..., cols].reshape(-1, 2 * FK)).numpy())


def test_whole_gathers_forward_and_slices_backward(results):
    """`whole` on three blocks of one width (two matrices and a vector, as
    the sLSTM's w_gates, r_gates and b_gates): every rank gets the whole
    weights, and each block's gradient is its columns of the whole
    gradient, not their sum over the ranks, bitwise."""
    x, world = results
    wants = [x["wh_w"][0], x["wh_w"][1], x["wh_w"][2, 0]]
    grads = [x["wh_g"][0], x["wh_g"][1], x["wh_g"][2, 0]]
    for r, got in enumerate(world):
        wholes, gs = got["whole"]
        cols = slice(r * 2 * FK, (r + 1) * 2 * FK)
        for t, want, gt, g in zip(wholes, wants, gs, grads):
            assert np.array_equal(t, want)
            assert np.array_equal(gt, g[..., cols])


# ---------------------------------------------------------------------------
# vocab-parallel embedding and cross entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vocab_parallel_embedding_is_the_lookup(results, dtype):
    """Bitwise `F.embedding` of the whole table, and each rank's weight
    gradient is its rows of the whole table's."""
    x, world = results
    table = torch.from_numpy(x["table"]).to(dtype).requires_grad_(True)
    e = F.embedding(torch.from_numpy(x["tokens"]), table)
    e.backward(torch.from_numpy(x["emb_g"]).to(dtype))
    rows = V // 2
    for r, w in enumerate(world):
        got, grad = w[f"embedding/{dtype}"]
        assert np.array_equal(got, e.detach().float().numpy())
        assert np.array_equal(
            grad, table.grad[r * rows:(r + 1) * rows].float().numpy())


@pytest.mark.parametrize("count", ["none", "global"])
def test_vocab_parallel_cross_entropy(results, count):
    """Value and gradients against `chunked_cross_entropy` on the whole
    head (module docstring); both ranks report the same value."""
    x, world = results
    mc = None if count == "none" else float(x["mask"].sum()) + 3
    h = torch.from_numpy(x["hidden"]).requires_grad_(True)
    head = torch.from_numpy(x["head"]).requires_grad_(True)
    loss = chunked_cross_entropy(
        h, head, torch.from_numpy(x["targets"]), torch.from_numpy(x["mask"]),
        chunk=CHUNK, mask_count=None if mc is None else torch.tensor(mc))
    loss.backward()
    rows = V // 2
    values = {w[f"ce/{mc}"][0] for w in world}
    assert len(values) == 1
    np.testing.assert_allclose(values.pop(), loss.item(), rtol=1e-6)
    for r, w in enumerate(world):
        _, gh, ghead = w[f"ce/{mc}"]
        _close(gh, h.grad.numpy(), 1e-6)
        _close(ghead, head.grad[:, r * rows:(r + 1) * rows].numpy(), 1e-6)


# ---------------------------------------------------------------------------
# one layer, column- then row-parallel
# ---------------------------------------------------------------------------

def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", LAYER_ARCHS)
def test_tensor_parallel_layer_matches_layer_fwd(results, arch):
    """The output, MoE's aux loss, the input's gradient and each rank's
    gradient of its blocks against the unsharded layer's (each block of
    the whole gradient; the router's, wq_a's and w_dkv's whole on each
    rank; MQA's replicated wk and wv and the RG-LRU's b_rg, b_ig and lam:
    the two ranks' shares sum to it), within 1e-5 x the largest |value|."""
    x, world = results
    lp = {k: v.clone().requires_grad_(True)
          for k, v in _leaves(x[f"{arch}/lp"]).items()}
    tree = {}
    for k, v in lp.items():
        node = tree
        *path, last = k.strip("/").split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    h = torch.from_numpy(x[f"{arch}/x"]).requires_grad_(True)
    y, aux = _layer_run(arch, tree, h)
    ((y * torch.from_numpy(x[f"{arch}/g"])).sum() + aux).backward()
    specs = _leaves(_specs(arch))
    shared = SHARED_LEAVES.get(arch, set())
    shares = {}
    for r, w in enumerate(world):
        out, gx, grads, aux_r = w[f"layer/{arch}"]
        _close(out, y.detach().numpy(), 1e-5)
        _close(aux_r, float(torch.as_tensor(aux).detach()), 1e-5)
        _close(gx, h.grad.numpy(), 1e-5)
        mesh = ShapeMesh((1, 2), ("data", "model"))
        mesh.coord = {"data": 0, "model": r}
        for k, g in _leaves(grads).items():
            whole = lp[k].grad
            if "model" in tuple(specs[k]):
                _close(g, _block(whole, mesh, specs[k]).numpy(), 1e-5)
            elif k in shared:
                shares[k] = shares.get(k, 0) + g
            else:
                _close(g, whole.numpy(), 1e-5)
    assert set(shares) == shared
    for k, g in shares.items():
        _close(g, lp[k].grad.numpy(), 1e-5)
        assert not np.allclose(_leaves(world[0][f"layer/{arch}"][2])[k], g)


def test_moe_exchange_adds_exact_zeros_from_the_other_rank(results):
    """With every assignment routed to rank 0's experts, rank 1 runs its
    experts on empty slots and its share of the exchange is zeros,
    bitwise; the sum each rank gets is rank 0's share, bitwise, and the
    layer's output is the unsharded layer's."""
    x, world = results
    cfg = _layer_cfg("moonshot_v1_16b_a3b")
    lp, h = x["exchange"]
    with torch.no_grad():
        want, _ = moe.moe_forward(lp, torch.from_numpy(h), cfg.moe,
                                  act=cfg.act)
        xt = torch.from_numpy(h).reshape(-1, cfg.d_model)
        _, top_e, _, rank, C, _ = moe.route(
            torch.softmax(xt @ lp["router"], dim=-1), cfg.moe)
    assert (top_e < cfg.moe.num_experts // 2).all()
    kept = (rank < C).numpy()
    assert kept.any() and not kept.all()
    mine, theirs = world[0]["exchange"][0], world[1]["exchange"][0]
    assert mine.shape == (B * S * cfg.moe.top_k, cfg.d_model)
    assert np.array_equal(np.abs(mine).max(axis=1) > 0, kept)
    assert np.array_equal(theirs, np.zeros_like(theirs))
    assert not np.signbit(theirs).any()
    for w in world:
        assert np.array_equal(w["exchange"][1], mine)
        _close(w["exchange"][2], want.numpy(), 1e-5)


# ---------------------------------------------------------------------------
# without a world
# ---------------------------------------------------------------------------

def test_dense_family():
    """The configs that run Megatron compute in the sharded train step:
    the transformer family, dense, MoE and MLA alike, Griffin and xLSTM."""
    dense = {a for a in ARCH_IDS
             if tp.computes_on_blocks(build_model(get_arch(a).SMOKE))}
    assert dense == {"tinyllama_1_1b", "gemma_2b", "granite_8b",
                     "h2o_danube_3_4b", "hubert_xlarge", "llava_next_34b",
                     "moonshot_v1_16b_a3b", "deepseek_v2_236b",
                     "recurrentgemma_2b", "xlstm_350m"}


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "gemma_2b",
                                  "hubert_xlarge"])
def test_local_config_divides_heads_ff_and_vocab(arch):
    cfg = get_arch(arch).CONFIG
    local = tp.local_config(cfg, 2)
    assert local.num_heads * 2 == cfg.num_heads
    assert local.num_kv_heads == (1 if cfg.num_kv_heads == 1
                                  else cfg.num_kv_heads // 2)
    assert (local.d_ff * 2, local.vocab * 2) == (cfg.d_ff, cfg.vocab)
    assert local.hd == cfg.hd
    assert tp.local_config(cfg, 1) is cfg
    with pytest.raises(ValueError, match="does not split"):
        tp.local_config(cfg, 3)


def test_outside_the_context_nothing_changes():
    x, w = torch.randn(2, 3), torch.randn(3, 4)
    assert torch.equal(tp.row(x, w), x @ w)
    assert all(torch.equal(y, x @ w) for y in tp.column(x, w, w))
    assert (tp.parts(), tp.index(), tp.active()) == (1, 0, False)
    table = torch.randn(V, D)
    tokens = torch.arange(V).reshape(2, -1)
    assert torch.equal(tp.embedding(tokens, table), F.embedding(tokens,
                                                                 table))


def test_load_refuses_shapes_of_neither_layout():
    """`load` takes the whole layout, and a rank's blocks only under the
    context (a stand-in mesh of 2 model ranks)."""
    cfg = _layer_cfg("tinyllama_1_1b")
    model = build_model(cfg).init(device="cpu")
    whole = model.tree()
    mesh = ShapeMesh((1, 2), ("data", "model"))
    mesh.coord = {"data": 0, "model": 1}
    half = tp.local_config(cfg, 2)
    blocks = build_model(half).init(device="cpu").tree()
    with pytest.raises(ValueError, match="match neither"):
        model.load(blocks)
    with tp.model_parallel(mesh, "model"):
        model.load(blocks)
        model.load(whole)
        wrong = dict(whole, head=whole["head"][:, :3])
        with pytest.raises(ValueError, match="blocks among 2"):
            model.load(wrong)


def _rank_mesh(m: int, i: int) -> ShapeMesh:
    mesh = ShapeMesh((1, m), ("data", "model"))
    mesh.coord = {"data": 0, "model": i}
    return mesh


@pytest.mark.parametrize("arch", ["moonshot_v1_16b_a3b", "deepseek_v2_236b"])
def test_expert_ranges_tile_and_routing_stays_global(arch):
    """The ranks' expert ranges tile 0 .. E in rank order at m = 1, 2, 4;
    `local_config` keeps MoE's config whole, so num_experts, top_k and
    the capacity C that `route` takes are the global ones; E that does
    not split raises."""
    cfg = get_arch(arch).CONFIG
    E = cfg.moe.num_experts
    for m in (1, 2, 4):
        covered = []
        for i in range(m):
            with tp.model_parallel(_rank_mesh(m, i), "model"):
                lo, n = tp.experts(E)
            covered += range(lo, lo + n)
        assert covered == list(range(E))
    assert tp.experts(E) == (0, E)
    local = tp.local_config(cfg, 2)
    assert (local.moe.num_experts, local.moe.top_k) == (E, cfg.moe.top_k)
    assert local.num_heads * 2 == cfg.num_heads
    probs = torch.softmax(torch.randn(96, E, generator=torch.Generator()
                                      .manual_seed(0)), dim=-1)
    with tp.model_parallel(_rank_mesh(2, 1), "model"):
        C = moe.route(probs, local.moe)[4]
    assert C == moe.route(probs, cfg.moe)[4] == max(1, int(
        96 * cfg.moe.top_k * cfg.moe.capacity_factor / E))
    with tp.model_parallel(_rank_mesh(3, 0), "model"):
        with pytest.raises(ValueError, match="does not split"):
            tp.experts(E)


def test_block_layout_divides_experts_shared_ff_and_mla_heads():
    """deepseek-v2's block shapes among 2: the experts' leading axis, the
    shared experts' ff and MLA's head columns halved; the router, wq_a,
    w_dkv and the norms whole."""
    cfg = get_arch("deepseek_v2_236b").CONFIG
    lay = tp.block_layout(layer_layout(cfg), 2)
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    h = cfg.num_heads
    assert lay["moe"]["wg"][0] == (E // 2, d, f)
    assert lay["moe"]["wo"][0] == (E // 2, f, d)
    assert lay["moe"]["router"][0] == (d, E)
    assert lay["moe"]["shared"]["wi"][0] == (d, f * cfg.moe.num_shared // 2)
    assert lay["moe"]["shared"]["wo"][0] == (f * cfg.moe.num_shared // 2, d)
    mla = cfg.mla
    assert lay["attn"]["wq_b"][0] == (mla["q_lora"], h // 2 * (
        cfg.hd + mla["rope_head_dim"]))
    assert lay["attn"]["w_uk"][0] == (mla["kv_lora"], h // 2 * cfg.hd)
    assert lay["attn"]["wo"][0] == (h // 2 * mla["v_head_dim"], d)
    for name in ("wq_a", "w_dkv", "q_norm", "kv_norm"):
        assert lay["attn"][name][0] == layer_layout(cfg)["attn"][name][0]
    assert lay["ln_attn"][0] == (d,)


@pytest.mark.parametrize("arch", ["moonshot_v1_16b_a3b", "deepseek_v2_236b"])
def test_load_takes_moe_and_mla_blocks(arch):
    """`load` takes a rank's blocks of a MoE / MLA model (cut by the specs)
    under the context and refuses them outside it; it refuses the layout
    of `local_config` (whole experts beside the rank's heads) either way."""
    cfg = _layer_cfg(arch)
    model = build_model(cfg).init(device="cpu")
    mesh = _rank_mesh(2, 1)
    specs = spec_tree_from_layout(SINGLE_POD_RULES, model.layout())
    layer_specs = specs["layers"]

    def cut(tree, spec, stacked):
        if isinstance(tree, dict):
            return {k: cut(v, spec[k], stacked) for k, v in tree.items()}
        return _block(tree, mesh, tuple(spec)[1:] if stacked else spec)
    whole = model.tree()
    blocks = {k: cut(v, specs[k], False) for k, v in whole.items()
              if k != "layers"}
    blocks["layers"] = [cut(lt, layer_specs, True)
                        for lt in whole["layers"]]
    local = build_model(tp.local_config(cfg, 2)).init(device="cpu").tree()
    with pytest.raises(ValueError, match="match neither"):
        model.load(blocks)
    with tp.model_parallel(mesh, "model"):
        model.load(blocks)
        assert model.layers[0]["moe"]["wg"].shape[0] == \
            cfg.moe.num_experts // 2
        with pytest.raises(ValueError, match="blocks among 2"):
            model.load(local)
        model.load(whole)


def _rank_blocks(model, mesh) -> dict:
    """A rank's blocks of a Griffin or xLSTM model's weights, cut by the
    specs of JAX's stacked layout, in `load`'s form."""
    specs = spec_tree_from_layout(SINGLE_POD_RULES, model.layout())

    def cut(tree, spec, stacked):
        if isinstance(tree, dict):
            return {k: cut(v, spec[k], stacked) for k, v in tree.items()}
        return _block(tree, mesh, tuple(spec)[1:] if stacked else spec)
    whole = model.tree()
    out = {k: cut(v, specs[k], False) for k, v in whole.items()
           if k != model.BLOCKS}
    stacked = specs["units"]
    if model.BLOCKS == "layers":          # Griffin: one tree a layer
        names = [n for _ in range(model.n_units)
                 for n in ("rec1", "rec2", "attn")]
        names += [f"tail{i}" for i in range(model.n_tail)]
        out["layers"] = [cut(lt, stacked[n], True) if n in stacked else
                         cut(lt, specs[n], False)
                         for lt, n in zip(whole["layers"], names)]
    else:
        out["units"] = [cut(u, stacked, True) for u in whole["units"]]
    return out


def test_load_takes_griffin_and_xlstm_blocks():
    """`GriffinLM.load` and `XLSTMLM.load` take a rank's blocks (cut by the
    specs) under the context only, and refuse other shapes (Griffin: the
    blocks among 4, a wrong tail layer) in and out of it; both take the
    whole layout under the context too."""
    cfg = _layer_cfg("recurrentgemma_2b")
    model = build_model(cfg).init(device="cpu")
    whole = model.tree()
    blocks = _rank_blocks(model, _rank_mesh(2, 1))
    assert blocks["layers"][0]["mix"]["w_rg"].shape == (cfg.d_rnn // 2,
                                                        cfg.d_rnn)
    assert blocks["layers"][-1]["mix"]["conv_b"].shape == (cfg.d_rnn // 2,)
    with pytest.raises(ValueError, match="match neither"):
        model.load(blocks)
    with tp.model_parallel(_rank_mesh(2, 1), "model"):
        model.load(blocks)
        assert model.blocks[0]["mix"]["w_x"].shape[1] == cfg.d_rnn // 2
        model.load(whole)
        wrong = dict(blocks, layers=blocks["layers"][:-1]
                     + [whole["layers"][-1]])
        with pytest.raises(ValueError, match="blocks among 2"):
            model.load(wrong)
        quarter = _rank_blocks(build_model(cfg).init(device="cpu"),
                               _rank_mesh(4, 1))
        with pytest.raises(ValueError, match="blocks among 2"):
            model.load(quarter)
    xcfg = _layer_cfg("xlstm_350m")
    xmodel = build_model(xcfg).init(device="cpu")
    xwhole = xmodel.tree()
    xblocks = _rank_blocks(xmodel, _rank_mesh(2, 1))
    assert xblocks["embed"].shape[0] * 2 == xcfg.vocab
    with pytest.raises(ValueError, match="match neither"):
        xmodel.load(xblocks)
    with tp.model_parallel(_rank_mesh(2, 1), "model"):
        xmodel.load(xblocks)
        unit = xmodel.blocks[0]
        d = xcfg.d_model
        assert unit["m"]["w_up"].shape == (d, 2 * d)      # 2 dp / 2
        assert unit["m"]["wq"].shape == (d, 2 * d)        # dp / 2 rows
        assert unit["s"]["r_gates"].shape == (d, 2 * d)   # 4 d / 2
        assert unit["s"]["conv_w"].shape == xwhole["units"][0]["s"][
            "conv_w"].shape
        xmodel.load(xwhole)


def test_mlstm_heads_that_do_not_split_raise():
    """The mLSTM computes on the rank's heads: its 4 heads over 8 model
    ranks raise ValueError (before any collective: the stand-in mesh has
    none), though every leaf's blocks among 8 exist."""
    cfg = _layer_cfg("xlstm_350m")
    model = build_model(cfg).init(device="cpu")
    mesh = _rank_mesh(8, 3)
    blocks = _rank_blocks(model, mesh)
    with tp.model_parallel(mesh, "model"):
        model.load(blocks)
        h = torch.zeros(1, 4, cfg.d_model)
        with pytest.raises(ValueError, match="num_heads = 4 does not split"):
            model.block_fwd("m", model.blocks[0].tree(), h,
                            need_state=False)
