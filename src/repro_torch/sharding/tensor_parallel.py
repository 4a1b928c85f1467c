"""Megatron compute over the "model" axis of a mesh: what XLA's partitioner
does for JAX's SPMD train step under `sharding.rules` (heads, kv heads, ff,
vocab and experts over "model"), written out for the transformer family
(dense, MoE and MLA), Griffin and xLSTM.

While `model_parallel(mesh, axis)` is active, each rank computes on the
blocks its specs give it:
  * attention and the MLP run their first products column-parallel on the
    rank's heads or ff columns (`column`: the plain products behind one
    `core.mesh.Mesh.copy_to`, so the input's gradient is summed over the
    axis) and their last product row-parallel (`row`: the partial product
    summed over the axis by `Mesh.reduce_from`, the plain gradients): one
    pair of sums a block.  Each sum adds float32 partials, rounded once to
    the operands' dtype: a bf16 partial product, and each product's share
    of a bf16 input's gradient, is taken in float32 (`torch.mm`'s
    ``out_dtype`` on the card), so a bf16 row-parallel product is rounded
    once, as the unsharded product is;
  * the embedding is vocab-parallel (`embedding`): each rank looks up the
    tokens in its rows, zeros elsewhere, and the sum over the axis is the
    unsharded lookup exactly (one rank adds a non-zero);
  * the cross entropy is vocab-parallel (`chunked_cross_entropy`): each
    chunk's logits are the rank's head columns, the log-normaliser comes
    from a max and a sum of exponentials over the axis, the gold logit from
    a masked local gather summed over it, and backward is the local softmax
    minus the local one-hot; no full-vocabulary tensor is formed;
  * MoE is expert-parallel (`models.moe`): every rank routes the whole
    batch to all E experts as one process does, dispatches locally the
    assignments routed to its own experts (`experts`), and the combine
    sums each assignment's expert output over the axis (`summed`: one
    rank adds a non-zero, so the sum is exact) before JAX's weighted
    combine; no all-to-all, as the batch is split over the data axes
    only.  MLA runs its heads as GQA does, its normed and roped latent
    behind one `copy_in`;
  * Griffin's RG-LRU block (`models.rglru`) runs its two input products
    column-parallel and its output product row-parallel, its conv and
    recurrence on the rank's ff columns; its gates, whose weights take ff
    as their input axis, are `row_products`: the float32 partial products
    summed over the axis in one collective, rounded once, and cut to the
    rank's columns (`span`), whose backward gives every rank the gradient
    of all the columns; the replicated vectors beside them (the gates'
    biases, the decay) enter as the rank's span (`own`);
  * xLSTM (`models.xlstm`): a fused leaf, whose columns are pieces side
    by side (the mLSTM's w_up u | z, the sLSTM's w_up a | b), is cut
    contiguously as JAX cuts it, so a rank's block is not its span of
    each piece: `fused` runs the block's product column-parallel and
    exchanges the products over the axis (one gather), so that each rank
    keeps its span of every piece; backward gathers every rank's span
    gradients and keeps the block's.  The mLSTM runs on the rank's heads:
    its conv on the rank's columns, q, k, v and the two gates through
    `row_products` (one sum), the gates' bias as the rank's heads' entries
    of each half (`own` with pieces), the norm's sum of squares summed
    over the axis (`all_sum`, whose backward sums too) and w_down
    row-parallel.  The sLSTM's recurrence reads the whole previous h at
    every position, so its conv, scan and norm run whole on every rank,
    their gate weights brought whole over the axis (`whole`: one gather;
    backward keeps the rank's columns of the gradient, which every rank
    computes the same), and its MLP is tensor-parallel (`fused`, `row`).
Serving (`launch.steps.make_serve_step`) runs the same layers under the
context, forward only: the decode step's attention on the rank's heads and
its cache columns, MLA's over the rank's slots of the latent (the queries
of all heads brought by `gathered`, the softmax's max and sums over the
axis by `all_max` and `all_sum`), and the head's vocab-parallel logits
brought whole by `gather_vocab`.
Outside it every function here is the identity or its unsharded
counterpart, so one process runs the same layer code.

Heads that do not split over the axis (tinyllama's 4 kv heads, gemma's 8
heads, recurrentgemma's 10 local-attention heads, whose RG-LRU's 2560
columns do split, or xLSTM's 4 over 16 ranks) keep JAX's even
column cut at rest (`block_layout`), and the rank computes on a head group
(`heads`): the m ranks form g = gcd(H, m) groups of r = m / g consecutive
ranks (a run, `core.mesh.Mesh.group(axis, run=r)`), and each group computes
its H / g whole heads, replicated on its r ranks.  GQA's q, k and v take
the group's columns (`head_columns`): the r ranks' blocks of the weight
gathered over the run (`_RunGather`); backward
sums the r replicas' gradients of the gathered columns over the run in
float32 and keeps the rank's block.  The mLSTM cuts its summed partials to
the group's heads (`row_products(..., nheads=H)`).  Each rank then keeps its
own (H hd) / m columns of the heads' output (`own_heads`), the rows of its
`wo` block, so the row-parallel product and its sum are unchanged.

Wherever each rank consumes a collective's output on its own columns, the
collective's backward sums over the axis (`row_products`, `all_sum`,
`fused`); `Mesh.reduce_from`'s identity backward is right only where every
rank consumes the output whole and alike, and a replicated weight brought
whole is sliced in backward, not summed.

The context is a module global, as `models.moe.global_routing` is, and not
a context variable: layers recomputed in backward run on autograd's own
threads.  The ranks of the axis issue their collectives in one order, as
they run the same graph.  `computes_on_blocks` names the configs that run
so: every family.  `block_layout` is the one rule for a rank's block
shapes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.device import on_card
from .rules import SINGLE_POD_RULES

#: (mesh, axis) of the model-parallel group while `model_parallel` is
#: active (a module global, not a context variable: see the docstring)
_GROUP = None


@contextlib.contextmanager
def model_parallel(mesh, axis: str = "model"):
    """Run every layer, embedding and loss inside the block
    (their recomputation in backward included) on this rank's blocks along
    `axis` of `mesh`."""
    global _GROUP
    saved, _GROUP = _GROUP, (mesh, axis)
    try:
        yield
    finally:
        _GROUP = saved


def active() -> bool:
    return _GROUP is not None


def parts() -> int:
    """Ranks along the model-parallel axis (1 outside the context)."""
    return 1 if _GROUP is None else _GROUP[0].axis_size(_GROUP[1])


def index() -> int:
    """This rank's index along the model-parallel axis (0 outside)."""
    return 0 if _GROUP is None else _GROUP[0].index(_GROUP[1])


def computes_on_blocks(model) -> bool:
    """Whether the sharded train step runs `model` on its blocks over
    "model": the transformer family, with or without MoE and MLA, Griffin
    and xLSTM."""
    cfg = getattr(model, "cfg", None)
    return cfg is not None and cfg.family in ("transformer", "griffin",
                                              "xlstm")


def _split(n: int, what: str, m: int) -> int:
    if n % m:
        raise ValueError(f"{what} = {n} does not split over {m} "
                         f"model-parallel ranks")
    return n // m


#: the logical axes that the rules shard over "model" (the same in
#: SINGLE_POD_RULES and MULTI_POD_RULES)
MODEL_AXES = frozenset(k for k, v in SINGLE_POD_RULES.rules.items()
                       if v == "model")


def block_layout(layout: dict, m: int) -> dict:
    """A layout table ({name: (shape, logical axes, init) | nested dict or
    list}) with each shape one rank's block among `m` along "model": every
    dimension whose logical axis is in `MODEL_AXES` divided by m (MoE's
    experts and its shared experts' ff, MLA's heads included); ValueError
    where one does not split."""
    def one(name, entry):
        if isinstance(entry, dict):
            return {k: one(k, v) for k, v in entry.items()}
        if isinstance(entry, list):
            return [one(name, v) for v in entry]
        shape, axes, init = entry
        return (tuple(_split(n, f"{name}'s {ax}", m) if ax in MODEL_AXES
                      else n for n, ax in zip(shape, axes)), axes, init)
    return {k: one(k, v) for k, v in layout.items()}


def span(n: int, what: str = "ff") -> tuple[int, int]:
    """(the first, the count) of this rank's entries of an axis of `n`
    that `block_layout` cuts over "model": index() * n / m onwards; (0, n)
    outside the context."""
    k = _split(n, what, parts())
    return index() * k, k


def experts(num_experts: int) -> tuple[int, int]:
    """(the first, the count) of this rank's experts among `num_experts`
    (`span` of the experts' leading axis)."""
    return span(num_experts, "num_experts")


def _cut(n: int, nheads) -> tuple[int, int]:
    """(the first, the count) of this rank's columns among `n`: its `span`,
    or with `nheads` the columns of its head group among that many heads
    (`heads`)."""
    if nheads is None:
        return span(n)
    lo, k, _ = heads(nheads)
    per = n // nheads
    return lo * per, k * per


def own(v: torch.Tensor, pieces: int = 1, nheads=None) -> torch.Tensor:
    """The rank's `span` (with `nheads`: its head group's columns among
    that many heads) of each of the `pieces` equal pieces of the last axis
    of a replicated `v`, side by side (one piece: a view): the entries
    beside its ff columns or heads; `v` itself outside the context.  Its
    gradient is zero outside the spans, so the sum of the ranks' gradients
    over the axis is the unsharded gradient exactly."""
    if _GROUP is None:
        return v
    n = v.shape[-1] // pieces
    lo, k = _cut(n, nheads)
    if pieces == 1:
        return v.narrow(-1, lo, k)
    return v.unflatten(-1, (pieces, n)).narrow(-1, lo, k).flatten(-2)


def own_heads(out: torch.Tensor, nheads: int) -> torch.Tensor:
    """This rank's own columns of `out`, a product over its head group's
    heads among `nheads` (`heads`): of the group's columns, its share in
    run order, (nheads hd) / m of them, the rows of its block of the
    output product; `out` itself where the heads split (or outside the
    context).  Backward gives the other columns zeros, and the run's
    gathers sum the replicas' gradients (`head_columns`,
    `row_products`)."""
    r = heads(nheads)[2]
    if r == 1:
        return out
    k = out.shape[-1] // r
    return out.narrow(-1, index() % r * k, k)


def _head_group(n: int, m: int, i: int) -> tuple[int, int, int]:
    g = math.gcd(n, m)
    r = m // g
    return i // r * (n // g), n // g, r


def heads(n: int) -> tuple[int, int, int]:
    """(the first, the count, r) of the heads among `n` that this rank
    computes: where n splits over the m ranks of the axis, its own n / m
    (r = 1); elsewhere its group's: the ranks form g = gcd(n, m) groups of
    r = m / g consecutive ranks, and each group computes its n / g heads,
    replicated on its r ranks.  (0, n, 1) outside the context."""
    return _head_group(n, parts(), index())


def head_runs(cfg, m: int) -> set[int]:
    """The runs (r > 1) over which a config's heads and kv heads are
    replicated among `m` ranks (`heads`)."""
    counts = [cfg.num_heads] + ([cfg.num_kv_heads]
                                if cfg.num_kv_heads > 1 else [])
    return {r for n in counts if (r := _head_group(n, m, 0)[2]) > 1}


def _kv_heads_of(H: int, hk: int, m: int, i: int) -> int:
    """Rank i's count of kv heads among `hk` (MQA's one kv head
    replicated), ValueError unless they are the kv heads that its q heads
    among `H` read (GQA reads kv head h // (H / hk) at q head h)."""
    lo, k, _ = _head_group(H, m, i)
    if hk == 1:
        return 1
    klo, kk, _ = _head_group(hk, m, i)
    per = H // hk
    if (lo // per, (lo + k - 1) // per + 1 - lo // per) != (klo, kk):
        raise ValueError(f"rank {i}'s q heads {lo}..{lo + k - 1} of {H} "
                         f"read kv heads other than its {kk} of {hk} from "
                         f"{klo} over {m} model-parallel ranks")
    return kk


def local_config(cfg, m: int, i: int = 0):
    """The `models.transformer.ModelConfig` rank `i` computes with among
    `m` along "model": its heads (`heads`: its own, or its group's where
    they do not split; MLA's must split), its kv heads (MQA's single kv
    head is replicated), ff and vocab divided (ValueError where they do
    not split), the head dim kept.  MoE's config stays whole: routing
    runs over all E experts, so E, top_k and the capacity C are the
    global ones (a rank's experts are `experts`).  A rank's block shapes
    are `block_layout`'s."""
    if m == 1:
        return cfg
    H, hk = cfg.num_heads, cfg.num_kv_heads
    if cfg.mla is not None:
        _split(H, "MLA's num_heads", m)
    return dataclasses.replace(
        cfg, head_dim=cfg.hd,
        num_heads=_head_group(H, m, i)[1],
        num_kv_heads=_kv_heads_of(H, hk, m, i),
        d_ff=_split(cfg.d_ff, "d_ff", m),
        vocab=_split(cfg.vocab, "vocab", m))


def local_attn(acfg):
    """An `AttnConfig` for this rank's heads (`heads`; MLA's must split
    over the axis; itself outside the context)."""
    m = parts()
    if m == 1:
        return acfg
    H = acfg.num_heads
    if acfg.kv_lora is not None:
        _split(H, "MLA's num_heads", m)
    return dataclasses.replace(
        acfg, num_heads=heads(H)[1],
        num_kv_heads=_kv_heads_of(H, acfg.num_kv_heads, m, index()))


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The 2-D product a @ b accumulated and returned in float32."""
    if a.dtype == torch.float32:
        return a @ b
    if on_card(a):
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1])


def copy_in(x: torch.Tensor) -> torch.Tensor:
    """`x` in float32 behind one `Mesh.copy_to` (an input that the rank's
    blocks alone read, so its gradient is the rank's share): the gradient
    summed over the model axis in float32 and rounded once to x's dtype;
    `x` itself outside the context."""
    if _GROUP is None:
        return x
    mesh, axis = _GROUP
    return mesh.copy_to(x.float(), axis)


def summed(x: torch.Tensor) -> torch.Tensor:
    """`x` summed over the model axis (`Mesh.reduce_from`: in float32,
    rounded once to x's dtype; backward the identity); `x` itself outside
    the context."""
    if _GROUP is None:
        return x
    mesh, axis = _GROUP
    return mesh.reduce_from(x, axis)


class _Products(torch.autograd.Function):
    """``x @ w`` for each w, in the weights' dtype, from a float32 `x`; x's
    gradient is the products' float32 shares summed, in float32."""

    @staticmethod
    def forward(ctx, x, *ws):
        xs = x.to(ws[0].dtype)
        ctx.save_for_backward(xs, *ws)
        return tuple(xs @ w for w in ws)

    @staticmethod
    def backward(ctx, *grads):
        xs, *ws = ctx.saved_tensors
        gx, gws = None, []
        for g, w in zip(grads, ws):
            g = _flat(g)
            part = _mm32(g, w.t())
            gx = part if gx is None else gx.add_(part)
            gws.append(_flat(xs).t() @ g)
        return (gx.view(xs.shape), *gws)


class _Mm32(torch.autograd.Function):
    """``x @ w`` accumulated and returned in float32 (a row-parallel
    partial); the plain gradients in x's dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm32(_flat(x), w).view(*x.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = _flat(g).to(x.dtype)
        return (g2 @ w.t()).view(x.shape), _flat(x).t() @ g2


def column(x: torch.Tensor, *ws: torch.Tensor) -> tuple:
    """``x @ w`` for each of `ws`: column-parallel products on one input
    (the rank's columns of each weight) behind one `Mesh.copy_to`, so the
    input's gradient is summed over the model axis once, in float32, and
    rounded once; the plain products outside the context."""
    if _GROUP is None:
        return tuple(x @ w for w in ws)
    return _Products.apply(copy_in(x), *ws)


class _RunGather(torch.autograd.Function):
    """The blocks (..., c) of the r ranks of this rank's run along the
    axis, gathered on the last axis into its group's (..., r c); backward
    sums the r replicas' gradients of the whole over the run in float32,
    rounds once to the block's dtype, and keeps the rank's block (a
    reduce-scatter: each replica reads the group's columns on its own
    share alone)."""

    @staticmethod
    def forward(ctx, mesh, axis, r, blk):
        ctx.mesh, ctx.axis, ctx.r = mesh, axis, r
        ctx.dtype, ctx.k = blk.dtype, blk.shape[-1]
        return mesh.all_gather(blk, axis, blk.dim() - 1, run=r)

    @staticmethod
    def backward(ctx, g):
        total = ctx.mesh.all_reduce_sum(
            g.float().contiguous() if g.dtype != torch.float32 else
            g.clone(memory_format=torch.contiguous_format), ctx.axis,
            run=ctx.r)
        i = ctx.mesh.index(ctx.axis) % ctx.r
        return (None, None, None,
                total[..., i * ctx.k:(i + 1) * ctx.k].to(ctx.dtype))


def head_columns(x: torch.Tensor, *pairs) -> tuple:
    """``x @ w`` for each pair ``(w, nheads)`` (a weight whose columns are
    `nheads` heads side by side): inside the context `w` is the rank's
    block of JAX's even column cut, and each product is the columns of
    the rank's heads (`heads`), column-parallel on one input as `column`'s;
    where the heads do not split, the r ranks of the group's run gather
    their blocks of the weight through `_RunGather`.  A replicated weight
    (MQA's kv, ``nheads`` 1) is taken whole.  The plain products outside
    the context."""
    if _GROUP is None:
        return tuple(x @ w for w, _ in pairs)
    mesh, axis = _GROUP
    runs = [heads(n)[2] if n > 1 else 1 for _, n in pairs]
    ws = [_RunGather.apply(mesh, axis, r, w) if r > 1 else w
          for (w, _), r in zip(pairs, runs)]
    return _Products.apply(copy_in(x), *ws)


def row(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for the rank's rows of `w`: the float32 partial product
    summed over the model axis by `Mesh.reduce_from` and rounded once to
    x's dtype; the plain product outside the context."""
    if _GROUP is None:
        return x @ w
    mesh, axis = _GROUP
    return mesh.reduce_from(_Mm32.apply(x, w), axis, x.dtype)


class _SumColumns(torch.autograd.Function):
    """The float32 partials (..., n_i) summed over the model axis in one
    collective, rounded once to `dtype`, and each cut to its column ranges
    `cuts[i]` (side by side).  Backward gives each partial the gradient of
    all its columns: the ranks' column gradients put in place among zeros
    and summed over the axis in float32 (one rank adds a non-zero, so the
    sum is their gather exactly)."""

    @staticmethod
    def forward(ctx, mesh, axis, dtype, cuts, *partials):
        widths = [p.shape[-1] for p in partials]
        ctx.mesh, ctx.axis, ctx.cuts, ctx.widths = mesh, axis, cuts, widths
        total = mesh.all_reduce_sum(torch.cat(partials, dim=-1), axis)
        total = total.to(dtype)
        out, off = [], 0
        for w, cut in zip(widths, cuts):
            parts = [total[..., off + a:off + b] for a, b in cut]
            out.append(parts[0].contiguous() if len(parts) == 1
                       else torch.cat(parts, dim=-1))
            off += w
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        ref = next(g for g in grads if g is not None)
        full = ref.new_zeros(*ref.shape[:-1], sum(ctx.widths),
                             dtype=torch.float32)
        off = 0
        for w, cut, g in zip(ctx.widths, ctx.cuts, grads):
            at = 0
            for a, b in cut:
                if g is not None:
                    full[..., off + a:off + b] = g[..., at:at + b - a]
                at += b - a
            off += w
        ctx.mesh.all_reduce_sum(full, ctx.axis)
        return (None, None, None, None, *full.split(ctx.widths, dim=-1))


def row_products(*pairs, nheads=None) -> tuple:
    """``x @ w`` for each pair ``(x, w)`` or ``(x, w, pieces)``, cut to the
    rank's columns: each x is the rank's columns of an input and each w
    (n_l, n) the rank's rows of a weight whose input axis is sharded; the
    float32 partial products are summed over the model axis in one
    collective, rounded once to the first x's dtype, and each product keeps
    the rank's `span` of each of its `pieces` (default 1) equal pieces,
    side by side (with `nheads`: the columns of its head group among that
    many heads in each piece, `heads`).  Each x's gradient is its columns
    of the unsharded one, and each w's the rank's rows of the unsharded
    one, with no sum (a head group's replicas each give their share, and
    the backward's sum adds them).  The plain products outside the
    context."""
    if _GROUP is None:
        return tuple(p[0] @ p[1] for p in pairs)
    mesh, axis = _GROUP
    cuts = []
    for p in pairs:
        pieces = p[2] if len(p) > 2 else 1
        n = p[1].shape[1] // pieces
        lo, k = _cut(n, nheads)
        cuts.append(tuple((j * n + lo, j * n + lo + k)
                          for j in range(pieces)))
    return _SumColumns.apply(mesh, axis, pairs[0][0].dtype, tuple(cuts),
                             *(_Mm32.apply(p[0], p[1]) for p in pairs))


class _AllSum(torch.autograd.Function):
    """`x` summed over the model axis, forward and backward: every rank
    reads the sum on its own columns, so each rank's part gets the sum of
    their gradients."""

    @staticmethod
    def forward(ctx, mesh, axis, x):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_reduce_sum(
            x.clone(memory_format=torch.contiguous_format), axis)

    @staticmethod
    def backward(ctx, g):
        return None, None, ctx.mesh.all_reduce_sum(
            g.clone(memory_format=torch.contiguous_format), ctx.axis)


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """`x` summed over the model axis, its gradient summed too (a
    statistic of rows whose columns the ranks share: the mLSTM norm's sum
    of squares); `x` itself outside the context."""
    if _GROUP is None:
        return x
    mesh, axis = _GROUP
    return _AllSum.apply(mesh, axis, x)


class _Exchange(torch.autograd.Function):
    """The ranks' blocks of a fused product (..., P n / m) gathered over
    the model axis into the whole (..., P n), each of its P pieces cut to
    the rank's span lo .. lo + k; backward gathers every rank's span
    gradients and keeps the rank's block of the whole gradient (each
    column's gradient comes from the one rank whose span holds it, so
    both ways are exact)."""

    @staticmethod
    def forward(ctx, mesh, axis, pieces, blk):
        full = mesh.all_gather(blk, axis, blk.dim() - 1)
        n = full.shape[-1] // pieces
        lo, k = span(n)
        ctx.mesh, ctx.axis, ctx.dims = mesh, axis, (pieces, n // k, k, lo)
        return tuple(full[..., j * n + lo:j * n + lo + k].contiguous()
                     for j in range(pieces))

    @staticmethod
    def backward(ctx, *grads):
        pieces, m, k, lo = ctx.dims
        ref = next(g for g in grads if g is not None)
        mine = torch.cat([torch.zeros_like(ref) if g is None else g
                          for g in grads], dim=-1)
        every = ctx.mesh.all_gather(mine, ctx.axis, mine.dim() - 1)
        # rank q's gradient of piece j's span sits at (q, j); the whole
        # gradient's column j n + q k + i at (j, q, i)
        grad = every.unflatten(-1, (m, pieces, k)).transpose(-3, -2)
        first = lo // k * pieces * k
        return (None, None, None,
                grad.flatten(-3)[..., first:first + pieces * k].contiguous())


def fused(x: torch.Tensor, w: torch.Tensor, pieces: int) -> tuple:
    """The `pieces` products of ``x @ w`` for a fused weight whose columns
    are equal pieces side by side (``torch.chunk(x @ w, pieces)`` outside
    the context).  Inside it `w` is the rank's contiguous block of the
    columns (JAX's cut, not the rank's span of each piece): its product is
    column-parallel on `x` (`column`), and the products are exchanged over
    the model axis (`_Exchange`: one gather forward, one backward), so
    that each product is the rank's span of its piece."""
    if _GROUP is None:
        return torch.chunk(x @ w, pieces, dim=-1)
    mesh, axis = _GROUP
    (blk,) = column(x, w)
    return _Exchange.apply(mesh, axis, pieces, blk)


class _Whole(torch.autograd.Function):
    """The ranks' column blocks of a weight gathered over the model axis;
    backward keeps the rank's columns of the gradient, with no sum (the
    computation that reads it is replicated, so every rank's gradient of
    the whole is the same)."""

    @staticmethod
    def forward(ctx, mesh, axis, blk):
        ctx.cols = (blk.shape[-1] * mesh.index(axis), blk.shape[-1])
        return mesh.all_gather(blk, axis, blk.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        lo, k = ctx.cols
        return None, None, g[..., lo:lo + k].contiguous()


def whole(*ws: torch.Tensor) -> tuple:
    """Each of `ws` whole: inside the context each is the rank's block of
    the last axis of a weight that a computation replicated over the model
    axis reads whole (the sLSTM's gates), all of one block width; they are
    gathered in one collective, and each one's gradient is the rank's block
    of the whole gradient.  `ws` themselves outside the context."""
    if _GROUP is None:
        return ws
    mesh, axis = _GROUP
    c = ws[0].shape[-1]
    flat = torch.cat([w.reshape(-1, c) for w in ws], dim=0)
    full = _Whole.apply(mesh, axis, flat)
    return tuple(part.reshape(*w.shape[:-1], full.shape[-1]) for part, w in
                 zip(full.split([w.numel() // c for w in ws], dim=0), ws))


def gathered(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The `x` of every rank of the model axis concatenated on `dim` in
    rank order (one all-gather, forward only: serving runs under
    `torch.no_grad`); `x` itself outside the context."""
    if _GROUP is None:
        return x
    mesh, axis = _GROUP
    return mesh.all_gather(x, axis, dim % x.dim())


def gather_vocab(logits: torch.Tensor) -> torch.Tensor:
    """The logits over the whole vocabulary from the rank's vocab columns
    (..., V / m) of them: one gather over the model axis, so that every
    rank holds JAX's ``P(batch, None, None)`` logits; `logits` itself
    outside the context."""
    return gathered(logits, -1)


def all_max(x: torch.Tensor) -> torch.Tensor:
    """`x`'s elementwise maximum over the model axis (a new tensor; forward
    only): a softmax's max over positions that the ranks split; `x` itself
    outside the context."""
    if _GROUP is None:
        return x
    mesh, axis = _GROUP
    return mesh.all_reduce_max(x.contiguous(), axis)


def embedding(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``F.embedding(tokens, whole table)``: outside the context the plain
    lookup; inside it `table` is this rank's rows index() * V_l ..
    (index() + 1) * V_l, tokens outside them give zeros, and the sum over
    the axis equals the unsharded lookup bitwise."""
    if _GROUP is None:
        return F.embedding(tokens, table)
    rows = table.shape[0]
    local = tokens - index() * rows
    mine = (local >= 0) & (local < rows)
    x = F.embedding(torch.where(mine, local, 0), table)
    mesh, axis = _GROUP
    return mesh.reduce_from(torch.where(mine[..., None], x, 0), axis)


class _VocabNLL(torch.autograd.Function):
    """Each position's -log softmax(logits)[target] over the whole
    vocabulary, from this rank's float32 logits (B, c, V_l) of vocabulary
    entries v0 .. v0 + V_l; the same value on every rank of the axis."""

    @staticmethod
    def forward(ctx, logits, targets, v0, mesh, axis):
        m = mesh.all_reduce_max(logits.amax(dim=-1), axis)
        sumexp = torch.exp(logits - m[..., None]).sum(dim=-1)
        logz = m + torch.log(mesh.all_reduce_sum(sumexp, axis))
        local = targets.long() - v0
        mine = (local >= 0) & (local < logits.shape[-1])
        idx = torch.where(mine, local, 0)
        gold = torch.where(mine, logits.gather(-1, idx[..., None])[..., 0],
                           0.0)
        gold = mesh.all_reduce_sum(gold.contiguous(), axis)
        ctx.save_for_backward(logits, logz, idx, mine)
        return logz - gold

    @staticmethod
    def backward(ctx, grad):
        logits, logz, idx, mine = ctx.saved_tensors
        d = torch.exp(logits - logz[..., None])
        d.scatter_add_(-1, idx[..., None], -mine[..., None].to(d.dtype))
        return d.mul_(grad[..., None]), None, None, None, None


def _chunk_nll(hs, head, ts, ms, v0):
    """(sum of the chunk's masked NLL, sum of its mask), float32, from this
    rank's head columns."""
    mesh, axis = _GROUP
    nll = _VocabNLL.apply((hs @ head).float(), ts, v0, mesh, axis)
    return (nll * ms).sum(), ms.sum()


def chunked_cross_entropy(hidden, head, targets, mask, chunk: int = 512,
                          mask_count=None):
    """`models.common.chunked_cross_entropy` with a vocab-parallel head:
    `head` (D, V_l) is this rank's columns index() * V_l .. of the whole
    head, and `hidden` enters through `Mesh.copy_to` once.  Chunks run in order
    and are recomputed in backward; the sum is divided by max(`mask_count`,
    1) (default: the mask's sum).  Every rank of the axis returns the same
    value."""
    B, S, D = hidden.shape
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"loss chunk {chunk}")
    mesh, axis = _GROUP
    hidden = mesh.copy_to(hidden, axis)
    v0 = index() * head.shape[1]
    tot = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, S, chunk):
        nll, m = checkpoint(_chunk_nll, hidden[:, i:i + chunk], head,
                            targets[:, i:i + chunk], mask[:, i:i + chunk],
                            v0, use_reentrant=False)
        tot, cnt = tot + nll, cnt + m
    if mask_count is not None:
        cnt = mask_count
    return tot / torch.clamp_min(cnt, 1.0)


__all__ = ["model_parallel", "active", "parts", "index",
           "computes_on_blocks", "MODEL_AXES", "block_layout", "span",
           "heads", "head_runs", "experts", "own", "own_heads",
           "local_config", "local_attn", "copy_in", "summed", "column",
           "head_columns", "row", "row_products",
           "all_sum", "all_max", "gathered", "gather_vocab", "fused",
           "whole", "embedding",
           "chunked_cross_entropy"]
