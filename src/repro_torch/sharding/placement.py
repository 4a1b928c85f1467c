"""The training state on a mesh: each rank's block of every leaf under
`train.train_state_specs`, as JAX places a state with ``device_put(state,
NamedSharding(mesh, specs))``, the gathers back, and ZeRO-1's regions; and
the serving placement (`ServePlacement`): the weights' blocks, a batch's
rows and a decode cache's block for the sharded prefill and decode steps.

The specs are in JAX's layout, whose stacked leaves carry a leading layer
axis; the port holds one tensor a layer (`models.convert.jax_pieces` lists
them, `port_layout` takes them back).  A weight's layer axis is never
sharded, so each layer's tensor takes its leaf's spec without the first
entry.  ZeRO-1 (`optim.zero1_specs`) shards a moment's largest free axis
over the data axes, and that can be the layer axis: a rank then holds the
moments of whole layers, its contiguous share of them (`owned_layers`), and
an empty tensor for every other layer; `TrainPlacement.layer_leaves` lists
such leaves.  Blocks are cut by `checkpointing.elastic`'s rule, row-major
over a dimension's axes, so a whole state resharded by `elastic.reshard`
gives the same blocks in JAX's layout.

Cutting needs only the mesh's shape and this rank's coordinates (a
`core.mesh.ShapeMesh` with ``coord`` set will do); gathering and ZeRO-1's
rebuild run `Mesh.all_gather`.  The sharded train step
(`train.make_train_step(..., mesh=)`) is the reader.  Every family
computes on the rank's blocks (Megatron compute over "model",
`tensor_parallel.computes_on_blocks`), so its gradients are blocks too:
`regions` cuts them over the data axes only, as the weights' blocks, and
`leaf_roles` says which gradients are blocks, which are whole and which
are a rank's share of a replicated leaf.  The step updates the region of
each leaf that the rank's moments cover and rebuilds the weights' blocks
over the data axes.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..checkpointing.elastic import _block
from ..core.mesh import axes_of
from ..models.convert import jax_pieces, port_layout
from ..models.hybrid import StateCache
from . import tensor_parallel
from .rules import SINGLE_POD_RULES


def data_axes(rules, mesh) -> tuple[str, ...]:
    """The axes `rules` shards the batch over, as a tuple; ValueError unless
    they span the mesh's data-parallel ranks (pod x data)."""
    axes = rules.axis("batch")
    axes = ("data",) if axes is None else axes_of(axes)
    want = mesh.shape["data"] * mesh.shape.get("pod", 1)
    if not set(axes) <= set(mesh.shape) or mesh.axis_size(axes) != want:
        raise ValueError(f"the batch axes {axes} of the rules do not span "
                         f"the {want} data-parallel ranks of {mesh}")
    return axes


def owned_layers(mesh, lead, n: int) -> range:
    """The layers of a stacked leaf of `n` whose layer axis is sharded over
    `lead` (None: not sharded) that this rank holds."""
    if lead is None:
        return range(n)
    mine = _block(np.arange(n), mesh, (lead,))
    return range(int(mine[0]), int(mine[-1]) + 1)


def _walk(fn, tree, spec, path=""):
    """`fn(path, x, spec)` over the leaves of a tree in JAX's layout (a
    stacked leaf a list of pieces), matched to a spec tree by key."""
    if isinstance(spec, dict):
        return {k: _walk(fn, tree[k], spec[k], f"{path}/{k}") for k in spec}
    return fn(path, tree, tuple(spec))


def _gather_block(mesh, x, spec):
    for dim, ax in enumerate(spec):
        if ax is not None:
            x = mesh.all_gather(x, ax, dim)
    return x


class _Blocks:
    """Cutting a tree in the port's layout into this rank's blocks by a
    spec tree in JAX's layout, and gathering the blocks back."""

    model = mesh = None

    def _cut(self, x, spec):
        def one(t, s):
            return _block(t, self.mesh, s).detach().clone()
        if not isinstance(x, list):
            return one(x, spec)
        mine = owned_layers(self.mesh, spec[0], len(x))
        return [one(t, spec[1:]) if i in mine else t.new_empty(0)
                for i, t in enumerate(x)]

    def _gather(self, x, spec):
        mesh = self.mesh
        if not isinstance(x, list):
            return _gather_block(mesh, x, spec)
        if spec[0] is None:
            return [_gather_block(mesh, t, spec[1:]) for t in x]
        mine = owned_layers(mesh, spec[0], len(x))
        whole = _gather_block(mesh, torch.stack([x[i] for i in mine]), spec)
        return list(whole.unbind(0))

    def _map(self, fn, tree, specs) -> dict:
        return port_layout(_walk(lambda _, x, s: fn(x, s),
                                 jax_pieces(tree, self.model), specs),
                           self.model)

    def gather_params(self, blocks: dict) -> dict:
        """The whole weights of the ranks' blocks, in the port's layout."""
        return self._map(self._gather, blocks, self.pspecs)


class TrainPlacement(_Blocks):
    """Where each leaf of `model`'s training state lies on `mesh` under
    `rules`: weights by ``model.param_specs(rules)``, AdamW's moments by
    ZeRO-1 over the data axes (`train_state_specs`)."""

    def __init__(self, model, mesh, rules=SINGLE_POD_RULES):
        from ..train.train_step import train_state_specs

        self.model, self.mesh = model, mesh
        self.data_axes = data_axes(rules, mesh)
        specs = train_state_specs(model, rules,
                                  mesh.axis_size(self.data_axes))
        self.pspecs, self.mspecs = specs["params"], specs["opt"]["m"]

    def _is_data(self, ax) -> bool:
        return ax is not None and axes_of(ax) == self.data_axes

    def _data_only(self, spec) -> tuple:
        """`spec` with the entries that do not name the data axes cleared:
        a moment's region within its weight's block."""
        return tuple(ax if self._is_data(ax) else None for ax in spec)

    def shard(self, state: dict) -> dict:
        """This rank's blocks (copies) of a whole state in the port's layout
        (`train.init_train_state`, `convert.train_state_from_jax`); the
        step is replicated."""
        opt = state["opt"]
        return {"params": self._map(self._cut, state["params"], self.pspecs),
                "opt": {"m": self._map(self._cut, opt["m"], self.mspecs),
                        "v": self._map(self._cut, opt["v"], self.mspecs),
                        "step": opt["step"].detach().clone()}}

    def gather(self, state: dict) -> dict:
        """The whole state of the blocks of every rank (each rank of the
        mesh calls this and gets all of it)."""
        opt = state["opt"]
        return {"params": self.gather_params(state["params"]),
                "opt": {"m": self._map(self._gather, opt["m"], self.mspecs),
                        "v": self._map(self._gather, opt["v"], self.mspecs),
                        "step": opt["step"]}}

    # -- ZeRO-1 -------------------------------------------------------------
    def regions(self, blocks: dict, grads: dict, m: dict, v: dict):
        """For each piece of the rank's moments: (the view of its weights'
        block that it covers, the gradient over it, m, v).  `grads`, in the
        port's layout, are the weights' blocks (Megatron compute,
        `tensor_parallel`), cut as the weights over the data axes."""
        mesh = self.mesh
        out = []

        def leaf(path, x, spec):
            p, g, mm, vv = x
            if not isinstance(p, list):
                z = self._data_only(spec)
                out.append((_block(p, mesh, z), _block(g, mesh, z), mm, vv))
                return
            z = self._data_only(spec[1:])
            for i in owned_layers(mesh, spec[0], len(p)):
                out.append((_block(p[i], mesh, z), _block(g[i], mesh, z),
                            mm[i], vv[i]))

        trees = [jax_pieces(t, self.model) for t in (blocks, grads, m, v)]
        _walk(leaf, _zip4(*trees), self.mspecs)
        return out

    def rebuild(self, blocks: dict) -> None:
        """After each rank updated its regions: every weight block whole
        again, gathered over the data axes (in place)."""
        mesh = self.mesh

        def one(t, spec):
            z = self._data_only(spec)
            for dim, ax in enumerate(z):
                if ax is not None:
                    t.copy_(mesh.all_gather(_block(t, mesh, z), ax, dim))

        def leaf(path, p, spec):
            if not isinstance(p, list):
                one(p, spec)
            elif spec[0] is None:
                for t in p:
                    one(t, spec[1:])
            else:
                mine = owned_layers(mesh, spec[0], len(p))
                whole = mesh.all_gather(torch.stack([p[i] for i in mine]),
                                        spec[0], 0)
                for t, w in zip(p, whole):
                    t.copy_(w)

        _walk(leaf, jax_pieces(blocks, self.model), self.mspecs)

    def leaf_roles(self) -> dict:
        """Under Megatron compute, each weight's gradient on a rank, in the
        port's layout: "block" (the rank's block of a leaf its spec shards
        over "model": heads, ff, vocab, MoE's experts and shared experts,
        MLA's wq_b, w_uk, w_uv and wo, Griffin's conv, xLSTM's fused
        w_up and the sLSTM's gate weights, whose gradients the layer cuts to
        the block), "partial" (a replicated leaf that the rank's heads or
        columns alone read, so its gradient is the rank's share: MQA's
        single kv head's wk and wv, the transformer's and Griffin's; the
        RG-LRU's gate biases b_rg, b_ig and its decay lam, read on the
        rank's columns; the mLSTM's gate bias b_if, read on the rank's
        heads) or "whole" (the norms, MoE's router, MLA's wq_a and w_dkv,
        whose products' gradients are summed over "model" inside the layer;
        the sLSTM's conv and norm, computed whole on every rank)."""
        partial = _PARTIAL
        if self.model.cfg.num_kv_heads == 1:
            partial += _MQA_PARTIAL

        def role(path, x, spec):
            axes = {a for ax in spec if ax is not None for a in axes_of(ax)}
            r = ("block" if "model" in axes else
                 "partial" if path.endswith(partial) else "whole")
            return [r] * len(x) if isinstance(x, list) else r
        abstract = port_layout(self.model.abstract_params(), self.model)
        return port_layout(_walk(role, jax_pieces(abstract, self.model),
                                 self.pspecs), self.model)

    def layer_leaves(self) -> list[str]:
        """The JAX leaves whose moments shard the layer axis (the rank holds
        whole layers of them), by path."""
        found = []

        def leaf(path, x, spec):
            if isinstance(x, list) and spec[0] is not None:
                found.append(path)
        abstract = port_layout(self.model.abstract_params(), self.model)
        _walk(leaf, jax_pieces(abstract, self.model), self.mspecs)
        return found


#: the replicated leaves that a rank reads on its own columns or heads
#: alone (JAX path endings): the RG-LRU's gate biases and decay, the
#: mLSTM's gate bias, and MQA's kv projections (the transformer's, and
#: Griffin's attention layers')
_PARTIAL = ("/mix/b_rg", "/mix/b_ig", "/mix/lam", "/m/b_if")
_MQA_PARTIAL = ("/attn/wk", "/attn/wv", "/attn/mix/wk", "/attn/mix/wv")


class ServePlacement(_Blocks):
    """Where `model`'s weights, a batch and a decode cache lie on `mesh`
    under `rules` for the sharded prefill and decode steps
    (`launch.steps.make_serve_step`): the weights by
    ``model.param_specs(rules)`` (the train step's blocks, no optimizer
    moments); the rows of a batch over the data axes, or every row where
    the rules replicate the batch (``"batch": None``, JAX's rule for the
    one-sequence cells, `serve_rules`); and the rank's block of the cache
    (the state follows the compute: a rank holds what its blocks read):
      * its rows, as the batch's;
      * the transformer's layer list (`TransformerLM.init_cache`): the kv
        columns of the kv heads the rank computes on (`tensor_parallel.
        heads`: its own, or its head group's whole heads where they do not
        split over "model", not JAX's even column cut); MQA's single kv
        head whole, as JAX's ``kv_axis = None``; MLA's latent and its
        ``pos`` as the rank's contiguous share of the slots (JAX's
        ``"pos": spec("heads")``); ``pos`` of a GQA cache and ``next``
        whole;
      * Griffin's `hybrid.StateCache` (a dict a layer): a rec layer's
        ``h`` and conv tail on the rank's span of the d_rnn columns (those
        `tensor_parallel.column` gives it of u), an attention layer's ring
        as a GQA cache's (MQA: its one kv head whole);
      * xLSTM's `StateCache` (a dict a unit): the mLSTM's C, n and m of the
        heads the rank computes (its head group's where they do not split),
        its conv tail on the rank's span of u (`tensor_parallel.fused`'s
        columns, not its heads'), the sLSTM's state and conv tail whole;
        and the cache's ``next`` whole.
    JAX's ``cache_specs`` split the recurrent states over the batch only:
    there a rank holds every column.  Cutting needs only the mesh's shape
    and this rank's coordinates; `gather_cache` runs `Mesh.all_gather`."""

    def __init__(self, model, mesh, rules=SINGLE_POD_RULES):
        self.model, self.mesh = model, mesh
        self.pspecs = model.param_specs(rules)
        #: the batch's axes, None where the rules replicate it
        self.data_axes = (None if rules.axis("batch") is None
                          else data_axes(rules, mesh))

    def shard(self, params: dict) -> dict:
        """This rank's blocks (copies) of whole weights in the port's
        layout (`model.tree()`)."""
        return self._map(self._cut, params, self.pspecs)

    def draw(self, generator: torch.Generator, device) -> dict:
        """This rank's blocks of the weights ``model.init(generator,
        device=device)`` draws: the layout's leaves drawn in its order, as
        `models.common.init_params` draws them, each leaf whole only while
        its block is cut (so a rank never holds the whole weights)."""
        from ..models.common import _init_tensor

        dtype = self.model.cfg.dtype

        def walk(lay, spec):
            out = {}
            for name, v in lay.items():
                if isinstance(v, dict):
                    out[name] = walk(v, spec[name])
                    continue
                whole = _init_tensor(v[0], v[2], dtype, generator, device)
                out[name] = _block(whole, self.mesh, spec[name]).clone()
                del whole
            return out
        return port_layout(walk(self.model.layout(), self.pspecs),
                           self.model)

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of `n`: its contiguous share
        along the data axes, in their row-major order (all of them where
        the batch is replicated); ValueError where n does not split."""
        if self.data_axes is None:
            return slice(0, n)
        d = self.mesh.axis_size(self.data_axes)
        if n % d:
            raise ValueError(f"a batch of {n} rows does not split over the "
                             f"{d} data-parallel ranks")
        i = self.mesh.index(self.data_axes)
        return slice(i * n // d, (i + 1) * n // d)

    # -- the cache's block ------------------------------------------------
    def _cuts(self, entry: dict) -> dict:
        """How each leaf of a cache entry (a layer's or a unit's dict) lies:
        a tree of (rows, dim, nheads): whether its first axis is the rows;
        its axis cut over "model" (None: whole over "model"); the heads
        that axis holds, cut to the ones the rank computes
        (`tensor_parallel.heads`; 1: whole), or None: the rank's span."""
        cfg = self.model.cfg
        rows_only = (True, None, None)
        if "latent" in entry:                       # MLA: the slots split
            return {"latent": (True, 1, None), "pos": (False, 0, None),
                    "next": (False, None, None)}
        if "k" in entry:                            # GQA / MQA: the kv heads
            kv = (True, 2, cfg.num_kv_heads)
            return {"k": kv, "v": kv, "pos": (False, None, None),
                    "next": (False, None, None)}
        if "h" in entry:                            # an RG-LRU layer
            return {"h": (True, 1, None), "conv": (True, 2, None)}
        heads = (True, 1, cfg.num_heads)            # an xLSTM unit
        return {"m": {"rec": {k: heads for k in entry["m"]["rec"]},
                      "conv": (True, 2, None)},
                "s": {"rec": {k: rows_only for k in entry["s"]["rec"]},
                      "conv": rows_only}}

    def _over_cache(self, fn, cache: list) -> list:
        """`fn(t, cut)` over every leaf of every entry of `cache` (and its
        ``next`` whole, for a `hybrid.StateCache`)."""
        def walk(entry, cuts):
            return {k: (walk(v, cuts[k]) if isinstance(v, dict)
                        else fn(v, cuts[k])) for k, v in entry.items()}
        out = [walk(c, self._cuts(c)) for c in cache]
        if isinstance(cache, StateCache):
            return StateCache(out, fn(cache.next, (False, None, None)))
        return out

    def _columns(self, n: int, nheads) -> slice:
        """This rank's entries of an axis of `n` cut over "model": its span,
        or with `nheads` those of the heads it computes among that many
        (`tensor_parallel.heads`; one head is whole)."""
        with tensor_parallel.model_parallel(self.mesh):
            if nheads is None:
                lo, k = tensor_parallel.span(n, "a cache axis")
            elif nheads == 1:
                lo, k = 0, n
            else:
                first, count, _ = tensor_parallel.heads(nheads)
                lo, k = first * n // nheads, count * n // nheads
        return slice(lo, lo + k)

    def shard_cache(self, cache: list) -> list:
        """This rank's block (copies) of a whole decode cache."""
        def cut(t, how):
            has_rows, dim, nheads = how
            if has_rows:
                t = t[self.rows(len(t))]
            if dim is not None:
                at = self._columns(t.shape[dim], nheads)
                t = t.narrow(dim, at.start, at.stop - at.start)
            return t.clone()
        return self._over_cache(cut, cache)

    def gather_cache(self, cache: list) -> list:
        """The whole decode cache of the ranks' blocks, in the port's
        layout (each rank of the mesh calls this and gets all of it)."""
        mesh = self.mesh
        m = mesh.axis_size("model")

        def gather(t, how):
            has_rows, dim, nheads = how
            if dim is not None and nheads != 1:
                every = mesh.all_gather(t, "model", dim)
                run = 1 if nheads is None else m // math.gcd(nheads, m)
                if run > 1:     # one rank of each head group's run, in order
                    w = t.shape[dim]
                    every = torch.cat([every.narrow(dim, j * w, w)
                                       for j in range(0, m, run)], dim=dim)
                t = every
            if has_rows and self.data_axes is not None:
                t = mesh.all_gather(t, self.data_axes, 0)
            return t
        return self._over_cache(gather, cache)

    def init_cache(self, batch: int, max_len: int, device=None) -> list:
        """This rank's block of an empty cache for a global `batch` of
        rows (the model's `init_cache` under the context)."""
        n = len(range(batch)[self.rows(batch)])
        with tensor_parallel.model_parallel(self.mesh):
            return self.model.init_cache(n, max_len, device)


def serve_rules(rules, batch: int):
    """`rules` for a serving cell of a global `batch`: JAX's, with the batch
    replicated (``"batch": None``) for one sequence (long_500k), as
    `repro.launch.steps.build_cell` rebuilds them."""
    if batch != 1:
        return rules
    return dataclasses.replace(rules, rules={**rules.rules, "batch": None})


def _zip4(*trees):
    """Like trees of JAX's layout zipped into one whose leaves are tuples
    (a stacked leaf a tuple of lists)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _zip4(*(t[k] for t in trees)) for k in first}
    return tuple(trees)


def shard_train_state(state: dict, model, mesh,
                      rules=SINGLE_POD_RULES) -> dict:
    """This rank's blocks of a whole training state (`TrainPlacement.shard`),
    as JAX's ``device_put`` of the state by `train_state_specs`."""
    return TrainPlacement(model, mesh, rules).shard(state)


def gather_train_state(state: dict, model, mesh,
                       rules=SINGLE_POD_RULES) -> dict:
    """The whole training state of a sharded one; every rank of the mesh
    calls this."""
    return TrainPlacement(model, mesh, rules).gather(state)


def state_bytes(tree) -> int:
    """Bytes of a tree's tensors (meta tensors counted as if allocated)."""
    if isinstance(tree, dict):
        return sum(state_bytes(v) for v in tree.values())
    if isinstance(tree, StateCache):
        return sum(state_bytes(v) for v in tree) + state_bytes(tree.next)
    if isinstance(tree, (list, tuple)):
        return sum(state_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


__all__ = ["TrainPlacement", "ServePlacement", "serve_rules", "data_axes",
           "owned_layers",
           "shard_train_state", "gather_train_state", "state_bytes"]
