"""The training state on a mesh: each rank's block of every leaf under
`train.train_state_specs`, as JAX places a state with ``device_put(state,
NamedSharding(mesh, specs))``, the gathers back, and ZeRO-1's regions.

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

import numpy as np
import torch

from ..checkpointing.elastic import _block
from ..core.mesh import axes_of
from ..models.convert import jax_pieces, port_layout
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


class TrainPlacement:
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

    # -- cutting and gathering ---------------------------------------------
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

    def gather_params(self, blocks: dict) -> dict:
        """The whole weights of the ranks' blocks, in the port's layout."""
        return self._map(self._gather, blocks, self.pspecs)

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
    if isinstance(tree, (list, tuple)):
        return sum(state_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


__all__ = ["TrainPlacement", "data_axes", "owned_layers",
           "shard_train_state", "gather_train_state", "state_bytes"]
