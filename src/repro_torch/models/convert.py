"""Carry parameter trees and decode caches between the JAX package and
the port.

A JAX parameter tree is a nested dict of arrays under JAX's names:
  * transformer: the layers stacked on axis 0 under ``params["layers"]``
    (or as ``"l0"``, ``"l1"``, ... when the config does not scan its
    layers), MoE's shared experts a nested dict, and ``head`` absent when
    the embeddings are tied;
  * Griffin: ``units`` = {rec1, rec2, attn} stacked on axis 0 over the
    units, ``tail{i}`` the tail rec layers, ``embed``, ``ln_out``;
  * xLSTM: ``units`` = {ln_m, m, ln_s, s} stacked, ``embed``, ``ln_out``.
`params_from_jax` builds the port's model from one, so that both packages
compute with the same weights; `to_numpy_tree` gives the tree back.

A JAX decode cache:
  * transformer: one dict ({"k", "v", "pos", "next"}, or MLA's {"latent",
    "pos", "next"}) with every leaf stacked on axis 0 over the layers (a
    list of dicts when the config does not scan its layers);
  * Griffin: {"rec1", "rec2": {h float32, conv} stacked over the units,
    "attn": the rings stacked, "tails": [{h, conv}], "next"};
  * xLSTM: {"units": {"m": {"rec": {C, n, m}, "conv"}, "s": {"rec": {c, n,
    m, h}, "conv"}} stacked, "next"}.
The port keeps a list of one dict a layer (a `hybrid.StateCache`, with
``next``, for the recurrent families; one dict a unit for xLSTM).
`cache_from_jax` and `cache_to_numpy` carry it across and back, the state
that crosses between the packages beside the weights.

A JAX training state is ``{"params", "opt": {"m", "v", "step"}}`` with m
and v float32 trees in the parameters' layout; the port's
(`train.train_step`) holds the same in its own per-layer layout.
`train_state_from_jax` and `train_state_to_numpy` carry it across and
back (a sharded state gathered first), and `jax_layout` maps any tree in
the port's parameter layout (a gradient, a moment) to JAX's.  `jax_leaf_groups` lists, for each JAX leaf,
the port's tensors it stacks: int8 error feedback takes one scale a JAX
leaf (`optim.compression`).

Arrays are read through numpy (a JAX array converts itself), bfloat16 by
its bits, so nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from ..sharding.rules import SINGLE_POD_RULES
from .hybrid import StateCache
from .registry import build_model
from .transformer import ModelConfig, layer_trees

#: the cache leaves kept in the model's dtype; other floating leaves (the
#: recurrent states) are float32, positions int32
_MODEL_DTYPE_LEAVES = ("k", "v", "latent", "conv")
#: the Griffin unit's layers, in order
_GRIFFIN_UNIT = ("rec1", "rec2", "attn")


def _tensor(a, dtype: torch.dtype | None, device) -> torch.Tensor:
    """`a` as a tensor on `device`, cast to `dtype` (None: its own)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: keep the bits
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def port_layout(tree: dict, model) -> dict:
    """A tree in JAX's parameter layout split into the port's (stacked
    leaves sliced: views; a stacked leaf may also be a list of the layers'
    tensors, as `jax_pieces` gives it)."""
    if model.cfg.family == "transformer":
        return {**tree, "layers": layer_trees(tree["layers"], model.cfg)}
    return model.layer_trees(tree)


def params_from_jax(tree: dict, cfg: ModelConfig, *, device=None):
    """The built model of `cfg` holding the weights of JAX tree `tree`, cast
    to ``cfg.dtype`` on `device` (None: ``cuda``)."""
    dev = resolve_device(device)
    model = build_model(cfg)
    return model.load(port_layout(
        _map(tree, lambda a: _tensor(a, cfg.dtype, dev)), model))


def _host(t: torch.Tensor) -> np.ndarray:
    """A numpy copy (of a CPU tensor too: it shares no memory with `t`);
    bfloat16 comes back as float32, which holds it exactly."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def _stack(items: list, stack=np.stack):
    """A list of like trees of leaves as one tree, `stack` joining each
    leaf's items (on a new axis 0)."""
    first = items[0]
    if isinstance(first, dict):
        return {k: _stack([it[k] for it in items], stack) for k in first}
    return stack(items)


def _griffin_units(layers: list, n_units: int, stack) -> dict:
    """One tree a Griffin layer (in layer order) as JAX's {rec1, rec2,
    attn} stacked over the units."""
    return {name: _stack([layers[3 * u + j] for u in range(n_units)], stack)
            for j, name in enumerate(_GRIFFIN_UNIT)}


def _jax_params(tree: dict, model, stack) -> dict:
    """A tree in the port's parameter layout (`model.tree()`'s) in JAX's,
    the layers' (units') leaves joined by `stack`."""
    tree = dict(tree)
    cfg = model.cfg
    if cfg.family == "griffin":
        layers = tree.pop("layers")
        tree["units"] = _griffin_units(layers, model.n_units, stack)
        for i in range(model.n_tail):
            tree[f"tail{i}"] = layers[3 * model.n_units + i]
    elif cfg.family == "xlstm":
        tree["units"] = _stack(tree["units"], stack)
    elif cfg.scan_layers:
        tree["layers"] = _stack(tree["layers"], stack)
    else:
        tree["layers"] = {f"l{i}": lt for i, lt in enumerate(tree["layers"])}
    return tree


def jax_layout(tree: dict, model) -> dict:
    """A tree in the port's parameter layout (weights, gradients, moments)
    as JAX's of numpy arrays (layers stacked on axis 0 where JAX stacks
    them); bfloat16 comes back as float32, which holds it exactly."""
    return _jax_params(_map(tree, _host), model, np.stack)


def to_numpy_tree(model) -> dict:
    """The model's weights as a JAX parameter tree of numpy arrays."""
    return jax_layout(model.tree(), model)


def jax_pieces(tree: dict, model) -> dict:
    """A tree in the port's parameter layout in JAX's, each stacked leaf
    the list of the port's tensors it stacks, in stack order (the tensors
    themselves; `port_layout` takes it back)."""
    return _jax_params(tree, model, list)


def jax_leaf_groups(tree: dict, model) -> list[list[torch.Tensor]]:
    """For each leaf of JAX's layout of `tree` (in the port's parameter
    layout), the port's tensors it stacks, in stack order (one tensor for
    a leaf JAX does not stack)."""
    groups = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        else:
            groups.append(t if isinstance(t, list) else [t])
    walk(jax_pieces(tree, model))
    return groups


def train_state_from_jax(state: dict, model, *, device=None) -> dict:
    """The port's training state of JAX's ``{"params", "opt": {"m", "v",
    "step"}}`` (numpy, or arrays numpy reads): the weights loaded into
    `model` in ``model.cfg.dtype``, the moments float32 and the step int32
    on `device` (None: ``cuda``).  The weights are the model's own tensors
    (``state["params"]`` is ``model.tree()``)."""
    dev = resolve_device(device)

    def port(tree, dtype):
        return port_layout(_map(tree, lambda a: _tensor(a, dtype, dev)),
                           model)
    model.load(port(state["params"], model.cfg.dtype))
    opt = state["opt"]
    return {"params": model.tree(),
            "opt": {"m": port(opt["m"], torch.float32),
                    "v": port(opt["v"], torch.float32),
                    "step": _tensor(opt["step"], torch.int32, dev)}}


def train_state_to_numpy(state: dict, model, mesh=None,
                         rules=SINGLE_POD_RULES) -> dict:
    """JAX's layout of the port's training state, as numpy arrays.  A state
    sharded on `mesh` under `rules` (`sharding.placement`; every rank of
    the mesh calls this) is gathered first."""
    if mesh is not None:
        from ..sharding.placement import gather_train_state
        state = gather_train_state(state, model, mesh, rules)
    opt = state["opt"]
    return {"params": jax_layout(state["params"], model),
            "opt": {"m": jax_layout(opt["m"], model),
                    "v": jax_layout(opt["v"], model),
                    "step": _host(opt["step"])}}


def cache_from_jax(cache, cfg: ModelConfig, *, device=None) -> list:
    """The port's cache of JAX decode cache `cache`, on `device` (None:
    ``cuda``): keys, values, latents and conv tails in ``cfg.dtype``, the
    recurrent states float32, positions int32."""
    dev = resolve_device(device)

    def leaf(name, a, i):
        a = np.asarray(a)
        a = a if i is None else a[i]
        if np.issubdtype(a.dtype, np.integer):
            return _tensor(a, torch.int32, dev)
        return _tensor(a, cfg.dtype if name in _MODEL_DTYPE_LEAVES
                       else torch.float32, dev)

    def entry(tree, i=None):
        """One layer's (unit's) dict: slice `i` of stacked leaves."""
        return {k: (entry(v, i) if isinstance(v, dict) else leaf(k, v, i))
                for k, v in tree.items()}

    def pos(a):
        return _tensor(np.asarray(a), torch.int32, dev)

    if cfg.family == "griffin":
        n_units = cfg.num_layers // 3
        entries = [entry(cache[name], u) for u in range(n_units)
                   for name in _GRIFFIN_UNIT]
        entries += [entry(t) for t in cache["tails"]]
        return StateCache(entries, pos(cache["next"]))
    if cfg.family == "xlstm":
        return StateCache([entry(cache["units"], u)
                           for u in range(cfg.num_layers // 2)],
                          pos(cache["next"]))
    if not cfg.scan_layers:
        return [entry(dict(c)) for c in cache]
    return [entry(cache, i) for i in range(cfg.num_layers)]


def _jax_layout(cache: list, cfg: ModelConfig, leaf, stack):
    """JAX's layout of the port's cache (the module docstring), each tensor
    through `leaf` and the layers' (units') leaves joined by `stack`."""
    per_layer = [_map(c, leaf) for c in cache]
    if cfg.family == "griffin":
        n_units = cfg.num_layers // 3
        out = _griffin_units(per_layer, n_units, stack)
        out["tails"] = per_layer[3 * n_units:]
        out["next"] = leaf(cache.next)
        return out
    if cfg.family == "xlstm":
        return {"units": _stack(per_layer, stack), "next": leaf(cache.next)}
    return _stack(per_layer, stack) if cfg.scan_layers else per_layer


def cache_to_numpy(cache: list, cfg: ModelConfig):
    """JAX's layout of the port's cache as numpy arrays; bfloat16 comes
    back as float32."""
    return _jax_layout(cache, cfg, _host, np.stack)


__all__ = ["params_from_jax", "to_numpy_tree", "cache_from_jax",
           "cache_to_numpy", "jax_layout", "jax_leaf_groups", "jax_pieces",
           "port_layout",
           "train_state_from_jax", "train_state_to_numpy"]
