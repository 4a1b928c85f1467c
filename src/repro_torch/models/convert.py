"""Carry parameter trees and decode caches between the JAX package and
the port.

A JAX parameter tree is a nested dict of arrays under JAX's names, with the
layers stacked on axis 0 under ``params["layers"]`` (or as ``"l0"``,
``"l1"``, ... when the config does not scan its layers), MoE's shared
experts a nested dict, and ``head`` absent when the embeddings are tied.
`params_from_jax` builds the port's model from one, so that both packages
compute with the same weights; `to_numpy_tree` gives the tree back.

A JAX decode cache is one dict ({"k", "v", "pos", "next"}, or MLA's
{"latent", "pos", "next"}) with every leaf stacked on axis 0 over the
layers (a list of dicts when the config does not scan its layers); the
port keeps a list of one dict a layer.  `cache_from_jax` and
`cache_to_numpy` carry it across and back, the state that crosses between
the packages beside the weights.

Arrays are read through numpy (a JAX array converts itself), bfloat16 by
its bits, so nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from .registry import build_model
from .transformer import ModelConfig, TransformerLM, layer_trees


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


def params_from_jax(tree: dict, cfg: ModelConfig, *,
                    device=None) -> TransformerLM:
    """The built model of `cfg` holding the weights of JAX tree `tree`, cast
    to ``cfg.dtype`` on `device` (None: ``cuda``)."""
    dev = resolve_device(device)
    tree = _map(tree, lambda a: _tensor(a, cfg.dtype, dev))
    tree["layers"] = layer_trees(tree["layers"], cfg)
    return build_model(cfg).load(tree)


def _host(t: torch.Tensor) -> np.ndarray:
    """A numpy copy; bfloat16 comes back as float32, which holds it
    exactly."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _stack(items: list):
    """A list of like trees of arrays as one tree stacked on axis 0."""
    first = items[0]
    if isinstance(first, dict):
        return {k: _stack([it[k] for it in items]) for k in first}
    return np.stack(items)


def to_numpy_tree(model: TransformerLM) -> dict:
    """The model's weights as a JAX parameter tree of numpy arrays (layers
    stacked on axis 0 when ``cfg.scan_layers``); bfloat16 weights come back
    as float32, which holds them exactly."""
    tree = _map(model.tree(), _host)
    layers = tree["layers"]
    if model.cfg.scan_layers:
        tree["layers"] = _stack(layers)
    else:
        tree["layers"] = {f"l{i}": lt for i, lt in enumerate(layers)}
    return tree


def cache_from_jax(cache, cfg: ModelConfig, *, device=None) -> list[dict]:
    """The port's cache (one dict a layer) of JAX decode cache `cache`
    (stacked on axis 0 when ``cfg.scan_layers``, else a list), on `device`
    (None: ``cuda``): keys, values and latents in ``cfg.dtype``, positions
    int32."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        integer = np.issubdtype(a.dtype, np.integer)
        return _tensor(a, torch.int32 if integer else cfg.dtype, dev)

    if not cfg.scan_layers:
        return [_map(dict(c), leaf) for c in cache]
    return [{k: leaf(np.asarray(v)[i]) for k, v in cache.items()}
            for i in range(cfg.num_layers)]


def cache_to_numpy(cache: list[dict], cfg: ModelConfig):
    """JAX's layout of the port's cache: one dict with every leaf stacked
    on axis 0 over the layers (a list of dicts when the config does not
    scan its layers), as numpy arrays; bfloat16 comes back as float32."""
    per_layer = [_map(c, _host) for c in cache]
    return _stack(per_layer) if cfg.scan_layers else per_layer


__all__ = ["params_from_jax", "to_numpy_tree", "cache_from_jax",
           "cache_to_numpy"]
