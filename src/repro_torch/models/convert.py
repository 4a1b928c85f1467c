"""Carry parameter trees between the JAX package and the port.

A JAX parameter tree is a nested dict of arrays under JAX's names, with the
layers stacked on axis 0 under ``params["layers"]`` (or as ``"l0"``,
``"l1"``, ... when the config does not scan its layers), and ``head``
untied for hubert.  `params_from_jax` builds the port's model from one, so
that both packages compute with the same weights; `to_numpy_tree` gives the
tree back.  Arrays are read through numpy (a JAX array converts itself), so
nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from .registry import build_model
from .transformer import ModelConfig, TransformerLM, layer_trees


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
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


def to_numpy_tree(model: TransformerLM) -> dict:
    """The model's weights as a JAX parameter tree of numpy arrays (layers
    stacked on axis 0 when ``cfg.scan_layers``); bfloat16 weights come back
    as float32, which holds them exactly."""
    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    tree = _map(model.tree(), host)
    layers = tree["layers"]
    if model.cfg.scan_layers:
        def stack(items):
            first = items[0]
            if isinstance(first, dict):
                return {k: stack([it[k] for it in items]) for k in first}
            return np.stack(items)
        tree["layers"] = stack(layers)
    else:
        tree["layers"] = {f"l{i}": lt for i, lt in enumerate(layers)}
    return tree


__all__ = ["params_from_jax", "to_numpy_tree"]
