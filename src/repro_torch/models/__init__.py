"""The model substrate on PyTorch, as in `repro.models`: the dense
transformer stacks (encoder-only and the layers a causal LM shares with
them), built from a `ModelConfig`; `convert` carries JAX parameter trees
across."""

from .transformer import EncoderLayer, ModelConfig, TransformerLM
from .registry import build_model
from .convert import params_from_jax, to_numpy_tree

__all__ = ["ModelConfig", "TransformerLM", "EncoderLayer", "build_model",
           "params_from_jax", "to_numpy_tree"]
