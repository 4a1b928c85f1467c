"""The model substrate on PyTorch, as in `repro.models`: the transformer
stacks (encoder-only and causal: dense, GQA / MQA / sliding-window, MoE,
MLA, llava's image tokens) and the recurrent families (Griffin's RG-LRU
with local attention, xLSTM), each built from a `ModelConfig`, with their
prefill and decode over ring-buffer caches and recurrent states;
`convert` carries JAX parameter trees and caches across."""

from .transformer import ModelConfig, TransformerLayer, TransformerLM
from .hybrid import GriffinLM, StateCache, XLSTMLM
from .moe import MoEConfig
from .registry import build_model
from .convert import (cache_from_jax, cache_to_numpy, params_from_jax,
                      to_numpy_tree)

__all__ = ["ModelConfig", "MoEConfig", "TransformerLM", "TransformerLayer",
           "GriffinLM", "XLSTMLM", "StateCache",
           "build_model", "params_from_jax", "to_numpy_tree",
           "cache_from_jax", "cache_to_numpy"]
