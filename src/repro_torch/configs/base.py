"""Shape and input-spec machinery of the architecture configs, as in
`repro.configs.base`.

Every arch module exposes
    CONFIG  -- the published configuration (`ModelConfig`)
    SMOKE   -- a reduced same-family config for CPU tests
    SKIPS   -- {shape_name: reason} cells excluded
    input_specs(shape) -> InputSpec | None  (None = a skipped cell)

The four LM shapes (seq_len x global_batch):
    train_4k     4,096 x 256   -> train_step
    prefill_32k  32,768 x 32   -> prefill
    decode_32k   32,768 x 128  -> serve_step (1 new token, 32k cache)
    long_500k    524,288 x 1   -> serve_step (1 new token, 500k context)

An `InputSpec`'s arguments are tensors on the ``meta`` device: shapes and
dtypes, no memory (the decode cache is ``init_cache(..., device="meta")``,
in the port's per-layer form: a list of one dict a layer, or a
`models.hybrid.StateCache` for the recurrent families).  Its `shardings`
are `core.mesh.PartitionSpec` trees, JAX's: the batch over "data" (over
("pod", "data") with ``multi_pod``), a decode cache's in JAX's stacked
layout (`model.cache_specs`), with the batch replicated at batch 1.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.mesh import PartitionSpec as P
from ..models import build_model
from ..models.transformer import ModelConfig
from ..sharding.rules import MULTI_POD_RULES, SINGLE_POD_RULES

SHAPES: dict[str, tuple[str, int, int]] = {
    "train_4k": ("train", 4_096, 256),
    "prefill_32k": ("prefill", 32_768, 32),
    "decode_32k": ("decode", 32_768, 128),
    "long_500k": ("decode", 524_288, 1),
}


@dataclasses.dataclass
class InputSpec:
    """Abstract inputs of one cell."""
    kind: str                      # train | prefill | decode
    seq_len: int
    batch: int
    args: dict                     # name -> tree of meta tensors
    shardings: dict                # name -> PartitionSpec tree (same keys)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else "data"


def lm_input_specs(cfg: ModelConfig, shape: str, multi_pod: bool = False,
                   skips: dict[str, str] | None = None) -> InputSpec | None:
    """Token-input LM specs; None for a skipped cell."""
    if skips and shape in skips:
        return None
    kind, S, B = SHAPES[shape]
    ba = _batch_axes(multi_pod)
    if kind == "train":
        return InputSpec(kind, S, B, {"batch": {
            "tokens": _meta((B, S), torch.int32),
            "labels": _meta((B, S), torch.int32),
            "mask": _meta((B, S), torch.float32)}},
            {"batch": {"tokens": P(ba, None), "labels": P(ba, None),
                       "mask": P(ba, None)}})
    if kind == "prefill":
        return InputSpec(kind, S, B, {"batch": {
            "tokens": _meta((B, S), torch.int32)}},
            {"batch": {"tokens": P(ba, None)}})
    # decode: one new token against a cache of length S
    model = build_model(cfg)
    cache = model.init_cache(B, S, device="meta")
    rules = MULTI_POD_RULES if multi_pod else SINGLE_POD_RULES
    if B == 1:  # long-context single stream: the batch cannot shard
        rules = dataclasses.replace(rules, rules={**rules.rules,
                                                  "batch": None})
    return InputSpec(kind, S, B, {"tokens": _meta((B, 1), torch.int32),
                                  "cache": cache},
                     {"tokens": P(rules.axis("batch"), None),
                      "cache": model.cache_specs(rules)})


def embeds_input_specs(cfg: ModelConfig, shape: str, multi_pod: bool = False,
                       skips: dict[str, str] | None = None,
                       num_image_tokens: int = 0) -> InputSpec | None:
    """Specs of the modality-frontend stubs.  Encoder (hubert): the batch
    supplies precomputed frame embeddings; no decode cells.  VLM (llava):
    text tokens plus `num_image_tokens` patch embeddings, seq_len counting
    both; its decode cells are the token LM's."""
    if skips and shape in skips:
        return None
    kind, S, B = SHAPES[shape]
    ba = _batch_axes(multi_pod)
    if num_image_tokens:
        base = lm_input_specs(cfg, shape, multi_pod, skips)
        if kind != "decode":
            base.args["batch"]["tokens"] = _meta((B, S - num_image_tokens),
                                                 torch.int32)
            base.args["batch"]["image_embeds"] = _meta(
                (B, num_image_tokens, cfg.d_model), cfg.dtype)
            base.shardings["batch"]["image_embeds"] = P(ba, None, None)
        return base
    embeds = _meta((B, S, cfg.d_model), cfg.dtype)
    if kind == "train":
        return InputSpec(kind, S, B, {"batch": {
            "embeds": embeds, "labels": _meta((B, S), torch.int32),
            "mask": _meta((B, S), torch.float32)}},
            {"batch": {"embeds": P(ba, None, None), "labels": P(ba, None),
                       "mask": P(ba, None)}})
    if kind == "prefill":
        return InputSpec(kind, S, B, {"batch": {"embeds": embeds}},
                         {"batch": {"embeds": P(ba, None, None)}})
    return None


def smoke_batch(cfg: ModelConfig, rng: np.random.Generator, batch: int = 2,
                seq: int = 16, num_image_tokens: int = 0,
                embeds: bool = False, device=None) -> dict:
    """A concrete tiny batch drawn from `rng`, on `device` (None:
    ``cuda``): tokens (or frame embeddings), labels and a mask; with
    `num_image_tokens`, seq - num_image_tokens tokens and that many patch
    embeddings (seq counts both)."""
    dev = resolve_device(device)
    b = {"labels": rng.integers(0, cfg.vocab, (batch, seq), dtype=np.int32),
         "mask": np.ones((batch, seq), np.float32)}
    if embeds:
        b["embeds"] = rng.standard_normal((batch, seq, cfg.d_model),
                                          dtype=np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab,
                                   (batch, seq - num_image_tokens),
                                   dtype=np.int32)
    if num_image_tokens:
        b["image_embeds"] = rng.standard_normal(
            (batch, num_image_tokens, cfg.d_model), dtype=np.float32)
    out = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    for k in ("embeds", "image_embeds"):
        if k in out:
            out[k] = out[k].to(cfg.dtype)
    return out


__all__ = ["SHAPES", "InputSpec", "lm_input_specs", "embeds_input_specs",
           "smoke_batch"]
