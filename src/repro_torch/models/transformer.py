"""Transformer assembly on PyTorch, as in `repro.models.transformer`: the
dense stacks with a gated or plain MLP, bidirectional (encoder-only) or
causal attention, sliding windows and rope.

`ModelConfig` is the JAX package's configuration with a `torch.dtype`.
`model_layout` is JAX's layout table (layers stacked on axis 0 when
``scan_layers``), so `param_count` and the initial draw agree with JAX's.
`TransformerLM` is an `nn.Module` whose layers are `EncoderLayer` modules
in an `nn.ModuleList`, where JAX scans one layer body over stacked
parameters.  Weights keep JAX's (d_in, d_out) orientation, so ``x @ W``
reads as in JAX, and a product of bfloat16 operands stays bfloat16 until
the head's logits are cast to float32, as in JAX.

What serves an encoder is ported: `encode` and the encoder-only `prefill`
on frame embeddings.  The causal prefill with its caches, token inputs,
tied heads, `decode_step`, `init_cache`, MoE and MLA wait for the causal-LM
slice (ROADMAP Queue 1 item 11b); `loss` waits for
the training slice (item 11c).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from ..core.device import resolve_device
from .attention import AttnConfig, attn_layout, gqa_forward
from .common import (Layout, glu_mlp, glu_mlp_layout, init_params, mlp,
                     mlp_layout, param_count, rms_norm)


def _waits(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1 item {item})")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # transformer | griffin | xlstm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None      # default d_model // num_heads
    act: str = "silu"
    causal: bool = True
    encoder_only: bool = False       # hubert: bidirectional, no decode
    window: int | None = None        # sliding-window attention
    rope_theta: float = 10000.0
    moe: Any = None                  # MoE config; not ported yet
    mla: dict | None = None          # q_lora/kv_lora/rope_head_dim/v_head_dim
    embed_inputs: bool = True        # False: batch supplies "embeds" directly
    num_image_tokens: int = 0        # llava: prepended patch embeddings
    embed_scale: bool = False        # gemma: scale embeddings by sqrt(d)
    mlp_glu: bool = True             # False: plain 2-matrix MLP (hubert)
    use_rope: bool = True            # False: frontend supplies positions (hubert)
    tie_embeddings: bool = True
    scan_layers: bool = True         # the layout stacks layers on axis 0
    remat_policy: str = "full"       # training only; not ported yet
    dtype: torch.dtype = torch.bfloat16
    # griffin/xlstm extras
    block_pattern: tuple = ()
    d_rnn: int = 0
    conv_width: int = 4
    # attention blocking
    q_block: int = 512
    kv_block: int = 1024
    loss_chunk: int = 512
    subquadratic: bool = False
    causal_schedule: str = "full"    # "banded": causal band skipping

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def attn_config(self) -> AttnConfig:
        mla = self.mla or {}
        return AttnConfig(
            d_model=self.d_model, num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads, head_dim=self.hd,
            causal=self.causal and not self.encoder_only,
            window=self.window, rope_theta=self.rope_theta,
            use_rope=self.use_rope,
            q_block=self.q_block, kv_block=self.kv_block,
            q_lora=mla.get("q_lora"), kv_lora=mla.get("kv_lora"),
            rope_head_dim=mla.get("rope_head_dim", 64),
            v_head_dim=mla.get("v_head_dim"),
            causal_schedule=self.causal_schedule)


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------

def layer_layout(cfg: ModelConfig) -> Layout:
    if cfg.moe is not None:
        raise _waits("MoE", "11b")
    return {
        "ln_attn": ((cfg.d_model,), (None,), "zeros"),
        "attn": attn_layout(cfg.attn_config()),
        "ln_mlp": ((cfg.d_model,), (None,), "zeros"),
        "mlp": (glu_mlp_layout if cfg.mlp_glu else mlp_layout)(cfg.d_model,
                                                               cfg.d_ff),
    }


def _stack_layout(lay: Layout, n: int) -> Layout:
    return {k: (_stack_layout(v, n) if isinstance(v, dict)
                else ((n, *v[0]), (None, *v[1]), v[2]))
            for k, v in lay.items()}


def model_layout(cfg: ModelConfig) -> Layout:
    lay: Layout = {}
    if cfg.embed_inputs or cfg.num_image_tokens:
        lay["embed"] = ((cfg.vocab, cfg.d_model), ("vocab", "model_d"), "embed")
    per_layer = layer_layout(cfg)
    if cfg.scan_layers:
        lay["layers"] = _stack_layout(per_layer, cfg.num_layers)
    else:
        lay["layers"] = {f"l{i}": per_layer for i in range(cfg.num_layers)}
    lay["ln_out"] = ((cfg.d_model,), (None,), "zeros")
    if not cfg.tie_embeddings:
        lay["head"] = ((cfg.d_model, cfg.vocab), ("model_d", "vocab"), "normal")
    return lay


def layer_trees(layers: dict, cfg: ModelConfig) -> list[dict]:
    """JAX's ``params["layers"]`` (stacked on axis 0 when ``scan_layers``,
    else ``{"l0": ..., "l1": ...}``) as one nested dict a layer, in layer
    order; stacked leaves are sliced (views, no copy)."""
    if not cfg.scan_layers:
        return [layers[f"l{i}"] for i in range(cfg.num_layers)]

    def pick(tree, i):
        return {k: (pick(v, i) if isinstance(v, dict) else v[i])
                for k, v in tree.items()}
    return [pick(layers, i) for i in range(cfg.num_layers)]


# ---------------------------------------------------------------------------
# Layer body
# ---------------------------------------------------------------------------

def layer_fwd(cfg: ModelConfig, lp, x, positions):
    """Full-sequence layer, JAX's `_layer_fwd`.  Returns (x', kv)."""
    h = rms_norm(x, lp["ln_attn"])
    attn_out, kv = gqa_forward(lp["attn"], h, positions, cfg.attn_config())
    x = x + attn_out
    h = rms_norm(x, lp["ln_mlp"])
    mlp_out = (glu_mlp if cfg.mlp_glu else mlp)(lp["mlp"], h, act=cfg.act)
    return x + mlp_out, kv


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class EncoderLayer(nn.Module):
    """One layer's weights (`layer_layout`'s names) and its forward."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        self.cfg = cfg
        self.ln_attn = _frozen(tree["ln_attn"])
        self.attn = nn.ParameterDict(
            {k: _frozen(v) for k, v in tree["attn"].items()})
        self.ln_mlp = _frozen(tree["ln_mlp"])
        self.mlp = nn.ParameterDict(
            {k: _frozen(v) for k, v in tree["mlp"].items()})

    def tree(self) -> dict:
        return {"ln_attn": self.ln_attn, "attn": dict(self.attn),
                "ln_mlp": self.ln_mlp, "mlp": dict(self.mlp)}

    def forward(self, x, positions):
        return layer_fwd(self.cfg, self.tree(), x, positions)[0]


# ---------------------------------------------------------------------------
# Model API
# ---------------------------------------------------------------------------

class TransformerLM(nn.Module):
    """The model of one `ModelConfig`.  Built without weights; `init` draws
    them from a generator, `load` takes a tree (see `models.convert`)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList()
        for name in ("embed", "ln_out", "head"):
            self.register_parameter(name, None)

    # -- params -------------------------------------------------------------
    def layout(self) -> Layout:
        return model_layout(self.cfg)

    def param_count(self) -> int:
        """From the layout alone: nothing is allocated."""
        return param_count(self.layout())

    def init(self, generator: torch.Generator | None = None, *,
             device=None) -> "TransformerLM":
        """Draw the weights on `device` (None: ``cuda``) from `generator`
        (None: a fresh one seeded 0 on that device), leaf by leaf in the
        layout's order, as JAX's `init_params` draws them."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        tree = init_params(self.layout(), self.cfg.dtype, generator=generator,
                           device=dev)
        tree["layers"] = layer_trees(tree["layers"], self.cfg)
        return self.load(tree)

    def load(self, tree: dict) -> "TransformerLM":
        """Take the weights of `tree`: JAX's parameter names, with
        ``tree["layers"]`` a list of one nested dict a layer."""
        if len(tree["layers"]) != self.cfg.num_layers:
            raise ValueError(f"{len(tree['layers'])} layers given, "
                             f"{self.cfg.num_layers} configured")
        self.layers = nn.ModuleList(
            EncoderLayer(self.cfg, lt) for lt in tree["layers"])
        for name in ("embed", "ln_out", "head"):
            if name in tree:
                setattr(self, name, _frozen(tree[name]))
        return self

    def tree(self) -> dict:
        """The weights as `load` takes them (the module's own tensors)."""
        out = {"layers": [layer.tree() for layer in self.layers]}
        for name in ("embed", "ln_out", "head"):
            if getattr(self, name) is not None:
                out[name] = getattr(self, name)
        return out

    def cast(self, dtype: torch.dtype) -> "TransformerLM":
        """A copy of the model with every weight cast to `dtype`."""
        def conv(t):
            return ([conv(v) for v in t] if isinstance(t, list) else
                    {k: conv(v) for k, v in t.items()} if isinstance(t, dict)
                    else t.detach().to(dtype))
        return TransformerLM(dataclasses.replace(self.cfg, dtype=dtype)).load(
            conv(self.tree()))

    # -- serving ------------------------------------------------------------
    def encode(self, embeds) -> torch.Tensor:
        """The layer stack over (B, S, d) inputs, then the output norm: JAX's
        `_run_stack` and ``rms_norm(x, params["ln_out"])``, in cfg.dtype."""
        x = embeds.to(self.cfg.dtype)
        positions = torch.arange(x.shape[1], device=x.device)
        for layer in self.layers:
            x = layer(x, positions)
        return rms_norm(x, self.ln_out)

    def prefill(self, batch, max_len: int | None = None):
        """Encoder-only, on ``batch["embeds"]`` (B, S, d): (logits (B, S,
        vocab) float32, None); encoders keep no cache.  The causal prefill,
        token and image inputs and tied heads wait for item 11b."""
        cfg = self.cfg
        if not cfg.encoder_only or cfg.embed_inputs or cfg.tie_embeddings:
            raise _waits("the causal prefill, token inputs and tied heads",
                         "11b")
        return (self.encode(batch["embeds"]) @ self.head).float(), None

    def decode_step(self, tokens, cache):
        if self.cfg.encoder_only:
            raise ValueError(
                f"{self.cfg.name} is encoder-only: no decode step")
        raise _waits("decode_step", "11b")

    def init_cache(self, batch: int, max_len: int):
        raise _waits("init_cache", "11b")

    def loss(self, batch):
        raise _waits("the training loss", "11c")


__all__ = ["ModelConfig", "TransformerLM", "EncoderLayer", "model_layout",
           "layer_layout", "layer_trees", "layer_fwd"]
