"""Transformer assembly on PyTorch, as in `repro.models.transformer`: the
dense / GQA / MQA / sliding-window / MoE / MLA stacks, causal or
encoder-only, with token or embedding inputs and tied or untied heads.

`ModelConfig` is the JAX package's configuration with a `torch.dtype`.
`model_layout` is JAX's layout table (layers stacked on axis 0 when
``scan_layers``), so `param_count` and the initial draw agree with JAX's.
`TransformerLM` is an `nn.Module` whose layers are `TransformerLayer`
modules in an `nn.ModuleList`, where JAX scans one layer body over stacked
parameters.  Weights keep JAX's (d_in, d_out) orientation, so ``x @ W``
reads as in JAX, and a product of bfloat16 operands stays bfloat16 until
the head's logits are cast to float32, as in JAX.

Serving is JAX's Model API:

    model.prefill(batch, max_len)      -> (last-position logits, cache)
    model.decode_step(tokens, cache)   -> (logits, cache)
    model.init_cache(batch, max_len)   -> cache

(the encoder-only prefill returns every position's logits and no cache).
Under `sharding.tensor_parallel.model_parallel` the model holds a rank's
blocks (`launch.steps.make_serve_step` loads them), the cache the rank's
block (`sharding.placement.ServePlacement`), and the logits are gathered
over "model" once a step (`tensor_parallel.gather_vocab`), so every rank
returns them whole.
The cache is a list of one dict a layer, where JAX stacks the layers'
caches on axis 0 (`models.convert.cache_from_jax` carries one across); a
decode step updates it in place and returns it.  A VLM config (llava,
``num_image_tokens``) prepends ``batch["image_embeds"]`` (B, N_img, d) to
the prompt's token embeddings; its decode continues at position N_img +
S_text.  The Griffin and xLSTM families are `models.hybrid`'s.

Training is JAX's ``model.loss(params, batch)`` as ``model.loss(batch)``
on the module's own weights: the chunked cross entropy, plus MoE's
load-balance term, each layer recomputed in backward under
``cfg.remat_policy`` (`_remat`).  The weights are frozen (no gradient)
until `train.init_train_state` makes them trainable, and serving runs under
`torch.no_grad`, so a prefill or decode step builds no autograd graph
whichever the weights are.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..core.device import resolve_device
from ..core.mesh import PartitionSpec as P
from ..sharding import tensor_parallel
from .attention import (AttnConfig, attn_layout, gqa_decode, gqa_forward,
                        gqa_init_cache, gqa_prefill_cache, mla_decode,
                        mla_forward, mla_init_cache, mla_prefill_cache)
from .common import (Layout, abstract_params, chunked_cross_entropy,
                     glu_mlp, glu_mlp_layout, init_params, mlp, mlp_layout,
                     param_count, param_specs, rms_norm)
from .moe import MoEConfig, moe_forward, moe_layout


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
    moe: MoEConfig | None = None
    mla: dict | None = None          # q_lora/kv_lora/rope_head_dim/v_head_dim
    embed_inputs: bool = True        # False: batch supplies "embeds" directly
    num_image_tokens: int = 0        # llava: prepended patch embeddings
    embed_scale: bool = False        # gemma: scale embeddings by sqrt(d)
    mlp_glu: bool = True             # False: plain 2-matrix MLP (hubert)
    use_rope: bool = True            # False: frontend supplies positions (hubert)
    tie_embeddings: bool = True
    scan_layers: bool = True         # the layout stacks layers on axis 0
    remat_policy: str = "full"       # none | dots | full (training only)
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


#: the ops whose outputs the "dots" policy keeps: products without batch
#: dimensions (``x @ W`` reaches ``aten.mm``; attention's batched products
#: do not), as JAX's ``checkpoint_dots_with_no_batch_dims``
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, policy: str):
    """`fn` recomputed in backward as JAX's ``jax.checkpoint`` under the
    config's policy: "full" keeps only its inputs, "dots" also the outputs
    of its plain products (`_DOTS`), "none" is the plain call."""
    if policy == "none":
        return fn
    if policy == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_dots))
    raise ValueError(f"unknown remat policy {policy!r}: none | dots | full")


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------

def layer_layout(cfg: ModelConfig) -> Layout:
    lay: Layout = {
        "ln_attn": ((cfg.d_model,), (None,), "zeros"),
        "attn": attn_layout(cfg.attn_config()),
        "ln_mlp": ((cfg.d_model,), (None,), "zeros"),
    }
    if cfg.moe is not None:
        lay["moe"] = moe_layout(cfg.d_model, cfg.moe)
    else:
        lay["mlp"] = (glu_mlp_layout if cfg.mlp_glu else mlp_layout)(
            cfg.d_model, cfg.d_ff)
    return lay


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

def _ffn(cfg: ModelConfig, lp, h):
    """(the MLP's or MoE's output, MoE's load-balance aux loss; 0.0 for a
    dense MLP)."""
    if cfg.moe is not None:
        return moe_forward(lp["moe"], h, cfg.moe, act=cfg.act)
    return (glu_mlp if cfg.mlp_glu else mlp)(lp["mlp"], h, act=cfg.act), 0.0


def layer_fwd(cfg: ModelConfig, lp, x, positions):
    """Full-sequence layer, JAX's `_layer_fwd`.  Returns (x', kv, aux): kv
    is GQA's {"k", "v"} streams or MLA's latent, what a causal prefill
    keeps in its cache; aux is MoE's load-balance loss (0.0 for a dense
    MLP), which the training loss adds."""
    acfg = cfg.attn_config()
    h = rms_norm(x, lp["ln_attn"])
    fwd = mla_forward if acfg.kv_lora is not None else gqa_forward
    attn_out, kv = fwd(lp["attn"], h, positions, acfg)
    x = x + attn_out
    out, aux = _ffn(cfg, lp, rms_norm(x, lp["ln_mlp"]))
    return x + out, kv, aux


def layer_decode(cfg: ModelConfig, lp, x, cache_l):
    """One position through a layer against its cache (JAX's
    `_layer_decode`); the cache is updated in place.  Returns (x', cache)."""
    acfg = cfg.attn_config()
    h = rms_norm(x, lp["ln_attn"])
    dec = mla_decode if acfg.kv_lora is not None else gqa_decode
    attn_out, cache_l = dec(lp["attn"], h, cache_l, acfg)
    x = x + attn_out
    return x + _ffn(cfg, lp, rms_norm(x, lp["ln_mlp"]))[0], cache_l


def _shape_tree(tree):
    """A tree's leaves' shapes (a layout table's first entries)."""
    if isinstance(tree, dict):
        return {k: _shape_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shape_tree(v) for v in tree]
    return tuple(tree[0]) if isinstance(tree, tuple) else tuple(tree.shape)


def check_shapes(name: str, tree: dict, layout: Layout, form) -> None:
    """ValueError unless the shapes of `tree` (weights as a model's `load`
    takes them) are those of `layout` (JAX's table) or, under
    `tensor_parallel.model_parallel`, of a rank's blocks of it
    (`tensor_parallel.block_layout`); `form(layout)` is a layout's shape
    tree in `load`'s form."""
    got = _shape_tree(tree)
    m = tensor_parallel.parts()
    if got != form(layout) and (m == 1 or got != form(
            tensor_parallel.block_layout(layout, m))):
        where = f" or a rank's blocks among {m}" if m > 1 else ""
        raise ValueError(f"the weights' shapes match neither "
                         f"{name}'s layout{where}")


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class ParamTree(nn.Module):
    """A nested dict of frozen tensors as a module: leaves are parameters,
    sub-dicts child modules, each read back as ``tree[name]``."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, _frozen(v))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def tree(self) -> dict:
        """The nested dict of the module's own tensors."""
        out = dict(self.named_parameters(recurse=False))
        out.update((k, m.tree()) for k, m in self.named_children())
        return out


class TransformerLayer(ParamTree):
    """One layer's weights (`layer_layout`'s names), its full-sequence
    forward and its decode step."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, x, positions):
        return layer_fwd(self.cfg, self.tree(), x, positions)

    def train_forward(self, x, positions):
        """(x', aux): the layer as the training loss runs it (no kv)."""
        x, _, aux = layer_fwd(self.cfg, self.tree(), x, positions)
        return x, aux

    def decode(self, x, cache_l):
        return layer_decode(self.cfg, self.tree(), x, cache_l)


# ---------------------------------------------------------------------------
# Model API
# ---------------------------------------------------------------------------

class TransformerLM(nn.Module):
    """The model of one `ModelConfig`.  Built without weights; `init` draws
    them from a generator, `load` takes a tree (see `models.convert`).
    `prefill` and `decode_step` run where the weights lie."""

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

    def abstract_params(self) -> dict:
        """JAX's parameter tree (its stacked layout) as meta tensors."""
        return abstract_params(self.layout(), self.cfg.dtype)

    def param_specs(self, rules) -> dict:
        """JAX's PartitionSpec tree of the parameters under `rules`."""
        return param_specs(rules, self.layout())

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: the top_k routed experts and
        the shared ones only)."""
        cfg, total = self.cfg, self.param_count()
        if cfg.moe is None:
            return total
        e = cfg.moe
        per_expert = 3 * cfg.d_model * e.d_ff_expert
        return total - cfg.num_layers * (e.num_experts - e.top_k) * per_expert

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
        ``tree["layers"]`` a list of one nested dict a layer, each shaped as
        the whole layout or, under `tensor_parallel.model_parallel`, as a
        rank's blocks (`tensor_parallel.block_layout`); ValueError
        otherwise."""
        if len(tree["layers"]) != self.cfg.num_layers:
            raise ValueError(f"{len(tree['layers'])} layers given, "
                             f"{self.cfg.num_layers} configured")
        self._check_shapes(tree)
        self.layers = nn.ModuleList(
            TransformerLayer(self.cfg, lt) for lt in tree["layers"])
        for name in ("embed", "ln_out", "head"):
            if name in tree:
                setattr(self, name, _frozen(tree[name]))
        return self

    def _check_shapes(self, tree: dict) -> None:
        lay = model_layout(dataclasses.replace(self.cfg, scan_layers=False))
        lay["layers"] = list(lay["layers"].values())
        check_shapes(self.cfg.name, tree, lay, _shape_tree)

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

    # -- inputs and head ----------------------------------------------------
    def _scaled(self, x):
        """Gemma's embedding scale: sqrt(d) rounded to cfg.dtype first (45.25
        in bf16 at d = 2048), as JAX's ``jnp.asarray(math.sqrt(d), dtype)``."""
        if not self.cfg.embed_scale:
            return x
        return x * torch.tensor(math.sqrt(self.cfg.d_model),
                                dtype=self.cfg.dtype, device=x.device)

    def _rows(self, tokens):
        """The embedding rows of `tokens` (a gather; its backward sums rows
        in a fixed order on the card, where indexing's would use
        atomics); vocab-parallel under `tensor_parallel.model_parallel`."""
        return tensor_parallel.embedding(tokens.to(self.embed.device),
                                         self.embed)

    def _inputs(self, batch):
        """JAX's `_embed_tokens`: the frame embeddings of an encoder, else
        the token embeddings, after the image embeddings of a VLM, then
        scaled where the config says."""
        cfg = self.cfg
        if not cfg.embed_inputs and not cfg.num_image_tokens:
            return batch["embeds"].to(self.ln_out.device, cfg.dtype)
        x = self._rows(batch["tokens"])
        if cfg.num_image_tokens:
            img = batch["image_embeds"].to(x.device, cfg.dtype)
            x = torch.cat([img, x], dim=1)
        return self._scaled(x)

    def _head(self):
        """The (d, vocab) head: the embedding's transpose when tied (a
        rank's columns of it when the weights are its blocks)."""
        if self.cfg.tie_embeddings and self.embed is not None:
            return self.embed.T
        return self.head

    # -- serving ------------------------------------------------------------
    @torch.no_grad()
    def encode(self, embeds) -> torch.Tensor:
        """The layer stack over (B, S, d) inputs, then the output norm: JAX's
        `_run_stack` and ``rms_norm(x, params["ln_out"])``, in cfg.dtype."""
        return self._stack(embeds.to(self.cfg.dtype), keep_kv=False)[0]

    def _stack(self, x, keep_kv: bool):
        """(output-normed x, each layer's kv streams when `keep_kv`)."""
        positions = torch.arange(x.shape[1], device=x.device)
        kvs = []
        for layer in self.layers:
            x, kv, _ = layer(x, positions)
            if keep_kv:
                kvs.append(kv)
        return rms_norm(x, self.ln_out), kvs

    @torch.no_grad()
    def prefill(self, batch, max_len: int | None = None):
        """JAX's `prefill`.  Causal: ``batch["tokens"]`` (B, S) (after
        ``batch["image_embeds"]`` (B, N_img, d) for a VLM: S counts both)
        -> (logits (B, 1, vocab) float32 of the last position, the cache of
        positions 0..S-1 with room for `max_len` (None: S)).  Encoder-only: on
        ``batch["embeds"]`` (B, S, d) -> (logits (B, S, vocab) float32,
        None); encoders keep no cache."""
        cfg = self.cfg
        x, kvs = self._stack(self._inputs(batch),
                             keep_kv=not cfg.encoder_only)
        if cfg.encoder_only:
            return tensor_parallel.gather_vocab(
                (x @ self._head()).float()), None
        logits = tensor_parallel.gather_vocab(
            (x[:, -1:] @ self._head()).float())
        max_len = max_len or x.shape[1]
        acfg = cfg.attn_config()
        if acfg.kv_lora is not None:
            cache = [mla_prefill_cache(kv, max_len) for kv in kvs]
        else:
            cache = [gqa_prefill_cache(acfg, kv, max_len) for kv in kvs]
        return logits, cache

    @torch.no_grad()
    def decode_step(self, tokens, cache):
        """One token a sequence, ``tokens`` (B, 1), against `cache`, which
        the step updates in place (JAX's serve step donates it).  Returns
        (logits (B, 1, vocab) float32, cache)."""
        cfg = self.cfg
        if cfg.encoder_only:
            raise ValueError(f"{cfg.name} is encoder-only: no decode step")
        if len(cache) != cfg.num_layers:
            raise ValueError(f"a cache of {len(cache)} layers for "
                             f"{cfg.num_layers} layers")
        x = self._scaled(self._rows(tokens))
        for layer, cache_l in zip(self.layers, cache):
            x, _ = layer.decode(x, cache_l)
        x = rms_norm(x, self.ln_out)
        return tensor_parallel.gather_vocab((x @ self._head()).float()), cache

    def init_cache(self, batch: int, max_len: int, device=None) -> list:
        """An empty cache on `device` (None: ``cuda``; ``"meta"`` gives its
        shapes without memory): one dict a layer, a window-sized ring for
        sliding-window layers.  Under `tensor_parallel.model_parallel` a
        rank's block of it for its `batch` rows: the kv columns of its kv
        heads, MLA's share of the slots."""
        cfg = self.cfg
        if cfg.encoder_only:
            raise ValueError(f"{cfg.name} is encoder-only: no cache")
        dev = resolve_device(device)
        acfg = tensor_parallel.local_attn(cfg.attn_config())
        mk = mla_init_cache if acfg.kv_lora is not None else gqa_init_cache
        return [mk(acfg, batch, max_len, cfg.dtype, dev)
                for _ in range(cfg.num_layers)]

    def cache_specs(self, rules):
        """JAX's PartitionSpec tree of the decode cache, in its stacked
        layout (`convert.cache_to_numpy`'s): the batch over the data axis,
        the kv heads over the model axis; MLA's latent, which has no heads
        axis, sharded along its sequence."""
        cfg = self.cfg
        lead = (None,) if cfg.scan_layers else ()
        kv_axis = ("kv_heads" if (cfg.mla is None and cfg.num_kv_heads > 1)
                   else None)

        def spec(*ax):
            return P(*(rules.axis(a) if isinstance(a, str) else a
                       for a in lead + ax))

        if cfg.attn_config().kv_lora is not None:
            one = {"latent": spec("batch", "heads", None),
                   "pos": spec("heads"), "next": spec()}
        else:
            one = {"k": spec("batch", None, kv_axis),
                   "v": spec("batch", None, kv_axis),
                   "pos": spec(None), "next": spec()}
        return one if cfg.scan_layers else [one] * cfg.num_layers

    # -- training -----------------------------------------------------------
    def loss(self, batch, mask_count=None) -> torch.Tensor:
        """JAX's `loss`: the chunked cross entropy of ``batch["labels"]``
        under ``batch["mask"]`` (B, S), plus 0.01 x MoE's aux loss summed
        over the layers / num_layers.  Inputs as `prefill` takes them (an
        encoder's ``batch["embeds"]``, a VLM's image embeddings first);
        each layer recomputed in backward under ``cfg.remat_policy``.  S
        must be a multiple of min(loss_chunk, S).  A 0-d float32 tensor.
        `mask_count`: what the cross entropy divides by (default: the
        mask's sum; `common.chunked_cross_entropy`).  Under
        `tensor_parallel.model_parallel` the model holds a rank's blocks
        and every layer, the embedding and the cross entropy run
        tensor-parallel; each rank of the axis returns the same loss."""
        cfg = self.cfg
        x = self._inputs(batch)
        S = x.shape[1]
        positions = torch.arange(S, device=x.device)
        aux = 0.0
        for layer in self.layers:
            x, a = _remat(layer.train_forward, cfg.remat_policy)(x,
                                                                 positions)
            aux = aux + a
        x = rms_norm(x, self.ln_out)
        ce = (tensor_parallel.chunked_cross_entropy
              if tensor_parallel.active() else chunked_cross_entropy)(
            x, self._head(),
            batch["labels"].to(x.device), batch["mask"].to(x.device).float(),
            chunk=min(cfg.loss_chunk, S), mask_count=mask_count)
        return ce + 0.01 * aux / max(cfg.num_layers, 1)


__all__ = ["ModelConfig", "TransformerLM", "TransformerLayer", "ParamTree",
           "model_layout", "layer_layout", "layer_trees", "layer_fwd",
           "layer_decode", "check_shapes"]
