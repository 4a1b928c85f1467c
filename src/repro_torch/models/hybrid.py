"""The recurrent model stacks on PyTorch, as in `repro.models.hybrid`:
Griffin (RecurrentGemma) and xLSTM.

Both have `TransformerLM`'s Model API (`init`, `load`, `tree`, `cast`,
`param_count`, `prefill`, `decode_step`, `init_cache`).  JAX scans repeating
*units* over stacked parameters (RecurrentGemma: (rec, rec, local-attn) x 8
+ 2 tail rec layers for 26; xLSTM-350m: (mLSTM, sLSTM) x 12 for 24); the
port keeps one parameter tree a layer (Griffin, in layer order) or a unit
(xLSTM) in an `nn.ModuleList`, and its caches likewise: a `StateCache`,
one dict a layer or unit, where JAX stacks them (`models.convert` carries
them across).  `layer_trees` splits JAX's layout into that form.

Both families are sub-quadratic: the recurrent state is O(1) in sequence
length, and Griffin's local attention caches only its window (a ring).

`loss(batch)` is JAX's: the chunked cross entropy on the tied head, each
unit (Griffin's (rec, rec, attn), an xLSTM unit) recomputed in backward
under ``cfg.remat_policy``; Griffin's tail layers run outside the remat,
as outside JAX's scan.  xLSTM's loss skips the mLSTM's final-state loop
(``need_state=False``), which XLA drops from JAX's loss as dead code.
Serving runs under `torch.no_grad`.

Under `sharding.tensor_parallel.model_parallel` (the sharded train step)
both families hold a rank's blocks (`load` takes them) and their losses
run Megatron compute over "model": the embedding lookup and the cross
entropy vocab-parallel; Griffin's attention on the rank's heads, its MLP
and RG-LRU block on its ff columns (`models.rglru`); xLSTM's mLSTM on the
rank's heads, its sLSTM's recurrence whole on every rank beside a
tensor-parallel MLP (`models.xlstm`).  Their prefill and decode steps run
so too (the sharded serving step, `launch.steps.make_serve_step`): the
logits of the rank's vocab columns gathered whole over "model" once a
step (`tensor_parallel.gather_vocab`), and the cache the rank's block,
built by `init_cache` under the context: Griffin's rec states on its
d_rnn columns, its attention rings with MQA's one kv head whole; xLSTM's
mLSTM states on its heads (its head group's where they do not split), its
mLSTM conv tail on its span of u, its sLSTM state whole.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..core.device import host_metadata, resolve_device
from ..core.mesh import PartitionSpec as P
from ..sharding import tensor_parallel
from . import rglru as rg
from . import xlstm as xl
from .attention import (attn_layout, gqa_decode, gqa_forward, gqa_init_cache,
                        gqa_prefill_cache)
from .common import (Layout, abstract_params, chunked_cross_entropy,
                     glu_mlp, glu_mlp_layout, init_params, param_count,
                     param_specs, rms_norm)
from .transformer import (ModelConfig, ParamTree, _frozen, _remat,
                          _shape_tree, _stack_layout, check_shapes)


class StateCache(list):
    """A recurrent family's decode cache: one dict a layer (Griffin) or a
    unit (xLSTM), as the transformer's list, and `next`, the position of
    the next token (JAX's top-level ``"next"``), a 0-d int32 tensor that a
    decode step advances in place."""

    def __init__(self, entries, next_pos: torch.Tensor):
        super().__init__(entries)
        self.next = next_pos


def _pick(tree, i: int):
    return {k: (_pick(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _map(tree, fn):
    return {k: (_map(v, fn) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


def _assign(dst: dict, src: dict) -> None:
    """Copy each tensor of `src` into the same-named tensor of `dst`."""
    for k, v in src.items():
        if isinstance(v, dict):
            _assign(dst[k], v)
        else:
            dst[k].copy_(v)


def _compact(state: dict) -> dict:
    """A prefill's state as tensors of their own (not views that keep the
    sequence's activations alive)."""
    return _map(state, lambda t: t.contiguous())


class _RecurrentLM(nn.Module):
    """What the two families share: weights as one `ParamTree` a block
    (a Griffin layer, an xLSTM unit) under ``tree()[self.BLOCKS]``, the
    embedding (tied head) and the output norm.  A family sets `n_blocks`
    and defines `layout()` (JAX's table) and `layer_trees(tree)` (JAX's
    parameter tree as `load` takes it)."""

    BLOCKS = "layers"

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.blocks = nn.ModuleList()
        self.register_parameter("embed", None)
        self.register_parameter("ln_out", None)

    def param_count(self) -> int:
        """From the layout alone: nothing is allocated."""
        return param_count(self.layout())

    def active_param_count(self) -> int:
        return self.param_count()

    def abstract_params(self) -> dict:
        """JAX's parameter tree (its stacked layout) as meta tensors."""
        return abstract_params(self.layout(), self.cfg.dtype)

    def param_specs(self, rules) -> dict:
        """JAX's PartitionSpec tree of the parameters under `rules`."""
        return param_specs(rules, self.layout())

    def init(self, generator: torch.Generator | None = None, *,
             device=None):
        """Draw the weights on `device` (None: ``cuda``) from `generator`
        (None: a fresh one seeded 0 on that device), leaf by leaf in the
        layout's order, as JAX's `init_params` draws them."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        return self.load(self.layer_trees(init_params(
            self.layout(), self.cfg.dtype, generator=generator, device=dev)))

    def load(self, tree: dict):
        """Take the weights of `tree`: JAX's parameter names, with
        ``tree[self.BLOCKS]`` a list of one nested dict a block, each
        shaped as the whole layout or, under
        `tensor_parallel.model_parallel`, as a rank's blocks; ValueError
        otherwise."""
        blocks = tree[self.BLOCKS]
        if len(blocks) != self.n_blocks:
            raise ValueError(f"{len(blocks)} {self.BLOCKS} given, "
                             f"{self.n_blocks} configured")
        check_shapes(self.cfg.name, tree, self.layout(), self._load_form)
        self.blocks = nn.ModuleList(ParamTree(t) for t in blocks)
        self.embed = _frozen(tree["embed"])
        self.ln_out = _frozen(tree["ln_out"])
        return self

    def _load_form(self, layout: Layout) -> dict:
        """The shape tree of a layout in `load`'s form, from meta tensors
        made with every dispatch mode set aside (`host_metadata`: in the
        dry run they would be fake tensors, counted as live memory)."""
        with host_metadata():
            return _shape_tree(self.layer_trees(abstract_params(layout)))

    def tree(self) -> dict:
        return {self.BLOCKS: [b.tree() for b in self.blocks],
                "embed": self.embed, "ln_out": self.ln_out}

    def cast(self, dtype: torch.dtype):
        """A copy of the model with every weight cast to `dtype`."""
        tree = self.tree()
        conv = {self.BLOCKS: [_map(b, lambda t: t.detach().to(dtype))
                              for b in tree[self.BLOCKS]],
                "embed": self.embed.detach().to(dtype),
                "ln_out": self.ln_out.detach().to(dtype)}
        return type(self)(dataclasses.replace(self.cfg, dtype=dtype)).load(
            conv)

    def _tokens(self, tokens):
        """The embedding rows of `tokens` (a gather; its backward sums rows
        in a fixed order on the card, where indexing's would use
        atomics); vocab-parallel under `tensor_parallel.model_parallel`."""
        return tensor_parallel.embedding(tokens.to(self.embed.device),
                                         self.embed)

    def _logits(self, x):
        """The float32 logits of `x` on the tied head, whole over the
        vocabulary: under `tensor_parallel.model_parallel` the rank's vocab
        columns gathered over "model" (`tensor_parallel.gather_vocab`)."""
        return tensor_parallel.gather_vocab(
            (rms_norm(x, self.ln_out) @ self.embed.T).float())

    def _ce(self, x, batch, mask_count=None):
        """JAX's loss head: the output norm, then the chunked cross entropy
        on the tied embedding (divided by `mask_count`, default the mask's
        sum); vocab-parallel on the rank's rows of the embedding under
        `tensor_parallel.model_parallel`."""
        S = x.shape[1]
        ce = (tensor_parallel.chunked_cross_entropy
              if tensor_parallel.active() else chunked_cross_entropy)
        return ce(
            rms_norm(x, self.ln_out), self.embed.T,
            batch["labels"].to(x.device), batch["mask"].to(x.device).float(),
            chunk=min(self.cfg.loss_chunk, S), mask_count=mask_count)


# ---------------------------------------------------------------------------
# Griffin / RecurrentGemma
# ---------------------------------------------------------------------------

class GriffinLM(_RecurrentLM):
    """(rec, rec, local-attn) repeating pattern + GeGLU MLP per layer; the
    layers in order, `kinds[i]` "rec" or "attn"."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family != "griffin":
            raise ValueError(f"GriffinLM takes the griffin family, not "
                             f"{cfg.family!r}")
        super().__init__(cfg)
        self.n_units, self.n_tail = divmod(cfg.num_layers, 3)
        self.rcfg = rg.RGLRUConfig(d_model=cfg.d_model,
                                   d_rnn=cfg.d_rnn or cfg.d_model,
                                   conv_width=cfg.conv_width)
        self.kinds = ["rec", "rec", "attn"] * self.n_units + \
            ["rec"] * self.n_tail
        self.n_blocks = cfg.num_layers

    # -- layouts --------------------------------------------------------
    def _layer(self, mix: Layout) -> Layout:
        d = self.cfg.d_model
        return {"ln_mix": ((d,), (None,), "zeros"),
                "mix": mix,
                "ln_mlp": ((d,), (None,), "zeros"),
                "mlp": glu_mlp_layout(d, self.cfg.d_ff)}

    def layout(self) -> Layout:
        cfg = self.cfg
        rec = self._layer(rg.rglru_layout(self.rcfg))
        unit = {"rec1": rec, "rec2": rec,
                "attn": self._layer(attn_layout(cfg.attn_config()))}
        lay: Layout = {
            "embed": ((cfg.vocab, cfg.d_model), ("vocab", "model_d"), "embed"),
            "units": _stack_layout(unit, self.n_units),
            "ln_out": ((cfg.d_model,), (None,), "zeros"),
        }
        for i in range(self.n_tail):
            lay[f"tail{i}"] = rec
        return lay

    def layer_trees(self, tree: dict) -> dict:
        """JAX's {"units": {rec1, rec2, attn} stacked, "tail{i}", ...} as
        one tree a layer in layer order (stacked leaves sliced: views)."""
        layers = [_pick(tree["units"][name], u) for u in range(self.n_units)
                  for name in ("rec1", "rec2", "attn")]
        layers += [tree[f"tail{i}"] for i in range(self.n_tail)]
        return {"layers": layers, "embed": tree["embed"],
                "ln_out": tree["ln_out"]}

    # -- blocks -----------------------------------------------------------
    def _mlp(self, lp, x):
        return x + glu_mlp(lp["mlp"], rms_norm(x, lp["ln_mlp"]),
                           act=self.cfg.act)

    def _embed(self, tokens):
        """Always scaled by sqrt(d) rounded to the dtype, as JAX's
        ``_embed``."""
        x = self._tokens(tokens)
        return x * torch.tensor(math.sqrt(self.cfg.d_model),
                                dtype=self.cfg.dtype, device=x.device)

    def layer_fwd(self, kind: str, lp: dict, x, positions):
        """A layer of `kind` ("rec" or "attn") with weights `lp` over the
        full sequence: (x', its rec state {h, conv} or its attention kv
        streams)."""
        h = rms_norm(x, lp["ln_mix"])
        if kind == "rec":
            y, out = rg.block_forward(lp["mix"], h, self.rcfg, None)
        else:
            y, out = gqa_forward(lp["mix"], h, positions,
                                 self.cfg.attn_config())
        return self._mlp(lp, x + y), out

    def _block_fwd(self, i: int, x, positions):
        """Layer `i` over the full sequence (`layer_fwd`)."""
        return self.layer_fwd(self.kinds[i], self.blocks[i].tree(), x,
                              positions)

    def _unit_loss(self, u: int, x, positions):
        for i in range(3 * u, 3 * u + 3):
            x, _ = self._block_fwd(i, x, positions)
        return x

    # -- training ---------------------------------------------------------
    def loss(self, batch, mask_count=None) -> torch.Tensor:
        """JAX's `GriffinLM.loss` on ``batch["tokens"]``, ``["labels"]``
        and ``["mask"]`` (B, S): a 0-d float32 tensor (`mask_count` as
        `TransformerLM.loss` takes it).  Under
        `tensor_parallel.model_parallel` the model holds a rank's blocks
        and runs tensor-parallel; each rank of the axis returns the same
        loss."""
        x = self._embed(batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)
        unit = _remat(self._unit_loss, self.cfg.remat_policy)
        for u in range(self.n_units):
            x = unit(u, x, positions)
        for i in range(3 * self.n_units, self.cfg.num_layers):
            x, _ = self._block_fwd(i, x, positions)
        return self._ce(x, batch, mask_count)

    # -- serving ----------------------------------------------------------
    @torch.no_grad()
    def prefill(self, batch, max_len: int | None = None):
        """``batch["tokens"]`` (B, S) -> (logits (B, 1, vocab) float32 of
        the last position, the cache: each rec layer's {h, conv}, each
        attention layer's window ring with room for `max_len` (None: S)).
        Under `tensor_parallel.model_parallel` the cache is the rank's block
        (`init_cache`'s shapes) and its attention runs on its head group."""
        acfg = self.cfg.attn_config()
        x = self._embed(batch["tokens"])
        S = x.shape[1]
        max_len = max_len or S
        positions = torch.arange(S, device=x.device)
        entries = []
        for i, kind in enumerate(self.kinds):
            x, out = self._block_fwd(i, x, positions)
            entries.append(_compact(out) if kind == "rec" else
                           gqa_prefill_cache(acfg, out, max_len))
        cache = StateCache(entries, torch.tensor(S, dtype=torch.int32,
                                                 device=x.device))
        return self._logits(x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, tokens, cache: StateCache):
        """One token a sequence, ``tokens`` (B, 1), against `cache`, which
        the step updates in place (no host sync).  Returns (logits (B, 1,
        vocab) float32, cache)."""
        if len(cache) != self.cfg.num_layers:
            raise ValueError(f"a cache of {len(cache)} layers for "
                             f"{self.cfg.num_layers} layers")
        acfg = self.cfg.attn_config()
        x = self._embed(tokens)
        for kind, layer, entry in zip(self.kinds, self.blocks, cache):
            lp = layer.tree()
            h = rms_norm(x, lp["ln_mix"])
            if kind == "rec":
                y, st = rg.block_forward(lp["mix"], h, self.rcfg, entry)
                _assign(entry, st)
            else:
                y, _ = gqa_decode(lp["mix"], h, entry, acfg)
            x = self._mlp(lp, x + y)
        cache.next.add_(1)
        return self._logits(x), cache

    def init_cache(self, batch: int, max_len: int, device=None) -> StateCache:
        """An empty cache on `device` (None: ``cuda``; ``"meta"`` gives its
        shapes without memory).  Under `tensor_parallel.model_parallel` a
        rank's block of it for its `batch` rows: each rec layer's state on
        the rank's d_rnn columns, each attention ring on its kv heads (MQA's
        one kv head whole)."""
        cfg, dev = self.cfg, resolve_device(device)
        acfg = tensor_parallel.local_attn(cfg.attn_config())
        entries = [rg.init_state(self.rcfg, batch, cfg.dtype, dev)
                   if kind == "rec" else
                   gqa_init_cache(acfg, batch, max_len, cfg.dtype, dev)
                   for kind in self.kinds]
        return StateCache(entries, torch.zeros((), dtype=torch.int32,
                                               device=dev))


    def cache_specs(self, rules):
        """JAX's PartitionSpec tree of the decode cache, in its stacked
        layout (`convert.cache_to_numpy`'s)."""
        b = rules.axis("batch")
        rec = {"h": P(None, b), "conv": P(None, b, None, None)}
        rec_tail = {"h": P(b), "conv": P(b, None, None)}
        return {
            "rec1": rec, "rec2": rec,
            "attn": {"k": P(None, b, None, None), "v": P(None, b, None, None),
                     "pos": P(None, None), "next": P(None)},
            "tails": [rec_tail for _ in range(self.n_tail)],
            "next": P(),
        }


# ---------------------------------------------------------------------------
# xLSTM
# ---------------------------------------------------------------------------

class XLSTMLM(_RecurrentLM):
    """Alternating (mLSTM, sLSTM) units; the cache holds one dict a unit."""

    BLOCKS = "units"

    def __init__(self, cfg: ModelConfig):
        if cfg.family != "xlstm" or cfg.num_layers % 2:
            raise ValueError(f"XLSTMLM takes the xlstm family with an even "
                             f"number of layers, not {cfg.family!r} with "
                             f"{cfg.num_layers}")
        super().__init__(cfg)
        self.n_units = self.n_blocks = cfg.num_layers // 2
        self.xcfg = xl.XLSTMConfig(d_model=cfg.d_model,
                                   num_heads=cfg.num_heads,
                                   conv_width=cfg.conv_width)

    def layout(self) -> Layout:
        cfg = self.cfg
        d = cfg.d_model
        unit = {
            "ln_m": ((d,), (None,), "zeros"),
            "m": xl.mlstm_layout(self.xcfg),
            "ln_s": ((d,), (None,), "zeros"),
            "s": xl.slstm_layout(self.xcfg),
        }
        return {
            "embed": ((cfg.vocab, d), ("vocab", "model_d"), "embed"),
            "units": _stack_layout(unit, self.n_units),
            "ln_out": ((d,), (None,), "zeros"),
        }

    def layer_trees(self, tree: dict) -> dict:
        """JAX's {"units": stacked, ...} as one tree a unit (views)."""
        return {"units": [_pick(tree["units"], u)
                          for u in range(self.n_units)],
                "embed": tree["embed"], "ln_out": tree["ln_out"]}

    def block_fwd(self, kind: str, up: dict, x, state=None,
                  need_state: bool = True):
        """x plus the unit's mLSTM (`kind` "m") or sLSTM ("s") block on
        its pre-norm ``up["ln_" + kind]`` and weights ``up[kind]`` (a unit's
        tree, or the two entries of it): (x', the block's state)."""
        h = rms_norm(x, up["ln_" + kind])
        if kind == "m":
            y, st = xl.mlstm_block(up["m"], h, self.xcfg, state,
                                   need_state=need_state)
        else:
            y, st = xl.slstm_block(up["s"], h, self.xcfg, state)
        return x + y, st

    def _unit(self, up, x, state, need_state: bool = True):
        x, m_new = self.block_fwd("m", up, x,
                                  None if state is None else state["m"],
                                  need_state)
        x, s_new = self.block_fwd("s", up, x,
                                  None if state is None else state["s"])
        return x, {"m": m_new, "s": s_new}

    def _fresh_state(self, batch: int, device) -> dict:
        """A unit's empty state; under `tensor_parallel.model_parallel`
        the rank's block: the mLSTM's (C, n, m) of the heads it computes
        (`tensor_parallel.heads`) and its conv tail's span of u (the columns
        `tensor_parallel.fused` gives it), the sLSTM's whole."""
        cfg, W = self.cfg, self.xcfg.conv_width
        hd = cfg.d_model * 2 // cfg.num_heads  # mLSTM runs at 2x width
        H = tensor_parallel.heads(cfg.num_heads)[1]
        u = tensor_parallel.span(cfg.d_model * 2, "the mLSTM's u")[1]
        return {
            "m": {"rec": xl.init_mlstm_state(batch, H, hd, device=device),
                  "conv": torch.zeros((batch, W - 1, u),
                                      dtype=cfg.dtype, device=device)},
            "s": {"rec": xl.init_slstm_state(batch, cfg.d_model,
                                             device=device),
                  "conv": torch.zeros((batch, W - 1, cfg.d_model),
                                      dtype=cfg.dtype, device=device)},
        }

    def _unit_loss(self, u: int, x):
        return self._unit(self.blocks[u].tree(), x, None,
                          need_state=False)[0]

    # -- training ---------------------------------------------------------
    def loss(self, batch, mask_count=None) -> torch.Tensor:
        """JAX's `XLSTMLM.loss` on ``batch["tokens"]``, ``["labels"]`` and
        ``["mask"]`` (B, S): a 0-d float32 tensor (`mask_count` as
        `TransformerLM.loss` takes it).  No mLSTM final state is computed
        (`xlstm.mlstm_block`'s ``need_state``).  Under
        `tensor_parallel.model_parallel` the model holds a rank's blocks
        and runs tensor-parallel; each rank of the axis returns the same
        loss."""
        x = self._tokens(batch["tokens"])
        unit = _remat(self._unit_loss, self.cfg.remat_policy)
        for u in range(self.n_units):
            x = unit(u, x)
        return self._ce(x, batch, mask_count)

    # -- serving ----------------------------------------------------------
    @torch.no_grad()
    def prefill(self, batch, max_len: int | None = None):
        """``batch["tokens"]`` (B, S) -> (logits (B, 1, vocab) float32 of
        the last position, the cache).  Each unit starts from a fresh state
        (the conv tails from zeros), as JAX's; `max_len` is not needed (the
        state does not grow).  Above 256 positions S must be a multiple of
        256 (`xlstm.mlstm_chunked`).  Under
        `tensor_parallel.model_parallel` the cache is the rank's block
        (`_fresh_state`'s shapes)."""
        x = self._tokens(batch["tokens"])
        B, S = x.shape[:2]
        entries = []
        for unit in self.blocks:
            x, st = self._unit(unit.tree(), x, self._fresh_state(B, x.device))
            entries.append(_compact(st))
        cache = StateCache(entries, torch.tensor(S, dtype=torch.int32,
                                                 device=x.device))
        return self._logits(x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, tokens, cache: StateCache):
        """One token a sequence against `cache`, updated in place (no host
        sync).  Returns (logits (B, 1, vocab) float32, cache)."""
        if len(cache) != self.n_units:
            raise ValueError(f"a cache of {len(cache)} units for "
                             f"{self.n_units} units")
        x = self._tokens(tokens)
        for unit, entry in zip(self.blocks, cache):
            x, st = self._unit(unit.tree(), x, entry)
            _assign(entry, st)
        cache.next.add_(1)
        return self._logits(x), cache

    def init_cache(self, batch: int, max_len: int, device=None) -> StateCache:
        """An empty cache on `device` (None: ``cuda``; ``"meta"`` gives its
        shapes); `max_len` is not needed (the state does not grow).  Under
        `tensor_parallel.model_parallel` a rank's block of it for its
        `batch` rows (`_fresh_state`)."""
        dev = resolve_device(device)
        return StateCache([self._fresh_state(batch, dev)
                           for _ in range(self.n_units)],
                          torch.zeros((), dtype=torch.int32, device=dev))


    def cache_specs(self, rules):
        """JAX's PartitionSpec tree of the decode cache, in its stacked
        layout (`convert.cache_to_numpy`'s)."""
        b = rules.axis("batch")
        one = {
            "m": {"rec": {"C": P(None, b), "n": P(None, b), "m": P(None, b)},
                  "conv": P(None, b, None, None)},
            "s": {"rec": {"c": P(None, b), "n": P(None, b), "m": P(None, b),
                          "h": P(None, b)},
                  "conv": P(None, b, None, None)},
        }
        return {"units": one, "next": P()}

__all__ = ["GriffinLM", "XLSTMLM", "StateCache"]
