"""Attention on PyTorch, as in `repro.models.attention`: GQA / MQA / MHA,
sliding-window and encoder (bidirectional) attention, MLA (DeepSeek-V2's
multi-head latent attention), and their decode paths over ring-buffer
caches.

`blockwise_attention` is JAX's online-softmax formulation, in plain torch
ops: queries in blocks of `q_block`, keys and values scanned in blocks of
`kv_block` with a running max `m`, a running sum `l` and a float32
accumulator, so the (S, S) score matrix is never materialised.  The
arithmetic is JAX's, with the casts at the same points: q, k and v go to
float32 (`qf`), masked scores are -1e30, `m` starts at -inf, `l` is floored
at 1e-30 and the output is cast to the input's dtype before ``@ wo``.
JAX scans the q blocks one after another; here all q blocks of a kv block
run in one batched product (each q block's arithmetic is unchanged), so a
float32 (B, nq, H, q_block, kv_block) score tensor is live per kv block.

Decode attends one position against a cache: {"k", "v": (B, C, Hkv*hd),
"pos": (C,) int32 slot positions (-1 = empty), "next": () int32}, a ring
of C = window slots for sliding-window layers (slot = position % C); MLA's
cache holds the (kv_lora + rope_head_dim) latent a token.  The decode
functions write the new position into the cache in place and return it:
the cache is consumed by the step, as JAX's serve step donates it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F

from ..sharding import tensor_parallel
from .common import Layout, apply_rope, rms_norm

_MASK_VALUE = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    causal: bool = True
    window: int | None = None          # sliding-window size (None = full)
    rope_theta: float = 10000.0
    use_rope: bool = True
    q_block: int = 512
    kv_block: int = 1024
    # MLA (None = standard attention)
    q_lora: int | None = None
    kv_lora: int | None = None
    rope_head_dim: int = 64
    v_head_dim: int | None = None
    causal_schedule: str = "full"      # "banded": skip future KV bands


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------

def attn_layout(cfg: AttnConfig) -> Layout:
    d, h, hk, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if cfg.kv_lora is not None:
        dn, dr = cfg.head_dim, cfg.rope_head_dim
        dv = cfg.v_head_dim or cfg.head_dim
        return {
            "wq_a": ((d, cfg.q_lora), ("model_d", None), "normal"),
            "q_norm": ((cfg.q_lora,), (None,), "zeros"),
            "wq_b": ((cfg.q_lora, h * (dn + dr)), (None, "heads"), "normal"),
            "w_dkv": ((d, cfg.kv_lora + dr), ("model_d", None), "normal"),
            "kv_norm": ((cfg.kv_lora,), (None,), "zeros"),
            "w_uk": ((cfg.kv_lora, h * dn), (None, "heads"), "normal"),
            "w_uv": ((cfg.kv_lora, h * dv), (None, "heads"), "normal"),
            "wo": ((h * dv, d), ("heads", "model_d"), "normal"),
        }
    kv_axis = "kv_heads" if hk > 1 else None  # MQA kv proj too small to shard
    return {
        "wq": ((d, h * hd), ("model_d", "heads"), "normal"),
        "wk": ((d, hk * hd), ("model_d", kv_axis), "normal"),
        "wv": ((d, hk * hd), ("model_d", kv_axis), "normal"),
        "wo": ((h * hd, d), ("heads", "model_d"), "normal"),
    }


# ---------------------------------------------------------------------------
# Blockwise (flash-style) attention
# ---------------------------------------------------------------------------

def qf(x):
    return x.float()


def blockwise_attention(q, kv_latent, expand_fn: Callable, *, causal: bool,
                        window: int | None, q_offset, kv_positions,
                        q_block: int, kv_block: int, scale: float):
    """Online-softmax attention over latent KV blocks.

    q:          (B, S, H, hd_k) queries (rope already applied).
    kv_latent:  tuple of (B, Skv, *) latent KV streams (for plain GQA the
                pair (k, v)).
    expand_fn:  tuple of (B, kb, L) blocks, trailing axes flattened as JAX's
                reshape flattens them -> (k (B, kb, H, hd_k), v (B, kb, H,
                hd_v)).
    kv_positions: (Skv,) int position of each kv slot (-1 = invalid slot).

    Returns (B, S, H, hd_v) float32.  S must be a multiple of `q_block` and
    Skv of `kv_block` (JAX's reshape fails otherwise); ValueError if not.
    """
    B, S, H, hd_k = q.shape
    Skv = kv_latent[0].shape[1]
    if S % q_block or Skv % kv_block:
        raise ValueError(
            f"sequence length {S} must be a multiple of q_block={q_block} "
            f"and kv length {Skv} of kv_block={kv_block}")
    nq, nkv = S // q_block, Skv // kv_block
    q_r = qf(q).reshape(B, nq, q_block, H, hd_k)
    qpos = (q_offset + torch.arange(S, device=q.device)).reshape(nq, q_block)

    m = l = acc = None
    for j in range(nkv):
        blk = slice(j * kv_block, (j + 1) * kv_block)
        k, v = expand_fn(tuple(a[:, blk].reshape(B, kv_block, -1)
                               for a in kv_latent))
        kpos = kv_positions[blk]
        if acc is None:
            m = torch.full((B, nq, H, q_block), -math.inf,
                           dtype=torch.float32, device=q.device)
            l = torch.zeros((B, nq, H, q_block), dtype=torch.float32,
                            device=q.device)
            acc = torch.zeros((B, nq, q_block, H, v.shape[-1]),
                              dtype=torch.float32, device=q.device)
        s = torch.einsum("bnqhd,bkhd->bnhqk", q_r, qf(k)) * scale
        valid = (kpos[None, None, :] >= 0).expand(nq, q_block, -1)
        if causal:
            valid = valid & (qpos[:, :, None] >= kpos[None, None, :])
        if window is not None:
            valid = valid & ((qpos[:, :, None] - kpos[None, None, :])
                             < window)
        s = torch.where(valid[None, :, None], s, _MASK_VALUE)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(dim=-1)
        pv = torch.einsum("bnhqk,bkhd->bnqhd", p, qf(v))
        acc = corr.transpose(2, 3)[..., None] * acc + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30).transpose(2, 3)[..., None]
    return out.reshape(B, S, H, -1)


def banded_blockwise(q, kv_latent, expand_fn: Callable, *, window,
                     q_offset, kv_positions, q_block: int, kv_block: int,
                     scale: float, bands: int = 4):
    """Causal attention that skips future kv bands (the opt-in
    ``causal_schedule="banded"``): the queries split into `bands` groups,
    group g attending only kv[: (g + 1) S / bands].  One band when S does
    not split into bands of whole q blocks."""
    S = q.shape[1]
    if S % bands or (S // bands) % q_block:
        bands = 1
    Sb = S // bands
    outs = []
    for g in range(bands):
        end = (g + 1) * Sb
        outs.append(blockwise_attention(
            q[:, g * Sb:end], tuple(a[:, :end] for a in kv_latent),
            expand_fn, causal=True, window=window, q_offset=q_offset + g * Sb,
            kv_positions=kv_positions[:end], q_block=min(q_block, Sb),
            kv_block=min(kv_block, end), scale=scale))
    return torch.cat(outs, dim=1)


def _full_sequence(q, kv_latent, expand_fn, positions, cfg: AttnConfig,
                   scale: float):
    """`blockwise_attention`, or `banded_blockwise` where JAX takes it."""
    S = q.shape[1]
    qb, kb = min(cfg.q_block, S), min(cfg.kv_block, S)
    if cfg.causal_schedule == "banded" and cfg.causal and S >= 4 * qb:
        return banded_blockwise(q, kv_latent, expand_fn, window=cfg.window,
                                q_offset=positions[0],
                                kv_positions=positions, q_block=qb,
                                kv_block=kb, scale=scale)
    return blockwise_attention(q, kv_latent, expand_fn, causal=cfg.causal,
                               window=cfg.window, q_offset=positions[0],
                               kv_positions=positions, q_block=qb,
                               kv_block=kb, scale=scale)


# ---------------------------------------------------------------------------
# Standard (GQA/MQA) attention
# ---------------------------------------------------------------------------

def _split_heads(x, n, hd):
    B, S, _ = x.shape
    return x.reshape(B, S, n, hd)


def gqa_forward(params, x, positions, cfg: AttnConfig):
    """Full-sequence GQA attention (encoder / prefill).  Returns (out,
    {"k", "v"}), the (B, S, Hkv*hd) key and value streams (what a causal
    prefill stores in its cache).  Under `tensor_parallel.model_parallel`
    the weights are this rank's blocks: wq / wk / wv run column-parallel
    on one input (MQA's single kv head replicated) for the rank's heads, or
    its head group's where they do not split over "model"
    (`tensor_parallel.head_columns`), and wo row-parallel on the rank's
    own columns of their output (`own_heads`), one sum over "model" each
    way."""
    B, S, _ = x.shape
    H, Hk = cfg.num_heads, cfg.num_kv_heads
    cfg = tensor_parallel.local_attn(cfg)
    h, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = tensor_parallel.head_columns(
        x, (params["wq"], H), (params["wk"], Hk), (params["wv"], Hk))
    q, k, v = (_split_heads(t, n, hd) for t, n in ((q, h), (k, hk), (v, hk)))
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    k_flat = k.reshape(B, S, hk * hd)
    v_flat = v.reshape(B, S, hk * hd)
    g = h // hk

    def expand(kv_b):
        k_b, v_b = kv_b
        kb = k_b.shape[1]
        k_b = k_b.reshape(B, kb, hk, 1, hd).expand(B, kb, hk, g, hd)
        v_b = v_b.reshape(B, kb, hk, 1, hd).expand(B, kb, hk, g, hd)
        return k_b.reshape(B, kb, h, hd), v_b.reshape(B, kb, h, hd)

    out = _full_sequence(q, (k_flat, v_flat), expand, positions, cfg,
                         1.0 / math.sqrt(hd))
    out = tensor_parallel.own_heads(out.to(x.dtype).reshape(B, S, h * hd),
                                    H)
    return (tensor_parallel.row(out, params["wo"]),
            {"k": k_flat, "v": v_flat})


def _write_slot(cache, name: str, new, slot):
    """Write `new` (B, S, L) into ``cache[name]`` at the ring slots `slot`
    (an (S,) tensor), in place (no host sync)."""
    return cache[name].index_copy_(1, slot, new.to(cache[name].dtype))


def _softmax_attend(s, kpos, positions, window: int | None):
    """Mask a decode step's float32 scores (..., S, C) and softmax them:
    JAX's ``kpos >= 0``, causality and the window."""
    valid = (kpos[None, :] >= 0) & (positions[:, None] >= kpos[None, :])
    if window is not None:
        valid = valid & ((positions[:, None] - kpos[None, :]) < window)
    return torch.softmax(torch.where(valid, s, _MASK_VALUE), dim=-1)


def gqa_decode(params, x, cache, cfg: AttnConfig):
    """One position against a ring-buffer cache (JAX's `gqa_decode`): the
    new key and value go to slot ``next % C``, which the cache's tensors
    take in place.  Returns (out, cache)."""
    B, S, _ = x.shape   # S == 1
    h, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    positions = cache["next"].reshape(1) + torch.arange(S, device=x.device)

    q = _split_heads(x @ params["wq"], h, hd)
    k = _split_heads(x @ params["wk"], hk, hd)
    v = _split_heads(x @ params["wv"], hk, hd)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    C = cache["k"].shape[1]
    slot = positions % C
    k_all = _write_slot(cache, "k", k.reshape(B, S, hk * hd), slot)
    v_all = _write_slot(cache, "v", v.reshape(B, S, hk * hd), slot)
    kpos = cache["pos"].index_copy_(0, slot, positions.to(torch.int32))
    cache["next"] = cache["next"] + S

    g = h // hk
    qg = q.reshape(B, S, hk, g, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf(qg),
                     qf(k_all.reshape(B, C, hk, hd))) / math.sqrt(hd)
    p = _softmax_attend(s, kpos, positions, cfg.window)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p,
                       qf(v_all.reshape(B, C, hk, hd)))
    out = out.to(x.dtype).reshape(B, S, h * hd)
    return out @ params["wo"], cache


def _ring_slots(cfg: AttnConfig, max_len: int) -> int:
    return min(max_len, cfg.window) if cfg.window else max_len


def gqa_init_cache(cfg: AttnConfig, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16, device=None):
    """An empty cache: a ring of `window` slots when the layer has one."""
    C = _ring_slots(cfg, max_len)
    kv_shape = (batch, C, cfg.num_kv_heads * cfg.head_dim)
    return {"k": torch.zeros(kv_shape, dtype=dtype, device=device),
            "v": torch.zeros(kv_shape, dtype=dtype, device=device),
            "pos": torch.full((C,), -1, dtype=torch.int32, device=device),
            "next": torch.zeros((), dtype=torch.int32, device=device)}


def gqa_prefill_cache(cfg: AttnConfig, kv, max_len: int):
    """The decode cache of a prefill over positions 0..S-1 (JAX's
    `gqa_prefill_cache`): the last C entries, rolled by the static shift
    ``start % C`` so that slot == position % C, or all S entries padded
    with empty slots (position -1) when S < C."""
    B, S, _ = kv["k"].shape
    dev = kv["k"].device
    C = _ring_slots(cfg, max_len)
    if S >= C:
        start = S - C
        shift = start % C
        k, v = (torch.roll(kv[n][:, start:], shift, dims=1) for n in "kv")
        kpos = torch.roll(torch.arange(start, S, dtype=torch.int32,
                                       device=dev), shift, dims=0)
    else:
        k, v = (F.pad(kv[n], (0, 0, 0, C - S)) for n in "kv")
        kpos = torch.cat([torch.arange(S, dtype=torch.int32, device=dev),
                          torch.full((C - S,), -1, dtype=torch.int32,
                                     device=dev)])
    return {"k": k, "v": v, "pos": kpos,
            "next": torch.tensor(S, dtype=torch.int32, device=dev)}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------

def _mla_inputs(params, x, positions, cfg: AttnConfig):
    """(q_nope, q_pe, c_kv, k_pe): the queries split at head_dim, rope on
    their rope part; the normed kv latent and its roped key part.  Under
    `tensor_parallel.model_parallel` (`cfg` the rank's heads) wq_a and
    w_dkv are replicated and wq_b the rank's heads, run column-parallel;
    the normed and roped latent feeds only the rank's heads (through w_uk,
    w_uv and the roped key they share), so it passes one `copy_in`, where
    its gradient is summed over "model" (after the norm and the rope, so
    that w_dkv's and kv_norm's gradients are whole)."""
    B, S, _ = x.shape
    h, dn, kvl = cfg.num_heads, cfg.head_dim, cfg.kv_lora
    ql = rms_norm(x @ params["wq_a"], params["q_norm"])
    (qall,) = tensor_parallel.column(ql, params["wq_b"])
    qall = qall.reshape(B, S, h, dn + cfg.rope_head_dim)
    q_nope, q_pe = qall[..., :dn], qall[..., dn:]
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)
    dkv = x @ params["w_dkv"]                       # (B, S, kvl + dr)
    c_kv = rms_norm(dkv[..., :kvl], params["kv_norm"])
    k_pe = apply_rope(dkv[..., None, kvl:], positions, cfg.rope_theta)[:, :, 0]
    lat = tensor_parallel.copy_in(torch.cat([c_kv, k_pe], dim=-1))
    lat = lat.to(x.dtype)
    return q_nope, q_pe, lat[..., :kvl], lat[..., kvl:]


def mla_forward(params, x, positions, cfg: AttnConfig):
    """Full-sequence MLA (prefill): the latent expanded to keys and values
    a kv block at a time inside `blockwise_attention`.  Returns (out,
    latent (B, S, kv_lora + rope_head_dim)), the decode cache's content.
    Under `tensor_parallel.model_parallel` the weights are this rank's
    heads (`_mla_inputs`) and wo runs row-parallel."""
    B, S, _ = x.shape
    cfg = tensor_parallel.local_attn(cfg)
    h, dn = cfg.num_heads, cfg.head_dim
    dr, dv = cfg.rope_head_dim, (cfg.v_head_dim or cfg.head_dim)
    q_nope, q_pe, c_kv, k_pe = _mla_inputs(params, x, positions, cfg)

    def expand(lat_b):
        c, pe = lat_b
        kb = c.shape[1]
        k_nope = (c @ params["w_uk"]).reshape(B, kb, h, dn)
        v = (c @ params["w_uv"]).reshape(B, kb, h, dv)
        k = torch.cat([k_nope, pe[:, :, None, :].expand(B, kb, h, dr)], -1)
        return k, v

    out = _full_sequence(torch.cat([q_nope, q_pe], dim=-1), (c_kv, k_pe),
                         expand, positions, cfg, 1.0 / math.sqrt(dn + dr))
    out = out.to(x.dtype).reshape(B, S, h * dv)
    return (tensor_parallel.row(out, params["wo"]),
            torch.cat([c_kv, k_pe], dim=-1))


def mla_decode(params, x, cache, cfg: AttnConfig):
    """Absorbed-form MLA decode (JAX's `mla_decode`): attention in the
    latent space, every product in float32; the new latent goes to slot
    ``next % C`` of the cache in place.  Returns (out, cache)."""
    B, S, _ = x.shape
    h, dn = cfg.num_heads, cfg.head_dim
    dr, dv = cfg.rope_head_dim, (cfg.v_head_dim or cfg.head_dim)
    kvl = cfg.kv_lora
    positions = cache["next"].reshape(1) + torch.arange(S, device=x.device)
    q_nope, q_pe, c_kv, k_pe = _mla_inputs(params, x, positions, cfg)

    C = cache["latent"].shape[1]
    slot = positions % C
    lat = _write_slot(cache, "latent", torch.cat([c_kv, k_pe], dim=-1), slot)
    kpos = cache["pos"].index_copy_(0, slot, positions.to(torch.int32))
    cache["next"] = cache["next"] + S

    # absorb W_uk into q: q_eff[b,s,h,kvl] = q_nope . W_uk_h^T
    w_uk = params["w_uk"].reshape(kvl, h, dn)
    q_eff = torch.einsum("bshd,khd->bshk", qf(q_nope), qf(w_uk))
    s_lat = torch.einsum("bshk,bck->bhsc", q_eff, qf(lat[..., :kvl]))
    s_pe = torch.einsum("bshd,bcd->bhsc", qf(q_pe), qf(lat[..., kvl:]))
    p = _softmax_attend((s_lat + s_pe) / math.sqrt(dn + dr), kpos,
                        positions, None)
    ctx = torch.einsum("bhsc,bck->bshk", p, qf(lat[..., :kvl]))
    w_uv = params["w_uv"].reshape(kvl, h, dv)
    out = torch.einsum("bshk,khd->bshd", ctx, qf(w_uv))
    out = out.to(x.dtype).reshape(B, S, h * dv)
    return out @ params["wo"], cache


def mla_init_cache(cfg: AttnConfig, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16, device=None):
    """An empty MLA cache of `max_len` latent slots (MLA has no window)."""
    return {"latent": torch.zeros(
                (batch, max_len, cfg.kv_lora + cfg.rope_head_dim),
                dtype=dtype, device=device),
            "pos": torch.full((max_len,), -1, dtype=torch.int32,
                              device=device),
            "next": torch.zeros((), dtype=torch.int32, device=device)}


def mla_prefill_cache(latent, max_len: int):
    """The MLA decode cache of a prefill over positions 0..S-1: the latent
    padded to `max_len` slots (JAX's prefill pads it; S > max_len is an
    error there too)."""
    B, S, _ = latent.shape
    if S > max_len:
        raise ValueError(f"prefill of {S} positions exceeds max_len "
                         f"{max_len}: the MLA cache keeps every position")
    dev = latent.device
    return {"latent": F.pad(latent, (0, 0, 0, max_len - S)),
            "pos": torch.cat([torch.arange(S, dtype=torch.int32, device=dev),
                              torch.full((max_len - S,), -1,
                                         dtype=torch.int32, device=dev)]),
            "next": torch.tensor(S, dtype=torch.int32, device=dev)}


__all__ = [
    "AttnConfig", "attn_layout", "blockwise_attention", "banded_blockwise",
    "gqa_forward", "gqa_decode", "gqa_init_cache", "gqa_prefill_cache",
    "mla_forward", "mla_decode", "mla_init_cache", "mla_prefill_cache",
]
