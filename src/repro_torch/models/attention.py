"""Attention on PyTorch, as in `repro.models.attention`: GQA / MQA / MHA,
sliding-window and encoder (bidirectional) attention over the full sequence.

`blockwise_attention` is JAX's online-softmax formulation, in plain torch
ops: queries in blocks of `q_block`, keys and values scanned in blocks of
`kv_block` with a running max `m`, a running sum `l` and a float32
accumulator, so the (S, S) score matrix is never materialised.  The
arithmetic is JAX's, with the casts at the same points: q, k and v go to
float32 (`qf`), masked scores are -1e30, `m` starts at -inf, `l` is floored
at 1e-30 and the output is cast to the input's dtype before ``@ wo``.
JAX scans the q blocks one after another; here all q blocks of a kv block
run in one batched product (each q block's arithmetic is unchanged).

The decode paths (`gqa_decode` and the ring-buffer caches), MLA and
`banded_blockwise` wait for the causal-LM slice (ROADMAP Queue 1 item 11b).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from .common import Layout, apply_rope

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
    # MLA (None = standard attention); not ported yet
    q_lora: int | None = None
    kv_lora: int | None = None
    rope_head_dim: int = 64
    v_head_dim: int | None = None
    causal_schedule: str = "full"      # "banded": skip future KV bands


def _mla_waits() -> NotImplementedError:
    return NotImplementedError(
        "MLA attention is not ported yet (ROADMAP Queue 1 item 11b)")


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------

def attn_layout(cfg: AttnConfig) -> Layout:
    if cfg.kv_lora is not None:
        raise _mla_waits()
    d, h, hk, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
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


# ---------------------------------------------------------------------------
# Standard (GQA/MQA) attention
# ---------------------------------------------------------------------------

def _split_heads(x, n, hd):
    B, S, _ = x.shape
    return x.reshape(B, S, n, hd)


def gqa_forward(params, x, positions, cfg: AttnConfig):
    """Full-sequence GQA attention (encoder / prefill).  Returns (out,
    {"k", "v"}), the (B, S, Hkv*hd) key and value streams (what a causal
    prefill stores in its cache)."""
    if cfg.kv_lora is not None:
        raise _mla_waits()
    B, S, _ = x.shape
    h, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _split_heads(x @ params["wq"], h, hd)
    k = _split_heads(x @ params["wk"], hk, hd)
    v = _split_heads(x @ params["wv"], hk, hd)
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

    if cfg.causal_schedule == "banded" and cfg.causal and \
            S >= 4 * min(cfg.q_block, S):
        raise NotImplementedError(
            "the banded causal schedule is not ported yet (ROADMAP Queue 1 "
            "item 11b)")
    out = blockwise_attention(
        q, (k_flat, v_flat), expand, causal=cfg.causal, window=cfg.window,
        q_offset=positions[0], kv_positions=positions,
        q_block=min(cfg.q_block, S), kv_block=min(cfg.kv_block, S),
        scale=1.0 / math.sqrt(hd))
    out = out.to(x.dtype).reshape(B, S, h * hd)
    return out @ params["wo"], {"k": k_flat, "v": v_flat}


__all__ = ["AttnConfig", "attn_layout", "blockwise_attention", "gqa_forward"]
