"""Useful-FLOPs model per (arch config, kind, shape), as
`repro.launch.model_flops`: plain arithmetic, equal to JAX's.

6*N*D (params) alone misrepresents attention-heavy cells (an encoder at 32k
does most of its work in S^2 attention), so the useful-work yardstick is:

  train:   6*N_active*D   + 3 * attn_fwd     (fwd + 2x bwd, remat excluded)
  prefill: 2*N_active*D   + attn_fwd
  decode:  2*N_active*B   + attn_decode      (one token/stream vs the cache)

attn_fwd counts the two attention matmuls (QK^T and PV) at 2 FLOPs/MAC:
  full:    4 * B * S^2 * H * hd   (x1/2 when causal)
  window:  4 * B * S * min(S, W) * H * hd
MLA uses its true head dims (dn + dr for scores, dv for values); Griffin
counts only its attention layers; xLSTM counts the mLSTM parallel (quadratic,
causal) form at its 2x-width heads.  Recurrent (RG-LRU / sLSTM) elementwise
work is O(S*d) and negligible next to the projections already in 6ND.
"""

from __future__ import annotations


def _attn_tokens_pairs(S: int, causal: bool, window: int | None) -> float:
    """Sum over queries of attended positions."""
    if window is not None:
        w = min(S, window)
        return float(S) * w - (w * (w - 1) / 2 if causal else 0.0)
    if causal:
        return S * (S + 1) / 2.0
    return float(S) * S


def attention_fwd_flops(cfg, S: int, B: int) -> float:
    """Forward QK^T + PV FLOPs for the whole stack at sequence length S."""
    if cfg.family == "xlstm":
        # mLSTM parallel form: causal quadratic at 2x width, half the layers
        H, hd = cfg.num_heads, 2 * cfg.d_model // cfg.num_heads
        pairs = _attn_tokens_pairs(S, True, None)
        return 4.0 * B * pairs * H * hd * (cfg.num_layers // 2)
    if cfg.family == "griffin":
        n_attn = cfg.num_layers // 3
        pairs = _attn_tokens_pairs(S, True, cfg.window)
        return 4.0 * B * pairs * cfg.num_heads * cfg.hd * n_attn
    # transformer family
    if cfg.mla:
        dk = cfg.hd + cfg.mla.get("rope_head_dim", 64)
        dv = cfg.mla.get("v_head_dim", cfg.hd)
        per_pair = 2.0 * cfg.num_heads * (dk + dv)
    else:
        per_pair = 4.0 * cfg.num_heads * cfg.hd
    causal = cfg.causal and not cfg.encoder_only
    pairs = _attn_tokens_pairs(S, causal, cfg.window)
    return B * pairs * per_pair * cfg.num_layers


def attention_decode_flops(cfg, S_cache: int, B: int) -> float:
    """One-token attention against an S_cache-long cache."""
    if cfg.family == "xlstm":
        H, hd = cfg.num_heads, 2 * cfg.d_model // cfg.num_heads
        return 4.0 * B * H * hd * hd * (cfg.num_layers // 2)  # C matrix read
    if cfg.family == "griffin":
        n_attn = cfg.num_layers // 3
        w = min(S_cache, cfg.window or S_cache)
        return 4.0 * B * w * cfg.num_heads * cfg.hd * n_attn
    if cfg.mla:
        kvl = cfg.mla["kv_lora"] + cfg.mla.get("rope_head_dim", 64)
        # absorbed form: q_eff (H x kvl) scores + latent ctx
        return 4.0 * B * S_cache * cfg.num_heads * kvl * cfg.num_layers
    w = min(S_cache, cfg.window or S_cache)
    return 4.0 * B * w * cfg.num_heads * cfg.hd * cfg.num_layers


def useful_flops(model, kind: str, S: int, B: int) -> float:
    cfg = model.cfg
    n_active = model.active_param_count()
    if kind == "train":
        return 6.0 * n_active * S * B + 3.0 * attention_fwd_flops(cfg, S, B)
    if kind == "prefill":
        return 2.0 * n_active * S * B + attention_fwd_flops(cfg, S, B)
    return 2.0 * n_active * B + attention_decode_flops(cfg, S, B)


__all__ = ["useful_flops", "attention_fwd_flops", "attention_decode_flops"]
