"""xLSTM blocks (sLSTM + mLSTM) on PyTorch, as in `repro.models.xlstm`
(Beck et al. 2024, arXiv:2405.04517).

* mLSTM: matrix memory C_t (hd x hd) per head with exponential gating.  The
  decode form carries (C, n, m); a prefill runs the stabilised parallel
  (quadratic) form in chunks of 256 query rows, then the recurrence over
  the prompt for the state it hands to decode (`_mlstm_final_state`).
* sLSTM: scalar memory per unit with exponential gating, sequential by
  nature (the paper's sLSTM has no parallel form).

The two sequential loops (`_mlstm_final_state`, `slstm_scan`) run one
position at a time in eager ops, as JAX's `lax.scan` does; the sLSTM's
input projection, which no step depends on, is one product over the
sequence before its loop.

As in JAX: block-diagonal projections and GroupNorm are replaced by per-head
RMS normalisation; causal conv1d front-ends kept; xlstm-350m alternates
mLSTM and sLSTM blocks 1:1.

Under `sharding.tensor_parallel.model_parallel` the weights are this rank's
blocks (`tensor_parallel.block_layout`), and each block runs as JAX's
partitioner runs it on the rank's share:
  * the mLSTM on the rank's heads (`tensor_parallel.heads`: its head
    group's where they do not split over "model", replicated on the
    group's ranks): w_up's block product exchanged so that the rank holds
    its span of u and of z (`tensor_parallel.fused`), the conv on those
    columns, q, k (from the conv's output) and v (from u) and the two gates
    (w_if's halves, i and f) as the float32 partials of the rank's rows
    summed in one collective and cut to the rank's heads
    (`tensor_parallel.row_products`), b_if's entries of those heads, the
    chunked parallel form on them, the rank's own columns of its output
    (`own_heads`), the norm's sum of squares over the whole width
    (`tensor_parallel.all_sum`) and w_down row-parallel;
  * the sLSTM's conv, scan and norm whole on every rank, its gate weights
    gathered whole (`tensor_parallel.whole`), its MLP tensor-parallel
    (`fused`, then `row`).
The widths come from the blocks' shapes.  Decode runs outside the context.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..sharding import tensor_parallel
from .common import Layout, act_fn, rms_norm
from .rglru import _causal_conv1d

# Floor for the exponential-gating stabiliser m: the normaliser is
# max(|n|, exp(-m)), so m below ~-88 overflows exp(-m) to f32 inf.  Every
# value the floor touches is already ~exp(-80) in the output.
_M_FLOOR = -80.0


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    d_model: int
    num_heads: int
    proj_factor_m: float = 2.0   # mLSTM up-projection
    proj_factor_s: float = 4.0 / 3.0
    conv_width: int = 4


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_layout(cfg: XLSTMConfig) -> Layout:
    d = cfg.d_model
    dp = int(d * cfg.proj_factor_m)
    return {
        "w_up": ((d, 2 * dp), ("model_d", "ff"), "normal"),
        "conv_w": ((cfg.conv_width, dp), (None, "ff"), "normal"),
        "conv_b": ((dp,), ("ff",), "zeros"),
        "wq": ((dp, dp), ("ff", None), "normal"),
        "wk": ((dp, dp), ("ff", None), "normal"),
        "wv": ((dp, dp), ("ff", None), "normal"),
        "w_if": ((dp, 2 * cfg.num_heads), ("ff", None), "normal"),
        "b_if": ((2 * cfg.num_heads,), (None,), "zeros"),
        "norm": ((dp,), ("ff",), "zeros"),
        "w_down": ((dp, d), ("ff", "model_d"), "normal"),
    }


def _heads(x, h):
    B, S, D = x.shape
    return x.reshape(B, S, h, D // h)


def _parallel_rows(q, k, v, log_i, cf, t0: int):
    """The parallel form's output rows t0 .. t0 + len(q) - 1 against every
    position: the log-gate decay matrix D[t, s] = cumF[t] - cumF[s] +
    log i_s for s <= t (-inf above), stabilised by its row max (floored at
    _M_FLOOR)."""
    S, hd = k.shape[1], q.shape[-1]
    rows = q.shape[1]
    lg = cf[:, t0:t0 + rows, None, :] - cf[:, None, :, :] \
        + log_i[:, None, :, :]                            # (B, rows, S, H)
    tpos = torch.arange(t0, t0 + rows, device=q.device)
    mask = tpos[:, None] >= torch.arange(S, device=q.device)[None, :]
    # flashlint: disable=FL007(causal mask of the mLSTM's parallel form, as JAX's, not a decode allowed-set)
    lg = lg.masked_fill(~mask[None, :, :, None], float("-inf"))
    m = torch.clamp_min(lg.amax(dim=2, keepdim=True), _M_FLOOR)
    dmat = torch.exp(lg - m)
    s = torch.einsum("bthd,bshd->btsh", q.float(), k.float()) / math.sqrt(hd)
    c = s * dmat
    n = torch.maximum(c.sum(dim=2).abs(), torch.exp(-m[:, :, 0]))  # (B,t,H)
    out = torch.einsum("btsh,bshd->bthd", c, v.float())
    return out / n[..., None]


def mlstm_parallel(q, k, v, log_i, log_f):
    """Stabilised parallel mLSTM (quadratic form).  q, k, v: (B, S, H, hd);
    log_i / log_f: (B, S, H).  Returns (B, S, H, hd) float32."""
    return _parallel_rows(q, k, v, log_i, torch.cumsum(log_f, dim=1), 0)


def mlstm_chunked(q, k, v, log_i, log_f, chunk: int = 256):
    """The parallel form in slabs of `chunk` query rows (bounds the (S, S)
    matrix to (chunk, S) slabs; exact, not an approximation).  Above one
    chunk, S must be a multiple of it: JAX's reshape of the slabs fails
    otherwise."""
    B, S, H, hd = q.shape
    if S <= chunk:
        return mlstm_parallel(q, k, v, log_i, log_f)
    if S % chunk:
        raise ValueError(f"mlstm_chunked: S = {S} is above one chunk and "
                         f"not a multiple of chunk = {chunk} (JAX's reshape "
                         f"of the {S // chunk} slabs fails)")
    cf = torch.cumsum(log_f, dim=1)
    return torch.cat([_parallel_rows(q[:, t0:t0 + chunk], k, v, log_i, cf, t0)
                      for t0 in range(0, S, chunk)], dim=1)


def mlstm_step(q, k, v, log_i, log_f, state):
    """Recurrent decode step. state: dict(C (B,H,hd,hd), n (B,H,hd), m
    (B,H)), float32."""
    hd = q.shape[-1]
    qt, kt, vt = (x[:, 0].float() for x in (q, k, v))
    li, lf = log_i[:, 0], log_f[:, 0]                     # (B, H)
    m_new = torch.clamp_min(torch.maximum(lf + state["m"], li), _M_FLOOR)
    fi = torch.exp(lf + state["m"] - m_new)[..., None]
    ii = torch.exp(li - m_new)[..., None]
    kv = kt[..., :, None] * vt[..., None, :] / math.sqrt(hd)  # (B,H,hd,hd)
    C = fi[..., None] * state["C"] + ii[..., None] * kv
    n = fi * state["n"] + ii * kt
    num = torch.einsum("bhd,bhde->bhe", qt, C)
    den = torch.maximum((qt * n).sum(dim=-1).abs(), torch.exp(-m_new))
    out = (num / den[..., None])[:, None]                 # (B,1,H,hd)
    return out, {"C": C, "n": n, "m": m_new}


def _mlstm_final_state(q, k, v, log_i, log_f):
    """The recurrent state after a prefill: `mlstm_step` over the S
    positions in order, as JAX's scan (S steps of about 28 launches)."""
    B, S, H, hd = q.shape
    st = init_mlstm_state(B, H, hd, device=q.device)
    for t in range(S):
        sl = slice(t, t + 1)
        _, st = mlstm_step(q[:, sl], k[:, sl], v[:, sl], log_i[:, sl],
                           log_f[:, sl], st)
    return st


def _norm(x, scale, eps: float = 1e-6):
    """`common.rms_norm` over the whole width: under the context `x` holds
    the rank's columns, and each row's sum of squares is summed over
    "model" (forward and backward)."""
    if not tensor_parallel.active():
        return rms_norm(x, scale, eps)
    xf = x.float()
    ss = tensor_parallel.all_sum(xf.square().sum(dim=-1, keepdim=True))
    var = ss / (x.shape[-1] * tensor_parallel.parts())
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def mlstm_block(params, x, cfg: XLSTMConfig, state=None,
                need_state: bool = True):
    """Pre-up-projected mLSTM block. Returns (y, new_state).  Over a
    sequence, ``need_state=False`` skips the recurrence that gives the
    final state (`_mlstm_final_state`, S eager steps) and returns None as
    the recurrent state: the training loss reads no state.  On the rank's
    heads under `tensor_parallel.model_parallel` (module docstring)."""
    B, S, _ = x.shape
    nh = cfg.num_heads
    H = tensor_parallel.heads(nh)[1]
    u, z = tensor_parallel.fused(x, params["w_up"], 2)    # branch + gate
    conv_state = None if state is None else state["conv"]
    uc, conv_tail = _causal_conv1d(u, params["conv_w"], params["conv_b"],
                                   conv_state)
    uc = F.silu(uc)
    q, k, v, g = tensor_parallel.row_products(
        (uc, params["wq"]), (uc, params["wk"]), (u, params["wv"]),
        (uc, params["w_if"], 2), nheads=nh)
    q, k, v = _heads(q, H), _heads(k, H), _heads(v, H)
    gates = (g + tensor_parallel.own(params["b_if"], 2, nh)).float()
    log_i, log_f = gates[..., :H], F.logsigmoid(gates[..., H:])

    if state is None or S > 1:
        h = mlstm_chunked(q, k, v, log_i, log_f)
        mst = (_mlstm_final_state(q, k, v, log_i, log_f) if need_state
               else None)
    else:
        h, mst = mlstm_step(q, k, v, log_i, log_f, state["rec"])
    hp = tensor_parallel.own_heads(h.reshape(B, S, -1).to(x.dtype), nh)
    hn = _norm(hp, params["norm"]) * F.silu(z)
    y = tensor_parallel.row(hn, params["w_down"])
    return y, {"rec": mst, "conv": conv_tail}


def init_mlstm_state(batch: int, H: int, hd: int, device=None):
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, H, hd, hd), **f32),
            "n": torch.zeros((batch, H, hd), **f32),
            "m": torch.full((batch, H), -1e30, **f32)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_layout(cfg: XLSTMConfig) -> Layout:
    d = cfg.d_model
    # round the 4/3 up-projection to a lane/TP-friendly multiple of 128
    dp = ((int(d * cfg.proj_factor_s) + 127) // 128) * 128
    return {
        "conv_w": ((cfg.conv_width, d), (None, None), "normal"),
        "conv_b": ((d,), (None,), "zeros"),
        "w_gates": ((d, 4 * d), ("model_d", "ff"), "normal"),
        "r_gates": ((d, 4 * d), (None, "ff"), "normal"),
        "b_gates": ((4 * d,), ("ff",), "zeros"),
        "norm": ((d,), (None,), "zeros"),
        "w_up": ((d, 2 * dp), ("model_d", "ff"), "normal"),
        "w_down": ((dp, d), ("ff", "model_d"), "normal"),
    }


def slstm_scan(params, x, state):
    """sLSTM over a sequence. x: (B, S, D). state: dict(c, n, m, h) each
    (B, D) float32.  Returns (h (B, S, D) in x's dtype, the last state)."""
    xw = x @ params["w_gates"]        # every step's input projection at once
    st, hs = dict(state), []
    for t in range(x.shape[1]):
        zall = xw[:, t] + st["h"].to(x.dtype) @ params["r_gates"] \
            + params["b_gates"]
        z, i, f, o = torch.chunk(zall.float(), 4, dim=-1)
        lf = F.logsigmoid(f)
        m_new = torch.maximum(lf + st["m"], i)
        ii = torch.exp(i - m_new)
        fi = torch.exp(lf + st["m"] - m_new)
        c = fi * st["c"] + ii * torch.tanh(z)
        n = fi * st["n"] + ii
        h = torch.sigmoid(o) * c / torch.clamp_min(n, 1.0)
        st = {"c": c, "n": n, "m": m_new, "h": h}
        hs.append(h)
    return torch.stack(hs, dim=1).to(x.dtype), st


def slstm_block(params, x, cfg: XLSTMConfig, state=None):
    """The sLSTM block. Returns (y, new_state).  Under
    `tensor_parallel.model_parallel` the recurrence runs whole on every
    rank and the MLP on the rank's columns (module docstring)."""
    B, S, D = x.shape
    conv_state = None if state is None else state["conv"]
    xc, conv_tail = _causal_conv1d(x, params["conv_w"], params["conv_b"],
                                   conv_state)
    xc = F.silu(xc)
    rec = (init_slstm_state(B, D, device=x.device) if state is None
           else state["rec"])
    gates = dict(zip(("w_gates", "r_gates", "b_gates"), tensor_parallel.whole(
        params["w_gates"], params["r_gates"], params["b_gates"])))
    h, rec = slstm_scan(dict(params, **gates), xc, rec)
    h = rms_norm(h, params["norm"])
    a, b = tensor_parallel.fused(h, params["w_up"], 2)
    y = tensor_parallel.row(act_fn("gelu")(a) * b, params["w_down"])
    return y, {"rec": rec, "conv": conv_tail}


def init_slstm_state(batch: int, d: int, device=None):
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, d), **f32),
            "n": torch.zeros((batch, d), **f32),
            "m": torch.full((batch, d), -1e30, **f32),
            "h": torch.zeros((batch, d), **f32)}


__all__ = [
    "XLSTMConfig", "mlstm_layout", "slstm_layout", "mlstm_block", "slstm_block",
    "init_mlstm_state", "init_slstm_state", "mlstm_parallel", "mlstm_chunked",
    "mlstm_step", "slstm_scan",
]
