"""Batched decoding: `viterbi_decode_batch` over (B, T, K), as in `repro.core.batch`.

Sequence i is decoded *exactly* at length `lengths[i]`: the tail runs as
tropical-identity pad steps, so per-sequence paths and scores are
bit-identical to decoding each unpadded sequence alone.  Path entries at
padded steps repeat the sequence's final decoded state; slice row i to
[:lengths[i]] for the true path.

Methods ported so far:
  * ``fused``   -- one forward-kernel launch and one backtrack-kernel launch
                   for the whole bucket (`kernels.ops.viterbi_decode_fused_batch`);
                   with ``constraint=``, one masked-forward-kernel launch
                   (`kernels.ops.viterbi_decode_fused_batch_masked`).
  * ``vanilla`` -- the masked plain loop per sequence (exact oracle).

``flash``, ``flash_bs`` and ``mesh=`` raise `NotImplementedError` naming the
ROADMAP item that ports them; nothing silently takes another path.
"""

from __future__ import annotations

import torch

from ..kernels.ops import (viterbi_decode_fused_batch,
                           viterbi_decode_fused_batch_masked)
from .constraints import compiled_penalties, constrain_inputs
from .vanilla import viterbi_vanilla_masked

BATCH_METHODS = ("vanilla", "flash", "flash_bs", "fused")

#: what of the JAX package is not ported yet, and the ROADMAP item that ports it
NOT_PORTED = {
    m: "ROADMAP Queue 1 item 4 (paper algorithms)"
    for m in ("checkpoint", "flash", "flash_bs", "beam_static",
              "beam_static_mp", "assoc")
} | {
    "online": "ROADMAP Queue 1 item 6 (streaming)",
    "online_beam": "ROADMAP Queue 1 item 6 (streaming)",
    "mesh": "ROADMAP Queue 1 item 8 (distributed)",
}


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet: {NOT_PORTED[what]}")


def _validate_lengths(lengths: torch.Tensor, T: int) -> None:
    """Eagerly reject lengths outside [1, T] instead of silently clipping."""
    if lengths.numel() and (lengths.min() < 1 or lengths.max() > T):
        raise ValueError(
            f"lengths must lie in [1, T={T}]; got range "
            f"[{int(lengths.min())}, {int(lengths.max())}]")


def _vanilla_batch(log_pi, log_A, em, lengths):
    T = em.shape[1]
    pad = (torch.arange(T, device=em.device)[None, :]
           >= lengths.to(em.device)[:, None])
    out = [viterbi_vanilla_masked(log_pi, log_A, e, p)
           for e, p in zip(em, pad)]
    return (torch.stack([p for p, _ in out]), torch.stack([s for _, s in out]))


def viterbi_decode_batch(
    emissions: torch.Tensor,
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    lengths=None,
    method: str = "fused",
    *,
    bt: int = 8,
    mesh=None,
    constraint=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode a (possibly ragged) batch of emission sequences.

    Args:
      emissions: (B, T, K) float32 emission log-likelihoods on the device of
        log_A, row i real for the first lengths[i] steps (pad frames may hold
        anything; they are masked).
      log_pi, log_A: shared HMM in log domain.
      lengths: optional (B,) int true lengths; None means every sequence is
        full-length.  Every value must lie in [1, T] or a ValueError is
        raised eagerly.  There is no clipping.
      method: one of ``BATCH_METHODS``; ``vanilla`` and ``fused`` are ported.
      bt: fused-kernel time-block size (no effect on the card).
      mesh: not ported; a value other than None raises.
      constraint: optional `core.constraints.ConstraintSpec`, shared by the
        whole bucket (per-step schedules index *absolute* step t, so ragged
        tails never reach the later rows).  ``fused`` keeps the inputs dense
        and fuses the penalty adds into the masked kernel; ``vanilla`` (and
        T == 1) pre-masks the inputs with `constrain_inputs`.  Both are
        bit-identical to decoding the pre-masked model.

    Returns:
      (paths (B, T) int32, scores (B,)): paths[i, :lengths[i]] is the decode
      of emissions[i, :lengths[i]], bit-identical to the unbatched call;
      entries past the length repeat the final decoded state.
    """
    if method not in BATCH_METHODS:
        raise ValueError(
            f"unknown batch method {method!r}; choose from {BATCH_METHODS}")
    if method in NOT_PORTED:
        raise not_ported(method)
    if mesh is not None:
        raise not_ported("mesh")
    B, T, K = emissions.shape
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32)
    lengths = torch.as_tensor(lengths, dtype=torch.int32)
    _validate_lengths(lengths, T)

    if constraint is not None:
        if method == "fused" and T > 1:
            t_pen, pi_pen, s_pen = compiled_penalties(constraint, K, T)
            return viterbi_decode_fused_batch_masked(
                log_pi, log_A, emissions, lengths,
                t_pen=t_pen, pi_pen=pi_pen, s_pen=s_pen, bt=bt)
        log_pi, log_A, emissions = constrain_inputs(
            constraint, log_pi, log_A, emissions)

    if T == 1:
        d0 = log_pi[None, :] + emissions[:, 0, :]
        return d0.argmax(dim=1).to(torch.int32)[:, None], d0.amax(dim=1)

    if method == "fused":
        return viterbi_decode_fused_batch(log_pi, log_A, emissions, lengths,
                                          bt=bt)
    return _vanilla_batch(log_pi, log_A, emissions, lengths)


__all__ = ["viterbi_decode_batch", "BATCH_METHODS"]
