"""Batched decoding: `viterbi_decode_batch` over (B, T, K), as in `repro.core.batch`.

Sequence i is decoded *exactly* at length `lengths[i]`: the tail runs as
tropical-identity pad steps, so per-sequence paths and scores are
bit-identical to decoding each unpadded sequence alone.  Path entries at
padded steps repeat the sequence's final decoded state; slice row i to
[:lengths[i]] for the true path.

Methods:
  * ``fused``    -- one forward-kernel launch and one backtrack-kernel launch
                    for the whole bucket (`kernels.ops.viterbi_decode_fused_batch`);
                    with ``constraint=``, one masked-forward-kernel launch
                    (`kernels.ops.viterbi_decode_fused_batch_masked`).
  * ``vanilla``  -- the masked plain loop per sequence (exact oracle).
  * ``flash``    -- the FLASH wavefront over the whole bucket at once
                    (plain PyTorch); ragged masks ride the pad machinery the
                    algorithm already uses for its P * 2^L padding.
  * ``flash_bs`` -- the FLASH-BS dynamic beam over the whole bucket: every
                    beam transition is one beam-kernel launch for all beams
                    in flight (exact when beam_width >= K).

With ``mesh=`` (a `core.mesh.Mesh` over an initialised process group)
every rank holds the whole bucket, decodes its ``B / dp`` slice along
``data_axis`` through the same unsharded call, and all-gathers the slices
in one collective, so every rank returns the whole (B, T) paths and (B,)
scores, bitwise those of the unsharded call.  A mesh without a process
group raises; nothing is decoded unsharded in its place.
"""

from __future__ import annotations

import torch

from ..kernels.ops import (viterbi_decode_fused_batch,
                           viterbi_decode_fused_batch_masked)
from .constraints import compiled_penalties, constrain_inputs
from .flash import _flash_padded, pad_time, plan_padding
from .flash_bs import flash_bs_batch
from .vanilla import viterbi_vanilla_masked

BATCH_METHODS = ("vanilla", "flash", "flash_bs", "fused")


def _validate_lengths(lengths: torch.Tensor, T: int) -> None:
    """Eagerly reject lengths outside [1, T] instead of silently clipping."""
    # flashlint: disable=FL002(eager validation of host-side lengths metadata)
    conc = lengths.cpu().numpy()
    if conc.size and (conc.min() < 1 or conc.max() > T):
        raise ValueError(
            f"lengths must lie in [1, T={T}]; got range "
            f"[{int(conc.min())}, {int(conc.max())}]")


def _pad_mask(T: int, lengths: torch.Tensor, device) -> torch.Tensor:
    """(B, T) bool, True where step t >= lengths[b] (a tropical identity)."""
    return (torch.arange(T, device=device)[None, :]
            >= lengths.to(device)[:, None])


def _vanilla_batch(log_pi, log_A, em, pad):
    out = [viterbi_vanilla_masked(log_pi, log_A, e, p)
           for e, p in zip(em, pad)]
    return (torch.stack([p for p, _ in out]), torch.stack([s for _, s in out]))


def _flash_batch(log_pi, log_A, em, pad, P: int, lanes):
    T = em.shape[1]
    Tp, _ = plan_padding(T, P)
    em_p, pad_p = pad_time(em, pad, Tp)
    q, s = _flash_padded(log_pi, log_A, em_p, pad_p, P, lanes)
    return q[:, :T].to(torch.int32), s


def viterbi_decode_batch(
    emissions: torch.Tensor,
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    lengths=None,
    method: str = "fused",
    *,
    parallelism: int = 8,
    lanes: int | None = -1,
    beam_width: int = 128,
    chunk: int = 128,
    bt: int = 8,
    mesh=None,
    data_axis: str = "data",
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
      method: one of ``BATCH_METHODS``.  ``vanilla``, ``fused`` and
        ``flash`` are exact; ``flash_bs`` is exact when beam_width >= K.
      parallelism, lanes, beam_width, chunk: as in `flash_viterbi` and
        `flash_bs_viterbi` (lanes -1 means = parallelism, None the whole
        layer).
      bt: fused-kernel time-block size (no effect on the card).
      mesh: optional `core.mesh.Mesh`; when given, the batch shards over
        ``data_axis`` (its size must divide B) and each rank decodes its
        slice with the same per-sequence compute, so results stay
        bit-identical to the unsharded call.  Every rank of the mesh calls
        with the same inputs and gets the whole result.  A mesh whose
        process group is not initialised raises RuntimeError.
      data_axis: the mesh axis the batch shards over (unused without a
        mesh).
      constraint: optional `core.constraints.ConstraintSpec`, shared by the
        whole bucket (per-step schedules index *absolute* step t, so ragged
        tails never reach the later rows).  ``fused`` keeps the inputs dense
        and fuses the penalty adds into the masked kernel; every other
        method, the sharded route and T == 1 pre-mask the inputs with
        `constrain_inputs` (the plain kernels then run, as in JAX).
        Both are bit-identical to decoding the pre-masked model.

    Returns:
      (paths (B, T) int32, scores (B,)): paths[i, :lengths[i]] is the decode
      of emissions[i, :lengths[i]], bit-identical to the unbatched call for
      the exact methods; entries past the length repeat the final decoded
      state.
    """
    if method not in BATCH_METHODS:
        raise ValueError(
            f"unknown batch method {method!r}; choose from {BATCH_METHODS}")
    if mesh is not None:
        _check_mesh(mesh)
    B, T, K = emissions.shape
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32)
    lengths = torch.as_tensor(lengths, dtype=torch.int32)
    _validate_lengths(lengths, T)

    if constraint is not None:
        if method == "fused" and mesh is None and T > 1:
            t_pen, pi_pen, s_pen = compiled_penalties(constraint, K, T)
            return viterbi_decode_fused_batch_masked(
                log_pi, log_A, emissions, lengths,
                t_pen=t_pen, pi_pen=pi_pen, s_pen=s_pen, bt=bt)
        log_pi, log_A, emissions = constrain_inputs(
            constraint, log_pi, log_A, emissions)

    if T == 1:
        d0 = log_pi[None, :] + emissions[:, 0, :]
        return d0.argmax(dim=1).to(torch.int32)[:, None], d0.amax(dim=1)

    if mesh is not None:
        return _sharded_batch(emissions, log_pi, log_A, lengths, method,
                              mesh=mesh, data_axis=data_axis,
                              parallelism=parallelism, lanes=lanes,
                              beam_width=beam_width, chunk=chunk, bt=bt)

    if method == "fused":
        return viterbi_decode_fused_batch(log_pi, log_A, emissions, lengths,
                                          bt=bt)
    pad = _pad_mask(T, lengths, emissions.device)
    if method == "vanilla":
        return _vanilla_batch(log_pi, log_A, emissions, pad)
    P = int(parallelism)
    if lanes == -1:
        lanes = P
    if method == "flash":
        return _flash_batch(log_pi, log_A, emissions, pad, P, lanes)
    return flash_bs_batch(log_pi, log_A, emissions, pad, beam_width, P, lanes,
                          chunk)


def _check_mesh(mesh) -> None:
    from .mesh import Mesh, process_group_ready
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a core.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    if not process_group_ready():
        raise RuntimeError("mesh= needs an initialised torch.distributed "
                           "process group; it never decodes unsharded")


def _sharded_batch(emissions, log_pi, log_A, lengths, method, *, mesh,
                   data_axis, **kw):
    """Decode this rank's slice of the bucket along `data_axis`, then
    all-gather the slices in one collective.

    Sequences are independent, so the slice's decode is the unsharded
    `viterbi_decode_batch` and per-sequence results are bit-identical to
    the unsharded call; log_pi and log_A are whole on every rank.
    """
    dp = mesh.shape[data_axis]
    B = emissions.shape[0]
    if B % dp:
        raise ValueError(
            f"mesh axis {data_axis!r}={dp} must divide batch size {B}; pad "
            f"the bucket with length-1 dummies (serving.alignment does this)")
    if mesh.coord is None:
        raise ValueError(f"this rank is not in {mesh}")
    n = B // dp
    mine = slice(mesh.coord[data_axis] * n, (mesh.coord[data_axis] + 1) * n)
    paths, scores = viterbi_decode_batch(emissions[mine], log_pi, log_A,
                                         lengths[mine], method=method, **kw)
    # one gather of both: the scores' float32 bits ride as an int32 column
    packed = torch.cat([paths, scores.contiguous().view(torch.int32)[:, None]],
                       dim=1)
    whole = mesh.all_gather(packed, data_axis)
    T = paths.shape[1]
    return (whole[:, :T].contiguous(),
            whole[:, T].contiguous().view(torch.float32))


__all__ = ["viterbi_decode_batch", "BATCH_METHODS"]
