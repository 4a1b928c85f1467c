"""Distributed FLASH Viterbi: the paper's parallelism over a mesh of ranks, as
in `repro.core.distributed`.

Two orthogonal axes on a (data, model) `core.mesh.Mesh`:

  * **Subtask parallelism over ``data``**, the paper's P threads.  Each
    wavefront layer's tiles shard over the data axis; pruning (Sec. V-B)
    makes the tiles independent, so a layer needs no collective inside it:
    its resolved midpoints are all-gathered over ``data`` after it, so that
    every rank holds the same pinned states.
  * **State parallelism over ``model``** (tropical tensor parallelism).  The
    DP step ``delta'[j] = max_k (delta[k] + log_A[k, j]) + em[j]`` is a
    (max, +) product.  Each step's local part is one `tropical_matmul_batch`
    launch (with the argmax) for all of a layer's tiles at once.
    - ``shard="row"``: each rank holds K/mp source rows of log_A; the
      partial maxima combine by an all-reduce MAX, and the backpointers by a
      second all-reduce MAX over the value-matched global row indices, so
      among shards that tie **the highest source index wins** (one device
      takes the lowest; scores are the same either way).
    - ``shard="col"``: each rank holds K/mp target columns and computes its
      slice of delta' and psi over all sources; the combine is two
      all-gathers in rank order.

A third axis, **sequence parallelism over ``data``**
(`make_batched_flash_decoder`), is the serving configuration: whole
sequences shard over ranks through `core.batch.viterbi_decode_batch`'s
``mesh=`` route.

Every rank holds the whole (replicated) inputs, as JAX's replicated
in_shardings give each device; a rank reads only its shard of log_A.  The
time loop runs on the host, one step (one kernel launch and two
collectives) at a time, as the port's exact FLASH does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.tropical import tropical_matmul_batch
from .flash import (_initial_walk, _segment_walk, pad_emissions, pin_bounds,
                    plan_padding, wavefront)
from .hmm import NEG_INF


def _freeze(delta, new, psi, is_pad):
    """Pad steps are tropical identities: delta frozen, identity psi."""
    eye = torch.arange(delta.shape[1], device=delta.device)
    keep = is_pad[:, None]
    return torch.where(keep, delta, new), torch.where(keep, eye, psi.long())


def _tp_row_step(mesh, axis: str, log_A_local, row0: int):
    """One row-sharded DP step for M tasks: delta (M, K) replicated over
    `axis`, log_A_local (K/mp, K) this rank's source rows."""
    kl = log_A_local.shape[0]
    b = log_A_local[None]

    def step(delta, em_t, is_pad):
        a = delta[:, row0:row0 + kl].contiguous()[None]
        part_val, part_arg = tropical_matmul_batch(a, b)     # (1, M, K)
        part_val, part_arg = part_val[0], part_arg[0] + row0
        vmax = mesh.all_reduce_max(part_val, axis)
        contrib = torch.where(part_val >= vmax, part_arg, -1)
        psi = mesh.all_reduce_max(contrib, axis)             # argmax combine
        return _freeze(delta, vmax + em_t, psi, is_pad)

    return step


def _tp_col_step(mesh, axis: str, log_A_local, col0: int):
    """One column-sharded DP step for M tasks: log_A_local (K, K/mp) this
    rank's target columns."""
    kl = log_A_local.shape[1]
    b = log_A_local[None]

    def step(delta, em_t, is_pad):
        vals, args = tropical_matmul_batch(delta.contiguous()[None], b)
        part_val = vals[0] + em_t[:, col0:col0 + kl]         # (M, K/mp)
        new = mesh.all_gather(part_val, axis, dim=1)
        psi = mesh.all_gather(args[0], axis, dim=1)
        return _freeze(delta, new, psi, is_pad)

    return step


def make_flash_viterbi_2d(mesh, T: int, K: int,
                          parallelism: int | None = None,
                          data_axis: str = "data", model_axis: str = "model",
                          shard: str = "row"):
    """Build a 2-D-parallel FLASH decoder for fixed (T, K) on this rank.

    Every rank of `mesh` calls the returned ``decode(log_pi, log_A, em)``
    with the same inputs (each rank holds them whole) and gets the same
    ``(path (T,) int32, score)``.  Layer tiles shard over `data_axis` (the
    paper's P := the data axis's size unless `parallelism` is given) where
    the axis divides the layer's tile count, and are replicated otherwise;
    each DP step shards log_A over `model_axis` by source rows
    (``shard="row"``) or target columns (``"col"``).
    """
    dp = mesh.shape[data_axis]
    mp = mesh.shape[model_axis]
    P_par = parallelism or dp
    if K % mp:
        raise ValueError(f"K={K} must divide model axis {mp}")
    if shard not in ("row", "col"):
        raise ValueError(f"shard must be 'row' or 'col', got {shard!r}")
    Tp, _ = plan_padding(T, P_par)
    boundaries = (np.arange(1, P_par) * (Tp // P_par) - 1).astype(np.int64)
    kl = K // mp
    lo = mesh.coord[model_axis] * kl
    d = mesh.coord[data_axis]

    def decode(log_pi, log_A, em):
        em_p, pad = pad_emissions(em, Tp)
        if shard == "row":
            log_A_local = log_A[lo:lo + kl].contiguous()
            step = _tp_row_step(mesh, model_axis, log_A_local, lo)
            delta0 = log_pi + em_p[0]
        else:
            log_A_local = log_A[:, lo:lo + kl].contiguous()
            step = _tp_col_step(mesh, model_axis, log_A_local, lo)
            delta0 = mesh.all_gather(log_pi[lo:lo + kl] + em_p[0, lo:lo + kl],
                                     model_axis)
        q_bounds, q_last, score = _initial_walk(
            step, delta0[None], em_p[None], pad[None], boundaries)
        q_star = pin_bounds(q_bounds, q_last, Tp, boundaries)

        def seed(em0, entry, is_first):
            """The pruned re-init of each tile from its pinned entry state."""
            if shard == "row":
                # only one shard owns row log_A[entry]: all-reduce MAX with
                # an identity below every real entry
                has = (entry >= lo) & (entry < lo + kl)
                local = log_A_local[(entry - lo).clamp(0, kl - 1)]
                # flashlint: disable=FL007(pmax reduction identity for the non-owning shards, not an allowed-set mask)
                owned = torch.where(has[:, None], local, NEG_INF * 2)
                row = mesh.all_reduce_max(owned, model_axis)
                return torch.where(is_first[:, None], log_pi + em0, row + em0)
            d0 = (torch.where(is_first[:, None], log_pi[lo:lo + kl],
                              log_A_local[entry]) + em0[:, lo:lo + kl])
            return mesh.all_gather(d0, model_axis, dim=1)

        def decode_tiles(em_seg, pad_seg, entry, exit_state, is_first):
            n = em_seg.shape[0]
            mine = (slice(d * n // dp, (d + 1) * n // dp) if n % dp == 0
                    else slice(None))
            mids = _segment_walk(
                step, seed(em_seg[mine, 0], entry[mine], is_first[mine]),
                em_seg[mine], pad_seg[mine], exit_state[mine])
            return mesh.all_gather(mids, data_axis) if n % dp == 0 else mids

        q_star = wavefront(decode_tiles, em_p[None], pad[None], q_star,
                           P_par, None)
        return q_star[0, :T].to(torch.int32), score[0]

    return decode


BATCHED_DECODER_METHODS = ("vanilla", "flash", "flash_bs", "fused")


def make_batched_flash_decoder(mesh, data_axis: str = "data",
                               method: str = "flash", *,
                               spec=None,
                               parallelism: int = 8, lanes: int | None = None,
                               beam_width: int = 128, chunk: int = 128,
                               bt: int = 8):
    """Batch-of-sequences serving decoder: sequences shard over `data_axis`.

    Built on `core.batch.viterbi_decode_batch` (the entry point every serving
    path goes through), so it inherits the ragged-``lengths`` contract: pad
    frames run as tropical-identity steps, and each sequence's result is
    bit-identical to an unbatched decode of its unpadded payload.

    Args:
      mesh: a `core.mesh.Mesh`; ``mesh.shape[data_axis]`` must divide B.
      spec: a batchable `core.DecodeSpec`, the preferred form; it supplies
        the method and the tunables (``method`` / ``parallelism`` / ``lanes``
        / ``bt`` are then ignored).
      method: legacy string form: ``vanilla``, ``flash``, ``flash_bs`` or
        ``fused``.
      parallelism / lanes / beam_width / chunk / bt: forwarded to
        `viterbi_decode_batch`.

    Returns ``decode(log_pi, log_A, ems (B, T, K), lengths (B,)) -> (paths
    (B, T), scores (B,))``, every rank holding the whole bucket and getting
    the whole result.
    """
    from .batch import viterbi_decode_batch
    if spec is not None:
        if spec.batch_method is None:
            raise ValueError(f"{type(spec).__name__} has no batched path; "
                             f"choose a spec whose method is in "
                             f"{BATCHED_DECODER_METHODS}")
        method = spec.batch_method
        tunables = spec.batch_tunables()
    else:
        if method not in BATCHED_DECODER_METHODS:
            raise ValueError(f"unknown method {method!r}; choose from "
                             f"{BATCHED_DECODER_METHODS}")
        tunables = dict(parallelism=parallelism, lanes=lanes,
                        beam_width=beam_width, chunk=chunk, bt=bt)

    def decode(log_pi, log_A, ems, lengths):
        return viterbi_decode_batch(ems, log_pi, log_A, lengths,
                                    method=method, mesh=mesh,
                                    data_axis=data_axis, **tunables)

    return decode


__all__ = ["make_flash_viterbi_2d", "make_batched_flash_decoder",
           "BATCHED_DECODER_METHODS"]
