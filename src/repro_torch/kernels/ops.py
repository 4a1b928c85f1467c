"""Public wrappers around the fused Viterbi kernels, as in `repro.kernels.ops`.

Same functions, signatures and results as the JAX package's ops, without the
TPU's fit rule (`_kernel_fits`: 12 MiB of VMEM, K % 128): the Hopper kernel
takes any K >= 1, and no shape falls back to another path.  ``bt`` stays in
the signatures for parity; it has no effect on the card, whose kernel runs
the whole time loop in one block per sequence.  The TPU's ``interpret`` and
``vmem_limit_bytes`` have no counterpart.
"""

from __future__ import annotations

import torch

from .viterbi_dp import viterbi_backtrack_batch
from .viterbi_dp import viterbi_forward as _fwd
from .viterbi_dp import viterbi_forward_batch as _fwd_batch


def _pad_mask(T: int, lengths, device: torch.device) -> torch.Tensor:
    """(B, T) float32, 1.0 where step t >= lengths[b] (a tropical identity)."""
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=device)
    steps = torch.arange(T, dtype=torch.int32, device=device)
    return (steps[None, :] >= lengths[:, None]).to(torch.float32)


def viterbi_forward(log_A: torch.Tensor, em: torch.Tensor,
                    delta0: torch.Tensor, *, bt: int = 8):
    """Fused Viterbi forward pass.

    em covers steps 1..T (delta0 is step 0). Returns (psi (T,K) i32, delta_T).
    """
    T, K = em.shape
    if T == 0:
        return torch.zeros((0, K), dtype=torch.int32, device=em.device), delta0
    return _fwd(log_A, em, delta0)


def viterbi_forward_batch(log_A: torch.Tensor, em: torch.Tensor,
                          delta0: torch.Tensor, lengths=None, *, bt: int = 8):
    """Batched fused forward pass over (B, T, K) emissions with ragged lengths.

    One kernel launch covers the whole batch.  `lengths[i]` counts the *real*
    rows of `em[i]` (delta0 is step 0 and always real); the remaining rows run
    as tropical-identity steps, so per-sequence results are bit-identical to
    `viterbi_forward` on the unpadded prefix.

    Returns (psi (B, T, K) int32, delta_T (B, K)).  psi rows at padded steps
    are the identity permutation.
    """
    B, T, K = em.shape
    if T == 0:
        return (torch.zeros((B, 0, K), dtype=torch.int32, device=em.device),
                delta0)
    pad = None if lengths is None else _pad_mask(T, lengths, em.device)
    return _fwd_batch(log_A, em, delta0, pad)


def viterbi_chunk_step(log_A: torch.Tensor, em_chunk: torch.Tensor,
                       delta: torch.Tensor, *, bt: int = 8):
    """One streaming DP advance: carry delta through a (C, K) emission chunk.

    Returns (psi (C, K) int32, delta' (K,)).
    """
    return viterbi_forward(log_A, em_chunk, delta, bt=bt)


def viterbi_slot_step(log_A: torch.Tensor, em: torch.Tensor,
                      delta: torch.Tensor, nfeed, *, bt: int = 8):
    """One inflight-batching advance: carry S slot deltas through a block.

    `em` is (S, block, K) with slot s holding `nfeed[s]` real emission rows
    (0 <= nfeed[s] <= block) followed by arbitrary padding.  Slots with
    `nfeed[s] == 0` run the whole block as tropical-identity steps: their
    delta comes back bit-identical and their psi rows are the identity.

    Returns (psi (S, block, K) int32, delta' (S, K)).
    """
    return viterbi_forward_batch(log_A, em, delta, nfeed, bt=bt)


def viterbi_decode_fused(log_pi: torch.Tensor, log_A: torch.Tensor,
                         em: torch.Tensor, *, bt: int = 8):
    """Full Viterbi decode: the fused forward kernel, then the backtrack kernel.

    Returns (path (T,) int32, score).
    """
    delta0 = log_pi + em[0]
    psi, delta_T = viterbi_forward(log_A, em[1:], delta0, bt=bt)
    paths, scores = viterbi_backtrack_batch(psi[None], delta_T[None])
    return paths[0], scores[0]


def viterbi_decode_fused_batch(log_pi: torch.Tensor, log_A: torch.Tensor,
                               em: torch.Tensor, lengths=None, *, bt: int = 8):
    """Batched full Viterbi decode: one forward launch, one backtrack launch.

    Args:
      em:      (B, T, K) emissions, row i real for the first lengths[i] steps.
      lengths: optional (B,) int true lengths (None means full length).

    Returns:
      (paths (B, T) int32, scores (B,)).  paths[i, t] for t >= lengths[i]
      repeat the sequence's final decoded state (the identity backpointers of
      the pad steps); slice to [:lengths[i]] for the true decode.
    """
    delta0 = log_pi[None, :] + em[:, 0, :]
    if em.shape[1] == 1:
        q = delta0.argmax(dim=1).to(torch.int32)
        return q[:, None], delta0.amax(dim=1)
    if lengths is not None:
        lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                  device=em.device)
        lengths = (lengths - 1).clamp(min=0)
    psi, delta_T = viterbi_forward_batch(log_A, em[:, 1:], delta0, lengths,
                                         bt=bt)
    return viterbi_backtrack_batch(psi, delta_T)


__all__ = ["viterbi_forward", "viterbi_forward_batch", "viterbi_chunk_step",
           "viterbi_slot_step", "viterbi_decode_fused",
           "viterbi_decode_fused_batch"]
