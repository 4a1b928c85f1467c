"""Plain PyTorch versions of the port's kernels.

Each function is the semantic specification its CUDA kernel is held against
(on the card by `chip_smoke.py`) and what the kernel wrappers run for tensors
that lie on the CPU.  They mirror `repro.kernels.ref`: psi is int32 and every
argmax takes the lowest index among equal maxima, as `jnp.argmax` does
(`torch.max(dim=...)` and `torch.argmax` return the first maximal index).

Leading batch dimensions broadcast: ``em`` may be (T, K) or (B, T, K) with
``delta0`` (K,) or (B, K).
"""

from __future__ import annotations

import torch


def _step(delta: torch.Tensor, log_A: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor]:
    scores = delta.unsqueeze(-1) + log_A          # (..., K_src, K_dst)
    best, psi = scores.max(dim=-2)                # first index among ties
    return best, psi.to(torch.int32)


def viterbi_forward_ref(log_A: torch.Tensor, em: torch.Tensor,
                        delta0: torch.Tensor):
    """Reference for the forward kernel: (psi (..., T, K) int32, delta_T)."""
    T = em.shape[-2]
    psi = torch.empty(em.shape, dtype=torch.int32, device=em.device)
    delta = delta0
    for t in range(T):
        best, psi[..., t, :] = _step(delta, log_A)
        delta = best + em[..., t, :]
    return psi, delta


def viterbi_forward_masked_ref(log_A: torch.Tensor, em: torch.Tensor,
                               delta0: torch.Tensor, pad: torch.Tensor):
    """Reference for the kernel's tropical-identity pad steps.

    `pad` is a (..., T) bool mask; masked steps freeze delta and emit identity
    backpointers, so the result is bit-identical to running the unmasked
    recursion on the unpadded prefix.
    """
    T, K = em.shape[-2:]
    eye = torch.arange(K, dtype=torch.int32, device=em.device)
    psi = torch.empty(em.shape, dtype=torch.int32, device=em.device)
    delta = delta0
    for t in range(T):
        best, step_psi = _step(delta, log_A)
        is_pad = pad[..., t, None]
        psi[..., t, :] = torch.where(is_pad, eye, step_psi)
        delta = torch.where(is_pad, delta, best + em[..., t, :])
    return psi, delta


def viterbi_backtrack_ref(psi: torch.Tensor, delta_T: torch.Tensor):
    """Reference for the backtrack kernel.

    psi (B, T, K) int32 and delta_T (B, K) -> (paths (B, T + 1) int32,
    scores (B,)).  The last state is the lowest-index argmax of delta_T; the
    rest follow psi backwards, so identity rows (pad steps) repeat a state.
    """
    B, T, _ = psi.shape
    q_last = delta_T.argmax(dim=1)
    paths = torch.empty((B, T + 1), dtype=torch.int32, device=psi.device)
    paths[:, T] = q_last
    q = q_last[:, None]
    for t in range(T - 1, -1, -1):
        q = psi[:, t].gather(1, q).long()
        paths[:, t] = q[:, 0]
    return paths, delta_T.gather(1, q_last[:, None])[:, 0]


__all__ = ["viterbi_forward_ref", "viterbi_forward_masked_ref",
           "viterbi_backtrack_ref"]
