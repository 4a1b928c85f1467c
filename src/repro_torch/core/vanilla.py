"""Vanilla Viterbi in PyTorch: a plain forward loop and a backtracking loop.

Baseline #1 of the paper (O(K^2 T) time, O(KT) space: the full psi table is
materialised) and the exact oracle of every other path, as
`repro.core.vanilla` is for the JAX package.  It launches no kernel of this
package.
"""

from __future__ import annotations

import torch

from ..kernels.ref import viterbi_forward_masked_ref


def _backtrack(psis: torch.Tensor, delta_T: torch.Tensor):
    """Follow (T-1, K) backpointers back from the lowest-index argmax."""
    T = psis.shape[0] + 1
    q = delta_T.argmax()
    score = delta_T[q]
    path = torch.empty((T,), dtype=torch.int32, device=delta_T.device)
    path[T - 1] = q
    for t in range(T - 2, -1, -1):
        q = psis[t, q]
        path[t] = q
    return path, score


def viterbi_vanilla(log_pi: torch.Tensor, log_A: torch.Tensor,
                    em: torch.Tensor):
    """Exact Viterbi decode.

    Args:
      log_pi: (K,) initial log-probs.
      log_A:  (K, K) transition log-probs, [src, dst].
      em:     (T, K) emission log-likelihoods per timestep.

    Returns:
      (path, score): (T,) int32 optimal state sequence and its log-likelihood.
    """
    T, K = em.shape
    psis = torch.empty((T - 1, K), dtype=torch.int64, device=em.device)
    delta = log_pi + em[0]
    for t in range(1, T):
        scores = delta[:, None] + log_A              # (K_src, K_dst)
        psis[t - 1] = scores.argmax(dim=0)           # lowest index on ties
        delta = scores.amax(dim=0) + em[t]
    return _backtrack(psis, delta)


def viterbi_vanilla_masked(log_pi: torch.Tensor, log_A: torch.Tensor,
                           em: torch.Tensor, pad: torch.Tensor):
    """Exact Viterbi decode of a padded sequence.

    `pad` is a (T,) bool mask; masked steps are tropical identities (delta
    frozen, identity backpointers), so the returned score and the path prefix
    up to the true length are bit-identical to `viterbi_vanilla` on the
    unpadded sequence.  Path entries at padded steps repeat the final state.
    pad[0] must be False (length >= 1).
    """
    # one spec of the masked recursion, shared with the kernel's plain version
    delta0 = log_pi + em[0]
    psis, delta_T = viterbi_forward_masked_ref(log_A, em[1:], delta0, pad[1:])
    return _backtrack(psis.long(), delta_T)


def viterbi_vanilla_batched(log_pi: torch.Tensor, log_A: torch.Tensor,
                            em_batch: torch.Tensor):
    """`viterbi_vanilla` over a batch of emission sequences (B, T, K)."""
    out = [viterbi_vanilla(log_pi, log_A, e) for e in em_batch]
    return (torch.stack([p for p, _ in out]), torch.stack([s for _, s in out]))


#: The analysis gate's findings this module makes by design (`analysis.findings`
#: has the grammar; PERF.md records the measured ratios).
FLASHPROVE_WAIVERS = {
    "PV102:dispatch:*:vanilla": (
        "the plain baseline backtracks on the host: each step indexes psi "
        "with the previous state, a 0-d tensor, one sync a step; it is the "
        "independent oracle the kernels are held against, not a served path"),
    "PV104:dispatch:*:vanilla[": (
        "psi is argmax's int64, twice the model's int32 table, and two "
        "steps' (K, K) score blocks are live at once in the eager loop: "
        "2.5-2.8x the model on the dispatch grid"),
}

__all__ = ["viterbi_vanilla", "viterbi_vanilla_masked",
           "viterbi_vanilla_batched"]
