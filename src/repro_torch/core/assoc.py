"""Associative-scan Viterbi over the tropical (max, +) semiring, as in
`repro.core.assoc` (beyond the paper).

Viterbi's DP recurrence is a chain of matrix products in the (max, +)
semiring:  delta_t = delta_{t-1} (x) M_t,  M_t[i, j] = log A[i, j] + em[t, j].
The product is associative, so all prefixes take O(log T) depth at O(K^3 T)
work and O(T K^2) memory: the small-K, large-T regime.

The combine is the hand-written tropical kernel's values-only instance
(`kernels.tropical.tropical_matmul_batch` with ``with_args=False``, the
counterpart of JAX's values-only `_tropical_matmul`), one launch for all
pairs of a level.  The scan is a port of `jax.lax.associative_scan`'s
recursion (reduce adjacent pairs, recurse on the half, combine the evens,
interleave): the max is exact in any order, but the adds are grouped by
that tree, and any other tree rounds differently.

The backtrack runs on the kernels too.  JAX's reverse `lax.scan` takes, at
each step, the lowest-index argmax of ``deltas[t] + log_A[:, q]`` for the
state q after it.  That is entry (t, q) of the tropical product
``deltas[:-1] (x) log_A`` with its argmax (`tropical_matmul_batch` with
``with_args=True``: the same f32 adds, k scanned upward, the lowest index
on ties), so one launch writes the table for every q at once, and the
backtrack kernel (`viterbi_backtrack_batch`) walks it from the argmax of
``deltas[-1]``: the same bits as the scan, with no host loop.
"""

from __future__ import annotations

import torch

from ..kernels.tropical import tropical_matmul_batch
from ..kernels.viterbi_dp import viterbi_backtrack_batch


def _combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(max, +) products of the pairs (a[n], b[n]), one kernel launch; no
    argmax (the scan keeps only the values)."""
    return tropical_matmul_batch(a.contiguous(), b.contiguous(),
                                 with_args=False)[0]


def associative_scan(fn, elems: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of `elems` along axis 0 with the associative `fn`,
    grouped exactly as `jax.lax.associative_scan` groups it."""
    n = elems.shape[0]
    if n < 2:
        return elems
    reduced = fn(elems[0:-1:2], elems[1::2])      # adjacent pairs
    odd = associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn(odd[:-1], elems[2::2])
    else:
        even = fn(odd, elems[2::2])
    even = torch.cat([elems[:1], even])
    out = torch.empty_like(elems)
    out[0::2] = even
    out[1::2] = odd
    return out


def viterbi_assoc(log_pi, log_A, em):
    """Exact Viterbi via a tropical associative scan.  O(K^3 T) work,
    O(log T) depth, O(T K^2) memory.  Returns ((T,) int32 path, score)."""
    T, K = em.shape
    Ms = log_A[None, :, :] + em[1:, None, :]                  # (T-1, K, K)
    F = associative_scan(_combine, Ms)                        # prefix products
    d0 = log_pi + em[0]
    deltas_tail = (d0[None, :, None] + F).amax(dim=1)         # (T-1, K)
    deltas = torch.cat([d0[None], deltas_tail])               # (T, K)

    # args[0, t, q] = argmax_k (deltas[t][k] + log_A[k, q]): the state
    # before q at step t + 1, for every q; T = 1 has no step to walk
    if T > 1:
        _, args = tropical_matmul_batch(deltas[None, :-1].contiguous(),
                                        log_A[None].contiguous())
    else:
        args = torch.empty((1, 0, K), dtype=torch.int32, device=em.device)
    paths, scores = viterbi_backtrack_batch(args,
                                            deltas[None, -1].contiguous())
    return paths[0], scores[0]


#: The analysis gate's findings this module makes by design (`analysis.findings`
#: has the grammar; PERF.md records the measured ratios).
FLASHPROVE_WAIVERS = {
    "PV104:dispatch:*:assoc": (
        "the scan keeps each level's combined (pairs, K, K) values and the "
        "backtrack's int32 argmax table beside the T K K prefixes the model "
        "counts (3.4-3.7x on the card); on the CPU the plain tropical "
        "product's broadcast adds to it"),
    "PV103:dispatch:cpu:assoc": (
        "the plain tropical product combines ~T/2 pairs a level by "
        "materialising a (pairs, K, K, K) broadcast before its max; the "
        "kernel on the card never does, and O(T K^2) products are the "
        "modeled cost of the assoc method"),
}

__all__ = ["viterbi_assoc"]
