"""Pure-numpy reference decoders, copied from `repro.core.reference`.

The port keeps its own copy because importing the JAX package's module goes
through `repro/core/__init__.py`, which imports jax.  These are the
independent oracles `chip_smoke.py` holds the served paths against: they
share no code with the torch paths or the kernels.
"""

from __future__ import annotations

# flashlint: disable-file=FL002(pure-numpy oracle: everything here is host-side by design)

import itertools

import numpy as np

NEG_INF = -1.0e9


def viterbi_numpy(log_pi: np.ndarray, log_A: np.ndarray, em: np.ndarray):
    """Vanilla Viterbi, O(KT) space. Returns (path (T,), score)."""
    T, K = em.shape
    delta = log_pi + em[0]
    psi = np.zeros((T, K), dtype=np.int64)
    for t in range(1, T):
        scores = delta[:, None] + log_A  # (K, K): src x dst
        psi[t] = np.argmax(scores, axis=0)
        delta = scores[psi[t], np.arange(K)] + em[t]
    path = np.zeros((T,), dtype=np.int64)
    path[-1] = int(np.argmax(delta))
    for t in range(T - 2, -1, -1):
        path[t] = psi[t + 1][path[t + 1]]
    return path, float(np.max(delta))


def brute_force(log_pi: np.ndarray, log_A: np.ndarray, em: np.ndarray):
    """Exhaustive search over all K^T paths. Tiny problems only."""
    T, K = em.shape
    best, best_path = -np.inf, None
    for path in itertools.product(range(K), repeat=T):
        s = log_pi[path[0]] + em[0, path[0]]
        for t in range(1, T):
            s += log_A[path[t - 1], path[t]] + em[t, path[t]]
        if s > best:
            best, best_path = s, path
    return np.asarray(best_path, dtype=np.int64), float(best)


def path_score_numpy(log_pi, log_A, em, path) -> float:
    s = log_pi[path[0]] + em[0, path[0]]
    for t in range(1, len(path)):
        s += log_A[path[t - 1], path[t]] + em[t, path[t]]
    return float(s)


__all__ = ["viterbi_numpy", "brute_force", "path_score_numpy"]
