"""The work of each kernel entry: the bytes it must move (each input read
once, each output written once) and the operations it must do, as
functions of its shapes.  `chip_smoke.py` turns them into bounds with the
card's rates; the dry run (`launch.dryrun`, `launch.op_cost`) charges them
for each launch that its fake tensors stand for.

Where the work depends on the data (the log_A entries a banded window or a
beam's rows touch), a function takes what the run's data needs, and with
that left out (None: the data is not known, as on fake tensors) the most
it could need.

`charge` hands a launch that did not run (the fake branch of a wrapper,
`fake`) to the listeners that `listening` installs: the dry run's cost
counter.  With none installed it does nothing.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor

#: the callables ``(entry, nbytes, ops)`` that `charge` calls
_LISTENERS: list = []


@contextlib.contextmanager
def listening(fn):
    """Call ``fn(entry, nbytes, ops)`` for every launch `charge` is given
    inside the block."""
    _LISTENERS.append(fn)
    try:
        yield fn
    finally:
        _LISTENERS.remove(fn)


def charge(entry: str, nbytes: float, ops: float) -> None:
    """A launch of kernel entry `entry` with its work, for the listeners."""
    for fn in _LISTENERS:
        fn(entry, nbytes, ops)


def fake(*tensors) -> bool:
    """Whether an input is a fake tensor (`torch._subclasses.FakeTensor`:
    shapes without storage, the dry run's): a wrapper then makes its
    outputs' shapes and charges its launch (`charge`), and runs nothing."""
    return any(isinstance(t, FakeTensor) for t in tensors)


def fwd_work(B: int, T: int, K: int, real_steps: int):
    """The forward kernel: em and psi once each, log_A, delta0, delta_T and
    pad once; an add and a compare per score of each real step."""
    nbytes = 4 * (2 * B * T * K + K * K + 2 * B * K + B * T)
    return nbytes, 2.0 * real_steps * K * K


def masked_work(B: int, T: int, K: int, has_t: bool, has_s: bool,
                real_steps: int):
    """The masked forward kernel: em and psi once each, log_A, tmask and
    smask once, delta0, delta_T and pad once; an add and a compare per
    score of each real step (the tmask add, K*K once, is left out)."""
    nbytes = 4 * (2 * B * T * K + K * K + (K * K if has_t else 0)
                  + (T * K if has_s else 0) + 2 * B * K + B * T)
    return nbytes, 2.0 * real_steps * K * K


def banded_work(K: int, T: int, Kb: int, starts=None):
    """The banded forward kernel: the log_A entries the windows touch (the
    windows' starts a sequence of ints; None: (T - 1) Kb^2 at most), em and
    the penalty inputs inside the windows, log_pi's window, centers and
    starts once; psi and delta_w written once; an add and a compare per
    score of T - 1 steps."""
    if starts is None:
        touched = min(K * K, (T - 1) * Kb * Kb)
    else:
        s = np.asarray(starts, dtype=np.int64)
        mask = np.zeros((K, K), dtype=bool)
        for t in range(1, T):
            mask[s[t - 1]:s[t - 1] + Kb, s[t]:s[t] + Kb] = True
        touched = int(mask.sum())
    nbytes = 4 * (touched + T * Kb + Kb + 2 * T + (T - 1) * Kb + Kb)
    return nbytes, 2.0 * (T - 1) * Kb * Kb


def backtrack_work(B: int, T: int, K: int):
    """The backtrack kernel: delta_T once, the B T psi entries the walk
    reads, paths and scores once; one compare per delta_T entry."""
    nbytes = 4 * (B * K + B * T + B * (T + 1) + B)
    return nbytes, float(B * K)


def beam_work(N: int, K: int, B: int, chunk: int, rows=None):
    """One beam step of N beams of width B: the log_A rows the beams gather
    (`rows` distinct rows; None: min(K, N B) at most), em, scores, states
    and the three outputs once; two adds and a compare per candidate and
    one compare per entry of each chunk merge."""
    rows = min(K, N * B) if rows is None else rows
    nbytes = 4 * (rows * K + N * K + 2 * N * B + 3 * N * B)
    return nbytes, 3.0 * N * B * K + N * (K // chunk) * (B + chunk)


def pass_work(N: int, T: int, K: int, B: int, out_words: int,
              extra_bytes: int = 0):
    """A beam pass of N beams over T steps, every step real: log_A, log_pi,
    em and the pad mask read once, the outputs written once (plus
    `extra_bytes`: the tiles' entry, exit and first flags); two adds and a
    compare per candidate of each transition, 3 N B K a step."""
    nbytes = 4 * (K * K + K + N * T * K + out_words) + N * T + extra_bytes
    return nbytes, 3.0 * N * (T - 1) * B * K


def chunk_work(N: int, C: int, K: int, B: int, n_first: int):
    """A chunk launch of N streaming beams over C rows: log_A, log_pi, em,
    the carried beams and the flags read once, the final beams and every
    row's slot states and from-slots (8 B bytes a row and beam) written
    once; two adds and a compare per candidate of each transition (C - 1
    for a seeding beam, C for a carried one) and an add per seed score."""
    nbytes = 4 * (K * K + K + N * C * K + 2 * N * B + 2 * N * B
                  + 2 * N * C * B) + N
    steps = N * C - n_first
    return nbytes, 3.0 * steps * B * K + n_first * K


def tropical_work(N: int, I: int, K: int, J: int, itemsize: int,
                  with_args: bool = True):
    """N (max, +) products (N, I, K) x (N, K, J): A and B once, vals (and
    args, with the argmax) written once; an add and a compare per
    (n, i, j, k)."""
    nbytes = itemsize * (N * I * K + N * K * J + N * I * J) \
        + (4 * N * I * J if with_args else 0)
    return nbytes, 2.0 * N * I * J * K


def fake_outputs(like: torch.Tensor, entry: str, work, *shapes,
                 launched: bool = True) -> tuple:
    """Empty outputs of ``(shape, dtype)`` each, made from the fake tensor
    `like` (so fake too), after charging `entry`'s launch with `work`
    ((nbytes, ops)) where the kernel would launch (`launched`: not on an
    empty batch)."""
    if launched:
        charge(entry, *work)
    return tuple(like.new_empty(shape, dtype=dtype) for shape, dtype in shapes)


__all__ = ["listening", "charge", "fake", "fake_outputs", "fwd_work",
           "masked_work", "banded_work", "backtrack_work", "beam_work",
           "pass_work", "chunk_work", "tropical_work"]
