"""Constrained decoding: frozen `ConstraintSpec`s compiled to penalty masks,
as in `repro.core.constraints`.

The port keeps its own copy of the JAX package's module: the classes and the
penalty compile are numpy, copied as they are (same error messages, same
``{0.0, NEG_INF}`` float32 arrays, same caches); only `constrain_inputs` is
PyTorch.  Every spec compiles (host-side, cached) to up to three additive f32
penalty arrays whose entries are exactly ``0.0`` or ``NEG_INF``:

    t_pen  (K, K)  transition penalty, added to `log_A`
    pi_pen (K,)    initial-state penalty, added to `log_pi`
    s_pen  (T, K)  per-step state penalty, added to the emissions

Masking is *always* expressed as these adds (tropical-identity adds: adding
``0.0`` keeps a score, adding ``NEG_INF`` kills it).  Every consumer -- the
dense decode over `constrain_inputs`, the masked forward kernel and the
banded kernel -- applies the same float adds to the same operands, so a
constrained decode is bit-identical to an unconstrained decode over the
pre-masked inputs.  That identity is the oracle the tests pin.

Infeasibility is eager: an all-masked step raises `ValueError` at constraint
construction (empty anchor) or at compile time (reachability walk finds an
empty live set), never NaN scores at decode time.

The caches are keyed by the (hashable) constraint, so equal constraints
share compiles exactly like equal `DecodeSpec`s.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import numpy as np
import torch

from .hmm import NEG_INF

__all__ = [
    "ConstraintSpec", "TransitionMaskConstraint", "BandConstraint",
    "LexiconConstraint", "ScheduleConstraint",
    "transition_penalty", "init_penalty", "step_penalty",
    "step_penalty_rows", "compiled_penalties", "constrain_inputs",
    "with_constraint", "banded_state_bytes",
]


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _int_tuple(values: Any, name: str) -> tuple:
    try:
        out = tuple(int(v) for v in values)
    except TypeError:
        raise ValueError(f"{name} must be an iterable of ints, "
                         f"got {values!r}") from None
    _check(all(v >= 0 for v in out), f"{name} entries must be >= 0")
    return out


@dataclasses.dataclass(frozen=True)
class ConstraintSpec:
    """Base class: a hashable description of which states/transitions are legal.

    Subclasses implement the private compile hooks below; the public compiled
    surface (`transition_penalty` / `step_penalty` / `constrain_inputs`) is
    shared and cached.  The hooks are host-side numpy — constraints compile to
    constants, they are never traced.
    """

    def validate(self) -> None:
        """Eager structural validation; raise ValueError on nonsense."""

    def __post_init__(self):
        self.validate()

    # ---- compile hooks (None = unconstrained along that axis) -------------

    def _transition_allowed(self, K: int) -> Optional[np.ndarray]:
        """(K, K) bool, [i, j] True iff i -> j is legal; None = all legal."""
        return None

    def _init_allowed(self, K: int) -> Optional[np.ndarray]:
        """(K,) bool of legal initial states; None = all legal."""
        return None

    def _step_allowed(self, K: int, t: int) -> Optional[np.ndarray]:
        """(K,) bool of states legal at step t; None = all legal.

        Steps beyond a constraint's horizon (e.g. past the last band center)
        are unconstrained and must return None here.
        """
        return None

    def _has_step_component(self) -> bool:
        """Whether a per-step `s_pen` exists at all.

        Must be constant per constraint (not per step): the streaming decoders
        use it to decide whether to add penalty rows chunk-by-chunk, and the
        decision has to match the offline `s_pen is None` choice bit-for-bit.
        """
        return False

    def _schedule_from_reachability(self) -> bool:
        """Whether `s_pen` rows are the reachability walk's live sets.

        Lexicon constraints compile their trie into per-step allowed-state
        sets this way; pure transition masks only use the walk to prove
        feasibility.
        """
        return False

    # ---- planner surface --------------------------------------------------

    def band(self) -> Optional[tuple[tuple[int, ...], int]]:
        """(centers, width) when this is a banded constraint, else None."""
        return None

    def live_states(self, K: int) -> int:
        """Upper bound on states simultaneously live under this constraint."""
        return K

    def mask_bytes(self, K: int, T: int) -> int:
        """Bytes of compiled penalty arrays the generic masked path holds."""
        n = 0
        if self._transition_allowed(K) is not None:
            n += K * K * 4
        if self._init_allowed(K) is not None:
            n += K * 4
        if self._has_step_component():
            n += T * K * 4
        return n


@dataclasses.dataclass(frozen=True)
class TransitionMaskConstraint(ConstraintSpec):
    """Static allowed-transition mask: only the listed (src, dst) arcs are legal.

    `init_states=None` leaves the initial distribution unconstrained.  The
    compile-time reachability walk rejects dead ends eagerly: if after some
    step no state with an outgoing arc is live, `ValueError` is raised at
    compile, not NaN at decode.
    """
    edges: tuple[tuple[int, int], ...]
    init_states: Optional[tuple[int, ...]] = None

    def validate(self):
        _check(len(self.edges) >= 1, "edges must be non-empty")
        object.__setattr__(self, "edges", tuple(
            (int(s), int(d)) for s, d in self.edges))
        _check(all(s >= 0 and d >= 0 for s, d in self.edges),
               "edge endpoints must be >= 0")
        if self.init_states is not None:
            object.__setattr__(self, "init_states",
                               _int_tuple(self.init_states, "init_states"))
            _check(len(self.init_states) >= 1,
                   "init_states must be non-empty (an empty initial set "
                   "masks every path)")

    def _transition_allowed(self, K):
        hi = max(max(s, d) for s, d in self.edges)
        _check(hi < K, f"edge endpoint {hi} out of range for K={K}")
        allowed = np.zeros((K, K), dtype=bool)
        for s, d in self.edges:
            allowed[s, d] = True
        return allowed

    def _init_allowed(self, K):
        if self.init_states is None:
            return None
        _check(max(self.init_states) < K,
               f"init state {max(self.init_states)} out of range for K={K}")
        allowed = np.zeros(K, dtype=bool)
        allowed[list(self.init_states)] = True
        return allowed

    def live_states(self, K):
        states = {s for e in self.edges for s in e}
        states.update(self.init_states or ())
        return min(len(states), K)


@dataclasses.dataclass(frozen=True)
class BandConstraint(ConstraintSpec):
    """Banded reachability: at step t only states within `width` of
    `centers[t]` are legal (map matching: the road cells near observation t).

    Centers are clipped into [0, K-1] at compile; steps past the centers
    horizon are unconstrained.  `FusedSpec` decodes this without ever
    materialising K-wide rows (O(T * Kb^2) work, Kb = 2*width+1); every other
    method applies it as a per-step penalty.  Both are bit-identical to the
    dense masked decode *when the in-band states keep feasible paths* (dense
    `log_A`) — with a sparse `log_A`, compose with `TransitionMaskConstraint`
    semantics by pre-masking `log_A` instead.
    """
    centers: tuple[int, ...]
    width: int

    def validate(self):
        object.__setattr__(self, "centers",
                           _int_tuple(self.centers, "centers"))
        _check(len(self.centers) >= 1, "centers must be non-empty")
        _check(isinstance(self.width, int) and not isinstance(self.width, bool)
               and self.width >= 0,
               f"width must be an int >= 0, got {self.width!r}")

    def _step_allowed(self, K, t):
        if t >= len(self.centers):
            return None
        c = min(max(self.centers[t], 0), K - 1)
        idx = np.arange(K)
        return np.abs(idx - c) <= self.width

    def _has_step_component(self):
        return True

    def band(self):
        return self.centers, self.width

    def live_states(self, K):
        return min(2 * self.width + 1, K)


@dataclasses.dataclass(frozen=True)
class LexiconConstraint(ConstraintSpec):
    """Word/pronunciation trie compiled into per-step allowed-state sets.

    `words[w]` is a tuple of pronunciation *alternatives*; each alternative is
    the state sequence of that pronunciation.  Legal arcs are succession
    within an alternative, optional state self-loops (frame-level dwell,
    `self_loops`) and pronunciation-final -> pronunciation-initial arcs for
    connected word sequences (`loop_words`).  Decoding may start at any
    pronunciation-initial state.

    The per-step allowed sets are the reachability walk's live sets, so the
    compiled `s_pen` encodes exactly "states reachable from some word start
    in t legal arcs" — the FLCVA-style lexical schedule.
    """
    words: tuple[tuple[tuple[int, ...], ...], ...]
    self_loops: bool = True
    loop_words: bool = True

    def validate(self):
        _check(len(self.words) >= 1, "words must be non-empty")
        norm = []
        for w, prons in enumerate(self.words):
            _check(len(prons) >= 1,
                   f"word {w} needs at least one pronunciation")
            norm.append(tuple(_int_tuple(p, f"words[{w}] pronunciation")
                              for p in prons))
            _check(all(len(p) >= 1 for p in norm[-1]),
                   f"word {w} has an empty pronunciation")
        object.__setattr__(self, "words", tuple(norm))

    def _states(self) -> set[int]:
        return {s for prons in self.words for p in prons for s in p}

    def _transition_allowed(self, K):
        hi = max(self._states())
        _check(hi < K, f"lexicon state {hi} out of range for K={K}")
        allowed = np.zeros((K, K), dtype=bool)
        finals, initials = [], []
        for prons in self.words:
            for p in prons:
                initials.append(p[0])
                finals.append(p[-1])
                for a, b in zip(p[:-1], p[1:]):
                    allowed[a, b] = True
        if self.self_loops:
            for s in self._states():
                allowed[s, s] = True
        if self.loop_words:
            for f in finals:
                for i in initials:
                    allowed[f, i] = True
        return allowed

    def _init_allowed(self, K):
        allowed = np.zeros(K, dtype=bool)
        allowed[[p[0] for prons in self.words for p in prons]] = True
        return allowed

    def _has_step_component(self):
        return True

    def _schedule_from_reachability(self):
        return True

    def live_states(self, K):
        return min(len(self._states()), K)


@dataclasses.dataclass(frozen=True)
class ScheduleConstraint(ConstraintSpec):
    """Time-varying mask: at each anchored step only the listed states are
    legal (forced-alignment anchors).  Unanchored steps are unconstrained.

    An empty anchor set would mask the whole step, so it raises here —
    eagerly, at construction.
    """
    anchors: tuple[tuple[int, tuple[int, ...]], ...]

    def validate(self):
        _check(len(self.anchors) >= 1, "anchors must be non-empty")
        norm = []
        for t, states in self.anchors:
            t = int(t)
            _check(t >= 0, f"anchor step {t} must be >= 0")
            states = _int_tuple(states, f"anchor[{t}] states")
            _check(len(states) >= 1,
                   f"anchor at step {t} has an empty state set: every path "
                   f"through step {t} would be masked")
            norm.append((t, states))
        steps = [t for t, _ in norm]
        _check(len(set(steps)) == len(steps), "duplicate anchor steps")
        object.__setattr__(self, "anchors", tuple(norm))

    def _anchor_map(self) -> dict[int, tuple[int, ...]]:
        return dict(self.anchors)

    def _step_allowed(self, K, t):
        states = self._anchor_map().get(t)
        if states is None:
            return None
        _check(max(states) < K,
               f"anchor state {max(states)} out of range for K={K}")
        allowed = np.zeros(K, dtype=bool)
        allowed[list(states)] = True
        return allowed

    def _has_step_component(self):
        return True


# --------------------------------------------------------------------------
# Compilation: constraint -> numpy penalty constants (cached, feasibility-
# checked).  Penalties are additive and exactly {0.0, NEG_INF} in f32.
# --------------------------------------------------------------------------


def _penalty(allowed: np.ndarray) -> np.ndarray:
    out = np.zeros(allowed.shape, dtype=np.float32)
    out[~allowed] = np.float32(NEG_INF)
    return out


@functools.lru_cache(maxsize=512)
def transition_penalty(constraint: ConstraintSpec,
                       K: int) -> Optional[np.ndarray]:
    """(K, K) f32 penalty for `log_A`, or None when transitions are free."""
    allowed = constraint._transition_allowed(K)
    return None if allowed is None else _penalty(allowed)


@functools.lru_cache(maxsize=512)
def init_penalty(constraint: ConstraintSpec, K: int) -> Optional[np.ndarray]:
    """(K,) f32 penalty for `log_pi`, or None when the start is free."""
    allowed = constraint._init_allowed(K)
    return None if allowed is None else _penalty(allowed)


class _ReachWalker:
    """Incremental reachability walk R_t over a constraint's allowed sets.

    R_0 = init ∩ allowed(0); R_t = succ(R_{t-1}) ∩ allowed(t).  Rows are
    cached so streaming decoders can ask for step t without recomputing the
    prefix, and a fixpoint (R_{t+1} == R_t with no step mask ahead) stops the
    walk — the common self-loop lexicon converges in a handful of steps.
    Raises ValueError the moment a step's live set is empty.
    """

    def __init__(self, constraint: ConstraintSpec, K: int):
        self.c = constraint
        self.K = K
        self.ta = constraint._transition_allowed(K)
        init = constraint._init_allowed(K)
        r0 = np.ones(K, dtype=bool) if init is None else init.copy()
        sa0 = constraint._step_allowed(K, 0)
        if sa0 is not None:
            r0 &= sa0
        self.rows: list[np.ndarray] = [r0]
        self.fixpoint: Optional[int] = None
        self._raise_if_empty(r0, 0)

    def _raise_if_empty(self, row: np.ndarray, t: int) -> None:
        if not row.any():
            raise ValueError(
                f"infeasible constraint {type(self.c).__name__}: no legal "
                f"state is reachable at step {t} (every path is masked)")

    def row(self, t: int) -> np.ndarray:
        if self.fixpoint is not None and t >= self.fixpoint:
            return self.rows[self.fixpoint]
        while len(self.rows) <= t:
            prev = self.rows[-1]
            tn = len(self.rows)
            if self.ta is None:
                nxt = np.ones(self.K, dtype=bool)
            else:
                nxt = self.ta[prev, :].any(axis=0)
            sa = self.c._step_allowed(self.K, tn)
            if sa is not None:
                nxt &= sa
            self._raise_if_empty(nxt, tn)
            if sa is None and np.array_equal(nxt, prev):
                # no time-varying mask ahead of a converged set for *this*
                # step; only safe as a terminal fixpoint when the constraint
                # has no step masks at all beyond here — band/schedule rows
                # can re-shrink, so only reachability-scheduled or maskless
                # constraints may stop early.
                if self.c._schedule_from_reachability() or \
                        not self.c._has_step_component():
                    self.fixpoint = tn
                    self.rows.append(nxt)
                    return nxt
            self.rows.append(nxt)
        return self.rows[t]


_WALKERS: dict[tuple[ConstraintSpec, int], _ReachWalker] = {}


def _walker(constraint: ConstraintSpec, K: int) -> _ReachWalker:
    key = (constraint, K)
    w = _WALKERS.get(key)
    if w is None:
        w = _ReachWalker(constraint, K)
        _WALKERS[key] = w
    return w


def _step_row_allowed(constraint: ConstraintSpec, K: int,
                      t: int) -> np.ndarray:
    """The (K,) bool allowed set the compiled `s_pen` row t encodes."""
    if constraint._schedule_from_reachability():
        return _walker(constraint, K).row(t)
    sa = constraint._step_allowed(K, t)
    return np.ones(K, dtype=bool) if sa is None else sa


@functools.lru_cache(maxsize=256)
def step_penalty(constraint: ConstraintSpec, K: int,
                 T: int) -> Optional[np.ndarray]:
    """(T, K) f32 per-step penalty, or None when no step component exists.

    Compiling also proves feasibility over the horizon: the reachability walk
    (init set pushed through the allowed arcs, intersected with each step's
    allowed set) must stay non-empty for T steps, else ValueError.
    """
    walker = _walker(constraint, K)
    for t in range(T):
        walker.row(t)                       # feasibility over the horizon
    if not constraint._has_step_component():
        return None
    out = np.zeros((T, K), dtype=np.float32)
    for t in range(T):
        out[t] = _penalty(_step_row_allowed(constraint, K, t))
    return out


def step_penalty_rows(constraint: ConstraintSpec, K: int, t0: int,
                      n: int) -> Optional[np.ndarray]:
    """Rows [t0, t0+n) of the step penalty, for streaming decoders.

    Returns None when the constraint has no step component (matching the
    offline `step_penalty` None-ness, so streaming and offline apply exactly
    the same float adds).  Rows beyond a constraint's horizon are zeros.
    """
    if not constraint._has_step_component():
        _walker(constraint, K)              # still eager-check step 0
        return None
    out = np.zeros((n, K), dtype=np.float32)
    for i in range(n):
        out[i] = _penalty(_step_row_allowed(constraint, K, t0 + i))
    return out


def compiled_penalties(constraint: ConstraintSpec, K: int, T: int,
                       ) -> tuple[Optional[np.ndarray], Optional[np.ndarray],
                                  Optional[np.ndarray]]:
    """(t_pen, pi_pen, s_pen) for a (K, T) problem; feasibility-checked."""
    if not isinstance(constraint, ConstraintSpec):
        raise TypeError(f"expected a ConstraintSpec, got "
                        f"{type(constraint).__name__}")
    s_pen = step_penalty(constraint, K, T)
    return (transition_penalty(constraint, K),
            init_penalty(constraint, K), s_pen)


def constrain_inputs(constraint: ConstraintSpec, log_pi: torch.Tensor,
                     log_A: torch.Tensor, emissions: torch.Tensor):
    """Apply a constraint as tropical-identity adds on the model inputs.

    Returns (log_pi', log_A', emissions') such that an *unconstrained* decode
    over the primed inputs is the constrained decode.  The penalties become
    tensors on each operand's device and are added in the JAX package's
    operand order (``log_pi + pi_pen``, ``log_A + t_pen``, ``em + s_pen``),
    so the fused and banded kernels, which reproduce these adds, stay
    bit-identical to it.

    `emissions` may be (T, K) or batched (B, T, K); the step penalty is
    shared across the batch (one schedule per constraint).
    """
    K = log_A.shape[-1]
    T = emissions.shape[-2]
    t_pen, pi_pen, s_pen = compiled_penalties(constraint, K, T)
    if pi_pen is not None:
        log_pi = log_pi + _tensor(pi_pen, log_pi)
    if t_pen is not None:
        log_A = log_A + _tensor(t_pen, log_A)
    if s_pen is not None:
        pen = _tensor(s_pen, emissions)
        emissions = emissions + (pen if emissions.dim() == 2 else pen[None])
    return log_pi, log_A, emissions


def _tensor(pen: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(pen).to(device=like.device, dtype=like.dtype)


def with_constraint(spec, constraint: Optional[ConstraintSpec]):
    """Return `spec` with its `constraint` field replaced (specs are frozen)."""
    return dataclasses.replace(spec, constraint=constraint)


def banded_state_bytes(K: int, T: int, width: int) -> int:
    """Live DP-state bytes of the banded fast path (window backpointers only).

    T windows of Kb = 2*width+1 local backpointers, the Kb-float frontier,
    and the T window starts — the band analogue of the fused path's
    K*T*4 + K*8 (`decoder_state_bytes("fused", ...)` in the JAX package's
    planner).
    """
    Kb = min(2 * width + 1, K)
    return T * Kb * 4 + Kb * 8 + T * 4
