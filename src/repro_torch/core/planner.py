"""Budget -> spec planning, as in `repro.core.planner`: the cost model and
the paper's degradation ladder (Sec. V-C-3).

* **The memory cost model.** `decoder_state_bytes(method, K, T, P, B)`: the
  analytic live-DP-state formulas the paper's Fig. 1/7/9 track.
  `spec_state_bytes(spec, K, T)` is the typed view of the same model.

* **The degradation ladder.** `plan(K, T, budget)` turns a `ResourceBudget`
  into a `DecodePlan`, a concrete `DecodeSpec` plus a human-readable `why`:
  the exact decoder at the largest parallelism that fits, then smaller P,
  then the dynamic beam (widest beam first), then the floor config.  A
  smaller budget never yields a larger-footprint plan.

Pure arithmetic, copied from the JAX module.  Its streaming-admission
helpers (`online_session_bytes`, `inflight_state_bytes`, `plan_admission`)
wait for the streaming and inflight slices, and its IR cross-check
(`IR_STATE_FACTOR`, `crosscheck_state_bytes`) for the port's static analysis
(ROADMAP Queue 1 items 6, 7 and 9).
"""

from __future__ import annotations

import dataclasses
import math

from .constraints import ConstraintSpec, banded_state_bytes
from .spec import DecodeSpec, FlashSpec, FlashBSSpec, FusedSpec, ResourceBudget

__all__ = ["decoder_state_bytes", "spec_state_bytes", "DecodePlan", "plan"]


def decoder_state_bytes(method: str, K: int, T: int, P: int = 8,
                        B: int = 128) -> int:
    """Live DP-state bytes per the complexity table (paper Fig. 1).

    4-byte scores + 4-byte indices; FLASH tracks (OptProb, PreState-equivalent,
    MidState/DivState); beams track (score, state, mid) per slot.
    """
    if method in ("vanilla", "fused", "online"):
        # full psi table + delta; `fused` streams the same table through the
        # kernel, `online` holds it as the worst-case commit window.
        return K * T * 4 + K * 8
    if method == "checkpoint":
        c = int(math.ceil(math.sqrt(T)))
        return K * c * 4 + K * c * 4 + K * 8     # checkpoints + segment psis
    if method in ("sieve", "sieve_mp"):
        return K * 12                            # delta + mid + entry vector
    if method == "flash":
        return P * K * 12 + (P - 1) * K * 4      # P lanes + DivState
    if method == "flash_bs":
        return P * B * 12 + (P - 1) * B * 4
    if method == "online_beam":
        # streaming beam: worst case the commit window never converges, so up
        # to T slot-pointer rows (state + from, 4B each, per slot) stay live
        # on top of the O(B) beam carry.  Expected window is O(B log B), but
        # the planner must bound, not hope.
        return T * B * 8 + B * 12
    if method == "beam_static":
        return K * 4 + T * B * 8                 # full-K transient + survivors
    if method == "beam_static_mp":
        return K * 4 + P * B * 12                # full-K transient per step
    if method == "assoc":
        return T * K * K * 4
    raise ValueError(method)


def spec_state_bytes(spec: DecodeSpec, K: int, T: int) -> int:
    """Cost-model bytes for a typed spec (the planner's fitness function).

    A constrained spec pays for its compiled penalty masks on top of the
    method's DP state — except the banded fused path, which never
    materialises K-wide rows and is costed by `banded_state_bytes` (this is
    how a tight `BandConstraint` keeps exact decoding on the ladder at
    budgets where the dense methods have long since degraded to beams).
    """
    P = getattr(spec, "parallelism", 1)
    B = getattr(spec, "beam_width", 128)
    base = decoder_state_bytes(spec.method, K, T, P=P, B=B)
    c = spec.constraint
    if c is None:
        return base
    band = c.band()
    if spec.method == "fused" and band is not None and len(band[0]) >= T:
        return banded_state_bytes(K, T, band[1])
    return base + c.mask_bytes(K, T)


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """A planner decision: the spec to run plus the reasoning behind it.

    state_bytes is the cost-model estimate for the *whole* planned workload
    (per-sequence bytes x batch when a batch size was planned for).
    """
    spec: DecodeSpec
    why: str
    state_bytes: int
    K: int
    T: int
    batch: int | None = None
    budget: ResourceBudget | None = None


# Paper Sec. V-C-3 ladder, as in the JAX planner: exact at descending P,
# then beams widest-first with descending P, then the floor.  First fit wins,
# so footprint is monotone in the budget.
_EXACT_P = (16, 8, 4, 2, 1)
_BEAM_B = (256, 128, 64, 32)
_BEAM_P = (8, 4, 1)
_FLOOR = FlashBSSpec(parallelism=1, beam_width=16)


def plan(K: int, T: int,
         budget: ResourceBudget | int | None = None,
         batch: int | None = None,
         constraint: ConstraintSpec | None = None) -> DecodePlan:
    """Pick the best-fitting decoder spec for a (K, T) workload.

    Args:
      K, T: state count and sequence length of the workload.
      budget: a `ResourceBudget`, a raw byte count (shorthand for
        ``ResourceBudget(memory_bytes=...)``), or None (unlimited).
      batch: optional number of sequences decoded together; the footprint is
        per-sequence bytes x batch, and the chosen spec is guaranteed to be a
        `viterbi_decode_batch` method.
      constraint: optional `ConstraintSpec` the workload decodes under.
        Every rung carries it (its mask bytes count against the budget), and
        a `BandConstraint` covering the horizon adds an exact banded-fused
        rung between the exact and beam rungs — so a tight constraint keeps
        exact decoding alive at budgets where the dense ladder has already
        degraded to beams.

    Returns a `DecodePlan`; `.spec` is ready for `ViterbiDecoder` and
    `.why` says which ladder rung fired and what it cost.
    """
    if isinstance(budget, int):
        budget = ResourceBudget(memory_bytes=budget)
    budget = budget or ResourceBudget()
    if batch is not None and batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    scale = int(batch) if batch is not None else 1
    cap = budget.memory_bytes

    def fits(spec: DecodeSpec) -> int | None:
        bytes_ = spec_state_bytes(spec, K, T) * scale
        return bytes_ if cap is None or bytes_ <= cap else None

    def mk(spec, why, bytes_):
        per = " per batch" if batch else ""
        cap_s = ""
        if cap is not None:
            rel = "<=" if bytes_ <= cap else "exceeds"
            cap_s = f" {rel} budget {cap:,}B"
        return DecodePlan(spec=spec, why=f"{why} (state {bytes_:,}B{per}{cap_s})",
                          state_bytes=bytes_, K=K, T=T, batch=batch,
                          budget=budget)

    exact_ps = (_EXACT_P if budget.latency_hint != "memory"
                else tuple(reversed(_EXACT_P)))
    for P in exact_ps:
        spec = FlashSpec(parallelism=P, constraint=constraint)
        bytes_ = fits(spec)
        if bytes_ is not None:
            return mk(spec, f"exact, P={P}", bytes_)
    # still exact, far smaller state: the banded fused path (single-sequence
    # only — the batched fused kernel applies the band as fused penalty adds
    # instead, whose footprint the rungs above already modeled).
    band = constraint.band() if constraint is not None else None
    if band is not None and len(band[0]) >= T and batch is None:
        spec = FusedSpec(constraint=constraint)
        bytes_ = fits(spec)
        if bytes_ is not None:
            return mk(spec, f"exact banded fused, width={band[1]}", bytes_)
    for B in _BEAM_B:
        for P in _BEAM_P:
            spec = FlashBSSpec(parallelism=P, beam_width=B,
                               constraint=constraint)
            bytes_ = fits(spec)
            if bytes_ is not None:
                return mk(spec, f"beam, P={P}, B={B}", bytes_)
    floor = dataclasses.replace(_FLOOR, constraint=constraint)
    return mk(floor, "floor: P=1,B=16",
              spec_state_bytes(floor, K, T) * scale)
