"""Typed decode specs, as in `repro.core.spec`: the configuration objects
behind every decoder.

A `DecodeSpec` is a frozen, hashable dataclass that pins one algorithm plus
exactly the tunables it consumes.  Nonsense is rejected eagerly: ``bt=0``
raises `ValueError` at construction, an unknown tunable raises `TypeError`
from the dataclass constructor.

Every method of the JAX package is ported, each with an optional
``constraint`` (`core.constraints.ConstraintSpec`): the eight offline ones
and the two streaming ones (``online``, ``online_beam``), whose
`make_streaming` builds the incremental decoder that `serving.stream` wraps.
The JAX spec's ``jittable`` flag has no counterpart: PyTorch runs eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Mapping, Optional

from ..kernels.ops import (viterbi_decode_banded, viterbi_decode_fused,
                           viterbi_decode_fused_masked)
from .assoc import viterbi_assoc
from .beam_static import beam_static_mp_viterbi, beam_static_viterbi
from .checkpoint_viterbi import viterbi_checkpoint
from .constraints import ConstraintSpec, compiled_penalties, constrain_inputs
from .flash import flash_viterbi
from .flash_bs import flash_bs_viterbi
from .online import (OnlineBeamDecoder, OnlineViterbiDecoder, viterbi_online,
                     viterbi_online_beam)
from .vanilla import viterbi_vanilla

__all__ = [
    "ResourceBudget", "DecodeSpec",
    "VanillaSpec", "CheckpointSpec", "FlashSpec", "FlashBSSpec",
    "BeamStaticSpec", "BeamStaticMPSpec", "AssocSpec", "FusedSpec",
    "OnlineSpec", "OnlineBeamSpec",
    "SPEC_BY_METHOD", "spec_from_tunables", "as_decode_spec",
]

def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_pos(value: Any, name: str) -> None:
    _check(isinstance(value, int) and not isinstance(value, bool)
           and value >= 1, f"{name} must be an int >= 1, got {value!r}")


def _check_lanes(lanes: Any) -> None:
    """lanes: None = whole layers at once, -1 = match parallelism, n >= 1."""
    if lanes is None or lanes == -1:
        return
    _check_pos(lanes, "lanes")


def _check_opt_pos(value: Any, name: str) -> None:
    if value is not None:
        _check_pos(value, name)


@dataclasses.dataclass(frozen=True)
class ResourceBudget:
    """Deployment resource envelope handed to the planner.

    memory_bytes: cap on live decoder-state bytes; None = unlimited.
    latency_hint: "latency" (default), "memory", or None.
    """
    memory_bytes: int | None = None
    latency_hint: str | None = None

    def __post_init__(self):
        if self.memory_bytes is not None:
            _check_pos(self.memory_bytes, "memory_bytes")
        _check(self.latency_hint in (None, "latency", "memory"),
               f"latency_hint must be None, 'latency' or 'memory', "
               f"got {self.latency_hint!r}")


@dataclasses.dataclass(frozen=True)
class DecodeSpec:
    """Base class: one decoding algorithm + its (validated) tunables.

    Subclasses set the class-level contract:
      method          -- the method name, as in the JAX package.
      batch_method    -- name in `core.batch.BATCH_METHODS`, or None.
      legacy_tunables -- legacy kwarg name -> field name map.

    Every spec carries an optional `constraint`: a frozen, hashable
    description of which states and transitions are legal.  `run` applies it
    by masking the inputs with tropical-identity adds (`constrain_inputs`),
    so a constrained decode is bit-identical to the same method over the
    pre-masked model; `FusedSpec` overrides `_run_constrained` to make the
    same adds inside its kernels instead.
    """
    method: ClassVar[str] = ""
    batch_method: ClassVar[str | None] = None
    legacy_tunables: ClassVar[Mapping[str, str]] = {}
    constraint: Optional[ConstraintSpec] = dataclasses.field(
        default=None, kw_only=True)

    def __post_init__(self):
        if self.constraint is not None and \
                not isinstance(self.constraint, ConstraintSpec):
            raise TypeError(f"constraint must be a ConstraintSpec or None, "
                            f"got {type(self.constraint).__name__}")
        self.validate()

    def validate(self) -> None:
        """Eager validation; subclasses raise ValueError on nonsense."""

    def run(self, log_pi, log_A, emissions):
        """Decode one (T, K) sequence; returns (path (T,) int32, score)."""
        if self.constraint is None:
            return self._run(log_pi, log_A, emissions)
        return self._run_constrained(log_pi, log_A, emissions,
                                     self.constraint)

    def _run(self, log_pi, log_A, emissions):
        """The unconstrained decode; what subclasses implement."""
        raise NotImplementedError

    def _run_constrained(self, log_pi, log_A, emissions, constraint):
        """Constrained decode; default = the method over pre-masked inputs."""
        return self._run(*constrain_inputs(constraint, log_pi, log_A,
                                           emissions))

    def batch_tunables(self) -> dict[str, Any]:
        """Tunables forwarded to `viterbi_decode_batch` (batchable specs)."""
        return {}


@dataclasses.dataclass(frozen=True)
class VanillaSpec(DecodeSpec):
    """Textbook DP with the full backpointer table: the exact oracle."""
    method: ClassVar[str] = "vanilla"
    batch_method: ClassVar[str | None] = "vanilla"

    def _run(self, log_pi, log_A, emissions):
        return viterbi_vanilla(log_pi, log_A, emissions)


@dataclasses.dataclass(frozen=True)
class CheckpointSpec(DecodeSpec):
    """Tarnas-Hughey checkpointing; seg_len=None means ceil(sqrt(T))."""
    method: ClassVar[str] = "checkpoint"
    legacy_tunables: ClassVar[Mapping[str, str]] = {"seg_len": "seg_len"}
    seg_len: int | None = None

    def validate(self):
        _check_opt_pos(self.seg_len, "seg_len")

    def _run(self, log_pi, log_A, emissions):
        return viterbi_checkpoint(log_pi, log_A, emissions,
                                  seg_len=self.seg_len)


@dataclasses.dataclass(frozen=True)
class FlashSpec(DecodeSpec):
    """The paper's non-recursive divide-and-conquer wavefront (exact)."""
    method: ClassVar[str] = "flash"
    batch_method: ClassVar[str | None] = "flash"
    legacy_tunables: ClassVar[Mapping[str, str]] = {
        "parallelism": "parallelism", "lanes": "lanes"}
    parallelism: int = 8
    lanes: int | None = -1

    def validate(self):
        _check_pos(self.parallelism, "parallelism")
        _check_lanes(self.lanes)

    def _run(self, log_pi, log_A, emissions):
        return flash_viterbi(log_pi, log_A, emissions,
                             parallelism=self.parallelism, lanes=self.lanes)

    def batch_tunables(self):
        return {"parallelism": self.parallelism, "lanes": self.lanes}


@dataclasses.dataclass(frozen=True)
class FlashBSSpec(DecodeSpec):
    """FLASH with the dynamic top-B beam (exact when beam_width >= K); every
    beam transition is one launch of the beam kernel."""
    method: ClassVar[str] = "flash_bs"
    batch_method: ClassVar[str | None] = "flash_bs"
    legacy_tunables: ClassVar[Mapping[str, str]] = {
        "beam_width": "beam_width", "parallelism": "parallelism",
        "lanes": "lanes", "chunk": "chunk"}
    beam_width: int = 128
    parallelism: int = 8
    lanes: int | None = -1
    chunk: int = 128

    def validate(self):
        _check_pos(self.beam_width, "beam_width")
        _check_pos(self.parallelism, "parallelism")
        _check_lanes(self.lanes)
        _check_pos(self.chunk, "chunk")

    def _run(self, log_pi, log_A, emissions):
        return flash_bs_viterbi(log_pi, log_A, emissions,
                                beam_width=self.beam_width,
                                parallelism=self.parallelism,
                                lanes=self.lanes, chunk=self.chunk)

    def batch_tunables(self):
        return {"beam_width": self.beam_width,
                "parallelism": self.parallelism,
                "lanes": self.lanes, "chunk": self.chunk}


@dataclasses.dataclass(frozen=True)
class BeamStaticSpec(DecodeSpec):
    """Static beam baseline (scores all K, then truncates to the beam)."""
    method: ClassVar[str] = "beam_static"
    legacy_tunables: ClassVar[Mapping[str, str]] = {"beam_width": "beam_width"}
    beam_width: int = 128

    def validate(self):
        _check_pos(self.beam_width, "beam_width")

    def _run(self, log_pi, log_A, emissions):
        return beam_static_viterbi(log_pi, log_A, emissions,
                                   B=min(self.beam_width,
                                         emissions.shape[1]))


@dataclasses.dataclass(frozen=True)
class BeamStaticMPSpec(DecodeSpec):
    """Static beam on the multi-partition FLASH wavefront (FLASH-BS with
    chunk = K, so it runs on the beam kernel)."""
    method: ClassVar[str] = "beam_static_mp"
    legacy_tunables: ClassVar[Mapping[str, str]] = {
        "beam_width": "beam_width", "parallelism": "parallelism",
        "lanes": "lanes"}
    beam_width: int = 128
    parallelism: int = 8
    lanes: int | None = -1

    def validate(self):
        _check_pos(self.beam_width, "beam_width")
        _check_pos(self.parallelism, "parallelism")
        _check_lanes(self.lanes)

    def _run(self, log_pi, log_A, emissions):
        return beam_static_mp_viterbi(log_pi, log_A, emissions,
                                      beam_width=self.beam_width,
                                      parallelism=self.parallelism,
                                      lanes=self.lanes)


@dataclasses.dataclass(frozen=True)
class AssocSpec(DecodeSpec):
    """Tropical associative scan on the tropical kernel: O(log T) depth,
    O(K^3 T) work."""
    method: ClassVar[str] = "assoc"

    def _run(self, log_pi, log_A, emissions):
        return viterbi_assoc(log_pi, log_A, emissions)


@dataclasses.dataclass(frozen=True)
class FusedSpec(DecodeSpec):
    """The fused forward kernel, then the backtrack kernel.

    `bt` is kept for parity with the TPU kernel's time-block size; it has no
    effect on the card.
    """
    method: ClassVar[str] = "fused"
    batch_method: ClassVar[str | None] = "fused"
    legacy_tunables: ClassVar[Mapping[str, str]] = {"bt": "bt"}
    bt: int = 8

    def validate(self):
        _check_pos(self.bt, "bt")

    def _run(self, log_pi, log_A, emissions):
        return viterbi_decode_fused(log_pi, log_A, emissions, bt=self.bt)

    def _run_constrained(self, log_pi, log_A, emissions, constraint):
        # The constraint is applied inside the kernels: a BandConstraint that
        # covers the horizon decodes over sliding windows (the banded
        # kernel, never a K-wide row), anything else fuses the penalty adds
        # into the masked forward kernel.  Both reproduce the masked-input
        # adds operand for operand, so results stay bit-identical to the
        # generic path.
        T = emissions.shape[0]
        band = constraint.band()
        if band is not None and len(band[0]) >= T:
            centers, width = band
            return viterbi_decode_banded(log_pi, log_A, emissions,
                                         centers[:T], width=width)
        K = log_A.shape[-1]
        t_pen, pi_pen, s_pen = compiled_penalties(constraint, K, T)
        return viterbi_decode_fused_masked(log_pi, log_A, emissions,
                                           t_pen=t_pen, pi_pen=pi_pen,
                                           s_pen=s_pen, bt=self.bt)

    def batch_tunables(self):
        return {"bt": self.bt}


@dataclasses.dataclass(frozen=True)
class OnlineSpec(DecodeSpec):
    """Streaming exact decode (convergence-point commits), one-shot form.

    `stream_chunk` is the chunk size the one-shot `run` feeds with; `max_lag`
    bounds commit latency (forced flushes make the forced part approximate).
    For true incremental use build the decoder via `make_streaming`.
    """
    method: ClassVar[str] = "online"
    legacy_tunables: ClassVar[Mapping[str, str]] = {
        "stream_chunk": "stream_chunk", "max_lag": "max_lag"}
    stream_chunk: int = 64
    max_lag: int | None = None

    def validate(self):
        _check_pos(self.stream_chunk, "stream_chunk")
        _check_opt_pos(self.max_lag, "max_lag")

    def _run(self, log_pi, log_A, emissions):
        return viterbi_online(log_pi, log_A, emissions,
                              chunk_size=self.stream_chunk,
                              max_lag=self.max_lag)

    def make_streaming(self, log_pi, log_A):
        """The stateful incremental decoder `serving.stream` wraps."""
        return OnlineViterbiDecoder(log_pi, log_A, max_lag=self.max_lag,
                                    constraint=self.constraint)


@dataclasses.dataclass(frozen=True)
class OnlineBeamSpec(DecodeSpec):
    """Streaming dynamic beam: live state O(W*B), K never materialises; a
    chunk is one launch of the beam kernel's chunk mode."""
    method: ClassVar[str] = "online_beam"
    legacy_tunables: ClassVar[Mapping[str, str]] = {
        "beam_width": "beam_width", "chunk": "kchunk",
        "stream_chunk": "stream_chunk", "max_lag": "max_lag"}
    beam_width: int = 128
    kchunk: int = 128
    stream_chunk: int = 64
    max_lag: int | None = None

    def validate(self):
        _check_pos(self.beam_width, "beam_width")
        _check_pos(self.kchunk, "kchunk")
        _check_pos(self.stream_chunk, "stream_chunk")
        _check_opt_pos(self.max_lag, "max_lag")

    def _run(self, log_pi, log_A, emissions):
        return viterbi_online_beam(log_pi, log_A, emissions,
                                   beam_width=self.beam_width,
                                   kchunk=self.kchunk,
                                   chunk_size=self.stream_chunk,
                                   max_lag=self.max_lag)

    def make_streaming(self, log_pi, log_A):
        return OnlineBeamDecoder(log_pi, log_A, beam_width=self.beam_width,
                                 kchunk=self.kchunk, max_lag=self.max_lag,
                                 constraint=self.constraint)


SPEC_BY_METHOD: dict[str, type[DecodeSpec]] = {
    cls.method: cls for cls in (
        VanillaSpec, CheckpointSpec, FlashSpec, FlashBSSpec,
        BeamStaticSpec, BeamStaticMPSpec, AssocSpec, FusedSpec,
        OnlineSpec, OnlineBeamSpec)
}


def spec_from_tunables(method: str, tunables: dict[str, Any],
                       ) -> tuple[DecodeSpec, tuple[str, ...]]:
    """Build the spec for a legacy (method, kwargs) call.

    Returns (spec, ignored): `ignored` names the tunables `method` does not
    consume.
    """
    if "constraint" in tunables:
        raise TypeError(
            "constraint= is not a legacy tunable; construct a typed spec "
            "instead, e.g. FusedSpec(constraint=...) or "
            "with_constraint(spec, constraint)")
    try:
        cls = SPEC_BY_METHOD[method]
    except KeyError:
        raise ValueError(f"unknown method {method!r}; choose from "
                         f"{tuple(SPEC_BY_METHOD)}") from None
    fields: dict[str, Any] = {}
    ignored: list[str] = []
    for name, value in tunables.items():
        target = cls.legacy_tunables.get(name)
        if target is None:
            ignored.append(name)
        else:
            fields[target] = value
    return cls(**fields), tuple(ignored)


def as_decode_spec(obj: Any) -> DecodeSpec:
    """Coerce a spec-like object (spec, or anything with `.to_spec()`)."""
    if isinstance(obj, DecodeSpec):
        return obj
    to_spec = getattr(obj, "to_spec", None)
    if callable(to_spec):
        return to_spec()
    raise TypeError(f"expected a DecodeSpec (or an object with .to_spec()), "
                    f"got {type(obj).__name__}")
