"""Contract checker for every registered `DecodeSpec`, as
`repro.analysis.contracts` is the JAX package's.

PyTorch has no abstract evaluation of a decode, so every contract here runs
the decode on small seeded inputs, on the device it is given.  Three
families:

  * **Shape and dtype contracts.**  Every spec over the (K, T) grid, and
    every batchable spec over the (K, T, B) grid with ragged lengths: paths
    int32 of the right shape, scores float32, and no float64 output.

  * **Memory contract.**  The planner's `decoder_state_bytes` model is what
    the budget -> plan ladder trusts (`core/planner.py`).
    `allocated_state_bytes(spec, K, T, device)`, the counterpart of JAX's
    `compiled_state_bytes`, is on the card the peak of
    `torch.cuda.max_memory_allocated` over one decode minus the bytes
    allocated before it, and must stay at or under the model x
    `MEMORY_TOLERANCE[method]` (the JAX package's values, as they are).  A
    departure is a PV104 finding on the subject
    ``memory:cuda:<method>[K=..,T=..]``: it fails the contract unless the
    module that owns the computation waives it (`FLASHPROVE_WAIVERS`) with
    its measured ratio and cause; a tolerance is never raised to absorb it.
    On the CPU there is no allocator to read: `allocated_state_bytes`
    returns None and the check is listed under ``skipped`` as needing the
    card, which is not a pass.

  * **Streaming contracts.**  The online decoders are stateful host loops,
    so their contract is checked live on a tiny stream: committed paths are
    int32 and complete, and the peak `live_state_bytes()` of the decoder, of
    a `StreamSession` fed ragged pieces (its buffered frames count) and of
    the `StreamMux` around it never exceeds the planner model.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.planner import spec_state_bytes
from ..core.spec import (AssocSpec, BeamStaticMPSpec, BeamStaticSpec,
                         CheckpointSpec, DecodeSpec, FlashBSSpec, FlashSpec,
                         FusedSpec, OnlineBeamSpec, OnlineSpec, SPEC_BY_METHOD,
                         VanillaSpec)

__all__ = [
    "TRACEABLE_SPECS", "STREAMING_SPECS", "SHAPE_GRID", "BATCH_GRID",
    "MEMORY_GRID", "MEMORY_TOLERANCE", "ContractError", "ContractReport",
    "check_contracts", "check_shape_contracts", "check_memory_contracts",
    "check_streaming_contracts", "allocated_state_bytes", "seeded_hmm",
]

#: One default-constructed instance per offline method (JAX's
#: TRACEABLE_SPECS: the specs the JAX package can jit).
TRACEABLE_SPECS: tuple[DecodeSpec, ...] = (
    VanillaSpec(), CheckpointSpec(), FlashSpec(), FlashBSSpec(),
    BeamStaticSpec(), BeamStaticMPSpec(), AssocSpec(), FusedSpec())

#: The stateful streaming methods (checked live).
STREAMING_SPECS: tuple[DecodeSpec, ...] = (
    OnlineSpec(stream_chunk=16), OnlineBeamSpec(stream_chunk=16))

SHAPE_GRID: tuple[tuple[int, int], ...] = ((8, 16), (24, 64), (64, 256))
BATCH_GRID: tuple[tuple[int, int, int], ...] = ((16, 32, 3), (24, 48, 5))
MEMORY_GRID: tuple[tuple[int, int], ...] = ((24, 64), (64, 256))

#: Pinned ceilings for allocated / model, per method (the JAX package's
#: values, as they are).
MEMORY_TOLERANCE: dict[str, float] = {
    "vanilla": 8.0,
    "checkpoint": 16.0,
    "flash": 96.0,
    "flash_bs": 64.0,
    "beam_static": 4.0,
    "beam_static_mp": 96.0,
    "assoc": 64.0,
    "fused": 8.0,
}


class ContractError(AssertionError):
    """A decode-stack contract does not hold."""


@dataclasses.dataclass
class ContractReport:
    checks: list[str] = dataclasses.field(default_factory=list)
    failures: list[str] = dataclasses.field(default_factory=list)
    skipped: list[str] = dataclasses.field(default_factory=list)
    #: memory departures waived by their owning module, with the reason
    waived: list[str] = dataclasses.field(default_factory=list)
    #: (method, K, T) -> allocated / model ratio from the memory pass.
    memory_ratios: dict[tuple[str, int, int], float] = dataclasses.field(
        default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.failures

    def raise_if_failed(self) -> None:
        if self.failures:
            raise ContractError(
                f"{len(self.failures)} contract violation(s):\n  "
                + "\n  ".join(self.failures))


def seeded_hmm(K: int, T: int, device, B: int | None = None,
               seed: int = 0):
    """(log_pi (K,), log_A (K, K), em (T, K) or (B, T, K)), float32 on
    `device`, drawn with numpy from a seed: the gate's inputs."""
    rng = np.random.default_rng(seed + 7 * K + T)
    log_pi = torch.log_softmax(torch.from_numpy(rng.standard_normal(K)), 0)
    log_A = torch.log_softmax(torch.from_numpy(rng.standard_normal((K, K))),
                              1)
    em = torch.from_numpy(rng.standard_normal((T, K) if B is None
                                              else (B, T, K)))
    return tuple(x.to(device=device, dtype=torch.float32)
                 for x in (log_pi, log_A, em))


def _expect(report: ContractReport, what: str, cond: bool, detail: str):
    if cond:
        report.checks.append(what)
    else:
        report.failures.append(f"{what}: {detail}")


def _check_pair(report: ContractReport, label: str, out, path_shape,
                score_shape):
    path, score = out
    score = torch.as_tensor(score)
    _expect(report, f"{label} path",
            tuple(path.shape) == tuple(path_shape)
            and path.dtype == torch.int32,
            f"got shape={tuple(path.shape)} dtype={path.dtype}; want "
            f"{tuple(path_shape)} int32")
    _expect(report, f"{label} score",
            tuple(score.shape) == tuple(score_shape)
            and score.dtype == torch.float32,
            f"got shape={tuple(score.shape)} dtype={score.dtype}; want "
            f"{tuple(score_shape)} float32")
    _expect(report, f"{label} no float64",
            torch.float64 not in (path.dtype, score.dtype),
            "a float64 output leaked out of the decode")


# ---------------------------------------------------------------------------
# Shape and dtype contracts
# ---------------------------------------------------------------------------

def check_shape_contracts(specs: Sequence[DecodeSpec] = TRACEABLE_SPECS,
                          grid: Sequence[tuple[int, int]] = SHAPE_GRID,
                          batch_grid: Sequence[tuple[int, int, int]]
                          = BATCH_GRID, device="cpu",
                          report: ContractReport | None = None
                          ) -> ContractReport:
    from ..core.batch import viterbi_decode_batch

    report = report if report is not None else ContractReport()
    dev = torch.device(device)
    for spec in specs:
        for K, T in grid:
            label = f"shape[{spec.method} K={K} T={T}]"
            pi, A, em = seeded_hmm(K, T, dev)
            try:
                out = spec.run(pi, A, em)
            except Exception as e:   # the decode itself must not fail
                report.failures.append(f"{label}: run error {e!r}")
                continue
            _check_pair(report, label, out, (T,), ())
        if spec.batch_method is None:
            continue
        for K, T, B in batch_grid:
            label = f"shape[{spec.method} batch K={K} T={T} B={B}]"
            pi, A, em = seeded_hmm(K, T, dev, B=B)
            # ragged on purpose: every row a different true length
            lengths = torch.tensor([(i % T) + 1 for i in range(B)],
                                   dtype=torch.int32)
            try:
                out = viterbi_decode_batch(em, pi, A, lengths,
                                           method=spec.batch_method,
                                           **spec.batch_tunables())
            except Exception as e:
                report.failures.append(f"{label}: run error {e!r}")
                continue
            _check_pair(report, label, out, (B, T), (B,))
    return report


# ---------------------------------------------------------------------------
# Memory contract (the card's allocator)
# ---------------------------------------------------------------------------

def allocated_state_bytes(spec: DecodeSpec, K: int, T: int, device
                          ) -> int | None:
    """Bytes one ``spec.run`` at (K, T) allocates at its peak on a CUDA
    device, above what was allocated before it; None on the CPU.  The
    decode runs once first, so that kernel builds and loads stay out."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    pi, A, em = seeded_hmm(K, T, dev)
    spec.run(pi, A, em)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    out = spec.run(pi, A, em)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - before
    del out
    return int(peak)


def check_memory_contracts(specs: Sequence[DecodeSpec] = TRACEABLE_SPECS,
                           grid: Sequence[tuple[int, int]] = MEMORY_GRID,
                           device="cpu",
                           report: ContractReport | None = None
                           ) -> ContractReport:
    from .findings import (Finding, apply_waivers, collect_waivers,
                           waiver_applies)

    report = report if report is not None else ContractReport()
    dev = torch.device(device)
    departures: list[Finding] = []
    for spec in specs:
        tol = MEMORY_TOLERANCE.get(spec.method)
        if tol is None:
            report.failures.append(
                f"memory[{spec.method}]: no pinned tolerance in "
                f"MEMORY_TOLERANCE; add one")
            continue
        for K, T in grid:
            label = f"memory[{spec.method} K={K} T={T}]"
            got = allocated_state_bytes(spec, K, T, dev)
            if got is None:
                report.skipped.append(f"{label}: needs the card (the CUDA "
                                      f"allocator's peak)")
                continue
            model = spec_state_bytes(spec, K, T)
            ratio = got / max(model, 1)
            report.memory_ratios[(spec.method, K, T)] = ratio
            if got <= model * tol:
                report.checks.append(label)
                continue
            departures.append(Finding(
                "PV104", f"memory:{dev.type}:{spec.method}[K={K},T={T}]",
                f"allocated {got:,}B = {ratio:.2f}x the model {model:,}B > "
                f"tolerance {tol}; the planner would under-budget this "
                f"spec"))
    waivers, malformed = collect_waivers()
    waivers = {k: r for k, r in waivers.items()
               if k.startswith("PV104:memory:") and waiver_applies(k, dev.type)}
    active, waived = apply_waivers(departures, waivers, require_used=False)
    report.failures.extend(str(f) for f in malformed + active)
    report.waived.extend(f"{f} ({reason})" for f, reason in waived)
    return report


# ---------------------------------------------------------------------------
# Streaming (stateful) contracts: a tiny live run
# ---------------------------------------------------------------------------

def _pieces(T: int, seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    out, left = [], T
    while left:
        n = int(min(left, rng.integers(1, 12)))
        out.append(n)
        left -= n
    return out


def check_streaming_contracts(specs: Sequence[DecodeSpec] = STREAMING_SPECS,
                              K: int = 16, T: int = 48, seed: int = 0,
                              device="cpu",
                              report: ContractReport | None = None
                              ) -> ContractReport:
    from ..serving.stream import StreamMux

    report = report if report is not None else ContractReport()
    dev = torch.device(device)
    log_pi, log_A, em = seeded_hmm(K, T, dev, seed=seed)
    em_np = em.cpu().numpy()
    for spec in specs:
        label = f"streaming[{spec.method} K={K} T={T}]"
        model = spec_state_bytes(spec, K, T)
        dec = spec.make_streaming(log_pi, log_A)
        chunk = getattr(spec, "stream_chunk", 16)
        peak = 0
        for s in range(0, T, chunk):
            dec.feed(em[s:s + chunk])
            peak = max(peak, dec.live_state_bytes())
        dec.flush()
        path = dec.path
        _expect(report, f"{label} path",
                path.shape == (T,) and path.dtype == np.int32,
                f"got shape={path.shape} dtype={path.dtype}; want ({T},) "
                f"int32")
        _expect(report, f"{label} live-state", peak <= model,
                f"measured peak live state {peak:,}B exceeds the planner "
                f"model {model:,}B; decoder_state_bytes({spec.method!r}) "
                f"drifted from the implementation")

        # the serving tier: a session in a mux, fed ragged pieces, so that
        # frames wait in its buffer between blocks
        mux = StreamMux(log_pi, log_A, spec, blocks=(chunk,), device=dev)
        sid = mux.open(block=chunk)
        sess = mux._session(sid)
        peak_sess = peak_mux = 0
        at = 0
        for n in _pieces(T, seed):
            mux.feed(sid, em_np[at:at + n])
            at += n
            peak_sess = max(peak_sess, sess.live_state_bytes())
            peak_mux = max(peak_mux, mux.live_state_bytes())
        spath, _ = mux.finish(sid)
        _expect(report, f"{label} session path",
                np.array_equal(spath, path),
                "the session's path differs from the decoder's")
        for what, got in (("session", peak_sess), ("mux", peak_mux)):
            _expect(report, f"{label} {what} live-state", got <= model,
                    f"the {what}'s peak live state {got:,}B exceeds the "
                    f"planner model {model:,}B")
    return report


# ---------------------------------------------------------------------------
# Aggregate entry point
# ---------------------------------------------------------------------------

def check_contracts(quick: bool = False, device=None,
                    memory_grid: Sequence[tuple[int, int]] | None = None
                    ) -> ContractReport:
    """Run every contract family over every registered spec on `device`
    (None: ``cuda``; a host without a GPU raises unless given ``"cpu"``).

    ``quick`` shrinks the grids to one point each; `memory_grid` overrides
    the memory contract's grid (the smoke adds the serve's (512, 511)).
    """
    device = resolve_device(device)
    # keep the registry honest: every method must be covered by one family
    covered = ({s.method for s in TRACEABLE_SPECS}
               | {s.method for s in STREAMING_SPECS})
    report = ContractReport()
    missing = set(SPEC_BY_METHOD) - covered
    _expect(report, "registry coverage", not missing,
            f"methods {sorted(missing)} registered in SPEC_BY_METHOD but "
            f"not covered by the contract checker")
    shape_grid = SHAPE_GRID[:1] if quick else SHAPE_GRID
    batch_grid = BATCH_GRID[:1] if quick else BATCH_GRID
    if memory_grid is None:
        memory_grid = MEMORY_GRID[:1] if quick else MEMORY_GRID
    check_shape_contracts(grid=shape_grid, batch_grid=batch_grid,
                          device=device, report=report)
    check_memory_contracts(grid=memory_grid, device=device, report=report)
    check_streaming_contracts(device=device, report=report)
    return report
