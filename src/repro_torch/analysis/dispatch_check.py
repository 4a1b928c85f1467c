"""flashprove pass 1: every op a decode entry dispatches, the port's
counterpart of `repro.analysis.jaxpr_check`.

The JAX pass walks traced jaxprs.  PyTorch runs eagerly, so this pass runs
each planner-reachable decode entry once on small seeded inputs under a
`TorchDispatchMode` that sees every aten op the entry dispatches, with its
inputs and outputs.  The entries are the JAX pass's: each registered
`DecodeSpec`'s single-sequence decode (`spec.run`, what
`ViterbiDecoder.decode` runs; the streaming specs through their chunk
advance, as in JAX), the batched decode of each batchable spec
(`ViterbiDecoder.decode_batch`'s `viterbi_decode_batch`), the inflight slot
step, and the two constrained entries (the banded decode and the
mask-fused decode), on JAX's grids.  Four things come out of each:

  * **PV101, widening.**  An op whose floating output is wider than its
    widest floating input (f32 -> f64, bf16 -> f32), or a float64 tensor
    made from nothing.  Int64 indices from `argmax` or `topk` are torch's
    idiom, not a finding; the path's int32 belongs to the contracts.
  * **PV102, host syncs.**  ``aten._local_scalar_dense`` (``.item()``,
    ``int()`` of a tensor, a tensor in an ``if``) and, on the card, any op
    that copies from the card to the host.
  * **PV103, oversized outputs.**  An op output above ``max(4 x model,
    1 MiB)``: the signature of an accidental (K, K, T) broadcast.
  * **PV104, peak live bytes.**  The bytes of the tensors the entry makes,
    counted by storage (views add none) and freed through weakref
    finalizers when the last tensor on a storage dies, at their peak,
    against `planner.crosscheck_state_bytes`.

**What the mode does not see.**  A kernel launched through ctypes is
invisible to it: only the tensors its wrapper allocates (`torch.empty` of
its outputs) are.  So on the card this pass checks the wrappers and the host
algebra around the kernels, and on the CPU it checks the plain versions
that stand in for the kernels, plus that same algebra.
"""

from __future__ import annotations

import dataclasses
import traceback
import weakref
from typing import Callable, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..core.device import resolve_device
from .contracts import seeded_hmm
from .findings import Finding, ProveReport

__all__ = [
    "DISPATCH_GRID", "DISPATCH_BATCH_GRID", "DEEP_GRID", "DEEP_BATCH_GRID",
    "INFLIGHT_GRID", "DEEP_INFLIGHT_GRID", "CONSTRAINED_GRID",
    "DEEP_CONSTRAINED_GRID", "PV103_MODEL_FACTOR", "PV103_FLOOR_BYTES",
    "EntryStats", "analyze_entry", "entry_call", "batch_entry_call",
    "peak_live_bytes", "check_dispatch",
]

#: (K, T) grid every spec's single-sequence entry runs over (JAX's
#: JAXPR_GRID).
DISPATCH_GRID: tuple[tuple[int, int], ...] = ((16, 32), (24, 64), (64, 256))
#: (K, T, B) grid for the batched entry of batchable specs.
DISPATCH_BATCH_GRID: tuple[tuple[int, int, int], ...] = ((16, 32, 3),
                                                         (24, 48, 4))
#: --deep adds JAX's serving-sized point.
DEEP_GRID = DISPATCH_GRID + ((128, 384),)
DEEP_BATCH_GRID = DISPATCH_BATCH_GRID + ((128, 256, 4),)
#: (S, block, K) grid for the inflight slot step.
INFLIGHT_GRID: tuple[tuple[int, int, int], ...] = ((4, 8, 16), (8, 16, 24))
DEEP_INFLIGHT_GRID = INFLIGHT_GRID + ((8, 16, 128),)
#: (K, T, width) grid for the constrained entries.
CONSTRAINED_GRID: tuple[tuple[int, int, int], ...] = ((24, 64, 3),
                                                      (64, 256, 8))
DEEP_CONSTRAINED_GRID = CONSTRAINED_GRID + ((128, 384, 8),)

#: An output bigger than model x factor (with an absolute floor so tiny
#: grids don't false-positive on padding) is PV103.
PV103_MODEL_FACTOR = 4.0
PV103_FLOOR_BYTES = 1 << 20

_LOCAL_SCALAR = "aten::_local_scalar_dense"
_HERE = __file__


def _storage_key(t: torch.Tensor):
    st = t.untyped_storage()
    if st.nbytes() == 0:
        return None
    return (t.device.type, t.device.index, st.data_ptr())


def _caller() -> str:
    """The innermost frame of the port outside this pass and torch."""
    for fr in reversed(traceback.extract_stack()):
        f = fr.filename.replace("\\", "/")
        if "/repro_torch/" in f and f != _HERE.replace("\\", "/"):
            tail = f.split("/repro_torch/", 1)[1]
            return f"repro_torch/{tail}:{fr.lineno}"
    return "?"


class _Probe(TorchDispatchMode):
    """Sees every aten op of the guarded block: findings and live bytes."""

    def __init__(self, threshold: int):
        super().__init__()
        self.threshold = threshold
        self.live = 0
        self.peak = 0
        self._sizes: dict = {}          # storage key -> [bytes, tensors]
        self.found: dict[tuple[str, str], int] = {}

    def _release(self, key) -> None:
        entry = self._sizes.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._sizes[key]

    def _flag(self, code: str, detail: str) -> None:
        key = (code, f"{detail} at {_caller()}")
        self.found[key] = self.found.get(key, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [a for a in tree_flatten((args, kwargs))[0]
               if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0]
                if isinstance(o, torch.Tensor)]
        name = func._schema.name
        if name == _LOCAL_SCALAR:
            self._flag("PV102", f"{name} (a host sync)")
        elif (any(o.device.type == "cpu" for o in outs)
              and any(i.device.type == "cuda" for i in ins)):
            self._flag("PV102", f"{name} copies from the card to the host")
        in_float = [i.dtype.itemsize for i in ins if i.dtype.is_floating_point]
        in_keys = {_storage_key(i) for i in ins}
        for o in outs:
            if o.dtype.is_floating_point:
                widest = max(in_float, default=None)
                if (widest is None and o.dtype == torch.float64) or (
                        widest is not None and o.dtype.itemsize > widest):
                    src = ("nothing" if widest is None else
                           "/".join(sorted({str(i.dtype) for i in ins
                                            if i.dtype.is_floating_point})))
                    self._flag("PV101", f"{name} makes {o.dtype} from {src}")
            key = _storage_key(o)
            if key is None:
                continue
            if key in self._sizes:
                self._sizes[key][1] += 1
            elif key in in_keys:
                continue                # a view or in-place write of a
            else:                       # tensor made outside the entry
                nbytes = o.untyped_storage().nbytes()
                self._sizes[key] = [nbytes, 1]
                self.live += nbytes
                if nbytes > self.threshold:
                    self._flag("PV103", f"{name} makes {tuple(o.shape)} "
                                        f"{o.dtype} = {nbytes:,}B (> "
                                        f"threshold {self.threshold:,}B)")
            weakref.finalize(o, self._release, key)
        self.peak = max(self.peak, self.live)
        return out


@dataclasses.dataclass(frozen=True)
class EntryStats:
    """What one run of an entry under the probe measured."""
    peak_live_bytes: int
    model_bytes: int


def analyze_entry(fn: Callable[[], object], subject: str, model_bytes: int
                  ) -> tuple[EntryStats, list[Finding]]:
    """Run `fn()` under the probe; its stats and per-op findings."""
    threshold = int(max(PV103_MODEL_FACTOR * model_bytes, PV103_FLOOR_BYTES))
    probe = _Probe(threshold)
    with torch.no_grad(), probe:
        out = fn()
    del out
    findings = [Finding(code, subject,
                        detail + (f" (x{n})" if n > 1 else ""))
                for (code, detail), n in sorted(probe.found.items())]
    return EntryStats(probe.peak, model_bytes), findings


def peak_live_bytes(fn: Callable[[], object]) -> int:
    """Peak bytes of the tensors `fn()` makes, live at once."""
    return analyze_entry(fn, "peak", 0)[0].peak_live_bytes


# ---------------------------------------------------------------------------
# Entries
# ---------------------------------------------------------------------------

def entry_call(spec, K: int, T: int, device) -> Callable[[], object]:
    """The spec's single-sequence decode at (K, T) as a thunk over inputs
    made beforehand.

    Offline specs run ``spec.run``, what `ViterbiDecoder.decode` runs.  The
    streaming specs are host loops; their entry is the chunk advance the
    loop drives (JAX's surrogates): `kernels.ops.viterbi_chunk_step` for
    `online`, one carried `bs_chunk_batch` for `online_beam`.
    """
    from ..core.spec import OnlineBeamSpec, OnlineSpec

    log_pi, log_A, em = seeded_hmm(K, T, device)
    if isinstance(spec, OnlineSpec):
        from ..kernels.ops import viterbi_chunk_step
        C = min(spec.stream_chunk, T)
        delta = log_pi + em[0]
        return lambda: viterbi_chunk_step(log_A, em[:C].contiguous(), delta)
    if isinstance(spec, OnlineBeamSpec):
        from ..core.flash_bs import pad_state_space
        from ..kernels.beam_stream import bs_chunk_batch
        B = min(spec.beam_width, K)
        kchunk = min(spec.kchunk, K)
        C = min(spec.stream_chunk, T)
        pi_p, A_p, em_p, _ = pad_state_space(log_pi, log_A, em[:C], kchunk)
        scores = torch.zeros((1, B), device=device)
        states = torch.arange(B, dtype=torch.int32, device=device)[None]
        first = torch.zeros((1,), dtype=torch.bool, device=device)
        A_p = A_p.contiguous()
        return lambda: bs_chunk_batch(pi_p, A_p, em_p[None], scores, states,
                                      first, B, kchunk)
    return lambda: spec.run(log_pi, log_A, em)


def batch_entry_call(spec, K: int, T: int, B: int, device
                     ) -> Callable[[], object]:
    """`ViterbiDecoder.decode_batch`'s decode at (K, T, B), ragged."""
    from ..core.batch import viterbi_decode_batch

    log_pi, log_A, em = seeded_hmm(K, T, device, B=B)
    lengths = torch.tensor([max(1, T - 3 * i) for i in range(B)],
                           dtype=torch.int32)
    tun = spec.batch_tunables()
    return lambda: viterbi_decode_batch(em, log_pi, log_A, lengths,
                                        method=spec.batch_method,
                                        constraint=spec.constraint, **tun)


def _inflight_call(S: int, block: int, K: int, device):
    from ..serving.inflight import _inflight_step

    log_pi, log_A, em = seeded_hmm(K, block, device, B=S)
    em0 = em[:, 0].contiguous()
    fresh = torch.tensor([i % 2 == 0 for i in range(S)], device=device)
    delta = torch.zeros((S, K), device=device)
    nfeed = torch.tensor([i % (block + 1) for i in range(S)],
                         dtype=torch.int32)
    return lambda: _inflight_step(log_pi, log_A, em0, fresh, em, delta,
                                  nfeed)


def _banded_call(K: int, T: int, width: int, device):
    from ..kernels.ops import viterbi_decode_banded

    log_pi, log_A, em = seeded_hmm(K, T, device)
    centers = tuple(t % K for t in range(T))     # a band's host schedule
    return lambda: viterbi_decode_banded(log_pi, log_A, em, centers,
                                         width=width)


def _masked_call(K: int, T: int, device):
    """The mask-fused decode under a lexicon's compiled penalties (a
    (K, K) transition penalty and a (T, K) step penalty)."""
    from ..core.constraints import LexiconConstraint, compiled_penalties
    from ..kernels.ops import viterbi_decode_fused_masked

    log_pi, log_A, em = seeded_hmm(K, T, device)
    words = tuple(((2 * w, 2 * w + 1),) for w in range(K // 2))
    t_pen, _, s_pen = compiled_penalties(LexiconConstraint(words=words), K, T)
    t_pen, s_pen = (torch.from_numpy(x).to(device=device, dtype=torch.float32)
                    for x in (t_pen, s_pen))
    return lambda: viterbi_decode_fused_masked(log_pi, log_A, em,
                                               t_pen=t_pen, s_pen=s_pen)


# ---------------------------------------------------------------------------
# The pass
# ---------------------------------------------------------------------------

def _record(report: ProveReport, subject: str, fn, model: int,
            crosscheck: Callable[[int], str | None]) -> None:
    try:
        stats, found = analyze_entry(fn, subject, model)
    except Exception as e:       # running the entry itself must not fail
        report.findings.append(Finding("PV103", subject, f"run error {e!r}"))
        return
    report.findings.extend(found)
    err = crosscheck(stats.peak_live_bytes)
    if err:
        report.findings.append(Finding("PV104", subject, err))
    report.stats[subject] = {"peak_live_bytes": stats.peak_live_bytes,
                             "model_bytes": model,
                             "ratio": round(stats.peak_live_bytes
                                            / max(model, 1), 4)}
    report.checks.append(subject)


def check_dispatch(device=None, quick: bool = False, deep: bool = False,
                   specs: Sequence | None = None,
                   crosscheck: Callable | None = None) -> ProveReport:
    """Run every planner-reachable decode entry under the probe, on
    `device` (None: ``cuda``; a host without a GPU raises unless given
    ``"cpu"``).

    ``quick`` shrinks the grids to one point each; ``deep`` extends them
    with JAX's serving-sized points.  ``crosscheck`` defaults to
    `planner.crosscheck_state_bytes` (PV104).  Subjects read
    ``dispatch:<device>:<entry>[...]``, so a waiver can name the device its
    finding belongs to.
    """
    from ..core.constraints import banded_state_bytes
    from ..core.planner import (crosscheck_state_bytes, inflight_state_bytes,
                                spec_state_bytes)
    from ..core.spec import SPEC_BY_METHOD, FusedSpec

    crosscheck = crosscheck or crosscheck_state_bytes
    dev = resolve_device(device)
    if specs is None:
        specs = tuple(cls() for cls in SPEC_BY_METHOD.values())

    def pick(full, default):
        return full if deep else (default[:1] if quick else default)

    grid = pick(DEEP_GRID, DISPATCH_GRID)
    bgrid = pick(DEEP_BATCH_GRID, DISPATCH_BATCH_GRID)
    pre = f"dispatch:{dev.type}:"
    report = ProveReport()
    for spec in specs:
        for K, T in grid:
            model = spec_state_bytes(spec, K, T)
            _record(report, f"{pre}{spec.method}[K={K},T={T}]",
                    entry_call(spec, K, T, dev), model,
                    lambda b, spec=spec, K=K, T=T: crosscheck(spec, K, T, b))
        if spec.batch_method is None:
            continue
        for K, T, B in bgrid:
            model = spec_state_bytes(spec, K, T) * B
            _record(report, f"{pre}{spec.method}:batch[K={K},T={T},B={B}]",
                    batch_entry_call(spec, K, T, B, dev), model,
                    lambda b, spec=spec, K=K, T=T, B=B:
                    crosscheck(spec, K, T, b, batch=B))

    # the inflight slot step: the pool formula plus JAX's slack must cover
    # its live bytes
    for S, block, K in pick(DEEP_INFLIGHT_GRID, INFLIGHT_GRID):
        model = inflight_state_bytes(K, block, S)
        slack = 8 * block * S + 256

        def pool(b, model=model, slack=slack, S=S, block=block, K=K):
            if b <= model + slack:
                return None
            return (f"planner.inflight_state_bytes(K={K}, block={block}, "
                    f"slots={S}) = {model:,}B does not cover the step's "
                    f"peak live bytes {b:,}B (+{slack:,}B slack)")
        _record(report, f"{pre}inflight[S={S},block={block},K={K}]",
                _inflight_call(S, block, K, dev), model, pool)

    # the constrained entries: the banded decode against banded_state_bytes,
    # the mask-fused decode against the fused model plus its masks
    for K, T, width in pick(DEEP_CONSTRAINED_GRID, CONSTRAINED_GRID):
        slack = 8 * T + 256
        for subject, fn, model in (
                (f"{pre}constrained[K={K},T={T},band={width}]",
                 _banded_call(K, T, width, dev),
                 banded_state_bytes(K, T, width)),
                (f"{pre}constrained:masked[K={K},T={T}]",
                 _masked_call(K, T, dev),
                 spec_state_bytes(FusedSpec(), K, T) + K * K * 4
                 + T * K * 4)):
            def covered(b, model=model, slack=slack):
                if b <= model + slack:
                    return None
                return (f"constrained-path model {model:,}B does not cover "
                        f"the decode's peak live bytes {b:,}B "
                        f"(+{slack:,}B slack)")
            _record(report, subject, fn, model, covered)
    return report
