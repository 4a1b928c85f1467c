"""flashprove findings: the result type and the waiver registry, as in
`repro.analysis.findings`.

The semantic passes (`dispatch_check`, `kernel_check`, `collective_check`)
analyse *executed decodes and built kernels*, so an intentional exception
cannot be a source comment the way flashlint's
``# flashlint: disable=FL002(reason)`` is: the finding has no source line.
Instead the module that owns the computation declares a module-level

    FLASHPROVE_WAIVERS = {
        "PV104:dispatch:*:vanilla": "psi rows are argmax's int64 ...",
    }

mapping ``CODE`` or ``CODE:subject-prefix`` to a mandatory human reason.  A
``*`` in the prefix stands for any run of characters: the dispatch pass
names the device in its subjects (``dispatch:cpu:...``,
``dispatch:cuda:...``), and ``PV104:dispatch:*:vanilla`` waives a finding
on both, where ``PV103:dispatch:cpu:assoc`` names the one device whose
plain version makes it.  A waiver with an empty reason, an unknown code, or
that matches nothing in a full run on the device it applies to is itself a
finding (PV000), as flashlint's FL005 makes a disable that does not say
*why* a finding of its own.

Finding code catalogue (`PROVE_RULES`):

  PV000  malformed or unused flashprove waiver
  PV101  an op whose floating output is wider than its widest floating
         input inside a decode entry (f32 -> f64, bf16 -> f32)
  PV102  a host sync inside a decode entry (``aten._local_scalar_dense``;
         on the card also a copy from the card to the host)
  PV103  an op output above the per-spec bytes threshold
  PV104  the planner's cost model below the entry's measured peak live bytes
  PV201  ptxas spill stores or spill loads in a kernel
  PV202  shared memory per block over the card's opt-in limit at a K the
         planner serves
  PV301  a collective in the body of the data-parallel sharded decode
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from typing import Iterable, Sequence

__all__ = ["PROVE_RULES", "Finding", "ProveReport", "collect_waivers",
           "apply_waivers", "waiver_applies", "WAIVER_MODULES"]

PROVE_RULES: dict[str, str] = {
    "PV000": "malformed or unused flashprove waiver",
    "PV101": "floating output wider than its widest floating input in a "
             "decode entry",
    "PV102": "host sync inside a decode entry",
    "PV103": "op output above the bytes threshold",
    "PV104": "planner cost model below the entry's measured peak live bytes",
    "PV201": "ptxas spill stores or spill loads in a kernel",
    "PV202": "shared memory per block over SMEM_BYTES at a served K",
    "PV301": "collective in the data-parallel sharded decode's body",
}

#: Modules scanned for `FLASHPROVE_WAIVERS` declarations: the port's
#: counterparts of the JAX package's eleven, and two owners of
#: computations whose findings the JAX package's passes do not make.
WAIVER_MODULES: tuple[str, ...] = (
    # the owners of computations whose findings fire in the port alone
    "repro_torch.core.checkpoint_viterbi",
    "repro_torch.core.beam_static",
    # the JAX package's eleven
    "repro_torch.kernels.viterbi_dp",
    "repro_torch.kernels.ops",
    "repro_torch.kernels.beam_stream",
    "repro_torch.kernels.tropical",
    "repro_torch.core.vanilla",
    "repro_torch.core.flash",
    "repro_torch.core.flash_bs",
    "repro_torch.core.assoc",
    "repro_torch.core.batch",
    "repro_torch.core.online",
    "repro_torch.core.planner",
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One flashprove finding: a rule code plus the subject it fired on.

    subject is a stable, hierarchical label ("pass:entry:detail", e.g.
    ``dispatch:cpu:flash[K=64,T=256]``) so waivers can prefix-match it.
    """
    code: str
    subject: str
    detail: str

    def __str__(self) -> str:
        return f"{self.code} {self.subject}: {self.detail}"

    def to_json(self) -> dict:
        return {"code": self.code, "rule": PROVE_RULES.get(self.code, "?"),
                "subject": self.subject, "detail": self.detail}


@dataclasses.dataclass
class ProveReport:
    """Aggregated result of a flashprove run (what `--report` serialises)."""
    findings: list[Finding] = dataclasses.field(default_factory=list)
    waived: list[tuple[Finding, str]] = dataclasses.field(default_factory=list)
    checks: list[str] = dataclasses.field(default_factory=list)
    skipped: list[str] = dataclasses.field(default_factory=list)
    #: per-entry stats: subject -> {"peak_live_bytes": ..., "model_bytes":
    #: ...} (dispatch pass) or {"smem_bytes": ..., "registers": ...}
    #: (kernel pass).
    stats: dict[str, dict] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.findings

    def extend(self, other: "ProveReport") -> None:
        self.findings.extend(other.findings)
        self.waived.extend(other.waived)
        self.checks.extend(other.checks)
        self.skipped.extend(other.skipped)
        self.stats.update(other.stats)

    def to_json(self) -> dict:
        return {
            "ok": self.ok,
            "findings": [f.to_json() for f in self.findings],
            "waived": [{**f.to_json(), "reason": r} for f, r in self.waived],
            "checks": len(self.checks),
            "skipped": self.skipped,
            "stats": self.stats,
        }

    def dump(self, path) -> None:
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(self.to_json(), fh, indent=2, sort_keys=True)
            fh.write("\n")


def collect_waivers(modules: Sequence[str] = WAIVER_MODULES
                    ) -> tuple[dict[str, str], list[Finding]]:
    """Gather `FLASHPROVE_WAIVERS` declarations from the decode stack.

    Returns (waivers, malformed): waivers maps "CODE[:subject-prefix]" to its
    reason; malformed holds PV000 findings for empty reasons / unknown codes.
    """
    waivers: dict[str, str] = {}
    malformed: list[Finding] = []
    for name in modules:
        try:
            mod = importlib.import_module(name)
        except ImportError as e:
            malformed.append(Finding("PV000", f"waivers:{name}",
                                     f"module failed to import: {e!r}"))
            continue
        declared = getattr(mod, "FLASHPROVE_WAIVERS", None)
        if declared is None:
            continue
        if not isinstance(declared, dict):
            malformed.append(Finding(
                "PV000", f"waivers:{name}",
                "FLASHPROVE_WAIVERS must be a dict of "
                "'CODE[:subject-prefix]' -> reason"))
            continue
        for key, reason in declared.items():
            code = str(key).split(":", 1)[0]
            if code not in PROVE_RULES or code == "PV000":
                malformed.append(Finding(
                    "PV000", f"waivers:{name}",
                    f"unknown rule {code!r} in waiver {key!r}"))
                continue
            if not str(reason).strip():
                malformed.append(Finding(
                    "PV000", f"waivers:{name}",
                    f"waiver {key!r} has an empty reason; say why"))
                continue
            waivers[str(key)] = str(reason)
    return waivers, malformed


def _waiver_matches(waiver_key: str, finding: Finding) -> bool:
    code, _, prefix = waiver_key.partition(":")
    if code != finding.code:
        return False
    pieces = prefix.split("*")
    if not finding.subject.startswith(pieces[0]):
        return False
    at = len(pieces[0])
    for piece in pieces[1:]:
        i = finding.subject.find(piece, at)
        if i < 0:
            return False
        at = i + len(piece)
    return True


_DEVICES = ("cpu", "cuda")


def waiver_applies(waiver_key: str, device_type: str) -> bool:
    """False for a waiver whose prefix names another device than the run's
    (``CODE:pass:<device>:...``); such a waiver cannot be used by the run,
    so it is not held to the unused-waiver rule there."""
    parts = waiver_key.split(":")
    return not (len(parts) > 2 and parts[2] in _DEVICES
                and parts[2] != device_type)


def apply_waivers(findings: Iterable[Finding], waivers: dict[str, str],
                  *, require_used: bool = True
                  ) -> tuple[list[Finding], list[tuple[Finding, str]]]:
    """Split findings into (active, waived) per the waiver registry.

    A declared waiver that matched nothing becomes a PV000 active finding
    when ``require_used`` (only meaningful when `findings` came from a full
    run): stale waivers rot into blanket suppressions otherwise.
    """
    active: list[Finding] = []
    waived: list[tuple[Finding, str]] = []
    used: set[str] = set()
    for f in findings:
        hit = next((k for k in waivers if _waiver_matches(k, f)), None)
        if hit is None:
            active.append(f)
        else:
            used.add(hit)
            waived.append((f, waivers[hit]))
    if require_used:
        for key in sorted(set(waivers) - used):
            active.append(Finding(
                "PV000", f"waivers:{key}",
                "waiver matched no finding in this run; remove it or fix "
                "the subject prefix"))
    return active, waived
