"""flashprove: the three semantic passes and the waivers, as in
`repro.analysis.prove`.

`run_prove` is the library entry the CLI, the smoke and the tests share: run
the dispatch, kernel and collective passes, gather `FLASHPROVE_WAIVERS`
declarations from the decode stack, and split findings into active and
waived.  Zero active findings is the bar (`report.ok`).

Tiers, as in the JAX package:

  * default: the dispatch pass over the standard grids, the kernel pass at
    the served K ladder, the collective pass over every sharded path;
  * ``quick``: one grid point everywhere;
  * ``deep``: the serving-sized dispatch points and every K up to the
    wrappers' limit; only a deep run holds waivers to being used.
"""

from __future__ import annotations

from .findings import (ProveReport, apply_waivers, collect_waivers,
                       waiver_applies)

__all__ = ["run_prove"]


def run_prove(device=None, quick: bool = False, deep: bool = False,
              ptxas_log: str | None = None) -> ProveReport:
    """Run all flashprove passes on `device` (None: ``cuda``; a host
    without a GPU raises unless given ``"cpu"``); a report with waivers
    applied.  `ptxas_log` is the kernels' ptxas ``-v`` report (the card's
    build); without it the spill check is listed as skipped."""
    from ..core.device import resolve_device
    from .collective_check import check_collectives
    from .dispatch_check import check_dispatch
    from .kernel_check import check_kernels

    dev = resolve_device(device)
    report = ProveReport()
    report.extend(check_dispatch(dev, quick=quick, deep=deep))
    report.extend(check_kernels(ptxas_log, quick=quick, deep=deep))
    report.extend(check_collectives(quick=quick, deep=deep))

    waivers, malformed = collect_waivers()
    # the waivers of these passes on this device (the memory contract's
    # ``PV104:memory:...`` ones belong to `contracts`)
    waivers = {k: r for k, r in waivers.items()
               if k.split(":")[1:2] in ([], ["dispatch"], ["kernel"],
                                        ["collective"])
               and waiver_applies(k, dev.type)}
    # the unused-waiver rule needs the full finding surface; a narrowed run
    # (quick / default) must not flag a waiver of the deep tier's subjects
    active, waived = apply_waivers(report.findings, waivers,
                                   require_used=deep and not quick)
    report.findings = malformed + active
    report.waived.extend(waived)
    return report
