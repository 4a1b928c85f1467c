"""CLI for the port's analysis gate: ``python -m repro_torch.analysis``.

Runs the two tiers in order, tier 1 flashlint (AST lint, contracts, launch
guard) and tier 2 flashprove (dispatch semantics, kernel resources,
collectives), and exits non-zero if any layer fails.  Like every entry
point of the port it runs on ``cuda`` unless ``--device cpu`` is given, and
raises on a host without a GPU otherwise.  Layer flags run one layer alone;
``--lint-only`` and ``--list-rules`` need no device.

    PYTHONPATH=src python -m repro_torch.analysis --device cpu
    PYTHONPATH=src python -m repro_torch.analysis --lint-only
"""

from __future__ import annotations

import argparse
import pathlib
import sys


def _default_paths() -> list[pathlib.Path]:
    # the `repro_torch` package itself
    return [pathlib.Path(__file__).resolve().parent.parent]


def _run_lint(paths: list[pathlib.Path]) -> int:
    from .lint import lint_paths
    violations, n_files = lint_paths(paths)
    for v in violations:
        print(v)
    status = "clean" if not violations else f"{len(violations)} violation(s)"
    print(f"flashlint: {n_files} file(s) checked, {status}")
    return 1 if violations else 0


def _run_contracts(quick: bool, device) -> int:
    from .contracts import check_contracts
    report = check_contracts(quick=quick, device=device)
    for line in report.failures:
        print(f"CONTRACT FAIL: {line}")
    for line in report.skipped:
        print(f"contract skipped: {line}")
    for line in report.waived:
        print(f"contract waived: {line}")
    memory = sum(1 for s in report.skipped if s.startswith("memory["))
    tail = (f"; memory contract skipped at {memory} point(s): needs the card"
            if memory else "")
    if report.memory_ratios:
        (method, K, T), ratio = max(report.memory_ratios.items(),
                                    key=lambda kv: kv[1])
        tail += (f"; worst allocated/model memory ratio {ratio:.2f}x "
                 f"({method}, K={K}, T={T})")
    print(f"contracts[{device.type}]: {len(report.checks)} check(s) passed, "
          f"{len(report.failures)} failed, {len(report.waived)} waived{tail}")
    return 0 if report.ok else 1


def _run_retrace(device) -> int:
    from .retrace import LaunchError, check_launch_guard
    try:
        passed = check_launch_guard(device)
    except LaunchError as e:
        print(f"LAUNCH FAIL: {e}")
        return 1
    for line in passed:
        print(f"launch guard: {line}")
    what = ("mechanics only, counts set by hand" if device.type != "cuda"
            else "one decode per spec")
    print(f"launch guard[{device.type}]: {len(passed)} scenario(s) passed "
          f"({what})")
    return 0


def _run_prove(quick: bool, deep: bool, device,
               report_path: pathlib.Path | None) -> int:
    from .prove import run_prove
    log = None
    if device.type == "cuda":
        from ..kernels import build
        build.build_all()
        log = "\n".join(build.build_logs().values()) or None
    report = run_prove(device, quick=quick, deep=deep, ptxas_log=log)
    for finding in report.findings:
        print(f"PROVE FAIL: {finding}")
    for finding, reason in report.waived:
        print(f"prove waived: {finding.code} {finding.subject} ({reason})")
    for line in report.skipped:
        print(f"prove skipped: {line}")
    tier = "deep" if deep else ("quick" if quick else "fast")
    print(f"flashprove[{tier}, {device.type}]: {len(report.checks)} entry "
          f"point(s) analysed, {len(report.findings)} active finding(s), "
          f"{len(report.waived)} waived, {len(report.skipped)} skipped")
    if report_path is not None:
        report.dump(report_path)
        print(f"flashprove: findings report written to {report_path}")
    return 0 if report.ok else 1


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's analysis gate: flashlint (AST lint + "
                    "contracts + launch guard) and flashprove (dispatch "
                    "semantics + kernel resources + collectives)")
    ap.add_argument("paths", nargs="*", type=pathlib.Path,
                    help="files/directories to lint (default: the "
                         "repro_torch package)")
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--lint-only", action="store_true",
                      help="run just the AST linter")
    only.add_argument("--contracts-only", action="store_true",
                      help="run just the contract checker")
    only.add_argument("--retrace-only", action="store_true",
                      help="run just the launch guard")
    only.add_argument("--prove-only", action="store_true",
                      help="run just the flashprove passes")
    ap.add_argument("--quick", action="store_true",
                    help="shrink the contract/prove grids to one point each")
    ap.add_argument("--deep", action="store_true",
                    help="the serving-sized dispatch points, every K up to "
                         "the kernels' limit, unused waivers flagged")
    ap.add_argument("--report", type=pathlib.Path, metavar="PATH",
                    help="write the flashprove findings report as JSON")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="where the decodes run (default cuda; raises "
                         "without a GPU)")
    args = ap.parse_args(argv)

    if args.list_rules:
        from .findings import PROVE_RULES
        from .lint import RULES
        for code, summary in sorted({**RULES, **PROVE_RULES}.items()):
            print(f"{code}  {summary}")
        return 0

    run_all = not (args.lint_only or args.contracts_only
                   or args.retrace_only or args.prove_only)
    device = None
    if not args.lint_only:   # raises here, before any layer runs
        from ..core.device import resolve_device
        device = resolve_device(args.device)
    rc = 0
    if run_all or args.lint_only:
        rc |= _run_lint(list(args.paths or _default_paths()))
    if run_all or args.contracts_only:
        rc |= _run_contracts(args.quick, device)
    if run_all or args.retrace_only:
        rc |= _run_retrace(device)
    if run_all or args.prove_only:
        rc |= _run_prove(args.quick, args.deep, device, args.report)
    return rc


if __name__ == "__main__":
    sys.exit(main())
