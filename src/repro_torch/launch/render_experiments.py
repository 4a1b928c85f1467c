"""The dry run's two tables, from its JSONL (`launch.dryrun --json`,
`launch.dryrun_viterbi --json`), as `repro.launch.render_experiments`
renders JAX's: the per-card memory of every cell (the cells that did not
run folded into one row a status and reason), and the roofline of the
single-pod cells.  `fixup` recomputes the useful flops from the configs, so
rows written before a change of the yardstick stay comparable.  The
roofline's constants are data-sheet figures (`launch.roofline`).

    PYTHONPATH=src python -m repro_torch.launch.render_experiments \\
        dryrun.jsonl > tables.md
"""

from __future__ import annotations

import json
import sys

from ..configs import get_arch
from ..configs.base import SHAPES
from ..models import build_model
from .model_flops import useful_flops
from .roofline import PEAK_FLOPS

_MODEL_CACHE: dict = {}


def fixup(row: dict) -> dict:
    """Recompute model_flops / useful / fraction from the current yardstick
    (an LM cell's; a Viterbi row keeps its own)."""
    if row.get("status") != "ok" or row.get("kind") == "viterbi":
        return row
    arch = row["arch"].replace("-", "_").replace(".", "_")
    if arch not in _MODEL_CACHE:
        _MODEL_CACHE[arch] = build_model(get_arch(arch).CONFIG)
    kind, S, B = SHAPES[row["shape"]]
    mf = useful_flops(_MODEL_CACHE[arch], kind, S, B)
    chips = row["chips"]
    row = dict(row)
    row["model_flops"] = mf
    row["useful_ratio"] = (mf / (row["hlo_flops"] * chips)
                           if row["hlo_flops"] else 0)
    step = max(row["compute_s"], row["memory_s"], row["collective_s"])
    row["step_time_s"] = step
    row["roofline_fraction"] = (mf / (chips * PEAK_FLOPS)) / step if step \
        else 0
    terms = {"compute": row["compute_s"], "memory": row["memory_s"],
             "collective": row["collective_s"]}
    row["dominant"] = max(terms, key=terms.get)
    return row


def gib(x) -> str:
    return f"{x / 2**30:.2f}"


def _coll(r) -> str:
    return ", ".join(f"{k.split('_')[-1]}:{v / 2**30:.2f}G"
                     for k, v in sorted(r["coll_detail"].items())) or "—"


def render(path: str):
    """(the dry-run table, the roofline table, the rows) of a JSONL file,
    the last row of each (arch, shape, mesh) kept."""
    rows = [fixup(json.loads(line)) for line in open(path) if line.strip()]
    dedup = {}
    for r in rows:
        dedup[(r["arch"], r["shape"], r["mesh"])] = r
    rows = list(dedup.values())

    out = ["| arch | shape | mesh | kind | trace s | args GiB/dev | "
           "temp GiB/dev | peak GiB/dev | fits 80 GB | collectives |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    # the cells that did not run: one row a status and reason, listing
    # each arch's shapes
    held: dict = {}
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if r["status"] != "ok":
            why = r.get("reason") or r.get("error", "")
            archs, meshes = held.setdefault((r["status"], why), ({}, {}))
            archs.setdefault(r["arch"], {})[r["shape"]] = None
            meshes[r["mesh"]] = None
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['kind']} "
            f"| {r['trace_s']} "
            f"| {gib(r['arg_bytes_per_device'])} "
            f"| {gib(r['temp_bytes_per_device'])} "
            f"| {gib(r['peak_bytes_per_device'])} "
            f"| {'yes' if r['fits'] else 'no'} | {_coll(r)} |")
    for (status, why), (archs, meshes) in sorted(held.items()):
        cells = "; ".join(f"{a} ({', '.join(sh)})" for a, sh in archs.items())
        out.append(f"| {cells} | — | {', '.join(sorted(meshes))} | "
                   f"{status.upper()} | — | — | — | — | — | {why[:60]} |")
    dry = "\n".join(out)

    out = ["| arch | shape | compute s | memory s | eager memory s | coll s "
           "| dominant | useful | roofline frac | note |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    singles = [r for r in rows if r["status"] == "ok" and r["mesh"] == "16x16"]
    for r in sorted(singles, key=lambda r: (r["arch"], r["shape"])):
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3f} "
            f"| {r['memory_s']:.3f} | {r.get('eager_memory_s', 0):.3f} "
            f"| {r['collective_s']:.3f} | **{r['dominant']}** "
            f"| {r['useful_ratio']:.2f} | {r['roofline_fraction']:.3f} "
            f"| {_note(r)} |")
    roof = "\n".join(out)
    return dry, roof, rows


def _note(r) -> str:
    if r.get("kind") == "viterbi":
        if r["dominant"] == "collective":
            return "a DP step's max-combines over \"model\", two a step"
        if r["arch"].startswith("flash-viterbi-2d"):
            return "each DP step reads the rank's log_A rows (tropical kernel)"
        return "exact FLASH's plain loops over (M, K, K) scores (Queue 2 F)"
    if r.get("kind") == "decode" and r["dominant"] == "memory":
        return "a step reads the rank's weights and its cache block once"
    if r["dominant"] == "compute" and r["useful_ratio"] < 0.6:
        return ("compute waste: causal-masked full blocks / remat — skip "
                "masked KV blocks")
    if r["dominant"] == "memory":
        return "activation traffic — fuse/enlarge blocks, check remat policy"
    if r["dominant"] == "collective":
        return ("float32 sums over \"model\" across hosts — bf16 partials / "
                "overlap (Queue 2 S)")
    return ""


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    dry, roof, _ = render(argv[0] if argv else "dryrun.jsonl")
    print("## Dry-run\n")
    print(dry)
    print("\n## Roofline (single pod 16x16)\n")
    print(roof)
    return 0


if __name__ == "__main__":
    sys.exit(main())
