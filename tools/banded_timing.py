"""Time the port's banded forward kernel on map matching, on one CUDA card.

    python3 tools/banded_timing.py [--src DIR] [--label NAME]

Imports `repro_torch` from DIR (default: this checkout's `src`), builds its
kernels there (printing ptxas's report for the banded kernel), holds
`viterbi_banded_forward` bitwise against its plain version and times it by
CUDA events at `chip_smoke.py`'s map-matching shape, (T, K, Kb) = (512,
1024, 193), per launch and per DP step: each instance where the wrapper
takes an `instance` argument, else its one path.  Pointing --src at an
unpacked older commit times that commit's kernel the same way, so two
versions compare within one call on one card.
"""

from __future__ import annotations

import argparse
import inspect
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import GRID_T, card_line, cuda_ms, grid_problem  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("banded_timing: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import viterbi_dp as vdp
    from repro_torch.kernels.ops import band_windows
    card = card_line()
    banded = False   # inside ptxas's report of a banded instance
    for line in build.build_all().get("viterbi_dp", "").splitlines():
        banded = "banded" in line or (banded and "Compiling" not in line)
        if banded:
            print(f"{args.label} ptxas: {line.strip()}")

    dev = torch.device("cuda")
    log_pi, log_A, em, _, band = grid_problem(dev)
    K = log_A.shape[0]
    c, starts = (x.to(dev) for x in band_windows(band.centers, K, band.width))
    Kb = min(2 * band.width + 1, K)
    want = ref.viterbi_banded_forward_ref(log_A, log_pi, em[0], c, starts,
                                          band.width)
    takes = "instance" in inspect.signature(
        vdp.viterbi_banded_forward).parameters
    for instance in (("global", "prefetch") if takes else (None,)):
        kw = {} if instance is None else {"instance": instance}

        def run():
            return vdp.viterbi_banded_forward(log_A, log_pi, em[0], c, starts,
                                              band.width, **kw)
        got = run()
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            print(f"{args.label} FAIL: banded kernel != plain", flush=True)
            return 1
        ms = cuda_ms(run, reps=20)
        print(f"{args.label} viterbi_banded_fwd (T,K,Kb)=({GRID_T},{K},{Kb})"
              f"{'' if instance is None else ', ' + instance + ' instance'}: "
              f"{ms:.4f} ms, {1e3 * ms / (GRID_T - 1):.4f} us per DP step, "
              f"bitwise == plain; {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
