"""Device time of the port's tropical (max, +) kernel on one CUDA card.

    python3 tools/tropical_timing.py [--src DIR] [--label NAME]

Imports `repro_torch` from DIR (default: this checkout's `src`), builds its
tropical kernel there, and times `tropical_matmul_batch` by CUDA-graph
replay (`chip_smoke.graph_ms`: the calls run back to back on the card with
no host work between them) and by back-to-back CUDA events, with the
argmax and, where the wrapper has it, values-only:

  - at (N, I, K, J) = (N, 64, 64, 64), N in {1, 255, 256, 2047}, and at
    (1, 512, 512, 512);
  - over the 22 levels of one `assoc` scan at (T, K) = (4096, 64), one
    graph of the 22 launches (the sum of the levels' device times).

Pointing --src at an unpacked older commit times that commit's kernel the
same way, so two versions compare within one call on one card.  Prints one
line per reading, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import inspect
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import card_line, cuda_ms, graph_ms, scan_levels  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tropical_timing: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels.tropical import tropical_matmul_batch
    card = card_line()
    modes = [True]
    if "with_args" in inspect.signature(tropical_matmul_batch).parameters:
        modes.append(False)

    def call(a, b, with_args):
        if with_args:
            return tropical_matmul_batch(a, b)
        return tropical_matmul_batch(a, b, with_args=False)

    dev = torch.device("cuda")
    g = np.random.default_rng(0)
    for N, K in ((1, 64), (255, 64), (256, 64), (2047, 64), (1, 512)):
        a, b = (torch.from_numpy(g.standard_normal((N, K, K)).astype(
            np.float32)).to(dev) for _ in range(2))
        for with_args in modes:
            dms = graph_ms(lambda: call(a, b, with_args), 20)
            ems = cuda_ms(lambda: call(a, b, with_args), reps=20)
            print(f"{args.label} tropical (N,I,K,J)=({N},{K},{K},{K})"
                  f"{'' if with_args else ' values-only'}: {dms:.4f} ms "
                  f"device time, {ems:.4f} ms by back-to-back events; {card}")
    levels = scan_levels(4095)
    pairs = [tuple(torch.from_numpy(g.standard_normal((n, 64, 64)).astype(
        np.float32)).to(dev) for _ in range(2)) for n in levels]
    for with_args in modes:
        total = graph_ms(lambda: [call(a, b, with_args) for a, b in pairs], 1)
        print(f"{args.label} tropical assoc scan (T,K)=(4096,64), "
              f"{len(levels)} launches, {sum(levels)} products"
              f"{'' if with_args else ', values-only'}: {total:.4f} ms "
              f"device time; {card}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
