"""Phase 17e of chip_smoke.py at other sequence lengths and dtypes, on one
CUDA card.

    python3 tools/xlstm_sharded_probe.py [--seq 512 1024] [--dtype bf16]
                                         [--parity]

Runs `chip_smoke.shard_main` for xlstm-350m at full width,
`SHARD_XLSTM_UNITS` units, on (data 2, model 2) with 4 ranks sharing the
card, once for each S of --seq, in --dtype (bf16 as the smoke, or
float32: the tensor-parallel step against the float32 single-process step
with no bf16 rounding in either).  With --parity it first runs 17a
(`chip_smoke.shard_parity`, every SMOKE on the two test meshes).  A run
whose first step misses its yardstick prints its FAIL line and the probe
goes on; in float32 the "bf16" reference of `shard_main` is not one
(`cast` to the same dtype shares the weights, so that second reference
steps from updated weights), and its bounds are not read.  Prints each
run's lines as the smoke does, its wall time, and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", type=int, nargs="+",
                    default=[chip_smoke.SHARD_XLSTM_S])
    ap.add_argument("--dtype", choices=("bf16", "float32"), default="bf16")
    ap.add_argument("--parity", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("xlstm_sharded_probe: no CUDA device available",
              file=sys.stderr)
        return 1
    from repro_torch.configs import get_arch

    chip_smoke.card_settings()
    card = chip_smoke.card_line()
    dev = torch.device("cuda")
    if args.parity:
        t = time.perf_counter()
        chip_smoke.shard_parity(dev, card)
        print(f"probe 17a: {time.perf_counter() - t:.1f} s wall")
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    cfg = dataclasses.replace(get_arch("xlstm_350m").CONFIG,
                              num_layers=2 * chip_smoke.SHARD_XLSTM_UNITS,
                              dtype=dtype)
    for S in args.seq:
        t = time.perf_counter()
        try:
            chip_smoke.shard_main(dev, card, cfg, "17e", True, S)
        except SystemExit as e:
            print(f"probe 17e {args.dtype} S {S}: {e}")
        print(f"probe 17e {args.dtype} S {S}: "
              f"{time.perf_counter() - t:.1f} s wall")
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
