"""End-to-end training example on PyTorch, the port of
`examples/train_lm.py`: an LM trained for a few hundred steps.

    PYTHONPATH=src python examples/torch_train_lm.py --device cpu  # reduced
    PYTHONPATH=src python examples/torch_train_lm.py --m100        # ~100M

Drives `repro_torch.launch.train.main`, the production loop: the train
step, async checkpoints (under ``build/``), resume, the loss going down.
The default mode is tinyllama's reduced SMOKE config; ``--m100`` is the
xlstm-350m config (the same code path, hours on a CPU).  Runs on ``cuda``
unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--m100", action="store_true", help="full ~100M-param run")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; no CPU fallback)")
    args = ap.parse_args(argv)
    dev = [] if args.device is None else ["--device", args.device]
    if args.m100:
        steps = args.steps or 300
        return train_main(["--arch", "xlstm_350m", "--steps", str(steps),
                           "--batch", "8", "--seq", "256", "--lr", "3e-4",
                           "--ckpt-dir", os.path.join("build", "lm100"),
                           "--ckpt-every", "50"] + dev)
    steps = args.steps or 120
    return train_main(["--arch", "tinyllama-1.1b", "--smoke", "--steps",
                       str(steps), "--batch", "8", "--seq", "128", "--lr",
                       "5e-3", "--ckpt-dir",
                       os.path.join("build", "lm_smoke"), "--ckpt-every",
                       "40"] + dev)


if __name__ == "__main__":
    main()
