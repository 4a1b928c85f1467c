"""End-to-end training loop, as `repro.launch.train`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --smoke --steps 100 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

Runs on ``cuda`` unless given ``--device cpu``.  `--smoke` selects the
reduced config.  The loop is JAX's: the train step, async checkpoints,
resumable step-indexed data, straggler logging.  `main` returns the
step losses.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from ..checkpointing.manager import CheckpointManager
from ..configs import get_arch
from ..core.device import resolve_device
from ..data.pipeline import SyntheticTokenPipeline, TokenPipelineConfig
from ..models import build_model
from ..optim.adamw import AdamWConfig
from ..runtime.fault import StragglerDetector
from ..train import TrainConfig, init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--horizon", type=int, default=None,
                    help="LR-schedule horizon (default: --steps); set it to"
                         " the FULL run length when pre-empting early so the"
                         " schedule is restart-invariant")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compress-accum", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join("build", "ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; no CPU fallback)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    arch = get_arch(args.arch)
    cfg = arch.SMOKE if args.smoke else arch.CONFIG
    model = build_model(cfg)
    print(f"arch={cfg.name} params={model.param_count():,} device={dev}")

    horizon = args.horizon or args.steps
    tcfg = TrainConfig(
        opt=AdamWConfig(lr=args.lr, total_steps=horizon,
                        warmup_steps=max(horizon // 20, 5)),
        accum_steps=args.accum, compress_accum=args.compress_accum)
    step_fn = make_train_step(model, tcfg)

    pipe = SyntheticTokenPipeline(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed, kind="vlm" if cfg.num_image_tokens else "tokens",
        num_image_tokens=min(cfg.num_image_tokens, args.seq // 2),
        d_model=cfg.d_model))

    ckpt = CheckpointManager(args.ckpt_dir, keep=3)
    state = init_train_state(
        model, torch.Generator(device=dev).manual_seed(args.seed),
        device=dev)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        start = ckpt.latest_step()
        state = ckpt.restore(start, state)
        print(f"resumed from step {start}")

    strag = StragglerDetector(num_workers=1)
    losses = []
    t_start = time.time()
    cur = state
    for step in range(start, args.steps):
        t0 = time.time()
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe.batch(step).items()}
        cur, metrics = step_fn(cur, batch)
        losses.append(float(metrics["loss"]))
        dt = time.time() - t0
        strag.record(0, dt)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss={losses[-1]:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e} {dt*1e3:.0f}ms")
        if (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, cur)
    ckpt.save(args.steps, cur, blocking=True)
    wall = time.time() - t_start
    print(f"done: {args.steps - start} steps in {wall:.1f}s; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
