"""Serving driver: batched forced alignment on a left-to-right HMM, as in
`repro.launch.serve`.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 32 \
        --states 512 --method flash_bs --beam 128

    # or let the planner pick (method, P, B) from a memory budget:
    PYTHONPATH=src python -m repro_torch.launch.serve --budget-kb 64

Builds a left-to-right HMM from ``--seed``, the alignment head on
``--device`` (default ``cuda``) and the batching scheduler; reports latency
and the relative error against the exact decode on a sample.  The default
is the JAX serve's: FLASH-BS with a beam of 128 and P = 8.  With
``--budget-kb`` the spec comes from `core.planner.plan`: the budget covers
the live DP state of a full ``--max-batch`` bucket at the largest length
bucket.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core import (ResourceBudget, left_to_right_hmm, plan, relative_error,
                    viterbi_vanilla)
from ..serving.alignment import AlignmentConfig, make_alignment_head
from ..serving.scheduler import BatchScheduler

BUCKETS = (128, 256, 512)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--states", type=int, default=512)
    ap.add_argument("--classes", type=int, default=64)
    ap.add_argument("--method", default="flash_bs")
    ap.add_argument("--beam", type=int, default=128)
    ap.add_argument("--parallelism", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--budget-kb", type=float, default=None,
                    help="live decoder-state budget (KiB) for a full batch; "
                         "overrides --method/--beam/--parallelism via the "
                         "planner")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    hmm = left_to_right_hmm(np.random.default_rng(args.seed), args.states,
                            args.classes, device=args.device)
    if args.budget_kb is not None:
        decode_plan = plan(args.states, max(BUCKETS),
                           ResourceBudget(memory_bytes=int(args.budget_kb
                                                           * 1024)),
                           batch=args.max_batch)
        spec = decode_plan.spec
        print(f"planner: budget={args.budget_kb:.0f}KiB "
              f"x batch {args.max_batch} -> {spec}  [{decode_plan.why}]")
    else:
        spec = AlignmentConfig(method=args.method, beam_width=args.beam,
                               parallelism=args.parallelism).to_spec()
    head = make_alignment_head(hmm.log_pi, hmm.log_A, spec,
                               device=args.device)
    sched = BatchScheduler(head, max_batch=args.max_batch, buckets=BUCKETS)

    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        T = int(rng.choice([96, 128, 200, 256, 384, 512]))
        em = rng.standard_normal((T, args.states)).astype(np.float32) * 2.0
        sched.submit(em)

    t0 = time.time()
    done = sched.drain()
    wall = time.time() - t0

    # accuracy vs exact decode on a sample
    errs = []
    for r in done[:8]:
        em = torch.from_numpy(r.payload).to(hmm.log_A.device)
        _, opt = viterbi_vanilla(hmm.log_pi, hmm.log_A, em)
        errs.append(float(relative_error(float(opt), r.result[1])))
    print(f"served {len(done)} requests in {wall:.2f}s "
          f"({len(done)/wall:.1f} req/s), batches={sched.stats['batches']}, "
          f"mean pad frac={np.mean(sched.stats['padded_frac']):.2f}")
    print(f"relative error vs exact (sample of 8): "
          f"mean={np.mean(errs):.2e} max={np.max(errs):.2e}")
    return done


if __name__ == "__main__":
    main()
