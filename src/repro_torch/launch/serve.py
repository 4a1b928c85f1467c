"""Serving driver: batched forced alignment on a left-to-right HMM, as in
`repro.launch.serve`.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 32 --states 512

Builds a left-to-right HMM from ``--seed``, the alignment head on
``--device`` (default ``cuda``) and the batching scheduler; reports latency
and the relative error against the exact decode on a sample.  ``--method``
takes ``fused`` (the default until FLASH-BS is ported) or ``vanilla``.
``--beam``, ``--parallelism`` and ``--budget-kb`` raise until FLASH, FLASH-BS
and the planner are ported.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core import left_to_right_hmm, relative_error, viterbi_vanilla
from ..serving.alignment import AlignmentConfig, make_alignment_head
from ..serving.scheduler import BatchScheduler

BUCKETS = (128, 256, 512)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--states", type=int, default=512)
    ap.add_argument("--classes", type=int, default=64)
    ap.add_argument("--method", default="fused", choices=("fused", "vanilla"))
    ap.add_argument("--beam", type=int, default=None,
                    help="FLASH-BS beam width; not ported yet")
    ap.add_argument("--parallelism", type=int, default=None,
                    help="FLASH parallelism; not ported yet")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--budget-kb", type=float, default=None,
                    help="live decoder-state budget (KiB) for a full batch; "
                         "needs the planner, not ported yet")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    for flag, value in (("--budget-kb", args.budget_kb),
                        ("--beam", args.beam),
                        ("--parallelism", args.parallelism)):
        if value is not None:
            raise NotImplementedError(
                f"{flag} needs FLASH, FLASH-BS or the planner, which are not "
                "ported to repro_torch yet: ROADMAP Queue 1 item 4 "
                "(paper algorithms)")
    hmm = left_to_right_hmm(np.random.default_rng(args.seed), args.states,
                            args.classes, device=args.device)
    spec = AlignmentConfig(method=args.method).to_spec()
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
