"""The paper's adaptivity story as an executable policy (Fig. 1), on
PyTorch: the port of `examples/adaptive_edge.py`.

Given a device memory budget, `repro_torch.core.planner.plan` picks the
decode spec (the paper's Sec. V-C-3 degradation ladder: exact and parallel,
then shrink P, then the dynamic beam, then the floor) and a `ViterbiDecoder`
runs it: one operator, tuned by two integers, covering the whole time-space
trade-off curve.

    PYTHONPATH=src python examples/torch_adaptive_edge.py --budget-kb 64
    PYTHONPATH=src python examples/torch_adaptive_edge.py --budget-kb 8 \
        --seq 2048 --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import (ResourceBudget, VanillaSpec, ViterbiDecoder,
                              erdos_renyi_hmm, path_score, plan,
                              random_emissions, relative_error,
                              spec_state_bytes)
from repro_torch.core.device import resolve_device


def choose(K: int, T: int, budget_kb: float):
    """The planner's decision for a (K, T) workload under the budget."""
    return plan(K, T, ResourceBudget(memory_bytes=int(budget_kb * 1024)))


def make_model(seed: int, K: int, T: int, device):
    """(log_pi, log_A, em): an Erdos-Renyi HMM and random emissions."""
    g = np.random.default_rng(seed)
    hmm = erdos_renyi_hmm(g, K, device=device)
    return hmm.log_pi, hmm.log_A, random_emissions(g, T, K, device=device)


def decode(spec, log_pi, log_A, em, device):
    """One decode of the chosen spec -> (path, score)."""
    return ViterbiDecoder(spec, log_pi, log_A, device=device).decode(em)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--budget-kb", type=float, default=64)
    ap.add_argument("--states", type=int, default=512)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    K, T = args.states, args.seq
    decode_plan = choose(K, T, args.budget_kb)
    print(f"budget={args.budget_kb:.0f}KiB K={K} T={T} -> {decode_plan.spec}")
    print(f"  why: {decode_plan.why}")

    log_pi, log_A, em = make_model(args.seed, K, T, dev)
    decode(decode_plan.spec, log_pi, log_A, em, dev)          # warm-up
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    path, score = decode(decode_plan.spec, log_pi, log_A, em, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = (time.perf_counter() - t0) * 1e3

    _, opt = decode(VanillaSpec(), log_pi, log_A, em, dev)
    ll = path_score(log_pi, log_A, em, path)
    err = float(relative_error(opt, ll))
    state = spec_state_bytes(decode_plan.spec, K, T)
    print(f"decoded in {dt:.1f}ms on {dev}, state={state:,}B (budget "
          f"{int(args.budget_kb * 1024):,}B), rel.err={err:.2e}")
    return {"plan": decode_plan, "path": path.cpu().numpy(),
            "score": float(score), "rel_err": err}


if __name__ == "__main__":
    main()
