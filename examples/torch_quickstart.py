"""Quickstart on PyTorch: FLASH Viterbi as a drop-in decoding operator, the
port of `examples/quickstart.py`.

    PYTHONPATH=src python examples/torch_quickstart.py             # on cuda
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Builds a random Erdos-Renyi HMM (the paper's synthetic workload), decodes one
observation sequence with every method in the family via typed specs and
one `ViterbiDecoder` per spec, and shows the paper's adaptivity story: the
same operator tuned for latency (high P), memory (P=1 / narrow beam), or
exactness, including letting the planner pick the spec from a byte budget.
``--states`` and ``--seq`` shrink the problem (default: the paper's 512).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import (BeamStaticSpec, CheckpointSpec, FlashBSSpec,
                              FlashSpec, ResourceBudget, VanillaSpec,
                              ViterbiDecoder, erdos_renyi_hmm, path_score,
                              plan, relative_error, sample_observations,
                              spec_state_bytes)
from repro_torch.core.device import resolve_device

SPECS = (
    VanillaSpec(),
    CheckpointSpec(),
    FlashSpec(parallelism=1),
    FlashSpec(parallelism=7),
    FlashSpec(parallelism=16),
    FlashBSSpec(parallelism=7, beam_width=128),
    FlashBSSpec(parallelism=7, beam_width=32),
    BeamStaticSpec(beam_width=128),
)
BUDGETS_KB = (512, 64, 4)


def make_model(seed: int, K: int, T: int, device):
    """(log_pi, log_A, em) of the paper's workload: an Erdos-Renyi HMM
    (p = 0.253) and the emissions of one sampled sequence."""
    rng = np.random.default_rng(seed)
    hmm = erdos_renyi_hmm(rng, K, num_obs=50, edge_prob=0.253, device=device)
    _, obs = sample_observations(rng, hmm, T)
    return hmm.log_pi, hmm.log_A, hmm.emissions(obs)


def decode(spec, log_pi, log_A, em, device):
    """One decode through a `ViterbiDecoder` -> (path, score)."""
    return ViterbiDecoder(spec, log_pi, log_A, device=device).decode(em)


def spec_name(spec) -> str:
    fields = ", ".join(f"{k[0].upper()}={v}" for k, v in (
        ("parallelism", getattr(spec, "parallelism", None)),
        ("beam_width", getattr(spec, "beam_width", None))) if v is not None)
    return type(spec).__name__ + f"({fields})"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--states", type=int, default=512)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    K, T = args.states, args.seq

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    log_pi, log_A, em = make_model(args.seed, K, T, dev)
    print(f"HMM: K={K} states, T={T} steps, p=0.253 (paper defaults) on "
          f"{dev}\n")
    print(f"{'spec':34s} {'time(ms)':>9s} {'state bytes':>12s} "
          f"{'score':>12s} {'rel.err':>9s}")
    _, opt_score = decode(VanillaSpec(), log_pi, log_A, em, dev)
    results = {}
    for spec in SPECS:
        decode(spec, log_pi, log_A, em, dev)          # warm-up
        sync()
        t0 = time.perf_counter()
        path, score = decode(spec, log_pi, log_A, em, dev)
        sync()
        dt = (time.perf_counter() - t0) * 1e3
        ll = path_score(log_pi, log_A, em, path)
        err = float(relative_error(opt_score, ll))
        mem = spec_state_bytes(spec, K, T)
        name = spec_name(spec)
        results[name] = (path.cpu().numpy(), float(score))
        print(f"{name:34s} {dt:9.2f} {mem:12,d} {float(score):12.2f} "
              f"{err:9.2e}")

    print("\nSame operator, three deployment profiles (the paper's Fig. 1):")
    print("  latency-optimal : FlashSpec(parallelism=16)      "
          "(time/P, memory O(PK))")
    print("  memory-optimal  : FlashBSSpec(P=1, beam_width=32) "
          "(memory O(B), decoupled from K)")
    print("  exact           : FlashSpec(parallelism=7)        "
          "(optimal path, O(PK))")
    print("\nOr let the planner pick from a budget (Sec. V-C-3 ladder):")
    plans = {}
    for kb in BUDGETS_KB:
        p = plan(K, T, ResourceBudget(memory_bytes=kb * 1024))
        plans[kb] = p
        print(f"  {kb:4d} KiB -> {p.why}")
    return {"results": results, "plans": plans}


if __name__ == "__main__":
    main()
