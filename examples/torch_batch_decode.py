"""Batched decoding on PyTorch: one launch for a whole ragged request bucket,
the port of `examples/batch_decode.py`.

    PYTHONPATH=src python examples/torch_batch_decode.py             # on cuda
    PYTHONPATH=src python examples/torch_batch_decode.py --device cpu

Builds a shared HMM, a batch of emission sequences with *different* true
lengths, and decodes them three ways:

  1. `viterbi_decode_batch(method="fused")`: one forward-kernel launch and
     one backtrack-kernel launch for the bucket, pad frames masked as
     tropical-identity steps;
  2. a Python loop of single-sequence `FusedSpec` decodes (the semantics the
     batch must reproduce bit for bit);
  3. through the serving `BatchScheduler`, which buckets, pads, and passes
     `lengths` so results stay exact.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import (FusedSpec, ViterbiDecoder, erdos_renyi_hmm,
                              random_emissions, viterbi_decode_batch)
from repro_torch.core.device import resolve_device
from repro_torch.serving.alignment import make_alignment_head
from repro_torch.serving.scheduler import BatchScheduler

K, TMAX, B = 128, 96, 8


def make_model(seed: int, device):
    """(log_pi, log_A, em (B, TMAX, K), lengths): an Erdos-Renyi HMM
    (p = 0.3), random emissions and ragged lengths, the longest TMAX."""
    g = np.random.default_rng(seed)
    hmm = erdos_renyi_hmm(g, K, edge_prob=0.3, device=device)
    em = random_emissions(g, B * TMAX, K, device=device).reshape(B, TMAX, K)
    rng = np.random.default_rng(seed)
    lengths = np.sort(rng.integers(1, TMAX + 1, B))[::-1].copy()
    lengths[0] = TMAX
    return hmm.log_pi, hmm.log_A, em, lengths


def decode_batch(log_pi, log_A, em, lengths):
    """The whole bucket in one batched decode -> (paths, scores)."""
    return viterbi_decode_batch(em, log_pi, log_A,
                                torch.as_tensor(lengths, dtype=torch.int32),
                                method="fused")


def decode_loop(log_pi, log_A, em, lengths, device):
    """Each sequence alone at its true length -> [(path, score), ...]."""
    dec = ViterbiDecoder(FusedSpec(), log_pi, log_A, device=device)
    return [dec.decode(em[i, :int(L)]) for i, L in enumerate(lengths)]


def serve(log_pi, log_A, em, lengths, device):
    """Through `BatchScheduler` and the alignment head -> (done, stats)."""
    head = make_alignment_head(log_pi, log_A, FusedSpec(), device=device)
    sched = BatchScheduler(head, max_batch=B, buckets=(TMAX,))
    for i, L in enumerate(lengths):
        sched.submit(em[i, :int(L)].cpu().numpy())
    return sched.drain(), sched.stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    log_pi, log_A, em, lengths = make_model(args.seed, dev)
    print(f"batch of {B} sequences, K={K}, ragged lengths="
          f"{lengths.tolist()} on {dev}\n")

    # 1. one batched decode (ragged lengths masked as tropical identities)
    decode_batch(log_pi, log_A, em, lengths)
    sync()
    t0 = time.perf_counter()
    paths, scores = decode_batch(log_pi, log_A, em, lengths)
    sync()
    t_batch = time.perf_counter() - t0

    # 2. the per-sequence loop it must reproduce bit for bit
    decode_loop(log_pi, log_A, em, lengths, dev)
    sync()
    t0 = time.perf_counter()
    looped = decode_loop(log_pi, log_A, em, lengths, dev)
    sync()
    t_loop = time.perf_counter() - t0

    same = all(torch.equal(paths[i, :int(L)], looped[i][0])
               and float(scores[i]) == float(looped[i][1])
               for i, L in enumerate(lengths))
    print(f"batched == looped per sequence: {same}")
    print(f"batched decode: {t_batch * 1e3:.2f} ms   loop of {B}: "
          f"{t_loop * 1e3:.2f} ms (both warmed)\n")

    # 3. the serving path: the scheduler buckets and pads, the decoder masks
    # the pads
    done, stats = serve(log_pi, log_A, em, lengths, dev)
    served = all(
        np.array_equal(r.result[0], paths[i, :int(lengths[i])].cpu().numpy())
        and r.result[1] == float(scores[i]) for i, r in enumerate(done))
    print(f"scheduler results == batched decode: {served}")
    print(f"scheduler stats: {stats['batches']} batch(es), mean pad frac "
          f"{np.mean(stats['padded_frac']):.2f} -- padding costs throughput "
          f"only, never correctness")
    return {"paths": paths.cpu().numpy(), "scores": scores.cpu().numpy(),
            "lengths": lengths, "looped_equal": same, "served_equal": served}


if __name__ == "__main__":
    main()
