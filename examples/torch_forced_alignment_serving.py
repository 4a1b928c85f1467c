"""End-to-end serving example on PyTorch (the paper's kind of workload):
batched forced-alignment requests against a hubert-style encoder and a
FLASH-BS head, the port of `examples/forced_alignment_serving.py`.

    PYTHONPATH=src python examples/torch_forced_alignment_serving.py \
        --device cpu                    # hubert SMOKE on the CPU
    PYTHONPATH=src python examples/torch_forced_alignment_serving.py \
        --full                          # hubert-xlarge, 48 layers, on cuda

Twelve requests of 40-63 frames go through `BatchScheduler` (batches of 4,
one bucket of 64 frames) with their true lengths, so each request decodes
as if it had been served alone.  Its emissions do not: the encoder attends
over the bucket's pad frames, as in the JAX example.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core import left_to_right_hmm, viterbi_decode_batch
from repro_torch.core.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serving.scheduler import BatchScheduler

STATES = 64


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="hubert-xlarge's CONFIG instead of SMOKE")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. encoder (reduced hubert by default; --full takes the whole model)
    arch = get_arch("hubert_xlarge")
    cfg = arch.CONFIG if args.full else arch.SMOKE
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = build_model(cfg).init(gen, device=dev)
    num_classes = cfg.vocab

    # 2. alignment HMM over the transcription states (left-to-right)
    hmm = left_to_right_hmm(np.random.default_rng(args.seed + 1), STATES,
                            num_classes, device=dev)
    # states index classes mod C
    state_to_class = torch.arange(STATES, device=dev) % num_classes

    # 3. one serve step: encoder -> emissions -> FLASH-BS alignment.
    # `lengths` masks the bucket's pad frames as tropical-identity steps.
    @torch.inference_mode()
    def serve(frames, lengths):               # (B, T, d), (B,)
        x = torch.as_tensor(frames, device=dev)
        logits, _ = model.prefill({"embeds": x})
        em = torch.log_softmax(logits, dim=-1)[..., state_to_class]
        return viterbi_decode_batch(em, hmm.log_pi, hmm.log_A, lengths,
                                    method="flash_bs", beam_width=32,
                                    parallelism=4, lanes=None)

    sched = BatchScheduler(serve, max_batch=4, buckets=(64,))
    rng = np.random.default_rng(args.seed)
    for _ in range(12):
        T = int(rng.integers(40, 64))
        sched.submit(rng.standard_normal((T, cfg.d_model)).astype(np.float32))

    t0 = time.perf_counter()
    done = sched.drain()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"{cfg.name} on {dev}: served {len(done)} alignment requests in "
          f"{wall:.2f}s ({len(done) / wall:.1f} req/s) in "
          f"{sched.stats['batches']} batches")
    for r in done[:3]:
        path, score = r.result
        print(f"  req {r.rid}: frames={len(r.payload)} "
              f"alignment[0:12]={path[:12].tolist()} score={score:.1f}")
    print("alignment paths are monotone:",
          all(np.all(np.diff(r.result[0]) >= 0) for r in done))
    return done


if __name__ == "__main__":
    main()
