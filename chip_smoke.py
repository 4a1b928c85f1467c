"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the checkout's `src/repro_torch`; imports
nothing of JAX or of the JAX package.  Phases, each fatal on failure:

  0. build every kernel from `src/repro_torch/kernels/csrc` with nvcc for
     sm_90a and print ptxas's register / spill report;
  1. hold each kernel against its plain PyTorch version on the card, bitwise
     (`torch.equal`) at the serve shapes (B, T, K) = (8, 511, 512) on a
     left-to-right HMM with ragged lengths including 1 and 0 and on an
     Erdos-Renyi HMM (p = 0.253), and at K in {100, 200, 384, 1024, 1500};
  2. serve the default 32 requests at K = 512 through
     `repro_torch.launch.serve.main`, with the launch counters set to 0 just
     before and read just after: each kernel must have launched once per
     batch, and every served path and score must equal the exact
     `viterbi_vanilla` decode (relative error exactly 0) and, on a sample,
     the numpy oracle `viterbi_numpy`;
  3. time each kernel and its plain version with CUDA events at the serve
     shapes (B = 8, T in {128, 256, 512}, K = 512).

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Exits non-zero, printing no
result, when no CUDA device is available.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet) used for each kernel's bound.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

SERVE_T = (128, 256, 512)
SERVE_B, SERVE_K = 8, 512


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean time of one call of `fn` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else
                                        "operations")


def fwd_bound(B: int, T: int, K: int, real_steps: int):
    """em and psi once each, log_A, delta0, delta_T and pad once; an add and
    a compare per score of each real step."""
    nbytes = 4 * (2 * B * T * K + K * K + 2 * B * K + B * T)
    return bound_ms(nbytes, 2.0 * real_steps * K * K)


def backtrack_bound(B: int, T: int, K: int):
    """delta_T once, the B*T psi entries the walk reads, paths and scores
    once; one compare per delta_T entry."""
    nbytes = 4 * (B * K + B * T + B * (T + 1) + B)
    return bound_ms(nbytes, float(B * K))


def pad_of(lengths, T: int, dev) -> torch.Tensor:
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    return (torch.arange(T, device=dev)[None, :]
            >= lengths[:, None]).to(torch.float32)


def check_forward(vdp, ref, log_A, em, delta0, pad, what: str):
    """Kernel vs plain version, bitwise; returns (max |delta_T difference|,
    the kernel's psi and delta_T)."""
    psi, dT = vdp.viterbi_forward_batch(log_A, em, delta0, pad)
    if pad is None:
        psi_r, dT_r = ref.viterbi_forward_ref(log_A, em, delta0)
    else:
        psi_r, dT_r = ref.viterbi_forward_masked_ref(log_A, em, delta0,
                                                     pad > 0.5)
    torch.cuda.synchronize()
    if not (torch.equal(psi, psi_r) and torch.equal(dT, dT_r)):
        bad = int((psi != psi_r).sum())
        raise SystemExit(f"FAIL forward {what}: {bad} psi entries differ, "
                         f"max |delta_T diff| "
                         f"{float((dT - dT_r).abs().max())}")
    print(f"forward kernel == plain (bitwise) at {what}")
    return float((dT - dT_r).abs().max()), psi, dT


def check_backtrack(vdp, ref, psi, dT, what: str) -> float:
    paths, scores = vdp.viterbi_backtrack_batch(psi, dT)
    paths_r, scores_r = ref.viterbi_backtrack_ref(psi, dT)
    torch.cuda.synchronize()
    if not (torch.equal(paths, paths_r) and torch.equal(scores, scores_r)):
        raise SystemExit(f"FAIL backtrack {what}: paths or scores differ")
    print(f"backtrack kernel == plain (bitwise) at {what}")
    return float((scores - scores_r).abs().max())


def phase_kernels(dev) -> dict[str, float]:
    from repro_torch.core import erdos_renyi_hmm, left_to_right_hmm
    from repro_torch.kernels import ref
    from repro_torch.kernels import viterbi_dp as vdp

    err = {"viterbi_fwd_batch": 0.0, "viterbi_backtrack_batch": 0.0}
    g = np.random.default_rng(1)
    B, T, K = SERVE_B, 511, SERVE_K
    cases = [
        ("left-to-right", left_to_right_hmm(g, K, 64, device=dev),
         [511, 300, 1, 0, 128, 511, 77, 255]),
        ("erdos-renyi p=0.253", erdos_renyi_hmm(g, K, 50, 0.253, device=dev),
         None),
    ]
    inputs = []
    for name, hmm, steps in cases:
        em_full = torch.from_numpy(
            (2.0 * g.standard_normal((B, T + 1, K))).astype(np.float32)).to(dev)
        delta0 = hmm.log_pi[None, :] + em_full[:, 0, :]
        em = em_full[:, 1:]                 # strided, as the decode passes it
        pad = None if steps is None else pad_of(steps, T, dev)
        inputs.append((f"{name} (B,T,K)=({B},{T},{K}) lengths={steps}",
                       hmm.log_A, em, delta0, pad))
    for K in (100, 200, 384, 1024, 1500):
        B, T = 3, 37
        log_A, em, delta0 = (torch.from_numpy(
            g.standard_normal(shape).astype(np.float32)).to(dev)
            for shape in ((K, K), (B, T, K), (B, K)))
        inputs.append((f"(B,T,K)=({B},{T},{K}) lengths=[{T}, 1, 0]",
                       log_A, 2.0 * em, delta0, pad_of([T, 1, 0], T, dev)))
    for what, log_A, em, delta0, pad in inputs:
        e, psi, dT = check_forward(vdp, ref, log_A, em, delta0, pad, what)
        err["viterbi_fwd_batch"] = max(err["viterbi_fwd_batch"], e)
        e = check_backtrack(vdp, ref, psi, dT, what)
        err["viterbi_backtrack_batch"] = max(err["viterbi_backtrack_batch"], e)
    return err


def expected_batches(requests) -> list[tuple[int, int]]:
    """(bucket, requests) of each batch the scheduler forms for these
    payloads, replayed without decoding."""
    from repro_torch.launch.serve import BUCKETS
    from repro_torch.serving.scheduler import BatchScheduler

    formed = []

    def record(padded, lens):
        formed.append((padded.shape[1], padded.shape[0]))
        return (np.zeros(padded.shape[:2], np.int32),
                np.zeros(len(lens), np.float32))

    sched = BatchScheduler(record, max_batch=8, buckets=BUCKETS)
    for r in sorted(requests, key=lambda r: r.rid):
        sched.submit(r.payload)
    sched.drain()
    return formed


def phase_serve(dev) -> dict[str, int]:
    from repro_torch.core import (left_to_right_hmm, relative_error,
                                  viterbi_vanilla)
    from repro_torch.core.reference import viterbi_numpy
    from repro_torch.kernels import viterbi_dp as vdp
    from repro_torch.launch import serve

    vdp.reset_launches()
    done = serve.main(["--method", "fused", "--device", "cuda"])
    torch.cuda.synchronize()
    launches = dict(vdp.launches)

    formed = expected_batches(done)
    batches = len(formed)
    print(f"serve: {len(done)} requests, {batches} batches "
          f"(bucket x requests: "
          f"{', '.join(f'{b} x {n}' for b, n in formed)}), "
          f"launches {launches}")
    if len(done) != 32:
        raise SystemExit(f"FAIL serve: {len(done)} of 32 requests served")
    for name, n in launches.items():
        if n != batches:
            raise SystemExit(f"FAIL serve: {name} launched {n} times for "
                             f"{batches} batches")

    # the same model serve.main built from its default seed and sizes
    hmm = left_to_right_hmm(np.random.default_rng(0), 512, 64, device=dev)
    worst = 0.0
    for r in done:
        path, score = r.result
        em = torch.from_numpy(r.payload).to(dev)
        p_ref, s_ref = viterbi_vanilla(hmm.log_pi, hmm.log_A, em)
        worst = max(worst, float(relative_error(float(s_ref), score)))
        if not np.array_equal(path, p_ref.cpu().numpy()):
            raise SystemExit(f"FAIL serve: request {r.rid} path != vanilla")
    if worst != 0.0:
        raise SystemExit(f"FAIL serve: relative error vs vanilla {worst}")
    log_pi, log_A = hmm.log_pi.cpu().numpy(), hmm.log_A.cpu().numpy()
    for r in done[:3]:
        p_np, s_np = viterbi_numpy(log_pi, log_A, r.payload)
        if not (np.array_equal(r.result[0], p_np) and r.result[1] == s_np):
            raise SystemExit(f"FAIL serve: request {r.rid} != viterbi_numpy")
    print("serve: all 32 paths == viterbi_vanilla, relative error 0; "
          "3 sampled == viterbi_numpy")
    return launches


def phase_timing(dev, card: str) -> dict[str, dict]:
    from repro_torch.core import left_to_right_hmm
    from repro_torch.kernels import ref
    from repro_torch.kernels import viterbi_dp as vdp

    g = np.random.default_rng(2)
    B, K = SERVE_B, SERVE_K
    hmm = left_to_right_hmm(g, K, 64, device=dev)
    rows = {}
    for T_req in SERVE_T:
        T = T_req - 1                                  # forward steps
        em_full = torch.from_numpy(
            (2.0 * g.standard_normal((B, T_req, K))).astype(np.float32)).to(dev)
        delta0 = hmm.log_pi[None, :] + em_full[:, 0, :]
        em = em_full[:, 1:]
        pad = pad_of([T] * B, T, dev)
        mask = pad > 0.5
        psi, dT = vdp.viterbi_forward_batch(hmm.log_A, em, delta0, pad)
        times = {
            "viterbi_fwd_batch": (
                cuda_ms(lambda: vdp.viterbi_forward_batch(
                    hmm.log_A, em, delta0, pad), reps=10),
                cuda_ms(lambda: ref.viterbi_forward_masked_ref(
                    hmm.log_A, em, delta0, mask), reps=3),
                fwd_bound(B, T, K, B * T)),
            "viterbi_backtrack_batch": (
                cuda_ms(lambda: vdp.viterbi_backtrack_batch(psi, dT), reps=20),
                cuda_ms(lambda: ref.viterbi_backtrack_ref(psi, dT), reps=3),
                backtrack_bound(B, T, K)),
        }
        for name, (ms, plain, (bms, by)) in times.items():
            print(f"timing {name} (B,T,K)=({B},{T},{K}): kernel {ms:.4f} ms, "
                  f"plain {plain:.4f} ms, bound {bms:.6f} ms ({by}); {card}")
            rows[name] = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by)
    return rows       # the last, largest serve shape (T = 511 steps)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    for name, log in build.build_all().items():
        print(f"built {name} ({build.library_path(build.CSRC / (name + '.cu'))})")
        for line in log.splitlines():
            if "ptxas" in line or "spill" in line:
                print(f"  {line.strip()}")

    errs = phase_kernels(dev)
    launches = phase_serve(dev)
    timing = phase_timing(dev, card)

    source = "src/repro_torch/kernels/csrc/viterbi_dp.cu"
    replaces = {"viterbi_fwd_batch": "src/repro/kernels/viterbi_dp.py:45",
                "viterbi_backtrack_batch": "src/repro/kernels/ops.py:213"}
    kernels = [dict(name=name, route="cuda", source=source,
                    replaces=replaces[name], launches=launches[name],
                    max_abs_err=errs[name], **timing[name], library_ms=None)
               for name in ("viterbi_fwd_batch", "viterbi_backtrack_batch")]
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
