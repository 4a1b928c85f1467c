"""Streaming decode on PyTorch: states become final while the sequence is
still arriving, the port of `examples/streaming_decode.py`.

    PYTHONPATH=src python examples/torch_streaming_decode.py             # cuda
    PYTHONPATH=src python examples/torch_streaming_decode.py --device cpu

Simulates a live feed (emission chunks arriving over time) against a
`StreamSession`, printing each committed prefix as it becomes final, then
verifies the assembled path is bit-identical to the offline decode.  The
second half shows the serving shape: a `StreamMux` carrying two concurrent
sessions with different latency/memory profiles (exact vs narrow beam).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (erdos_renyi_hmm, sample_observations,
                              viterbi_vanilla)
from repro_torch.core.device import resolve_device
from repro_torch.serving import StreamConfig, StreamMux, StreamSession

K, T, CHUNK = 64, 512, 32
BEAM = StreamConfig(method="online_beam", beam_width=16, kchunk=64)


def make_model(seed: int, device):
    """(log_pi, log_A, em (T, K) numpy): an Erdos-Renyi HMM (p = 0.253) and
    the emissions of one sampled sequence."""
    rng = np.random.default_rng(seed)
    hmm = erdos_renyi_hmm(rng, K, num_obs=50, edge_prob=0.253, device=device)
    _, obs = sample_observations(rng, hmm, T)
    return hmm.log_pi, hmm.log_A, hmm.emissions(obs).cpu().numpy()


def stream_exact(log_pi, log_A, em, device, report=print):
    """Feed `em` chunk by chunk through one exact session -> (path, score,
    the session)."""
    sess = StreamSession(log_pi, log_A, StreamConfig(), block=CHUNK,
                         device=device)
    for start in range(0, em.shape[0], CHUNK):
        committed = sess.feed(em[start:start + CHUNK])
        n = sess.decoder.n_committed
        bar = "#" * (40 * n // em.shape[0])
        report(f"  t={start + CHUNK:4d}  +{committed.shape[0]:3d} states "
               f"final (lag {sess.lag:3d}, live {sess.live_state_bytes():6d} "
               f"B)  |{bar}")
    path, score = sess.finish()
    return path, score, sess


def mux_two(log_pi, log_A, em, device):
    """An exact session beside a beam-16 session of a `StreamMux` ->
    ((exact path, score), (beam path, score))."""
    mux = StreamMux(log_pi, log_A, BEAM, blocks=(CHUNK,), device=device)
    exact = StreamSession(log_pi, log_A, StreamConfig(), block=CHUNK,
                          device=device)
    sid = mux.open(block=CHUNK)
    for start in range(0, em.shape[0], CHUNK):
        exact.feed(em[start:start + CHUNK])
        mux.feed(sid, em[start:start + CHUNK])
    return exact.finish(), mux.finish(sid)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    log_pi, log_A, em = make_model(args.seed, dev)
    print(f"live feed: K={K}, T={T}, {CHUNK}-frame chunks on {dev}\n")
    path, score, sess = stream_exact(log_pi, log_A, em, dev)
    ref_path, _ = viterbi_vanilla(log_pi, log_A, torch.from_numpy(em).to(dev))
    same = np.array_equal(path, ref_path.cpu().numpy())
    if not same:
        raise SystemExit("FAIL: the streamed path differs from the offline "
                         "decode")
    first = (f"first commit after {sess.first_commit_s * 1e3:.1f} ms"
             if sess.first_commit_s is not None
             else "no commit before finish()")
    print(f"\nassembled path == offline decode (score {score:.2f}); "
          f"{first}\n")

    print("two concurrent sessions, one mux (exact vs B=16 beam):")
    (p1, s1), (p2, s2) = mux_two(log_pi, log_A, em, dev)
    agree = float(np.mean(p1 == p2))
    print(f"  exact   : score {s1:9.2f}, live state O(W*K)")
    print(f"  beam 16 : score {s2:9.2f}, live state O(W*B) -- "
          f"{100 * agree:.1f}% of states agree with exact")
    return {"path": path, "score": score, "exact": (p1, s1),
            "beam": (p2, s2)}


if __name__ == "__main__":
    main()
