"""Map matching under a BandConstraint on PyTorch: spatial reachability as a
constraint, the port of `examples/map_matching.py`.

    PYTHONPATH=src python examples/torch_map_matching.py             # on cuda
    PYTHONPATH=src python examples/torch_map_matching.py --device cpu

A vehicle random-walks on a G x G road grid (K = G^2 cells).  Noisy GPS fixes
arrive each step; map matching is Viterbi over the grid HMM with emissions
``-||obs_t - cell_k||^2 / (2 sigma^2)``.  The GPS fix itself bounds where the
vehicle can be, so decoding only ever needs the states within a few cells of
each fix: exactly a `BandConstraint` over per-step centers.

Three execution shapes, each checked bit for bit against the dense oracle
(`viterbi_vanilla` over the `constrain_inputs`-masked inputs):

  1. a single trajectory through `FusedSpec(constraint=band)`: the band
     covers the horizon, so this runs the banded kernel, which never
     materialises K-wide DP rows;
  2. a ragged batch of B sensors observing the same vehicle (one shared
     consensus band) through `ViterbiDecoder.decode_batch`: the masked
     forward kernel;
  3. streaming: `OnlineSpec(constraint=band)` fed in chunks, committing
     matches at convergence points.

Exits non-zero unless all three are oracle-clean.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.core import (BandConstraint, FusedSpec, OnlineSpec,
                              ViterbiDecoder, banded_state_bytes,
                              constrain_inputs, decoder_state_bytes,
                              viterbi_vanilla)
from repro_torch.core.device import resolve_device

G = 16                       # grid side -> K = 256 road cells
K = G * G
T = 64                       # fixes per trajectory
B = 4                        # sensors observing the same vehicle
SIGMA = 0.45                 # GPS noise, in cell units
WIDTH = 3 * G                # band half-width in flattened-index units:
                             # +/- 3 grid rows around each fix
LENGTHS = (T, T - 11, T - 29, 9)
STREAM_CHUNK = 16


def make_model(seed: int, device):
    """(log_pi, log_A, em (B, T, K), truth (T,), band): the road-grid HMM
    (movement cost decays with squared cell distance), a random-walk
    trajectory, B sensors' noisy fixes and the consensus band."""
    rng = np.random.default_rng(seed)
    pos = np.stack(np.meshgrid(np.arange(G), np.arange(G), indexing="ij"),
                   -1).reshape(K, 2).astype(np.float32)
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    log_A = torch.log_softmax(torch.from_numpy(-0.7 * d2), dim=1)
    log_pi = torch.log_softmax(torch.zeros(K), dim=0)
    steps = rng.integers(-1, 2, size=(T, 2))
    truth_xy = np.clip(np.cumsum(np.vstack([[[G // 2, G // 2]], steps[1:]]),
                                 0), 0, G - 1)
    truth = (truth_xy[:, 0] * G + truth_xy[:, 1]).astype(np.int64)
    obs = truth_xy[None] + rng.normal(0, SIGMA, size=(B, T, 2))
    em = -((obs[:, :, None, :] - pos[None, None]) ** 2).sum(-1) / (
        2 * SIGMA ** 2)
    # consensus centers: the cell nearest the sensors' mean fix, shared by
    # every execution shape (a BandConstraint is one schedule, batch-wide)
    cxy = np.clip(np.round(obs.mean(0)), 0, G - 1)
    band = BandConstraint(centers=tuple(int(x * G + y) for x, y in cxy),
                          width=WIDTH)
    em = torch.from_numpy(em.astype(np.float32)).to(device)
    return log_pi.to(device), log_A.to(device), em, truth, band


def oracle(band, log_pi, log_A, em):
    """The dense decode over the masked inputs."""
    return viterbi_vanilla(*constrain_inputs(band, log_pi, log_A, em))


def decode_single(band, log_pi, log_A, em, device):
    """One trajectory through the banded fused decode."""
    return ViterbiDecoder(FusedSpec(constraint=band), log_pi, log_A,
                          device=device).decode(em)


def decode_batch(band, log_pi, log_A, em, lengths, device):
    """B sensors, ragged, in one masked batched decode."""
    return ViterbiDecoder(FusedSpec(constraint=band), log_pi, log_A,
                          device=device).decode_batch(
        em, torch.as_tensor(lengths, dtype=torch.int32))


def decode_stream(band, log_pi, log_A, em, device):
    """One trajectory streamed in chunks -> (path, score, states committed
    before the final flush)."""
    stream = ViterbiDecoder(OnlineSpec(constraint=band), log_pi, log_A,
                            device=device).make_streaming()
    committed = 0
    for t0 in range(0, em.shape[0], STREAM_CHUNK):
        committed += len(stream.feed(em[t0:t0 + STREAM_CHUNK]))
    _, score = stream.flush()
    return stream.path, score, committed


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    log_pi, log_A, em, truth, band = make_model(args.seed, dev)

    # 1. single trajectory: banded fused decode (window Kb = 2*WIDTH + 1)
    path1, score1 = decode_single(band, log_pi, log_A, em[0], dev)
    po, so = oracle(band, log_pi, log_A, em[0])
    bit1 = torch.equal(path1, po) and float(score1) == float(so)
    acc = float(np.mean(path1.cpu().numpy() == truth))
    dense_b = decoder_state_bytes("vanilla", K, T) + band.mask_bytes(K, T)
    print(f"banded fused == dense oracle (bitwise): {bit1}   "
          f"match accuracy vs truth: {acc:.2f}")
    print(f"state bytes: banded {banded_state_bytes(K, T, WIDTH):,} vs "
          f"dense+mask {dense_b:,}\n")

    # 2. ragged batch: all B sensors in one launch, shared consensus band
    paths, scores = decode_batch(band, log_pi, log_A, em, LENGTHS, dev)
    bit2 = True
    for i, L in enumerate(LENGTHS):
        p, s = oracle(band, log_pi, log_A, em[i, :L])
        bit2 &= torch.equal(paths[i, :L], p) and float(scores[i]) == float(s)
    print(f"batched ({B} sensors, ragged lengths={list(LENGTHS)}) == "
          f"per-sensor dense oracle (bitwise): {bit2}\n")

    # 3. streaming: feed fixes in chunks, commit matches at convergence
    path3, score3, committed = decode_stream(band, log_pi, log_A, em[0], dev)
    bit3 = (np.array_equal(path3, po.cpu().numpy())
            and float(score3) == float(so))
    print(f"streaming == dense oracle (bitwise): {bit3}   "
          f"({committed}/{T} matches committed before the final flush)")

    ok = bit1 and bit2 and bit3
    print(f"\nmap matching oracle-clean: {ok} on {dev}")
    if not ok:
        sys.exit(1)
    return {"single": (path1.cpu().numpy(), float(score1)),
            "batch": (paths.cpu().numpy(), scores.cpu().numpy()),
            "stream": (path3, float(score3))}


if __name__ == "__main__":
    main()
