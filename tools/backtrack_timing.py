"""Device time of the port's backtrack kernel on one CUDA card.

    python3 tools/backtrack_timing.py [--src DIR] [--label NAME]

Imports `repro_torch` from DIR (default: this checkout's `src`), builds its
kernels there, and times `viterbi_backtrack_batch` by CUDA-graph replay
(`chip_smoke.graph_ms`: 20 launches back to back on the card on one psi,
which stays in L2 where it fits, as on the decode path, where the forward
launch has just written it) and by back-to-back CUDA events:

  - at the serve shapes (B, T, K) = (8, T, 512), T in {127, 255, 511}, on
    the psi of the forward kernel over the serve's left-to-right model, and
    at (8, 511, 512) also on random-state psi;
  - at (40, 511, 512) (psi 42 MB: mostly out of L2), (1, 511, 193) (map
    matching's window) and (1, 4095, 64) (assoc's table), on random-state
    psi.

Each launch's paths and scores are first held against the plain version,
bitwise.  Pointing --src at an unpacked older commit times that commit's
kernel the same way, so two versions compare within one call on one card.
Prints one line per reading, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (card_line, cuda_ms, graph_ms,  # noqa: E402
                        pad_of, random_psi)

RANDOM_SHAPES = ((8, 511, 512), (40, 511, 512), (1, 511, 193), (1, 4095, 64))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("backtrack_timing: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core import left_to_right_hmm
    from repro_torch.kernels import ref
    from repro_torch.kernels import viterbi_dp as vdp
    card = card_line()
    dev = torch.device("cuda")
    g = np.random.default_rng(0)

    cases = []
    hmm = left_to_right_hmm(g, 512, 64, device=dev)
    for T in (127, 255, 511):
        em_full = torch.from_numpy((2.0 * g.standard_normal(
            (8, T + 1, 512))).astype(np.float32)).to(dev)
        delta0 = hmm.log_pi[None, :] + em_full[:, 0, :]
        psi, dT = vdp.viterbi_forward_batch(hmm.log_A, em_full[:, 1:], delta0,
                                            pad_of([T] * 8, T, dev))
        cases.append(("forward psi, serve model", psi, dT))
    for shape in RANDOM_SHAPES:
        cases.append(("random-state psi", *random_psi(g, dev, *shape)))

    for what, psi, dT in cases:
        B, T, K = psi.shape
        paths, scores = vdp.viterbi_backtrack_batch(psi, dT)
        paths_r, scores_r = ref.viterbi_backtrack_ref(psi, dT)
        if not (torch.equal(paths, paths_r) and torch.equal(scores, scores_r)):
            raise SystemExit(f"FAIL {args.label} backtrack (B,T,K)=({B},{T},"
                             f"{K}) {what}: != the plain version")
        dms = graph_ms(lambda: vdp.viterbi_backtrack_batch(psi, dT), 20)
        ems = cuda_ms(lambda: vdp.viterbi_backtrack_batch(psi, dT), reps=20)
        print(f"{args.label} backtrack (B,T,K)=({B},{T},{K}) {what}: "
              f"{dms:.4f} ms device time, {ems:.4f} ms by back-to-back "
              f"events; {card}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
