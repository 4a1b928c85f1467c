"""The dry run of the paper's operator itself on the production meshes, as
`repro.launch.dryrun_viterbi`:

  * the 2-D sharded FLASH decoder (`core.distributed.make_flash_viterbi_2d`:
    the wavefront's tiles over "data", each DP step's (max, +) product
    sharded over "model" by source rows or target columns, ``--shard``) at
    forced-alignment scale, K = 4096 (above the paper's K = 3965), T = 512;
  * the batched serving decoder (`make_batched_flash_decoder`, sequences
    over "data", JAX's ``method="flash"``) at B = 256, K = 512, T = 512.

As `launch.dryrun`: this process is rank 0 of a fake world of 256 or 512
ranks, the inputs are fake tensors, and `launch.op_cost` counts the decode.
The 2-D decoder's DP steps reach the tropical kernel
(`kernels.tropical.tropical_matmul_batch`), whose fake branch charges each
launch with its work (`kernels.work`).  The port's exact FLASH runs its
batch as plain PyTorch loops (ROADMAP Queue 2 F), so the batched decoder
launches no kernel.  Useful flops are JAX's: 2 K^2 T and 2 K^2 T B.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_viterbi \\
        [--multi-pod] [--shard row|col] [--json out.jsonl]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..core.distributed import make_batched_flash_decoder, make_flash_viterbi_2d
from .dryrun import FAKE_DEVICE, _mesh_name, cost_row, fake_mode
from .mesh import fake_world, make_production_mesh
from .op_cost import OpCost

#: the 2-D FLASH cell's (K, T), and the batched decoder's (B, K, T)
FLASH_2D = (4096, 512)
BATCHED = (256, 512, 512)


def flash_2d_cell(mesh, K: int, T: int, shard: str = "row") -> OpCost:
    """Rank 0's decode of one (T, K) sequence by the 2-D FLASH decoder on
    `mesh` (over a fake world), on fake inputs: its `OpCost`."""
    dev = FAKE_DEVICE
    dec = make_flash_viterbi_2d(mesh, T, K, shard=shard)
    with fake_mode():
        args = (torch.empty((K,), device=dev),
                torch.empty((K, K), device=dev),
                torch.empty((T, K), device=dev))
        cost = OpCost(mesh)
        cost.track(args)
        with cost:
            dec(*args)
    return cost


def batched_cell(mesh, B: int, K: int, T: int) -> OpCost:
    """Rank 0's share of a bucket of B full-length sequences through the
    batched FLASH decoder on `mesh` (over a fake world): its `OpCost`.  The
    lengths stay a real host tensor, which the decoder validates on the
    host."""
    dev = FAKE_DEVICE
    dec = make_batched_flash_decoder(mesh, method="flash")
    lengths = torch.full((B,), T, dtype=torch.int32)
    with fake_mode():
        args = (torch.empty((K,), device=dev),
                torch.empty((K, K), device=dev),
                torch.empty((B, T, K), device=dev))
        cost = OpCost(mesh)
        cost.track(args)
        with cost:
            dec(*args, lengths)
    return cost


def run(multi_pod: bool, json_path: str | None = None,
        shard: str = "row") -> list[dict]:
    """Both cells on one production mesh; their rows."""
    shape_mesh = make_production_mesh(multi_pod=multi_pod)
    mesh = fake_world(shape_mesh.size, multi_pod=multi_pod)
    name = _mesh_name(multi_pod)
    rows = []
    K, T = FLASH_2D
    t0 = time.perf_counter()
    cost = flash_2d_cell(mesh, K, T, shard)
    row = cost_row(cost, mesh, f"flash-viterbi-2d-{shard}", f"K{K}_T{T}",
                   "viterbi", 2.0 * K * K * T, cost.args,
                   time.perf_counter() - t0)
    print(f"OK  flash-viterbi-2d K={K} T={T} {name} trace={row['trace_s']}s "
          f"temp/dev={row['temp_bytes_per_device'] / 2**20:.1f}MiB "
          f"dominant={row['dominant']} launches={row['launches']} "
          f"coll={row['coll_detail']}")
    rows.append(row)
    B2, K2, T2 = BATCHED
    t0 = time.perf_counter()
    cost = batched_cell(mesh, B2, K2, T2)
    row = cost_row(cost, mesh, "flash-viterbi-batched", f"B{B2}_K{K2}_T{T2}",
                   "viterbi", 2.0 * K2 * K2 * T2 * B2, cost.args,
                   time.perf_counter() - t0)
    print(f"OK  flash-viterbi-batched B={B2} K={K2} T={T2} {name} "
          f"trace={row['trace_s']}s "
          f"temp/dev={row['temp_bytes_per_device'] / 2**20:.1f}MiB "
          f"dominant={row['dominant']}")
    rows.append(row)
    if json_path:
        with open(json_path, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--json", default=None)
    ap.add_argument("--shard", default="row", choices=("row", "col"))
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    for mp in ([False, True] if args.both_meshes else [args.multi_pod]):
        run(mp, args.json, args.shard)
    return 0


if __name__ == "__main__":
    sys.exit(main())
