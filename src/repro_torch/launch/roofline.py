"""Roofline of a dry-run cell on NVIDIA H100 cards, as `repro.launch.roofline`
is on TPU v5e chips.  Per (arch x shape x mesh), per card:

    compute term    = flops / PEAK_FLOPS
    memory term     = fused bytes / HBM_BW   (JAX's fusion model)
    collective term = sum over collectives of their ring bytes / the
                      slowest link on their group's ring

The counts come from `launch.op_cost` (rank 0's step, op by op); they are
per card, as JAX's are per device of its SPMD module.  ``eager_memory_s``
charges every op's inputs and outputs instead (`op_cost.eager_bytes`): the
traffic the eager port makes, one kernel an op.

**These constants are data-sheet peaks and a link assumption, not
measurements.**  PEAK_FLOPS, HBM_BW and HBM_BYTES are NVIDIA's figures for
the H100 SXM at 700 W (dense bf16).  The links assume a DGX H100-like
layout: ranks row-major, 8 cards to a host joined by NVLink at 450 GB/s
each way, and one 400 Gb/s NIC a card (50 GB/s each way) between hosts.  A
collective whose group stays inside one host runs at NVLink's rate;
"model" = 16 spans two hosts, so it runs at the NIC's, as "data" does.

MODEL_FLOPS (useful work) is `launch.model_flops.useful_flops`: 6ND / 2ND
of the active parameters plus the attention products.
"""

from __future__ import annotations

import dataclasses

import numpy as np

PEAK_FLOPS = 989e12          # dense bf16 a card (H100 SXM data sheet)
HBM_BW = 3.35e12             # B/s a card (data sheet)
HBM_BYTES = 80e9             # a card's memory (data sheet)
NVLINK_BW = 450e9            # B/s each way, inside a host (assumption)
NIC_BW = 50e9                # B/s each way, between hosts (assumption)
CARDS_PER_HOST = 8


def group_ranks(shape: dict, label: str) -> list[int]:
    """Rank 0's group of a collective over `label` ("model", "pod+data",
    a run "model/4") on a mesh of axis sizes `shape` ({axis: size}, in
    order), ranks row-major."""
    axes, _, run = label.partition("/")
    names = list(shape)
    grid = np.arange(int(np.prod(list(shape.values())))).reshape(
        list(shape.values()))
    idx = tuple(slice(None) if a in axes.split("+") else 0 for a in names)
    members = grid[idx].reshape(-1).tolist()
    return members[:int(run)] if run else members


def link_bw(shape: dict, label: str) -> float:
    """The slowest link on the ring of rank 0's group over `label`."""
    hosts = {r // CARDS_PER_HOST for r in group_ranks(shape, label)}
    return NVLINK_BW if len(hosts) == 1 else NIC_BW


@dataclasses.dataclass
class Roofline:
    """Every hlo_* field is per card (rank 0's step), as JAX's are per
    device; the names are JAX's, so `render_experiments` reads both."""
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float              # op_cost.flops
    hlo_bytes: float              # op_cost.fused_bytes
    coll_bytes: dict              # kind -> ring bytes
    model_flops: float            # GLOBAL useful flops (6ND / 2ND)
    bytes_per_device: float       # peak bytes a card
    eager_bytes: float = 0.0      # op_cost.eager_bytes
    coll_seconds: dict = dataclasses.field(default_factory=dict)

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def eager_memory_s(self) -> float:
        return self.eager_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return sum(self.coll_seconds.values())

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """(useful FLOP time a card) / (roofline step time)."""
        useful_s = self.model_flops / (self.chips * PEAK_FLOPS)
        return useful_s / self.step_time_s if self.step_time_s else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "coll_bytes": sum(self.coll_bytes.values()),
            "coll_detail": dict(self.coll_bytes),
            "model_flops": self.model_flops,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "bytes_per_device": self.bytes_per_device,
            "eager_bytes": self.eager_bytes,
            "eager_memory_s": self.eager_memory_s,
            "coll_seconds": dict(self.coll_seconds),
        }


def analyze(cost, *, mesh_shape: dict, arch: str, shape: str,
            mesh_name: str, model_flops: float) -> Roofline:
    """The roofline of one rank's `op_cost.OpCost` on a mesh of axis sizes
    `mesh_shape`."""
    coll, secs = {}, {}
    for (kind, label), (_, _, ring) in cost.collectives.items():
        coll[kind] = coll.get(kind, 0.0) + ring
        key = f"{kind} over {label}"
        secs[key] = secs.get(key, 0.0) + ring / link_bw(mesh_shape, label)
    return Roofline(arch=arch, shape=shape, mesh=mesh_name,
                    chips=int(np.prod(list(mesh_shape.values()))),
                    hlo_flops=cost.flops, hlo_bytes=cost.fused_bytes,
                    coll_bytes=coll, model_flops=model_flops,
                    bytes_per_device=float(cost.peak),
                    eager_bytes=cost.eager_bytes, coll_seconds=secs)


__all__ = ["Roofline", "analyze", "group_ranks", "link_bw", "PEAK_FLOPS",
           "HBM_BW", "HBM_BYTES", "NVLINK_BW", "NIC_BW", "CARDS_PER_HOST"]
