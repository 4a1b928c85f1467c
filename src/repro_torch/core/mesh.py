"""Named process meshes over `torch.distributed`: the mesh type that the
sharded decodes, the alignment heads and elastic rescaling work on, as
`jax.sharding.Mesh` is in the JAX package.

A `Mesh` names the axes of a world of processes ("ranks"), laid out
row-major as JAX lays out devices: on the test mesh (data 4, model 2) rank r
sits at data r // 2, model r % 2.  Every rank of the world builds the same
meshes in the same order (each axis's subgroups come from `dist.new_group`,
which every rank must call), holds its own coordinate, and runs an axis's
collectives in that axis's subgroup.  `ShapeMesh` is the shape alone and owns
no processes: the production shapes and rescale targets are described by it.

Ranks that share one card use the gloo backend (NCCL refuses two ranks on one
device); gloo runs `all_reduce` (MAX) and the list form of `all_gather` on
CUDA tensors, moving them through host memory.  On hosts with one card per
rank, ``backend="nccl"`` runs the same code.  The factories and the launcher
that makes the world are in `launch.mesh`.

Importing this module starts no process and creates no process group.
"""

from __future__ import annotations

import datetime
import math

import numpy as np
import torch
import torch.distributed as dist

#: seconds a collective may wait for its peers before it raises
COLLECTIVE_TIMEOUT_S = 60.0


def process_group_ready() -> bool:
    """Whether the default process group is initialised: a `Mesh` is built
    over it, and its collectives need it alive."""
    return dist.is_initialized()


class PartitionSpec(tuple):
    """How a leaf shards, as `jax.sharding.PartitionSpec`: per dimension an
    axis name, None (not sharded) or a tuple of axis names."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)


class ShapeMesh:
    """Axis names and sizes only: ``mesh.shape[axis]`` as JAX callers read
    it.  Owns no processes."""

    def __init__(self, axis_sizes, axis_names):
        sizes, names = tuple(int(s) for s in axis_sizes), tuple(axis_names)
        if len(sizes) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"need one size per distinct axis name, got "
                             f"{sizes} and {names}")
        self.axis_names = names
        self.shape = dict(zip(names, sizes))
        self.size = math.prod(sizes)

    def __repr__(self):
        return f"{type(self).__name__}({self.shape})"


class Mesh(ShapeMesh):
    """A named mesh over ranks of the initialised default process group.

    `ranks` lists the world ranks the mesh spans, row-major (default: the
    whole world).  Every rank of the world constructs it, those outside
    `ranks` too, because each axis's subgroups are made by `dist.new_group`,
    which every rank calls in the same order.  ``coord[axis]`` is this
    rank's index along each axis; it is None on a rank outside the mesh.
    """

    def __init__(self, axis_sizes, axis_names, *, ranks=None):
        super().__init__(axis_sizes, axis_names)
        if not dist.is_initialized():
            raise RuntimeError("a Mesh needs an initialised torch.distributed "
                               "process group (see run_spmd)")
        world = dist.get_world_size()
        self.ranks = tuple(range(world) if ranks is None else ranks)
        if len(self.ranks) != self.size or not set(self.ranks) <= set(
                range(world)):
            raise ValueError(f"mesh {self.shape} needs {self.size} distinct "
                             f"ranks of the world of {world}, got "
                             f"{self.ranks}")
        me = dist.get_rank()
        sizes = tuple(self.shape.values())
        self.coord = None
        if me in self.ranks:
            where = np.unravel_index(self.ranks.index(me), sizes)
            self.coord = dict(zip(self.axis_names, (int(i) for i in where)))
        grid = np.asarray(self.ranks).reshape(sizes)
        timeout = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)
        self._groups = {}
        for i, name in enumerate(self.axis_names):
            for members in np.moveaxis(grid, i, -1).reshape(-1, sizes[i]):
                members = [int(r) for r in members]
                group = dist.new_group(members, timeout=timeout)
                if me in members:
                    self._groups[name] = group

    def group(self, axis: str):
        """This rank's process subgroup along `axis`."""
        if self.coord is None:
            raise ValueError(f"rank {dist.get_rank()} is not in {self}")
        return self._groups[axis]

    def all_reduce_max(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Elementwise maximum of `x` over `axis` (a new tensor)."""
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group(axis))
        return out

    def all_gather(self, x: torch.Tensor, axis: str, dim: int = 0
                   ) -> torch.Tensor:
        """The `x` of every rank along `axis`, concatenated on `dim` in the
        axis's order."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.shape[axis])]
        dist.all_gather(parts, x, group=self.group(axis))
        return torch.cat(parts, dim=dim)


__all__ = ["COLLECTIVE_TIMEOUT_S", "Mesh", "ShapeMesh", "PartitionSpec",
           "process_group_ready"]
