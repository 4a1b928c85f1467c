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

A collective runs over one axis or a tuple of axes (the sharded train step
reduces over ("pod", "data")): a tuple's ranks are ordered row-major over
its axes, as `checkpointing.elastic` cuts a dimension sharded over them.
The subgroups of a tuple are made at its first use, which every rank of the
world must reach in the same order (as it reaches the collectives).

Ranks that share one card use the gloo backend (NCCL refuses two ranks on one
device); gloo runs `all_reduce` (MAX, SUM) and the list form of `all_gather`
on CUDA tensors, moving them through host memory, and the mesh uses no other
collective: Megatron's pair of differentiable sums (`Mesh.reduce_from`,
`Mesh.copy_to`) runs `all_reduce_sum` in forward or in backward.  On hosts
with one card per rank, ``backend="nccl"`` runs the same code.  The
factories and the launcher that makes the world are in `launch.mesh`.

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
#: elements a sum-reduction moves in one collective (gloo stages each piece
#: of a CUDA tensor in host memory)
REDUCE_PIECE = 1 << 26


def axes_of(axes) -> tuple[str, ...]:
    """An axis name or a tuple of them, as a tuple."""
    return (axes,) if isinstance(axes, str) else tuple(axes)


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
    it.  Owns no processes.  `coord` is None; set it to a position
    ({axis: index}) to cut that position's blocks without a world
    (`checkpointing.elastic`, `sharding.placement`)."""

    coord = None

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

    def axis_size(self, axes) -> int:
        """Positions along `axes` (an axis name or a tuple of them)."""
        return math.prod(self.shape[a] for a in axes_of(axes))

    def index(self, axes) -> int:
        """This position's index along `axes`, row-major over a tuple."""
        axes = axes_of(axes)
        return int(np.ravel_multi_index([self.coord[a] for a in axes],
                                        [self.shape[a] for a in axes]))


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
        self._grid = np.asarray(self.ranks).reshape(sizes)
        #: axes -> (this rank's subgroup, its members row-major over axes)
        self._groups = {}
        self._made = set()
        for name in self.axis_names:
            self._make_groups((name,))

    def _make_groups(self, axes: tuple[str, ...]) -> None:
        """Every subgroup along `axes` (each rank calls `dist.new_group`
        for each of them, in the same order)."""
        unknown = set(axes) - set(self.axis_names)
        if unknown or len(set(axes)) != len(axes):
            raise ValueError(f"axes {axes} are not distinct axes of {self}")
        pos = [self.axis_names.index(a) for a in axes]
        n = math.prod(self.shape[a] for a in axes)
        timeout = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)
        me = dist.get_rank()
        rows = np.moveaxis(self._grid, pos, list(range(-len(axes), 0)))
        for members in rows.reshape(-1, n):
            members = [int(r) for r in members]
            group = dist.new_group(members, timeout=timeout)
            if me in members:
                self._groups[axes] = (group, members)
        self._made.add(axes)

    def _group(self, axes):
        axes = axes_of(axes)
        if axes not in self._made:
            self._make_groups(axes)
        if self.coord is None:
            raise ValueError(f"rank {dist.get_rank()} is not in {self}")
        return self._groups[axes]

    def group(self, axes):
        """This rank's process subgroup along `axes` (an axis name or a
        tuple of them)."""
        return self._group(axes)[0]

    def all_reduce_max(self, x: torch.Tensor, axis) -> torch.Tensor:
        """Elementwise maximum of `x` over `axis` (a new tensor)."""
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group(axis))
        return out

    def all_reduce_sum(self, x: torch.Tensor, axes) -> torch.Tensor:
        """`x` (contiguous) summed elementwise over `axes`, in place, in
        pieces of `REDUCE_PIECE` elements; returns `x`."""
        if not x.is_contiguous():
            raise ValueError("all_reduce_sum needs a contiguous tensor")
        group = self.group(axes)
        flat = x.view(-1)
        for i in range(0, flat.numel(), REDUCE_PIECE):
            dist.all_reduce(flat[i:i + REDUCE_PIECE], op=dist.ReduceOp.SUM,
                            group=group)
        return x

    def reduce_from(self, x: torch.Tensor, axes, dtype=None
                    ) -> torch.Tensor:
        """`x` summed over `axes`, differentiably: forward a sum, backward
        the identity (Megatron's sum after a row-parallel product).  The
        sum runs in float32 and is rounded once to `dtype` (default `x`'s:
        a float32 partial product is summed and rounded to its operands'
        dtype)."""
        return _ReduceFrom.apply(x, self, axes, dtype or x.dtype)

    def copy_to(self, x: torch.Tensor, axes) -> torch.Tensor:
        """`x` itself in forward; in backward its gradient summed over
        `axes` (the conjugate of `reduce_from`, before a column-parallel
        product), in float32 and rounded once to the gradient's dtype."""
        return _CopyTo.apply(x, self, axes)

    def all_gather(self, x: torch.Tensor, axes, dim: int = 0
                   ) -> torch.Tensor:
        """The `x` of every rank along `axes`, concatenated on `dim` in
        the axes' order (row-major over a tuple)."""
        group, members = self._group(axes)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in members]
        dist.all_gather(parts, x, group=group)
        # the group's ranks are in ascending order, the axes' in `members`
        by_rank = dict(zip(sorted(members), parts))
        return torch.cat([by_rank[r] for r in members], dim=dim)


def _summed(mesh: Mesh, x: torch.Tensor, axes, dtype) -> torch.Tensor:
    """A new tensor: `x` summed over `axes` in float32, in `dtype`."""
    out = x.float().contiguous()
    if out is x:
        out = x.clone(memory_format=torch.contiguous_format)
    return mesh.all_reduce_sum(out, axes).to(dtype)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dtype):
        ctx.dtype = x.dtype
        return _summed(mesh, x, axes, dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _summed(ctx.mesh, grad, ctx.axes, grad.dtype), None, None


__all__ = ["COLLECTIVE_TIMEOUT_S", "REDUCE_PIECE", "Mesh", "ShapeMesh",
           "PartitionSpec", "axes_of", "process_group_ready"]
