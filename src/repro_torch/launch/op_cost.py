"""A step's cost on one rank, counted op by op as it runs: the port's
counterpart of `repro.launch.hlo_cost`, which walks XLA's compiled HLO.
The port has no compiled program to walk, so `OpCost` is a
`TorchDispatchMode` that sees every aten op the step dispatches (on fake
tensors in the dry run: shapes without storage, `launch.dryrun`), the
collectives at the `core.mesh.Mesh` methods, and the kernel launches that
the wrappers' fake branch charges (`kernels.work.charge`).  It counts, per
rank:

  * ``flops``: matmul-like ops by `torch.utils.flop_counter`'s formulas,
    elementwise ops (aten's ``pointwise`` tag) at 1 an output element and
    reductions (``reduction``) at 1 an input element: JAX's per-op model
    (`hlo_cost.py:8-10`);
  * ``fused_bytes``: HBM traffic if every elementwise op fused into its
    neighbours, JAX's rule (`hlo_cost.py:11-22`): only data movement is
    charged (products, reductions, sorts, copies, concatenations and pads
    at their inputs and outputs; gathers and slices copied out at twice
    their output; scatters at twice their updates and their indices once;
    collectives at their input and output), casts and views nothing, so
    rows compare with JAX's;
  * ``eager_bytes``: every op's inputs and outputs (views and empty
    allocations nothing): the traffic the eager port really makes, one
    kernel an op;
  * ``collectives``: calls, the input's bytes (what `chip_smoke.py`'s
    phase 17b reads at the same methods) and JAX's ring accounting (an
    all-reduce 2x its size, a gather its output), by kind and by mesh axis
    ("model", "data", "pod+data"; a head group's run "model/4");
  * ``launches``: each kernel entry's launches and their bytes and
    operations (`kernels.work`), which the flops and both byte counts
    take in too;
  * ``peak``: the most bytes live at once, each storage rounded up to the
    card allocator's 512-byte blocks, the tensors given to `track` (the
    rank's state and batch) included; ``args`` is theirs.
    `torch.distributed._tools.mem_tracker.MemTracker` rounds only tensors
    on a CUDA device, and fake CUDA tensors cannot run autograd in a
    CPU-only build (the dry run's fake tensors name the CPU), so the
    storages are tracked here.

A host read of a fake tensor (``.item()``, a Python branch on a tensor)
raises `HostRead`, naming the op and the line of the port that made it: a
sync on the card's path.
"""

from __future__ import annotations

import traceback
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..core.mesh import axes_of
from ..kernels import work

aten = torch.ops.aten

#: the card's caching allocator hands out blocks of multiples of this
ALLOC_ROUND = 512

#: gathers and slices copied out: 2x their output (read, write)
_GATHERS = {aten.index, aten.index_select, aten.gather, aten.embedding,
            aten.narrow_copy, aten.slice_copy, aten.take_along_dim}
#: scatters: 2x their updates and their indices once
_SCATTERS = {aten.index_put, aten.index_put_, aten.index_copy,
             aten.index_copy_, aten.scatter, aten.scatter_,
             aten.scatter_add, aten.scatter_add_, aten.index_add,
             aten.index_add_, aten.embedding_dense_backward,
             aten.slice_scatter, aten.select_scatter, aten.masked_scatter}
#: data movement charged at input and output
_MOVES = {aten.clone, aten.cat, aten.stack, aten.flip, aten.roll,
          aten.constant_pad_nd, aten.repeat, aten.sort, aten.topk,
          aten.cumsum, aten.cumprod, aten.repeat_interleave}
#: copies that are casts where the dtype changes (elementwise: free)
_CASTS = {aten._to_copy, aten.copy_, aten.copy}
#: allocations that neither read nor write
_EMPTY = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
          aten.new_empty_strided}
#: ops that read a device tensor on the host
_HOST_READS = {aten._local_scalar_dense, aten.is_nonzero, aten.equal}


class HostRead(RuntimeError):
    """A host read of a fake tensor: the card's path syncs there."""


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _caller() -> str:
    """The innermost frame of the port outside this module."""
    for f in reversed(traceback.extract_stack()):
        if "repro_torch" in f.filename and not f.filename.endswith(
                "op_cost.py"):
            return f"{f.filename.rsplit('repro_torch', 1)[1]}:{f.lineno}"
    return "?"


def axis_label(axes, run=None) -> str:
    """An axis or a tuple of them as one label ("pod+data"), a run of r
    ranks along it as "model/r"."""
    name = "+".join(axes_of(axes))
    return name if run is None else f"{name}/{run}"


class OpCost(TorchDispatchMode):
    """Counts a block's work on this rank (module docstring); `mesh`'s
    collectives are counted at its methods while the block runs."""

    def __init__(self, mesh=None):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_formulas = flop_registry
        self.mesh = mesh
        self.flops = 0.0
        self.fused_bytes = 0.0
        self.eager_bytes = 0.0
        self.ops = 0
        #: (kind, axis label) -> [calls, input bytes, ring bytes]
        self.collectives: dict = defaultdict(lambda: [0, 0, 0.0])
        #: kernel entry -> [launches, bytes, operations]
        self.launches: dict = defaultdict(lambda: [0, 0.0, 0.0])
        self.args = 0
        self.live = 0
        self.peak = 0
        self._sizes: dict[int, int] = {}
        self._saved: dict = {}
        self._listen = None

    # -- memory ----------------------------------------------------------
    def _hold(self, t: torch.Tensor) -> int:
        """Start counting `t`'s storage if it is not counted yet; its
        rounded bytes (0 if it was)."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._sizes:
            return 0
        n = -(-st.nbytes() // ALLOC_ROUND) * ALLOC_ROUND
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)
        return n

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def track(self, *trees) -> int:
        """Count the storages of the tensors in `trees` (the rank's state
        and batch) as live, and as the step's arguments; their bytes."""
        n = sum(self._hold(t) for t in _tensors(trees))
        self.args += n
        return n

    # -- collectives -----------------------------------------------------
    def _wrap(self, name: str, fn, ring: float):
        mesh = self.mesh

        def call(x, axes, *args, **kwargs):
            run = kwargs.get("run")
            if name == "all_gather" and len(args) > 1:
                run = args[1]
            if name == "all_reduce_sum" and args:
                run = args[0]
            out = fn(x, axes, *args, **kwargs)
            size = _nbytes(x)
            group = run or mesh.axis_size(axes)
            moved = size * (group if name == "all_gather" else ring)
            c = self.collectives[name, axis_label(axes, run)]
            c[0] += 1
            c[1] += size
            c[2] += moved
            traffic = size + _nbytes(out)
            self.fused_bytes += traffic
            self.eager_bytes += traffic
            return out
        return call

    def _launch(self, entry: str, nbytes: float, ops: float) -> None:
        c = self.launches[entry]
        c[0] += 1
        c[1] += nbytes
        c[2] += ops
        self.flops += ops
        self.fused_bytes += nbytes
        self.eager_bytes += nbytes

    def __enter__(self):
        if self.mesh is not None:
            for name, ring in (("all_reduce_sum", 2.0),
                               ("all_reduce_max", 2.0), ("all_gather", 1.0)):
                self._saved[name] = getattr(self.mesh, name)
                setattr(self.mesh, name, self._wrap(name, self._saved[name],
                                                    ring))
        self._listen = work.listening(self._launch)
        self._listen.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._listen.__exit__(*exc)
            for name in self._saved:
                delattr(self.mesh, name)
            self._saved.clear()

    # -- the ops ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        ins = _tensors((args, kwargs))
        if packet in _HOST_READS and any(
                isinstance(t, torch._subclasses.FakeTensor) for t in ins):
            raise HostRead(f"host read of a device tensor ({func}) at "
                           f"{_caller()}")
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            self._hold(t)
        self.ops += 1
        view = getattr(func, "is_view", False)
        in_b = sum(_nbytes(t) for t in ins)
        out_b = sum(_nbytes(t) for t in outs)
        # flops
        if packet in self._flop_formulas:
            self.flops += float(self._flop_formulas[packet](
                *args, **kwargs, out_val=out))
        elif packet in _MOVES or packet in _CASTS or packet in _GATHERS \
                or packet in _SCATTERS:
            pass                 # data movement: no arithmetic
        elif torch.Tag.pointwise in func.tags:
            self.flops += sum(t.numel() for t in outs)
        elif torch.Tag.reduction in func.tags and ins:
            self.flops += ins[0].numel()
        # bytes
        if view or not outs:
            return out
        if packet not in _EMPTY:
            self.eager_bytes += in_b + out_b
        cast = packet in _CASTS and ins and outs and \
            ins[-1].dtype != outs[0].dtype
        if packet in self._flop_formulas:
            self.fused_bytes += in_b + out_b
        elif packet in _GATHERS:
            self.fused_bytes += 2.0 * out_b
        elif packet in _SCATTERS:
            upd = sum(_nbytes(t) for t in ins[1:] if t.is_floating_point())
            idx = sum(_nbytes(t) for t in ins[1:]
                      if not t.is_floating_point())
            self.fused_bytes += 2.0 * upd + idx
        elif (packet in _MOVES or torch.Tag.reduction in func.tags
              or (packet in _CASTS and not cast)):
            self.fused_bytes += in_b + out_b
        return out

    # -- results ---------------------------------------------------------
    def collective_rows(self) -> dict:
        """{"<kind> over <axis>": (calls, input bytes)}, as phase 17b of
        `chip_smoke.py` reads them."""
        return {f"{k} over {a}": (c[0], c[1])
                for (k, a), c in sorted(self.collectives.items())}


__all__ = ["OpCost", "HostRead", "ALLOC_ROUND", "axis_label"]
