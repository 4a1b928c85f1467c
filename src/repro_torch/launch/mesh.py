"""Mesh factories and the SPMD launcher, as in `repro.launch.mesh`.

The mesh type itself (`core.mesh.Mesh`, its shape-only `ShapeMesh`) lives in
`core.mesh`; this module makes the test and production meshes and the worlds
of ranks they span.

`run_spmd(fn, world)` spawns `world` ranks, rendezvous through a file under a
fresh temporary directory (never a fixed port), runs ``fn(device, *args)`` in
each and returns rank 0's result.  A rank that raises or exits non-zero, or a
world that outlives its deadline, raises in the caller after every rank is
stopped.  Ranks that share one card use the gloo backend; with one card per
rank ``backend="nccl"`` runs the same code.

Importing this module starts no process and creates no process group.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..core.mesh import COLLECTIVE_TIMEOUT_S, Mesh, ShapeMesh


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    """Single pod 16 x 16 (data, model); multi-pod 2 x 16 x 16 with "pod"
    carrying only data parallelism.  A shape: it owns no processes."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return ShapeMesh(shape, axes)


def make_test_mesh(*, multi_pod: bool = False) -> Mesh:
    """The small analogue over an initialised world of 8 ranks."""
    shape = (2, 2, 2) if multi_pod else (4, 2)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def world_size() -> int:
    """Ranks in the initialised world."""
    return dist.get_world_size()


def world_rank() -> int:
    """This process's rank in the initialised world."""
    return dist.get_rank()


#: the torch.distributed collectives `count_collectives` sees
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "all_gather_object", "broadcast", "reduce", "reduce_scatter",
               "reduce_scatter_tensor", "all_to_all", "all_to_all_single",
               "scatter", "gather", "send", "recv", "isend", "irecv",
               "barrier")


class Calls(list):
    """The names of the collectives a block called, in order; ``groups``
    holds the process group each was given (None: the default group)."""

    def __init__(self):
        super().__init__()
        self.groups = []


@contextlib.contextmanager
def count_collectives():
    """Record, in order, every torch.distributed collective this process
    calls inside the block (the mesh layer's own included); yields the
    list of their names (a `Calls`, with their groups)."""
    calls = Calls()
    saved = {name: getattr(dist, name) for name in COLLECTIVES
             if hasattr(dist, name)}

    def counted(name, fn):
        def call(*args, **kwargs):
            calls.append(name)
            calls.groups.append(kwargs.get("group"))
            return fn(*args, **kwargs)
        return call

    for name, fn in saved.items():
        setattr(dist, name, counted(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def data_axis_size(mesh) -> int:
    size = mesh.shape["data"]
    if "pod" in mesh.shape:
        size *= mesh.shape["pod"]
    return size


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def _rank_main(rank: int, world: int, tmp: str, backend: str,
               device: torch.device, fn, args) -> None:
    """One spawned rank: join the world, run fn, leave its result or its
    traceback in `tmp`, and exit non-zero on failure."""
    try:
        # every rank of the world runs on this host: gloo over loopback,
        # and one intra-op thread a rank, as the ranks share the cores
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        torch.set_num_threads(1)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", rank % torch.cuda.device_count())
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            backend, init_method="file://" + os.path.join(tmp, "rendezvous"),
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        result = fn(device, *args)
        dist.destroy_process_group()
        if rank == 0:
            with open(os.path.join(tmp, "result.pkl"), "wb") as f:
                pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(tmp, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def run_spmd(fn, world: int, *, device=None, backend: str = "gloo",
             args: tuple = (), timeout_s: float = 900.0):
    """Run ``fn(device, *args)`` on `world` spawned ranks; rank 0's result.

    `fn` must be importable (a module-level function) and its result
    picklable.  ``device=None`` means ``cuda``: every rank then runs on card
    ``rank % device_count`` (all on one card on a one-card host), and the
    kernels are built here first so that the ranks only load them.  Raises
    if a rank raises or exits non-zero, or if the world has not ended within
    `timeout_s`; every rank still running is killed first.
    """
    from ..core.device import resolve_device
    from ..kernels import build

    device = resolve_device(device)
    if device.type == "cuda":
        build.build_all()
    tmp = tempfile.mkdtemp(prefix="repro_torch_spmd_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(
        rank, world, tmp, backend, device, fn, args)) for rank in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        # until every rank ended, or one failed (its peers may wait on it)
        while not any(p.exitcode for p in procs) and any(
                p.exitcode is None for p in procs):
            if time.monotonic() > deadline:
                raise TimeoutError(f"run_spmd: world of {world} still "
                                   f"running after {timeout_s} s")
            next(p for p in procs if p.exitcode is None).join(0.05)
        errors = []
        for r, p in enumerate(procs):
            if p.exitcode:
                path = os.path.join(tmp, f"error_{r}.txt")
                text = (open(path).read() if os.path.exists(path)
                        else "(no traceback)\n")
                errors.append(f"rank {r} exited {p.exitcode}:\n{text}")
        if errors:
            raise RuntimeError("run_spmd: " + "".join(errors))
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)


__all__ = ["make_production_mesh", "make_test_mesh", "data_axis_size",
           "world_size", "world_rank", "COLLECTIVES", "Calls",
           "count_collectives", "run_spmd"]
