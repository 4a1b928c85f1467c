"""Checkpointing: async, atomic, keep-N, as in `repro.checkpointing.manager`.

Layout per step:  <dir>/step_<N>.tmp/  -> fsync'd -> rename to step_<N>/
    leaves.npz      every leaf, key = its flattened path (``a/b/0``)
    meta.json       step, timestamp, number of leaves

* A state is a nested ``dict`` / ``list`` / ``tuple`` of tensors and numpy
  arrays (0-d included).  `save` copies the leaves to the host and one
  background thread writes them, so the caller never waits on disk I/O
  beyond the device-to-host copy.
* bfloat16 and float16 leaves are saved as float32 (npz holds only builtin
  dtypes; the upcast is lossless) and cast back to the dtype of the leaf in
  `like` on restore.
* The rename is atomic: a crash mid-write never corrupts the latest
  checkpoint, and `latest_step` sees only fully renamed directories.
* `restore` puts each leaf on the device of its counterpart in `like` (or on
  `device`), so a checkpoint written on one device restores onto another.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch


def _host(leaf) -> np.ndarray:
    """A host numpy copy of one leaf; half-precision floats become float32."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype in (torch.bfloat16, torch.float16):
            leaf = leaf.float()
        return leaf.cpu().numpy().copy()
    arr = np.array(leaf)
    return arr.astype(np.float32) if arr.dtype == np.float16 else arr


def _leaves(tree, prefix: str = ""):
    """(path, leaf) of every leaf, depth first, dict keys in their order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, sub in items:
        yield from _leaves(sub, f"{prefix}/{k}" if prefix else str(k))


def _rebuild(like, leaves: dict, prefix: str = ""):
    """`like`'s structure with every leaf replaced from `leaves`."""
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, f"{prefix}/{k}" if prefix else str(k))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        out = [_rebuild(v, leaves, f"{prefix}/{i}" if prefix else str(i))
               for i, v in enumerate(like)]
        return type(like)(out)
    return leaves[prefix]


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # -- save --------------------------------------------------------------
    def save(self, step: int, state, blocking: bool = False):
        """Snapshot `state` at `step`. Returns immediately unless blocking."""
        host = {k: _host(v) for k, v in _leaves(state)}
        self.wait()  # at most one outstanding write

        def write():
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            leaves = os.path.join(tmp, "leaves.npz")
            np.savez(leaves, **host)
            meta = os.path.join(tmp, "meta.json")
            with open(meta, "w") as f:
                json.dump({"step": step, "time": time.time(),
                           "num_leaves": len(host)}, f)
            for path in (leaves, meta, tmp):
                _fsync(path)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            _fsync(self.dir)
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like, device=None):
        """Load `step` into the structure of `like` (shapes validated).

        Each leaf takes the dtype of its counterpart in `like` (a bfloat16
        leaf saved as float32 comes back bfloat16) and, for tensors, its
        device, or `device` when given.  A shape that differs from `like`'s
        raises ValueError.
        """
        self.wait()
        path = os.path.join(self.dir, f"step_{step}", "leaves.npz")
        restored = {}
        with np.load(path) as data:
            for key, leaf in _leaves(like):
                arr = data[key]
                ref_shape = tuple(getattr(leaf, "shape", ()))
                if arr.shape != ref_shape:
                    raise ValueError(f"{key}: checkpoint {arr.shape} != "
                                     f"expected {ref_shape}")
                if isinstance(leaf, torch.Tensor):
                    restored[key] = torch.from_numpy(arr).to(
                        device=leaf.device if device is None else device,
                        dtype=leaf.dtype)
                else:
                    restored[key] = arr.astype(getattr(leaf, "dtype",
                                                       arr.dtype))
        return _rebuild(like, restored)


__all__ = ["CheckpointManager"]
