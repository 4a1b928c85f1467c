"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by nvcc, for Hopper (``sm_90a``), into
its own shared library with a plain C interface, which is loaded with ctypes.
Libraries go to ``build/repro_torch_kernels/<hash>/`` at the root of the
checkout, where ``<hash>`` covers the flags, every source and the headers
they include (``HEADERS``), so an edit to either builds afresh.  Nothing is built when the package is imported: the
first launch builds (`load`), or a caller builds everything up front
(`build_all`, one nvcc run per source, all started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "viterbi_dp.cu", CSRC / "beam_stream.cu",
           CSRC / "tropical.cu")
#: headers the sources include: hashed with them, never compiled alone
HEADERS = (CSRC / "cluster.cuh", CSRC / "cp_async.cuh")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

# No fast-math: the kernels must reproduce the reference's f32 rounding.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}

_VOID = ctypes.c_void_p
_I32 = ctypes.c_int
_I64 = ctypes.c_int64
# argtypes of each C entry point; pointers and the stream are c_void_p
SIGNATURES = {
    "viterbi_dp": {
        "viterbi_fwd_smem_bytes": (_I32, _I32),
        "viterbi_fwd_batch": (_VOID, _VOID, _I64, _I64, _VOID, _VOID,
                              _I32, _I32, _I32, _I32, _VOID, _VOID, _VOID),
        "viterbi_fwd_batch_masked": (_VOID, _VOID, _VOID, _I64, _I64, _VOID,
                                     _I64, _VOID, _VOID, _I32, _I32, _I32,
                                     _I32, _VOID, _VOID, _VOID),
        "viterbi_banded_fwd": (_VOID, _VOID, _VOID, _I64, _VOID, _VOID, _I32,
                               _I32, _I32, _I32, _VOID, _VOID, _VOID),
        "viterbi_backtrack_plan": (_I32, _I32),
        "viterbi_backtrack_batch": (_VOID, _VOID, _I32, _I32, _I32, _VOID,
                                    _VOID, _VOID),
    },
    "beam_stream": {
        "beam_pass_smem_bytes": (_I32, _I32, _I32, _I32),
        "bs_initial_pass_batch": (_VOID, _VOID, _VOID, _I64, _I64, _VOID,
                                  _I64, _VOID, _I32, _I32, _I32, _I32, _I32,
                                  _I32, _VOID, _VOID, _VOID, _VOID),
        "bs_segment_decode_batch": (_VOID, _VOID, _VOID, _I64, _I64, _VOID,
                                    _I64, _VOID, _VOID, _VOID, _I32, _I32,
                                    _I32, _I32, _I32, _VOID, _VOID),
        "beam_step_batch": (_VOID, _VOID, _I64, _VOID, _VOID, _I32, _I32,
                            _I32, _VOID, _VOID, _VOID, _VOID),
        "bs_chunk_batch": (_VOID, _VOID, _VOID, _I64, _I64, _VOID, _VOID,
                           _VOID, _I32, _I32, _I32, _I32, _I32, _VOID, _VOID,
                           _VOID, _VOID, _VOID),
    },
    "tropical": {
        "tropical_matmul_batch": (_VOID, _VOID, _I32, _I32, _I32, _I32, _I32,
                                  _VOID, _VOID, _VOID),
    },
}


def nvcc() -> str:
    """The nvcc of $CUDA_HOME, else the one on PATH, else /usr/local/cuda's."""
    home = os.environ.get("CUDA_HOME")
    if home:
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def library_path(source: Path) -> Path:
    return build_dir() / f"lib{source.stem}.so"


def nvcc_command(source: Path, out: Path) -> list[str]:
    return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(source)]


def log_path(source: Path) -> Path:
    """Where nvcc's output for `source`'s library is kept."""
    return library_path(source).with_suffix(".log")


def build_logs() -> dict[str, str]:
    """{name: nvcc's output} of every built library (ptxas's report of
    registers, shared memory and spills), whichever call built it."""
    return {src.stem: log_path(src).read_text() for src in SOURCES
            if log_path(src).exists()}


def build_all() -> dict[str, str]:
    """Build every source not yet built; returns {name: nvcc's output} for
    the sources this call built (also kept beside each library, see
    `build_logs`).

    One nvcc process per missing source, all started together, then waited
    for.  The output holds ptxas's report (registers, shared memory,
    spills).  Raises if a build fails.
    """
    build_dir().mkdir(parents=True, exist_ok=True)
    running = {}
    for src in SOURCES:
        lib = library_path(src)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(nvcc_command(src, tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[src] = (proc, tmp, lib)
    logs, failed = {}, []
    for src, (proc, tmp, lib) in running.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{src.name}: nvcc exited {proc.returncode}\n{log}")
            continue
        log_path(src).write_text(log)
        os.replace(tmp, lib)
        logs[src.stem] = log
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``, built if need be."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(CSRC / f"{name}.cu")
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


__all__ = ["SOURCES", "HEADERS", "NVCC_FLAGS", "nvcc_command", "build_all", "load",
           "library_path", "log_path", "build_logs"]
