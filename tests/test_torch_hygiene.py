"""Import and device hygiene of the PyTorch port.

`repro_torch` and `chip_smoke.py` import neither jax nor the JAX package
`repro`; entry points never fall back to the CPU; the kernels' nvcc command
targets Hopper without fast-math.  No nvcc runs here.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [
    ROOT / "chip_smoke.py",
    ROOT / "examples" / "torch_forced_alignment_serving.py"] + [
    ROOT / "examples" / f"torch_{name}.py"
    for name in ("quickstart", "batch_decode", "adaptive_edge",
                 "streaming_decode", "map_matching")]
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(
        ".__init__") for p in PKG.rglob("*.py"))


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}


def test_ast_scan_tells_repro_from_repro_torch(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.core\nfrom repro_torch import kernels\n")
    assert _imported_roots(f) == {"repro_torch"}
    f.write_text("from repro.core import hmm\n")
    assert _imported_roots(f) == {"repro"}


def test_importing_every_module_pulls_in_no_jax():
    """Importing every module of the port (the mesh, the launcher and the
    load test among them) pulls in no JAX, builds no kernel, starts no
    process group and makes no CUDA context."""
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "from repro_torch.kernels import build\n"
        "assert not build._loaded   # importing builds and loads nothing\n"
        "import torch, torch.distributed as dist\n"
        "assert not dist.is_initialized()   # no process group started\n"
        "assert not torch.cuda.is_initialized()   # no CUDA context made\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert {"repro_torch.kernels.build", "repro_torch.core.mesh",
            "repro_torch.launch.mesh",
            "repro_torch.launch.loadtest", "repro_torch.core.distributed",
            "repro_torch.checkpointing.manager",
            "repro_torch.runtime.fault", "repro_torch.models.convert",
            "repro_torch.models.transformer",
            "repro_torch.configs.hubert_xlarge",
            "repro_torch.configs.paper_hmm"} <= set(MODULES)


def test_decoder_without_device_raises_on_a_cpu_only_host():
    from repro_torch.core import FusedSpec, ViterbiDecoder
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ViterbiDecoder(FusedSpec(), np.zeros(4), np.zeros((4, 4)))
    dec = ViterbiDecoder(FusedSpec(), np.zeros(4), np.zeros((4, 4)),
                         device="cpu")
    assert dec.log_A.device.type == "cpu"


def test_nvcc_command_targets_sm90a_without_fast_math():
    from repro_torch.kernels import build
    assert build.SOURCES
    for src in build.SOURCES:
        cmd = build.nvcc_command(src, Path("/nonexistent/out.so"))
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert not any("fast" in a and "math" in a for a in cmd)
        assert not any("ftz" in a or "use_fast" in a for a in cmd)
        inputs = [a for a in cmd if a.endswith((".cu", ".cuh", ".cpp"))]
        assert inputs == [str(src)]
        assert Path(inputs[0]).resolve().is_relative_to(PKG / "kernels" / "csrc")
    assert build.library_path(build.SOURCES[0]).is_relative_to(
        ROOT / "build" / "repro_torch_kernels")



def test_every_c_entry_has_its_ctypes_signature():
    """A C entry cannot be added to a source without its argtypes."""
    import re
    from repro_torch.kernels import build
    assert set(build.SIGNATURES["viterbi_dp"]) == {
        "viterbi_fwd_smem_bytes", "viterbi_fwd_batch",
        "viterbi_fwd_batch_masked", "viterbi_banded_fwd",
        "viterbi_backtrack_plan", "viterbi_backtrack_batch"}
    assert set(build.SIGNATURES["beam_stream"]) == {
        "beam_pass_smem_bytes", "bs_initial_pass_batch",
        "bs_segment_decode_batch", "beam_step_batch", "bs_chunk_batch"}
    assert set(build.SIGNATURES["tropical"]) == {"tropical_matmul_batch"}
    assert {src.stem for src in build.SOURCES} == set(build.SIGNATURES)
    for src in build.SOURCES:
        entries = re.findall(r'extern "C" int (\w+)\(', src.read_text())
        assert sorted(entries) == sorted(build.SIGNATURES[src.stem]), src.name
        # each entry's parameter count matches its argtypes
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       src.read_text()):
            assert len(params.split(",")) == len(
                build.SIGNATURES[src.stem][name]), name


def test_headers_are_hashed_with_the_sources_but_not_compiled(tmp_path,
                                                             monkeypatch):
    """An edit to a shared header builds every library afresh; nvcc is
    given the sources alone (the header is included, never compiled)."""
    from repro_torch.kernels import build
    assert build.HEADERS
    for hdr in build.HEADERS:
        assert hdr.exists() and hdr.suffix == ".cuh"
        assert hdr not in build.SOURCES
        assert any(f'#include "{hdr.name}"' in src.read_text()
                   for src in build.SOURCES)
    before = build.build_dir()
    edited = tmp_path / build.HEADERS[0].name
    edited.write_text(build.HEADERS[0].read_text() + "\n// edited\n")
    monkeypatch.setattr(build, "HEADERS", (edited,) + build.HEADERS[1:])
    assert build.build_dir() != before


def test_every_include_in_csrc_is_a_listed_header():
    """A source that includes a header the hash does not cover would not
    rebuild when that header changes."""
    import re
    from repro_torch.kernels import build
    local = set()
    for path in build.SOURCES + build.HEADERS:
        local |= set(re.findall(r'#include "([^"]+)"', path.read_text()))
    assert local == {h.name for h in build.HEADERS}


def test_the_analysis_gate_and_the_examples_are_scanned():
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    assert {"src/repro_torch/analysis/lint.py",
            "src/repro_torch/analysis/dispatch_check.py",
            "src/repro_torch/analysis/kernel_check.py",
            "examples/torch_quickstart.py",
            "examples/torch_map_matching.py"} <= names
    assert all(p.exists() for p in SOURCES)


def test_occupancy_cache_is_keyed_on_the_device_and_guarded():
    """The persistent-cluster launcher caches its occupancy query; the
    answer differs between cards, and launches may come from several host
    threads (ctypes releases the GIL): the key names the current device and
    a mutex guards the lookup and the insert."""
    import re
    from repro_torch.kernels import build
    src = (build.CSRC / "cluster.cuh").read_text()
    fit = re.search(r"struct Fit \{(.*?)\};", src, re.S).group(1)
    assert re.search(r"\bint device;", fit)
    assert "cudaGetDevice(&device)" in src
    lookup = src[src.index("for (int i = 0; i < cached; ++i)"):]
    assert "cache[i].device == device" in lookup[:300]
    assert "Fit{device," in src
    assert "#include <mutex>" in src
    assert "static std::mutex" in src
    assert src.count("std::lock_guard<std::mutex>") == 2


def _fake_nvcc(tmp_path, monkeypatch, body: str):
    """Points the build at a stand-in nvcc (a shell script) and a build
    directory under tmp_path."""
    from repro_torch.kernels import build
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    return build


def test_build_all_starts_one_nvcc_per_source_together(tmp_path, monkeypatch):
    """Each nvcc sleeps 1 s: one after another they would take 3 s."""
    import time
    build = _fake_nvcc(tmp_path, monkeypatch, (
        'out=""; prev=""\n'
        'for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done\n'
        'sleep 1; echo "ptxas info: built $out"; touch "$out"\n'))
    t0 = time.monotonic()
    logs = build.build_all()
    took = time.monotonic() - t0
    assert set(logs) == {src.stem for src in build.SOURCES}
    assert all("ptxas info" in log for log in logs.values())
    assert all(build.library_path(src).exists() for src in build.SOURCES)
    assert took < 0.9 * len(build.SOURCES)
    assert build.build_all() == {}          # built: nothing to do


def test_build_logs_are_kept_beside_the_libraries(tmp_path, monkeypatch):
    """The analysis gate reads ptxas's report whichever call built the
    libraries."""
    build = _fake_nvcc(tmp_path, monkeypatch, (
        'out=""; prev=""\n'
        'for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done\n'
        'echo "ptxas info: Used 7 registers"; touch "$out"\n'))
    assert build.build_logs() == {}
    logs = build.build_all()
    assert build.build_logs() == logs
    assert build.build_all() == {} and build.build_logs() == logs


def test_build_all_raises_when_nvcc_fails(tmp_path, monkeypatch):
    build = _fake_nvcc(tmp_path, monkeypatch, 'echo "error: nope"; exit 2\n')
    with pytest.raises(RuntimeError, match="kernel build failed"):
        build.build_all()
