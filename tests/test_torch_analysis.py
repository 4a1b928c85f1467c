"""The port's flashlint tier (`repro_torch.analysis`): each lint rule in
torch's idiom made to fire and kept quiet, the disable grammar, the tree's
cleanliness, the CLI's exit codes, the contracts and the launch guard on
the CPU, and the JAX package's disables carried over to their counterparts.

The counterparts of `tests/test_analysis.py`.  No GPU: the memory contract
is listed as needing the card, and the launch guard's mechanics run on
counts set by hand.
"""

from __future__ import annotations

import io
import os
import pathlib
import subprocess
import sys
import textwrap
import tokenize

import pytest
import torch

from repro_torch import kernels
from repro_torch.analysis import lint_paths, lint_source
from repro_torch.analysis.contracts import (MEMORY_TOLERANCE,
                                            check_contracts,
                                            check_memory_contracts,
                                            check_shape_contracts,
                                            check_streaming_contracts)
from repro_torch.analysis import contracts as contracts_mod
from repro_torch.analysis.retrace import (LaunchError, LaunchGuard,
                                          check_launch_guard, check_launches,
                                          expected_launches,
                                          launch_departures, scan_levels)
from repro_torch.core.spec import (AssocSpec, FlashBSSpec, FlashSpec,
                                   FusedSpec, OnlineBeamSpec, OnlineSpec,
                                   SPEC_BY_METHOD, VanillaSpec)
from repro_torch.launch.loadtest import slot_step_departures

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SRC = ROOT / "src" / "repro_torch"

HOT = "src/repro_torch/core/somefile.py"        # FL002 applies
KERNELS = "src/repro_torch/kernels/somefile.py"  # FL002 applies, FL006 not
COLD = "src/repro_torch/serving/somefile.py"    # FL002 does not


def codes(src: str, path: str) -> list[str]:
    return [v.code for v in lint_source(textwrap.dedent(src), path)]


# ---------------------------------------------------------------------------
# Rule fixtures: each rule made to fire and kept quiet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src", [
    "import torch.distributed as dist\n",
    "import torch.distributed\n",
    "from torch import distributed as dist\n",
    "from torch.distributed import all_reduce\n",
    "import torch\ntorch.distributed.all_reduce(x)\n",
])
def test_fl001_raw_distributed_flagged_outside_the_mesh_layer(src):
    assert codes(src, COLD) == ["FL001"]


def test_fl001_allowed_in_the_mesh_layer_and_through_it():
    src = "import torch.distributed as dist\ndist.all_reduce(x)\n"
    assert codes(src, "src/repro_torch/core/mesh.py") == []
    assert codes(src, "src/repro_torch/launch/mesh.py") == []
    assert codes("from repro_torch.core.mesh import Mesh\n", COLD) == []
    assert codes("from repro_torch.launch.mesh import world_rank\n",
                 COLD) == []
    assert codes("import torch.multiprocessing as mp\n", COLD) == []


@pytest.mark.parametrize("src", [
    "x = delta.item()\n",
    "x = delta.cpu()\n",
    "x = psi.tolist()\n",
    "x = psi.numpy()\n",
    "import torch\ntorch.cuda.synchronize()\n",
    "import torch\nx = float(torch.max(delta))\n",
    "q = int(self._delta[0])\n",
    "import torch\nb = bool(torch.any(mask))\n",
])
def test_fl002_host_syncs_flagged_in_the_decode_stack_only(src):
    assert codes(src, HOT) == ["FL002"]
    assert codes(src, KERNELS) == ["FL002"]
    assert codes(src, COLD) == []


def test_fl002_static_metadata_is_exempt():
    assert codes("import torch\nn = int(torch.zeros((3,)).shape[0])\n",
                 HOT) == []
    assert codes("k = int(self.log_A.shape[0])\n", HOT) == []
    assert codes("d = int(self.em.ndim)\n", HOT) == []
    assert codes("on = bool(self.em.is_cuda)\n", HOT) == []
    # arguments are not host syncs, nor are plain Python numbers
    assert codes("x = delta.cpu(non_blocking=True)\n", HOT) == []
    assert codes("n = int(len(xs))\n", HOT) == []


def test_fl003_sys_path_manipulation():
    assert codes("import sys\nsys.path.insert(0, 'src')\n", COLD) == ["FL003"]
    assert codes("import sys\nprint(sys.argv)\n", COLD) == []


def test_fl004_string_dispatch_outside_shim_and_tests():
    src = "p, s = viterbi_decode(pi, A, em, method='flash')\n"
    assert codes(src, COLD) == ["FL004"]
    assert codes(src, "src/repro_torch/core/api.py") == []
    assert codes(src, "tests/test_something.py") == []
    assert codes("p, s = FlashSpec().run(pi, A, em)\n", COLD) == []


def test_fl005_malformed_disables():
    assert codes("x = 1  # flashlint: disable=FL999(made up)\n",
                 COLD) == ["FL005"]
    # an empty reason is FL005 AND suppresses nothing
    got = codes("x = delta.item()  # flashlint: disable=FL002()\n", HOT)
    assert sorted(got) == ["FL002", "FL005"]
    assert codes("x = 1  # flashlint: disable FL002\n", COLD) == ["FL005"]
    assert codes("x = 1  # flashlint: disable=FL002 because\n",
                 COLD) == ["FL005"]


@pytest.mark.parametrize("src", [
    "import ctypes\n",
    "from ctypes import CDLL\n",
    "import triton\n",
    "import triton.language as tl\n",
    "from triton import jit\n",
    "import torch.utils.cpp_extension\n",
    "from torch.utils.cpp_extension import load\n",
    "from torch.utils import cpp_extension\n",
    "import torch\ntorch.ops.load_library('libk.so')\n",
])
def test_fl006_kernel_loading_flagged_outside_kernels(src):
    assert codes(src, COLD) == ["FL006"]
    assert codes(src, HOT) == ["FL006"]


def test_fl006_allowed_in_kernels_tests_and_with_reason():
    src = "import ctypes\n"
    assert codes(src, "src/repro_torch/kernels/build.py") == []
    assert codes(src, "tests/test_kernels.py") == []
    assert codes("import ctypes  # flashlint: disable=FL006(prototype)\n",
                 COLD) == []
    # a non-torch root spelling the same attribute is not a violation
    assert codes("lib = mylib.ops.load_library('x')\n", COLD) == []
    assert codes("from torch.utils import data\n", COLD) == []


@pytest.mark.parametrize("src", [
    "import torch\ny = torch.where(mask, x, NEG_INF)\n",
    "import torch\ny = torch.where(keep, d, d + 4.0 * NEG_INF)\n",
    "import torch\ny = torch.where(mask, x, -torch.inf)\n",
    "import torch\ny = torch.where(mask, x, float('-inf'))\n",
    "import torch\ny = torch.where(mask, x, -1.0e9)\n",
    "y = x.masked_fill(~mask, NEG_INF)\n",
    "import torch\ny = x.masked_fill_(mask, value=-torch.inf)\n",
    "import numpy as np\ny = np.where(mask, x, -np.inf)\n",
])
def test_fl007_manual_neg_inf_masking_flagged(src):
    assert codes(src, COLD) == ["FL007"]


def test_fl007_exempt_in_constraints_kernels_and_tests():
    src = "import torch\ny = torch.where(mask, x, NEG_INF)\n"
    assert codes(src, "src/repro_torch/core/constraints.py") == []
    assert codes(src, "src/repro_torch/kernels/ops.py") == []
    assert codes(src, "tests/test_constraints.py") == []
    assert codes(src, HOT) == ["FL007"]        # core/ is not exempt
    assert codes("import torch\n"
                 "# flashlint: disable=FL007(sentinel padding seam)\n"
                 "y = torch.where(mask, x, NEG_INF)\n", COLD) == []


def test_fl007_benign_masks_not_flagged():
    assert codes("import torch\ny = torch.where(mask, x, 0.0)\n", COLD) == []
    assert codes("import torch\ny = torch.where(pad, delta, new)\n",
                 COLD) == []
    assert codes("y = x.masked_fill(mask, 0.0)\n", COLD) == []
    # small negative literals are scores, not sentinels
    assert codes("import torch\ny = torch.where(mask, x, -30.0)\n",
                 COLD) == []


# ---------------------------------------------------------------------------
# Disable grammar
# ---------------------------------------------------------------------------

def test_disable_same_line_and_previous_line():
    assert codes("x = delta.item()  # flashlint: disable=FL002(commit point)\n",
                 HOT) == []
    assert codes("# flashlint: disable=FL002(commit point)\n"
                 "x = delta.item()\n", HOT) == []
    # a previous-line disable covers that line only
    assert codes("# flashlint: disable=FL002(commit point)\n"
                 "x = delta.item()\ny = delta.item()\n", HOT) == ["FL002"]


def test_disable_requires_reason_and_right_code():
    assert codes("import sys\n"
                 "sys.path.insert(0, 'x')  # flashlint: disable=FL002(nope)\n",
                 HOT) == ["FL003"]


def test_disable_file_silences_whole_module():
    src = ("# flashlint: disable-file=FL002(host-side oracle)\n"
           "a = delta.item()\n"
           "b = other.cpu()\n")
    assert codes(src, HOT) == []


def test_grammar_in_docstrings_is_not_a_directive():
    src = '"""Use ``# flashlint: disable=FL002(reason)`` comments."""\n'
    assert codes(src, HOT) == []
    assert codes('"""# flashlint: disable=FL999()"""\n', HOT) == []


# ---------------------------------------------------------------------------
# Self-clean and the CLI's exit codes
# ---------------------------------------------------------------------------

def test_repro_torch_tree_is_flashlint_clean():
    violations, n_files = lint_paths([SRC])
    assert n_files > 50
    assert violations == [], "\n".join(str(v) for v in violations)


def _cli(*args, env_extra=None):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           *args], capture_output=True, text=True, env=env,
                          timeout=300)


def test_cli_exit_codes(tmp_path):
    bad = tmp_path / "core" / "bad.py"
    bad.parent.mkdir()
    bad.write_text("x = delta.cpu()\n")
    proc = _cli("--lint-only", str(tmp_path))
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "FL002" in proc.stdout
    bad.write_text("x = 1\n")
    proc = _cli("--lint-only", str(tmp_path))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "clean" in proc.stdout


def test_cli_lists_the_rules():
    proc = _cli("--list-rules")
    assert proc.returncode == 0, proc.stderr
    listed = {line.split()[0] for line in proc.stdout.splitlines() if line}
    assert listed == {f"FL00{i}" for i in range(1, 8)} | {
        "PV000", "PV101", "PV102", "PV103", "PV104", "PV201", "PV202",
        "PV301"}


def test_cli_device_cpu_and_no_silent_fallback():
    proc = _cli("--device", "cpu", "--contracts-only", "--quick")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    line = next(x for x in proc.stdout.splitlines()
                if x.startswith("contracts[cpu]"))
    assert "0 failed" in line and "needs the card" in line
    proc = _cli("--device", "cpu", "--retrace-only")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "launch guard[cpu]" in proc.stdout and "mechanics only" in \
        proc.stdout
    if not torch.cuda.is_available():   # the default device is cuda
        proc = _cli("--contracts-only", "--quick")
        assert proc.returncode != 0
        assert "CUDA is not available" in proc.stderr


# ---------------------------------------------------------------------------
# Contracts
# ---------------------------------------------------------------------------

def test_every_registered_method_has_contract_coverage():
    report = check_contracts(quick=True, device="cpu")
    assert report.ok, "\n".join(report.failures)
    assert any("registry coverage" in c for c in report.checks)


def test_shape_contracts_small_grid():
    report = check_shape_contracts(grid=((8, 16),), batch_grid=((8, 16, 3),))
    assert report.ok, "\n".join(report.failures)
    # a path, a score and no float64 for every spec; a batch for each
    # batchable one
    n_batch = sum(1 for s in contracts_mod.TRACEABLE_SPECS
                  if s.batch_method is not None)
    assert len(report.checks) == 3 * (len(contracts_mod.TRACEABLE_SPECS)
                                      + n_batch)


def test_shape_contract_catches_a_wrong_dtype():
    class Int64Path(FusedSpec):
        def run(self, log_pi, log_A, emissions):
            path, score = super().run(log_pi, log_A, emissions)
            return path.long(), score.double()

    report = check_shape_contracts(specs=(Int64Path(),), grid=((8, 16),),
                                   batch_grid=())
    assert not report.ok
    assert any("int32" in f for f in report.failures)
    assert any("float64" in f for f in report.failures)


def test_memory_contract_needs_the_card():
    report = check_memory_contracts(specs=(VanillaSpec(), FusedSpec()),
                                    grid=((24, 64),))
    assert report.ok and not report.checks and not report.memory_ratios
    assert len(report.skipped) == 2
    assert all("needs the card" in s for s in report.skipped)
    assert contracts_mod.allocated_state_bytes(VanillaSpec(), 8, 16,
                                               "cpu") is None


def test_memory_departure_is_a_pv104_finding_its_owner_may_waive(
        monkeypatch):
    # a card whose allocator reports 100x the model: flash's (512, 511)
    # departure is waived by core.flash, vanilla's is not
    from repro_torch.core.planner import spec_state_bytes

    monkeypatch.setattr(contracts_mod, "allocated_state_bytes",
                        lambda spec, K, T, device: 100 * spec_state_bytes(
                            spec, K, T))
    report = check_memory_contracts(specs=(FlashSpec(), VanillaSpec()),
                                    grid=((512, 511),), device="cuda")
    assert [w.split()[1].rstrip(":") for w in report.waived] == [
        "memory:cuda:flash[K=512,T=511]"]
    assert len(report.failures) == 1
    assert report.failures[0].startswith(
        "PV104 memory:cuda:vanilla[K=512,T=511]")
    assert report.memory_ratios[("flash", 512, 511)] == 100.0


def test_memory_tolerance_table_is_jaxs():
    from repro.analysis.contracts import MEMORY_TOLERANCE as JAX_TOL
    assert MEMORY_TOLERANCE == JAX_TOL
    for method, cls in SPEC_BY_METHOD.items():
        if method not in ("online", "online_beam"):
            assert method in MEMORY_TOLERANCE


def test_contract_grids_are_jaxs():
    from repro.analysis import contracts as jc
    assert contracts_mod.SHAPE_GRID == jc.SHAPE_GRID
    assert contracts_mod.BATCH_GRID == jc.BATCH_GRID
    assert contracts_mod.MEMORY_GRID == jc.MEMORY_GRID
    assert [s.method for s in contracts_mod.TRACEABLE_SPECS] == [
        s.method for s in jc.TRACEABLE_SPECS]
    assert [(s.method, s.stream_chunk)
            for s in contracts_mod.STREAMING_SPECS] == [
        (s.method, s.stream_chunk) for s in jc.STREAMING_SPECS]


def test_streaming_live_state_bounded_by_planner_model():
    report = check_streaming_contracts(K=12, T=32)
    assert report.ok, "\n".join(report.failures)
    # the decoder, the session and the mux, for both streaming specs
    assert sum("live-state" in c for c in report.checks) == 6


# ---------------------------------------------------------------------------
# The launch guard
# ---------------------------------------------------------------------------

def test_launch_guard_catches_a_count_set_by_hand():
    vdp = kernels.viterbi_dp
    try:
        with pytest.raises(LaunchError, match="viterbi_fwd_batch"):
            with LaunchGuard({}, what="hand"):
                vdp.launches["viterbi_fwd_batch"] += 1
        with pytest.raises(LaunchError, match="expected 2"):
            with LaunchGuard({"viterbi_backtrack_batch": 2}):
                vdp.launches["viterbi_backtrack_batch"] += 1
        with LaunchGuard({"bs_chunk_batch": 3}) as guard:
            kernels.beam_stream.launches["bs_chunk_batch"] += 3
        assert guard.launches["bs_chunk_batch"] == 3
        assert sum(guard.launches.values()) == 3
    finally:
        kernels.reset_launches()


def test_launch_guard_passes_an_exception_through():
    with pytest.raises(ValueError):
        with LaunchGuard({"viterbi_fwd_batch": 5}):
            raise ValueError("the block's own error wins")


def test_check_launch_guard_on_the_cpu_runs_its_mechanics():
    passed = check_launch_guard("cpu")
    assert any("positive control" in p for p in passed)
    assert any("mechanics only" in p for p in passed)
    assert not any(kernels.launch_counts().values())


def test_launch_departures_generalise_the_load_tests():
    counts = {name: 0 for name in kernels.launch_counts()}
    counts.update(viterbi_fwd_batch=5, bs_chunk_batch=1)
    assert launch_departures(counts, {"viterbi_fwd_batch": 5}) == {
        "bs_chunk_batch": (1, 0)}
    assert slot_step_departures(counts, 5) == 1
    assert slot_step_departures(counts, 7) == 3
    check_launches("ok", counts, {"viterbi_fwd_batch": 5,
                                  "bs_chunk_batch": 1})
    with pytest.raises(LaunchError):
        check_launches("bad", counts, {"viterbi_fwd_batch": 5})


def test_expected_launches_follow_the_decodes_structure():
    assert expected_launches(FusedSpec(), 64, 96) == {
        "viterbi_fwd_batch": 1, "viterbi_backtrack_batch": 1}
    assert expected_launches(VanillaSpec(), 64, 96) == {}
    # 22 values-only combines of the scan and one argmax launch, as the
    # smoke's paper-workload phase holds them
    assert expected_launches(AssocSpec(), 64, 4096) == {
        "tropical_matmul_batch": 23, "viterbi_backtrack_batch": 1}
    assert len(scan_levels(4095)) == 22
    # 96 frames in chunks of 64: the first chunk seeds from its first row
    assert expected_launches(OnlineSpec(stream_chunk=64), 64, 96) == {
        "viterbi_fwd_batch": 2}
    assert expected_launches(OnlineSpec(stream_chunk=1), 64, 3) == {
        "viterbi_fwd_batch": 2}
    assert expected_launches(OnlineBeamSpec(stream_chunk=64), 64, 96) == {
        "bs_chunk_batch": 2}
    # the serve's P = 8 at Tp = 512: one initial pass, then 64 ... 2-step
    # tiles, lanes = P a launch
    fb = expected_launches(FlashBSSpec(), 512, 512)
    assert fb["bs_initial_pass_batch"] == 1
    assert fb["bs_segment_decode_batch"] == 1 + 2 + 4 + 8 + 16 + 32


# ---------------------------------------------------------------------------
# The JAX package's disables, carried over
# ---------------------------------------------------------------------------

#: every `# flashlint: disable` under src/repro/{core,kernels,serving}, by
#: (file, line), with the code it disables and its counterpart in the port:
#: (port file, a snippet of the line it covers), or "file" for a
#: disable-file
COUNTERPARTS = {
    ("core/batch.py", 66): ("FL002", "core/batch.py",
                            "conc = lengths.cpu().numpy()"),
    ("core/reference.py", 13): ("FL002", "core/reference.py", "file"),
    ("core/online.py", 125): (
        "FL002", "core/online.py",
        "return np.asarray(self._committed, dtype=np.int32)"),
    ("core/online.py", 179): ("FL002", "core/online.py",
                              "return np.asarray(new, dtype=np.int32)"),
    ("core/online.py", 200): ("FL002", "core/online.py",
                              "return np.asarray(seg, dtype=np.int32), score"),
    ("core/online.py", 290): ("FL002", "core/online.py",
                              "delta = self._delta.cpu().numpy()"),
    ("core/online.py", 297): ("FL007", "core/online.py",
                              "self._delta = torch.where(keep, self._delta,"),
    ("core/online.py", 321): ("FL002", "core/online.py",
                              "self._psis.append(psi.cpu().numpy())"),
    ("core/online.py", 386): ("FL002", "core/online.py",
                              "psi_rows = np.asarray(psi_rows, np.int32)"),
    ("core/online.py", 399): ("FL002", "core/online.py",
                              "row = np.asarray(self._frontier())"),
    ("core/online.py", 426): (
        "FL002", "core/online.py",
        'self._psis = [np.asarray(p, np.int32).copy() for p in state["psis"]]'),
    ("core/online.py", 513): ("FL002", "core/online.py",
                              "scores = self._scores[0].cpu().numpy()"),
    ("core/online.py", 519): ("FL002", "core/online.py",
                              "return int(self._sstates[i][slot])"),
    ("core/online.py", 528): ("FL007", "core/online.py",
                              "self._scores = torch.where(keep, self._scores,"),
    # the port's chunk launch returns slot states and pointers together:
    # one transfer covers JAX's two
    ("core/online.py", 551): (
        "FL002", "core/online.py",
        "hist = torch.stack((sts[0], froms[0])).cpu().numpy()"),
    ("core/online.py", 559): (
        "FL002", "core/online.py",
        "hist = torch.stack((sts[0], froms[0])).cpu().numpy()"),
    ("core/hmm.py", 90): (
        "FL007", "core/hmm.py",
        "log_A = np.where(mask, np.log(np.maximum(probs, 1e-30)), NEG_INF)"),
    ("core/hmm.py", 118): (
        "FL007", "core/hmm.py",
        "log_A = np.where(allowed, np.log(np.maximum(probs, 1e-30)), NEG_INF)"),
    ("core/distributed.py", 162): (
        "FL007", "core/distributed.py",
        "owned = torch.where(has[:, None], local, NEG_INF * 2)"),
    ("serving/inflight.py", 102): (
        "FL007", "serving/inflight.py",
        "delta[slot] = torch.where(keep, row, row + 4.0 * NEG_INF)"),
}


def _jax_disables() -> dict[tuple[str, int], str]:
    out = {}
    base = ROOT / "src" / "repro"
    for sub in ("core", "kernels", "serving"):
        for path in sorted((base / sub).rglob("*.py")):
            text = path.read_text()
            for tok in tokenize.generate_tokens(io.StringIO(text).readline):
                if tok.type == tokenize.COMMENT and "flashlint: disable" in \
                        tok.string:
                    code = tok.string.split("=", 1)[1][:5]
                    out[(str(path.relative_to(base)), tok.start[0])] = code
    return out


def test_every_jax_disable_has_its_port_counterpart():
    found = _jax_disables()
    assert set(found) == set(COUNTERPARTS), (
        "a JAX disable without an entry in COUNTERPARTS, or a stale entry")
    for key, (code, port_file, anchor) in COUNTERPARTS.items():
        assert found[key] == code, key
        lines = (SRC / port_file).read_text().splitlines()
        if anchor == "file":
            assert any(f"flashlint: disable-file={code}(" in line
                       for line in lines), key
            continue
        at = [i for i, line in enumerate(lines) if anchor in line]
        assert len(at) == 1, (key, anchor)
        i = at[0]
        covered = (f"flashlint: disable={code}(" in lines[i]
                   or (lines[i - 1].strip().startswith("#")
                       and f"flashlint: disable={code}(" in lines[i - 1]))
        assert covered, f"{port_file}:{i + 1} lacks JAX's {code} disable"


@pytest.mark.parametrize("entry", ["run_prove", "check_contracts",
                                   "check_dispatch"])
def test_the_gate_entry_points_default_to_the_card(entry):
    """Given no device, each library entry point runs on ``cuda``: on a
    host without a GPU it raises before any work, never falling back to
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch import analysis
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(analysis, entry)()
