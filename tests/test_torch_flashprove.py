"""The port's flashprove tier (`repro_torch.analysis` tier 2) on the CPU: the
planner's cross-check against JAX's, the model against the port's measured
peak live bytes (or its owning module's waiver), injected defects the
dispatch pass must flag, the kernels' shared memory through the Python
mirror, the harvest, the collective check with its positive control, and
the waiver grammar.

The counterparts of `tests/test_flashprove.py`, its three failing tests
among them (an f64 promotion, an oversized kernel config, the harvest).
"""

from __future__ import annotations

import sys
import types

import pytest
import torch

from repro.core.planner import IR_STATE_FACTOR as JAX_FACTOR
from repro.core.planner import crosscheck_state_bytes as jax_crosscheck
from repro.core.spec import SPEC_BY_METHOD as JAX_SPECS
from repro_torch.analysis import kernel_check as kc
from repro_torch.analysis.collective_check import check_collectives
from repro_torch.analysis.dispatch_check import (DISPATCH_BATCH_GRID,
                                                 DISPATCH_GRID, analyze_entry,
                                                 batch_entry_call, entry_call,
                                                 peak_live_bytes)
from repro_torch.analysis.findings import (Finding, apply_waivers,
                                           collect_waivers, waiver_applies)
from repro_torch.core.planner import (IR_STATE_FACTOR, crosscheck_state_bytes,
                                      spec_state_bytes)
from repro_torch.core.spec import SPEC_BY_METHOD
from repro_torch.kernels import viterbi_dp

torch.set_num_threads(1)

GRID = DISPATCH_GRID[:2]
BATCH_GRID = DISPATCH_BATCH_GRID[:1]


# ---------------------------------------------------------------------------
# The planner's cross-check: JAX's factors, JAX's bound
# ---------------------------------------------------------------------------

def test_ir_state_factor_is_jaxs():
    assert IR_STATE_FACTOR == JAX_FACTOR
    assert set(IR_STATE_FACTOR) == set(SPEC_BY_METHOD)


@pytest.mark.parametrize("method", sorted(SPEC_BY_METHOD))
def test_crosscheck_agrees_with_jax_at_its_bound(method):
    spec, jspec = SPEC_BY_METHOD[method](), JAX_SPECS[method]()
    for K, T, batch in ((16, 32, 1), (64, 256, 1), (24, 48, 4)):
        model = spec_state_bytes(spec, K, T) * batch
        bound = int(model * IR_STATE_FACTOR[method]) + 8 * T * batch + 256
        for ir in (0, bound - 1, bound, bound + 1, 10 * bound):
            ours = crosscheck_state_bytes(spec, K, T, ir, batch=batch)
            theirs = jax_crosscheck(jspec, K, T, ir, batch=batch)
            assert (ours is None) == (theirs is None), (method, K, T, ir)
        assert crosscheck_state_bytes(spec, K, T, bound + 1, batch=batch)


def test_crosscheck_rejects_a_blowup_by_name():
    msg = crosscheck_state_bytes(SPEC_BY_METHOD["vanilla"](), 16, 32,
                                 ir_bytes=1 << 30)
    assert msg is not None and "vanilla" in msg


# ---------------------------------------------------------------------------
# The model against the port's measured peak (or its owner's waiver)
# ---------------------------------------------------------------------------

def _waived(subject: str, code: str = "PV104") -> bool:
    waivers, malformed = collect_waivers()
    assert not malformed
    active, _ = apply_waivers(
        [Finding(code, subject, "")],
        {k: r for k, r in waivers.items() if waiver_applies(k, "cpu")},
        require_used=False)
    return not active


@pytest.mark.parametrize("method", sorted(SPEC_BY_METHOD))
def test_model_upper_bounds_measured_state(method):
    spec = SPEC_BY_METHOD[method]()
    for K, T in GRID:
        subject = f"dispatch:cpu:{method}[K={K},T={T}]"
        peak = peak_live_bytes(entry_call(spec, K, T, "cpu"))
        assert peak > 0
        msg = crosscheck_state_bytes(spec, K, T, peak)
        assert msg is None or _waived(subject), msg


@pytest.mark.parametrize("method", sorted(
    m for m, cls in SPEC_BY_METHOD.items() if cls.batch_method is not None))
def test_model_upper_bounds_measured_state_batched(method):
    spec = SPEC_BY_METHOD[method]()
    for K, T, B in BATCH_GRID:
        subject = f"dispatch:cpu:{method}:batch[K={K},T={T},B={B}]"
        peak = peak_live_bytes(batch_entry_call(spec, K, T, B, "cpu"))
        msg = crosscheck_state_bytes(spec, K, T, peak, batch=B)
        assert msg is None or _waived(subject), msg


def test_online_beam_needs_no_waiver():
    # the streaming beam's chunk advance sits well under its O(W B) model
    spec = SPEC_BY_METHOD["online_beam"]()
    for K, T in GRID:
        peak = peak_live_bytes(entry_call(spec, K, T, "cpu"))
        assert crosscheck_state_bytes(spec, K, T, peak) is None
    assert not _waived("dispatch:cpu:online_beam[K=16,T=32]")


def test_peak_counts_storages_not_views():
    x = torch.ones(1024)

    def two_live():
        a = x * 2.0                  # 4 KiB
        b = a[:512].view(2, 256)     # a view: no new bytes
        c = a + 1.0                  # 4 KiB, live with a
        return b, c

    def one_at_a_time():
        for _ in range(3):
            y = x * 2.0
            del y
        return None

    assert peak_live_bytes(two_live) == 8192
    assert peak_live_bytes(one_at_a_time) == 4096


# ---------------------------------------------------------------------------
# Injected defects the dispatch pass must flag
# ---------------------------------------------------------------------------

def _codes(fn, model: int = 1 << 20) -> set[str]:
    return {f.code for f in analyze_entry(fn, "dispatch:cpu:injected",
                                          model)[1]}


def test_injected_f64_promotion_is_flagged():
    x = torch.ones(8)
    assert "PV101" in _codes(lambda: x.to(torch.float64) * 2.0)
    assert "PV101" in _codes(lambda: torch.zeros(3, dtype=torch.float64))


def test_injected_bf16_widening_is_flagged():
    x = torch.ones(8, dtype=torch.bfloat16)
    assert "PV101" in _codes(lambda: x.float() + 1.0)


def test_narrowing_and_int64_indices_are_not_findings():
    x = torch.ones(8)
    assert _codes(lambda: x.to(torch.bfloat16)) == set()
    assert _codes(lambda: (x.argmax(), x.topk(3).indices)) == set()
    y = torch.ones(8, dtype=torch.bfloat16)
    assert _codes(lambda: y + x) == set()   # the widest input is float32


def test_item_inside_an_entry_is_pv102():
    x = torch.arange(6.0)
    assert _codes(lambda: x.sum().item()) == {"PV102"}
    assert _codes(lambda: int(x.argmax())) == {"PV102"}
    assert _codes(lambda: x.sum()) == set()


def test_oversized_output_is_pv103():
    a = torch.ones((128, 128))
    # (128, 128, 128) float32 = 8 MiB, far above a 1 KiB model's floor
    found = analyze_entry(lambda: (a[:, None, :] + a[None, :, :]).amax(),
                          "dispatch:cpu:injected", 1024)[1]
    assert "PV103" in {f.code for f in found}
    assert any("(128, 128, 128)" in f.detail for f in found)


def test_findings_name_the_ops_caller_in_the_port():
    from repro_torch.core.spec import VanillaSpec
    _, found = analyze_entry(entry_call(VanillaSpec(), 8, 12, "cpu"),
                             "dispatch:cpu:vanilla", 1 << 20)
    assert any("repro_torch/core/vanilla.py:" in f.detail for f in found
               if f.code == "PV102")


# ---------------------------------------------------------------------------
# Kernels: shared memory through the mirror, spills, the harvest
# ---------------------------------------------------------------------------

def _ptxas_log(spills: dict[str, int] | None = None) -> str:
    """A ptxas -v log in nvcc's format, one block per kernel instance."""
    spills = spills or {}
    names = (
        [f"viterbi_fwd_cluster_kernelILb{t}ELb{s}ELb{r}EEEvNS_7FwdArgsE"
         for t in (0, 1) for s in (0, 1) for r in (0, 1)]
        + [f"viterbi_banded_cluster_kernelILb{m}EEEvNS_8BandArgsE"
           for m in (0, 1)]
        + [f"viterbi_backtrack_cluster_kernelILb{s}EEEvNS_6BtArgsE"
           for s in (0, 1)]
        + [f"beam_pass_kernelILi{m}ELb{r}EEEvNS_4ArgsE"
           for m in range(4) for r in (0, 1)]
        + [f"tropical_tile_kernelI{t}Lb{a}EEEvNS_8TropArgsIT_EE"
           for t in ("f", "13__nv_bfloat16") for a in (1, 0)])
    out = ["ptxas info    : 0 bytes gmem"]
    for i, n in enumerate(names):
        full = f"_ZN46_GLOBAL__N__d80b887d_13_x_cu_5249dc4226{n}"
        sp = spills.get(n.split("I")[0], 0)
        smem = ", 34816 bytes smem" if "tropical" in n else ""
        out += [f"ptxas info    : Compiling entry function '{full}' for "
                f"'sm_90a'",
                f"ptxas info    : Function properties for {full}",
                f"    0 bytes stack frame, {sp} bytes spill stores, {sp} "
                f"bytes spill loads",
                f"ptxas info    : Used {100 + i} registers, used 1 "
                f"barriers{smem}",
                "ptxas info    : Compile time = 1.0 ms"]
    return "\n".join(out) + "\n"


def test_oversized_tile_config_is_rejected():
    # forced resident at K = 2048, a forward block would ask for 2 MB of
    # shared memory: PV202, through the Python mirror (no nvcc here)
    found = kc.check_forced_instance(2048, resident=True)
    assert [f.code for f in found] == ["PV202"]
    assert kc.check_forced_instance(2048, resident=False) == []
    # the wrapper's own pick at that K is the global instance, which fits
    assert kc.forward_instance(2048) == "global"
    assert kc.fwd_smem_bytes(2048, False) <= kc.SMEM_BYTES


def test_mirror_reads_the_sources_constants_and_boundaries():
    c = kc.constants()
    assert c["kCluster"] == 8 and c["kSmemBytes"] == kc.SMEM_BYTES
    assert viterbi_dp.SMEM_BYTES == kc.SMEM_BYTES
    # the forward template's instance boundary the smoke drives
    assert kc.forward_instance(665) == "resident"
    assert kc.forward_instance(672) == "global"
    # the widest K: one delta pair fills the block
    assert kc.fwd_smem_bytes(viterbi_dp.MAX_K, False) == kc.SMEM_BYTES
    assert kc.band_instance(viterbi_dp.MAX_K)[0] == "barrier"
    assert kc.backtrack_plan(4095, 64) == (True, 16)
    assert kc.tropical_smem_bytes() == 34816


def test_kernel_check_of_the_tree_is_clean():
    report = kc.check_kernels()
    assert report.ok, [str(f) for f in report.findings]
    assert len(report.checks) == 9
    assert any("spills" in s and "card" in s for s in report.skipped)
    assert any("refuses" in s for s in report.skipped)
    assert report.stats["kernel:beam_max_k"]["K"] == kc.beam_max_k()


def test_ptxas_spill_is_pv201():
    report = kc.check_kernels(_ptxas_log({"beam_pass_kernel": 16}),
                              quick=True)
    assert {f.code for f in report.findings} == {"PV201"}
    assert all("beam_pass_kernel" in f.subject for f in report.findings)
    report = kc.check_kernels(_ptxas_log(), quick=True)
    assert report.ok and not any("spills" in s for s in report.skipped)


def test_harvest_reads_declared_blocks_back():
    found = kc.harvest_kernels(_ptxas_log())
    assert list(found) == list(kc.ENTRIES)        # the nine entries
    assert found["viterbi_fwd_batch"]["smem_bytes"] == kc.fwd_smem_bytes(
        512, True)
    assert found["viterbi_fwd_batch"]["instance"] == "resident"
    assert found["tropical_matmul_batch"]["smem_bytes"] == 34816
    assert found["bs_initial_pass_batch"]["smem_bytes"] == kc.beam_smem_bytes(
        512, 128, 7, True)
    # registers read back: the most over an entry's instances
    fwd = found["viterbi_fwd_batch"]
    assert fwd["instances"] == ["viterbi_fwd_cluster_kernel<0,0,0>",
                                "viterbi_fwd_cluster_kernel<0,0,1>"]
    assert fwd["registers"] == 101 and fwd["spill_bytes"] == 0
    assert found["beam_step_batch"]["instances"] == [
        "beam_pass_kernel<0,0>", "beam_pass_kernel<0,1>"]
    assert len(found["tropical_matmul_batch"]["instances"]) == 4
    bare = kc.harvest_kernels()
    assert all(r["registers"] is None for r in bare.values())


# ---------------------------------------------------------------------------
# Collectives: none in the sharded decode's body, and a positive control
# ---------------------------------------------------------------------------

def test_sharded_decode_has_no_collectives():
    report = check_collectives()
    assert report.ok, [str(f) for f in report.findings]
    assert len(report.checks) == 6
    assert all(v["collectives"] == ["all_gather"]
               for v in report.stats.values())


def test_collective_detector_positive_control():
    report = check_collectives(quick=True, inject=True)
    assert {f.code for f in report.findings} == {"PV301"}
    assert all("all_reduce" in f.detail for f in report.findings)


# ---------------------------------------------------------------------------
# Waiver grammar
# ---------------------------------------------------------------------------

def test_waiver_prefix_matching_and_unused_detection():
    f = Finding("PV103", "dispatch:cpu:flash:batch[K=16,T=32,B=3]", "big")
    active, waived = apply_waivers([f], {"PV103:dispatch:cpu:flash":
                                         "modeled cost"})
    assert active == [] and waived == [(f, "modeled cost")]
    # a `*` stands for the device; a prefix need not end at a segment
    active, _ = apply_waivers([f], {"PV103:dispatch:*:flash:batch[": "x"})
    assert active == []
    # wrong code does not match; the unused waiver itself becomes PV000
    active, waived = apply_waivers([f], {"PV101:dispatch:cpu:flash": "nope"})
    assert [g.code for g in active] == ["PV103", "PV000"] and not waived
    # narrowed runs must not flag deep-only waivers
    active, _ = apply_waivers([f], {"PV101:dispatch:cpu:flash": "nope"},
                              require_used=False)
    assert [g.code for g in active] == ["PV103"]
    # a flash waiver does not reach flash_bs
    g = Finding("PV104", "dispatch:cpu:flash_bs[K=16,T=32]", "x")
    active, _ = apply_waivers([g], {"PV104:dispatch:*:flash[": "y"},
                              require_used=False)
    assert active == [g]


def test_waivers_naming_another_device_do_not_apply():
    assert waiver_applies("PV104:dispatch:cpu:fused", "cpu")
    assert not waiver_applies("PV104:dispatch:cpu:fused", "cuda")
    assert waiver_applies("PV104:dispatch:*:fused", "cuda")
    assert not waiver_applies("PV104:memory:cuda:flash[", "cpu")
    assert waiver_applies("PV201", "cpu")


def test_malformed_waivers_are_pv000():
    mod = types.ModuleType("fake_waiver_mod")
    mod.FLASHPROVE_WAIVERS = {
        "PV999:x": "unknown code",
        "PV103:y": "   ",          # empty reason
        "PV000:z": "cannot waive the waiver rule",
    }
    sys.modules["fake_waiver_mod"] = mod
    try:
        waivers, malformed = collect_waivers(("fake_waiver_mod",))
    finally:
        del sys.modules["fake_waiver_mod"]
    assert waivers == {}
    assert [m.code for m in malformed] == ["PV000"] * 3


def test_tree_waivers_are_well_formed():
    waivers, malformed = collect_waivers()
    assert malformed == []
    assert waivers, "the triaged findings declare their waivers in-code"
    # none of JAX's PV201 waivers (TPU (8, 128) tiles) carried over
    assert not any(k.startswith("PV201") for k in waivers)
