"""The port's fault drills (`repro_torch.launch.loadtest`) on the scenarios
and the `LoadConfig`s of tests/test_drills.py, on the CPU.

Worker death with restart from a checkpoint, elastic mesh shrink under load
and a mid-run budget shrink through the planner ladder: each must end with
every request delivered exactly once and every path bit-identical to the
reference oracle.  The shrink drill spawns its own gloo world of 4 CPU
processes (file rendezvous); the others run in this process.  JAX keeps its
drills out of tier-1 for the XLA device-count flag they need; these need
none and take seconds, so they run in tier-1.
"""

import pytest

from repro_torch.launch.loadtest import (LoadConfig, drill_budget_shrink,
                                         drill_mesh_rescale,
                                         drill_worker_death)

CFG = LoadConfig(seed=11, requests=12, states=24, stream_frac=0.0,
                 lengths=(9, 21, 40, 64), buckets=(64,), max_batch=4,
                 device="cpu")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return {
        "worker_death": drill_worker_death(
            CFG, str(tmp_path_factory.mktemp("warm")), kill_batch=1),
        # kill_batch=0 kills before anything is checkpointed: restart must
        # fall back to the empty done-mask and replay the entire trace
        "worker_death_cold": drill_worker_death(
            CFG, str(tmp_path_factory.mktemp("cold")), kill_batch=0),
        "mesh_rescale": drill_mesh_rescale(CFG, from_devices=4, to_devices=2),
        "budget_shrink": drill_budget_shrink(
            LoadConfig(seed=11, requests=12, states=32, stream_frac=0.0,
                       lengths=(9, 21, 40, 64), buckets=(128,), max_batch=8,
                       device="cpu")),
    }


def test_worker_death_detected_and_recovered(results):
    """Heartbeat catches the dead worker; restart-from-checkpoint loses and
    duplicates nothing; every path stays bit-identical to the oracle."""
    d = results["worker_death"]
    assert d["ok"], d
    assert d["detected_dead"] == [d["killed_worker"]]
    assert d["delivered"] == d["expected"]
    assert d["duplicates"] == 0
    assert d["oracle"]["ok"] and d["oracle"]["mismatches"] == []
    # the in-flight batch died after batch 0 was checkpointed, so recovery
    # restored a real step and resubmitted only the uncovered requests
    assert d["restored_from_step"] is not None
    assert 0 < d["resubmitted"] < d["expected"]


def test_worker_death_before_first_checkpoint(results):
    """Dying before any checkpoint exists degrades to a full replay, still
    exactly-once, still bit-identical."""
    d = results["worker_death_cold"]
    assert d["ok"], d
    assert d["restored_from_step"] is None
    assert d["resubmitted"] == d["expected"]
    assert d["delivered"] == d["expected"] and d["duplicates"] == 0


def test_mesh_rescale_bit_identical(results):
    """4 -> 2 ranks under load: the abstract-target plan is clean, the probe
    batch decodes bit-identically on both meshes, and the migrated queue
    drains exactly-once with the oracle green."""
    d = results["mesh_rescale"]
    assert d["ok"], d
    assert d["mesh"] == {"from": 4, "to": 2}
    assert d["rescale_plan_problems"] == []
    assert d["probe_bit_identical"]
    assert 0 < d["delivered_before_rescale"] < d["expected"]
    assert d["delivered"] == d["expected"] and d["duplicates"] == 0
    assert d["oracle"]["ok"]


def test_budget_shrink_engages_ladder(results):
    """Shrinking the budget mid-run re-plans to a smaller rung that fits,
    and both phases pass their own spec's oracle."""
    d = results["budget_shrink"]
    assert d["ok"], d
    assert d["downgraded"]
    assert d["under_budget"]
    assert (d["footprint_after_shrink_bytes"]
            <= d["budgets_bytes"]["small"])
    assert d["plans"]["small"]["state_bytes"] < d["plans"]["big"]["state_bytes"]
    assert d["oracle"]["big"]["ok"] and d["oracle"]["big"]["exact"]
    assert d["oracle"]["small"]["ok"]
    assert d["delivered"] == d["expected"] and d["duplicates"] == 0
