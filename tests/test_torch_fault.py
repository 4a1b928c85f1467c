"""The port's fault-tolerance primitives and checkpointing
(`repro_torch.runtime.fault`, `repro_torch.checkpointing`), on the cases of
tests/test_fault.py and the checkpoint, supervised-loop, heartbeat and
elastic cases of tests/test_substrate.py.

`HeartbeatMonitor`, `StragglerDetector` and `SupervisedLoop` are the port's
own copy of the JAX package's pure-Python module; these tests pin the same
edge cases (0 workers, all dead, even-length median windows, window
eviction) with an injected clock.  The checkpoint cases hold tensors (a
bfloat16 leaf among them) and numpy arrays.
"""

import numpy as np
import pytest
import torch

from repro_torch.checkpointing import (CheckpointManager,
                                       abstract_target_mesh, plan_rescale)
from repro_torch.core.mesh import PartitionSpec as P
from repro_torch.runtime import (HeartbeatMonitor, StragglerDetector,
                                 SupervisedLoop)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def now(self):
        return self.t


# ---------------------------------------------------------------------------
# HeartbeatMonitor
# ---------------------------------------------------------------------------

def test_heartbeat_zero_workers_is_healthy():
    clock = FakeClock()
    mon = HeartbeatMonitor(num_workers=0, timeout_s=1.0, clock=clock.now)
    clock.t = 100.0
    assert mon.dead_workers() == []
    assert mon.healthy()


def test_heartbeat_all_dead():
    clock = FakeClock()
    mon = HeartbeatMonitor(num_workers=3, timeout_s=5.0, clock=clock.now)
    clock.t = 5.0 + 1e-6
    assert mon.dead_workers() == [0, 1, 2]
    assert not mon.healthy()


def test_heartbeat_boundary_is_alive():
    """A worker seen exactly `timeout_s` ago is still alive (strict >)."""
    clock = FakeClock()
    mon = HeartbeatMonitor(num_workers=1, timeout_s=5.0, clock=clock.now)
    clock.t = 5.0
    assert mon.healthy()


def test_heartbeat_beat_revives_only_that_worker():
    clock = FakeClock()
    mon = HeartbeatMonitor(num_workers=2, timeout_s=2.0, clock=clock.now)
    clock.t = 3.0
    mon.beat(0)
    assert mon.dead_workers() == [1]
    clock.t = 4.9
    assert mon.dead_workers() == [1]
    clock.t = 5.1
    assert mon.dead_workers() == [0, 1]


# ---------------------------------------------------------------------------
# StragglerDetector
# ---------------------------------------------------------------------------

def test_median_odd_window():
    det = StragglerDetector(num_workers=1)
    for t in (3.0, 1.0, 2.0):
        det.record(0, t)
    assert det.median() == 2.0


def test_median_even_window_is_true_median():
    """Even-length windows must average the two middle elements, not take
    the upper one — the upper-middle bias inflated the straggler threshold."""
    det = StragglerDetector(num_workers=1)
    for t in (1.0, 2.0, 3.0, 10.0):
        det.record(0, t)
    assert det.median() == pytest.approx(2.5)
    assert det.median() == pytest.approx(np.median([1.0, 2.0, 3.0, 10.0]))


def test_median_empty():
    det = StragglerDetector(num_workers=2)
    assert det.median() == 0.0
    assert det.stragglers() == []


def test_straggler_flagged_and_released():
    det = StragglerDetector(num_workers=2, factor=3.0, window=16)
    for _ in range(8):
        det.record(0, 1.0)
        det.record(1, 1.0)
    det.record(1, 10.0)
    assert det.stragglers() == [1]
    det.record(1, 1.0)  # back to normal on its next step
    assert det.stragglers() == []


def test_straggler_even_window_regression():
    """History [1, 1, 2, 5]: the true median is 1.5 (threshold 4.5), so the
    5.0 step is a straggler.  The old upper-middle 'median' said 2.0
    (threshold 6.0) and masked it."""
    det = StragglerDetector(num_workers=2, factor=3.0)
    for t in (1.0, 1.0, 2.0):
        det.record(0, t)
    det.record(1, 5.0)
    assert det.median() == pytest.approx(1.5)
    assert det.median() == pytest.approx(np.median([1.0, 1.0, 2.0, 5.0]))
    assert det.stragglers() == [1]


def test_window_eviction():
    """Old samples fall out of the rolling window: an early spike regime must
    stop dominating the median once `window * num_workers` newer samples
    arrive."""
    det = StragglerDetector(num_workers=1, factor=3.0, window=4)
    for _ in range(4):
        det.record(0, 100.0)
    assert det.median() == 100.0
    for _ in range(4):  # exactly window*num_workers fresh samples
        det.record(0, 1.0)
    assert det.median() == 1.0
    assert len(det.history) == 4
    det.record(0, 10.0)
    assert det.stragglers() == [0]


# ---------------------------------------------------------------------------
# checkpointing + fault tolerance (tests/test_substrate.py)
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    """keep-N, the flattened-path layout, and every leaf back with its
    dtype: a bfloat16 leaf is saved as float32 and cast back."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    w = torch.arange(6.0).reshape(2, 3)
    state = {"params": {"w": w, "h": (w / 3).to(torch.bfloat16)},
             "step": torch.tensor(3), "mask": [np.array([True, False])]}
    for s in (10, 20, 30):
        mgr.save(s, state, blocking=True)
    assert mgr.all_steps() == [20, 30]        # keep=2 GC'd step 10
    with np.load(tmp_path / "step_30" / "leaves.npz") as data:
        assert sorted(data.files) == ["mask/0", "params/h", "params/w",
                                      "step"]
        assert data["params/h"].dtype == np.float32
    restored = mgr.restore(30, state)
    assert torch.equal(restored["params"]["w"], w)
    assert restored["params"]["h"].dtype == torch.bfloat16
    assert torch.equal(restored["params"]["h"], state["params"]["h"])
    assert int(restored["step"]) == 3
    assert isinstance(restored["mask"], list)
    assert np.array_equal(restored["mask"][0], [True, False])
    on_meta = mgr.restore(30, state, device="meta")["params"]["w"]
    assert on_meta.device.type == "meta" and on_meta.shape == (2, 3)


def test_checkpoint_async_save_is_atomic(tmp_path):
    """A background save is visible only once renamed; `wait` joins it."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, {"x": torch.ones(4)})
    mgr.wait()
    assert mgr.latest_step() == 5
    assert not list(tmp_path.glob("*.tmp"))
    assert (tmp_path / "step_5" / "meta.json").exists()


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.zeros((2, 2))}, blocking=True)
    with pytest.raises(ValueError):
        mgr.restore(1, {"w": torch.zeros((3, 3))})


def test_supervised_loop_restarts_from_checkpoint(tmp_path):
    """Inject a failure mid-run; the loop restores and replays identically."""
    mgr = CheckpointManager(str(tmp_path), keep=5)
    calls = {"n": 0}

    def step_fn(state, batch):
        return {"x": state["x"] + batch}, {"loss": state["x"]}

    def chaos(step):
        calls["n"] += 1
        if step == 7 and not calls.get("failed"):   # fail once at step 7
            calls["failed"] = True
            raise RuntimeError("injected node failure")

    loop = SupervisedLoop(step_fn, {"x": torch.tensor(0.0)}, mgr,
                          batch_fn=lambda s: torch.tensor(1.0),
                          ckpt_every=5, chaos=chaos)
    state, log = loop.run(0, 10)
    assert loop.restarts == 1
    assert float(state["x"]) == 10.0          # exact replay after restore


def test_heartbeat_and_straggler():
    clock = {"t": 0.0}
    hb = HeartbeatMonitor(3, timeout_s=5.0, clock=lambda: clock["t"])
    clock["t"] = 3.0
    hb.beat(0), hb.beat(1)
    clock["t"] = 7.0
    assert hb.dead_workers() == [2]

    sd = StragglerDetector(num_workers=4, factor=3.0)
    for w in range(4):
        for _ in range(4):
            sd.record(w, 1.0)
    sd.record(2, 9.0)
    assert sd.stragglers() == [2]


def test_elastic_plan_rescale():
    # a shape-only target mesh: plan_rescale reads only mesh.shape
    mesh_ok = abstract_target_mesh((2, 2), ("data", "model"))
    shapes = {"w": torch.empty((64, 128), device="meta")}
    specs = {"w": P("data", "model")}
    assert plan_rescale(shapes, specs, mesh_ok) == []
    shapes_bad = {"w": np.zeros((63, 128), np.float32)}
    assert len(plan_rescale(shapes_bad, specs, mesh_ok)) == 1
    assert plan_rescale({"w": torch.empty(8)}, {"w": P(("data", "model"))},
                        mesh_ok) == []
