"""Fault tolerance runtime: heartbeats, straggler detection, supervised steps,
as in `repro.runtime.fault` (the port keeps its own copy: it imports nothing
of the JAX package).

On a real multi-host deployment these hooks wrap `torch.distributed`
liveness; here the same state machine is driven by injectable clocks/chaos
hooks so the policies (restart-from-checkpoint, straggler skip, elastic
shrink) are unit-testable on one host — the part of fault tolerance that is
actually logic, not plumbing.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable


@dataclasses.dataclass
class HeartbeatMonitor:
    """Tracks per-worker liveness; a worker missing `timeout_s` is dead."""
    num_workers: int
    timeout_s: float = 60.0
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        now = self.clock()
        self.last_seen = {w: now for w in range(self.num_workers)}

    def beat(self, worker: int):
        self.last_seen[worker] = self.clock()

    def dead_workers(self) -> list[int]:
        now = self.clock()
        return [w for w, t in self.last_seen.items()
                if now - t > self.timeout_s]

    def healthy(self) -> bool:
        return not self.dead_workers()


@dataclasses.dataclass
class StragglerDetector:
    """Flags workers whose step time exceeds `factor` x the rolling median."""
    num_workers: int
    factor: float = 3.0
    window: int = 16

    def __post_init__(self):
        self.history: list[float] = []
        self.last: dict[int, float] = {}

    def record(self, worker: int, step_time: float):
        self.last[worker] = step_time
        self.history.append(step_time)
        self.history = self.history[-self.window * self.num_workers:]

    def median(self) -> float:
        h = sorted(self.history)
        if not h:
            return 0.0
        n = len(h)
        if n % 2:
            return h[n // 2]
        return 0.5 * (h[n // 2 - 1] + h[n // 2])

    def stragglers(self) -> list[int]:
        med = self.median()
        if med <= 0:
            return []
        return [w for w, t in self.last.items() if t > self.factor * med]


class SupervisedLoop:
    """Drives train steps under failure policy (`ckpt_manager` is a
    `checkpointing.CheckpointManager`):

       * checkpoint every `ckpt_every` steps (async);
       * on a step exception (preemption / injected chaos): restore the latest
         checkpoint and continue — the data pipeline is step-indexed so the
         replayed batches are identical;
       * on persistent failure of the same step `max_retries` times: raise.
    """

    def __init__(self, step_fn, state, ckpt_manager, batch_fn,
                 ckpt_every: int = 50, max_retries: int = 3,
                 chaos: Callable[[int], None] | None = None):
        self.step_fn = step_fn
        self.state = state
        self.ckpt = ckpt_manager
        self.batch_fn = batch_fn
        self.ckpt_every = ckpt_every
        self.max_retries = max_retries
        self.chaos = chaos
        self.restarts = 0

    def run(self, start_step: int, num_steps: int, like=None):
        step = start_step
        metrics_log = []
        retries = 0
        while step < start_step + num_steps:
            try:
                if self.chaos is not None:
                    self.chaos(step)  # may raise to simulate a node loss
                batch = self.batch_fn(step)
                self.state, metrics = self.step_fn(self.state, batch)
                metrics_log.append({k: float(v) for k, v in metrics.items()})
                if (step + 1) % self.ckpt_every == 0:
                    self.ckpt.save(step + 1, self.state)
                step += 1
                retries = 0
            except RuntimeError:
                retries += 1
                self.restarts += 1
                if retries > self.max_retries:
                    raise
                self.ckpt.wait()  # barrier on in-flight async writes first
                latest = self.ckpt.latest_step()
                if latest is not None:
                    self.state = self.ckpt.restore(latest, like or self.state)
                    step = latest
        self.ckpt.save(step, self.state, blocking=True)
        return self.state, metrics_log


__all__ = ["HeartbeatMonitor", "StragglerDetector", "SupervisedLoop"]
