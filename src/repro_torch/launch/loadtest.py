"""End-to-end scale harness: load generation, fault drills, serving oracle, as
in `repro.launch.loadtest`.

Everything below the serve path is tested in isolation elsewhere (decoders,
kernels, sharded decodes); this module exercises the *system*: a
deterministic, seedable load generator drives ``BatchScheduler`` (offline
requests), ``StreamMux`` (streaming sessions) and the planner's
``--budget-kb`` path through one harness object, records throughput and
latency percentiles, and checks every decoded path against a slow reference
oracle, so a scheduling, padding or rescale bug surfaces as a bit-identity
failure, not a perf blip.

Three pieces:

* **Load generation** (`make_workload`): ragged lengths drawn from a pool,
  bursty arrivals from a Markov-modulated Poisson process (all randomness
  from one `numpy` RNG, drawn exactly as the JAX package draws it; all time
  from a `VirtualClock`), and a streaming/offline request mix.  Streaming
  requests become open/feed/finish event sequences.  The HMM comes from the
  port's own generator (JAX draws it with `jax.random`); ``hmm=`` injects
  another, e.g. JAX's as numpy.

* **The differential serving oracle** (`oracle_check`): every delivered path
  is compared bit for bit against a looped single-sequence ``spec.run`` of
  the same spec on the unpadded payload, and against the pure-numpy
  ``core.reference`` decoder: score equality for exact specs, the
  optimal-score upper bound for beams.

* **Fault drills** (`drill_worker_death`, `drill_mesh_rescale`,
  `drill_budget_shrink`), built on ``runtime/fault.py`` and
  ``checkpointing``: a worker dies mid-decode and the survivor restarts from
  the done-mask checkpoint with no lost or duplicated requests; the data mesh
  shrinks under load (in a spawned world of ranks, `launch.mesh.run_spmd`)
  with results bit-identical across the rescale; the memory budget shrinks
  mid-run and the planner's downgrade ladder engages while staying under
  budget.

Reports go under ``build/loadtest/``.  CLI (``--device cpu`` runs on the CPU;
the default is the card)::

    PYTHONPATH=src python -m repro_torch.launch.loadtest --requests 24 --states 32
    PYTHONPATH=src python -m repro_torch.launch.loadtest --budget-kb 64 --drill all
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import numpy as np
import torch

from ..core import (HMM, ResourceBudget, erdos_renyi_hmm, plan,
                    spec_from_tunables, spec_state_bytes)
from ..core import reference as ref
from ..core.device import resolve_device
from ..core.spec import DecodeSpec, OnlineSpec
from ..serving.alignment import make_alignment_head
from ..serving.scheduler import BatchScheduler
from ..serving.stream import StreamMux

__all__ = [
    "VirtualClock", "LoadConfig", "LoadEvent", "Workload", "make_workload",
    "resolve_spec", "oracle_check", "LoadHarness", "WorkerDied",
    "peak_concurrency", "run_inflight_compare",
    "drill_worker_death", "drill_mesh_rescale", "drill_budget_shrink",
    "run_drill", "DRILLS", "main",
]

DEFAULT_OUT = os.path.join("build", "loadtest", "loadtest.json")


# ---------------------------------------------------------------------------
# Deterministic time
# ---------------------------------------------------------------------------

class VirtualClock:
    """Injectable simulation clock: arrivals live on a deterministic timeline.

    ``now`` has the same signature as ``time.monotonic``, so the clock plugs
    straight into ``runtime.fault.HeartbeatMonitor(clock=...)``.  Decode
    *service* time is real (measured around each device call, which ends
    with the results on the host, and added to the timeline); everything
    else (arrivals, heartbeats, failure detection) is virtual, which is what
    makes the drills deterministic.
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"clock cannot run backwards (dt={dt})")
        self._t += dt

    def advance_to(self, t: float) -> None:
        self._t = max(self._t, float(t))


# ---------------------------------------------------------------------------
# Workload generation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LoadConfig:
    """One load-test scenario; every field feeds the seeded generator.

    Arrivals follow a Markov-modulated Poisson process: a calm regime at
    ``1/mean_interarrival_s`` requests/s and a burst regime ``burst_factor``
    times faster, with per-arrival switch probabilities.  ``device`` is where
    the model and every decode live (None: ``cuda``).
    """
    seed: int = 0
    requests: int = 24
    states: int = 32                    # K
    edge_prob: float = 0.5
    stream_frac: float = 0.25           # fraction of requests that stream
    lengths: tuple[int, ...] = (12, 33, 64, 96, 128)
    buckets: tuple[int, ...] = (64, 128)
    max_batch: int = 8
    stream_block: int = 16              # StreamMux block bucket
    stream_chunk: int = 8               # frames per feed event
    frame_s: float = 1e-3               # virtual per-frame period for streams
    mean_interarrival_s: float = 4e-3
    burst_factor: float = 8.0
    p_enter_burst: float = 0.15
    p_exit_burst: float = 0.35
    method: str = "flash"               # offline spec when budget_kb is None
    budget_kb: float | None = None      # planner path: budget -> spec
    check_oracle: bool = True
    inflight: bool = False              # continuous batching for streams
    inflight_slots: int = 64            # slot-pool size when inflight
    device: str | None = None

    def __post_init__(self):
        if not 0.0 <= self.stream_frac <= 1.0:
            raise ValueError(f"stream_frac must be in [0, 1], "
                             f"got {self.stream_frac}")
        if max(self.lengths) > max(self.buckets):
            raise ValueError(f"lengths {self.lengths} exceed the largest "
                             f"bucket {max(self.buckets)}")


@dataclasses.dataclass(frozen=True)
class LoadEvent:
    """One timeline entry; ``seq`` breaks ties deterministically."""
    t: float
    seq: int
    kind: str                       # offline | open | feed | finish
    rid: int
    frames: np.ndarray | None = None


@dataclasses.dataclass
class Workload:
    hmm: HMM
    events: list[LoadEvent]
    payloads: dict[int, np.ndarray]     # rid -> full (T, K) emissions
    kinds: dict[int, str]               # rid -> offline | stream


def make_workload(cfg: LoadConfig, hmm: HMM | None = None) -> Workload:
    """Generate the full arrival trace; byte-reproducible from cfg.seed.

    Events and payloads are the JAX package's, byte for byte.  The HMM is
    drawn from its own stream, seeded by ``(cfg.seed, 1)``, unless `hmm` is
    given.
    """
    rng = np.random.default_rng(cfg.seed)
    if hmm is None:
        hmm = erdos_renyi_hmm(np.random.default_rng((cfg.seed, 1)),
                              cfg.states, edge_prob=cfg.edge_prob,
                              device=cfg.device)
    events: list[LoadEvent] = []
    payloads: dict[int, np.ndarray] = {}
    kinds: dict[int, str] = {}
    t, seq, burst = 0.0, 0, False

    def emit(t, kind, rid, frames=None):
        nonlocal seq
        events.append(LoadEvent(t, seq, kind, rid, frames))
        seq += 1

    for rid in range(cfg.requests):
        burst = (rng.random() >= cfg.p_exit_burst if burst
                 else rng.random() < cfg.p_enter_burst)
        rate = (cfg.burst_factor if burst else 1.0) / cfg.mean_interarrival_s
        t += float(rng.exponential(1.0 / rate))
        T = int(rng.choice(cfg.lengths))
        em = (rng.standard_normal((T, cfg.states)) * 2.0).astype(np.float32)
        payloads[rid] = em
        if rng.random() < cfg.stream_frac:
            kinds[rid] = "stream"
            emit(t, "open", rid)
            ft = t
            for s in range(0, T, cfg.stream_chunk):
                chunk = em[s:s + cfg.stream_chunk]
                ft += cfg.frame_s * chunk.shape[0]
                emit(ft, "feed", rid, chunk)
            emit(ft + cfg.frame_s, "finish", rid)
        else:
            kinds[rid] = "offline"
            emit(t, "offline", rid, em)
    events.sort(key=lambda e: (e.t, e.seq))
    return Workload(hmm=hmm, events=events, payloads=payloads, kinds=kinds)


def resolve_spec(cfg: LoadConfig):
    """(offline spec, DecodePlan | None): the ``--budget-kb`` alignment path."""
    if cfg.budget_kb is not None:
        p = plan(cfg.states, max(cfg.buckets),
                 ResourceBudget(memory_bytes=int(cfg.budget_kb * 1024)),
                 batch=cfg.max_batch)
        return p.spec, p
    spec, _ = spec_from_tunables(cfg.method, {})
    return spec, None


# ---------------------------------------------------------------------------
# Differential serving oracle
# ---------------------------------------------------------------------------

def _is_exact(spec: DecodeSpec, K: int) -> bool:
    if spec.method in ("online", "online_beam") and spec.max_lag is not None:
        return False
    if spec.method in ("flash_bs", "online_beam"):
        return spec.beam_width >= K
    if spec.method == "beam_static" or spec.method == "beam_static_mp":
        return spec.beam_width >= K
    return True


def oracle_check(spec: DecodeSpec, hmm: HMM,
                 payloads: dict[int, np.ndarray],
                 results: dict[int, tuple]) -> dict:
    """Check every delivered (path, score) against slow reference decodes.

    Per request:
      * bit-identity (path and score) versus a looped, unbatched, unpadded
        ``spec.run`` on the model's device: the invariant the scheduler,
        mux and mesh must preserve;
      * the path's recomputed numpy score must equal the reported score;
      * versus ``reference.viterbi_numpy``: score equality for exact specs,
        the optimal-score upper bound for beams.

    The recomputed score and ``viterbi_numpy``'s add the same float32 terms
    in different orders, so both comparisons with the optimum allow the
    same rounding (rtol 1e-5, atol 1e-4).  The JAX package bounds beams by
    atol 1e-4 alone, which flags a beam's *optimal* path at T = 511 (a sum
    near 557 differs by 3.7e-4 between the two orders).
    """
    log_pi_np = hmm.log_pi.cpu().numpy()
    log_A_np = hmm.log_A.cpu().numpy()
    exact = _is_exact(spec, int(log_A_np.shape[0]))
    mismatches: list[dict] = []

    def bad(rid, what, got, want):
        mismatches.append({"rid": int(rid), "what": what,
                           "got": got, "want": want})

    for rid in sorted(results):
        path, score = results[rid]
        path, score = np.asarray(path), float(score)
        em = payloads[rid]
        if path.shape != (em.shape[0],):
            bad(rid, "path_shape", list(path.shape), [int(em.shape[0])])
            continue
        rp, rs = spec.run(hmm.log_pi, hmm.log_A,
                          torch.from_numpy(em).to(hmm.log_A.device))
        rp = rp.cpu().numpy()
        if not np.array_equal(path, rp):
            n = int((path != rp).sum())
            bad(rid, "path_vs_looped_spec", f"{n} frames differ", "0")
        if not np.isclose(score, float(rs), rtol=1e-6, atol=1e-6):
            bad(rid, "score_vs_looped_spec", score, float(rs))
        ps = ref.path_score_numpy(log_pi_np, log_A_np, em, path)
        if not np.isclose(ps, score, rtol=1e-5, atol=1e-4):
            bad(rid, "reported_score_vs_path", score, ps)
        _, ns = ref.viterbi_numpy(log_pi_np, log_A_np, em)
        optimal = np.isclose(ps, ns, rtol=1e-5, atol=1e-4)
        if exact and not optimal:
            bad(rid, "exact_path_not_optimal", ps, ns)
        if not exact and ps > ns and not optimal:
            bad(rid, "beam_beats_optimum", ps, ns)
    return {"checked": len(results), "exact": exact,
            "mismatches": mismatches, "ok": not mismatches}


# ---------------------------------------------------------------------------
# The harness
# ---------------------------------------------------------------------------

def _pct(xs: list[float]) -> dict | None:
    if not xs:
        return None
    a = np.asarray(xs, np.float64)
    return {"p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99)),
            "mean": float(a.mean()), "max": float(a.max()), "n": len(xs)}


class LoadHarness:
    """Drives the serve path end to end under one generated trace.

    Offline requests go through ``BatchScheduler`` (batches fire whenever the
    queue reaches ``max_batch``, plus a final drain), streaming requests
    through ``StreamMux`` sessions fed chunk by chunk at their virtual
    arrival times.  ``chaos(batch_index)``, if given, runs before every
    offline batch decode and may raise to simulate a production event (the
    drills use this); exceptions propagate to the caller, which owns
    recovery.
    """

    def __init__(self, cfg: LoadConfig, *, workload: Workload | None = None,
                 chaos=None, clock: VirtualClock | None = None):
        self.cfg = cfg
        self.work = workload if workload is not None else make_workload(cfg)
        self.clock = clock if clock is not None else VirtualClock()
        self.chaos = chaos
        self.spec, self.plan = resolve_spec(cfg)
        hmm = self.work.hmm
        device = hmm.log_A.device
        self.head = make_alignment_head(hmm.log_pi, hmm.log_A, self.spec,
                                        device=device)
        self.sched = BatchScheduler(self.head, max_batch=cfg.max_batch,
                                    buckets=cfg.buckets)
        self.stream_spec = OnlineSpec(stream_chunk=cfg.stream_chunk)
        self.inflight = None
        if cfg.inflight:
            from ..serving.inflight import InflightScheduler
            self.inflight = InflightScheduler(
                hmm.log_pi, hmm.log_A, max_slots=cfg.inflight_slots,
                block=cfg.stream_block, device=device)
        self.mux = StreamMux(hmm.log_pi, hmm.log_A, self.stream_spec,
                             blocks=(cfg.stream_block,),
                             inflight=self.inflight, device=device)
        self.results: dict[int, tuple] = {}         # offline rid -> result
        self.stream_results: dict[int, tuple] = {}  # stream rid -> result
        self.duplicates = 0
        self.batches = 0
        self.latency = {"offline": [], "stream_first_commit": [],
                        "stream_finish": [], "stream_feed": []}
        self.lag_frames: list[float] = []
        self._arrival: dict[int, float] = {}
        self._rid_of: dict[int, int] = {}           # scheduler rid -> load rid
        self._sid_of: dict[int, int] = {}           # load rid -> mux sid
        self._first_commit: set[int] = set()
        self.peak_stream_bytes = 0

    # -- plumbing -----------------------------------------------------------
    def _timed(self, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.clock.advance(time.perf_counter() - t0)
        return out

    def _deliver(self, results: dict, rid: int, result) -> None:
        if rid in results:
            self.duplicates += 1
        results[rid] = result

    def step_batch(self) -> int:
        """Run one offline batch (chaos hook first); returns requests done."""
        if self.chaos is not None:
            self.chaos(self.batches)
        done = self._timed(self.sched.step)
        self.batches += 1
        for r in done:
            rid = self._rid_of[r.rid]
            self._deliver(self.results, rid, r.result)
            self.latency["offline"].append(self.clock.now()
                                           - self._arrival[rid])
        return len(done)

    # -- event dispatch -----------------------------------------------------
    def _on_offline(self, ev: LoadEvent) -> None:
        self._arrival[ev.rid] = ev.t
        req = self.sched.submit(ev.frames)
        self._rid_of[req.rid] = ev.rid
        while len(self.sched.queue) >= self.cfg.max_batch:
            self.step_batch()

    def _on_open(self, ev: LoadEvent) -> None:
        self._arrival[ev.rid] = ev.t
        self._sid_of[ev.rid] = self.mux.open(block=self.cfg.stream_block)

    def _on_feed(self, ev: LoadEvent) -> None:
        t_before = self.clock.now()
        out = self._timed(self.mux.feed, self._sid_of[ev.rid], ev.frames)
        self.latency["stream_feed"].append(self.clock.now() - t_before)
        self.lag_frames.append(float(out["lag"]))
        if out["committed"].shape[0] and ev.rid not in self._first_commit:
            self._first_commit.add(ev.rid)
            self.latency["stream_first_commit"].append(
                self.clock.now() - self._arrival[ev.rid])
        self.peak_stream_bytes = max(self.peak_stream_bytes,
                                     self.mux.live_state_bytes())

    def _on_finish(self, ev: LoadEvent) -> None:
        path, score = self._timed(self.mux.finish, self._sid_of[ev.rid])
        self._deliver(self.stream_results, ev.rid, (path, score))
        self.latency["stream_finish"].append(self.clock.now()
                                             - self._arrival[ev.rid])

    def run(self) -> dict:
        """Play the whole trace, drain, and return the report dict."""
        dispatch = {"offline": self._on_offline, "open": self._on_open,
                    "feed": self._on_feed, "finish": self._on_finish}
        for ev in self.work.events:
            self.clock.advance_to(ev.t)
            dispatch[ev.kind](ev)
        while self.sched.queue:
            self.step_batch()
        return self.report()

    # -- reporting ----------------------------------------------------------
    def report(self) -> dict:
        cfg = self.cfg
        kinds = self.work.kinds
        n_off = sum(1 for k in kinds.values() if k == "offline")
        n_st = len(kinds) - n_off
        frames = sum(p.shape[0] for p in self.work.payloads.values())
        elapsed = max(self.clock.now(), 1e-9)
        delivered = len(self.results) + len(self.stream_results)
        rep = {
            "config": dataclasses.asdict(cfg),
            "device": str(self.work.hmm.log_A.device),
            "spec": {"type": type(self.spec).__name__,
                     "method": self.spec.method,
                     "planned_why": self.plan.why if self.plan else None,
                     "planned_state_bytes":
                         self.plan.state_bytes if self.plan else None},
            "requests": {"total": cfg.requests, "offline": n_off,
                         "stream": n_st, "delivered": delivered,
                         "duplicates": self.duplicates},
            "throughput": {"requests_per_s": delivered / elapsed,
                           "frames_per_s": frames / elapsed,
                           "elapsed_s": elapsed},
            "latency_s": {k: _pct(v) for k, v in self.latency.items()},
            "scheduler": {"batches": self.sched.stats["batches"],
                          "mean_pad_frac":
                              float(np.mean(self.sched.stats["padded_frac"]))
                              if self.sched.stats["padded_frac"] else 0.0},
            "stream": {**{k: int(v) for k, v in self.mux.stats.items()},
                       "peak_live_state_bytes": int(self.peak_stream_bytes),
                       "commit_lag_frames": _pct(self.lag_frames)},
        }
        if self.inflight is not None:
            rep["inflight"] = self.inflight.slo_report()
        if cfg.check_oracle:
            rep["oracle"] = self.oracle()
        return rep

    def oracle(self) -> dict:
        """`oracle_check` of everything delivered, offline and streamed.

        `report` calls it when ``cfg.check_oracle``; a caller that counts
        the run's kernel launches turns that off and calls it after, since
        the oracle's looped decodes launch the same kernels.
        """
        hmm = self.work.hmm
        off_payloads = {r: self.work.payloads[r] for r in self.results}
        st_payloads = {r: self.work.payloads[r] for r in self.stream_results}
        off = oracle_check(self.spec, hmm, off_payloads, self.results)
        st = oracle_check(self.stream_spec, hmm, st_payloads,
                          self.stream_results)
        return {"offline": off, "stream": st, "ok": off["ok"] and st["ok"]}


# ---------------------------------------------------------------------------
# Inflight vs. bucketed comparison
# ---------------------------------------------------------------------------

DEFAULT_INFLIGHT_OUT = os.path.join("build", "loadtest", "inflight.json")


def peak_concurrency(work: Workload) -> int:
    """Max sessions simultaneously open in the trace (streams only)."""
    live = peak = 0
    for ev in work.events:
        if ev.kind == "open":
            live += 1
            peak = max(peak, live)
        elif ev.kind == "finish":
            live -= 1
    return peak


#: the kernel of the inflight pool's slot step (`kernels.ops.viterbi_slot_step`)
SLOT_STEP_KERNEL = "viterbi_fwd_batch"


def slot_step_departures(launches: dict[str, int], steps: int) -> int:
    """How far an inflight run's kernel launches are from one slot-step
    launch a `step()` and no other kernel: 0 when they agree."""
    from ..analysis.retrace import launch_departures
    return sum(abs(got - want) for got, want in launch_departures(
        launches, {SLOT_STEP_KERNEL: steps}).values())


def _counted_run(harness: LoadHarness) -> tuple[dict, dict[str, int]]:
    """Run a harness whose oracle is off; (report, kernel launches of the
    run).  The launch counters are per process and count kernel launches
    only, so on the CPU every count is 0."""
    from .. import kernels
    kernels.reset_launches()
    rep = harness.run()
    return rep, kernels.launch_counts()


def run_inflight_compare(cfg: LoadConfig) -> dict:
    """Drive the *same* seeded MMPP trace through bucketed and inflight muxing.

    Both runs are all-streaming (`stream_frac=1.0`) and oracle-checked
    after the run (``cfg.check_oracle``); the report carries p50/p99
    feed/block latency, commit lag, and session first-commit/completion
    latency for each side, plus the head-to-head p99-completion verdict.
    PyTorch has no jit cache to retrace: in its place the inflight run must
    launch the slot-step kernel exactly once a `step()` and no other
    kernel, whatever sessions join or leave, which the kernels' launch
    counters show.  ``retraces`` counts the departures from that
    (`slot_step_departures`) and must be 0.  Kernels launch only on the
    card: on the CPU the launches are not measured and ``retraces`` is
    None.
    """
    base = dataclasses.replace(cfg, stream_frac=1.0, inflight=False,
                               check_oracle=False)
    work = make_workload(base)
    concurrency = peak_concurrency(work)
    measured = work.hmm.log_A.device.type == "cuda"

    bucketed_h = LoadHarness(base, workload=work)
    bucketed, bucketed_launches = _counted_run(bucketed_h)

    infl_cfg = dataclasses.replace(base, inflight=True)
    harness = LoadHarness(infl_cfg, workload=work)
    pool = harness.inflight
    # warm the slot pool once so that the comparison excludes first use
    warm = pool.submit()
    pool.feed(warm, np.zeros((infl_cfg.stream_block + 1, cfg.states),
                             np.float32))
    pool.pump()
    pool.finish(warm)
    steps0 = pool.stats["steps"]
    inflight, inflight_launches = _counted_run(harness)
    steps = pool.stats["steps"] - steps0
    retraces = (slot_step_departures(inflight_launches, steps) if measured
                else None)
    if cfg.check_oracle:
        bucketed["oracle"] = bucketed_h.oracle()
        inflight["oracle"] = harness.oracle()

    def side(rep, launches):
        return {"feed_latency_s": rep["latency_s"]["stream_feed"],
                "first_commit_s": rep["latency_s"]["stream_first_commit"],
                "completion_s": rep["latency_s"]["stream_finish"],
                "commit_lag_frames": rep["stream"]["commit_lag_frames"],
                "throughput": rep["throughput"],
                "oracle_ok": rep.get("oracle", {}).get("ok"),
                "stream_stats": rep["stream"],
                "launches": launches if measured else None}

    b = side(bucketed, bucketed_launches)
    i = side(inflight, inflight_launches)
    p99_b = (b["completion_s"] or {}).get("p99", float("nan"))
    p99_i = (i["completion_s"] or {}).get("p99", float("nan"))
    return {
        "config": dataclasses.asdict(dataclasses.replace(
            infl_cfg, check_oracle=cfg.check_oracle)),
        "device": inflight["device"],
        "peak_concurrent_sessions": concurrency,
        "bucketed": b,
        "inflight": {**i, "slo": inflight.get("inflight"),
                     "slot_step": {"kernel": SLOT_STEP_KERNEL,
                                   "launches": (inflight_launches.get(
                                       SLOT_STEP_KERNEL, 0) if measured
                                       else None),
                                   "steps": steps},
                     "retraces_across_churn": retraces},
        "p99_completion_s": {"bucketed": p99_b, "inflight": p99_i,
                             "speedup": (p99_b / p99_i if p99_i else
                                         float("nan"))},
        "p99_completion_win": bool(p99_i < p99_b),
        "oracle_ok": bool(b["oracle_ok"] and i["oracle_ok"]),
        "retraces": retraces,
    }


# ---------------------------------------------------------------------------
# Fault drills
# ---------------------------------------------------------------------------

class WorkerDied(RuntimeError):
    """Injected chaos: the worker holding the in-flight batch vanished."""


def drill_worker_death(cfg: LoadConfig, ckpt_dir: str | None = None, *,
                       kill_batch: int = 1, timeout_s: float = 5.0) -> dict:
    """Drill 1: worker death mid-decode -> heartbeat detect -> restart.

    Two simulated workers alternate offline batches, beating a
    ``HeartbeatMonitor`` driven by the virtual clock, and a done-mask
    checkpoint is written after every delivered batch.  At ``kill_batch`` the
    active worker dies *after* the scheduler popped its batch (those requests
    are in flight on a dead host: gone).  The survivor notices the missed
    heartbeats, restores the latest checkpoint, resubmits exactly the
    requests the checkpoint does not cover, and drains.  Pass conditions:
    the dead worker is detected, every request is delivered exactly once,
    and every path is bit-identical to the oracle.
    """
    from ..checkpointing.manager import CheckpointManager
    from ..runtime.fault import HeartbeatMonitor

    cfg = dataclasses.replace(cfg, stream_frac=0.0)
    work = make_workload(cfg)
    spec, _ = resolve_spec(cfg)
    hmm = work.hmm
    head = make_alignment_head(hmm.log_pi, hmm.log_A, spec,
                               device=hmm.log_A.device)
    if ckpt_dir is None:
        ckpt_dir = tempfile.mkdtemp(prefix="drill_worker_death_")
    ckpt = CheckpointManager(ckpt_dir, keep=2)
    clock = VirtualClock()
    mon = HeartbeatMonitor(num_workers=2, timeout_s=timeout_s,
                           clock=clock.now)
    N = cfg.requests
    done_mask = np.zeros((N,), np.bool_)
    delivered: dict[int, tuple] = {}
    duplicates = 0
    box = {"batch": 0, "die_at": kill_batch}

    def flaky_head(em, lengths=None):
        if box["die_at"] is not None and box["batch"] == box["die_at"]:
            box["die_at"] = None
            raise WorkerDied("node hosting the in-flight batch lost")
        return head(em, lengths)

    def fresh_sched(rids, fn):
        sched = BatchScheduler(fn, max_batch=cfg.max_batch,
                               buckets=cfg.buckets)
        rid_of = {}
        for rid in rids:
            req = sched.submit(work.payloads[rid])
            rid_of[req.rid] = rid
        return sched, rid_of

    sched, rid_of = fresh_sched(range(N), flaky_head)
    detected: list[int] = []
    restored_step = None
    resubmitted = 0
    while sched.queue:
        worker = box["batch"] % 2
        try:
            completed = sched.step()
        except WorkerDied:
            # the dead worker stops beating; the survivor keeps beating while
            # the monitor's timeout runs down on the virtual clock
            survivor = 1 - worker
            while not mon.dead_workers():
                clock.advance(1.0)
                mon.beat(survivor)
            detected = mon.dead_workers()
            # restart: trust only the checkpoint (the in-flight batch and the
            # dead worker's queue are gone); resubmit everything not done
            ckpt.wait()
            latest = ckpt.latest_step()
            restored_step = latest
            if latest is not None:
                state = ckpt.restore(latest,
                                     {"done": np.zeros((N,), np.bool_)})
                known_done = np.asarray(state["done"], np.bool_)
            else:
                known_done = np.zeros((N,), np.bool_)
            todo = [rid for rid in range(N) if not known_done[rid]]
            resubmitted = len(todo)
            sched, rid_of = fresh_sched(todo, head)
            continue
        box["batch"] += 1
        mon.beat(worker)
        mon.beat(1 - worker)
        clock.advance(0.25)
        for r in completed:
            rid = rid_of[r.rid]
            if rid in delivered:
                duplicates += 1
            delivered[rid] = r.result
            done_mask[rid] = True
        ckpt.save(box["batch"], {"done": done_mask.copy()})
    ckpt.wait()

    ora = oracle_check(spec, hmm, work.payloads, delivered)
    kill_worker = kill_batch % 2
    ok = (detected == [kill_worker] and len(delivered) == N
          and duplicates == 0 and ora["ok"])
    return {"drill": "worker_death", "ok": ok,
            "killed_batch": kill_batch, "killed_worker": kill_worker,
            "detected_dead": detected,
            "detected_at_s": clock.now(),
            "restored_from_step": restored_step,
            "resubmitted": resubmitted,
            "delivered": len(delivered), "expected": N,
            "duplicates": duplicates, "oracle": ora}


def _mesh_rescale_rank(device, cfg: LoadConfig, to_devices: int) -> dict:
    """One rank of the rescale drill's world (see `drill_mesh_rescale`)."""
    from ..checkpointing.elastic import abstract_target_mesh, plan_rescale
    from ..core.mesh import Mesh, PartitionSpec
    from .mesh import world_rank, world_size

    from_devices = world_size()
    cfg = dataclasses.replace(cfg, stream_frac=0.0, device=str(device))
    work = make_workload(cfg)
    spec, _ = resolve_spec(cfg)
    hmm = work.hmm
    # every rank builds both meshes: every rank of the world makes each
    # mesh's subgroups
    mesh_from = Mesh((from_devices,), ("data",))
    mesh_to = Mesh((to_devices,), ("data",), ranks=range(to_devices))
    head_from = make_alignment_head(hmm.log_pi, hmm.log_A, spec,
                                    mesh=mesh_from, device=device)

    N = cfg.requests
    delivered: dict[int, tuple] = {}
    duplicates = 0

    def deliver(completed, rid_of):
        nonlocal duplicates
        for r in completed:
            rid = rid_of[r.rid]
            if rid in delivered:
                duplicates += 1
            delivered[rid] = r.result

    # phase 1: decode on the wide mesh until half the requests are out
    sched = BatchScheduler(head_from, max_batch=cfg.max_batch,
                           buckets=cfg.buckets)
    rid_of = {sched.submit(work.payloads[rid]).rid: rid for rid in range(N)}
    while sched.queue and len(delivered) < N // 2:
        deliver(sched.step(), rid_of)
    phase1 = len(delivered)

    # plan the shrink against an abstract target before committing to it
    target = abstract_target_mesh((to_devices,), ("data",))
    bucket_shape = torch.empty((cfg.max_batch, max(cfg.buckets), cfg.states),
                               device="meta")
    problems = plan_rescale({"emissions": bucket_shape},
                            {"emissions": PartitionSpec("data")}, target)

    # probe: the same padded batch must decode bit-identically on both meshes
    bucket = max(cfg.buckets)
    probe_rids = list(range(min(cfg.max_batch, N)))
    lens = np.asarray([work.payloads[r].shape[0] for r in probe_rids],
                      np.int32)
    probe = np.zeros((len(probe_rids), bucket, cfg.states), np.float32)
    for i, r in enumerate(probe_rids):
        probe[i, :lens[i]] = work.payloads[r]
    pf, sf = head_from(probe, lens)
    if mesh_to.coord is None:
        # a shrunk-away worker: it leaves at the rescale
        return {"drill": "mesh_rescale", "left_at_rescale": True}
    head_to = make_alignment_head(hmm.log_pi, hmm.log_A, spec, mesh=mesh_to,
                                  device=device)
    pt, st_ = head_to(probe, lens)
    probe_identical = (torch.equal(pf, pt) and
                       sf.cpu().numpy().tobytes() == st_.cpu().numpy().tobytes())

    # phase 2: migrate the live queue onto the shrunken mesh and drain
    pending = list(sched.queue)
    sched.queue.clear()
    sched2 = BatchScheduler(head_to, max_batch=cfg.max_batch,
                            buckets=cfg.buckets)
    rid_of2 = {sched2.submit(old.payload).rid: rid_of[old.rid]
               for old in pending}
    while sched2.queue:
        deliver(sched2.step(), rid_of2)
    if world_rank():
        return {"drill": "mesh_rescale", "left_at_rescale": False}

    ora = oracle_check(spec, hmm, work.payloads, delivered)
    ok = (not problems and probe_identical and len(delivered) == N
          and duplicates == 0 and ora["ok"])
    return {"drill": "mesh_rescale", "ok": ok,
            "mesh": {"from": from_devices, "to": to_devices},
            "rescale_plan_problems": problems,
            "probe_bit_identical": probe_identical,
            "delivered_before_rescale": phase1,
            "delivered": len(delivered), "expected": N,
            "duplicates": duplicates, "oracle": ora}


def drill_mesh_rescale(cfg: LoadConfig, *, from_devices: int = 4,
                       to_devices: int = 2) -> dict:
    """Drill 2: shrink the data mesh under load, bit-identical across it.

    Runs in a spawned world of `from_devices` ranks (gloo; on a one-card
    host every rank shares the card).  The first half of the trace decodes
    sharded over the whole world's data mesh.  The rescale is then *planned*
    against an ``abstract_target_mesh`` (the login-host guard: no process
    touched), the ranks past `to_devices` leave, as shrunk-away workers do,
    and the live queue migrates to a fresh scheduler on the mesh of the
    first `to_devices` ranks, where the rest drains.  A probe batch decoded
    on both meshes pins bit-identity across the boundary; the oracle covers
    every request from both phases.  Returns rank 0's report.
    """
    from .mesh import run_spmd
    return run_spmd(_mesh_rescale_rank, from_devices, device=cfg.device,
                    args=(cfg, to_devices))


def drill_budget_shrink(cfg: LoadConfig, *, big_kb: float = 64.0,
                        small_kb: float = 2.0) -> dict:
    """Drill 3: the memory budget shrinks mid-run; the ladder must engage.

    Phase 1 plans against ``big_kb`` (expected: an exact FLASH rung), serves
    half the trace, then the budget shrinks to ``small_kb`` and the planner
    re-plans (the downgrade ladder must pick a smaller-footprint spec whose
    reported state bytes stay under the new budget), and the rest of the
    trace serves on the downgraded spec.  Each phase's deliveries are checked
    against that phase's own spec oracle (phase 1 also against the optimal
    numpy score, being exact).
    """
    cfg = dataclasses.replace(cfg, stream_frac=0.0)
    work = make_workload(cfg)
    hmm = work.hmm
    K, Tmax = cfg.states, max(cfg.buckets)
    budgets = {"big": int(big_kb * 1024), "small": int(small_kb * 1024)}
    plan1 = plan(K, Tmax, ResourceBudget(memory_bytes=budgets["big"]),
                 batch=cfg.max_batch)
    plan2 = plan(K, Tmax, ResourceBudget(memory_bytes=budgets["small"]),
                 batch=cfg.max_batch)

    N = cfg.requests
    phases = {"big": list(range(N // 2)), "small": list(range(N // 2, N))}
    delivered_total = 0
    duplicates = 0
    oracles = {}
    for name, p in (("big", plan1), ("small", plan2)):
        head = make_alignment_head(hmm.log_pi, hmm.log_A, p.spec,
                                   device=hmm.log_A.device)
        sched = BatchScheduler(head, max_batch=cfg.max_batch,
                               buckets=cfg.buckets)
        rid_of = {}
        for rid in phases[name]:
            req = sched.submit(work.payloads[rid])
            rid_of[req.rid] = rid
        results: dict[int, tuple] = {}
        while sched.queue:
            for r in sched.step():
                rid = rid_of[r.rid]
                if rid in results:
                    duplicates += 1
                results[rid] = r.result
        delivered_total += len(results)
        payloads = {r: work.payloads[r] for r in results}
        oracles[name] = oracle_check(p.spec, hmm, payloads, results)

    footprint2 = spec_state_bytes(plan2.spec, K, Tmax) * cfg.max_batch
    downgraded = (plan2.spec != plan1.spec
                  and plan2.state_bytes < plan1.state_bytes)
    under_budget = footprint2 <= budgets["small"]
    ok = (downgraded and under_budget and delivered_total == N
          and duplicates == 0 and oracles["big"]["ok"]
          and oracles["small"]["ok"] and oracles["big"]["exact"])
    return {"drill": "budget_shrink", "ok": ok,
            "budgets_bytes": budgets,
            "plans": {name: {"spec": repr(p.spec), "why": p.why,
                             "state_bytes": p.state_bytes}
                      for name, p in (("big", plan1), ("small", plan2))},
            "downgraded": downgraded,
            "footprint_after_shrink_bytes": footprint2,
            "under_budget": under_budget,
            "delivered": delivered_total, "expected": N,
            "duplicates": duplicates, "oracle": oracles}


DRILLS = {"worker_death": drill_worker_death,
          "mesh_rescale": drill_mesh_rescale,
          "budget_shrink": drill_budget_shrink}


def run_drill(name: str, cfg: LoadConfig) -> dict:
    return DRILLS[name](cfg)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--states", type=int, default=32)
    ap.add_argument("--stream-frac", type=float, default=0.25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--method", default="flash")
    ap.add_argument("--budget-kb", type=float, default=None,
                    help="plan the offline spec from a memory budget "
                         "(the serve.py --budget-kb path, under load)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--no-oracle", action="store_true",
                    help="skip the reference-oracle pass (pure perf run)")
    ap.add_argument("--drill", choices=["none", "all", *DRILLS],
                    default="none")
    ap.add_argument("--inflight", action="store_true",
                    help="run the inflight-vs-bucketed streaming comparison "
                         "instead of the mixed harness; writes --inflight-out")
    ap.add_argument("--inflight-slots", type=int, default=64)
    ap.add_argument("--interarrival-us", type=float, default=None,
                    help="override mean interarrival (microseconds): drive "
                         "this down to pile up concurrent sessions")
    ap.add_argument("--device", default=None,
                    help="where to decode (default: cuda; cpu for a run "
                         "without a GPU)")
    ap.add_argument("--inflight-out", default=DEFAULT_INFLIGHT_OUT)
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    overrides = {}
    if args.interarrival_us is not None:
        overrides["mean_interarrival_s"] = args.interarrival_us * 1e-6
    cfg = LoadConfig(seed=args.seed, requests=args.requests,
                     states=args.states, stream_frac=args.stream_frac,
                     method=args.method, budget_kb=args.budget_kb,
                     max_batch=args.max_batch,
                     check_oracle=not args.no_oracle,
                     inflight_slots=args.inflight_slots,
                     device=str(resolve_device(args.device)), **overrides)

    if args.inflight:
        report = run_inflight_compare(cfg)
        p99 = report["p99_completion_s"]
        print(f"inflight compare: {cfg.requests} streaming sessions, peak "
              f"concurrency {report['peak_concurrent_sessions']}, "
              f"{cfg.inflight_slots} slots, on {report['device']}")
        print(f"  p99 completion: bucketed {p99['bucketed'] * 1e3:.1f}ms vs "
              f"inflight {p99['inflight'] * 1e3:.1f}ms "
              f"(speedup {p99['speedup']:.2f}x, "
              f"win={report['p99_completion_win']})")
        print(f"  oracle ok={report['oracle_ok']}, slot-step launches "
              f"{report['inflight']['slot_step']}, "
              f"retraces={report['retraces']} (None: not measured, no "
              f"kernel launches on the CPU)")
        os.makedirs(os.path.dirname(args.inflight_out) or ".", exist_ok=True)
        with open(args.inflight_out, "w") as f:
            json.dump(report, f, indent=2, default=str)
        print(f"  wrote {args.inflight_out}")
        if not report["oracle_ok"] or report["retraces"]:
            raise SystemExit(1)
        return report

    harness = LoadHarness(cfg)
    report = harness.run()

    tp, lat = report["throughput"], report["latency_s"]
    off = lat["offline"] or {"p50": float("nan"), "p99": float("nan")}
    print(f"loadtest: {report['requests']['delivered']}/{cfg.requests} "
          f"requests ({report['requests']['stream']} streaming) on "
          f"{report['device']} in {tp['elapsed_s']:.2f}s virtual: "
          f"{tp['requests_per_s']:.1f} req/s, {tp['frames_per_s']:.0f} "
          f"frames/s")
    print(f"  offline latency p50={off['p50'] * 1e3:.1f}ms "
          f"p99={off['p99'] * 1e3:.1f}ms; "
          f"batches={report['scheduler']['batches']}, "
          f"pad frac={report['scheduler']['mean_pad_frac']:.2f}")
    failed = False
    if "oracle" in report:
        print(f"  oracle: offline {report['oracle']['offline']['checked']} "
              f"checked, stream {report['oracle']['stream']['checked']} "
              f"checked, ok={report['oracle']['ok']}")
        failed |= not report["oracle"]["ok"]

    if args.drill != "none":
        names = list(DRILLS) if args.drill == "all" else [args.drill]
        report["drills"] = {}
        for name in names:
            d = run_drill(name, cfg)
            report["drills"][name] = d
            print(f"  drill {name}: {'ok' if d['ok'] else 'FAIL'}")
            failed |= not d["ok"]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2, default=str)
    print(f"  wrote {args.out}")
    if failed:
        raise SystemExit(1)
    return report


if __name__ == "__main__":
    main()
