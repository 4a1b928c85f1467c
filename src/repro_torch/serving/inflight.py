"""Continuous inflight batching, as in `repro.serving.inflight`: a
slot-based streaming serving tier.

`StreamMux` buckets sessions by block size, so a session joining mid-flight
waits for its bucket and every session pays its own kernel launch.  This
module is the continuous-batching alternative: an `InflightScheduler` owns a
fixed pool of `max_slots` decode slots backed by **one** persistent batched
DP state on the device, and every `step()` advances all live slots by up to
one block with a single launch of the forward kernel
(`kernels.ops.viterbi_slot_step`).

Sessions attach to a free slot at any block boundary and detach on finish.
The trick that makes join/leave free is the tropical identity: a slot with
`nfeed == 0` runs its whole block as identity steps (delta bit-identical,
psi rows the identity permutation), and a joining session's slot is re-seeded
by a `fresh` mask just before the launch, so every launch has the same shape
`(S, block, K)` for the scheduler's lifetime, whatever joins or leaves.

Correctness is inherited, not re-proven: each slot's backpointer rows feed a
`core.online.SlotViterbiDecoder` (the same convergence-commit / forced-flush
algebra as `OnlineViterbiDecoder`), and the batched kernel is bit-identical
per sequence to the single-sequence one, so every delivered path is
bit-identical to the looped unbatched `spec.run` oracle:

  * exact sessions (`max_lag=None`) may advance at any granularity —
    convergence commits are feed-boundary-independent;
  * bounded-lag sessions advance only in full `block`-sized feeds (plus the
    sub-block remainder at finish), replicating the forced-flush boundaries
    of `OnlineSpec(stream_chunk=block, max_lag=L).run` exactly.

Admission control runs against `core.spec.ResourceBudget`: each session is
costed at its worst-case window (`planner.online_session_bytes`) and, when
the remaining budget is short, degraded down the commit-lag ladder
(`planner.plan_admission`) before being queued; a session that cannot fit
the *total* budget even at the tightest rung is rejected outright.  The
queue is strict priority + FIFO within a class (head-of-line by design: a
queued head is never leapfrogged).

    sched = InflightScheduler(hmm.log_pi, hmm.log_A, max_slots=64, block=16)
    sid = sched.submit()
    sched.feed(sid, frames); sched.pump()
    prefix = sched.collect(sid)          # newly-final states, exactly once
    path, score = sched.finish(sid)      # full decode, frees the slot

The pool's delta lives on ``device`` (None means ``cuda``); each step moves
the staged block to the device and the psi rows back, one transfer each.
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.hmm import NEG_INF
from ..core.online import OnlineViterbiDecoder, SlotViterbiDecoder
from ..core.planner import (AdmissionPlan, inflight_state_bytes,
                            online_session_bytes, plan_admission)
from ..core.spec import OnlineSpec, ResourceBudget
from ..kernels.ops import viterbi_slot_step

__all__ = ["InflightScheduler", "AdmissionRejected"]


class AdmissionRejected(RuntimeError):
    """Session cannot fit the budget even at the tightest degradation rung."""


# ---------------------------------------------------------------------------
# The three device touch-points.  Joining and leaving sessions change only
# the contents of the fixed (S, block, K) staging arrays, so every step is
# one forward launch at the same shape.
# ---------------------------------------------------------------------------

def _inflight_step(log_pi, log_A, em0, fresh, em, delta, nfeed, *, bt=8):
    """One batched block advance over every slot.

    `fresh[s]` re-seeds slot s's delta row to `log_pi + em0[s]` (frame 0 of a
    newly-attached session) before the block runs; `nfeed[s]` in [0, block]
    counts the real emission rows of `em[s]`, the rest (and every row of a
    free slot, nfeed 0) run as tropical-identity steps.
    """
    delta = torch.where(fresh[:, None], log_pi[None, :] + em0, delta)
    return viterbi_slot_step(log_A, em, delta, nfeed, bt=bt)


def _slot_row(delta, slot: int) -> np.ndarray:
    """One slot's frontier delta row on the host (pulled only at flush /
    forced-flush)."""
    return delta[slot].cpu().numpy()


def _mask_slot(delta, slot: int, keep) -> None:
    """Suppress one slot's frontier hypotheses inconsistent with a forced
    commit (the f32 add of `OnlineViterbiDecoder`), in place."""
    row = delta[slot]
    # flashlint: disable=FL007(slot forced-commit suppression, mirrors OnlineViterbiDecoder's annotated seam)
    delta[slot] = torch.where(keep, row, row + 4.0 * NEG_INF)


def _pct(xs: list[float], q: float) -> float:
    if not xs:
        return float("nan")
    return float(np.percentile(np.asarray(xs, np.float64), q))


class _Session:
    """Book-keeping for one submitted decode (queued, live, or done)."""

    __slots__ = ("sid", "priority", "requested_lag", "max_lag", "plan",
                 "slot", "dec", "buf", "buffered", "pending", "draining",
                 "seeded", "frames_in", "final",
                 "t_submit", "t_attach", "t_first_commit", "t_finish")

    def __init__(self, sid: int, priority: int, requested_lag: int | None,
                 t_submit: float):
        self.sid = sid
        self.priority = priority
        self.requested_lag = requested_lag
        self.max_lag = requested_lag          # replanned at admission
        self.plan: AdmissionPlan | None = None
        self.slot: int | None = None
        self.dec: SlotViterbiDecoder | None = None
        self.buf: list[np.ndarray] = []
        self.buffered = 0
        self.pending: list[np.ndarray] = []
        self.draining = False
        self.seeded = False
        self.frames_in = 0
        self.final: tuple[np.ndarray, float] | None = None
        self.t_submit = t_submit
        self.t_attach: float | None = None
        self.t_first_commit: float | None = None
        self.t_finish: float | None = None

    def take(self, n: int) -> np.ndarray:
        pending = (self.buf[0] if len(self.buf) == 1
                   else np.concatenate(self.buf, axis=0))
        out, rest = pending[:n], pending[n:]
        self.buf = [rest] if rest.shape[0] else []
        self.buffered = int(rest.shape[0])
        return out


class InflightScheduler:
    """A fixed pool of decode slots over one persistent batched DP state.

    Args:
      log_pi, log_A: the shared model.
      max_slots: slot-pool size S — the batch dimension of the persistent
        state; fixed for the scheduler's lifetime.
      block: frames advanced per slot per `step()` (the jitted time extent).
      budget: `ResourceBudget` (or raw byte count) capping the projected
        live session bytes across slots; None = admit while slots last.
      horizon: worst-case frames per session — bounds the exact decoder's
        commit window for admission costing, and `feed` enforces it.
      default_max_lag: `max_lag` for sessions that don't request their own.
      bt: kept for parity with the TPU kernel's time tile; no effect here.
      clock: monotonic-seconds source for SLO records (injectable in tests).
      device: where the model and the pool's delta live (None: ``cuda``).
    """

    def __init__(self, log_pi, log_A, *, max_slots: int = 8, block: int = 16,
                 budget: ResourceBudget | int | None = None,
                 horizon: int = 4096, default_max_lag: int | None = None,
                 bt: int = 8, clock=time.monotonic, device=None):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        self.device = resolve_device(device)
        self.log_pi = torch.as_tensor(log_pi, dtype=torch.float32).to(
            self.device)
        self.log_A = torch.as_tensor(log_A, dtype=torch.float32).to(
            self.device).contiguous()
        self.K = int(self.log_A.shape[0])
        self.max_slots = int(max_slots)
        self.block = int(block)
        self.horizon = int(horizon)
        self.default_max_lag = default_max_lag
        self.bt = int(bt)
        if isinstance(budget, int):
            budget = ResourceBudget(memory_bytes=budget)
        self.budget = budget or ResourceBudget()
        self._clock = clock

        S, K, B = self.max_slots, self.K, self.block
        self._delta = torch.zeros((S, K), device=self.device)  # DP carry
        self._em = np.zeros((S, B, K), np.float32)     # host staging, reused
        self._em0 = np.zeros((S, K), np.float32)
        self._fresh = np.zeros((S,), bool)
        self._nfeed = np.zeros((S,), np.int32)

        self._sessions: dict[int, _Session] = {}
        self._queue: list[_Session] = []               # arrival order
        self._free: list[int] = list(range(S - 1, -1, -1))
        self._admitted_bytes = 0
        self._ids = itertools.count()
        self._step_s: list[float] = []
        self.stats = {"opened": 0, "finished": 0, "steps": 0, "frames": 0,
                      "commits": 0, "degraded": 0, "queued_peak": 0,
                      "overflow_finishes": 0, "rejected": 0}

    # -- admission ----------------------------------------------------------
    def _remaining_bytes(self) -> int | None:
        cap = self.budget.memory_bytes
        return None if cap is None else cap - self._admitted_bytes

    def submit(self, *, max_lag: int | None | str = "default",
               priority: int = 0) -> int:
        """Open a session; admit it to a slot or queue it (FIFO per class).

        Raises `AdmissionRejected` when the session cannot fit the *total*
        budget even fully degraded — queueing it could never succeed.
        """
        requested = (self.default_max_lag if max_lag == "default"
                     else max_lag)
        cap = self.budget.memory_bytes
        if cap is not None and plan_admission(
                self.K, self.block, cap, requested_lag=requested,
                horizon=self.horizon) is None:
            self.stats["rejected"] += 1
            raise AdmissionRejected(
                f"session (max_lag={requested}) needs "
                f"{online_session_bytes(self.K, self.block, max_lag=8):,}B "
                f"even at the tightest ladder rung; total budget is {cap:,}B")
        sid = next(self._ids)
        sess = _Session(sid, int(priority), requested, self._clock())
        self._sessions[sid] = sess
        self.stats["opened"] += 1
        if not self._queue and self._free:
            plan = plan_admission(self.K, self.block, self._remaining_bytes(),
                                  requested_lag=requested,
                                  horizon=self.horizon)
            if plan is not None:
                self._attach(sess, plan)
                return sid
        self._queue.append(sess)
        self.stats["queued_peak"] = max(self.stats["queued_peak"],
                                        len(self._queue))
        return sid

    def _attach(self, sess: _Session, plan: AdmissionPlan) -> None:
        slot = self._free.pop()
        sess.slot = slot
        sess.plan = plan
        sess.max_lag = plan.max_lag
        if plan.degraded:
            self.stats["degraded"] += 1
        sess.dec = SlotViterbiDecoder(
            self.K, max_lag=plan.max_lag,
            frontier=lambda s=slot: _slot_row(self._delta, s),
            mask_scores=lambda keep, s=slot: self._apply_mask(s, keep))
        self._admitted_bytes += plan.state_bytes
        sess.t_attach = self._clock()

    def _apply_mask(self, slot: int, keep: np.ndarray) -> None:
        _mask_slot(self._delta, slot,
                   torch.from_numpy(keep).to(self.device))

    def _drain_queue(self) -> None:
        # strict head-of-line: the best (priority, arrival) head either
        # fits (possibly degraded) or blocks the queue — FIFO within a
        # class is never violated by leapfrogging a smaller session.
        while self._queue and self._free:
            head = min(self._queue, key=lambda s: s.priority)  # stable: FIFO
            plan = plan_admission(self.K, self.block,
                                  self._remaining_bytes(),
                                  requested_lag=head.requested_lag,
                                  horizon=self.horizon)
            if plan is None:
                return
            self._queue.remove(head)
            self._attach(head, plan)

    # -- session I/O --------------------------------------------------------
    def _get(self, sid: int) -> _Session:
        try:
            return self._sessions[sid]
        except KeyError:
            raise KeyError(f"unknown session {sid}") from None

    def feed(self, sid: int, frames) -> dict:
        """Buffer (C, K) frames for a session (queued sessions buffer too).

        Buffering never advances the DP — call `pump()` (or `step()`) to run
        ready blocks; `collect(sid)` drains what became final.
        """
        sess = self._get(sid)
        if sess.final is not None:
            raise RuntimeError(f"session {sid} already finished")
        frames = np.asarray(frames, np.float32)
        if frames.ndim != 2 or frames.shape[1] != self.K:
            raise ValueError(f"expected (C, K={self.K}) frames, "
                             f"got {frames.shape}")
        if sess.frames_in + frames.shape[0] > self.horizon:
            raise ValueError(
                f"session {sid} exceeds horizon={self.horizon} frames "
                f"({sess.frames_in} fed + {frames.shape[0]} new); admission "
                f"costing is only sound up to the horizon")
        if frames.shape[0]:
            sess.buf.append(frames)
            sess.buffered += int(frames.shape[0])
            sess.frames_in += int(frames.shape[0])
        return {"buffered": sess.buffered, "queued": sess.slot is None,
                "lag": self.lag(sid)}

    def collect(self, sid: int) -> np.ndarray:
        """Drain this session's newly-final states (exactly-once delivery)."""
        sess = self._get(sid)
        if not sess.pending:
            return np.zeros((0,), np.int32)
        out = (sess.pending[0] if len(sess.pending) == 1
               else np.concatenate(sess.pending))
        sess.pending = []
        return out

    def lag(self, sid: int) -> int:
        """Fed-but-uncommitted frames (decoder window + feed buffer)."""
        sess = self._get(sid)
        dec_lag = sess.dec.lag if sess.dec is not None else 0
        return dec_lag + sess.buffered

    def n_committed(self, sid: int) -> int:
        sess = self._get(sid)
        return sess.dec.n_committed if sess.dec is not None else 0

    def session_spec(self, sid: int) -> OnlineSpec:
        """The `OnlineSpec` whose looped `run` this session is bit-identical
        to: the differential-oracle hook."""
        sess = self._get(sid)
        return OnlineSpec(stream_chunk=self.block, max_lag=sess.max_lag)

    # -- the batched advance ------------------------------------------------
    def _consume_now(self, sess: _Session) -> int:
        """Frames this slot eats in the next step (0 = sit out as identity).

        Exact sessions advance greedily (commits are feed-boundary
        independent); bounded-lag sessions only ever advance in full
        `block`-sized feeds — plus the sub-block remainder while draining —
        so their forced-flush boundaries replicate the oracle's.
        """
        b = sess.buffered
        if not b or sess.slot is None or sess.final is not None:
            return 0
        if sess.max_lag is None:
            # fresh slot: +1 because the seed frame costs no kernel row
            return min(b, self.block + (0 if sess.seeded else 1))
        # bounded-lag: consume in the oracle's chunk units — exactly `block`
        # frames per feed (the seed frame counts toward the first chunk),
        # sub-block remainder only as the final feed while draining
        if b >= self.block:
            return self.block
        return b if sess.draining else 0

    def step(self) -> dict:
        """Advance every ready slot by up to one block: one kernel call.

        Slots with nothing ready ride along as tropical-identity steps —
        their delta comes back bit-identical.  Returns counters.
        """
        plans: list[tuple[_Session, int]] = []
        for sess in self._sessions.values():
            c = self._consume_now(sess)
            if c:
                plans.append((sess, c))
        if not plans:
            return {"advanced": 0, "frames": 0, "committed": 0}
        t0 = self._clock()
        for sess, c in plans:
            s = sess.slot
            frames = sess.take(c)
            if not sess.seeded:
                self._em0[s] = frames[0]
                self._fresh[s] = True
                rows = frames[1:]
            else:
                rows = frames
            n = int(rows.shape[0])
            if n:
                self._em[s, :n] = rows
            self._nfeed[s] = n
        dev = self.device
        psi, self._delta = _inflight_step(
            self.log_pi, self.log_A, torch.from_numpy(self._em0).to(dev),
            torch.from_numpy(self._fresh).to(dev),
            torch.from_numpy(self._em).to(dev), self._delta,
            torch.from_numpy(self._nfeed).to(dev), bt=self.bt)
        psi_np = psi.cpu().numpy()        # one batched transfer per step
        frames_run = 0
        committed = 0
        for sess, c in plans:
            s = sess.slot
            if not sess.seeded:
                sess.seeded = True
                sess.dec.seed()
                self._fresh[s] = False
            n = int(self._nfeed[s])
            self._nfeed[s] = 0
            frames_run += c
            if n:
                out = sess.dec.ingest(psi_np[s, :n])
                if out.shape[0]:
                    sess.pending.append(out)
                    committed += int(out.shape[0])
                    if sess.t_first_commit is None:
                        sess.t_first_commit = self._clock()
        self._step_s.append(self._clock() - t0)
        self.stats["steps"] += 1
        self.stats["frames"] += frames_run
        self.stats["commits"] += committed
        return {"advanced": len(plans), "frames": frames_run,
                "committed": committed}

    def pump(self) -> int:
        """Step while any live slot has a full block buffered; returns steps."""
        n = 0
        while any(s.slot is not None and s.final is None
                  and s.buffered >= self.block
                  for s in self._sessions.values()):
            self.step()
            n += 1
        return n

    # -- finish / detach ----------------------------------------------------
    def finish(self, sid: int) -> tuple[np.ndarray, float]:
        """Drain, flush, detach; returns (full path, score).  Idempotent.

        A session finished while still *queued* (budget held it out of the
        pool the whole time) is decoded on the spot with its own unbatched
        streaming decoder — same algorithm, same oracle — so the tier stays
        live under overload; counted in `stats["overflow_finishes"]`.
        """
        sess = self._get(sid)
        if sess.final is not None:
            return sess.final
        if sess.slot is None:
            return self._overflow_finish(sess)
        sess.draining = True
        while sess.buffered:
            self.step()
        tail, score = sess.dec.flush()
        if tail.shape[0]:
            sess.pending.append(tail)
        sess.final = (sess.dec.path, score)
        self._detach(sess)
        return sess.final

    def _overflow_finish(self, sess: _Session) -> tuple[np.ndarray, float]:
        self._queue.remove(sess)
        dec = OnlineViterbiDecoder(self.log_pi, self.log_A,
                                   max_lag=sess.requested_lag, bt=self.bt)
        frames = (np.concatenate(sess.buf, axis=0) if sess.buf
                  else np.zeros((0, self.K), np.float32))
        sess.buf, sess.buffered = [], 0
        out: list[np.ndarray] = []
        for i in range(0, frames.shape[0], self.block):
            out.append(dec.feed(frames[i:i + self.block]))
        tail, score = dec.flush()
        out.append(tail)
        seg = np.concatenate(out) if out else np.zeros((0,), np.int32)
        if seg.shape[0]:
            sess.pending.append(seg)
        sess.final = (dec.path, score)
        sess.t_finish = self._clock()
        self.stats["finished"] += 1
        self.stats["overflow_finishes"] += 1
        return sess.final

    def _detach(self, sess: _Session) -> None:
        self._free.append(sess.slot)
        self._admitted_bytes -= sess.plan.state_bytes
        sess.slot = None
        sess.t_finish = self._clock()
        self.stats["finished"] += 1
        self._drain_queue()

    # -- observability ------------------------------------------------------
    def live_sessions(self) -> list[int]:
        return [s.sid for s in self._sessions.values()
                if s.slot is not None and s.final is None]

    def queued_sessions(self) -> list[int]:
        return [s.sid for s in self._queue]

    def admitted_bytes(self) -> int:
        """Projected worst-case bytes of the currently-admitted sessions
        (the quantity admission control holds under the budget)."""
        return self._admitted_bytes

    def live_state_bytes(self) -> int:
        """Actual live host-side bytes right now: decoder windows + buffers."""
        total = 0
        for s in self._sessions.values():
            if s.slot is not None and s.final is None:
                total += s.dec.live_state_bytes() + s.buffered * self.K * 4
        return total

    def device_state_bytes(self) -> int:
        """Fixed device-side footprint of the slot pool."""
        return inflight_state_bytes(self.K, self.block, self.max_slots)

    def slo_report(self) -> dict:
        """Per-step and per-session service-level metrics.

        block latency = wall seconds per `step()` (kernel + commit scan);
        commit lag = fed-but-unfinal frames (peak per session).
        """
        done = [s for s in self._sessions.values() if s.final is not None]
        q_wait = [s.t_attach - s.t_submit for s in done
                  if s.t_attach is not None]
        first = [s.t_first_commit - s.t_submit for s in done
                 if s.t_first_commit is not None]
        comp = [s.t_finish - s.t_submit for s in done
                if s.t_finish is not None]
        peak_lag = [s.dec.stats["peak_lag"] for s in done if s.dec is not None]
        forced = sum(s.dec.stats["forced"] for s in done if s.dec is not None)
        return {
            "block_latency_s": {"count": len(self._step_s),
                                "p50": _pct(self._step_s, 50),
                                "p99": _pct(self._step_s, 99)},
            "queue_wait_s": {"p50": _pct(q_wait, 50), "p99": _pct(q_wait, 99)},
            "first_commit_s": {"p50": _pct(first, 50), "p99": _pct(first, 99)},
            "completion_s": {"p50": _pct(comp, 50), "p99": _pct(comp, 99)},
            "commit_lag": {"peak_p50": _pct([float(x) for x in peak_lag], 50),
                           "peak_p99": _pct([float(x) for x in peak_lag], 99),
                           "forced_flushes": int(forced)},
            "stats": dict(self.stats),
        }
