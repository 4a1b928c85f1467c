"""Streaming decode sessions, as in `repro.serving.stream`: the serving
face of the online Viterbi subsystem.

``StreamSession`` wraps one live decode (frames go in, committed path
prefixes come out as soon as they are final) and ``StreamMux`` multiplexes
many concurrent sessions the way ``BatchScheduler`` multiplexes offline
requests: sessions are grouped by their *block size* (the bucket), frames are
buffered per session, and the DP only ever advances in whole blocks, so each
kernel launch of a bucket has one shape instead of one per ragged arrival.
Leftover frames shorter than a block run once, at ``finish()``.

    mux = StreamMux(hmm.log_pi, hmm.log_A, cfg=StreamConfig(max_lag=64))
    sid = mux.open(block=128)
    out = mux.feed(sid, frames)          # {"committed": (n,) int32, ...}
    path, score = mux.finish(sid)

Frames are host (numpy) data; the model lives on ``device`` (None means
``cuda``, which raises without a GPU), where each block runs.
"""

from __future__ import annotations

import dataclasses
import itertools
import time

import numpy as np

import torch

from ..core.device import resolve_device
from ..core.spec import OnlineBeamSpec, OnlineSpec, as_decode_spec


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Per-deployment resource profile for streaming decode.

    method "online" is exact (O(W*K) live state, W the convergence window);
    "online_beam" caps live state at O(W*B) independent of K.  ``max_lag``
    bounds commit latency (and W) at the cost of exactness on forced steps.

    Legacy string form; sessions also accept an `OnlineSpec` /
    `OnlineBeamSpec` directly (`to_spec()` is the conversion).
    """
    method: str = "online"            # online | online_beam
    beam_width: int = 128
    kchunk: int = 128                 # K-chunking of the beam transition
    max_lag: int | None = None

    def to_spec(self):
        if self.method == "online":
            return OnlineSpec(max_lag=self.max_lag)
        if self.method == "online_beam":
            return OnlineBeamSpec(beam_width=self.beam_width,
                                  kchunk=self.kchunk, max_lag=self.max_lag)
        raise ValueError(f"unknown stream method {self.method!r}")


def _on(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(device)


def _make_decoder(log_pi, log_A, cfg, device: torch.device):
    spec = as_decode_spec(cfg)
    if not isinstance(spec, (OnlineSpec, OnlineBeamSpec)):
        raise ValueError(f"streaming needs OnlineSpec/OnlineBeamSpec, "
                         f"got {type(spec).__name__}")
    return spec.make_streaming(_on(log_pi, device), _on(log_A, device))


class StreamSession:
    """One live decode: ``feed(chunk) -> committed_prefix``.

    Frames are buffered and the DP advances in fixed ``block``-sized chunks
    (one launch shape per block size); anything still buffered is drained by
    ``finish()``.  ``device=None`` means ``cuda``.
    """

    def __init__(self, log_pi, log_A, cfg: StreamConfig = StreamConfig(),
                 *, block: int = 128, sid: int = 0, device=None):
        self.sid = sid
        self.block = int(block)
        self.cfg = cfg
        self.decoder = _make_decoder(log_pi, log_A, cfg,
                                     resolve_device(device))
        self._buf: list[np.ndarray] = []
        self._buffered = 0
        self._final: tuple[np.ndarray, float] | None = None
        self.opened = time.monotonic()
        self.first_commit_s: float | None = None
        self.frames_in = 0

    def feed(self, frames) -> np.ndarray:
        """Buffer (C, K) frames; run whole blocks; return newly-final states."""
        if self._final is not None:
            raise RuntimeError(
                f"session {self.sid} already finished; open a new one")
        frames = np.asarray(frames, dtype=np.float32)
        if frames.ndim != 2:
            raise ValueError(f"expected (C, K) frames, got {frames.shape}")
        self.frames_in += frames.shape[0]
        self._buf.append(frames)
        self._buffered += frames.shape[0]
        out: list[np.ndarray] = []
        if self._buffered >= self.block:
            pending = np.concatenate(self._buf, axis=0)
            n_blocks = pending.shape[0] // self.block
            for i in range(n_blocks):
                out.append(self.decoder.feed(
                    pending[i * self.block:(i + 1) * self.block]))
            rest = pending[n_blocks * self.block:]
            self._buf = [rest] if rest.shape[0] else []
            self._buffered = rest.shape[0]
        committed = (np.concatenate(out) if out
                     else np.zeros((0,), np.int32))
        if committed.shape[0] and self.first_commit_s is None:
            self.first_commit_s = time.monotonic() - self.opened
        return committed

    def finish(self) -> tuple[np.ndarray, float]:
        """Drain the buffer, flush the decoder; returns (full path, score).

        Idempotent: a second ``finish()`` returns the same result instead of
        re-flushing a dead decoder.
        """
        if self._final is None:
            if self._buffered:
                self.decoder.feed(np.concatenate(self._buf, axis=0))
                self._buf, self._buffered = [], 0
            self.decoder.flush()
            self._final = (self.decoder.path, self.decoder.score)
        return self._final

    @property
    def lag(self) -> int:
        return self.decoder.lag + self._buffered

    def live_state_bytes(self) -> int:
        """Live bytes held for this session: decoder window + feed buffer.

        The buffered frames are as live as the DP window — leaving them out
        under-reports pressure (and made the metric sit flat while sub-block
        feeds accumulated), which is exactly what an admission controller
        must not see.
        """
        return (self.decoder.live_state_bytes()
                + self._buffered * self.decoder.K * 4)


class StreamMux:
    """Many concurrent ``StreamSession``s over one shared model.

    The ``BatchScheduler`` idea applied to streams: sessions are bucketed by
    block size so every session in a bucket launches its chunk step at the
    same shape.  (State stays per-session: streaming DP carries are
    stateful, so the win is shape bucketing, not cross-session batching.)

    Bucketing has head-of-line blocking baked in: a session joining
    mid-flight buffers until its bucket's block fills.  Pass ``inflight=``
    (an `serving.inflight.InflightScheduler`) and exact/lagged ``"online"``
    sessions are routed straight into the continuous-batching tier instead:
    served within one *block* of arrival, one batched kernel launch per step
    regardless of how many sessions are live.  ``"online_beam"`` sessions
    (and everything when no scheduler is configured) keep the bucketing
    path.  The model is placed on ``device`` once (None means ``cuda``).
    """

    def __init__(self, log_pi, log_A, cfg: StreamConfig = StreamConfig(),
                 blocks: tuple[int, ...] = (32, 128, 512),
                 inflight=None, device=None):
        self.device = resolve_device(device)
        self.log_pi = _on(log_pi, self.device)
        self.log_A = _on(log_A, self.device)
        self.cfg = cfg
        self.blocks = tuple(sorted(blocks))
        self.inflight = inflight
        self._routed: dict[int, int] = {}   # mux sid -> inflight sid
        self._sessions: dict[int, StreamSession] = {}
        self._ids = itertools.count()
        self.stats = {"opened": 0, "finished": 0, "frames": 0, "commits": 0,
                      "routed_inflight": 0}

    def _bucket(self, block: int) -> int:
        for b in self.blocks:
            if block <= b:
                return b
        return self.blocks[-1]

    def _route_inflight(self) -> bool:
        return (self.inflight is not None and self.cfg.method == "online")

    def open(self, block: int = 128) -> int:
        sid = next(self._ids)
        if self._route_inflight():
            self._routed[sid] = self.inflight.submit(max_lag=self.cfg.max_lag)
            self.stats["opened"] += 1
            self.stats["routed_inflight"] += 1
            return sid
        self._sessions[sid] = StreamSession(
            self.log_pi, self.log_A, self.cfg,
            block=self._bucket(block), sid=sid, device=self.device)
        self.stats["opened"] += 1
        return sid

    def _session(self, sid: int) -> StreamSession:
        try:
            return self._sessions[sid]
        except KeyError:
            raise KeyError(f"unknown or already-finished session {sid}"
                           ) from None

    def feed(self, sid: int, frames) -> dict:
        if sid in self._routed:
            isid = self._routed[sid]
            self.inflight.feed(isid, frames)
            self.inflight.pump()
            committed = self.inflight.collect(isid)
            self.stats["frames"] += int(np.asarray(frames).shape[0])
            self.stats["commits"] += int(committed.shape[0])
            return {"committed": committed, "lag": self.inflight.lag(isid),
                    "n_committed": self.inflight.n_committed(isid)}
        sess = self._session(sid)
        committed = sess.feed(frames)
        self.stats["frames"] += int(np.asarray(frames).shape[0])
        self.stats["commits"] += int(committed.shape[0])
        return {"committed": committed, "lag": sess.lag,
                "n_committed": sess.decoder.n_committed}

    def finish(self, sid: int) -> tuple[np.ndarray, float]:
        if sid in self._routed:
            isid = self._routed.pop(sid)
            self.stats["finished"] += 1
            return self.inflight.finish(isid)
        sess = self._session(sid)
        del self._sessions[sid]
        self.stats["finished"] += 1
        return sess.finish()

    def sessions_by_bucket(self) -> dict[int, list[int]]:
        out: dict[int, list[int]] = {b: [] for b in self.blocks}
        for sid, s in self._sessions.items():
            out[s.block].append(sid)
        return out

    def live_state_bytes(self) -> int:
        total = sum(s.live_state_bytes() for s in self._sessions.values())
        if self.inflight is not None:
            total += self.inflight.live_state_bytes()
        return total


__all__ = ["StreamConfig", "StreamSession", "StreamMux"]
