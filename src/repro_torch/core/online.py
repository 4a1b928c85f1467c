"""On-line (streaming) Viterbi decoding with convergence-point commitment, as
in `repro.core.online`.

Emissions arrive in chunks, and committed path prefixes are returned as soon
as they are provably final.  The backpointer maps psi_t : states(t) ->
states(t-1) compose; once the composition from the current frontier back to
some past time tau collapses to a single value, every surviving hypothesis
passes through that state, so the prefix up to tau is exact and can be
emitted and its backpointers freed (Sramek, Brejova & Vinar's On-line
Viterbi).

  * ``OnlineViterbiDecoder`` -- exact.  Each chunk's DP is one launch of the
    forward kernel at B = 1 (`kernels.ops.viterbi_chunk_step`).  With
    ``max_lag=None`` the assembled path is bit-identical to
    ``viterbi_vanilla``.
  * ``SlotViterbiDecoder`` -- the same commit algebra for a decode whose DP
    advance happens elsewhere (the inflight serving tier's slots).
  * ``OnlineBeamDecoder`` -- FLASH-BS's O(B) beam state made streaming.  Each
    chunk is one launch of the beam kernel's chunk mode
    (`kernels.beam_stream.bs_chunk_batch`), which returns every row's slot
    states and slot backpointers; the convergence check composes those, so
    live state is O(W * B), independent of K.

All support a bounded-lag forced flush: if the uncommitted window exceeds
``max_lag`` steps, the oldest states are committed along the currently-best
hypothesis, and hypotheses inconsistent with that commit are suppressed by
an f32 add of ``4 * NEG_INF`` to their scores.

The DP carry lives on the device of the model's tensors; the window of
backpointer rows and the committed path are host-side numpy, as in the JAX
package, and each chunk moves its new rows to the host in one transfer.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.beam_stream import bs_chunk_batch
from ..kernels.ops import viterbi_chunk_step
from .constraints import init_penalty, step_penalty_rows, transition_penalty
from .flash_bs import _SENTINEL
from .hmm import NEG_INF


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Shared window algebra (host-side numpy, copied from the JAX module)
# ---------------------------------------------------------------------------

def _latest_convergence(rows: list[np.ndarray], lo: int):
    """Latest row index i >= lo at which the pointer composition collapses.

    ``rows[i]`` maps identities at time base+i to identities at time base+i-1.
    Walking backward from the frontier, the first time the composed image is a
    single value is the *latest* convergence point (a collapsed composition
    stays collapsed further back).  Returns (i, value) or (None, None).
    """
    if len(rows) == 0:
        return None, None
    cur = np.arange(rows[-1].shape[0])
    for i in range(len(rows) - 1, -1, -1):
        cur = rows[i][cur]
        if i >= lo and (cur == cur[0]).all():
            return i, int(cur[0])
    return None, None


class _StreamingDecoder:
    """Commit/window bookkeeping shared by the exact and beam decoders.

    Subclasses provide the DP carry and the pointer rows; this base tracks the
    committed prefix, the window base time, lag statistics and forced flushes.
    Window row i always maps (state or slot) at absolute time ``_base + i`` to
    its predecessor at ``_base + i - 1``; committed states cover times
    ``0 .. n_committed - 1`` and ``_base == max(n_committed, 1)``.
    """

    def __init__(self, max_lag: int | None):
        if max_lag is not None and max_lag < 1:
            raise ValueError(f"max_lag must be >= 1, got {max_lag}")
        self.max_lag = max_lag
        self._committed: list[int] = []
        self._t = 0          # total timesteps fed
        self._base = 1
        self._finished = False
        self.score: float | None = None
        self.stats = {"feeds": 0, "commits": 0, "forced": 0, "peak_lag": 0}

    # -- subclass surface ---------------------------------------------------
    def _rows(self) -> list[np.ndarray]:
        raise NotImplementedError

    def _drop_rows(self, n: int) -> None:
        raise NotImplementedError

    def _frontier_best(self) -> tuple[int, float]:
        """(identity at time t-1 of the best hypothesis, its score)."""
        raise NotImplementedError

    def _identity_to_state(self, i_row_plus_1: int, ident: int) -> int:
        """Map a window identity (row index + 1 convention, see _collect)."""
        raise NotImplementedError

    def _mask_inconsistent(self, f_ident: int) -> None:
        """Suppress hypotheses whose ancestor at the new base-1 != f_ident."""
        raise NotImplementedError

    # -- shared machinery ---------------------------------------------------
    @property
    def n_committed(self) -> int:
        return len(self._committed)

    @property
    def lag(self) -> int:
        """Number of fed timesteps whose state has not been committed yet."""
        return self._t - self.n_committed

    @property
    def path(self) -> np.ndarray:
        """States committed so far (a prefix of the final decoded path)."""
        # flashlint: disable=FL002(committed prefix is a host-side python list, no device sync)
        return np.asarray(self._committed, dtype=np.int32)

    def _lo(self) -> int:
        # lowest row index whose composition tells us something new
        return self.n_committed - self._base + 1

    def _collect(self, rows, i_top: int, ident: int) -> tuple[list[int], int]:
        """Backtrack ``ident`` (at time _base + i_top) down to time n_committed.

        Returns (states oldest-first, identity at the oldest time).
        """
        lo = self._lo()
        seg = [self._identity_to_state(i_top + 1, ident)]
        for i in range(i_top, lo - 1, -1):
            ident = int(rows[i][ident])
            seg.append(self._identity_to_state(i, ident))
        seg.reverse()
        return seg, ident

    def _try_commit(self) -> list[int]:
        rows = self._rows()
        i_conv, ident = _latest_convergence(rows, self._lo())
        if i_conv is None:
            return []
        seg, _ = self._collect(rows, i_conv - 1, ident)
        self._committed.extend(seg)
        self._drop_rows(i_conv)
        self._base += i_conv
        self.stats["commits"] += 1
        return seg

    def _force_flush(self, m: int) -> list[int]:
        """Commit the oldest ``m`` window steps along the best hypothesis."""
        rows = self._rows()
        ident, _ = self._frontier_best()
        seg, _ = self._collect(rows, len(rows) - 1, ident)
        seg = seg[:m]
        self._committed.extend(seg)
        drop = self.n_committed - self._base  # rows for times <= n_committed-1
        self._drop_rows(drop)
        self._base += drop
        # pin future hypotheses to the committed seam state
        f_state = seg[-1]
        self._mask_inconsistent(f_state)
        self.stats["forced"] += 1
        return seg

    def _after_feed(self) -> np.ndarray:
        self.stats["feeds"] += 1
        new = self._try_commit()
        if self.max_lag is not None and self.lag > self.max_lag:
            new += self._force_flush(self.lag - self.max_lag)
        self.stats["peak_lag"] = max(self.stats["peak_lag"], self.lag)
        # flashlint: disable=FL002(newly committed states are a host list)
        return np.asarray(new, dtype=np.int32)

    def flush(self) -> tuple[np.ndarray, float]:
        """Commit everything fed so far; returns (tail states, path score).

        After flush the decoder is finished; ``path`` holds the full decode.
        """
        if self._finished:
            return np.zeros((0,), np.int32), self.score
        self._finished = True
        if self._t == 0:
            self.score = float("nan")
            return np.zeros((0,), np.int32), self.score
        rows = self._rows()
        ident, score = self._frontier_best()
        seg, _ = self._collect(rows, len(rows) - 1, ident)
        self._committed.extend(seg)
        self._drop_rows(len(rows))
        self._base = self._t
        self.score = score
        # flashlint: disable=FL002(flush tail is a host list)
        return np.asarray(seg, dtype=np.int32), score

    def _check_open(self, chunk) -> None:
        if self._finished:
            raise RuntimeError("decoder already flushed")
        if chunk.ndim != 2:
            raise ValueError(f"expected (C, K) chunk, got shape "
                             f"{tuple(chunk.shape)}")


# ---------------------------------------------------------------------------
# Exact streaming decoder
# ---------------------------------------------------------------------------

class _ExactWindow(_StreamingDecoder):
    """Window plumbing shared by the exact decoders (identities == states).

    Subclasses own the DP frontier (`_frontier_best`) and how an
    inconsistency mask reaches the scores (`_mask_inconsistent`); this base
    owns the (W, K) backpointer window itself.
    """

    K: int

    def __init__(self, max_lag: int | None):
        super().__init__(max_lag)
        self._psis: list[np.ndarray] = []   # each (c, K); together rows base..t-1

    def _rows(self) -> list[np.ndarray]:
        if len(self._psis) > 1:
            self._psis = [np.concatenate(self._psis, axis=0)]
        return self._psis[0] if self._psis else []

    def _drop_rows(self, n: int) -> None:
        if n and self._psis:
            self._psis = [self._psis[0][n:]]

    def _identity_to_state(self, i, ident: int) -> int:
        return int(ident)   # identities *are* states in the exact decoders

    def _ancestor_keep(self, f_state: int) -> np.ndarray:
        """(K,) bool: which frontier states trace back to ``f_state``."""
        anc = np.arange(self.K)
        for row in reversed(self._rows()):
            anc = row[anc]
        return anc == f_state

    def live_state_bytes(self) -> int:
        """Current live decoder state (the Fig. 11 memory metric)."""
        rows = self._rows()
        return len(rows) * self.K * 4 + self.K * 8


class OnlineViterbiDecoder(_ExactWindow):
    """Incremental exact Viterbi: feed (C, K) chunks, get committed prefixes.

        dec = OnlineViterbiDecoder(log_pi, log_A)    # on log_A's device
        for chunk in emission_stream:
            prefix = dec.feed(chunk)      # (n,) newly-final states, maybe empty
        tail, score = dec.flush()

    With ``max_lag=None`` (default) commits happen only at convergence points
    and the assembled path is exactly the offline Viterbi path.  With
    ``max_lag=L`` the uncommitted window never exceeds L steps (fixed-lag
    smoothing semantics: the forced part of the path is approximate).
    Chunks (numpy arrays or tensors) are moved to the model's device.
    """

    def __init__(self, log_pi, log_A, *, max_lag: int | None = None,
                 bt: int = 8, constraint=None):
        super().__init__(max_lag)
        self.log_A = _f32(log_A).contiguous()
        self.log_pi = _f32(log_pi, self.log_A.device)
        self.K = int(self.log_A.shape[0])
        self.bt = bt
        self.constraint = constraint
        if constraint is not None:
            # static components mask the model once; the per-step schedule is
            # added chunk by chunk in `feed` (the same elementwise adds as
            # the offline `constrain_inputs`, so streaming stays bit-identical)
            pi_pen = init_penalty(constraint, self.K)
            t_pen = transition_penalty(constraint, self.K)
            if pi_pen is not None:
                self.log_pi = self.log_pi + _f32(pi_pen, self.log_A.device)
            if t_pen is not None:
                self.log_A = self.log_A + _f32(t_pen, self.log_A.device)
        self._delta: torch.Tensor | None = None

    # -- window plumbing ----------------------------------------------------
    def _frontier_best(self) -> tuple[int, float]:
        # flashlint: disable=FL002(commit point: one batched frontier transfer instead of two scalar syncs)
        delta = self._delta.cpu().numpy()
        q = int(delta.argmax())
        return q, float(delta[q])

    def _mask_inconsistent(self, f_state: int) -> None:
        keep = torch.from_numpy(self._ancestor_keep(f_state)).to(
            self._delta.device)
        # flashlint: disable=FL007(forced-commit suppression seam; accumulative add by design, not an allowed-set mask)
        self._delta = torch.where(keep, self._delta,
                                  self._delta + 4.0 * NEG_INF)

    # -- feeding ------------------------------------------------------------
    def feed(self, em_chunk) -> np.ndarray:
        """Advance the DP by one emission chunk; returns newly committed states."""
        em_chunk = _f32(em_chunk, self.log_A.device)
        self._check_open(em_chunk)
        if em_chunk.shape[0] == 0:
            return np.zeros((0,), np.int32)
        if self.constraint is not None:
            rows = step_penalty_rows(self.constraint, self.K, self._t,
                                     int(em_chunk.shape[0]))
            if rows is not None:
                em_chunk = em_chunk + _f32(rows, em_chunk.device)
        if self._delta is None:
            self._delta = self.log_pi + em_chunk[0]
            self._t = 1
            em_chunk = em_chunk[1:]
        if em_chunk.shape[0]:
            psi, self._delta = viterbi_chunk_step(
                self.log_A, em_chunk, self._delta, bt=self.bt)
            # flashlint: disable=FL002(window transfer: backpointers feed the host-side convergence scan)
            self._psis.append(psi.cpu().numpy())
            self._t += int(em_chunk.shape[0])
        return self._after_feed()


# ---------------------------------------------------------------------------
# Externally-advanced slot decoder (the inflight serving tier's per-slot view)
# ---------------------------------------------------------------------------

class SlotViterbiDecoder(_ExactWindow):
    """Exact commit machinery for a decode whose DP advance happens elsewhere.

    The inflight scheduler (`serving.inflight`) advances *all* of its slots
    with one batched forward launch per block; each slot then owns only the
    host-side window bookkeeping: the same convergence-commit / forced-flush
    algebra as `OnlineViterbiDecoder` (bit-identical, because the batched
    kernel is bit-identical per sequence to the single-sequence one), minus
    any device state of its own.

    The two device touch-points are injected:

      frontier()      -> (K,) host array: this slot's current delta row.
                         Pulled only at flush / forced-flush time.
      mask_scores(keep (K,) bool) -> None: suppress frontier hypotheses whose
                         ancestor is inconsistent with a forced commit
                         (the scheduler applies it to its batched delta).

    Lifecycle: ``seed()`` once the first frame's delta row has been placed
    (t becomes 1), then ``ingest(psi_rows)`` after every externally-computed
    block advance; ``flush()`` (inherited) finishes.  ``save_state()`` /
    ``restore_state()`` round-trip the full host-side window so a slot can be
    checkpointed or migrated without replaying the stream.
    """

    def __init__(self, K: int, *, max_lag: int | None = None,
                 frontier=None, mask_scores=None):
        super().__init__(max_lag)
        self.K = int(K)
        if frontier is None:
            raise ValueError("SlotViterbiDecoder needs a frontier() callback")
        self._frontier = frontier
        self._mask_scores = mask_scores

    # -- external-advance surface -------------------------------------------
    def seed(self) -> None:
        """Mark the slot live: the caller just placed delta_0 for frame 0."""
        if self._finished:
            raise RuntimeError("slot decoder already flushed")
        if self._t:
            raise RuntimeError("slot decoder already seeded")
        self._t = 1

    def ingest(self, psi_rows: np.ndarray) -> np.ndarray:
        """Append externally-computed backpointer rows; commit what is final.

        ``psi_rows`` is (n, K) int32 mapping states at the n newly-fed steps
        to their predecessors (exactly `viterbi_chunk_step`'s psi output for
        this slot), on the host.  Returns the newly-committed states, like
        ``feed``.
        """
        if self._finished:
            raise RuntimeError("slot decoder already flushed")
        if self._t == 0:
            raise RuntimeError("slot decoder not seeded; call seed() first")
        # flashlint: disable=FL002(psi rows are already host numpy — the scheduler batched the transfer)
        psi_rows = np.asarray(psi_rows, np.int32)
        if psi_rows.ndim != 2 or psi_rows.shape[1] != self.K:
            raise ValueError(f"expected (n, K={self.K}) psi rows, "
                             f"got {psi_rows.shape}")
        if psi_rows.shape[0] == 0:
            return np.zeros((0,), np.int32)
        self._psis.append(psi_rows)
        self._t += int(psi_rows.shape[0])
        return self._after_feed()

    # -- _StreamingDecoder surface ------------------------------------------
    def _frontier_best(self) -> tuple[int, float]:
        # flashlint: disable=FL002(commit point: the injected frontier callback is the one batched row transfer)
        row = np.asarray(self._frontier())
        q = int(row.argmax())
        return q, float(row[q])

    def _mask_inconsistent(self, f_state: int) -> None:
        if self._mask_scores is None:
            raise RuntimeError(
                "forced flush needs a mask_scores callback (max_lag is set "
                "but the scheduler did not wire score masking)")
        self._mask_scores(self._ancestor_keep(f_state))

    # -- checkpoint / migration ---------------------------------------------
    def save_state(self) -> dict:
        """Host-side window snapshot (the device delta row is the caller's)."""
        return {"committed": list(self._committed), "t": self._t,
                "base": self._base, "finished": self._finished,
                "score": self.score, "stats": dict(self.stats),
                "psis": [p.copy() for p in self._psis]}

    def restore_state(self, state: dict) -> None:
        self._committed = list(state["committed"])
        self._t = int(state["t"])
        self._base = int(state["base"])
        self._finished = bool(state["finished"])
        self.score = state["score"]
        self.stats = dict(state["stats"])
        # flashlint: disable=FL002(restoring a host-side snapshot, no device data involved)
        self._psis = [np.asarray(p, np.int32).copy() for p in state["psis"]]


# ---------------------------------------------------------------------------
# Streaming dynamic-beam decoder
# ---------------------------------------------------------------------------

class OnlineBeamDecoder(_StreamingDecoder):
    """Streaming FLASH-BS: O(B) beam carry + O(W * B) window, K never live.

    The convergence check runs over *beam-slot* backpointers: once every slot
    of the current beam traces back to the same past slot, that slot's state
    is committed.  With ``beam_width >= K`` this is exact decoding (ties
    aside); narrower beams inherit FLASH-BS's accuracy/memory trade-off
    (paper Fig. 9) with streaming latency on top.  Each non-empty feed is one
    launch of the beam kernel's chunk mode; the beam stays on the device
    between feeds.
    """

    def __init__(self, log_pi, log_A, *, beam_width: int = 128,
                 kchunk: int = 128, max_lag: int | None = None,
                 constraint=None):
        super().__init__(max_lag)
        log_A = _f32(log_A)
        dev = log_A.device
        log_pi = _f32(log_pi, dev)
        K = int(log_A.shape[0])
        self.K = K
        self.B = int(min(beam_width, K))
        self.constraint = constraint
        if constraint is not None:
            # mask before the sentinel padding below: disallowed states score
            # ~NEG_INF and lose every slot, so the constraint compounds with
            # the beam pruning
            pi_pen = init_penalty(constraint, K)
            t_pen = transition_penalty(constraint, K)
            if pi_pen is not None:
                log_pi = log_pi + _f32(pi_pen, dev)
            if t_pen is not None:
                log_A = log_A + _f32(t_pen, dev)
        kchunk = int(min(kchunk, K))
        # pad K to a kchunk multiple; fake states get sentinel scores so they
        # never displace real candidates (as flash_bs_viterbi pads)
        K_pad = -(-K // kchunk) * kchunk
        if K_pad != K:
            log_A = torch.nn.functional.pad(
                log_A, (0, K_pad - K, 0, K_pad - K), value=_SENTINEL / 2)
            log_pi = torch.nn.functional.pad(log_pi, (0, K_pad - K),
                                             value=_SENTINEL / 2)
        self.K_pad = K_pad
        self.kchunk = kchunk
        self.log_pi = log_pi.contiguous()
        self.log_A = log_A.contiguous()
        self._scores: torch.Tensor | None = None   # (1, B) on the device
        self._states: torch.Tensor | None = None
        self._froms: list[np.ndarray] = []    # row i: slots(base+i)->slots(base+i-1)
        self._sstates: list[np.ndarray] = []  # entry j: slot states at time base-1+j

    # -- window plumbing ----------------------------------------------------
    def _rows(self) -> list[np.ndarray]:
        return self._froms

    def _drop_rows(self, n: int) -> None:
        if n:
            self._froms = self._froms[n:]
            self._sstates = self._sstates[n:]

    def _frontier_best(self) -> tuple[int, float]:
        # flashlint: disable=FL002(commit point: one batched frontier transfer instead of two scalar syncs)
        scores = self._scores[0].cpu().numpy()
        b = int(scores.argmax())
        return b, float(scores[b])

    def _identity_to_state(self, i, slot: int) -> int:
        # flashlint: disable=FL002(window rows are host numpy already, no device sync)
        return int(self._sstates[i][slot])

    def _mask_inconsistent(self, f_state: int) -> None:
        rows = self._rows()
        anc = np.arange(self.B)
        for i in range(len(rows) - 1, -1, -1):
            anc = rows[i][anc]
        keep = torch.from_numpy(self._sstates[0][anc] == f_state).to(
            self._scores.device)
        # flashlint: disable=FL007(beam forced-commit suppression seam, same accumulative add as the dense decoder)
        self._scores = torch.where(keep, self._scores,
                                   self._scores + 4.0 * NEG_INF)

    # -- feeding ------------------------------------------------------------
    def feed(self, em_chunk) -> np.ndarray:
        """Advance the beam by one emission chunk; returns committed states."""
        dev = self.log_A.device
        em_chunk = _f32(em_chunk, dev)
        self._check_open(em_chunk)
        C = int(em_chunk.shape[0])
        if C == 0:
            return np.zeros((0,), np.int32)
        if self.constraint is not None and em_chunk.shape[1] == self.K:
            rows = step_penalty_rows(self.constraint, self.K, self._t, C)
            if rows is not None:
                em_chunk = em_chunk + _f32(rows, dev)
        if self.K_pad != self.K and em_chunk.shape[1] == self.K:
            em_chunk = torch.nn.functional.pad(
                em_chunk, (0, self.K_pad - self.K), value=_SENTINEL / 2)
        first = self._scores is None
        if first:   # placeholders: a seeding beam reads no carry
            self._scores = torch.zeros((1, self.B), device=dev)
            self._states = torch.zeros((1, self.B), dtype=torch.int32,
                                       device=dev)
        is_first = torch.full((1,), first, dtype=torch.bool, device=dev)
        self._scores, self._states, sts, froms = bs_chunk_batch(
            self.log_pi, self.log_A, em_chunk[None], self._scores,
            self._states, is_first, self.B, self.kchunk)
        # flashlint: disable=FL002(window transfer: slot states and pointers feed the host-side convergence scan)
        hist = torch.stack((sts[0], froms[0])).cpu().numpy()
        sts, froms = hist
        if first:   # row 0 is the seed: slot states at time 0, no pointers
            self._sstates.append(sts[0])
        for r in range(1 if first else 0, C):
            self._sstates.append(sts[r])
            self._froms.append(froms[r])
        self._t += C
        return self._after_feed()

    def live_state_bytes(self) -> int:
        """Current live decoder state: O(W * B), decoupled from K."""
        return len(self._froms) * self.B * 8 + self.B * 8


# ---------------------------------------------------------------------------
# One-shot wrappers (offline signature over the streaming engine)
# ---------------------------------------------------------------------------

def _result(dec: _StreamingDecoder, device):
    return (torch.from_numpy(dec.path).to(device),
            torch.tensor(dec.score, dtype=torch.float32, device=device))


def viterbi_online(log_pi, log_A, em, *, chunk_size: int = 64,
                   max_lag: int | None = None, bt: int = 8):
    """Decode (T, K) emissions by streaming them chunk by chunk.

    Equivalent to ``viterbi_vanilla`` output-wise (bit-identical when
    ``max_lag=None``).  Returns (path (T,) int32, score) on log_A's device.
    """
    dec = OnlineViterbiDecoder(log_pi, log_A, max_lag=max_lag, bt=bt)
    T = em.shape[0]
    for s in range(0, T, chunk_size):
        dec.feed(em[s:s + chunk_size])
    dec.flush()
    return _result(dec, dec.log_A.device)


def viterbi_online_beam(log_pi, log_A, em, *, beam_width: int = 128,
                        chunk_size: int = 64, kchunk: int = 128,
                        max_lag: int | None = None):
    """Streaming beam decode of (T, K) emissions; returns (path, score)."""
    dec = OnlineBeamDecoder(log_pi, log_A, beam_width=beam_width,
                            kchunk=kchunk, max_lag=max_lag)
    T = em.shape[0]
    for s in range(0, T, chunk_size):
        dec.feed(em[s:s + chunk_size])
    dec.flush()
    return _result(dec, dec.log_A.device)


__all__ = ["OnlineViterbiDecoder", "OnlineBeamDecoder", "SlotViterbiDecoder",
           "viterbi_online", "viterbi_online_beam"]
