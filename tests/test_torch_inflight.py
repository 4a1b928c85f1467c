"""Parity of the port's continuous inflight batching tier
(`repro_torch.serving.inflight`, `SlotViterbiDecoder`, the mux's
``inflight=`` route) with the JAX package's on the CPU.

The cases are those of tests/test_inflight.py and
tests/test_inflight_property.py at their sizes (Erdos-Renyi K = 24, pools of
1-8 slots, blocks of 8 and 16), with the hypothesis strategy of the latter.
The model and every emission matrix are made once by the JAX package; the
same numpy arrays go to a JAX scheduler and a port scheduler on the CPU
(``device="cpu"``: the slot step runs the forward kernel's plain version),
which are driven in lockstep.

Tolerance: every delivered path, collected segment, score, `stats`, lag,
admitted and live byte count and queue state is equal, bitwise.  The JAX
tier's no-retrace guarantee becomes a launch check: every `step()` that
advances a slot is exactly one `viterbi_slot_step` call at the pool's fixed
(S, block, K).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import HealthCheck, given, settings, strategies as st

import repro.core as J
from repro.core import erdos_renyi_hmm as j_er, random_emissions as j_rand
from repro.serving import (InflightScheduler as JInflight,
                           StreamConfig as JStreamConfig,
                           StreamMux as JStreamMux)
from repro_torch.core import (OnlineSpec, ResourceBudget, SlotViterbiDecoder,
                              online_session_bytes)
from repro_torch.serving import (AdmissionRejected, InflightScheduler,
                                 StreamConfig, StreamMux)
from repro_torch.serving import inflight as p_inflight

# The plain versions run many small ops: one intra-op thread keeps the
# test workers from spinning against each other's JAX compiles.
torch.set_num_threads(1)

K = 24


@pytest.fixture(scope="module")
def hmm():
    """tests/test_inflight.py's model as numpy (log_pi, log_A)."""
    h = j_er(jax.random.key(7), K, edge_prob=0.4)
    return np.array(h.log_pi), np.array(h.log_A)


def _ems(lengths, seed=0, scale=2.0):
    key = jax.random.key(seed)
    return [np.array(j_rand(k, T, K, scale=scale))
            for k, T in zip(jax.random.split(key, len(lengths)), lengths)]


def _pair(hmm, **kw):
    """A port scheduler and a JAX one over the same model and arguments."""
    jkw = dict(kw)
    if isinstance(kw.get("budget"), ResourceBudget):
        jkw["budget"] = J.ResourceBudget(
            memory_bytes=kw["budget"].memory_bytes)
    return (InflightScheduler(*hmm, device="cpu", **kw),
            JInflight(*hmm, **jkw))


def _same_state(s, s_j):
    assert s.stats == s_j.stats
    assert s.admitted_bytes() == s_j.admitted_bytes()
    assert s.live_state_bytes() == s_j.live_state_bytes()
    assert s.live_sessions() == s_j.live_sessions()
    assert s.queued_sessions() == s_j.queued_sessions()
    assert s.device_state_bytes() == s_j.device_state_bytes()
    for sid in s._sessions:
        assert s.lag(sid) == s_j.lag(sid)
        assert s.n_committed(sid) == s_j.n_committed(sid)


def _collect_both(s, s_j, sid):
    got, want = s.collect(sid), s_j.collect(sid)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    return got


def _finish_both(s, s_j, sid):
    path, score = s.finish(sid)
    path_j, score_j = s_j.finish(sid)
    assert np.array_equal(path, path_j) and score == score_j
    _collect_both(s, s_j, sid)
    _same_state(s, s_j)
    return path, score


def _oracle(s, sid, hmm, em):
    """The port's own `OnlineSpec(stream_chunk=block, max_lag=L).run`."""
    spec = s.session_spec(sid)
    assert isinstance(spec, OnlineSpec)
    p, sc = spec.run(*(torch.from_numpy(x) for x in (*hmm, em)))
    return p.numpy(), float(sc)


# -- bit-identity against JAX and the unbatched oracle ----------------------

def test_exact_sessions_any_granularity(hmm):
    lengths = [37, 80, 9, 64, 33]
    ems = _ems(lengths)
    s, s_j = _pair(hmm, max_slots=3, block=16)
    sids = [s.submit() for _ in ems]
    assert sids == [s_j.submit() for _ in ems]
    cursors, feeds = [0] * len(ems), [5, 16, 3, 16, 11]
    while any(c < e.shape[0] for c, e in zip(cursors, ems)):
        for i, sid in enumerate(sids):
            c = cursors[i]
            if c < ems[i].shape[0]:
                chunk = ems[i][c:c + feeds[i]]
                assert s.feed(sid, chunk) == s_j.feed(sid, chunk)
                cursors[i] = min(c + feeds[i], ems[i].shape[0])
        assert s.pump() == s_j.pump()
        for sid in sids:
            _collect_both(s, s_j, sid)
        _same_state(s, s_j)
    for sid, em in zip(sids, ems):
        path, score = _finish_both(s, s_j, sid)
        p_v, s_v = J.viterbi_vanilla(*hmm, em)
        assert np.array_equal(path, np.asarray(p_v)) and score == float(s_v)


@pytest.mark.parametrize("max_lag", [2, 4, 8])
def test_lagged_sessions_match_online_spec_oracle(hmm, max_lag):
    # weak evidence, so forced flushes fire (this model's windows close
    # within 16 steps even at scale 0: lag 16 forces nothing here)
    ems = _ems([70, 41, 66], seed=3, scale=0.2)
    s, s_j = _pair(hmm, max_slots=3, block=8)
    sids = [s.submit(max_lag=max_lag) for _ in ems]
    [s_j.submit(max_lag=max_lag) for _ in ems]
    for sid, em in zip(sids, ems):
        s.feed(sid, em)
        s_j.feed(sid, em)
    assert s.pump() == s_j.pump()
    forced = 0
    for sid, em in zip(sids, ems):
        spec = s.session_spec(sid)
        assert spec.stream_chunk == 8 and spec.max_lag == max_lag
        forced += s._sessions[sid].dec.stats["forced"]
        path, score = _finish_both(s, s_j, sid)
        p_o, s_o = _oracle(s, sid, hmm, em)
        assert np.array_equal(path, p_o) and score == s_o
    assert forced > 0, "workload never forced a flush; oracle untested"


def test_mixed_exact_and_lagged_pool(hmm):
    ems = _ems([50, 50, 50, 50], seed=9, scale=0.3)
    s, s_j = _pair(hmm, max_slots=4, block=8)
    lags = [None, 4, None, 4]
    sids = [s.submit(max_lag=m) for m in lags]
    [s_j.submit(max_lag=m) for m in lags]
    for sid, em in zip(sids, ems):
        s.feed(sid, em)
        s_j.feed(sid, em)
        assert s.pump() == s_j.pump()
        _same_state(s, s_j)
    for sid, em in zip(sids, ems):
        path, score = _finish_both(s, s_j, sid)
        p_o, s_o = _oracle(s, sid, hmm, em)
        assert np.array_equal(path, p_o) and score == s_o


# -- delivery semantics -----------------------------------------------------

def test_collect_is_exactly_once(hmm):
    em = _ems([61])[0]
    s, s_j = _pair(hmm, max_slots=2, block=16)
    sid = s.submit()
    s_j.submit()
    got = []
    for i in range(0, 61, 16):
        s.feed(sid, em[i:i + 16])
        s_j.feed(sid, em[i:i + 16])
        s.pump(), s_j.pump()
        got.append(_collect_both(s, s_j, sid))
        assert s.collect(sid).shape[0] == 0
    path, _ = s.finish(sid)
    s_j.finish(sid)
    got.append(_collect_both(s, s_j, sid))
    assert s.collect(sid).shape[0] == 0
    assert np.array_equal(np.concatenate(got), path)


def test_finish_is_idempotent_and_feed_after_finish_raises(hmm):
    em = _ems([20])[0]
    s = InflightScheduler(*hmm, max_slots=1, block=8, device="cpu")
    sid = s.submit()
    s.feed(sid, em)
    first, again = s.finish(sid), s.finish(sid)
    assert np.array_equal(first[0], again[0]) and first[1] == again[1]
    with pytest.raises(RuntimeError, match="finished"):
        s.feed(sid, em[:1])
    with pytest.raises(ValueError, match="frames"):
        s.feed(s.submit(), em[:, :5])
    with pytest.raises(KeyError, match="unknown session"):
        s.collect(999)


def test_slot_reuse_never_leaks_state(hmm):
    ems = _ems([45, 30, 77], seed=5)
    s, s_j = _pair(hmm, max_slots=1, block=16)
    for em in ems:
        sid = s.submit()
        assert sid == s_j.submit() and s.live_sessions() == [sid]
        s.feed(sid, em)
        s_j.feed(sid, em)
        s.pump(), s_j.pump()
        path, score = _finish_both(s, s_j, sid)
        p_v, s_v = J.viterbi_vanilla(*hmm, em)
        assert np.array_equal(path, np.asarray(p_v)) and score == float(s_v)


# -- admission control ------------------------------------------------------

def test_admission_never_exceeds_budget(hmm):
    block = 8
    per = online_session_bytes(K, block, max_lag=32)
    cap = 2 * per + per // 2
    s, s_j = _pair(hmm, max_slots=8, block=block,
                   budget=ResourceBudget(memory_bytes=cap),
                   default_max_lag=32)
    sids = [s.submit() for _ in range(5)]
    [s_j.submit() for _ in range(5)]
    _same_state(s, s_j)
    ems = _ems([40] * 5, seed=11)
    for sid, em in zip(sids, ems):
        s.feed(sid, em)
        s_j.feed(sid, em)
        s.pump(), s_j.pump()
        assert s.admitted_bytes() <= cap
        _same_state(s, s_j)
    for sid, em in zip(sids, ems):
        path, score = _finish_both(s, s_j, sid)
        assert s.admitted_bytes() <= cap
        p_o, s_o = _oracle(s, sid, hmm, em)
        assert np.array_equal(path, p_o) and score == s_o
    assert s.admitted_bytes() == 0
    assert s.stats["queued_peak"] > 0 or s.stats["degraded"] > 0


def test_admission_degrades_rejects_and_overflows(hmm):
    """Degrade before queueing; reject what cannot fit at all; a session
    the budget kept queued is decoded at finish by the overflow path."""
    block = 8
    s, s_j = _pair(hmm, max_slots=2, block=block,
                   budget=online_session_bytes(K, block, max_lag=64))
    sid = s.submit(max_lag=1024)
    s_j.submit(max_lag=1024)
    sess = s._sessions[sid]
    assert sess.slot is not None and sess.max_lag < 1024
    assert dataclasses.asdict(sess.plan) == dataclasses.asdict(
        s_j._sessions[sid].plan)
    _same_state(s, s_j)

    tight = online_session_bytes(K, block, max_lag=8) - 1
    r = InflightScheduler(*hmm, max_slots=2, block=block, budget=tight,
                          device="cpu")
    with pytest.raises(AdmissionRejected):
        r.submit()
    assert r.stats["rejected"] == 1

    s, s_j = _pair(hmm, max_slots=4, block=block,
                   budget=online_session_bytes(K, block, max_lag=8),
                   default_max_lag=8)
    a, b = s.submit(), s.submit()
    s_j.submit(), s_j.submit()
    assert s.queued_sessions() == [b]
    ems = _ems([30, 30], seed=13)
    for sid, em in zip((a, b), ems):
        s.feed(sid, em)
        s_j.feed(sid, em)
    s.pump(), s_j.pump()
    for sid, em in zip((b, a), ems[::-1]):
        path, score = _finish_both(s, s_j, sid)
        p_o, s_o = _oracle(s, sid, hmm, em)
        assert np.array_equal(path, p_o) and score == s_o
    assert s.stats["overflow_finishes"] == 1


def test_fifo_within_priority_class(hmm):
    block = 8
    s, s_j = _pair(hmm, max_slots=1, block=block,
                   budget=online_session_bytes(K, block, max_lag=8),
                   default_max_lag=8)
    order = [s.submit(priority=p) for p in (1, 1, 1, 0)]
    [s_j.submit(priority=p) for p in (1, 1, 1, 0)]
    em = _ems([12])[0]
    attached = []
    for _ in range(4):
        live = s.live_sessions()
        assert live == s_j.live_sessions() and len(live) == 1
        attached.append(live[0])
        s.feed(live[0], em)
        s_j.feed(live[0], em)
        _finish_both(s, s_j, live[0])
    assert attached == [order[0], order[3], order[1], order[2]]


# -- mux routing ------------------------------------------------------------

def test_mux_routes_online_sessions_into_inflight(hmm):
    s, s_j = _pair(hmm, max_slots=2, block=16)
    mux = StreamMux(*hmm, StreamConfig(), inflight=s, device="cpu")
    mux_j = JStreamMux(*hmm, JStreamConfig(), inflight=s_j)
    em = _ems([50])[0]
    sid = mux.open()
    assert sid == mux_j.open()
    for i in range(0, 50, 16):
        out, out_j = mux.feed(sid, em[i:i + 16]), mux_j.feed(sid, em[i:i + 16])
        assert np.array_equal(out["committed"], out_j["committed"])
        assert (out["lag"], out["n_committed"]) == (out_j["lag"],
                                                    out_j["n_committed"])
    path, score = mux.finish(sid)
    path_j, score_j = mux_j.finish(sid)
    assert np.array_equal(path, path_j) and score == score_j
    assert mux.stats == mux_j.stats and mux.stats["routed_inflight"] == 1
    assert mux.live_state_bytes() == mux_j.live_state_bytes()
    p_v, s_v = J.viterbi_vanilla(*hmm, em)
    assert np.array_equal(path, np.asarray(p_v)) and score == float(s_v)


def test_midflight_join_served_within_one_block(hmm):
    s, s_j = _pair(hmm, max_slots=4, block=16)
    mux = StreamMux(*hmm, StreamConfig(), inflight=s, device="cpu")
    mux_j = JStreamMux(*hmm, JStreamConfig(), inflight=s_j)
    ems = _ems([200, 40], seed=21)
    incumbent = mux.open()
    mux_j.open()
    mux.feed(incumbent, ems[0][:64])
    mux_j.feed(incumbent, ems[0][:64])
    joiner = mux.open()
    mux_j.open()
    out = mux.feed(joiner, ems[1][:16])
    out_j = mux_j.feed(joiner, ems[1][:16])
    assert out["n_committed"] == out_j["n_committed"] > 0
    for sid, em in ((incumbent, ems[0][64:]), (joiner, ems[1][16:])):
        mux.feed(sid, em)
        mux_j.feed(sid, em)
    for sid, em in ((incumbent, ems[0]), (joiner, ems[1])):
        path, score = mux.finish(sid)
        path_j, score_j = mux_j.finish(sid)
        assert np.array_equal(path, path_j) and score == score_j
        p_v, s_v = J.viterbi_vanilla(*hmm, em)
        assert np.array_equal(path, np.asarray(p_v))


# -- one launch a step, one shape -------------------------------------------

def test_join_leave_churn_never_recompiles(hmm, monkeypatch):
    """Across join/leave churn (exact and lagged sessions, slot reuse, a
    forced flush), every `step()` that advances a slot calls
    `ops.viterbi_slot_step` exactly once, always at (S, block, K), and a
    step with nothing ready calls it never."""
    calls = []
    real = p_inflight.viterbi_slot_step

    def counted(log_A, em, delta, nfeed, **kw):
        calls.append((tuple(em.shape), tuple(delta.shape),
                      tuple(nfeed.shape)))
        return real(log_A, em, delta, nfeed, **kw)

    monkeypatch.setattr(p_inflight, "viterbi_slot_step", counted)
    S, block = 3, 8
    s = InflightScheduler(*hmm, max_slots=S, block=block, device="cpu")
    steps = 0
    real_step = s.step

    def step():
        nonlocal steps
        before = len(calls)
        out = real_step()
        assert len(calls) - before == (1 if out["advanced"] else 0)
        steps += bool(out["advanced"])
        return out

    s.step = step
    assert s.step() == {"advanced": 0, "frames": 0, "committed": 0}
    for seed in range(3):
        ems = _ems([25, 11, 19], seed=seed, scale=0.3)
        sids = [s.submit(max_lag=(4 if i == 1 else None)) for i in range(3)]
        for sid, em in zip(sids, ems):
            s.feed(sid, em)
            s.pump()
        for sid in sids:
            s.finish(sid)
    assert steps == s.stats["steps"] == len(calls) > 0
    assert set(calls) == {((S, block, K), (S, K), (S,))}
    assert sum(sess.dec.stats["forced"] for sess in s._sessions.values()) > 0


def test_slo_report_shape(hmm):
    s = InflightScheduler(*hmm, max_slots=2, block=8, device="cpu")
    sid = s.submit()
    s.feed(sid, _ems([20])[0])
    s.finish(sid)
    rep = s.slo_report()
    assert rep["block_latency_s"]["count"] == s.stats["steps"] > 0
    assert rep["completion_s"]["p50"] >= 0
    assert rep["stats"]["finished"] == 1
    assert s.device_state_bytes() > 0


def test_inflight_defaults_to_cuda(hmm):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InflightScheduler(*hmm)


# -- SlotViterbiDecoder -----------------------------------------------------

def _slot_pair(hmm, max_lag):
    """Port and JAX slot decoders, each advanced by its own package's
    `viterbi_chunk_step` on a frontier it owns.  `slot["dec"]` is the port
    decoder that `advance` drives; a test may swap it."""
    from repro.kernels.ops import viterbi_chunk_step as j_step
    from repro_torch.kernels.ops import viterbi_chunk_step as p_step
    lp, la = hmm
    state = {"p": None, "j": None}

    def mask(key, keep):
        d = state[key]
        state[key] = np.where(keep, d, d + np.float32(4.0 * J.NEG_INF))

    def make():
        return SlotViterbiDecoder(K, max_lag=max_lag,
                                  frontier=lambda: state["p"],
                                  mask_scores=lambda keep: mask("p", keep))

    slot = {"dec": make(), "make": make}
    dec_j = J.SlotViterbiDecoder(K, max_lag=max_lag,
                                 frontier=lambda: state["j"],
                                 mask_scores=lambda keep: mask("j", keep))

    def advance(em):
        if state["p"] is None:
            state["p"] = state["j"] = lp + em[0]
            slot["dec"].seed(), dec_j.seed()
            em = em[1:]
        psi, d = p_step(torch.from_numpy(la), torch.from_numpy(em),
                        torch.from_numpy(state["p"]))
        psi_j, d_j = j_step(la, em, state["j"])
        state["p"], state["j"] = d.numpy(), np.array(d_j)
        got = slot["dec"].ingest(psi.numpy())
        assert np.array_equal(got, dec_j.ingest(np.array(psi_j)))
        _same_slot(slot["dec"], dec_j)

    return slot, dec_j, advance


def _snapshot_equal(a, b):
    a, b = dict(a), dict(b)
    pa, pb = a.pop("psis"), b.pop("psis")
    return (a == b and len(pa) == len(pb)
            and all(np.array_equal(x, y) for x, y in zip(pa, pb)))


def _same_slot(dec, dec_j):
    assert np.array_equal(dec.path, dec_j.path)
    assert (dec.lag, dec.stats, dec.live_state_bytes()) == (
        dec_j.lag, dec_j.stats, dec_j.live_state_bytes())
    assert _snapshot_equal(dec.save_state(), dec_j.save_state())


@pytest.mark.parametrize("max_lag", [None, 4, 16])
def test_slot_decoder_matches_jax_and_round_trips(hmm, max_lag):
    """Feed by feed equal to the JAX slot decoder.  Mid-stream the window is
    saved and restored into a fresh decoder, which then carries the stream
    on, still equal to JAX's; the snapshot does not change with later
    feeds."""
    em = _ems([70], seed=31, scale=0.05)[0]
    slot, dec_j, advance = _slot_pair(hmm, max_lag)
    with pytest.raises(RuntimeError, match="not seeded"):
        slot["dec"].ingest(np.zeros((1, K), np.int32))
    for i in range(0, 30, 8):
        advance(em[i:i + 8])
    snap = slot["dec"].save_state()
    assert snap["t"] == 32 and snap.keys() == dec_j.save_state().keys()
    twin = slot["make"]()
    twin.restore_state(snap)
    _same_slot(twin, dec_j)
    slot["dec"] = twin
    for i in range(30, 70, 8):
        advance(em[i:i + 8])
    assert snap["t"] == 32 and not _snapshot_equal(snap, twin.save_state())
    tail, score = twin.flush()
    tail_j, score_j = dec_j.flush()
    assert np.array_equal(tail, tail_j) and score == score_j
    _same_slot(twin, dec_j)
    if max_lag == 4:
        assert twin.stats["forced"] > 0
    with pytest.raises(RuntimeError, match="flushed"):
        twin.ingest(np.zeros((2, K), np.int32))
    fresh = slot["make"]()
    fresh.seed()
    with pytest.raises(ValueError, match="psi rows"):
        fresh.ingest(np.zeros((2, K + 1), np.int32))


# -- the hypothesis schedules of tests/test_inflight_property.py ------------

@st.composite
def schedules(draw):
    n = draw(st.integers(2, 4))
    lengths = [draw(st.sampled_from([7, 18, 33, 49])) for _ in range(n)]
    lags = [draw(st.sampled_from([None, 4, 16])) for _ in range(n)]
    feeds = [draw(st.sampled_from([3, 8, 13, 64])) for _ in range(n)]
    prios = [draw(st.integers(0, 1)) for _ in range(n)]
    seed = draw(st.integers(0, 2**16))
    budgeted = draw(st.booleans())
    return lengths, lags, feeds, prios, seed, budgeted


@given(schedules())
@settings(max_examples=10, deadline=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.function_scoped_fixture])
def test_property_random_schedules(hmm, draw):
    """Random session mixes on a shared 3-slot pool, in lockstep with the
    JAX tier: the same collected segments, paths, scores and budget
    accounting, every slot released."""
    lengths, lags, feeds, prios, seed, budgeted = draw
    cap = online_session_bytes(K, 8, max_lag=64) * 2 if budgeted else None
    s, s_j = _pair(hmm, max_slots=3, block=8,
                   budget=ResourceBudget(memory_bytes=cap) if cap else None)
    ems = _ems(lengths, seed=seed, scale=0.5)
    sids = [s.submit(max_lag=lag, priority=p) for lag, p in zip(lags, prios)]
    [s_j.submit(max_lag=lag, priority=p) for lag, p in zip(lags, prios)]
    cursors = [0] * len(ems)
    delivered = {sid: [] for sid in sids}
    while any(c < e.shape[0] for c, e in zip(cursors, ems)):
        for i, sid in enumerate(sids):
            c, em = cursors[i], ems[i]
            if c < em.shape[0]:
                s.feed(sid, em[c:c + feeds[i]])
                s_j.feed(sid, em[c:c + feeds[i]])
                cursors[i] = min(c + feeds[i], em.shape[0])
        assert s.pump() == s_j.pump()
        if cap is not None:
            assert s.admitted_bytes() <= cap
        for sid in sids:
            delivered[sid].append(_collect_both(s, s_j, sid))
        _same_state(s, s_j)
    for sid, em in zip(sids, ems):
        path, score = s.finish(sid)
        path_j, score_j = s_j.finish(sid)
        assert np.array_equal(path, path_j) and score == score_j
        delivered[sid].append(_collect_both(s, s_j, sid))
        assert np.array_equal(np.concatenate(delivered[sid]), path)
    _same_state(s, s_j)
    assert s.admitted_bytes() == 0 and len(s._free) == 3
