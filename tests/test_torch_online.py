"""Parity of the port's streaming decode (`repro_torch.core.online`, the
streaming specs, `repro_torch.serving.stream`) and the planner's admission
helpers with the JAX package's on the CPU.

The cases are those of tests/test_online.py at its sizes (Erdos-Renyi K =
32, T = 97, and the smaller models it builds), plus chunk sizes {1, 7, 64},
`max_lag` None, 4 and 16, constraints (the five of tests/test_constraints.py
at K = 12, T = 24) and the beam decoder at K = 200 with `kchunk` 128 (K
padded to 256 with the -2e9 sentinel halves).  Every model and emission
matrix is made once (by the JAX package or numpy) and the same numpy arrays
go to both packages; the port gets CPU tensors, or ``device="cpu"``, so its
kernel wrappers run their plain versions.

Tolerance: paths, every feed's committed prefix, scores, `stats`, `lag`,
`live_state_bytes` and the planner's numbers are equal, bitwise.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import (erdos_renyi_hmm as j_er, left_to_right_hmm as j_l2r,
                        random_emissions as j_rand)
from repro.serving import (StreamConfig as JStreamConfig,
                           StreamMux as JStreamMux,
                           StreamSession as JStreamSession)
from repro_torch import core as P
from repro_torch.core import (OnlineBeamDecoder, OnlineViterbiDecoder,
                              ViterbiDecoder, viterbi_decode,
                              viterbi_online, viterbi_online_beam,
                              viterbi_vanilla)
from repro_torch.serving import StreamConfig, StreamMux, StreamSession

# The plain versions run many small ops: one intra-op thread keeps the
# test workers from spinning against each other's JAX compiles.
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _np(*xs):
    return tuple(np.array(x) for x in xs)


def _model(hmm):
    return _np(hmm.log_pi, hmm.log_A)


@pytest.fixture(scope="module")
def problem():
    """tests/test_online.py's problem: (log_pi, log_A, em (97, 32)) numpy."""
    k1, k2 = jax.random.split(jax.random.key(42))
    hmm = j_er(k1, 32, edge_prob=0.3)
    return _np(hmm.log_pi, hmm.log_A, j_rand(k2, 97, 32))


def _same_result(got, want):
    """Port (path, score) tensors against JAX's, bitwise."""
    p, s = got
    p_j, s_j = want
    return (p.dtype == torch.int32 and np.array_equal(p.numpy(),
                                                      np.asarray(p_j))
            and np.float32(s) == np.float32(np.asarray(s_j)))


def _same_decoder(dec, dec_j):
    """Committed path, lag, stats and live state equal."""
    assert np.array_equal(dec.path, dec_j.path)
    assert dec.lag == dec_j.lag and dec.n_committed == dec_j.n_committed
    assert dec.stats == dec_j.stats
    assert dec.live_state_bytes() == dec_j.live_state_bytes()


def _feed_both(dec, dec_j, em, step):
    """Feed both decoders the same chunks; every feed's commits equal."""
    for s in range(0, em.shape[0], step):
        got = dec.feed(em[s:s + step])
        want = dec_j.feed(em[s:s + step])
        assert got.dtype == np.int32 and np.array_equal(got, want)
        _same_decoder(dec, dec_j)
    tail, score = dec.flush()
    tail_j, score_j = dec_j.flush()
    assert np.array_equal(tail, tail_j) and score == score_j
    _same_decoder(dec, dec_j)


# -- exact variant ----------------------------------------------------------

@pytest.mark.parametrize("chunk_size", [1, 5, 7, 16, 64])
def test_online_exact_bit_identical(problem, chunk_size):
    lp, la, em = problem
    got = viterbi_online(torch.from_numpy(lp), torch.from_numpy(la),
                         torch.from_numpy(em), chunk_size=chunk_size)
    want = J.viterbi_online(lp, la, em, chunk_size=chunk_size)
    assert _same_result(got, want)
    p_v, s_v = viterbi_vanilla(torch.from_numpy(lp), torch.from_numpy(la),
                               torch.from_numpy(em))
    assert torch.equal(got[0], p_v) and float(got[1]) == float(s_v)


@pytest.mark.parametrize("step", [1, 7, 64])
def test_online_commits_equal_feed_by_feed(problem, step):
    """Every feed's committed prefix, the lag, the stats and the live state
    (tests/test_online.py's monotone-prefix and converges-before-flush
    cases)."""
    lp, la, em = problem
    dec = OnlineViterbiDecoder(lp, la)
    dec_j = J.OnlineViterbiDecoder(lp, la)
    _feed_both(dec, dec_j, em, step)
    assert dec.n_committed == em.shape[0]
    assert dec.stats["commits"] > 1


@pytest.mark.parametrize("max_lag", [4, 16])
def test_online_bounded_lag(max_lag):
    """Forced flushes at the same steps, the same suppression adds."""
    k1, k2 = jax.random.split(jax.random.key(3))
    lp, la = _model(j_er(k1, 24, edge_prob=0.3))
    # weak evidence (a weaker one at lag 16), so forced flushes fire
    em = np.array(j_rand(k2, 80, 24, scale=0.3 if max_lag == 4 else 0.05))
    dec = OnlineViterbiDecoder(lp, la, max_lag=max_lag)
    dec_j = J.OnlineViterbiDecoder(lp, la, max_lag=max_lag)
    _feed_both(dec, dec_j, em, 8)
    assert dec.stats["forced"] > 0 and dec.path.shape == (80,)
    got = viterbi_online(torch.from_numpy(lp), torch.from_numpy(la),
                         torch.from_numpy(em), chunk_size=7, max_lag=max_lag)
    assert _same_result(got, J.viterbi_online(lp, la, em, chunk_size=7,
                                              max_lag=max_lag))


def test_online_single_step_and_empty():
    k1, k2 = jax.random.split(jax.random.key(9))
    lp, la = _model(j_er(k1, 8, edge_prob=0.7))
    em = np.array(j_rand(k2, 1, 8))
    dec = OnlineViterbiDecoder(lp, la)
    assert dec.feed(em[:0]).shape == (0,)
    dec.feed(em)
    tail, score = dec.flush()
    p_v, s_v = J.viterbi_vanilla(lp, la, em)
    assert np.array_equal(dec.path, np.asarray(p_v))
    assert score == float(s_v)
    with pytest.raises(RuntimeError):
        dec.feed(em)
    with pytest.raises(ValueError, match="max_lag"):
        OnlineViterbiDecoder(lp, la, max_lag=0)


# -- beam variant -----------------------------------------------------------

@pytest.mark.parametrize("chunk_size", [1, 5, 7, 16, 64])
def test_online_beam_full_width_matches_jax(problem, chunk_size):
    lp, la, em = problem
    K = em.shape[1]
    got = viterbi_online_beam(torch.from_numpy(lp), torch.from_numpy(la),
                              torch.from_numpy(em), beam_width=K,
                              chunk_size=chunk_size, kchunk=8)
    want = J.viterbi_online_beam(lp, la, em, beam_width=K,
                                 chunk_size=chunk_size, kchunk=8)
    assert _same_result(got, want)
    p_v, _ = J.viterbi_vanilla(lp, la, em)
    assert np.array_equal(got[0].numpy(), np.asarray(p_v))


@pytest.mark.parametrize("max_lag", [None, 4, 16])
def test_online_beam_narrow_feed_by_feed(problem, max_lag):
    lp, la, em = problem
    dec = OnlineBeamDecoder(lp, la, beam_width=8, kchunk=8, max_lag=max_lag)
    dec_j = J.OnlineBeamDecoder(lp, la, beam_width=8, kchunk=8,
                                max_lag=max_lag)
    _feed_both(dec, dec_j, em, 11)
    assert dec.live_state_bytes() < 32 * em.shape[1] * 4


@pytest.mark.parametrize("chunk_size", [1, 7, 64])
@pytest.mark.parametrize("B,max_lag", [(16, None), (128, None), (16, 4),
                                       (200, 16)])
def test_online_beam_padded_k(chunk_size, B, max_lag):
    """K = 200 with kchunk 128: log_A, log_pi and every chunk padded to 256
    with -2e9, so a padded state's seed is exactly the -4e9 sentinel's."""
    k1, k2 = jax.random.split(jax.random.key(200))
    lp, la = _model(j_er(k1, 200, edge_prob=0.1))
    em = np.array(j_rand(k2, 70, 200, scale=0.5))
    dec = OnlineBeamDecoder(lp, la, beam_width=B, kchunk=128, max_lag=max_lag)
    dec_j = J.OnlineBeamDecoder(lp, la, beam_width=B, kchunk=128,
                                max_lag=max_lag)
    assert dec.K_pad == dec_j.K_pad == 256
    assert np.array_equal(dec.log_A.numpy(), np.asarray(dec_j.log_A))
    _feed_both(dec, dec_j, em, chunk_size)


@pytest.mark.parametrize("chunk_size", [1, 7, 64])
def test_online_beam_left_to_right_ties(chunk_size):
    """A left-to-right model (NEG_INF off the band, a one-hot log_pi): the
    early beams are mostly -4e9 sentinels and NEG_INF sums that tie."""
    k1, k2 = jax.random.split(jax.random.key(7))
    lp, la = _model(j_l2r(k1, 48, 16))
    em = np.array(j_rand(k2, 64, 48))
    for B in (4, 48):
        dec = OnlineBeamDecoder(lp, la, beam_width=B, kchunk=16)
        dec_j = J.OnlineBeamDecoder(lp, la, beam_width=B, kchunk=16)
        _feed_both(dec, dec_j, em, chunk_size)


def test_online_beam_first_feed_of_one_row(problem):
    """A first feed of one row is the seed alone: no transition, no row."""
    lp, la, em = problem
    dec = OnlineBeamDecoder(lp, la, beam_width=8, kchunk=8)
    dec_j = J.OnlineBeamDecoder(lp, la, beam_width=8, kchunk=8)
    for n in (1, 1, 5, 1, 20):
        assert np.array_equal(dec.feed(em[:n]), dec_j.feed(em[:n]))
        _same_decoder(dec, dec_j)
    assert len(dec._froms) == len(dec._sstates) - 1


# -- api dispatch and specs -------------------------------------------------

def test_api_dispatch_online(problem):
    lp, la, em = (torch.from_numpy(x) for x in problem)
    got = viterbi_decode(em, lp, la, method="online", stream_chunk=32)
    want = J.viterbi_decode(*problem[2:], *problem[:2], method="online",
                            stream_chunk=32)
    assert _same_result(got, want)
    got = viterbi_decode(em, lp, la, method="online_beam",
                         beam_width=em.shape[1], chunk=8, stream_chunk=32)
    want = J.viterbi_decode(*problem[2:], *problem[:2], method="online_beam",
                            beam_width=em.shape[1], chunk=8, stream_chunk=32)
    assert _same_result(got, want)


@pytest.mark.parametrize("spec_cls", ["OnlineSpec", "OnlineBeamSpec"])
def test_streaming_specs_match_jax(problem, spec_cls):
    """Fields, legacy tunables, validation, `run` and `make_streaming`
    through `ViterbiDecoder`."""
    lp, la, em = problem
    kw = dict(stream_chunk=16, max_lag=None)
    if spec_cls == "OnlineBeamSpec":
        kw.update(beam_width=16, kchunk=8)
    spec, spec_j = getattr(P, spec_cls)(**kw), getattr(J, spec_cls)(**kw)
    assert dataclasses.asdict(spec) == dataclasses.asdict(spec_j)
    assert spec.legacy_tunables == spec_j.legacy_tunables
    assert spec.method == spec_j.method and spec.batch_method is None
    assert hash(spec) == hash(getattr(P, spec_cls)(**kw))
    for bad in (dict(stream_chunk=0), dict(max_lag=0)):
        with pytest.raises(ValueError):
            getattr(P, spec_cls)(**bad)
    assert _same_result(spec.run(*(torch.from_numpy(x) for x in problem)),
                        spec_j.run(lp, la, em))
    dec = ViterbiDecoder(spec, lp, la, device="cpu").make_streaming()
    dec_j = J.ViterbiDecoder(spec_j, lp, la).make_streaming()
    assert type(dec).__name__ == type(dec_j).__name__
    _feed_both(dec, dec_j, em, 13)
    with pytest.raises(ValueError, match="not a streaming spec"):
        ViterbiDecoder(P.FusedSpec(), lp, la, device="cpu").make_streaming()


# -- constraints ------------------------------------------------------------

K_C, T_C = 12, 24


def _constraint_args():
    """tests/test_constraints.py's five constraints at K = 12, T = 24."""
    K, T = K_C, T_C
    chain = [(i, (i + 1) % K) for i in range(K)]
    loops = [(i, i) for i in range(K)]
    return {
        "band": ("BandConstraint",
                 dict(centers=tuple((3 * t) % K for t in range(T)), width=3)),
        "short_band": ("BandConstraint",
                       dict(centers=tuple(range(T // 2)), width=4)),
        "lexicon": ("LexiconConstraint",
                    dict(words=(((0, 1, 2), (0, 3, 2)), ((4, 5, 6),),
                                ((7, 8),)))),
        "transition": ("TransitionMaskConstraint",
                       dict(edges=tuple(chain + loops),
                            init_states=(0, 1, 2))),
        "schedule": ("ScheduleConstraint",
                     dict(anchors=((0, (0, 1, 2, 3)), (5, (2, 3, 4)),
                                   (T - 1, (3, 4, 5))))),
    }


@pytest.mark.parametrize("cname", sorted(_constraint_args()))
@pytest.mark.parametrize("spec_cls", ["OnlineSpec", "OnlineBeamSpec"])
def test_constrained_streaming_matches_jax(spec_cls, cname):
    """`constraint=` on both streaming specs: ragged feeds of 7 through
    `make_streaming` and the one-shot `run`, against the JAX spec and the
    port's own decode of the masked inputs."""
    cls, kw = _constraint_args()[cname]
    c, c_j = getattr(P, cls)(**kw), getattr(J, cls)(**kw)
    g = np.random.default_rng(10)
    hmm = P.erdos_renyi_hmm(g, K_C, edge_prob=1.0, device=CPU)
    em = P.random_emissions(g, T_C, K_C, device=CPU)
    lp, la, em_np = hmm.log_pi.numpy(), hmm.log_A.numpy(), em.numpy()
    extra = {} if spec_cls == "OnlineSpec" else dict(beam_width=K_C, kchunk=8)
    spec = getattr(P, spec_cls)(constraint=c, **extra)
    spec_j = getattr(J, spec_cls)(constraint=c_j, **extra)
    dec = ViterbiDecoder(spec, lp, la, device="cpu").make_streaming()
    dec_j = J.ViterbiDecoder(spec_j, lp, la).make_streaming()
    _feed_both(dec, dec_j, em_np, 7)
    got = spec.run(hmm.log_pi, hmm.log_A, em)
    assert _same_result(got, spec_j.run(lp, la, em_np))
    base = dataclasses.replace(spec, constraint=None)
    want = base.run(*P.constrain_inputs(c, hmm.log_pi, hmm.log_A, em))
    assert np.array_equal(dec.path, want[0].numpy())
    assert np.float32(dec.score) == np.float32(want[1])


# -- serving layer ----------------------------------------------------------

@pytest.mark.parametrize("cfg", [dict(), dict(max_lag=4),
                                 dict(method="online_beam", beam_width=8,
                                      kchunk=8)])
def test_stream_session_ragged_feeds(problem, cfg):
    lp, la, em = problem
    sess = StreamSession(lp, la, StreamConfig(**cfg), block=16, device="cpu")
    sess_j = JStreamSession(lp, la, JStreamConfig(**cfg), block=16)
    i = 0
    for n in (3, 20, 1, 40, 33):
        got, want = sess.feed(em[i:i + n]), sess_j.feed(em[i:i + n])
        assert np.array_equal(got, want)
        assert sess.lag == sess_j.lag
        assert sess.live_state_bytes() == sess_j.live_state_bytes()
        i += n
    path, score = sess.finish()
    path_j, score_j = sess_j.finish()
    assert np.array_equal(path, path_j) and score == score_j
    assert sess.decoder.stats == sess_j.decoder.stats
    if not cfg:
        p_v, s_v = J.viterbi_vanilla(lp, la, em)
        assert np.array_equal(path, np.asarray(p_v)) and score == float(s_v)


def test_stream_mux_concurrent_sessions(problem):
    lp, la, em = problem
    mux = StreamMux(lp, la, blocks=(16, 64), device="cpu")
    mux_j = JStreamMux(lp, la, blocks=(16, 64))
    a, b = mux.open(block=16), mux.open(block=50)
    mux_j.open(block=16), mux_j.open(block=50)
    assert mux.sessions_by_bucket() == mux_j.sessions_by_bucket()
    for s in range(0, em.shape[0], 25):
        chunk = em[s:s + 25]
        for sid in (a, b):
            out, out_j = mux.feed(sid, chunk), mux_j.feed(sid, chunk)
            assert np.array_equal(out["committed"], out_j["committed"])
            assert (out["lag"], out["n_committed"]) == (out_j["lag"],
                                                        out_j["n_committed"])
        assert mux.live_state_bytes() == mux_j.live_state_bytes()
    for sid in (a, b):
        path, score = mux.finish(sid)
        path_j, score_j = mux_j.finish(sid)
        assert np.array_equal(path, path_j) and score == score_j
    assert mux.stats == mux_j.stats


def test_stream_lifecycle(problem):
    """Unfed finish (empty path, NaN score), idempotent finish, double
    finish and feed after finish raising, as in tests/test_online.py."""
    lp, la, em = problem
    mux = StreamMux(lp, la, blocks=(16,), device="cpu")
    sid = mux.open(block=16)
    path, score = mux.finish(sid)
    assert path.shape == (0,) and np.isnan(score)
    sid = mux.open(block=16)
    mux.feed(sid, em[:20])
    mux.finish(sid)
    for call in (lambda: mux.finish(sid), lambda: mux.feed(sid, em[:4])):
        with pytest.raises(KeyError, match="unknown or already-finished"):
            call()
    assert mux.stats["finished"] == 2
    sess = StreamSession(lp, la, StreamConfig(), block=16, device="cpu")
    sess.feed(em[:40])
    p1, s1 = sess.finish()
    p2, s2 = sess.finish()
    assert np.array_equal(p1, p2) and s1 == s2
    p_v, s_v = J.viterbi_vanilla(lp, la, em[:40])
    assert np.array_equal(p1, np.asarray(p_v)) and s1 == float(s_v)
    with pytest.raises(RuntimeError, match="already finished"):
        sess.feed(em[40:43])


def _no_converge_hmm():
    """Two disconnected, symmetric chains: no convergence commit ever."""
    return (np.zeros((2,), np.float32),
            np.array([[0.0, -100.0], [-100.0, 0.0]], np.float32))


@pytest.mark.parametrize("n,block", [(8, 64), (7, 16)])
def test_stream_live_state_bytes(n, block):
    """Sub-block feeds count as live; without commits it never shrinks."""
    lp, la = _no_converge_hmm()
    sess = StreamSession(lp, la, StreamConfig(), block=block, device="cpu")
    sess_j = JStreamSession(lp, la, JStreamConfig(), block=block)
    sizes = [sess.live_state_bytes()]
    for _ in range(10):
        frames = np.zeros((n, 2), np.float32)
        assert sess.feed(frames).shape == sess_j.feed(frames).shape == (0,)
        sizes.append(sess.live_state_bytes())
        assert sizes[-1] == sess_j.live_state_bytes()
    assert all(b >= a for a, b in zip(sizes, sizes[1:]))
    assert sizes[-1] > sizes[0]


def test_stream_left_to_right_alignment_online():
    k1, k2 = jax.random.split(jax.random.key(7))
    lp, la = _model(j_l2r(k1, 32, 16))
    em = np.array(j_rand(k2, 64, 32))
    got = viterbi_online(torch.from_numpy(lp), torch.from_numpy(la),
                         torch.from_numpy(em), chunk_size=10)
    assert _same_result(got, J.viterbi_online(lp, la, em, chunk_size=10))
    path = got[0].numpy()
    assert path[0] == 0 and np.all(np.diff(path) >= 0)
    assert np.all(np.diff(path) <= 2)


def test_stream_entry_points_default_to_cuda():
    """Without ``device=`` the streaming entry points go to the card, and
    raise on a host without one (no silent CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    lp, la = _no_converge_hmm()
    for make in (lambda: StreamSession(lp, la),
                 lambda: StreamMux(lp, la),
                 lambda: P.resolve_device(None)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


# -- planner: admission helpers ---------------------------------------------

@pytest.mark.parametrize("K,block", [(24, 8), (512, 16), (4096, 64)])
def test_admission_helpers_match_jax(K, block):
    for lag in (None, 1, 8, 64, 1024):
        for horizon in (None, 512, 4096):
            if lag is None and horizon is None:
                for f in (P.online_session_bytes, J.online_session_bytes):
                    with pytest.raises(ValueError):
                        f(K, block, max_lag=None, horizon=None)
                continue
            assert P.online_session_bytes(K, block, lag, horizon) == \
                J.online_session_bytes(K, block, lag, horizon)
    for slots in (1, 3, 64):
        assert P.inflight_state_bytes(K, block, slots) == \
            J.inflight_state_bytes(K, block, slots)
    unit = P.online_session_bytes(K, block, max_lag=8)
    for remaining in (None, unit - 1, unit, 3 * unit, 100 * unit, 10 ** 12):
        for lag in (None, 8, 16, 100, 2048):
            got = P.plan_admission(K, block, remaining, requested_lag=lag,
                                   horizon=4096)
            want = J.plan_admission(K, block, remaining, requested_lag=lag,
                                    horizon=4096)
            assert (got is None) == (want is None)
            if got is not None:
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
                assert isinstance(got, P.AdmissionPlan)
