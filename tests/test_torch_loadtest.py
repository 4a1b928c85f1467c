"""The port's load harness (`repro_torch.launch.loadtest`) on the cases of
tests/test_loadtest.py, and against the JAX package's harness.

The port draws events and payloads exactly as the JAX package does (one
numpy RNG from the seed), so its traces equal JAX's byte for byte; its HMM
comes from its own generator, and the parity cases inject JAX's HMM as
numpy, after which every delivered path and score equals JAX's harness's,
bitwise.  Everything runs on the CPU at small K and T.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.launch import loadtest as jlt
from repro_torch.core import HMM, viterbi_vanilla
from repro_torch.launch.loadtest import (LoadConfig, LoadHarness, VirtualClock,
                                         make_workload, oracle_check,
                                         peak_concurrency, resolve_spec,
                                         run_inflight_compare,
                                         slot_step_departures)

SMOKE = LoadConfig(seed=3, requests=10, states=16, stream_frac=0.3,
                   lengths=(8, 18, 30), buckets=(32,), max_batch=4,
                   stream_block=8, stream_chunk=4, method="vanilla",
                   device="cpu")


def _jax_cfg(cfg: LoadConfig):
    fields = dataclasses.asdict(cfg)
    assert fields.pop("device") == "cpu"
    return jlt.LoadConfig(**fields)


# ---------------------------------------------------------------------------
# Clock and generator
# ---------------------------------------------------------------------------

def test_virtual_clock():
    clock = VirtualClock()
    clock.advance(1.5)
    clock.advance_to(1.0)          # never goes backwards
    assert clock.now() == 1.5
    clock.advance_to(2.0)
    assert clock.now() == 2.0
    with pytest.raises(ValueError):
        clock.advance(-0.1)


def test_config_validation():
    with pytest.raises(ValueError, match="stream_frac"):
        LoadConfig(stream_frac=1.5)
    with pytest.raises(ValueError, match="bucket"):
        LoadConfig(lengths=(256,), buckets=(64,))


def test_config_is_jaxs_plus_device():
    """Every field and default of the JAX config, plus ``device``."""
    mine = {f.name: f.default for f in dataclasses.fields(LoadConfig)}
    assert mine.pop("device") is None
    assert mine == {f.name: f.default
                    for f in dataclasses.fields(jlt.LoadConfig)}


def test_workload_deterministic_from_seed():
    """The whole trace (times, kinds, payload bytes) reproduces from the
    seed; a different seed produces a different trace."""
    w1, w2 = make_workload(SMOKE), make_workload(SMOKE)
    assert len(w1.events) == len(w2.events)
    for a, b in zip(w1.events, w2.events):
        assert (a.t, a.seq, a.kind, a.rid) == (b.t, b.seq, b.kind, b.rid)
        if a.frames is not None:
            assert np.array_equal(a.frames, b.frames)
    for rid in w1.payloads:
        assert np.array_equal(w1.payloads[rid], w2.payloads[rid])
    assert torch.equal(w1.hmm.log_A, w2.hmm.log_A)
    w3 = make_workload(dataclasses.replace(SMOKE, seed=SMOKE.seed + 1))
    assert any(a.t != b.t for a, b in zip(w1.events, w3.events))


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_workload_equals_jaxs_byte_for_byte(seed):
    """Events and payloads are JAX's for the same seed, byte for byte."""
    cfg = dataclasses.replace(SMOKE, seed=seed)
    mine, theirs = make_workload(cfg), jlt.make_workload(_jax_cfg(cfg))
    assert len(mine.events) == len(theirs.events)
    for a, b in zip(mine.events, theirs.events):
        assert (a.t, a.seq, a.kind, a.rid) == (b.t, b.seq, b.kind, b.rid)
        assert (a.frames is None) == (b.frames is None)
        if a.frames is not None:
            assert a.frames.tobytes() == b.frames.tobytes()
    assert mine.kinds == theirs.kinds
    assert all(mine.payloads[r].tobytes() == theirs.payloads[r].tobytes()
               for r in theirs.payloads)


def test_workload_shape():
    w = make_workload(SMOKE)
    assert set(w.kinds.values()) == {"offline", "stream"}
    assert all(p.shape[0] in SMOKE.lengths and p.shape[1] == SMOKE.states
               for p in w.payloads.values())
    ts = [e.t for e in w.events]
    assert ts == sorted(ts)
    # streaming requests decompose into open -> feeds covering T -> finish
    for rid, kind in w.kinds.items():
        evs = [e for e in w.events if e.rid == rid]
        if kind == "stream":
            assert [e.kind for e in evs][0] == "open"
            assert [e.kind for e in evs][-1] == "finish"
            fed = sum(e.frames.shape[0] for e in evs if e.kind == "feed")
            assert fed == w.payloads[rid].shape[0]
        else:
            assert [e.kind for e in evs] == ["offline"]


def test_resolve_spec_budget_path():
    spec, p = resolve_spec(SMOKE)
    assert p is None and spec.method == "vanilla"
    spec_b, plan_b = resolve_spec(dataclasses.replace(SMOKE, budget_kb=64.0))
    assert plan_b is not None and plan_b.spec == spec_b
    assert plan_b.state_bytes <= 64 * 1024


# ---------------------------------------------------------------------------
# Harness end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_report():
    return LoadHarness(SMOKE).run()


def test_harness_delivers_everything_exactly_once(smoke_report):
    r = smoke_report["requests"]
    assert r["delivered"] == r["total"] == SMOKE.requests
    assert r["duplicates"] == 0
    assert r["offline"] + r["stream"] == r["total"]


def test_harness_oracle_passes(smoke_report):
    """Every served path (batched, padded, muxed) is bit-identical to an
    unbatched reference decode."""
    ora = smoke_report["oracle"]
    assert ora["ok"]
    assert ora["offline"]["mismatches"] == []
    assert ora["stream"]["mismatches"] == []
    assert (ora["offline"]["checked"] + ora["stream"]["checked"]
            == SMOKE.requests)
    assert ora["offline"]["exact"]


def test_harness_reports_throughput_and_percentiles(smoke_report):
    tp = smoke_report["throughput"]
    assert tp["requests_per_s"] > 0 and tp["frames_per_s"] > 0
    off = smoke_report["latency_s"]["offline"]
    assert off is not None and 0 <= off["p50"] <= off["p99"] <= off["max"]
    assert smoke_report["scheduler"]["batches"] >= 1
    assert smoke_report["stream"]["peak_live_state_bytes"] > 0
    assert smoke_report["device"] == "cpu"


def test_report_is_json_serialisable(smoke_report):
    blob = json.dumps(smoke_report, default=str)
    back = json.loads(blob)
    assert back["config"]["seed"] == SMOKE.seed
    for key in ("config", "spec", "requests", "throughput", "latency_s",
                "scheduler", "stream", "oracle"):
        assert key in back


def test_budget_planned_harness_passes_oracle():
    """The serve.py --budget-kb path, under load: budget -> plan -> spec ->
    scheduler, still bit-identical to the oracle."""
    cfg = dataclasses.replace(SMOKE, budget_kb=8.0, requests=6)
    report = LoadHarness(cfg).run()
    assert report["spec"]["planned_why"] is not None
    assert report["oracle"]["ok"]
    assert report["requests"]["delivered"] == cfg.requests


@pytest.mark.parametrize("kw", [dict(method="flash"), dict(method="fused"),
                                dict(budget_kb=8.0)],
                         ids=["flash", "fused", "budget"])
def test_harness_matches_jaxs_on_jaxs_hmm(kw):
    """With JAX's HMM injected, every delivered offline and streamed path
    and score equals the JAX harness's, bitwise, and both oracles pass."""
    cfg = dataclasses.replace(SMOKE, **kw)
    jh = jlt.LoadHarness(_jax_cfg(cfg))
    jrep = jh.run()
    hmm = HMM.from_numpy(*(np.asarray(x) for x in (
        jh.work.hmm.log_pi, jh.work.hmm.log_A, jh.work.hmm.log_B)),
        device="cpu")
    h = LoadHarness(cfg, workload=make_workload(cfg, hmm=hmm))
    rep = h.run()
    assert rep["oracle"]["ok"] and jrep["oracle"]["ok"]
    assert rep["spec"]["type"] == jrep["spec"]["type"]
    for mine, theirs in ((h.results, jh.results),
                         (h.stream_results, jh.stream_results)):
        assert sorted(mine) == sorted(theirs) and mine
        for rid, (path, score) in theirs.items():
            assert np.array_equal(mine[rid][0], np.asarray(path)), rid
            assert np.float32(mine[rid][1]) == np.float32(score), rid


# ---------------------------------------------------------------------------
# Inflight vs bucketed comparison
# ---------------------------------------------------------------------------

def test_harness_inflight_mode_passes_oracle():
    """The harness event loop with sessions routed through the inflight
    tier instead of bucketing: still exactly-once, still oracle-clean."""
    cfg = dataclasses.replace(SMOKE, stream_frac=1.0, requests=8,
                              inflight=True, inflight_slots=4)
    report = LoadHarness(cfg).run()
    assert report["oracle"]["ok"]
    assert report["requests"]["delivered"] == cfg.requests
    assert report["inflight"]["stats"]["finished"] == cfg.requests
    assert report["inflight"]["block_latency_s"]["count"] > 0


def test_run_inflight_compare_smoke(monkeypatch):
    """Both sides of the A/B run the same seeded workload and pass the
    oracle, and across the session churn every inflight `step()` makes one
    slot-step call at the pool's one (S, block, K) shape (recorded here
    around the scheduler's `viterbi_slot_step`).  On the CPU no kernel
    launches, so the compare's launch-based ``retraces`` reads None (not
    measured); `test_slot_step_departures` holds its arithmetic."""
    from repro_torch.serving import inflight as p_inflight
    shapes = []
    real = p_inflight.viterbi_slot_step

    def recorded(log_A, em, delta, nfeed, **kw):
        shapes.append((tuple(em.shape), tuple(delta.shape)))
        return real(log_A, em, delta, nfeed, **kw)

    monkeypatch.setattr(p_inflight, "viterbi_slot_step", recorded)
    cfg = dataclasses.replace(SMOKE, requests=8, inflight=True,
                              inflight_slots=4)
    rep = run_inflight_compare(cfg)
    assert rep["oracle_ok"]
    assert rep["retraces"] is None
    slot = rep["inflight"]["slot_step"]
    assert slot["kernel"] == "viterbi_fwd_batch"
    assert slot["launches"] is None and slot["steps"] > 0
    assert rep["bucketed"]["launches"] is None
    assert len(shapes) == rep["inflight"]["slo"]["stats"]["steps"]
    assert len(shapes) > slot["steps"]      # the warm-up step came first
    assert set(shapes) == {((4, cfg.stream_block, cfg.states),
                            (4, cfg.states))}
    assert rep["peak_concurrent_sessions"] >= 1
    for side in ("bucketed", "inflight"):
        assert rep[side]["oracle_ok"]
        assert rep[side]["stream_stats"]["finished"] == cfg.requests
    assert rep["inflight"]["slo"]["stats"]["finished"] >= cfg.requests
    assert rep["p99_completion_s"]["bucketed"] > 0
    assert rep["p99_completion_s"]["inflight"] > 0
    blob = json.dumps(rep, default=str)
    assert json.loads(blob)["retraces"] is None


@pytest.mark.parametrize("launches,steps,want", [
    ({"viterbi_fwd_batch": 7, "viterbi_backtrack_batch": 0}, 7, 0),
    ({"viterbi_fwd_batch": 6, "viterbi_backtrack_batch": 0}, 7, 1),
    ({"viterbi_fwd_batch": 9}, 7, 2),
    ({"viterbi_fwd_batch": 7, "bs_chunk_batch": 3}, 7, 3),
    ({"viterbi_fwd_batch": 0, "viterbi_fwd_batch_masked": 7}, 7, 14),
    ({"viterbi_fwd_batch": 5, "viterbi_backtrack_batch": 5}, 5, 5),
])
def test_slot_step_departures(launches, steps, want):
    """The compare's ``retraces`` on the card: launches of the slot-step
    kernel other than one a step, plus any other kernel's launches."""
    assert slot_step_departures(launches, steps) == want


def test_peak_concurrency():
    w = make_workload(dataclasses.replace(SMOKE, stream_frac=1.0))
    assert 1 <= peak_concurrency(w) <= SMOKE.requests


# ---------------------------------------------------------------------------
# The oracle catches corruption
# ---------------------------------------------------------------------------

def test_oracle_flags_corrupted_path():
    """Negative control: corrupt one frame of one served path and the oracle
    must report it; otherwise the whole harness is a rubber stamp."""
    cfg = dataclasses.replace(SMOKE, stream_frac=0.0, requests=6)
    h = LoadHarness(cfg)
    orig = h.sched.fn

    def corrupting(padded, lengths):
        paths, scores = orig(padded, lengths)
        paths = paths.clone()
        paths[0, 0] = (paths[0, 0] + 1) % cfg.states   # one wrong frame
        return paths, scores

    h.sched.fn = corrupting
    report = h.run()
    assert not report["oracle"]["ok"]
    whats = {m["what"] for m in report["oracle"]["offline"]["mismatches"]}
    assert "path_vs_looped_spec" in whats


def test_oracle_flags_wrong_score():
    cfg = dataclasses.replace(SMOKE, stream_frac=0.0, requests=4)
    w = make_workload(cfg)
    spec, _ = resolve_spec(cfg)
    results = {}
    for rid in list(w.payloads)[:2]:
        p, s = viterbi_vanilla(w.hmm.log_pi, w.hmm.log_A,
                               torch.from_numpy(w.payloads[rid]))
        results[rid] = (p.numpy(), float(s))
    ora = oracle_check(spec, w.hmm, w.payloads, results)
    assert ora["ok"]
    rid0 = next(iter(results))
    results[rid0] = (results[rid0][0], results[rid0][1] + 1.0)
    ora2 = oracle_check(spec, w.hmm, w.payloads, results)
    assert not ora2["ok"]
    assert any(m["rid"] == rid0 for m in ora2["mismatches"])


def test_oracle_bounds_a_beam_by_the_optimum_up_to_rounding():
    """A beam that finds the optimal path of a long sequence passes: its
    path's score, summed in path order, exceeds `viterbi_numpy`'s DP sum
    of the same terms by 3.7e-4 here (float32 rounding), which the JAX
    oracle's absolute 1e-4 bound flags as beating the optimum."""
    from repro.core import FlashBSSpec as JFlashBS
    from repro.core.hmm import HMM as JHMM
    from repro_torch.core import FlashBSSpec, erdos_renyi_hmm
    from repro_torch.core import reference

    g = np.random.default_rng(2)
    hmm = erdos_renyi_hmm(g, 16, edge_prob=0.5, device="cpu")
    em = (g.standard_normal((511, 16)) * 2.0).astype(np.float32)
    spec = FlashBSSpec(beam_width=8)
    p, s = spec.run(hmm.log_pi, hmm.log_A, torch.from_numpy(em))
    lp, la = hmm.log_pi.numpy(), hmm.log_A.numpy()
    best, ns = reference.viterbi_numpy(lp, la, em)
    assert np.array_equal(p.numpy(), best)
    assert reference.path_score_numpy(lp, la, em, p.numpy()) > ns + 1e-4
    results, payloads = {0: (p.numpy(), float(s))}, {0: em}
    ora = oracle_check(spec, hmm, payloads, results)
    assert ora["ok"] and not ora["exact"], ora
    j_hmm = JHMM(*(np.asarray(x) for x in (lp, la, hmm.log_B.numpy())))
    j_ora = jlt.oracle_check(JFlashBS(beam_width=8), j_hmm, payloads, results)
    assert [m["what"] for m in j_ora["mismatches"]] == ["beam_beats_optimum"]


def test_oracle_flags_a_narrow_beams_score_in_jax_and_the_port_alike():
    """FLASH-BS at beam 16 (the budget-shrink drill's 2 KB rung) on a long
    request reports the initial pass's beam score while its stitched path
    scores higher: the port and the JAX package return the same path and
    score, and both oracles flag the reported score."""
    from repro.core import FlashBSSpec as JFlashBS
    from repro.core.hmm import HMM as JHMM
    from repro_torch.core import FlashBSSpec

    cfg = LoadConfig(seed=11, requests=16, states=64, edge_prob=0.253,
                     stream_frac=0.0, lengths=(128, 256, 511),
                     buckets=(128, 256, 512), device="cpu")
    w = make_workload(cfg)
    em = w.payloads[9]
    spec = FlashBSSpec(beam_width=16, parallelism=1)
    p, s = spec.run(w.hmm.log_pi, w.hmm.log_A, torch.from_numpy(em))
    hmm_np = [x.numpy() for x in (w.hmm.log_pi, w.hmm.log_A, w.hmm.log_B)]
    j_p, j_s = JFlashBS(beam_width=16, parallelism=1).run(
        hmm_np[0], hmm_np[1], em)
    assert np.array_equal(p.numpy(), np.asarray(j_p))
    assert np.float32(s) == np.float32(j_s)
    results, payloads = {9: (p.numpy(), float(s))}, {9: em}
    for ora in (oracle_check(spec, w.hmm, payloads, results),
                jlt.oracle_check(JFlashBS(beam_width=16, parallelism=1),
                                 JHMM(*hmm_np), payloads, results)):
        assert [m["what"] for m in ora["mismatches"]] == [
            "reported_score_vs_path"]
        got, want = ora["mismatches"][0]["got"], ora["mismatches"][0]["want"]
        assert want > got + 1e-2        # the path scores above the report
