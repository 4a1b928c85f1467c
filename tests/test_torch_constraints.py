"""Parity of the port's constrained decoding (`repro_torch.core.constraints`,
the constrained specs and batch path) with the JAX package's on the CPU.

The cases are the vanilla and fused rows of tests/test_constraints.py, at its
sizes (K = 12, T = 24) and with its five constraints.  Inputs are made once
with numpy from a seed and handed to both packages; each constraint is built
twice from the same arguments, once from each package's classes.  At K = 12
the JAX fused path takes its ref fallback; the K = 128 case runs its Pallas
masked kernel in interpret mode.  The port runs its kernels' plain versions,
because the tensors lie on the CPU.

Tolerance: compiled penalties, paths and scores are bitwise equal to JAX's
and to the port's own dense `viterbi_vanilla` over `constrain_inputs`.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import constraints as j_constraints
from repro_torch import core as P
from repro_torch.core import constraints as p_constraints
from repro_torch.core import (BandConstraint, FusedSpec, LexiconConstraint,
                              VanillaSpec, ViterbiDecoder, constrain_inputs,
                              erdos_renyi_hmm, random_emissions,
                              spec_from_tunables, viterbi_vanilla,
                              with_constraint)
from repro_torch.kernels import ops

CPU = torch.device("cpu")
K, T = 12, 24
SPECS = {"vanilla": (P.VanillaSpec, J.VanillaSpec),
         "fused": (P.FusedSpec, J.FusedSpec)}


def _constraint_args():
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


ARGS = _constraint_args()
CONSTRAINTS = {n: getattr(P, cls)(**kw) for n, (cls, kw) in ARGS.items()}
J_CONSTRAINTS = {n: getattr(J, cls)(**kw) for n, (cls, kw) in ARGS.items()}


@pytest.fixture(scope="module")
def problem():
    """(port HMM, emissions) and their numpy copies.  edge_prob=1.0: a dense
    log_A, the regime the banded path's bit-identity needs."""
    g = np.random.default_rng(10)
    hmm = erdos_renyi_hmm(g, K, edge_prob=1.0, device=CPU)
    em = random_emissions(g, T, K, device=CPU)
    return hmm, em, (hmm.log_pi.numpy(), hmm.log_A.numpy(), em.numpy())


def _bitwise(got, want):
    """Port (path, score) against a port or JAX (path, score), bitwise."""
    pa, sa = got
    pb, sb = want
    pb = pb.numpy() if isinstance(pb, torch.Tensor) else np.asarray(pb)
    return (np.array_equal(pa.numpy(), pb)
            and np.float32(sa) == np.float32(np.asarray(sb)))


def _oracle(c, hmm, em):
    return viterbi_vanilla(*constrain_inputs(c, hmm.log_pi, hmm.log_A, em))


# ---------------------------------------------------------------------------
# Compile: penalties, infeasibility, API surface
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cname", sorted(ARGS))
def test_compiled_penalties_bitwise_equal_to_jax(cname):
    c, cj = CONSTRAINTS[cname], J_CONSTRAINTS[cname]
    got = p_constraints.compiled_penalties(c, K, T)
    want = j_constraints.compiled_penalties(cj, K, T)
    for pen, pen_j in zip(got, want):
        assert (pen is None) == (pen_j is None)
        if pen is not None:
            assert pen.dtype == np.float32
            assert np.array_equal(pen, pen_j)
            assert set(np.unique(pen)) <= {np.float32(0.0),
                                           np.float32(-1.0e9)}
    rows = p_constraints.step_penalty_rows(c, K, 0, T)
    rows_j = j_constraints.step_penalty_rows(cj, K, 0, T)
    assert (rows is None) == (rows_j is None)
    if rows is not None:
        assert np.array_equal(rows, got[2]) and np.array_equal(rows, rows_j)
    if cname in ("band", "short_band", "schedule"):
        # beyond the horizon: unconstrained (zeros)
        assert not p_constraints.step_penalty_rows(c, K, 10 * T, 3).any()
    assert c.live_states(K) == cj.live_states(K)
    assert c.mask_bytes(K, T) == cj.mask_bytes(K, T)


def _infeasible_cases(m):
    """The four infeasibility cases of tests/test_constraints.py, each a
    thunk on package `m` (its core and constraints modules)."""
    core, cons = m
    return {
        "empty_anchor": lambda: core.ScheduleConstraint(anchors=((0, ()),)),
        "no_anchors": lambda: core.ScheduleConstraint(anchors=()),
        "duplicate_anchor": lambda: core.ScheduleConstraint(
            anchors=((2, (1,)), (2, (3,)))),
        "dead_end": lambda: cons.compiled_penalties(
            core.TransitionMaskConstraint(edges=((0, 1),), init_states=(0,)),
            K, T),
        "lexicon_without_loops": lambda: cons.step_penalty(
            core.LexiconConstraint((((5,),),), self_loops=False,
                                   loop_words=False), K, T),
        "schedule_out_of_range": lambda: cons.compiled_penalties(
            core.ScheduleConstraint(anchors=((0, (K + 3,)),)), K, T),
        "edge_out_of_range": lambda: cons.compiled_penalties(
            core.TransitionMaskConstraint(edges=((0, K),)), K, T),
        "lexicon_out_of_range": lambda: cons.compiled_penalties(
            core.LexiconConstraint((((K, K + 1),),)), K, T),
    }


@pytest.mark.parametrize("case", sorted(_infeasible_cases((P, p_constraints))))
def test_infeasible_raise_the_same_value_error(case):
    with pytest.raises(ValueError) as want:
        _infeasible_cases((J, j_constraints))[case]()
    with pytest.raises(ValueError) as got:
        _infeasible_cases((P, p_constraints))[case]()
    assert str(got.value) == str(want.value)


def test_dead_end_raises_from_the_decoder_too(problem):
    hmm, em, _ = problem
    dead = P.TransitionMaskConstraint(edges=((0, 1),), init_states=(0,))
    with pytest.raises(ValueError, match="infeasible"):
        ViterbiDecoder(FusedSpec(constraint=dead), hmm.log_pi, hmm.log_A,
                       device="cpu").decode(em)
    looped = LexiconConstraint((((5,),),), self_loops=False, loop_words=True)
    assert p_constraints.step_penalty(looped, K, T) is not None


def test_constraints_hashable_and_replaceable():
    for c in CONSTRAINTS.values():
        assert hash(c) == hash(dataclasses.replace(c))
    band = CONSTRAINTS["band"]
    spec = with_constraint(FusedSpec(), band)
    assert spec.constraint == band and FusedSpec().constraint is None
    assert with_constraint(spec, None).constraint is None
    assert hash(spec) == hash(FusedSpec(constraint=band))
    assert VanillaSpec(constraint=band) != VanillaSpec()


def test_spec_and_legacy_surface_reject_constraint_like_jax():
    with pytest.raises(TypeError, match="ConstraintSpec") as got:
        VanillaSpec(constraint=42)
    with pytest.raises(TypeError) as want:
        J.VanillaSpec(constraint=42)
    assert str(got.value) == str(want.value)
    with pytest.raises(TypeError, match="constraint") as got:
        spec_from_tunables("vanilla", {"constraint": CONSTRAINTS["band"]})
    with pytest.raises(TypeError) as want:
        J.spec_from_tunables("vanilla", {"constraint": J_CONSTRAINTS["band"]})
    assert str(got.value) == str(want.value)
    with pytest.raises(TypeError, match="ConstraintSpec"):
        p_constraints.compiled_penalties(object(), K, T)


def test_constrain_inputs_matches_jax(problem):
    hmm, em, (lp, la, e) = problem
    for cname, c in CONSTRAINTS.items():
        got = constrain_inputs(c, hmm.log_pi, hmm.log_A, em)
        want = J.constrain_inputs(J_CONSTRAINTS[cname], jnp.asarray(lp),
                                  jnp.asarray(la), jnp.asarray(e))
        for x, y in zip(got, want):
            assert np.array_equal(x.numpy(), np.asarray(y)), cname
    batch = em[None].expand(2, T, K)
    _, _, em_b = constrain_inputs(CONSTRAINTS["band"], hmm.log_pi, hmm.log_A,
                                  batch)
    assert em_b.shape == (2, T, K)
    assert torch.equal(em_b[1], constrain_inputs(
        CONSTRAINTS["band"], hmm.log_pi, hmm.log_A, em)[2])


# ---------------------------------------------------------------------------
# Single sequence: every constraint, vanilla and fused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cname", sorted(ARGS))
@pytest.mark.parametrize("method", sorted(SPECS))
def test_constrained_run_matches_jax_and_masked(problem, method, cname):
    hmm, em, (lp, la, e) = problem
    c, cj = CONSTRAINTS[cname], J_CONSTRAINTS[cname]
    spec_cls, jspec_cls = SPECS[method]
    got = spec_cls(constraint=c).run(hmm.log_pi, hmm.log_A, em)
    assert got[0].dtype == torch.int32 and got[0].shape == (T,)
    want_j = jspec_cls(constraint=cj).run(lp, la, e)
    assert _bitwise(got, want_j), (method, cname)
    masked = constrain_inputs(c, hmm.log_pi, hmm.log_A, em)
    assert _bitwise(got, spec_cls().run(*masked)), (method, cname)
    assert _bitwise(got, viterbi_vanilla(*masked)), (method, cname)
    assert np.isfinite(float(got[1]))


def test_fused_banded_path_runs_windowed(problem):
    """The covering band decodes through the banded op, still bit-identical,
    and every decoded state lies inside the band."""
    hmm, em, (lp, la, e) = problem
    band = CONSTRAINTS["band"]
    got = FusedSpec(constraint=band).run(hmm.log_pi, hmm.log_A, em)
    assert _bitwise(got, _oracle(band, hmm, em))
    direct = ops.viterbi_decode_banded(hmm.log_pi, hmm.log_A, em,
                                       band.centers[:T], width=band.width)
    assert _bitwise(got, direct)
    assert _bitwise(got, J.FusedSpec(constraint=J_CONSTRAINTS["band"]).run(
        lp, la, e))
    centers = np.clip(np.asarray(band.centers)[:T], 0, K - 1)
    assert (np.abs(got[0].numpy() - centers) <= band.width).all()


def test_masked_kernel_lane_aligned():
    """K = 128: the JAX side runs its Pallas masked kernel (interpret)."""
    Kb, Tb = 128, 16
    g = np.random.default_rng(3)
    hmm = erdos_renyi_hmm(g, Kb, edge_prob=1.0, device=CPU)
    em = random_emissions(g, Tb, Kb, device=CPU)
    words = (((0, 1, 2),), ((40, 41),), ((100, 101, 102),))
    got = FusedSpec(constraint=LexiconConstraint(words)).run(
        hmm.log_pi, hmm.log_A, em)
    assert _bitwise(got, _oracle(LexiconConstraint(words), hmm, em))
    want = J.FusedSpec(constraint=J.LexiconConstraint(words)).run(
        hmm.log_pi.numpy(), hmm.log_A.numpy(), em.numpy())
    assert _bitwise(got, want)


# ---------------------------------------------------------------------------
# Ragged batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cname", ("band", "lexicon", "schedule"))
@pytest.mark.parametrize("method", sorted(SPECS))
def test_batched_ragged_matches_jax_and_masked(problem, method, cname):
    hmm, _, (lp, la, _) = problem
    c, cj = CONSTRAINTS[cname], J_CONSTRAINTS[cname]
    spec_cls, jspec_cls = SPECS[method]
    B = 4
    em = random_emissions(np.random.default_rng(17), B * T, K,
                          device=CPU).reshape(B, T, K)
    lengths = np.array([T, T - 5, 7, 1], np.int32)
    dec = ViterbiDecoder(spec_cls(constraint=c), hmm.log_pi, hmm.log_A,
                         device="cpu")
    paths, scores = dec.decode_batch(em, lengths)
    jdec = J.ViterbiDecoder(jspec_cls(constraint=cj), lp, la)
    paths_j, scores_j = jdec.decode_batch(em.numpy(), jnp.asarray(lengths))
    assert np.array_equal(paths.numpy(), np.asarray(paths_j)), (method, cname)
    assert np.array_equal(scores.numpy(), np.asarray(scores_j)), (method, cname)
    mlp, mla, mem = constrain_inputs(c, hmm.log_pi, hmm.log_A, em)
    p_m, s_m = ViterbiDecoder(spec_cls(), mlp, mla,
                              device="cpu").decode_batch(mem, lengths)
    assert torch.equal(paths, p_m) and torch.equal(scores, s_m)
    for i, L in enumerate(lengths):
        assert _bitwise((paths[i, :L], scores[i]), _oracle(c, hmm, em[i, :L]))


@pytest.mark.parametrize("method", sorted(SPECS))
def test_batched_T1_takes_the_masked_inputs(problem, method):
    hmm, _, (lp, la, _) = problem
    c = CONSTRAINTS["lexicon"]
    em = random_emissions(np.random.default_rng(2), 3, K,
                          device=CPU).reshape(3, 1, K)
    got = P.viterbi_decode_batch(em, hmm.log_pi, hmm.log_A, method=method,
                                 constraint=c)
    want = J.viterbi_decode_batch(em.numpy(), lp, la, method=method,
                                  constraint=J_CONSTRAINTS["lexicon"])
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))


# ---------------------------------------------------------------------------
# Randomised sweeps and hypothesis properties
# ---------------------------------------------------------------------------

def _random_band(m, rng, horizon):
    centers = tuple(int(c) for c in rng.integers(0, K, size=horizon))
    return m.BandConstraint(centers=centers, width=int(rng.integers(1, K)))


def _random_trie(m, rng):
    words, pool = [], rng.permutation(K)
    i = 0
    for _ in range(int(rng.integers(1, 4))):
        n = int(rng.integers(1, 4))
        words.append((tuple(int(s) for s in pool[i:i + n]),))
        i += n
    return m.LexiconConstraint(tuple(words))


def _random_constraints(m, seed):
    rng = np.random.default_rng(seed)
    return (_random_band(m, rng, T), _random_band(m, rng, T // 3),
            _random_trie(m, rng))


@pytest.mark.parametrize("seed", range(5))
def test_random_band_and_trie_masks_bitwise(problem, seed):
    hmm, em, (lp, la, e) = problem
    for c, cj in zip(_random_constraints(P, seed),
                     _random_constraints(J, seed)):
        oracle = _oracle(c, hmm, em)
        for method, (spec_cls, jspec_cls) in SPECS.items():
            got = spec_cls(constraint=c).run(hmm.log_pi, hmm.log_A, em)
            assert _bitwise(got, oracle), (method, c)
            assert _bitwise(got, jspec_cls(constraint=cj).run(lp, la, e)), \
                (method, c)


def _check_property(problem, c, cj):
    hmm, em, (lp, la, e) = problem
    masked = constrain_inputs(c, hmm.log_pi, hmm.log_A, em)
    oracle = viterbi_vanilla(*masked)
    assert _bitwise(oracle, J.viterbi_vanilla(
        *J.constrain_inputs(cj, jnp.asarray(lp), jnp.asarray(la),
                            jnp.asarray(e))))
    for spec_cls in (VanillaSpec, FusedSpec):
        got = spec_cls(constraint=c).run(hmm.log_pi, hmm.log_A, em)
        assert _bitwise(got, oracle), (spec_cls.method, c)


def test_hypothesis_band_property(problem):
    hypothesis = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hypothesis.settings(max_examples=20, deadline=None)
    @hypothesis.given(
        centers=st.lists(st.integers(0, K - 1), min_size=1, max_size=T),
        width=st.integers(0, K))
    def check(centers, width):
        c = BandConstraint(centers=tuple(centers), width=width)
        cj = J.BandConstraint(centers=tuple(centers), width=width)
        try:
            p_constraints.compiled_penalties(c, K, T)
        except ValueError:
            with pytest.raises(ValueError):     # infeasible on both sides
                j_constraints.compiled_penalties(cj, K, T)
            return
        _check_property(problem, c, cj)

    check()


def test_hypothesis_trie_property(problem):
    hypothesis = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hypothesis.settings(max_examples=20, deadline=None)
    @hypothesis.given(st.lists(
        st.lists(st.integers(0, K - 1), min_size=1, max_size=4,
                 unique=True).map(tuple),
        min_size=1, max_size=3))
    def check(prons):
        words = tuple((p,) for p in prons)
        _check_property(problem, LexiconConstraint(words),
                        J.LexiconConstraint(words))

    check()
