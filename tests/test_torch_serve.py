"""Parity of the port's serving tier (`repro_torch.serving`, `launch.serve`)
with the JAX package's on the CPU.

The HMM is made by the JAX package and carried across with `HMM.from_numpy`;
the same numpy requests go through both schedulers and alignment heads.
Tolerance: every served path and score is bitwise equal.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import FusedSpec as JFused, left_to_right_hmm as j_l2r
from repro.core import VanillaSpec as JVanilla
from repro.core import ResourceBudget as JBudget, plan as j_plan
from repro.serving.alignment import AlignmentConfig as JAlignmentConfig
from repro.serving.alignment import make_alignment_head as j_head
from repro.serving.alignment import make_lexicon_align_head as j_lex_head
from repro.serving.scheduler import BatchScheduler as JScheduler
from repro_torch.core import (HMM, FlashBSSpec, FusedSpec, LexiconConstraint,
                              VanillaSpec, ViterbiDecoder, as_decode_spec,
                              with_constraint)
from repro_torch.launch import serve
from repro_torch.serving import (AlignmentConfig, BatchScheduler,
                                 make_alignment_head, make_lexicon_align_head)

K = 16


@pytest.fixture(scope="module")
def served():
    """(JAX results, numpy requests, HMM) for one seeded request stream."""
    jhmm = j_l2r(jax.random.key(0), K, 8)
    hmm = HMM.from_numpy(np.asarray(jhmm.log_pi), np.asarray(jhmm.log_A),
                         np.asarray(jhmm.log_B), device="cpu")
    rng = np.random.default_rng(0)
    reqs = [(rng.standard_normal((T, K)) * 2.0).astype(np.float32)
            for T in rng.choice([5, 12, 16, 20, 31], size=7)]
    sched = JScheduler(j_head(jhmm.log_pi, jhmm.log_A, JFused()), max_batch=3,
                       buckets=(16, 32))
    for em in reqs:
        sched.submit(em)
    done = {r.rid: r.result for r in sched.drain()}
    return done, reqs, hmm


def _serve(head_or_decoder, reqs):
    sched = BatchScheduler(head_or_decoder, max_batch=3, buckets=(16, 32))
    for em in reqs:
        sched.submit(em)
    return {r.rid: r.result for r in sched.drain()}, sched


def _serve_jax(head, reqs):
    sched = JScheduler(head, max_batch=3, buckets=(16, 32))
    for em in reqs:
        sched.submit(em)
    return {r.rid: r.result for r in sched.drain()}


#: each port config beside the JAX config it is held to
HEAD_CFGS = [(FusedSpec(), JFused()), (VanillaSpec(), JVanilla()),
             (AlignmentConfig(), JAlignmentConfig()),
             (AlignmentConfig("vanilla"), JAlignmentConfig("vanilla"))]


@pytest.mark.parametrize("cfg", [c for c, _ in HEAD_CFGS])
def test_scheduler_and_alignment_head_match_jax(served, cfg):
    """Every head against JAX's head of the same config on the same
    requests; `AlignmentConfig()` is FLASH-BS in both packages."""
    _, reqs, hmm = served
    j_cfg = dict((repr(c), j) for c, j in HEAD_CFGS)[repr(cfg)]
    done_j = _serve_jax(j_head(hmm.log_pi.numpy(), hmm.log_A.numpy(), j_cfg),
                        reqs)
    head = make_alignment_head(hmm.log_pi, hmm.log_A, cfg, device="cpu")
    done, sched = _serve(head, reqs)
    assert sched.stats["requests"] == len(reqs)
    assert done.keys() == done_j.keys()
    for rid, (path, score) in done.items():
        assert isinstance(path, np.ndarray)         # converted once per batch
        assert path.shape == (len(reqs[rid]),)
        assert np.array_equal(path, done_j[rid][0]), rid
        assert score == done_j[rid][1], rid


def test_scheduler_accepts_port_decoder(served):
    done_j, reqs, hmm = served
    dec = ViterbiDecoder(FusedSpec(), hmm.log_pi, hmm.log_A, device="cpu")
    done, _ = _serve(dec, reqs)
    for rid, (path, score) in done.items():
        assert np.array_equal(path, done_j[rid][0]) and score == done_j[rid][1]


def test_alignment_head_default_is_fused_and_unported_raise():
    """The default profile is the JAX package's FLASH-BS (beam 128, P = 8,
    chunk 128, whole layers); the streaming methods convert to the same
    specs as the JAX config's."""
    import dataclasses
    spec = AlignmentConfig().to_spec()
    assert spec == FlashBSSpec(lanes=None)
    assert dataclasses.asdict(spec) == dataclasses.asdict(
        JAlignmentConfig().to_spec())
    assert AlignmentConfig("fused", beam_width=8).to_spec() == FusedSpec()
    for method in ("online", "online_beam"):
        spec = AlignmentConfig(method, beam_width=64, chunk=32).to_spec()
        spec_j = JAlignmentConfig(method, beam_width=64, chunk=32).to_spec()
        assert type(spec).__name__ == type(spec_j).__name__
        assert dataclasses.asdict(spec) == dataclasses.asdict(spec_j)


#: the serve lexicon's shape at K = 16: word w is the chain (4w .. 4w+3)
WORDS = tuple(((4 * w, 4 * w + 1, 4 * w + 2, 4 * w + 3),)
              for w in range(K // 4))


@pytest.mark.parametrize("cfg", [None, FusedSpec(), VanillaSpec(),
                                 AlignmentConfig("vanilla")])
def test_lexicon_align_head_matches_jax(served, cfg):
    """The scheduler-driven lexicon head against JAX's on the same requests:
    the default (FLASH-BS) head against JAX's default head, the exact heads
    against JAX's fused head (exact methods decode alike)."""
    _, reqs, hmm = served
    jlp, jla = (np.asarray(hmm.log_pi), np.asarray(hmm.log_A))
    jhead = j_lex_head(jlp, jla, WORDS, cfg=None if cfg is None else JFused())
    done_j = _serve_jax(jhead, reqs)

    head = make_lexicon_align_head(hmm.log_pi, hmm.log_A, WORDS, cfg=cfg,
                                   device="cpu")
    base = as_decode_spec(AlignmentConfig() if cfg is None else cfg)
    assert head.decoder.spec == with_constraint(base, head.constraint)
    assert isinstance(head.constraint, LexiconConstraint)
    done, _ = _serve(head, reqs)
    assert done.keys() == done_j.keys()
    for rid, (path, score) in done.items():
        assert np.array_equal(path, done_j[rid][0]), rid
        assert score == done_j[rid][1], rid
        assert np.isin(path, np.arange(K)).all()


@pytest.mark.parametrize("method", ["fused", "vanilla"])
def test_serve_main_smoke(capsys, method):
    done = serve.main(["--device", "cpu", "--states", "16", "--requests", "4",
                       "--method", method])
    assert len(done) == 4 and all(r.done for r in done)
    out = capsys.readouterr().out
    assert "served 4 requests" in out
    assert "mean=0.00e+00 max=0.00e+00" in out


def test_serve_main_rejects_unported_and_missing_device(capsys):
    """`--beam`, `--parallelism` and `--budget-kb` work as in the JAX serve
    (the planner line is the JAX planner's); an unknown method raises, and
    without `--device cpu` the serve raises on a host without a GPU."""
    done = serve.main(["--device", "cpu", "--states", "16", "--requests", "3",
                       "--beam", "4", "--parallelism", "2"])
    assert len(done) == 3 and all(r.done for r in done)
    done = serve.main(["--device", "cpu", "--states", "16", "--requests", "2",
                       "--budget-kb", "2"])
    assert len(done) == 2
    out = capsys.readouterr().out
    p = j_plan(16, 512, JBudget(memory_bytes=2048), batch=8)
    assert f"planner: budget=2KiB x batch 8 -> {p.spec}  [{p.why}]" in out
    with pytest.raises(ValueError, match="unknown method"):
        serve.main(["--device", "cpu", "--method", "nope"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.main(["--states", "16", "--requests", "1"])


def test_serve_main_default_is_flash_bs(capsys):
    """The default serve is FLASH-BS (beam 128 >= K = 16: exact)."""
    done = serve.main(["--device", "cpu", "--states", "16", "--requests", "4"])
    assert len(done) == 4
    assert "mean=0.00e+00 max=0.00e+00" in capsys.readouterr().out
