"""Deterministic, resumable synthetic data pipelines, as
`repro.data.pipeline`.

Every batch is a pure function of (seed, step): after a restart the loader
resumes from the checkpointed step with bit-identical data and no state
shared between hosts.  Batches are numpy arrays on the host; the caller
moves them to its device.  `sharded_batch` gives a rank of a mesh its rows
of a step's batch, in the order the sharded train step reads them
(`shard_rows`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.hmm import HMM, sample_observations
from ..sharding.placement import data_axes
from ..sharding.rules import SINGLE_POD_RULES


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_image_tokens: int = 0
    d_model: int = 0              # for embeds/image modalities
    kind: str = "tokens"          # tokens | embeds | vlm


class SyntheticTokenPipeline:
    """Markov-ish synthetic token stream (not iid: learnable structure, so a
    training run's loss demonstrably decreases).  Its batches are bitwise
    the JAX package's: the same numpy draws in the same order."""

    def __init__(self, cfg: TokenPipelineConfig):
        self.cfg = cfg

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng((self.cfg.seed * 1_000_003 + step)
                                     & 0x7FFFFFFF)

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = self._rng(step)
        B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab
        if cfg.kind == "embeds":
            emb = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
            labels = rng.integers(0, V, (B, S))
            mask = (rng.random((B, S)) < 0.3).astype(np.float32)  # masked pred
            return {"embeds": emb, "labels": labels.astype(np.int32),
                    "mask": mask}
        # order-1 markov chain with banded transitions: next ~ cur + U(-8, 8)
        toks = np.zeros((B, S), dtype=np.int64)
        toks[:, 0] = rng.integers(0, V, B)
        jumps = rng.integers(-8, 9, (B, S))
        for t in range(1, S):
            toks[:, t] = (toks[:, t - 1] + jumps[:, t]) % V
        labels = np.roll(toks, -1, axis=1)
        mask = np.ones((B, S), dtype=np.float32)
        mask[:, -1] = 0.0
        out = {"tokens": toks.astype(np.int32),
               "labels": labels.astype(np.int32), "mask": mask}
        if cfg.kind == "vlm":
            n = cfg.num_image_tokens
            out["tokens"] = out["tokens"][:, : S - n]
            out["image_embeds"] = rng.standard_normal(
                (B, n, cfg.d_model), dtype=np.float32)
            out["mask"][:, :n] = 0.0
        return out

    def sharded_batch(self, step: int, mesh, accum_steps: int = 1,
                      rules=SINGLE_POD_RULES) -> dict:
        """This rank's rows of ``batch(step)`` on `mesh`, whose batch axes
        `rules` name (`shard_rows`): what JAX's ``sharded_batch`` places
        on this rank's devices, as the train step's microbatches read
        it."""
        rows = shard_rows(self.cfg.global_batch, mesh, accum_steps,
                          data_axes(rules, mesh))
        return {k: v[rows] for k, v in self.batch(step).items()}


def shard_rows(n: int, mesh, accum_steps: int, axes) -> np.ndarray:
    """The rows this rank holds of a batch of `n` rows that the train step
    splits into `accum_steps` microbatches, each split over the data ranks
    along `axes` (row-major over a tuple): JAX reshapes the global batch
    to (A, n / A, ...), so microbatch i is rows i n/A .. (i + 1) n/A, and
    data rank r holds rows i n/A + r n/(A R) .. i n/A + (r + 1) n/(A R) of
    it (R ranks).  Microbatch by microbatch, in order; a contiguous slice
    a rank would group other rows into its microbatches."""
    A, R = accum_steps, mesh.axis_size(axes)
    if n % (A * R):
        raise ValueError(f"a batch of {n} rows does not split into {A} "
                         f"microbatches over {R} data ranks")
    per, r = n // (A * R), mesh.index(axes)
    return np.concatenate([np.arange(i * n // A + r * per,
                                     i * n // A + (r + 1) * per)
                           for i in range(A)])


@dataclasses.dataclass(frozen=True)
class EmissionPipelineConfig:
    num_states: int
    seq_len: int
    batch: int
    seed: int = 0


class HMMEmissionPipeline:
    """Batches of (T, K) emission matrices for the decoding benchmarks and
    the alignment-serving path, deterministic per step like the token
    pipeline.  Each step samples its observation sequences with
    `core.hmm.sample_observations` from a numpy generator seeded by (seed,
    step); JAX's draws from ``jax.random``, so the bits differ from the JAX
    package's (the distribution is the same)."""

    def __init__(self, cfg: EmissionPipelineConfig, hmm: HMM):
        self.cfg = cfg
        self.hmm = hmm

    def batch(self, step: int) -> dict:
        """{"obs": (batch, T) int64, "emissions": (batch, T, K) float32},
        on the HMM's device."""
        g = np.random.default_rng([self.cfg.seed, step])
        obs = torch.stack([sample_observations(g, self.hmm,
                                               self.cfg.seq_len)[1]
                           for _ in range(self.cfg.batch)])
        ems = torch.stack([self.hmm.emissions(o) for o in obs])
        return {"obs": obs, "emissions": ems}


__all__ = ["TokenPipelineConfig", "SyntheticTokenPipeline", "shard_rows",
           "EmissionPipelineConfig", "HMMEmissionPipeline"]
