"""Deterministic, resumable synthetic data pipelines, as `repro.data`."""

from .pipeline import (EmissionPipelineConfig, HMMEmissionPipeline,
                       SyntheticTokenPipeline, TokenPipelineConfig,
                       shard_rows)

__all__ = ["TokenPipelineConfig", "SyntheticTokenPipeline", "shard_rows",
           "EmissionPipelineConfig", "HMMEmissionPipeline"]
