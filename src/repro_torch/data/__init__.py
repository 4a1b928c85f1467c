"""Deterministic, resumable synthetic data pipelines, as `repro.data`."""

from .pipeline import (EmissionPipelineConfig, HMMEmissionPipeline,
                       SyntheticTokenPipeline, TokenPipelineConfig)

__all__ = ["TokenPipelineConfig", "SyntheticTokenPipeline",
           "EmissionPipelineConfig", "HMMEmissionPipeline"]
