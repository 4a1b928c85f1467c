"""Checkpointing: the async, atomic, keep-N manager and elastic rescaling."""

from .manager import CheckpointManager
from .elastic import abstract_target_mesh, plan_rescale, reshard

__all__ = ["CheckpointManager", "abstract_target_mesh", "plan_rescale",
           "reshard"]
