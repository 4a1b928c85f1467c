"""Fault-handling runtime: heartbeats, straggler detection, supervised loops."""

from .fault import HeartbeatMonitor, StragglerDetector, SupervisedLoop

__all__ = ["HeartbeatMonitor", "StragglerDetector", "SupervisedLoop"]
