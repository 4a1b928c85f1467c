"""repro_torch.serving: the batch tier (scheduler and alignment head).

The streaming and inflight tiers of `repro.serving` wait for ROADMAP
Queue 1 items 6 and 7.
"""

from .scheduler import Request, BatchScheduler
from .alignment import (AlignmentConfig, make_alignment_head,
                        make_lexicon_align_head)

__all__ = ["Request", "BatchScheduler", "AlignmentConfig",
           "make_alignment_head", "make_lexicon_align_head"]
