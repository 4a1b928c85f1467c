"""repro_torch.serving: the batch tier (scheduler, alignment head and the
end-to-end encoder step), the streaming tier (stream) and continuous inflight batching (inflight), as in
`repro.serving`."""

from .scheduler import Request, BatchScheduler
from .alignment import (AlignmentConfig, make_alignment_head,
                        make_lexicon_align_head, make_e2e_align_step)
from .stream import StreamConfig, StreamSession, StreamMux
from .inflight import InflightScheduler, AdmissionRejected

__all__ = ["Request", "BatchScheduler", "AlignmentConfig",
           "make_alignment_head", "make_lexicon_align_head",
           "make_e2e_align_step",
           "StreamConfig", "StreamSession", "StreamMux",
           "InflightScheduler", "AdmissionRejected"]
