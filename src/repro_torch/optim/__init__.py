"""AdamW with ZeRO-1 specs and int8 error-feedback gradient accumulation,
as `repro.optim`."""

from .adamw import (AdamWConfig, global_norm, init_state, opt_state_specs,
                    schedule, update, zero1_specs)
from .compression import dequantize, ef_accumulate, init_ef_state, quantize

__all__ = ["AdamWConfig", "schedule", "init_state", "update", "global_norm",
           "zero1_specs", "opt_state_specs", "quantize", "dequantize",
           "ef_accumulate", "init_ef_state"]
