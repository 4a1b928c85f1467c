"""FLASH Viterbi core on PyTorch: the HMM substrate, the exact decoders, the
batched entry point, constrained decoding, typed specs and the decoder
object."""

from .hmm import (HMM, NEG_INF, erdos_renyi_hmm, left_to_right_hmm,
                  sample_observations, path_score, relative_error,
                  random_emissions)
from .device import resolve_device
from .vanilla import (viterbi_vanilla, viterbi_vanilla_masked,
                      viterbi_vanilla_batched)
from .batch import viterbi_decode_batch, BATCH_METHODS
from .constraints import (ConstraintSpec, TransitionMaskConstraint,
                          BandConstraint, LexiconConstraint,
                          ScheduleConstraint, constrain_inputs,
                          compiled_penalties, with_constraint,
                          banded_state_bytes)
from .spec import (ResourceBudget, DecodeSpec, VanillaSpec, FusedSpec,
                   SPEC_BY_METHOD, spec_from_tunables, as_decode_spec)
from .decoder import ViterbiDecoder

__all__ = [
    "HMM", "NEG_INF", "erdos_renyi_hmm", "left_to_right_hmm",
    "sample_observations", "path_score", "relative_error", "random_emissions",
    "resolve_device",
    "viterbi_vanilla", "viterbi_vanilla_masked", "viterbi_vanilla_batched",
    "viterbi_decode_batch", "BATCH_METHODS",
    # constrained decoding
    "ConstraintSpec", "TransitionMaskConstraint", "BandConstraint",
    "LexiconConstraint", "ScheduleConstraint", "constrain_inputs",
    "compiled_penalties", "with_constraint", "banded_state_bytes",
    "ResourceBudget", "DecodeSpec", "VanillaSpec", "FusedSpec",
    "SPEC_BY_METHOD", "spec_from_tunables", "as_decode_spec",
    "ViterbiDecoder",
]
