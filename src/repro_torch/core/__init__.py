"""FLASH Viterbi core on PyTorch: the HMM substrate, the paper's algorithms
and baselines, the batched entry point, streaming decode, constrained
decoding, typed specs, the planner, the decoder object and the legacy string
dispatch."""

from .hmm import (HMM, NEG_INF, erdos_renyi_hmm, left_to_right_hmm,
                  sample_observations, path_score, relative_error,
                  random_emissions)
from .device import resolve_device
from .vanilla import (viterbi_vanilla, viterbi_vanilla_masked,
                      viterbi_vanilla_batched)
from .checkpoint_viterbi import viterbi_checkpoint
from .flash import flash_viterbi, plan_padding, pad_emissions
from .flash_bs import flash_bs_viterbi, pad_state_space
from .beam_static import beam_static_viterbi, beam_static_mp_viterbi
from .assoc import viterbi_assoc
from .online import (OnlineViterbiDecoder, OnlineBeamDecoder,
                     SlotViterbiDecoder, viterbi_online, viterbi_online_beam)
from .batch import viterbi_decode_batch, BATCH_METHODS
from .constraints import (ConstraintSpec, TransitionMaskConstraint,
                          BandConstraint, LexiconConstraint,
                          ScheduleConstraint, constrain_inputs,
                          compiled_penalties, with_constraint,
                          banded_state_bytes)
from .spec import (ResourceBudget, DecodeSpec, VanillaSpec, CheckpointSpec,
                   FlashSpec, FlashBSSpec, BeamStaticSpec, BeamStaticMPSpec,
                   AssocSpec, FusedSpec, OnlineSpec, OnlineBeamSpec,
                   SPEC_BY_METHOD, spec_from_tunables, as_decode_spec)
from .planner import (decoder_state_bytes, spec_state_bytes, DecodePlan, plan,
                      online_session_bytes, inflight_state_bytes,
                      AdmissionPlan, plan_admission)
from .decoder import ViterbiDecoder
from .api import viterbi_decode, viterbi_decode_hmm, METHODS

__all__ = [
    "HMM", "NEG_INF", "erdos_renyi_hmm", "left_to_right_hmm",
    "sample_observations", "path_score", "relative_error", "random_emissions",
    "resolve_device",
    "viterbi_vanilla", "viterbi_vanilla_masked", "viterbi_vanilla_batched",
    "viterbi_checkpoint",
    "flash_viterbi", "plan_padding", "pad_emissions",
    "flash_bs_viterbi", "pad_state_space",
    "beam_static_viterbi", "beam_static_mp_viterbi", "viterbi_assoc",
    "OnlineViterbiDecoder", "OnlineBeamDecoder", "SlotViterbiDecoder",
    "viterbi_online", "viterbi_online_beam",
    "viterbi_decode_batch", "BATCH_METHODS",
    # constrained decoding
    "ConstraintSpec", "TransitionMaskConstraint", "BandConstraint",
    "LexiconConstraint", "ScheduleConstraint", "constrain_inputs",
    "compiled_penalties", "with_constraint", "banded_state_bytes",
    # typed spec / planner / decoder API
    "ResourceBudget", "DecodeSpec", "VanillaSpec", "CheckpointSpec",
    "FlashSpec", "FlashBSSpec", "BeamStaticSpec", "BeamStaticMPSpec",
    "AssocSpec", "FusedSpec", "OnlineSpec", "OnlineBeamSpec",
    "SPEC_BY_METHOD", "spec_from_tunables", "as_decode_spec",
    "decoder_state_bytes", "spec_state_bytes", "DecodePlan", "plan",
    "online_session_bytes", "inflight_state_bytes",
    "AdmissionPlan", "plan_admission",
    "ViterbiDecoder",
    # legacy string dispatch (thin shim over the specs)
    "viterbi_decode", "viterbi_decode_hmm", "METHODS",
]
