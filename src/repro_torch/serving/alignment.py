"""Forced-alignment serving head: emissions -> Viterbi paths, as in
`repro.serving.alignment`.

The head is a thin wrapper around `core.ViterbiDecoder`: the alignment config
resolves to a typed `DecodeSpec`, and the decoder object owns the device and
the ragged `lengths` contract.  ``mesh=``, the lexicon head and the
end-to-end encoder step wait for later slices (ROADMAP Queue 1 items 5, 8
and 11).
"""

from __future__ import annotations

import dataclasses

from ..core.decoder import ViterbiDecoder
from ..core.spec import as_decode_spec, spec_from_tunables


@dataclasses.dataclass(frozen=True)
class AlignmentConfig:
    """Legacy string-form alignment profile; `to_spec()` is the typed view.

    The default method is ``fused`` until FLASH-BS is ported (the JAX
    package's default is ``flash_bs``).  The JAX config's ``beam_width``,
    ``parallelism`` and ``chunk`` fields configure FLASH and FLASH-BS; they
    come back with those methods (ROADMAP Queue 1 item 4).
    """
    method: str = "fused"          # fused | vanilla

    def to_spec(self):
        spec, _ = spec_from_tunables(self.method, {})
        return spec


def make_alignment_head(hmm_log_pi, hmm_log_A, cfg, *, device=None):
    """Returns align(emissions (B, T, K), lengths=None) -> (paths, scores).

    `cfg` is a `DecodeSpec` (preferred) or a legacy `AlignmentConfig`.
    `lengths` (B,) gives each request's true frame count; pad frames run as
    tropical-identity steps, so results are bit-identical to unbatched
    decodes of the unpadded payloads.  This is the `decode_batch_fn`
    contract `BatchScheduler` expects.  ``device=None`` means ``cuda``.
    """
    dec = ViterbiDecoder(as_decode_spec(cfg), hmm_log_pi, hmm_log_A,
                         device=device)

    def align(em, lengths=None):
        return dec.decode_batch(em, lengths)

    align.decoder = dec
    return align


__all__ = ["AlignmentConfig", "make_alignment_head"]
