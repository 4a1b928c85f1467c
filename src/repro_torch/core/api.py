"""The legacy string dispatch, as in `repro.core.api`: a thin shim over the
typed specs.

    path, score = viterbi_decode(emissions, log_pi, log_A, method="flash", ...)

builds the spec for `method` from the tunables and runs it, so the result is
bit-identical to `ViterbiDecoder(spec, log_pi, log_A).decode`.  A tunable
the method does not consume raises a `DeprecationWarning`.  `METHODS` holds
every method of the JAX package, the streaming ``online`` and
``online_beam`` included.  Batches go through `viterbi_decode_batch`
(`core/batch.py`), whose methods are the JAX package's `BATCH_METHODS`.
"""

from __future__ import annotations

import warnings
from typing import Any

from .batch import BATCH_METHODS, viterbi_decode_batch
from .hmm import HMM
from .spec import SPEC_BY_METHOD, spec_from_tunables

METHODS = tuple(SPEC_BY_METHOD)

_UNSET: Any = object()


def viterbi_decode(
    emissions,
    log_pi,
    log_A,
    method: str = "flash",
    *,
    parallelism: int = _UNSET,
    lanes: int | None = _UNSET,
    beam_width: int = _UNSET,
    chunk: int = _UNSET,
    seg_len: int | None = _UNSET,
    stream_chunk: int = _UNSET,
    max_lag: int | None = _UNSET,
    bt: int = _UNSET,
    constraint: Any = _UNSET,
):
    """Decode the max-likelihood state path of (T, K) emissions.

    Back-compat shim: builds the typed spec for `method` and runs it.
    Returns (path (T,) int32, score).  Tunables the method does not consume
    raise a DeprecationWarning.  `constraint=` raises `TypeError`: a
    constrained decode needs a typed spec, so that a constraint is never
    dropped silently.
    """
    if constraint is not _UNSET:
        raise TypeError(
            "viterbi_decode() does not take constraint=; build a typed spec "
            "(e.g. FusedSpec(constraint=...)) and use ViterbiDecoder or "
            "spec.run")
    passed = {name: value for name, value in (
        ("parallelism", parallelism), ("lanes", lanes),
        ("beam_width", beam_width), ("chunk", chunk), ("seg_len", seg_len),
        ("stream_chunk", stream_chunk), ("max_lag", max_lag), ("bt", bt),
    ) if value is not _UNSET}
    spec, ignored = spec_from_tunables(method, passed)
    if ignored:
        warnings.warn(
            f"viterbi_decode(method={method!r}) ignores tunable(s) "
            f"{', '.join(sorted(ignored))}; construct a "
            f"{type(spec).__name__} to get eager validation instead",
            DeprecationWarning, stacklevel=2)
    return spec.run(log_pi, log_A, emissions)


def viterbi_decode_hmm(obs, hmm: HMM, method: str = "flash", **kwargs: Any):
    """Decode discrete observations under an `HMM` container."""
    return viterbi_decode(hmm.emissions(obs), hmm.log_pi, hmm.log_A,
                          method=method, **kwargs)


__all__ = ["viterbi_decode", "viterbi_decode_hmm", "viterbi_decode_batch",
           "METHODS", "BATCH_METHODS"]
