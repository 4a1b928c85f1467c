"""Hand-written Hopper kernels for the FLASH Viterbi hot paths.

Layout: ``csrc/<name>.cu`` CUDA sources with a plain C interface,
`build.py` (nvcc for sm_90a, ctypes loading), ``<name>.py`` wrappers with
launch counters, `ops.py` public wrappers, `ref.py` plain PyTorch versions,
`work.py` each entry's bytes and operations.
"""

from . import beam_stream, ops, ref, tropical, viterbi_dp, work

_WRAPPERS = (viterbi_dp, beam_stream, tropical)


def launch_counts() -> dict[str, int]:
    """Every kernel's launches since the last `reset_launches()`."""
    return {name: n for m in _WRAPPERS for name, n in m.launches.items()}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for m in _WRAPPERS:
        m.reset_launches()


__all__ = ["beam_stream", "ops", "ref", "tropical", "viterbi_dp", "work",
           "launch_counts", "reset_launches"]
