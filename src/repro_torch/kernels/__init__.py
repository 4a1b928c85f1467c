"""Hand-written Hopper kernels for the FLASH Viterbi hot paths.

Layout: ``csrc/<name>.cu`` CUDA sources with a plain C interface,
`build.py` (nvcc for sm_90a, ctypes loading), ``<name>.py`` wrappers with
launch counters, `ops.py` public wrappers, `ref.py` plain PyTorch versions.
"""

from . import ops, ref, viterbi_dp

__all__ = ["ops", "ref", "viterbi_dp"]
