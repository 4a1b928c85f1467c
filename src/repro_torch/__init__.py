"""FLASH Viterbi on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch counterpart of the JAX package `repro`, module for module
(`core/`, `kernels/`, `serving/`, `launch/`, `models/`, `configs/`,
`runtime/`, `checkpointing/`, `train/`, `optim/`, `data/`, `sharding/`).  It imports torch and numpy and
never jax.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without a GPU and without ``device="cpu"`` they raise.

The hand-written Hopper kernels live in `kernels/csrc/` and are built with
nvcc at first use (`kernels/build.py`).  Importing the package builds nothing.
"""
