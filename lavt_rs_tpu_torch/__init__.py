"""PyTorch + CUDA port of lavt_rs_tpu for NVIDIA Hopper (H100).

Lays out like the JAX package (config, ops, models, convert, eval) and
keeps the reference PyTorch state-dict names.  Imports neither JAX nor the
JAX package.  The hand-written kernels live in `csrc/` and are built with
nvcc on their first launch (ops/cuda_lib.py).
"""

from . import config  # noqa: F401
