"""euispice_coreg_tpu_torch: the coalignment framework on PyTorch and CUDA.

The port of ``euispice_coreg_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
Hopper card.  Same public surface, same numerics; the JAX package is the
reference it is tested against.  Nothing here imports ``jax`` or
``euispice_coreg_tpu``.
"""
from .hdrshift import Alignment, AlignmentResults

__all__ = ["Alignment", "AlignmentResults"]
