"""Softmax splatting (forward warping), NHWC.

Counterpart of the JAX package's ``ops/softsplat.py:softsplat``: all four
modes run in one launch of the CUDA kernel on CUDA tensors and as the plain
scatter on CPU tensors (``kernels/splat.py``).  The JAX package's blocked
one-hot einsum splat is a TPU formulation and is not carried over.
"""
from ..kernels.splat import softsplat

__all__ = ["softsplat"]
