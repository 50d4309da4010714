"""Softmax splatting (forward warping), NHWC.

Counterpart of the JAX package's ``ops/softsplat.py``: ``softsplat`` (all
four modes) and ``summation_splat`` (the bare splat) run in one launch of
the CUDA kernel on CUDA tensors and as the plain scatter on CPU tensors
(``kernels/splat.py``).  Both are differentiable in every tensor input
(inputs, flow and metric), as the JAX package's are: on the card the
forward keeps its normaliser and the backward is one launch of
``csrc/softsplat_backward.cu``, on the CPU autograd of the plain version.  The JAX package's blocked one-hot einsum
splat is a TPU formulation and is not carried over.
"""
import torch

from ..kernels.splat import softsplat


def summation_splat(values: torch.Tensor, flow: torch.Tensor
                    ) -> torch.Tensor:
    """values [B, H, W, C] f32, each added to its 4 bilinear neighbours at
    (x, y) + flow [B, H, W, 2] -> [B, H, W, C]: ``softsplat`` in summation
    mode."""
    return softsplat(values, flow, None, mode="summation")


__all__ = ["softsplat", "summation_splat"]
