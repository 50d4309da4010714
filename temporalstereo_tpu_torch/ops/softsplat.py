"""Softmax splatting (forward warping), NHWC.

Counterpart of the JAX package's ``ops/softsplat.py``.  The summation splat
is the CUDA kernel on CUDA tensors and the plain scatter on CPU tensors
(``kernels/splat.py``); the importance weighting and normalisation of the
four modes are plain PyTorch.  The JAX package's blocked one-hot einsum
splat is a TPU formulation and is not carried over.
"""
from __future__ import annotations

import torch

from ..kernels.splat import summation_splat


def softsplat(inputs: torch.Tensor, flow: torch.Tensor,
              metric: torch.Tensor | None, mode: str = "softmax",
              eps: float = 1e-22) -> torch.Tensor:
    """Importance-weighted forward warp: inputs [B,H,W,C], flow [B,H,W,2],
    metric [B,H,W,1] (linear and softmax modes), all f32."""
    assert mode in ("summation", "average", "linear", "softmax"), mode
    if mode == "average":
        vals = torch.cat([inputs, torch.ones_like(inputs[..., :1])], dim=-1)
    elif mode == "linear":
        assert metric is not None and metric.shape[-1] == 1
        vals = torch.cat([inputs * metric, metric], dim=-1)
    elif mode == "softmax":
        assert metric is not None and metric.shape[-1] == 1
        emetric = torch.exp(metric)
        vals = torch.cat([inputs * emetric, emetric], dim=-1)
    else:
        vals = inputs

    out = summation_splat(vals.contiguous(), flow.contiguous())
    if mode == "summation":
        return out
    return out[..., :-1] / (out[..., -1:] + eps)
