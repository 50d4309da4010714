"""Fold eval-mode BatchNorm into the convolution before it.

Counterpart of the JAX package's ``utils/fold_bn.py:fold_batch_norms``.  At
eval a BatchNorm is a fixed affine map per channel, so it folds into the
convolution that feeds it:

    BN(conv(x)) = x * (W * s) + (beta + (b - mean) * s),
    s = gamma / sqrt(var + eps)

The JAX package keeps the folded BatchNorm as a single add (``_BNShift``);
PyTorch's idiom is to move the shift into the convolution's bias and take
the BatchNorm out of the forward, one pass less per BatchNorm.  The pairs
are every conv wrapper of ``nn/layers.py`` with a ``.norm`` (its ``.norm``
becomes None), each ``conv, BatchNorm`` of an ``nn.Sequential`` (the convex
upsampler's mask head) and the backbone's named pairs (stem, the edge and
inverted residual blocks, the depthwise conv with its own BatchNorm); a
folded named or sequential BatchNorm becomes ``nn.Identity``.  The
arithmetic is float64 on the host, then each tensor is cast to its own
type (bf16 convolution weights, f32 BatchNorm in the bf16 model).

Eval only: the folded model has no BatchNorm statistics left to train.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn

from ..models.backbone import (EdgeResidual, InvertedResidual,
                               TemporalStereoBackbone)
from ..nn.layers import BatchNorm, _NormAct

_CONVS = (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.ConvTranspose3d)
# (conv, BatchNorm) attribute pairs of the backbone's blocks
_NAMED_PAIRS = {
    TemporalStereoBackbone: (("conv_stem", "bn1"),),
    EdgeResidual: (("conv_exp", "bn1"), ("conv_pwl", "bn2")),
    InvertedResidual: (("conv_pw", "bn1"), ("conv_dw", "bn2"),
                       ("conv_pwl", "bn3")),
}


@torch.no_grad()
def _fold(conv: nn.Module, bn: BatchNorm) -> None:
    """conv.weight *= s along its output channels; conv.bias = the shift."""
    w = conv.weight
    s = (bn.weight.double() / torch.sqrt(bn.running_var.double() + bn.eps))
    shift = bn.bias.double() - bn.running_mean.double() * s
    if conv.bias is not None:
        shift = shift + conv.bias.double() * s
    # output channels: dim 0 of a conv's weight, dim 1 of a transposed one's
    axis = 1 if isinstance(conv, (nn.ConvTranspose2d, nn.ConvTranspose3d)) \
        else 0
    shape = [1] * w.dim()
    shape[axis] = -1
    w.copy_((w.double() * s.view(shape)).to(w.dtype))
    if conv.bias is None:
        conv.bias = nn.Parameter(shift.to(w.dtype))
    else:
        conv.bias.copy_(shift.to(conv.bias.dtype))


def fold_batch_norms(model: nn.Module) -> Tuple[nn.Module, List[str]]:
    """Fold every BatchNorm that follows a convolution, in place, in an
    eval-mode model -> (model, names of the folded BatchNorms)."""
    if any(m.training for m in model.modules()):
        raise ValueError("fold_batch_norms takes an eval-mode model: a "
                         "folded model has no BatchNorm left to train")
    folded: List[str] = []
    for name, mod in list(model.named_modules()):
        prefix = f"{name}." if name else ""
        if isinstance(mod, _NormAct) and isinstance(mod.norm, BatchNorm):
            _fold(mod, mod.norm)
            mod.norm = None
            folded.append(f"{prefix}norm")
        if isinstance(mod, nn.Sequential):
            for i in range(len(mod) - 1):
                if isinstance(mod[i], _CONVS) and isinstance(mod[i + 1],
                                                             BatchNorm):
                    _fold(mod[i], mod[i + 1])
                    mod[i + 1] = nn.Identity()
                    folded.append(f"{prefix}{i + 1}")
        for conv, bn in _NAMED_PAIRS.get(type(mod), ()):
            if isinstance(getattr(mod, bn), BatchNorm):
                _fold(getattr(mod, conv), getattr(mod, bn))
                setattr(mod, bn, nn.Identity())
                folded.append(f"{prefix}{bn}")
    return model, folded
