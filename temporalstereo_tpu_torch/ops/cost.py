"""Cost-volume construction (NDHWC).

Counterpart of the JAX package's ``ops/cost.py``.  Features are
[B, H, W, C], hypotheses [B, D, H, W], volumes [B, D, H, W, C'].  The tensor
path's base (warp + concat + scale-0 correlation) is the fused kernel
(``kernels/cost.py``); without the correlation pyramid (or with C % 8 != 0)
the base is concat(ref, warped) and the warp is the shift kernel
(``kernels/shift.py``).  Each runs its plain version on CPU tensors.  The
pooled correlation scales are plain PyTorch.  There is no TPU lowering
switch.
"""
from __future__ import annotations

import torch

from ..kernels.cost import fused_cost_base
from ..kernels.shift import shift_1d
from .interpolate import avg_pool3d, resize_trilinear

CHANNELS_PER_GROUP = 8


def groupwise_correlation(fea1: torch.Tensor, fea2: torch.Tensor
                          ) -> torch.Tensor:
    """Negative squared distance summed within channel groups of 8:
    [B, D, H, W, C] -> [B, D, H, W, C//8]."""
    b, d, h, w, c = fea1.shape
    assert c % CHANNELS_PER_GROUP == 0, f"channels {c} not divisible by 8"
    diff = fea1 - fea2
    return -(diff * diff).reshape(b, d, h, w, c // CHANNELS_PER_GROUP,
                                  CHANNELS_PER_GROUP).sum(-1)


def shift_right_features(target_fm: torch.Tensor, max_disp: int
                         ) -> torch.Tensor:
    """out[:, d, :, x] = target[:, :, x - d] (zero beyond the left edge):
    [B, H, W, C] -> [B, D, H, W, C]."""
    b, h, w, c = target_fm.shape
    out = target_fm.new_zeros((b, max_disp, h, w, c))
    for d in range(min(max_disp, w)):
        out[:, d, :, d:] = target_fm[:, :, :w - d]
    return out


def block_cost(reference_fm: torch.Tensor, target_fm: torch.Tensor,
               disp_sample, block_cost_scale: int = 3) -> torch.Tensor:
    """The cost-volume constructor (JAX ``ops/cost.py:block_cost``).

    ``disp_sample`` is an int D (dense integer disparities 0..D-1, base cost
    ``-(l - r_shifted)^2``, C channels) or a [B, D, H, W] tensor of per-pixel
    hypotheses (base = concat(ref, warped target), 2C channels).  Both gain
    the groupwise-correlation pyramid over scales 2^s, s < block_cost_scale.
    Returns [B, D, H, W, C_base + block_cost_scale * C // 8].
    """
    b, h, w, c = reference_fm.shape
    scales = int(block_cost_scale)

    if isinstance(disp_sample, int):
        d = disp_sample
        tgt = shift_right_features(target_fm, d)
        ref = reference_fm[:, None].expand(b, d, h, w, c)
        diff = ref - tgt
        costs = [-(diff * diff)]
        first = 0
    elif c % CHANNELS_PER_GROUP == 0 and scales >= 1:
        d = disp_sample.shape[1]
        fused = fused_cost_base(reference_fm.contiguous(),
                                target_fm.contiguous(),
                                disp_sample.float().contiguous())
        ref, tgt = fused[..., :c], fused[..., c:2 * c]
        costs = [fused]
        first = 1
    else:
        # unfused tensor path (C % 8 != 0 or no pyramid), JAX's _shift
        d = disp_sample.shape[1]
        ref = reference_fm[:, None].expand(b, d, h, w, c)
        tgt = shift_1d(target_fm[:, None].contiguous(),
                       (-disp_sample.float()).contiguous())
        costs = [torch.cat([ref, tgt], dim=-1)]
        first = 0

    for s in range(first, scales):
        sh, sw = min(2 ** s, h), min(2 ** s, w)
        if (sh, sw) == (1, 1):
            costs.append(groupwise_correlation(ref, tgt))
            continue
        corr = groupwise_correlation(avg_pool3d(ref, (1, sh, sw)),
                                     avg_pool3d(tgt, (1, sh, sw)))
        costs.append(resize_trilinear(corr, (d, h, w)))
    return torch.cat(costs, dim=-1)
