"""Cost-volume construction (NDHWC).

Counterpart of the JAX package's ``ops/cost.py``.  Features are
[B, H, W, C], hypotheses [B, D, H, W], volumes [B, D, H, W, C'].  The tensor
path's base (warp + concat + scale-0 correlation) is the fused kernel
(``kernels/cost.py``); without the correlation pyramid (or with C % 8 != 0)
the base is concat(ref, warped) and the warp is the shift kernel
(``kernels/shift.py``).  Each runs its plain version on CPU tensors.  The
pooled correlation scales are plain PyTorch.  There is no TPU lowering
switch.  Inside a W-sharded forward (``parallel/spatial.py``) each rank
builds its columns' volume: the dense path takes D - 1 columns from the
left, the sparse paths gather the target along W and run the kernels with
a column offset, and the pyramid pools fall on the frame's windows.
``cat_fms`` and ``dif_fms`` (the reference's concatenation and difference
volumes, off the model's path) are plain PyTorch, as in the JAX package,
where no Pallas kernel computes them.
"""
from __future__ import annotations

import torch

from ..kernels.cost import fused_cost_base
from ..kernels.shift import shift_1d
from ..parallel.spatial import active_plan, lerp
from .interpolate import _resize_local, avg_pool3d, resize_trilinear

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
    # inside a W-sharded forward: this rank's columns [x0, x0 + w) of a
    # frame wg wide
    plan = active_plan()
    wg = w if plan is None else plan.global_width(w)
    x0 = 0 if plan is None else plan.part(wg)[plan.index][0]

    if isinstance(disp_sample, int):
        d = disp_sample
        if plan is None:
            tgt = shift_right_features(target_fm, d)
        else:
            # columns x0 - (d - 1) .. x1: target[x - i], 0 off the frame
            window = plan.halo(target_fm, 2, wg, d - 1, 0)
            tgt = torch.stack([window[:, :, d - 1 - i:d - 1 - i + w]
                               for i in range(d)], dim=1)
        ref = reference_fm[:, None].expand(b, d, h, w, c)
        diff = ref - tgt
        costs = [-(diff * diff)]
        first = 0
    else:
        d = disp_sample.shape[1]
        # a hypothesis may reach any column of the frame
        target = (target_fm if plan is None
                  else plan.gather(target_fm, 2, wg)).contiguous()
        if c % CHANNELS_PER_GROUP == 0 and scales >= 1:
            fused = fused_cost_base(reference_fm.contiguous(), target,
                                    disp_sample.float().contiguous(), x0, 0)
            ref, tgt = fused[..., :c], fused[..., c:2 * c]
            costs = [fused]
            first = 1
        else:
            # unfused tensor path (C % 8 != 0 or no pyramid), JAX's _shift
            ref = reference_fm[:, None].expand(b, d, h, w, c)
            tgt = shift_1d(target[:, None],
                           (-disp_sample.float()).contiguous(), x0, 0)
            costs = [torch.cat([ref, tgt], dim=-1)]
            first = 0

    for s in range(first, scales):
        sh, sw = min(2 ** s, h), min(2 ** s, wg)
        if (sh, sw) == (1, 1):
            costs.append(groupwise_correlation(ref, tgt))
        elif plan is not None:
            costs.append(_pooled_correlation(plan, ref, tgt, sh, sw, wg))
        else:
            corr = groupwise_correlation(avg_pool3d(ref, (1, sh, sw)),
                                         avg_pool3d(tgt, (1, sh, sw)))
            costs.append(resize_trilinear(corr, (d, h, w)))
    return torch.cat(costs, dim=-1)


def _pooled_correlation(plan, ref, tgt, sh, sw, wg):
    """One pyramid scale of this rank's columns: the correlation of the
    (1, sh, sw)-pooled volumes over the frame's windows, resized back to
    (D, H, the frame's W) with align corners."""
    b, d, h, w, c = ref.shape
    wp = wg // sw
    # the pooled columns each rank's output columns read, as volume columns
    if wp == wg:
        windows = plan.part(wg)
    else:
        scale, windows = plan.lerp_windows(wp, wg)
    vol = plan.fetch(torch.cat([ref, tgt], dim=-1), 3, wg,
                     [(lo * sw, hi * sw) for lo, hi in windows])
    pooled = avg_pool3d(vol, (1, sh, sw))
    corr = groupwise_correlation(pooled[..., :c], pooled[..., c:]).float()
    o0, o1 = plan.part(wg)[plan.index]
    if wp != wg:
        corr = lerp(corr, 3, windows[plan.index][0], wp, scale, o0, o1)
    corr = _resize_local(corr, (d, h), (1, 2), "bilinear")
    return corr.to(ref.dtype)


def _warped_target(target_fm: torch.Tensor, disp_sample):
    """(D, target shifted to x - d): the dense int form or per-pixel
    hypotheses [B, D, H, W] through the shift (kernel on the card)."""
    if isinstance(disp_sample, int):
        return disp_sample, shift_right_features(target_fm, disp_sample)
    return disp_sample.shape[1], shift_1d(
        target_fm[:, None].contiguous(), (-disp_sample.float()).contiguous())


def cat_fms(reference_fm: torch.Tensor, target_fm: torch.Tensor,
            disp_sample) -> torch.Tensor:
    """Concatenation cost volume (JAX ``ops/cost.py:cat_fms``): [B,H,W,C]
    x2 and an int D (dense disparities 0..D-1) or [B,D,H,W] hypotheses ->
    [B, D, H, W, 2C] = concat(ref, target warped to x - d)."""
    b, h, w, c = reference_fm.shape
    d, tgt = _warped_target(target_fm, disp_sample)
    ref = reference_fm[:, None].expand(b, d, h, w, c)
    return torch.cat([ref, tgt], dim=-1)


def dif_fms(reference_fm: torch.Tensor, target_fm: torch.Tensor,
            disp_sample) -> torch.Tensor:
    """Absolute-difference cost volume with max-cost fill (JAX
    ``ops/cost.py:dif_fms``): |ref - warped target| -> [B, D, H, W, C],
    where every element whose warped target value is <= 0 (out of view
    included) takes the volume's largest cost."""
    b, h, w, c = reference_fm.shape
    d, tgt = _warped_target(target_fm, disp_sample)
    cost = (reference_fm[:, None] - tgt).abs()
    return torch.where(tgt > 0, cost, cost.max())
