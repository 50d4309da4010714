"""Plain operations of the reference (NHWC unless said): resizes, the cost
volume, hypotheses, upsampling, the pose reprojection and the softmax
splat, each in plain PyTorch, in the type of its input (float32 here)."""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

GROUP = 8                 # channels per group of the correlation
FRACTIONS = (0.0, 3 / 8, 4 / 8, 5 / 8, 1.0)


def resize(x: torch.Tensor, size: Sequence[int], axes: Sequence[int],
           mode: str) -> torch.Tensor:
    """Align-corners resize of ``axes`` to ``size`` (identity when equal)."""
    axes = [a % x.ndim for a in axes]
    if tuple(x.shape[a] for a in axes) == tuple(size):
        return x
    rest = [i for i in range(x.ndim) if i not in axes]
    perm = rest + axes
    y = x.permute(perm)
    lead = y.shape[:len(rest)]
    y = y.reshape(1, -1, *y.shape[len(rest):])
    y = F.interpolate(y, size=tuple(size), mode=mode, align_corners=True)
    y = y.reshape(*lead, *size)
    inv = [0] * x.ndim
    for i, p in enumerate(perm):
        inv[p] = i
    return y.permute(inv)


def resize_bilinear(x, size, h_axis=-3, w_axis=-2):
    return resize(x, size, (h_axis, w_axis), "bilinear")


def resize_trilinear(x, size, axes=(1, 2, 3)):
    return resize(x, size, axes, "trilinear")


def avg_pool3d(x: torch.Tensor, window: Tuple[int, int, int]) -> torch.Tensor:
    """Non-overlapping average pool over NDHWC, floor semantics."""
    b, d, h, w, c = x.shape
    kd, kh, kw = window
    dt, ht, wt = d // kd, h // kh, w // kw
    y = x[:, :dt * kd, :ht * kh, :wt * kw]
    return y.reshape(b, dt, kd, ht, kh, wt, kw, c).mean(dim=(2, 4, 6))


def groupwise_correlation(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """-sum over each group of 8 channels of (a - b)^2."""
    bb, d, h, w, c = a.shape
    diff = a - b
    return -(diff * diff).reshape(bb, d, h, w, c // GROUP, GROUP).sum(-1)


def shift_1d(img: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Linear sample along W at x + shift, zero outside: img [B, 1, H, W,
    C], shift [B, D, H, W] -> [B, D, H, W, C]."""
    b, d, h, w = shift.shape
    c = img.shape[-1]
    src = img.expand(b, d, h, w, c)
    xs = torch.arange(w, dtype=shift.dtype, device=shift.device
                      ).view(1, 1, 1, w) + shift
    xf = torch.floor(xs)
    fx = xs - xf

    def tap(xi, weight):
        weight = weight * ((xi >= 0) & (xi <= w - 1)).to(weight.dtype)
        idx = xi.clamp(0, w - 1).long()[..., None].expand(b, d, h, w, c)
        return torch.gather(src, 3, idx) * weight[..., None]

    return tap(xf, 1 - fx) + tap(xf + 1, fx)


def block_cost(ref_fm: torch.Tensor, tgt_fm: torch.Tensor, disp_sample,
               scales: int) -> torch.Tensor:
    """The cost volume: ``disp_sample`` an int D (dense 0..D-1: base
    -(ref - target at x - d)^2) or per-pixel hypotheses [B, D, H, W] (base
    concat(ref, target at x - d)), then the groupwise correlation of
    (1, 2^s, 2^s)-pooled ref and target for s < ``scales``, resized back:
    [B, H, W, C] x2 -> [B, D, H, W, C_base + scales * C / 8]."""
    b, h, w, c = ref_fm.shape
    if isinstance(disp_sample, int):
        d = disp_sample
        tgt = ref_fm.new_zeros((b, d, h, w, c))
        for i in range(min(d, w)):
            tgt[:, i, :, i:] = tgt_fm[:, :, :w - i]
        ref = ref_fm[:, None].expand(b, d, h, w, c)
        costs = [-(ref - tgt) ** 2]
    else:
        d = disp_sample.shape[1]
        ref = ref_fm[:, None].expand(b, d, h, w, c)
        tgt = shift_1d(tgt_fm[:, None], -disp_sample)
        costs = [torch.cat([ref, tgt], dim=-1)]
    for s in range(scales):
        sh, sw = min(2 ** s, h), min(2 ** s, w)
        if (sh, sw) == (1, 1):
            costs.append(groupwise_correlation(ref, tgt))
        else:
            corr = groupwise_correlation(avg_pool3d(ref, (1, sh, sw)),
                                         avg_pool3d(tgt, (1, sh, sw)))
            costs.append(resize_trilinear(corr, (d, h, w)))
    return torch.cat(costs, dim=-1)


def topk_soft_argmin(cost, disp_sample, offset, k):
    """Soft-argmin over the k largest costs (stable order), with offsets:
    [B, H, W, D] -> (disp [B,H,W,1], topk disp, topk cost)."""
    order = torch.sort(cost, dim=-1, descending=True, stable=True
                       ).indices[..., :k]
    topk_cost = torch.gather(cost, -1, order)
    topk_disp = torch.gather(disp_sample + offset, -1, order)
    prob = torch.softmax(topk_cost, dim=-1)
    return (torch.sum(prob * topk_disp, dim=-1, keepdim=True), topk_disp,
            topk_cost)


def sort_samples_with_volume(disp_sample, volume, dim):
    """Hypotheses sorted by disparity (stable), the volume's D axis at
    ``dim`` permuted alike."""
    sorted_sample, order = torch.sort(disp_sample, dim=-1, stable=True)
    order = order.permute(0, 3, 1, 2)
    order = order[..., None] if dim == 1 else order[:, None]
    return sorted_sample, torch.gather(volume, dim, order.expand_as(volume))


def linear_samples(b, h, w, n, device):
    return torch.arange(n, dtype=torch.float32, device=device).view(
        1, 1, 1, -1).expand(b, h, w, n)


def fractional_samples(low, high):
    fr = torch.tensor(FRACTIONS, dtype=low.dtype, device=low.device)
    return torch.minimum(low, high) + torch.abs(high - low) * fr.view(
        1, 1, 1, -1)


def unfold3x3(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H, W, 9, C], zero-padded, k = dy * 3 + dx."""
    b, h, w, c = x.shape
    pad = F.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.stack([pad[:, dy:dy + h, dx:dx + w]
                        for dy in range(3) for dx in range(3)], dim=3)


def convex_upsample(disp, mask_logits, up=2):
    """disp [B, H, W, 1] x up through a softmax over each 3x3 window."""
    b, h, w, _ = disp.shape
    mask = torch.softmax(mask_logits.reshape(b, h, w, 9, up * up), dim=3)
    patches = unfold3x3(disp * float(up))[..., 0]
    out = (patches[..., None] * mask).sum(dim=3)
    out = out.reshape(b, h, w, up, up).permute(0, 1, 3, 2, 4)
    return out.reshape(b, h * up, w * up, 1)


def mask_upsample_9(disp, mask_logits):
    """disp [B, dh, dw, 1] -> [B, H, W, 1] of mask_logits [B, H, W, 9]."""
    b, h, w, _ = mask_logits.shape
    mask = torch.softmax(mask_logits, dim=-1)
    patches = unfold3x3(disp)[..., 0]
    patches = resize_bilinear(patches * (w / disp.shape[2]), (h, w))
    return torch.sum(patches * mask, dim=-1, keepdim=True)


def project_to_3d(depth: torch.Tensor, K: torch.Tensor, inv_K: torch.Tensor,
                  T: torch.Tensor, eps: float = 1e-7
                  ) -> Dict[str, torch.Tensor]:
    """C stacked depth maps [B, H, W, C] unprojected and seen from camera
    ``T``: ``triangular_depth`` [B, H, W, C], ``optical_flow`` [B, H, W,
    C, 2]."""
    b, h, w, c = depth.shape
    dt, dev = depth.dtype, depth.device
    xs = torch.arange(w, dtype=dt, device=dev).view(1, 1, w).expand(b, h, w)
    ys = torch.arange(h, dtype=dt, device=dev).view(1, h, 1).expand(b, h, w)
    grid = torch.stack([xs, ys], dim=-1)
    homo = torch.cat([grid, torch.ones((b, h, w, 1), dtype=dt, device=dev)],
                     dim=-1).reshape(b, h * w, 3).transpose(1, 2).repeat(
                         1, 1, c)
    depth_flat = depth.permute(0, 3, 1, 2).reshape(b, -1)
    points = torch.matmul(inv_K, homo) * depth_flat[:, None, :]
    points = torch.cat([points, torch.ones((b, 1, c * h * w), dtype=dt,
                                           device=dev)], dim=1)
    K4 = torch.eye(4, dtype=dt, device=dev).repeat(b, 1, 1)
    K4[:, :3, :3] = K
    src = torch.matmul(torch.matmul(K4, T)[:, :3, :], points)
    depth_out = src[:, 2].reshape(b, c, h, w).permute(0, 2, 3, 1)
    pix = (src[:, :2] / (src[:, 2:3] + eps)).reshape(b, 2, c, h, w).permute(
        0, 3, 4, 2, 1)
    return {"triangular_depth": depth_out,
            "optical_flow": pix - grid[:, :, :, None, :]}


def softmax_splat(inputs: torch.Tensor, flow: torch.Tensor,
                  metric: torch.Tensor, eps: float = 1e-22) -> torch.Tensor:
    """Forward warp: each source's inputs [B, H, W, C], weighted by
    exp(metric), added with the weight to its 4 bilinear neighbours at
    (x, y) + flow (each tap dropped outside the frame), the sums divided by
    the summed weight + eps."""
    b, h, w, c = inputs.shape
    em = torch.exp(metric)
    vals = torch.cat([inputs * em, em], dim=-1)
    xs = torch.arange(w, dtype=flow.dtype, device=flow.device
                      ).view(1, 1, w) + flow[..., 0]
    ys = torch.arange(h, dtype=flow.dtype, device=flow.device
                      ).view(1, h, 1) + flow[..., 1]
    x0, y0 = torch.floor(xs), torch.floor(ys)
    ax, ay = xs - x0, ys - y0
    base = torch.arange(b, device=flow.device).view(b, 1, 1) * (h * w)
    out = torch.zeros((b * h * w, c + 1), dtype=vals.dtype,
                      device=vals.device)
    for dx in (0, 1):
        for dy in (0, 1):
            tx, ty = x0 + dx, y0 + dy
            valid = (tx >= 0) & (tx <= w - 1) & (ty >= 0) & (ty <= h - 1)
            idx = (base + ty.clamp(0, h - 1).long() * w
                   + tx.clamp(0, w - 1).long())
            wk = (ax if dx else 1 - ax) * (ay if dy else 1 - ay)
            out.index_add_(0, idx[valid], (vals * wk[..., None])[valid])
    out = out.view(b, h, w, c + 1)
    return out[..., :c] / (out[..., c:] + eps)
