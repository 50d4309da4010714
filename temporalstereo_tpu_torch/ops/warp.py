"""Geometric warping ops (NHWC, pixel-coordinate API).

Counterpart of the JAX package's ``ops/warp.py``: ``mesh_grid``,
``grid_sample`` and ``inverse_warp`` (the occlusion split of the
evaluation), ``project_to_3d`` (the pose reprojection of the temporal
update), ``shift_1d`` (the W-axis bilinear gather of the cost volume) and
``inverse_warp_3d``, the general warp of a volume, which is the shift
kernel's wrapper where it shifts along W only.
Coordinates are f32 whatever the data type.  The JAX package's one-hot
matmul form of the W-shift exists for the TPU's matrix unit and is not
carried over.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch


def mesh_grid(b: int, h: int, w: int, dtype=torch.float32,
              device=None) -> torch.Tensor:
    """Pixel coordinate grid [B, H, W, 2] with channels (x, y)."""
    xs = torch.arange(w, dtype=dtype, device=device).view(1, 1, w).expand(b, h, w)
    ys = torch.arange(h, dtype=dtype, device=device).view(1, h, 1).expand(b, h, w)
    return torch.stack([xs, ys], dim=-1)


def grid_sample(img: torch.Tensor, coords: torch.Tensor,
                padding_mode: str = "zeros") -> torch.Tensor:
    """Bilinear sample of NHWC ``img`` at pixel ``coords`` [B, Ho, Wo, 2]
    = (x, y), align-corners: 'zeros' drops each out-of-range tap, 'border'
    clamps it.  Coordinates in f32, taps and weights in ``img``'s type."""
    b, h, w, c = img.shape
    x = coords[..., 0].float()
    y = coords[..., 1].float()
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0).to(img.dtype), (y - y0).to(img.dtype)
    flat = img.reshape(b, h * w, c)

    def tap(xi, yi, weight):
        if padding_mode == "zeros":
            valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            weight = weight * valid.to(img.dtype)
        idx = (yi.clamp(0, h - 1).long() * w
               + xi.clamp(0, w - 1).long()).reshape(b, -1, 1)
        vals = torch.gather(flat, 1, idx.expand(-1, -1, c))
        return vals.reshape(*xi.shape, c) * weight[..., None]

    return (tap(x0, y0, (1 - fx) * (1 - fy)) + tap(x0 + 1, y0, fx * (1 - fy))
            + tap(x0, y0 + 1, (1 - fx) * fy) + tap(x0 + 1, y0 + 1, fx * fy))


def inverse_warp(img: torch.Tensor, motion: torch.Tensor,
                 mode: str = "disparity", K: Optional[torch.Tensor] = None,
                 inv_K: Optional[torch.Tensor] = None,
                 T_target_to_source: Optional[torch.Tensor] = None,
                 padding_mode: str = "zeros", eps: float = 1e-7,
                 output_all: bool = False):
    """Backward warp ``img`` (source) into the target frame.  ``motion``:
    disparity [B,H,W,1] (added to x), flow [B,H,W,2] or depth [B,H,W,1]
    (reprojected with K and the transform; ``output_all`` also returns
    ``project_to_3d``'s outputs)."""
    b, h, w, cm = motion.shape
    output: Dict[str, torch.Tensor] = {}
    grid = mesh_grid(b, h, w, motion.dtype, motion.device)
    if mode == "disparity":
        assert cm == 1, f"disparity must have 1 channel, got {cm}"
        coords = torch.stack([grid[..., 0] + motion[..., 0], grid[..., 1]],
                             dim=-1)
    elif mode == "flow":
        assert cm == 2, f"flow must have 2 channels, got {cm}"
        coords = grid + motion
    elif mode == "depth":
        assert cm == 1, f"depth must have 1 channel, got {cm}"
        output = project_to_3d(motion, K, inv_K, T_target_to_source, eps)
        coords = output["src_pixel_coord"].reshape(b, h, w, 2)
    else:
        raise TypeError(f"unsupported warp mode {mode!r}")
    projected = grid_sample(img, coords, padding_mode=padding_mode)
    if output_all:
        return projected, output
    return projected


def project_to_3d(depth: torch.Tensor, K: torch.Tensor,
                  inv_K: Optional[torch.Tensor] = None,
                  T_target_to_source: Optional[torch.Tensor] = None,
                  eps: float = 1e-7) -> Dict[str, torch.Tensor]:
    """Unproject C stacked depth maps [B, H, W, C] to 3D, optionally
    reproject them into another camera.

    Returns ``homo_points_3d`` [B, 4, C*H*W] and, with a transform,
    ``triangular_depth`` [B,H,W,C], ``optical_flow`` [B,H,W,C,2],
    ``flow_mask`` [B,H,W,C], ``src_pixel_coord`` [B,H,W,C,2].
    """
    b, h, w, c = depth.shape
    dtype, dev = depth.dtype, depth.device
    out: Dict[str, torch.Tensor] = {}

    grid = mesh_grid(b, h, w, dtype, dev)
    homo = torch.cat([grid, torch.ones((b, h, w, 1), dtype=dtype, device=dev)],
                     dim=-1)
    # [B, 3, H*W] tiled over the C maps; depth flattened channel-major
    homo = homo.reshape(b, h * w, 3).transpose(1, 2).repeat(1, 1, c)
    depth_flat = depth.permute(0, 3, 1, 2).reshape(b, -1)
    if inv_K is None:
        inv_K = torch.linalg.inv(K[:, :3, :3])
    points = torch.matmul(inv_K[:, :3, :3], homo) * depth_flat[:, None, :]
    homo_points = torch.cat(
        [points, torch.ones((b, 1, c * h * w), dtype=dtype, device=dev)], dim=1)
    out["homo_points_3d"] = homo_points

    if T_target_to_source is not None:
        if K.shape[-1] == 3:
            new_K = torch.eye(4, dtype=dtype, device=dev).repeat(b, 1, 1)
            new_K[:, :3, :3] = K[:, :3, :3]
        else:
            new_K = K
        P = torch.matmul(new_K, T_target_to_source)[:, :3, :]
        src = torch.matmul(P, homo_points)                    # [B, 3, C*H*W]
        out["triangular_depth"] = src[:, 2].reshape(b, c, h, w).permute(
            0, 2, 3, 1)
        src_pix = src[:, :2] / (src[:, 2:3] + eps)
        src_pix = src_pix.reshape(b, 2, c, h, w).permute(0, 3, 4, 2, 1)
        out["flow_mask"] = ((src_pix[..., 0] >= 0) & (src_pix[..., 0] <= w - 1)
                            & (src_pix[..., 1] >= 0)
                            & (src_pix[..., 1] <= h - 1))
        out["src_pixel_coord"] = src_pix
        out["optical_flow"] = src_pix - grid[:, :, :, None, :]
    return out


def shift_1d(img: torch.Tensor, shift: torch.Tensor, x0: int = 0,
             t0: int = 0) -> torch.Tensor:
    """Bilinear sample of a volume along W at ``x + shift``, zero padding.

    img [B, D, H, Wt, C] (or [B, 1, H, Wt, C], broadcast over D), shift
    [B, D, H, W] -> [B, D, H, W, C].  Coordinates and taps are f32; the
    result is rounded once to ``img``'s type; out-of-range taps are dropped.
    Column x of shift and the output is the frame's column ``x0 + x``, and
    img holds the frame's columns [t0, t0 + Wt) (a W-sharded forward,
    ``parallel/spatial.py``); by default both start at 0.
    """
    b, d, h, w = shift.shape
    wt, c = img.shape[-2:]
    src = img.float().expand(b, d, h, wt, c)
    xs = torch.arange(x0, x0 + w, dtype=torch.float32, device=shift.device
                      ).view(1, 1, 1, w) + shift.float()
    xf = torch.floor(xs)
    fx = xs - xf

    def tap(xi, weight):
        xi = xi - t0
        weight = weight * ((xi >= 0) & (xi <= wt - 1)).float()
        idx = xi.clamp(0, wt - 1).long()[..., None].expand(b, d, h, w, c)
        return torch.gather(src, 3, idx) * weight[..., None]

    return (tap(xf, 1 - fx) + tap(xf + 1, fx)).to(img.dtype)


def inverse_warp_3d(img: torch.Tensor, disp: torch.Tensor,
                    padding_mode: str = "zeros",
                    disp_y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bilinear warp of a volume img [B, D|1, H, W, C] (or [B, H, W, C],
    broadcast over D) by per-(d, h, w) shifts: x + disp and, with
    ``disp_y`` [B, D, H, W], y + disp_y -> [B, D, H, W, C].  Coordinates
    in f32, weights in img's type; 'zeros' drops each out-of-range tap,
    'border' clamps it.

    Without ``disp_y`` in 'zeros' mode this is ``kernels/shift.py:shift_1d``:
    the shift kernel on CUDA tensors, its plain version on CPU tensors.
    With ``disp_y`` (or 'border') it is the 4-tap gather here, as the JAX
    package computes it outside any kernel."""
    if img.dim() == 4:
        img = img[:, None]
    if disp_y is None:
        if padding_mode == "zeros":
            from ..kernels.shift import shift_1d as shift_kernel

            return shift_kernel(img, disp.float())
        disp_y = torch.zeros_like(disp)
    b, d, h, w = disp.shape
    c = img.shape[-1]
    src = img.expand(b, d, h, w, c).reshape(b, d, h * w, c)
    xs = torch.arange(w, dtype=torch.float32, device=disp.device
                      ).view(1, 1, 1, w) + disp.float()
    ys = torch.arange(h, dtype=torch.float32, device=disp.device
                      ).view(1, 1, h, 1) + disp_y.float()
    x0, y0 = torch.floor(xs), torch.floor(ys)
    fx, fy = (xs - x0).to(img.dtype), (ys - y0).to(img.dtype)

    def tap(xi, yi, weight):
        if padding_mode == "zeros":
            valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            weight = weight * valid.to(img.dtype)
        idx = (yi.clamp(0, h - 1).long() * w
               + xi.clamp(0, w - 1).long()).reshape(b, d, -1, 1)
        vals = torch.gather(src, 2, idx.expand(-1, -1, -1, c))
        return vals.reshape(b, d, h, w, c) * weight[..., None]

    return (tap(x0, y0, (1 - fx) * (1 - fy)) + tap(x0 + 1, y0, fx * (1 - fy))
            + tap(x0, y0 + 1, (1 - fx) * fy) + tap(x0 + 1, y0 + 1, fx * fy))
