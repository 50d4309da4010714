"""Disparity metrics, KITTI protocol.

Counterpart of the JAX package's ``data/evaluation/pixel_error.py``
(``calc_error``, ``do_evaluation``, ``do_occlusion_evaluation``): tensor
ops on the data's device that return 0-d tensors and read nothing back to
the host.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ...ops.warp import inverse_warp


def calc_error(est_disp: torch.Tensor, gt_disp: torch.Tensor,
               lb: Optional[float] = None, ub: Optional[float] = None,
               return_count: bool = False) -> Dict[str, torch.Tensor]:
    """EPE and the {1,2,3,5}px outlier percentages over the ground truth
    in (lb, ub); 0 where no pixel is valid.  est/gt: any one shape.
    ``return_count`` adds the number of valid pixels as 'count'."""
    assert est_disp.shape == gt_disp.shape, (est_disp.shape, gt_disp.shape)
    mask = torch.ones_like(gt_disp, dtype=torch.bool)
    if lb is not None:
        mask = mask & (gt_disp > lb)
    if ub is not None:
        mask = mask & (gt_disp < ub)
    maskf = mask.to(est_disp.dtype)
    total = maskf.sum()
    safe_total = total.clamp(min=1.0)
    some = total >= 1.0
    zero = torch.zeros((), dtype=est_disp.dtype, device=est_disp.device)

    abs_err = (gt_disp - est_disp).abs() * maskf
    out = {}
    for px in (1, 2, 3, 5):
        frac = ((abs_err > px) & mask).sum() / safe_total
        out[f"{px}px"] = torch.where(some, frac * 100.0, zero)
    out["epe"] = torch.where(some, abs_err.sum() / safe_total, zero)
    if return_count:
        out["count"] = total
    return out


def do_evaluation(est_disp: Optional[torch.Tensor],
                  gt_disp: Optional[torch.Tensor], lb: float, ub: float
                  ) -> Dict[str, torch.Tensor]:
    if est_disp is None or gt_disp is None:
        return {}
    return calc_error(est_disp, gt_disp, lb=lb, ub=ub)


def do_occlusion_evaluation(est_disp: Optional[torch.Tensor],
                            ref_gt_disp: Optional[torch.Tensor],
                            target_gt_disp: Optional[torch.Tensor],
                            lb: float, ub: float,
                            return_counts: bool = False
                            ) -> Dict[str, torch.Tensor]:
    """The occluded / non-occluded split by left-right consistency: the
    right view's ground truth warped to the left (layout [B, H, W, 1]);
    'occ_*' and 'noc_*' metrics, with ``return_counts`` also
    'occ_count' and 'noc_count'."""
    if est_disp is None or ref_gt_disp is None or target_gt_disp is None:
        return {}
    warp_ref = inverse_warp(target_gt_disp, -ref_gt_disp, mode="disparity")
    theta, eps = 1.0, 1e-6
    occlusion = (((warp_ref - ref_gt_disp).abs() > theta)
                 | (warp_ref.abs() < eps)).to(ref_gt_disp.dtype)

    out = {}
    occ = calc_error(est_disp * occlusion, ref_gt_disp * occlusion, lb, ub,
                     return_count=return_counts)
    out.update({"occ_" + k: v for k, v in occ.items()})
    noc_mask = 1.0 - occlusion
    noc = calc_error(est_disp * noc_mask, ref_gt_disp * noc_mask, lb, ub,
                     return_count=return_counts)
    out.update({"noc_" + k: v for k, v in noc.items()})
    return out
