"""Optical-flow metrics: end-point error, outlier percentages and KITTI's
Fl.

Counterpart of the JAX package's ``data/evaluation/flow_error.py``; flow
[B, H, W, 2], tensor ops on the data's device.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch


def calc_flow_error(est_flow: torch.Tensor, gt_flow: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    lb: float = 0.0, ub: float = 400.0,
                    sparse: bool = False) -> Dict[str, torch.Tensor]:
    """Valid: a ground truth without NaN whose magnitude lies in (lb, ub)
    and, when ``sparse``, is not the all-zero fill; ``mask`` narrows it
    further."""
    assert est_flow.shape == gt_flow.shape
    err = ((est_flow - gt_flow) ** 2).sum(-1).sqrt()
    mag = (gt_flow ** 2).sum(-1).sqrt()
    valid = ~(torch.isnan(gt_flow[..., 0]) | torch.isnan(gt_flow[..., 1]))
    if sparse:
        eps = 1e-12
        valid = valid & ~((gt_flow[..., 0].abs() < eps)
                          & (gt_flow[..., 1].abs() < eps))
    valid = valid & (mag > lb) & (mag < ub)
    maskf = valid.to(err.dtype)
    if mask is not None:
        maskf = maskf * mask.reshape(err.shape).to(err.dtype)
    err = torch.nan_to_num(err) * maskf
    total = maskf.sum().clamp(min=1.0)

    out = {"epe": (err * maskf).sum() / total}
    for px in (1, 2, 3, 5):
        out[f"{px}px"] = ((err > px) * maskf).sum() / total * 100.0
    # KITTI's Fl: more than 3 px and more than 5% of the magnitude
    fl = ((err > 3.0) & (err > 0.05 * mag)) * maskf
    out["Fl"] = fl.sum() / total * 100.0
    return out


def do_flow_evaluation(est_flow: Optional[torch.Tensor],
                       gt_flow: Optional[torch.Tensor],
                       mask: Optional[torch.Tensor] = None,
                       lb: float = 0.0, ub: float = 400.0,
                       sparse: bool = False) -> Dict[str, torch.Tensor]:
    if est_flow is None or gt_flow is None:
        return {}
    return calc_flow_error(est_flow, gt_flow, mask, lb=lb, ub=ub,
                           sparse=sparse)
