"""The training step.

Counterpart of the JAX package's ``training/step.py`` (``build_losses``,
``compute_losses``, ``make_train_step``): multi-scale smooth-L1 on the
disparity pyramid plus the Wasserstein loss on the (cost, offset, sample)
triples; the total is the sum of every entry whose key contains "loss".
``make_eval_step`` is not ported yet (it needs the evaluation metrics).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..config import ConfigNode
from ..losses import DispSmoothL1Loss, WassersteinDistanceLoss
from ..models.stereo import TemporalStereoNet
from ..models.temporal import multi_frame_forward
from .optim import global_norm
from .state import TrainState


def build_losses(cfg: ConfigNode):
    l1 = DispSmoothL1Loss.from_config(cfg.MODEL.LOSSES.SMOOTH_L1_LOSS)
    wars = WassersteinDistanceLoss.from_config(
        cfg.MODEL.LOSSES.WARSSERSTEIN_DISTANCE_LOSS)
    return l1, wars


def compute_losses(outputs, disp_gt: torch.Tensor,
                   l1_loss: DispSmoothL1Loss,
                   wars_loss: WassersteinDistanceLoss
                   ) -> Dict[str, torch.Tensor]:
    losses = dict(l1_loss(outputs["disps"], disp_gt))
    losses.update(wars_loss(outputs["costs"], outputs["offsets"],
                            outputs["disp_samples"], disp_gt))
    losses["loss"] = sum(v for k, v in losses.items() if "loss" in k)
    return losses


@torch.no_grad()
def _load_working_copy(model: TemporalStereoNet, state: TrainState) -> None:
    """The model's parameters and statistics <- the state's f32 masters,
    each cast to the type the model keeps it in."""
    for name, p in model.named_parameters():
        p.copy_(state.params[name])
    for name, stat in state.batch_stats.items():
        model.get_buffer(name).copy_(stat)


def make_train_step(model: TemporalStereoNet, cfg: ConfigNode,
                    swa_start_step: int = -1):
    """Returns train_step(state, batch) -> (new state, metrics).

    batch: the time-major window of ``models/temporal.py`` plus 'disp_gt'
    [T, B, H, W, 1] (zeros where the ground truth is invalid).  The step
    loads the state into ``model``, runs the window, differentiates the
    loss, applies the optimizer to the f32 masters and reads back the
    BatchNorm statistics.  Metrics are the loss terms (per frame,
    ``{frame_idx}_...``, with PREVIOUS_WITH_GRADIENT) and ``grad_norm``,
    as 0-d tensors on the model's device.
    """
    l1_loss, wars_loss = build_losses(cfg)
    previous_with_gradient = cfg.MODEL.get("PREVIOUS_WITH_GRADIENT", False)

    def losses_of(batch) -> Dict[str, torch.Tensor]:
        outputs, _ = multi_frame_forward(
            model, batch, train=True,
            previous_with_gradient=previous_with_gradient)
        if not previous_with_gradient:
            return compute_losses(outputs, batch["disp_gt"][-1], l1_loss,
                                  wars_loss)
        # BPTT: every frame contributes, keyed by its frame index
        t = len(outputs)
        losses = {}
        for i, outs in enumerate(outputs):
            per = compute_losses(outs, batch["disp_gt"][i], l1_loss,
                                 wars_loss)
            per.pop("loss")
            losses.update({f"{i - (t - 1)}_{k}": v for k, v in per.items()})
        losses["loss"] = sum(v for k, v in losses.items() if "loss" in k)
        return losses

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        _load_working_copy(model, state)
        model.zero_grad(set_to_none=True)
        losses = losses_of(batch)
        losses["loss"].backward()
        grads = {name: (torch.zeros_like(state.params[name]) if p.grad is None
                        else p.grad.float())
                 for name, p in model.named_parameters()}
        new_stats = {name: model.get_buffer(name).detach().float().clone()
                     for name in state.batch_stats}
        model.zero_grad(set_to_none=True)
        swa_active = 0 <= swa_start_step <= state.step
        state = state.apply_gradients(grads, new_batch_stats=new_stats,
                                      swa_active=swa_active)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["grad_norm"] = global_norm(grads)
        return state, metrics

    return train_step
