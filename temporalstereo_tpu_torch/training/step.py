"""The training step.

Counterpart of the JAX package's ``training/step.py`` (``build_losses``,
``compute_losses``, ``make_train_step``): multi-scale smooth-L1 on the
disparity pyramid plus the Wasserstein loss on the (cost, offset, sample)
triples; the total is the sum of every entry whose key contains "loss".
``make_eval_step``: EPE and outlier metrics per sample at the ground
truth's resolution, the occluded / non-occluded split, averaged over the
samples that count.

Both take a ``DataMesh`` (``parallel/mesh.py``), the counterpart of the
JAX package's ``make_sharded_train_step`` / ``_eval_step``: each rank runs
its shard of the global batch, and what JAX's SPMD partitioner reduces
over the global batch is reduced over the ranks here, so that every rank
returns the global numbers and applies the same update.  Without a group,
or with one rank, nothing is reduced and nothing changes.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config import ConfigNode
from ..data.evaluation import calc_error, do_occlusion_evaluation
from ..losses import DispSmoothL1Loss, WassersteinDistanceLoss
from ..models.stereo import TemporalStereoNet
from ..models.temporal import multi_frame_forward
from ..nn.layers import synchronise_batch_norms
from ..ops.interpolate import resize_bilinear
from ..parallel.mesh import DataMesh, all_reduce_tree
from .optim import global_norm
from .state import TrainState


def build_losses(cfg: ConfigNode, mesh: Optional[DataMesh] = None):
    l1 = DispSmoothL1Loss.from_config(cfg.MODEL.LOSSES.SMOOTH_L1_LOSS, mesh)
    wars = WassersteinDistanceLoss.from_config(
        cfg.MODEL.LOSSES.WARSSERSTEIN_DISTANCE_LOSS, mesh)
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
def load_working_copy(model: TemporalStereoNet, state: TrainState) -> None:
    """The model's parameters and statistics <- the state's f32 masters,
    each cast to the type the model keeps it in."""
    for name, p in model.named_parameters():
        p.copy_(state.params[name])
    for name, stat in state.batch_stats.items():
        model.get_buffer(name).copy_(stat)


def make_train_step(model: TemporalStereoNet, cfg: ConfigNode,
                    swa_start_step: int = -1,
                    mesh: Optional[DataMesh] = None):
    """Returns train_step(state, batch) -> (new state, metrics).

    batch: the time-major window of ``models/temporal.py`` plus 'disp_gt'
    [T, B, H, W, 1] (zeros where the ground truth is invalid).  The step
    loads the state into ``model``, runs the window, differentiates the
    loss, applies the optimizer to the f32 masters and reads back the
    BatchNorm statistics.  Metrics are the loss terms (per frame,
    ``{frame_idx}_...``, with PREVIOUS_WITH_GRADIENT) and ``grad_norm``,
    as 0-d tensors on the model's device.  ``TPU.REMAT`` recomputes each
    BPTT frame's activations in the backward (``multi_frame_forward``).

    With a ``mesh`` of more than one rank, ``batch`` is this rank's shard:
    the model's BatchNorms take their train-mode statistics over the ranks
    from then on (``synchronise_batch_norms``, which also holds for any
    later train-mode forward of ``model``), the temporal update its splat
    metric's mean, the losses their normalisers;
    the f32 gradients are summed over the ranks in one flat bucket before
    the optimizer (so its global-norm clip and ``grad_norm`` see the
    global gradient), and the metrics are summed likewise.
    """
    synchronise_batch_norms(model, mesh)
    l1_loss, wars_loss = build_losses(cfg, mesh)
    previous_with_gradient = cfg.MODEL.get("PREVIOUS_WITH_GRADIENT", False)
    remat = cfg.TPU.get("REMAT", False)

    def losses_of(batch) -> Dict[str, torch.Tensor]:
        outputs, _ = multi_frame_forward(
            model, batch, train=True,
            previous_with_gradient=previous_with_gradient, remat=remat,
            mesh=mesh)
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
        load_working_copy(model, state)
        model.zero_grad(set_to_none=True)
        losses = losses_of(batch)
        losses["loss"].backward()
        grads = {name: (torch.zeros_like(state.params[name]) if p.grad is None
                        else p.grad.float())
                 for name, p in model.named_parameters()}
        grads = all_reduce_tree(grads, mesh)
        new_stats = {name: model.get_buffer(name).detach().float().clone()
                     for name in state.batch_stats}
        model.zero_grad(set_to_none=True)
        swa_active = 0 <= swa_start_step <= state.step
        state = state.apply_gradients(grads, new_batch_stats=new_stats,
                                      swa_active=swa_active)
        metrics = all_reduce_tree({k: v.detach() for k, v in losses.items()},
                                  mesh)
        metrics["grad_norm"] = global_norm(grads)
        return state, metrics

    return train_step


def make_eval_step(model: TemporalStereoNet, cfg: ConfigNode,
                   mesh: Optional[DataMesh] = None):
    """Returns eval_step(batch) -> metrics, 0-d tensors on the batch's
    device (nothing is read back to the host).

    batch: the time-major window with 'disp_gt' [T, B, h, w, 1] at the
    ground truth's own resolution, optionally 'disp_gt_right' and
    'pad_mask' [B] (0 for a wrap-padded duplicate).  Each of the
    VAL.EVAL_DISPARITY_IDS outputs is resized to the ground truth (values
    scaled by the width ratio) and scored per sample; a metric is the mean
    over the samples that are real and hold a valid pixel, and 'weight'
    is their number.  With VAL.DO_OCCLUSION_EVALUATION and a right-view
    ground truth, the 'occ_*' / 'noc_*' metrics are averaged over the
    samples with a pixel of that split, their number under
    'weight:<key>'.  With a ``mesh`` of more than one rank, every mean's
    sum and count are summed over the ranks (one flat all-reduce), so a
    wrap-padded duplicate counts on no rank and every rank returns the
    global metrics and weights.
    """
    lb = cfg.VAL.get("LOWERBOUND", 0)
    ub = cfg.VAL.get("UPPERBOUND", 192)
    eval_ids = list(cfg.VAL.get("EVAL_DISPARITY_IDS", [0]))
    do_occ = cfg.VAL.get("DO_OCCLUSION_EVALUATION", False)

    def per_sample(fn, *tensors) -> Dict[str, torch.Tensor]:
        rows = [fn(*(t[i:i + 1] for t in tensors))
                for i in range(tensors[0].shape[0])]
        return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    @torch.no_grad()
    def eval_step(batch) -> Dict[str, torch.Tensor]:
        outputs, _ = multi_frame_forward(model, batch, train=False,
                                         mesh=mesh)
        gt = batch["disp_gt"][-1].float()
        gt_right = batch.get("disp_gt_right")
        pad_mask = batch.get("pad_mask")
        pm = (pad_mask.to(gt.dtype) if pad_mask is not None
              else torch.ones(gt.shape[0], dtype=gt.dtype, device=gt.device))
        # a sample without a valid pixel carries no information
        valid_px = ((gt > lb) & (gt < ub)).sum(dim=(1, 2, 3))
        sw = pm * (valid_px > 0).to(gt.dtype)

        # each metric's sum over the samples that count, and the key of
        # their number: 'weight', or the metric's own 'weight:<key>'
        parts = {"weight": sw.sum()}
        means = []
        gh, gw = gt.shape[1:3]
        disps = [resize_bilinear(d.float() * (gw / d.shape[2]), (gh, gw))
                 if d.shape[1:3] != (gh, gw) else d.float()
                 for d in outputs["disps"]]
        for i in eval_ids:
            if i >= len(disps):
                continue
            err = per_sample(lambda e, g: calc_error(e, g, lb=lb, ub=ub),
                             disps[i], gt)
            for k, v in err.items():
                key = f"metric_disparity_{i}/all_{k}"
                parts[f"sum:{key}"] = (v * sw).sum()
                means.append((key, "weight"))
            if do_occ and gt_right is not None:
                occ = per_sample(
                    lambda e, g, gr: do_occlusion_evaluation(
                        e, g, gr, lb, ub, return_counts=True),
                    disps[i], gt, gt_right[-1].float())
                split_w = {s: pm * (occ.pop(f"{s}_count") > 0).to(gt.dtype)
                           for s in ("occ", "noc")}
                for k, v in occ.items():
                    w = split_w[k.split("_", 1)[0]]
                    key = f"metric_disparity_{i}/{k}"
                    parts[f"sum:{key}"] = (v * w).sum()
                    parts[f"weight:{key}"] = w.sum()
                    means.append((key, f"weight:{key}"))
        parts = all_reduce_tree(parts, mesh)
        metrics = {"weight": parts["weight"]}
        for key, weight in means:
            metrics[key] = parts[f"sum:{key}"] / parts[weight].clamp(min=1.0)
            if weight != "weight":
                metrics[weight] = parts[weight]
        return metrics

    return eval_step
