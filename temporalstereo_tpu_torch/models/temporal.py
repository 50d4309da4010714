"""Temporal stereo over video: the online stream and the training window.

Counterpart of the JAX package's ``models/temporal.py`` (``streaming_step``,
``multi_frame_forward``, ``chained_poses``).  The JAX package decides whether
to warp the state with ``lax.cond`` or a static flag, and runs the window's
shape-stable past frames in a ``lax.scan``; here both are Python control
flow, and the local map grows 0 -> LOCAL_MAP_SIZE channels exactly.

Batch layout of the training window (time-major):
  left/right [T, B, H, W, 3]; T_cam/inv_T [T, B, 4, 4] (world->cam and its
  inverse); K [B, 3, 3] full-resolution intrinsics; baseline [B].
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..nn.layers import recomputing
from .stereo import (PrevInfo, TemporalStereoNet, backbone_memory_shapes,
                     init_prev_info, update_prev_info)


def chained_poses(T_cam: torch.Tensor, inv_T: torch.Tensor) -> torch.Tensor:
    """[T, B, 4, 4] world->cam poses -> per-step T_past_to_now,
    T[t] @ inv_T[t-1] (identity for the first frame)."""
    eye = torch.eye(4, dtype=T_cam.dtype, device=T_cam.device).expand(
        T_cam.shape[1:])
    if T_cam.shape[0] == 1:
        return eye[None].clone()
    rel = torch.einsum("tbij,tbjk->tbik", T_cam[1:], inv_T[:-1])
    return torch.cat([eye[None], rel], dim=0)


def _frame(model: TemporalStereoNet, left, right, prev: Optional[PrevInfo],
           K, baseline, T_past_to_now, warp: Optional[bool], mesh=None):
    if prev is not None:
        if warp is None:
            warp = prev.has_memory
        if warp:
            prev = update_prev_info(prev, K, baseline, T_past_to_now,
                                    tuple(left.shape[1:3]),
                                    model.use_past_cost, model.local_map_size,
                                    mesh)
    return model(left, right, prev)


@torch.inference_mode()
def streaming_step(model: TemporalStereoNet, left: torch.Tensor,
                   right: torch.Tensor, prev: Optional[PrevInfo],
                   K: torch.Tensor, baseline: torch.Tensor,
                   T_past_to_now: torch.Tensor,
                   warp: Optional[bool] = None):
    """One video frame reusing the carried state -> (outputs, new_prev).

    left/right [B, H, W, 3].  ``warp`` None warps once the state holds a
    real frame (``prev.has_memory``); True/False forces it.
    """
    return _frame(model, left, right, prev, K, baseline, T_past_to_now, warp)


def _recompute_contexts():
    return contextlib.nullcontext(), recomputing()


def _remat(model: TemporalStereoNet, train: bool):
    """``model``'s forward under a non-reentrant activation checkpoint: the
    backward runs it again for its activations, in the mode of the first
    run (the window has restored the model's own mode by then) and inside
    ``recomputing()``, so that the BatchNorm statistics are not blended a
    second time.  The kernels' ``autograd.Function``s save their inputs,
    which the recompute regenerates."""
    def run(left, right, prev):
        was_training = model.training
        model.train(train)
        try:
            return model(left, right, prev)
        finally:
            model.train(was_training)

    def forward(left, right, prev):
        return checkpoint(run, left, right, prev, use_reentrant=False,
                          context_fn=_recompute_contexts)
    return forward


def multi_frame_forward(model: TemporalStereoNet,
                        batch: Dict[str, torch.Tensor], train: bool = False,
                        previous_with_gradient: bool = False,
                        remat: bool = False, mesh=None):
    """Run the temporal window -> (outputs of the final frame, final state).

    By default the past frames run in eval mode without gradients (their
    BatchNorms read the running statistics and update nothing) and only the
    final frame runs in ``train`` mode with gradients, so only it updates
    the BatchNorm statistics.  With ``previous_with_gradient`` (BPTT) every
    frame runs in ``train`` mode with gradients through the backbone
    memories, and the outputs are the list of every frame's.  The model's
    own train/eval mode is restored on return.

    ``remat`` (``TPU.REMAT``) keeps only each BPTT frame's inputs and
    carried state and recomputes its activations in the backward: one more
    forward per frame for memory O(1) frames in T.  As in the JAX package,
    the warp between frames stays outside the checkpoint (the splat's
    inputs are detached, so the recompute never reaches it), and without
    BPTT nothing is checkpointed: the past frames run without gradients,
    which keeps no activations (JAX's remat there only stops XLA from
    buffering a dead backward), and the final frame's backward needs its
    activations either way.

    ``mesh`` (``parallel/mesh.py``): with more than one rank, ``batch`` is
    this rank's shard, and the temporal update's splat metric takes its
    mean over the global batch (the BatchNorms reduce as
    ``synchronise_batch_norms`` set them).
    """
    left, right = batch["left"], batch["right"]
    t, b, full_h, full_w, _ = left.shape
    was_training = model.training
    try:
        if not model.with_previous:
            model.train(train)
            return model(left[-1], right[-1], None)

        K, baseline = batch["K"], batch["baseline"]
        t_p2n = chained_poses(batch["T_cam"], batch["inv_T"])
        prev = init_prev_info(
            model, b, (full_h, full_w),
            backbone_memory_shapes(model.backbone_cfg, (full_h, full_w)),
            model.precise_cfg.get("topk", 2),
            local_map_channels=0 if model.local_map_size > 0 else None,
            device=left.device)

        if previous_with_gradient:
            model.train(train)
            forward = _remat(model, train) if remat else model
            all_outputs = []
            for i in range(t):
                if i > 0:
                    prev = update_prev_info(
                        prev, K, baseline, t_p2n[i], (full_h, full_w),
                        model.use_past_cost, model.local_map_size, mesh)
                outputs, prev = forward(left[i], right[i], prev)
                all_outputs.append(outputs)
            return all_outputs, prev

        model.eval()
        with torch.no_grad():
            for i in range(t - 1):
                _, prev = _frame(model, left[i], right[i], prev, K, baseline,
                                 t_p2n[i], warp=i > 0, mesh=mesh)
        model.train(train)
        return _frame(model, left[-1], right[-1], prev, K, baseline,
                      t_p2n[-1], warp=t > 1, mesh=mesh)
    finally:
        model.train(was_training)
