"""The trainer: epochs, validation, checkpoints, resume, SWA and warm
starts.

Counterpart of the JAX package's ``training/trainer.py``.  The order of
work is the JAX package's, batch for batch:
  * the experiment dir ``LOG_DIR/TRAINER.NAME/TRAINER.VERSION`` with
    ``log.txt``, ``tb/metrics.jsonl``, ``checkpoints/`` and a copy of the
    port's code;
  * the weights from ``SEED`` (the port's own generator, not
    ``jax.random``), then ``MODEL.BACKBONE.PRETRAINED`` (a timm ``.pth``),
    then ``TRAINER.RESUME_FROM_CHECKPOINT`` (a checkpoint directory: the
    whole state) or ``TRAINER.LOAD_FROM_CHECKPOINT`` (weights only);
  * ``fit``: every epoch from 0 to MAX_EPOCHS (a resumed run starts at 0
    as the JAX package's does), validation every CHECK_VAL_EVERY_N_EPOCHS,
    checkpoints every EVERY_N_EPOCHS and EVERY_N_TRAIN_STEPS, FAST_DEV_RUN
    (2 train and 2 eval batches, one epoch); then the SWA finish and the
    final checkpoint and ``weights_final.pth``;
  * epoch means of the eval metrics weighted by ``weight`` and
    ``weight:<key>``.
Loss and metrics are read back from the card only every
FLUSH_LOGS_EVERY_N_STEPS and LOG_EVERY_N_STEPS steps.  ``timings`` records
the loader's wait and the step's time per batch (``step_s`` waits for the
card only on a step that reads the loss back; on the others it is the
host's time to enqueue the step), the eval time per
sample, each checkpoint's seconds and size, and the SWA finish; each
loader's worker pool starts once and stops at the end of ``fit`` and
``test``.

Data parallelism (``multihost``, the ``train --multihost`` CLI under
``torchrun``): each rank loads its shard of every split (``num_shards`` =
the ranks), the global batch is ``DATA.TRAIN.BATCH_SIZE`` x the ranks, and
the steps reduce over the ranks (``training/step.py``): BatchNorm
statistics, losses, gradients and eval metrics are those of the global
batch, as under JAX's SPMD partitioner.  The initial state is rank 0's,
broadcast after the seed, the warm starts and a resume.  Only rank 0
writes: the text log, the metrics, the code copy, images, checkpoints and
``weights_final.pth``; every rank waits for each checkpoint to be written.
The image logs' forwards run on rank 0 alone, on its own batch, in eval
mode and without the mesh, so that they reduce nothing (as JAX's process
0 runs them on its host-local batch).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch

from .. import kernels
from ..config import ConfigNode
from ..data import build_dataloader
from ..data.loader import prefetch_to_device
from ..data.transforms import denormalize
from ..models import build_model, multi_frame_forward, resolve_device
from ..ops.interpolate import resize_bilinear
from ..parallel.mesh import (barrier, broadcast_tree, init_distributed,
                             make_data_mesh, shard_batch_multihost,
                             world_size)
from ..utils.logging import FileWriter, MetricLogger, format_error_table
from ..visualization import disp_err_to_colorbar, disp_to_color
from .checkpoint import (CheckpointManager, load_any_weights, save_weights,
                         warm_start_backbone)
from .optim import build_optimizer
from .state import TrainState, master_copies
from .step import load_working_copy, make_eval_step, make_train_step

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def backup_code(dst_dir: str) -> None:
    """Snapshot the port's package into the experiment dir."""
    os.makedirs(dst_dir, exist_ok=True)
    shutil.copytree(PACKAGE_DIR,
                    os.path.join(dst_dir, os.path.basename(PACKAGE_DIR)),
                    dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))


def _host(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """0-d tensors -> floats, in one read-back."""
    names = list(metrics)
    values = torch.stack([metrics[k].float() for k in names]).tolist()
    return dict(zip(names, values))


class Trainer:
    def __init__(self, cfg: ConfigNode, device=None, multihost: bool = False):
        if multihost:
            device = init_distributed(device)
        elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
            raise RuntimeError("the port trains in one process unless "
                               "--multihost (multihost=True) is given")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mesh = make_data_mesh(cfg.DATA.TRAIN.BATCH_SIZE * world_size(),
                                   cfg.TPU.MESH.DATA, self.device)
        self.is_main = self.mesh.is_main
        self.exp_dir = os.path.join(cfg.LOG_DIR, cfg.TRAINER.NAME,
                                    cfg.TRAINER.VERSION)
        self.writer = FileWriter(self.exp_dir, self.is_main)
        self.metrics = MetricLogger(os.path.join(self.exp_dir, "tb"),
                                    self.is_main)
        if self.is_main:
            backup_code(os.path.join(self.exp_dir, "code"))
        self.timings = defaultdict(list)

        seed = cfg.get("SEED", 43)
        np.random.seed(seed)
        self.model = build_model(cfg, device=self.device, seed=seed)
        self.train_loader = self._loader(cfg.DATA.TRAIN, "train")
        self.val_loader = self._loader(cfg.DATA.VAL, "val")

        self.steps_per_epoch = max(len(self.train_loader), 1)
        self.tx = build_optimizer(cfg, self.steps_per_epoch)
        total_steps = self.steps_per_epoch * cfg.TRAINER.MAX_EPOCHS
        swa_cfg = cfg.TRAINER.get("SWA", None)
        swa_enabled = bool(swa_cfg and swa_cfg.get("ENABLED", False))
        swa_start = (int(total_steps * swa_cfg.get("START_FRACTION", 0.8))
                     if swa_enabled else -1)

        self.state = self._init_state(swa_enabled)
        self.ckpt = (CheckpointManager(
            os.path.join(self.exp_dir, "checkpoints"),
            keep=cfg.CHECKPOINT.get("KEEP", -1)) if self.is_main else None)
        self.train_step = make_train_step(self.model, cfg,
                                          swa_start_step=swa_start,
                                          mesh=self.mesh)
        self.eval_step = make_eval_step(self.model, cfg, mesh=self.mesh)
        self._maybe_restore()
        tensors = ("params", "batch_stats", "opt_state", "swa_params")
        self.state = dataclasses.replace(self.state, **broadcast_tree(
            {f: getattr(self.state, f) for f in tensors}, self.mesh))

    def _loader(self, node, phase: str):
        """This rank's shard of a split."""
        return build_dataloader(node, phase, num_shards=self.mesh.world,
                                shard_index=self.mesh.rank)

    # ------------------------------------------------------------------ --
    def _init_state(self, with_swa: bool) -> TrainState:
        params, stats = master_copies(self.model)
        params, stats = self._maybe_load_pretrained_backbone(params, stats)
        return TrainState.create(params, stats, self.tx, with_swa=with_swa)

    def _maybe_load_pretrained_backbone(self, params, stats):
        """MODEL.BACKBONE.PRETRAINED: a timm EfficientNetV2 state_dict
        (.pth) whose trunk tensors merge into the backbone by name."""
        path = self.cfg.MODEL.BACKBONE.get("PRETRAINED", "")
        if not path:
            return params, stats
        if not os.path.exists(path):
            self.writer.stdout(f"WARNING: MODEL.BACKBONE.PRETRAINED={path} "
                               "not found; backbone trains from scratch")
            return params, stats
        groups = self.model.backbone_cfg.get("groups")
        if groups is None:
            from ..models.backbone import V2S_GROUPS as groups
        params, stats, n = warm_start_backbone(params, stats, path, groups)
        self.writer.stdout(f"backbone warm start: {n} tensors from {path}")
        return params, stats

    def _maybe_restore(self) -> None:
        cfg = self.cfg
        resume = cfg.TRAINER.get("RESUME_FROM_CHECKPOINT", "")
        load = cfg.TRAINER.get("LOAD_FROM_CHECKPOINT", "")
        if resume:
            self.state = CheckpointManager(resume).restore(self.state)
            self.writer.stdout(f"resumed from {resume} "
                               f"@ step {self.state.step}")
        elif load:
            if not os.path.exists(load):
                self.writer.stdout(f"WARNING: warm-start checkpoint {load} "
                                   "not found; training from scratch")
                return
            params, stats, n = load_any_weights(
                self.state.params, self.state.batch_stats, load)
            self.state = dataclasses.replace(self.state, params=params,
                                             batch_stats=stats)
            self.writer.stdout(f"warm-started {n} tensors from {load}")

    def _save(self, step: int) -> None:
        """Rank 0 writes the checkpoint; every rank waits for it."""
        t0 = time.perf_counter()
        if self.is_main and self.ckpt.save(step, self.state,
                                           hparams=self.cfg.to_dict()):
            self.timings["checkpoint_s"].append(time.perf_counter() - t0)
            self.timings["checkpoint_mb"].append(
                os.path.getsize(self.ckpt.path(step)) / 2 ** 20)
        barrier(self.mesh)

    # ------------------------------------------------------------------ --
    def fit(self) -> None:
        cfg = self.cfg
        max_epochs = cfg.TRAINER.MAX_EPOCHS
        fast_dev = cfg.TRAINER.get("FAST_DEV_RUN", False)
        self.writer.set_num_total_steps(self.steps_per_epoch * max_epochs)
        self.writer.set_start_time(time.time())
        try:
            for epoch in range(max_epochs):
                self._train_epoch(epoch, fast_dev)
                if (epoch + 1) % cfg.TRAINER.CHECK_VAL_EVERY_N_EPOCHS == 0:
                    self.validate(epoch)
                if (epoch + 1) % max(cfg.CHECKPOINT.EVERY_N_EPOCHS, 1) == 0:
                    self._save(self.state.step)
                if fast_dev:
                    break
            self._finalize_swa()
            self._save(self.state.step)
            if self.is_main:
                save_weights(os.path.join(self.exp_dir, "weights_final.pth"),
                             self.state.params, self.state.batch_stats)
            barrier(self.mesh)
        finally:
            self.train_loader.close()
            self.val_loader.close()

    def _finalize_swa(self) -> None:
        """Swap in the SWA average of the f32 masters, then re-estimate
        the BatchNorm statistics with train-mode forwards (no gradients)
        over min(steps per epoch, BN_UPDATE_STEPS) train batches, over the
        ranks' global batches (the model's BatchNorms were synchronised by
        ``make_train_step``); the masters and the optimizer state stay as
        they are."""
        if self.state.swa_params is None or self.state.swa_count == 0:
            return
        t0 = time.perf_counter()
        self.state = dataclasses.replace(
            self.state, params=self.state.swa_model_params())
        max_batches = min(self.steps_per_epoch,
                          int(self.cfg.TRAINER.SWA.get("BN_UPDATE_STEPS", 50)))
        if max_batches <= 0:
            return
        load_working_copy(self.model, self.state)
        for i, (device_batch, _) in enumerate(
                self._prefetch(self.train_loader)):
            if i >= max_batches:
                break
            with torch.no_grad():
                multi_frame_forward(self.model, device_batch, train=True,
                                    mesh=self.mesh)
        stats = {name: self.model.get_buffer(name).detach().float().clone()
                 for name in self.state.batch_stats}
        self.state = dataclasses.replace(self.state, batch_stats=stats)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings["swa_finish_s"].append(time.perf_counter() - t0)
        self.writer.stdout(
            f"SWA: swapped in averaged weights ({self.state.swa_count} "
            f"snapshots), BN re-estimated over {max_batches} batches")

    def _prefetch(self, loader):
        """(device_batch, host_batch) pairs of this rank's shard,
        TPU.HOST_PREFETCH batches' copies ahead of the step."""
        local = (shard_batch_multihost(self.mesh, b) for b in loader)
        return prefetch_to_device(local, self.cfg.TPU.get("HOST_PREFETCH",
                                                          2), self.device)

    def _train_epoch(self, epoch: int, fast_dev: bool = False) -> None:
        cfg = self.cfg
        every_n_steps = max(cfg.CHECKPOINT.get("EVERY_N_TRAIN_STEPS", 0), 0)
        vis_every = max(cfg.TRAINER.get("VIS_EVERY_N_TRAIN_STEPS", 2000), 0)
        t_wait = time.perf_counter()
        for batch_idx, (device_batch, batch) in enumerate(
                self._prefetch(self.train_loader)):
            t0 = time.perf_counter()
            self.timings["loader_wait_s"].append(t0 - t_wait)
            self.state, metrics = self.train_step(self.state, device_batch)
            step = self.state.step
            if step % cfg.TRAINER.FLUSH_LOGS_EVERY_N_STEPS == 0:
                loss = float(metrics["loss"])
                self.writer.log_time(step, epoch, batch_idx,
                                     cfg.DATA.TRAIN.BATCH_SIZE,
                                     time.perf_counter() - t0, loss)
            if step % cfg.TRAINER.LOG_EVERY_N_STEPS == 0:
                self.metrics.log_scalars(step, _host(metrics),
                                         prefix="train/")
            self.timings["step_s"].append(time.perf_counter() - t0)
            if vis_every and step % vis_every == 0:
                self._log_images(device_batch, batch, epoch, prefix="train_")
            if every_n_steps and step % every_n_steps == 0:
                self._save(step)
            if fast_dev and batch_idx >= 1:
                break
            t_wait = time.perf_counter()

    def validate(self, epoch: int) -> Dict[str, float]:
        return self._run_eval(self.val_loader, epoch, tag="Validation",
                              prefix="val/")

    def test(self, epoch: Optional[int] = None) -> Dict[str, float]:
        """A pass over the DATA.TEST split after fit."""
        loader = self._loader(self.cfg.DATA.TEST, "test")
        if epoch is None:
            epoch = self.cfg.TRAINER.MAX_EPOCHS
        try:
            return self._run_eval(loader, epoch, tag="Test", prefix="test/")
        finally:
            loader.close()

    def _run_eval(self, loader, epoch: int, tag: str, prefix: str
                  ) -> Dict[str, float]:
        """Epoch means of the eval metrics: each batch's metrics weighted
        by its real-sample count ``weight``, or by ``weight:<key>`` for a
        metric pooled over a sub-population (the occ/noc splits); both are
        global over the ranks, so every rank computes the same means."""
        load_working_copy(self.model, self.state)
        sums = defaultdict(float)
        totals = defaultdict(float)
        vis_interval = max(self.cfg.VAL.get("VIS_INTERVAL", 8), 1)
        vis_batch = epoch % max(len(loader) // vis_interval, 1)
        fast_dev = self.cfg.TRAINER.get("FAST_DEV_RUN", False)
        for batch_idx, (device_batch, batch) in enumerate(
                self._prefetch(loader)):
            t0 = time.perf_counter()
            metrics = _host(self.eval_step(device_batch))
            self.timings["val_sample_s"].append(
                (time.perf_counter() - t0) / batch["left"].shape[1])
            weight = float(metrics.pop("weight", batch["left"].shape[1]))
            keyed_w = {k[len("weight:"):]: float(metrics.pop(k))
                       for k in list(metrics) if k.startswith("weight:")}
            for k, v in metrics.items():
                w = keyed_w.get(k, weight)
                sums[k] += float(v) * w
                totals[k] += w
            if batch_idx == vis_batch:
                self._log_images(device_batch, batch, epoch)
            if fast_dev and batch_idx >= 1:
                break
        means = {k: v / max(totals[k], 1) for k, v in sums.items()}
        self.writer.stdout("\n" + "*" * 40 +
                           f"  {tag} on Epoch: {epoch}  " + "*" * 40)
        self.writer.stdout(format_error_table(means))
        self.metrics.log_scalars(self.state.step, means, prefix=prefix)
        return means

    def _log_images(self, device_batch, batch, epoch: int,
                    prefix: str = "val/") -> None:
        """Image dumps of up to VAL.VIS_BATCH_INDEX samples: input, ground
        truth, predicted disparity and error colour bar per scale, the
        local map and the search-range low/high/validity maps, on rank 0
        only (its forward, in eval mode without the mesh, reduces
        nothing).  The
        forward runs outside any ``try``: its failure ends the run."""
        n_vis = self.cfg.VAL.get("VIS_BATCH_INDEX", 4)
        if n_vis <= 0 or not self.is_main:
            return      # dumps disabled: no extra forward either
        load_working_copy(self.model, self.state)
        with torch.no_grad():
            outputs, _ = multi_frame_forward(self.model, device_batch,
                                             train=False)
        step = self.state.step
        full_h, full_w = batch["left"].shape[2:4]
        max_disp_cfg = self.cfg.get("MAX_DISP", 192)

        def host(x, bs):
            return x[bs].float().cpu().numpy()

        for bs in range(min(n_vis, batch["left"].shape[1])):
            self.metrics.log_image(step, f"{prefix}color_0_l/{bs}",
                                   denormalize(batch["left"][-1][bs]))
            gt = batch["disp_gt"][-1][bs, :, :, 0]
            gh, gw = gt.shape
            max_disp = float(gt.max()) if gt.max() > 0 else None
            if max_disp:
                self.metrics.log_image(step, f"{prefix}disparity_gt/{bs}",
                                       disp_to_color(gt, max_disp))
            for i, d in enumerate(outputs["disps"]):
                disp = host(d, bs)[:, :, 0]
                self.metrics.log_image(step, f"{prefix}disparity_{i}/{bs}",
                                       disp_to_color(disp, max_disp))
                if max_disp:
                    if disp.shape != (gh, gw):
                        disp = host(resize_bilinear(
                            d.float() * (gw / d.shape[2]), (gh, gw)),
                            bs)[:, :, 0]
                    self.metrics.log_image(
                        step, f"{prefix}disp_errorbar_{i}/{bs}",
                        disp_err_to_colorbar(disp, gt, with_bar=True))
            lm = outputs.get("local_map")
            if lm is not None:
                mw = lm.shape[2]
                lm_full = host(resize_bilinear(lm.float() * (full_w / mw),
                                               (full_h, full_w)), bs)
                stacked = lm_full.transpose(2, 0, 1).reshape(-1, full_w)
                self.metrics.log_image(step, f"{prefix}local_map/{bs}",
                                       disp_to_color(stacked, max_disp))
            for sr in outputs.get("search_ranges", []):
                w = sr["low"].shape[2]
                lvl = int(np.log2(max(full_w // w, 1)))
                low, high = (host(resize_bilinear(
                    sr[k].float() * (gw / w), (gh, gw)), bs)[:, :, 0]
                    for k in ("low", "high"))
                self.metrics.log_image(
                    step, f"{prefix}low_disparity_{lvl}/{bs}",
                    disp_to_color(low, max_disp))
                self.metrics.log_image(
                    step, f"{prefix}high_disparity_{lvl}/{bs}",
                    disp_to_color(high, max_disp))
                if max_disp:
                    mask = (gt > 0) & (gt < max_disp_cfg)
                    valid = (mask & (low <= gt) & (high >= gt)) | ~mask
                    self.metrics.log_image(
                        step, f"{prefix}search_range_valid_{lvl}/{bs}",
                        np.repeat(valid[..., None].astype(np.float32), 3,
                                  axis=-1))

    # ------------------------------------------------------------------ --
    def summary(self) -> Dict:
        """The timings (medians and totals), the kernels' launch counts
        and the peak device memory, for a JSON line."""
        out = {"step": self.state.step, "swa_count": self.state.swa_count,
               "launches": dict(kernels.LAUNCHES)}
        for k, v in self.timings.items():
            out[k] = {"n": len(v), "median": float(np.median(v)),
                      "sum": float(np.sum(v)), "all": [round(x, 6) for x in v]}
        if self.device.type == "cuda":
            out["peak_gib"] = torch.cuda.max_memory_allocated(
                self.device) / 2 ** 30
        return out

    def close(self) -> None:
        self.train_loader.close()
        self.val_loader.close()
        self.metrics.close()
        self.writer.stdout("train summary: " + json.dumps(self.summary()))
        self.writer.close()
