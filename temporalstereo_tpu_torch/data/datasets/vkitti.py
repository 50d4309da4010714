"""Virtual KITTI 2 stereo video.

Counterpart of the JAX package's ``data/datasets/vkitti.py``: PNG depth in
centimetres, ``extrinsic.txt`` rows (world->cam), baseline 0.532725,
375x1242.
"""
from __future__ import annotations

import os

import numpy as np

from ...utils.registry import DATASET_REGISTRY
from ..formats import load_vkitti_depth
from .base import StereoDataset


@DATASET_REGISTRY.register(name="VKITTI2")
class VKITTI2Dataset(StereoDataset):
    norm_K = np.array([[725.0087 / 1242, 0, 620.5 / 1242],
                       [0, 725.0087 / 375, 187.0 / 375],
                       [0, 0, 1.0]])
    full_resolution = (375, 1242)
    baseline = 0.532725
    with_depth_gt = True
    with_disp_gt = False
    with_pose_gt = True

    def depth_loader(self, path: str, full_K=None) -> np.ndarray:
        return load_vkitti_depth(os.path.join(self.root, path))

    def extrinsic_loader(self, path: str):
        """``frame cameraID r11 .. r44`` rows after a header; camera 0 is
        the left one -> {frame: [4, 4]}."""
        poses = {}
        with open(os.path.join(self.root, path), "r") as f:
            f.readline()
            for line in f:
                vals = line.split()
                if len(vals) < 18:
                    continue
                frame, cam = int(vals[0]), int(vals[1])
                if cam != 0:
                    continue
                poses[frame] = np.array([float(v) for v in vals[2:18]],
                                        dtype=np.float32).reshape(4, 4)
        return poses

    def get_extrinsic(self, extrinsics, image_path: str) -> np.ndarray:
        base = os.path.basename(image_path)
        idx = int("".join(ch for ch in base.split(".")[0] if ch.isdigit()))
        if idx in extrinsics:
            return extrinsics[idx]
        return np.eye(4, dtype=np.float32)
