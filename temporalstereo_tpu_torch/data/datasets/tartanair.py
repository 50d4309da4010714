"""TartanAir stereo video.

Counterpart of the JAX package's ``data/datasets/tartanair.py``: metric
.npy depth (a PNG depth is in centimetres), ground-truth quaternion poses
with the NED -> camera correction, baseline 0.25, 480x640.
"""
from __future__ import annotations

import os

import numpy as np

from ...utils.registry import DATASET_REGISTRY
from ..formats import tartanair_pose_to_matrix
from ..png import read_png
from .base import StereoDataset


@DATASET_REGISTRY.register(name="TartanAir")
class TartanAirDataset(StereoDataset):
    norm_K = np.array([[320.0 / 640, 0, 320.0 / 640],
                       [0, 320.0 / 480, 240.0 / 480],
                       [0, 0, 1.0]])
    full_resolution = (480, 640)
    baseline = 0.25
    with_depth_gt = True
    with_disp_gt = False
    with_pose_gt = True

    def depth_loader(self, path: str, full_K=None) -> np.ndarray:
        full = os.path.join(self.root, path)
        if full.endswith(".npy"):
            return np.load(full).astype(np.float32)
        return read_png(full).astype(np.float32) / 100.0

    def extrinsic_loader(self, path: str):
        """pose_left.txt: x y z qx qy qz qw (cam-to-world, NED) a frame ->
        [N, 4, 4] world->cam."""
        rows = np.loadtxt(os.path.join(self.root, path)).reshape(-1, 7)
        mats = np.stack([tartanair_pose_to_matrix(r) for r in rows])
        return np.linalg.inv(mats).astype(np.float32)

    def get_extrinsic(self, extrinsics, image_path: str) -> np.ndarray:
        base = os.path.basename(image_path)
        idx = int("".join(ch for ch in base.split(".")[0] if ch.isdigit()))
        return extrinsics[min(idx, len(extrinsics) - 1)]
