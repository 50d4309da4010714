"""SceneFlow (FlyingThings3D, Driving, Monkaa).

Counterpart of the JAX package's ``data/datasets/scene_flow.py``: PFM
disparity, fixed normalised 35 mm intrinsics (15 mm for the scenes so
named), 540x960, baseline 1.
"""
from __future__ import annotations

import os

import numpy as np

from ...utils.registry import DATASET_REGISTRY
from ..formats import load_pfm, load_pose_file, load_sceneflow_camera_data
from .base import StereoDataset


@DATASET_REGISTRY.register(name="SceneFlow")
class SceneFlowDataset(StereoDataset):
    norm_K = np.array([[1050.0 / 960, 0, 497.5 / 960],
                       [0, 1050.0 / 540, 269.5 / 540],
                       [0, 0, 1.0]])
    norm_K15 = np.array([[450.0 / 960, 0, 497.5 / 960],
                         [0, 450.0 / 540, 269.5 / 540],
                         [0, 0, 1.0]])
    full_resolution = (540, 960)
    baseline = 1.0
    with_depth_gt = False
    with_disp_gt = True
    with_pose_gt = True

    def intrinsic_loader(self, intrinsic_path: str):
        norm_K = (self.norm_K15 if "15mm" in str(intrinsic_path)
                  else self.norm_K)
        h, w = self.full_resolution
        full_K = norm_K.copy()
        full_K[0, :] *= w
        full_K[1, :] *= h
        return norm_K.copy(), full_K, self.full_resolution

    def disp_loader(self, path: str, full_K=None) -> np.ndarray:
        """NaN and values outside [0, width] become 0 (invalid)."""
        disp, _ = load_pfm(os.path.join(self.root, path))
        disp = np.nan_to_num(disp, nan=0.0)
        w = disp.shape[1]
        disp[disp > w] = 0
        disp[disp < 0] = 0
        return disp.astype(np.float32)

    def extrinsic_loader(self, path: str):
        """``camera_data.txt`` Frame blocks (world->cam), or rows of
        cam-to-world poses; None (identity) when it cannot be read."""
        full = os.path.join(self.root, path)
        try:
            with open(full) as f:
                first = f.readline().split()
            if first and first[0] == "Frame":
                return load_sceneflow_camera_data(full)
            return load_pose_file(full, invert=True)
        except (ValueError, OSError):
            return None

    def get_extrinsic(self, extrinsics, image_path: str) -> np.ndarray:
        """The frame number is the last 4 digits of the image's name; a
        frame missing from the file is the identity."""
        if extrinsics is None:
            return np.eye(4, dtype=np.float32)
        stem = os.path.splitext(os.path.basename(image_path))[0]
        digits = "".join(ch for ch in stem if ch.isdigit())
        idx = int(digits[-4:]) if digits else 0
        if isinstance(extrinsics, dict):
            entry = extrinsics.get(idx)
            if entry is None or "l" not in entry:
                return np.eye(4, dtype=np.float32)
            return entry["l"][0]
        return extrinsics[min(idx, len(extrinsics) - 1)]
