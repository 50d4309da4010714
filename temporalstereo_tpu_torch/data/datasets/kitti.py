"""KITTI 2015 and KITTI raw stereo video.

Counterpart of the JAX package's ``data/datasets/kitti.py``: uint16 / 256
PNG disparity, intrinsics from a calib file, ORB-SLAM3 poses (cam-to-world
rows, inverted on load), baseline 0.54, native 375x1242.
"""
from __future__ import annotations

import os

import numpy as np

from ...utils.registry import DATASET_REGISTRY
from ..calibration import read_calib_file
from ..formats import load_kitti_disp, load_pose_file
from .base import StereoDataset


@DATASET_REGISTRY.register(name="KITTI2015")
class KITTI2015Dataset(StereoDataset):
    norm_K = np.array([[721.5377 / 1242, 0, 609.5593 / 1242],
                       [0, 721.5377 / 375, 172.854 / 375],
                       [0, 0, 1.0]])
    full_resolution = (375, 1242)
    baseline = 0.54
    with_depth_gt = False
    with_disp_gt = True
    with_pose_gt = True

    def disp_loader(self, path: str, full_K=None) -> np.ndarray:
        return load_kitti_disp(os.path.join(self.root, path))

    def intrinsic_loader(self, intrinsic_path: str):
        """``P_rect_02`` (or ``P2``) and ``S_rect_02`` of the scene's calib
        file when the item names one; the nominal KITTI intrinsics else."""
        full = os.path.join(self.root, str(intrinsic_path))
        if str(intrinsic_path).endswith(".txt") and os.path.exists(full):
            data = read_calib_file(full)
            key = "P_rect_02" if "P_rect_02" in data else "P2"
            K = np.asarray(data[key]).reshape(3, 4)[:3, :3]
            if "S_rect_02" in data:
                w, h = np.asarray(data["S_rect_02"])
            else:
                h, w = self.full_resolution
            norm_K = K.copy()
            norm_K[0, :] /= w
            norm_K[1, :] /= h
            return norm_K, K, (int(h), int(w))
        return super().intrinsic_loader(intrinsic_path)

    def extrinsic_loader(self, path: str):
        return load_pose_file(os.path.join(self.root, path), invert=True)

    def get_extrinsic(self, extrinsics, image_path: str) -> np.ndarray:
        name = os.path.splitext(os.path.basename(image_path))[0]
        # '000123_10' (KITTI 2015 multiview) or '0000000042' (raw)
        idx = int(name.split("_")[-1] if "_" in name else name)
        return extrinsics[min(idx, len(extrinsics) - 1)]


@DATASET_REGISTRY.register(name="KITTIRAW")
class KITTIRawDataset(KITTI2015Dataset):
    """KITTI raw sequences with pseudo ground truth; pose rows indexed by
    the raw frame number."""

    def get_extrinsic(self, extrinsics, image_path: str) -> np.ndarray:
        idx = int(os.path.splitext(os.path.basename(image_path))[0])
        return extrinsics[min(idx, len(extrinsics) - 1)]
