"""ETH3D and DrivingStereo.

Counterpart of the JAX package's ``data/datasets/extra_formats.py``.
"""
from __future__ import annotations

import os

import numpy as np

from ...utils.registry import DATASET_REGISTRY
from ..formats import load_kitti_disp, load_pfm
from .base import StereoDataset


def read_eth3d_intrinsic(path: str):
    """An ETH3D camera file whose last line is ``<id> PINHOLE <w> <h> <fx>
    <fy> <cx> <cy>`` -> (K [3, 3], (h, w))."""
    with open(path, "r") as fp:
        lines = [ln for ln in fp.read().splitlines()
                 if ln.strip() and not ln.startswith("#")]
    fields = lines[-1].split()
    assert fields[1] == "PINHOLE", f"unsupported camera model {fields[1]!r}"
    w, h = int(fields[2]), int(fields[3])
    fx, fy, cx, cy = (float(v) for v in fields[4:8])
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    return K, (h, w)


@DATASET_REGISTRY.register(name="ETH3D")
class ETH3DDataset(StereoDataset):
    """ETH3D two-view stereo: PFM disparity (inf = invalid), per-scene
    camera files; the class intrinsics only when an item names none."""
    norm_K = np.array([[3408.59 / 6048, 0, 3117.0 / 6048],
                       [0, 3408.59 / 4032, 2064.0 / 4032],
                       [0, 0, 1.0]])
    full_resolution = (4032, 6048)
    baseline = 0.595499
    with_depth_gt = False
    with_disp_gt = True
    with_pose_gt = False

    def intrinsic_loader(self, intrinsic_path: str):
        path = os.path.join(self.root, intrinsic_path)
        if not (intrinsic_path.endswith(".txt") and os.path.exists(path)):
            return super().intrinsic_loader(intrinsic_path)
        full_K, (h, w) = read_eth3d_intrinsic(path)
        norm_K = full_K.copy()
        norm_K[0, :] /= w
        norm_K[1, :] /= h
        return norm_K, full_K, (h, w)

    def disp_loader(self, path: str, full_K=None) -> np.ndarray:
        disp, _ = load_pfm(os.path.join(self.root, path))
        disp = np.asarray(disp, np.float32)
        return np.where(np.isfinite(disp), disp, 0.0)


@DATASET_REGISTRY.register(name="DrivingStereo")
class DrivingStereoDataset(StereoDataset):
    """DrivingStereo: uint16 / 256 PNG disparity, 800x1758."""
    norm_K = np.array([[1003.556 / 1758, 0, 879.0 / 1758],
                       [0, 1003.556 / 800, 400.0 / 800],
                       [0, 0, 1.0]])
    full_resolution = (800, 1758)
    baseline = 0.5443
    with_depth_gt = False
    with_disp_gt = True
    with_pose_gt = False

    def disp_loader(self, path: str, full_K=None) -> np.ndarray:
        return load_kitti_disp(os.path.join(self.root, path))
