"""KITTI calibration files and camera projections (numpy).

A copy of the JAX package's ``data/calibration.py``: ``read_calib_file``
and ``Projection`` (velodyne <-> rectified camera <-> image, depth <->
disparity).
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def read_calib_file(path: str) -> Dict[str, np.ndarray]:
    """Parse 'key: v v v ...' calibration text files."""
    data: Dict[str, np.ndarray] = {}
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or ":" not in line:
                continue
            key, value = line.split(":", 1)
            try:
                data[key.strip()] = np.array(
                    [float(v) for v in value.split()])
            except ValueError:
                data[key.strip()] = value.strip()
    return data


def to_homogeneous(points: np.ndarray) -> np.ndarray:
    """[N, 3] -> [N, 4]."""
    return np.concatenate(
        [points, np.ones((points.shape[0], 1), points.dtype)], axis=1)


class Projection:
    """Rigid and projective transforms between velodyne, rectified-camera
    and image coordinates."""

    def __init__(self, calib: Dict[str, np.ndarray], camera: int = 2):
        P = calib[f"P_rect_0{camera}"] if f"P_rect_0{camera}" in calib \
            else calib[f"P{camera}"]
        self.P = np.asarray(P).reshape(3, 4)
        self.K = self.P[:3, :3]

        R = calib.get("R_rect_00", calib.get("R0_rect"))
        self.R_rect = np.eye(4)
        if R is not None:
            self.R_rect[:3, :3] = np.asarray(R).reshape(3, 3)

        Tv = calib.get("Tr_velo_to_cam", calib.get("Tr_velo_cam"))
        self.T_velo_to_cam = np.eye(4)
        if Tv is not None:
            self.T_velo_to_cam[:3, :] = np.asarray(Tv).reshape(3, 4)

        # baseline from projection-matrix translation: P[0,3] = -fx * b
        self.fx = self.P[0, 0]
        self.tx = self.P[0, 3] / (-self.fx)

    def velo_to_rect(self, points: np.ndarray) -> np.ndarray:
        homo = to_homogeneous(points)
        rect = (self.R_rect @ self.T_velo_to_cam @ homo.T).T
        return rect[:, :3]

    def rect_to_velo(self, points: np.ndarray) -> np.ndarray:
        """Inverse rigid transform rect -> velodyne."""
        homo = to_homogeneous(points)
        inv = np.linalg.inv(self.R_rect @ self.T_velo_to_cam)
        velo = (inv @ homo.T).T
        return velo[:, :3]

    def rect_to_image(self, points: np.ndarray) -> np.ndarray:
        homo = to_homogeneous(points)
        img = (self.P @ homo.T).T
        return img[:, :2] / np.maximum(img[:, 2:3], 1e-9)

    def velo_to_image(self, points: np.ndarray) -> np.ndarray:
        return self.rect_to_image(self.velo_to_rect(points))

    def depth_to_rect(self, depth: np.ndarray, image: np.ndarray = None):
        """Unproject a depth map to rectified-camera 3D points, exactly
        inverting ``rect_to_image`` (incl. the P[:, 3] camera offset), with
        optional per-point color.

        Returns (points [N, 3], color [N, C] or None)."""
        v, u = np.where(depth > 0.0)
        z = depth[v, u].astype(np.float64)
        P = self.P
        # projective depth includes the rectified P's last-row offset:
        # [u, v, 1] * zp = P @ [X, Y, Z, 1], zp = Z + P[2, 3]
        zp = z + P[2, 3]
        x = (u * zp - P[0, 2] * z - P[0, 3]) / P[0, 0]
        y = (v * zp - P[1, 2] * z - P[1, 3]) / P[1, 1]
        points = np.stack([x, y, z], axis=1)
        color = image[v, u] if image is not None else None
        return points, color

    def depth_to_velo(self, depth: np.ndarray) -> np.ndarray:
        """Depth map -> velodyne-frame point cloud."""
        points, _ = self.depth_to_rect(depth)
        return self.rect_to_velo(points)

    def velo_to_depth_map(self, points: np.ndarray, shape) -> np.ndarray:
        """Sparse depth map from a velodyne scan, the nearest point per
        pixel."""
        h, w = shape
        rect = self.velo_to_rect(points)
        valid = rect[:, 2] > 0.1
        rect = rect[valid]
        uv = self.rect_to_image(rect)
        u = np.round(uv[:, 0]).astype(int)
        v = np.round(uv[:, 1]).astype(int)
        ok = (u >= 0) & (u < w) & (v >= 0) & (v < h)
        depth = np.zeros((h, w), np.float32)
        # keep the nearest point per pixel
        order = np.argsort(-rect[ok, 2])
        depth[v[ok][order], u[ok][order]] = rect[ok, 2][order]
        return depth

    def depth_to_disparity(self, depth: np.ndarray,
                           baseline: float) -> np.ndarray:
        return np.where(depth > 1e-6,
                        self.fx * baseline / np.maximum(depth, 1e-6), 0.0)

    def disparity_to_depth(self, disp: np.ndarray,
                           baseline: float) -> np.ndarray:
        return np.where(disp > 1e-6,
                        self.fx * baseline / np.maximum(disp, 1e-6), 0.0)
