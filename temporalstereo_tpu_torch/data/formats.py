"""Image, disparity, depth, flow and pose files.

Copies of the JAX package's ``data/formats.py`` readers and writers, in
numpy and the standard library: PNG files are read and written by the
port's own codec (``data/png.py``), so no imaging package is needed for
them.  Only ``load_image`` of another format (JPEG, ...) imports Pillow.
"""
from __future__ import annotations

import os
import re
from typing import Tuple

import numpy as np

from .png import read_png, write_png


def load_pfm(path: str) -> Tuple[np.ndarray, float]:
    """A PFM file -> (array [H, W] or [H, W, 3] f32, top row first, scale)."""
    with open(path, "rb") as f:
        header = f.readline().decode("latin-1").rstrip()
        if header not in ("PF", "Pf"):
            raise ValueError(f"not a PFM file: {path}")
        dims = f.readline().decode("latin-1")
        m = re.match(r"^(\d+)\s(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"malformed PFM header in {path}")
        w, h = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().decode("latin-1").rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (h, w, 3) if header == "PF" else (h, w)
    data = np.flipud(data.reshape(shape))      # PFM stores bottom-up
    return np.ascontiguousarray(data, dtype=np.float32), abs(scale)


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    """[H, W] or [H, W, 3] -> a PFM file (bottom row first; a negative
    scale marks little-endian data)."""
    image = np.asarray(image, dtype=np.float32)
    color = image.ndim == 3 and image.shape[2] == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and np.little_endian):
            scale = -scale
        f.write(f"{scale}\n".encode())
        np.flipud(image).tofile(f)


def _load_png16(path: str) -> np.ndarray:
    return read_png(path).astype(np.float32)


def load_kitti_disp(path: str) -> np.ndarray:
    """KITTI uint16 PNG disparity (value / 256, 0 = invalid)."""
    return _load_png16(path) / 256.0


def load_kitti_depth(path: str) -> np.ndarray:
    """KITTI uint16 PNG depth (value / 256, 0 = invalid)."""
    return _load_png16(path) / 256.0


def sceneflow_disp_to_depth(disp: np.ndarray, focal: float = 1050.0,
                            baseline: float = 1.0) -> np.ndarray:
    """SceneFlow depth = focal * baseline / disparity."""
    return focal * baseline / np.maximum(disp, 1e-6)


def load_npy_depth(path: str, scale: float = 100.0) -> np.ndarray:
    """TartanAir .npy depth / ``scale``."""
    return np.load(path).astype(np.float32) / scale


def load_vkitti_depth(path: str) -> np.ndarray:
    """Virtual KITTI 2 PNG depth in centimetres -> metres."""
    return _load_png16(path) / 100.0


def load_flo(path: str) -> np.ndarray:
    """A Middlebury .flo file -> [H, W, 2] f32."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)[0]
        assert magic == 202021.25, f"bad .flo magic in {path}"
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path: str, flow: np.ndarray) -> None:
    """[H, W, 2] -> a Middlebury .flo file: f32 magic 202021.25, int32
    width and height, interleaved u/v rows."""
    assert flow.ndim == 3 and flow.shape[2] == 2, flow.shape
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.array([202021.25], np.float32).tofile(f)
        np.array(w, np.int32).tofile(f)
        np.array(h, np.int32).tofile(f)
        flow.astype(np.float32).reshape(h, w * 2).tofile(f)


def load_kitti_flow(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """KITTI 16-bit RGB PNG flow -> ((value - 2^15) / 64 [H, W, 2], valid
    [H, W] from the third channel)."""
    raw = _load_png16(path)
    flow = (raw[..., :2] - 2 ** 15) / 64.0
    return flow, raw[..., 2] > 0


def write_kitti_disp(path: str, disp: np.ndarray) -> None:
    """[H, W] disparity -> KITTI uint16 PNG (value * 256)."""
    write_png(path, np.clip(disp * 256.0, 0, 65535).astype(np.uint16))


def load_disparity(path: str) -> np.ndarray:
    """Disparity by extension: .pfm, KITTI uint16 .png or .npy -> [H, W]
    f32."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".pfm":
        disp, _ = load_pfm(path)
        return np.ascontiguousarray(disp).astype(np.float32)
    if ext == ".png":
        return load_kitti_disp(path)
    if ext == ".npy":
        return np.load(path).astype(np.float32)
    raise ValueError(f"unsupported disparity format: {path}")


def _quaternion_to_matrix(q: np.ndarray) -> np.ndarray:
    """Unit quaternion (x, y, z, w), normalised first -> 3x3 rotation."""
    x, y, z, w = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def tartanair_pose_to_matrix(pose_line: np.ndarray) -> np.ndarray:
    """TartanAir pose (x y z qx qy qz qw, NED axes) -> 4x4 cam-to-world in
    camera axes (C T C^T with the NED -> camera permutation C)."""
    T = np.eye(4, dtype=np.float64)
    T[:3, :3] = _quaternion_to_matrix(pose_line[3:7])
    T[:3, 3] = pose_line[:3]
    # NED (x forward, y right, z down) -> camera (x right, y down, z forward)
    ned2cam = np.array([[0, 1, 0, 0],
                        [0, 0, 1, 0],
                        [1, 0, 0, 0],
                        [0, 0, 0, 1]], dtype=np.float64)
    return (ned2cam @ T @ ned2cam.T).astype(np.float32)


def load_pose_file(path: str, invert: bool = True) -> np.ndarray:
    """ORB-SLAM3 / KITTI-odometry poses: one row of 12 or 16 floats (an
    optional leading timestamp) per frame, cam-to-world -> [N, 4, 4],
    world-to-cam when ``invert``."""
    rows = []
    with open(path, "r") as f:
        for line in f:
            vals = [float(v) for v in line.split()]
            if not vals:
                continue
            if len(vals) in (13, 17):
                vals = vals[1:]
            mat = np.eye(4, dtype=np.float64)
            if len(vals) == 12:
                mat[:3, :] = np.array(vals).reshape(3, 4)
            elif len(vals) == 16:
                mat = np.array(vals).reshape(4, 4)
            else:
                raise ValueError(f"unsupported pose row of {len(vals)} values")
            rows.append(mat)
    poses = np.stack(rows).astype(np.float64)
    if invert:
        poses = np.linalg.inv(poses)
    return poses.astype(np.float32)


def load_sceneflow_camera_data(path: str) -> dict:
    """SceneFlow ``camera_data.txt``: blocks ``Frame N`` / ``L <16
    floats>`` / ``R <16 floats>``, world->cam -> {frame: {side: (T,
    pinv(T))}}."""
    data: dict = {}
    frame = None
    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "Frame":
                frame = int(parts[1])
                data[frame] = {}
            elif parts[0] in ("L", "R") and frame is not None:
                T = np.array([float(v) for v in parts[1:]],
                             np.float64).reshape(4, 4)
                data[frame][parts[0].lower()] = (
                    T.astype(np.float32),
                    np.linalg.pinv(T).astype(np.float32))
    return data


def load_tartanair_pose_file(path: str) -> np.ndarray:
    """TartanAir poses, one ``x y z qx qy qz qw`` row per frame -> [N, 4, 4]
    world-to-cam in camera axes."""
    rows = []
    with open(path, "r") as f:
        for line in f:
            vals = [float(v) for v in line.split()]
            if not vals:
                continue
            if len(vals) != 7:
                raise ValueError(
                    f"TartanAir pose rows have 7 values, got {len(vals)}")
            c2w = tartanair_pose_to_matrix(np.asarray(vals, np.float64))
            rows.append(np.linalg.inv(c2w.astype(np.float64)))
    return np.stack(rows).astype(np.float32)


def sniff_pose_format(path: str) -> str:
    """'tartanair' (7 values a row) or 'matrix' (12 or 16)."""
    with open(path, "r") as f:
        for line in f:
            n = len(line.split())
            if n:
                return "tartanair" if n == 7 else "matrix"
    raise ValueError(f"empty pose file: {path}")


def load_image(path: str) -> np.ndarray:
    """An image -> RGB in [0, 1] f32 [H, W, 3].  A PNG is read by the
    port's codec (gray repeated to 3 channels, alpha dropped); any other
    format by Pillow, converted to RGB."""
    if not path.lower().endswith(".png"):
        try:
            from PIL import Image
        except ImportError as exc:
            raise ImportError(f"{path}: images other than PNG are read with "
                              "Pillow, which is not installed") from exc
        with Image.open(path) as img:
            return np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
    raw = read_png(path)
    if raw.dtype != np.uint8:
        raise ValueError(f"{path}: 16-bit PNG is not an RGB image")
    if raw.ndim == 2:
        raw = raw[..., None]
    if raw.shape[-1] < 3:
        raw = np.repeat(raw[..., :1], 3, axis=-1)
    return raw[..., :3].astype(np.float32) / 255.0
