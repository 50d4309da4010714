"""A synthetic KITTI 2015 multiview split, for trying the evaluation path
without the dataset.

``write_kitti2015_split`` writes, under ``root``, what the KITTI2015
dataset reads: per sample and frame, left and right RGB PNGs
(``training/image_2|3/{sample:06d}_{10 + frame:02d}.png``, seeded noise),
for frame 0 a sparse uint16 disparity of each view
(``training/disp_occ_0|1/``: a disparity growing down the image, 30% of
the pixels valid, as a projected lidar scan), a calib file with
``P_rect_02`` and ``S_rect_02``, an ORB-SLAM3 pose file (cam-to-world
rows; the camera moves 0.5 m forward and 0.02 m sideways a frame) and the
annfile ``split.json``.
"""
from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np

from .formats import write_kitti_disp
from .png import write_png

FOCAL, CX, CY = 721.5377, 609.5593, 172.854


def write_kitti2015_split(root: str, samples: int, frame_idxs: Sequence[int],
                          h: int = 375, w: int = 1242, seed: int = 0,
                          filter_type: int = 2) -> str:
    """-> the annfile's path.  Images are written with PNG row filter
    ``filter_type`` (2 Up, the codec's default; real KITTI PNGs use Paeth,
    4)."""
    rng = np.random.RandomState(seed)
    for sub in ("image_2", "image_3", "disp_occ_0", "disp_occ_1",
                "calib_cam_to_cam", "poses"):
        os.makedirs(os.path.join(root, "training", sub), exist_ok=True)
    rows = np.arange(h, dtype=np.float32)[:, None]
    field = np.broadcast_to(5.0 + 60.0 * rows / h, (h, w))
    items = []
    for s in range(samples):
        calib = f"training/calib_cam_to_cam/{s:06d}.txt"
        with open(os.path.join(root, calib), "w") as fp:
            fp.write(f"S_rect_02: {w:.6e} {h:.6e}\n")
            fp.write(f"P_rect_02: {FOCAL:.6e} 0 {CX:.6e} 4.485728e+01 0 "
                     f"{FOCAL:.6e} {CY:.6e} 2.163791e-01 0 0 1 "
                     "2.745884e-03\n")
        poses = f"training/poses/{s:06d}.txt"
        with open(os.path.join(root, poses), "w") as fp:
            for k in range(21):
                c2w = np.eye(4)[:3]
                c2w[0, 3], c2w[2, 3] = -0.02 * k, 0.5 * k
                fp.write(" ".join(f"{v:.6e}" for v in c2w.ravel()) + "\n")
        item = {"extrinsic_path": poses, "intrinsic_path": calib}
        for f in frame_idxs:
            name = f"{s:06d}_{10 + f:02d}.png"
            cur = {}
            for view, key in (("image_2", "left_image_path"),
                              ("image_3", "right_image_path")):
                cur[key] = f"training/{view}/{name}"
                write_png(os.path.join(root, cur[key]),
                          rng.randint(0, 256, (h, w, 3)).astype(np.uint8),
                          filter_type)
            if f == 0:
                for view, key in (("disp_occ_0", "left_disp_path"),
                                  ("disp_occ_1", "right_disp_path")):
                    cur[key] = f"training/{view}/{name}"
                    write_kitti_disp(os.path.join(root, cur[key]),
                                     field * (rng.rand(h, w) < 0.3))
            item[str(f)] = cur
        items.append(item)
    annfile = os.path.join(root, "split.json")
    with open(annfile, "w") as fp:
        json.dump(items, fp)
    return annfile
