"""Stereo-video dataset base: an annfile index -> time-major numpy samples.

Counterpart of the JAX package's ``data/datasets/base.py``
(``StereoDataset``).  The annfile is the reference's JSON split: a list of
items, ``item[str(frame_idx)] = {left_image_path, right_image_path,
left_disp_path, ...}``, ``item["extrinsic_path"]`` and an optional
``item["intrinsic_path"]``.

A sample (numpy, time-major; ``data/loader.py:collate`` batches it):
  left / right   [T, H, W, 3] normalised f32
  disp_gt        [T, h, w, 1] (0 where there is none)
  disp_gt_right  [T, h, w, 1] (only when the split has it)
  T_cam / inv_T  [T, 4, 4] world->cam of the left camera and its inverse
  K              [3, 3] intrinsics at the processed resolution
  baseline       scalar
Training crops everything to (HEIGHT, WIDTH); evaluation resizes only the
images, and the ground truth keeps its native resolution (h, w).

Nothing here imports or touches the card: loader workers build samples.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .. import transforms as T
from ..formats import load_image


class StereoDataset:
    """Base dataset; subclasses provide the format-specific loaders."""

    # intrinsics normalised by the image size (rows / w, / h)
    norm_K: np.ndarray = np.eye(3, dtype=np.float64)
    full_resolution: Tuple[int, int] = (540, 960)
    baseline: float = 1.0
    with_depth_gt = False
    with_disp_gt = True
    with_pose_gt = True

    def __init__(self, annfile: str, root: str, height: int, width: int,
                 frame_idxs: Sequence[int], is_train: bool = False,
                 use_common_intrinsics: bool = False,
                 do_same_lr_transform: bool = True,
                 mean=T.IMAGENET_MEAN, std=T.IMAGENET_STD, seed: int = 43):
        self.root = root
        self.annfile = annfile
        self.height = height
        self.width = width
        self.frame_idxs = sorted(frame_idxs)
        self.is_train = is_train
        self.use_common_intrinsics = use_common_intrinsics
        self.do_same_lr_transform = do_same_lr_transform
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.rng = np.random.RandomState(seed)
        self.data_list = self._load_annfile()

    def _load_annfile(self) -> List[Dict]:
        with open(self.annfile, "r") as fp:
            return list(json.load(fp))

    def __len__(self) -> int:
        return len(self.data_list)

    # ------------------------------------------------ subclass interface --
    def image_loader(self, path: str) -> np.ndarray:
        return load_image(os.path.join(self.root, path))

    def disp_loader(self, path: str, full_K=None) -> np.ndarray:
        raise NotImplementedError

    def depth_loader(self, path: str, full_K=None) -> np.ndarray:
        raise NotImplementedError

    def extrinsic_loader(self, path: str):
        """The pose data that ``get_extrinsic`` reads."""
        raise NotImplementedError

    def get_extrinsic(self, extrinsics, image_path: str) -> np.ndarray:
        """-> [4, 4] world->cam of this frame's left camera."""
        raise NotImplementedError

    def intrinsic_loader(self, intrinsic_path: str):
        """-> (norm_K [3, 3] rows / w, / h, full_K [3, 3], (h, w))."""
        h, w = self.full_resolution
        full_K = self.norm_K.copy()
        full_K[0, :] *= w
        full_K[1, :] *= h
        return self.norm_K.copy(), full_K, self.full_resolution

    def depth_to_disp(self, depth: np.ndarray, full_K: np.ndarray
                      ) -> np.ndarray:
        focal = full_K[0, 0]
        return np.where(depth > 1e-6,
                        self.baseline * focal / np.maximum(depth, 1e-6),
                        0.0).astype(np.float32)

    # ------------------------------------------------------------ sample --
    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return self._get(idx, self.rng)

    def getitem_seeded(self, idx: int, seed: int) -> Dict[str, np.ndarray]:
        """The sample with its augmentation drawn from a fresh
        ``RandomState(seed)``: a pure function of (idx, seed), whatever
        worker or thread builds it."""
        return self._get(idx, np.random.RandomState(seed & 0x7FFFFFFF))

    def _get(self, idx: int, rng: np.random.RandomState
             ) -> Dict[str, np.ndarray]:
        item = self.data_list[idx]
        norm_K, full_K, _ = self.intrinsic_loader(
            item["intrinsic_path"] if "intrinsic_path" in item
            else item["0"]["left_image_path"])

        extrinsics = None
        if self.with_pose_gt and "extrinsic_path" in item:
            extrinsics = self.extrinsic_loader(item["extrinsic_path"])

        lefts, rights, disps, disps_r, poses = [], [], [], [], []
        has_right_disp = False
        for frame_idx in self.frame_idxs:
            cur = item[str(frame_idx)]
            lefts.append(self.image_loader(cur["left_image_path"]))
            rights.append(self.image_loader(cur["right_image_path"]))

            disp = disp_r = None
            if self.with_disp_gt and "left_disp_path" in cur:
                disp = self.disp_loader(cur["left_disp_path"], full_K)
            elif self.with_depth_gt and "left_depth_path" in cur:
                disp = self.depth_to_disp(
                    self.depth_loader(cur["left_depth_path"], full_K), full_K)
            if self.with_disp_gt and "right_disp_path" in cur:
                disp_r = self.disp_loader(cur["right_disp_path"], full_K)
                has_right_disp = True
            elif self.with_depth_gt and "right_depth_path" in cur:
                disp_r = self.depth_to_disp(
                    self.depth_loader(cur["right_depth_path"], full_K),
                    full_K)
                has_right_disp = True
            h, w = lefts[-1].shape[:2]
            disps.append(disp if disp is not None
                         else np.zeros((h, w), np.float32))
            disps_r.append(disp_r if disp_r is not None
                           else np.zeros((h, w), np.float32))
            poses.append(np.eye(4, dtype=np.float32) if extrinsics is None
                         else self.get_extrinsic(extrinsics,
                                                 cur["left_image_path"]))

        sample = self._transform(lefts, rights, disps,
                                 disps_r if has_right_disp else None,
                                 norm_K, rng)
        T_cam = np.stack(poses).astype(np.float32)
        sample["T_cam"] = T_cam
        sample["inv_T"] = np.linalg.inv(T_cam).astype(np.float32)
        sample["baseline"] = np.float32(self.baseline)
        return sample

    # --------------------------------------------------------- transform --
    def _transform(self, lefts, rights, disps, disps_r, norm_K, rng):
        ih, iw = lefts[0].shape[:2]
        th, tw = self.height, self.width
        K = norm_K.copy().astype(np.float64)
        K[0, :] *= iw
        K[1, :] *= ih

        if self.is_train:
            # random crop; K moves with the crop
            y, x = T.random_crop_params(rng, ih, iw, th, tw)
            lefts = [T.crop(a, y, x, th, tw) for a in lefts]
            rights = [T.crop(a, y, x, th, tw) for a in rights]
            disps = [T.crop(a, y, x, th, tw) for a in disps]
            if disps_r is not None:
                disps_r = [T.crop(a, y, x, th, tw) for a in disps_r]
            K = T.crop_intrinsics(K, y, x)

            # photometric augmentation with probability 0.5
            if rng.rand() < 0.5:
                if self.do_same_lr_transform:
                    seed = rng.randint(0, 2 ** 31)
                    lefts = [T.color_jitter(a, np.random.RandomState(seed))
                             for a in lefts]
                    rights = [T.color_jitter(a, np.random.RandomState(seed))
                              for a in rights]
                else:
                    lefts = [T.color_jitter(a, rng) for a in lefts]
                    rights = [T.color_jitter(a, rng) for a in rights]
            rights = [T.right_occlusion_aug(a, rng) for a in rights]
        elif (ih, iw) != (th, tw):
            # evaluation: only the images are resized; the ground truth
            # keeps its native resolution and the metrics resize the
            # estimate to it
            lefts = [T.resize_image(a, (th, tw)) for a in lefts]
            rights = [T.resize_image(a, (th, tw)) for a in rights]
            K = T.scale_intrinsics(K, tw / iw, th / ih)

        sample = {
            "left": np.stack([T.normalize(a, self.mean, self.std)
                              for a in lefts]),
            "right": np.stack([T.normalize(a, self.mean, self.std)
                               for a in rights]),
            "disp_gt": np.stack(disps)[..., None].astype(np.float32),
            "K": K.astype(np.float32),
        }
        if disps_r is not None:
            sample["disp_gt_right"] = np.stack(disps_r)[..., None].astype(
                np.float32)
        return sample
