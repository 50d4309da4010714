"""Generate annfile split JSONs from raw dataset directory layouts.

The port's own copy of the JAX package's ``cli/make_splits.py`` (pure
Python; the JSON it writes is byte for byte the JAX CLI's).

The reference consumes ``./splits/<dataset>/{train,test}.json`` annfiles
(configs/*.yaml DATA.*.ANNFILE) but ships no generator — the splits are a
separate download.  This CLI scans the standard on-disk layouts and emits
annfiles in the exact schema ``data/datasets/base.py`` (and the reference's
StereoDatasetBase, base.py:189-300) consumes:

  item[str(frame_idx)] = {left_image_path, right_image_path,
                          left_disp_path?, right_disp_path?}
  item["extrinsic_path"]  (optional pose file per scene)
  item["intrinsic_path"]  (optional per-scene calib)

Usage:
  python -m temporalstereo_tpu_torch.cli.make_splits sceneflow \
      --data-root /data/FlyingThings3D --split TRAIN \
      --frame-idxs -1 0 --output splits/flyingthings3d/train.json
  python -m temporalstereo_tpu_torch.cli.make_splits kitti2015 \
      --data-root /data/kitti2015 --split training \
      --frame-idxs -10..0 --output splits/kitti2015/train.json
  python -m temporalstereo_tpu_torch.cli.make_splits sequence \
      --left-dir seq/left --right-dir seq/right --disp-dir seq/disp \
      --pose-file seq/pose_left.txt --frame-idxs -1 0 --output seq.json
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".webp")


def _parse_frame_idxs(tokens: List[str]) -> List[int]:
    """Accepts '-1 0' style lists or a single 'A..B' range."""
    if len(tokens) == 1 and ".." in tokens[0]:
        a, b = tokens[0].split("..")
        return list(range(int(a), int(b) + 1))
    return [int(t) for t in tokens]


def _rel(path: str, root: str) -> str:
    return os.path.relpath(path, root)


# ------------------------------------------------------------- SceneFlow --

def scan_sceneflow(root: str, split: str, frame_idxs: List[int],
                   pass_name: str = "frames_cleanpass") -> List[Dict]:
    """FlyingThings3D layout: <pass>/<SPLIT>/<A|B|C>/<scene>/<left|right>/
    <NNNN>.png with disparity/<SPLIT>/.../<NNNN>.pfm; windows are consecutive
    frames within one scene."""
    items = []
    base = os.path.join(root, pass_name, split)
    for sub in sorted(os.listdir(base)) if os.path.isdir(base) else []:
        for scene in sorted(os.listdir(os.path.join(base, sub))):
            left_dir = os.path.join(base, sub, scene, "left")
            if not os.path.isdir(left_dir):
                continue
            frames = sorted(
                f for f in os.listdir(left_dir)
                if f.lower().endswith(IMAGE_EXTS))
            nums = [os.path.splitext(f)[0] for f in frames]
            lo = -min(frame_idxs)
            for i in range(lo, len(frames)):
                item: Dict = {}
                for fi in frame_idxs:
                    n = nums[i + fi]
                    ext = os.path.splitext(frames[i + fi])[1]
                    entry = {
                        "left_image_path": _rel(os.path.join(
                            base, sub, scene, "left", n + ext), root),
                        "right_image_path": _rel(os.path.join(
                            base, sub, scene, "right", n + ext), root),
                    }
                    disp = os.path.join(root, "disparity", split, sub, scene,
                                        "left", n + ".pfm")
                    if os.path.exists(disp):
                        entry["left_disp_path"] = _rel(disp, root)
                    disp_r = os.path.join(root, "disparity", split, sub,
                                          scene, "right", n + ".pfm")
                    if os.path.exists(disp_r):
                        entry["right_disp_path"] = _rel(disp_r, root)
                    item[str(fi)] = entry
                cam = os.path.join(root, "camera_data", split, sub, scene,
                                   "camera_data.txt")
                if os.path.exists(cam):
                    item["extrinsic_path"] = _rel(cam, root)
                items.append(item)
    return items


# ------------------------------------------------------------- KITTI2015 --

def scan_kitti2015(root: str, split: str, frame_idxs: List[int]
                   ) -> List[Dict]:
    """KITTI2015 layout: <split>/image_2/<NNNNNN>_<FF>.png (multiview frames
    FF=00..20, GT at FF=10), image_3 right, disp_occ_0 GT, optional
    poses/<NNNNNN>.txt and calib_cam_to_cam/<NNNNNN>.txt."""
    img2 = os.path.join(root, split, "image_2")
    sample_ids = sorted({f.split("_")[0] for f in os.listdir(img2)
                         if f.endswith("_10.png")})
    items = []
    for sid in sample_ids:
        item: Dict = {}
        ok = True
        for fi in frame_idxs:
            ff = 10 + fi
            name = f"{sid}_{ff:02d}.png"
            lp = os.path.join(root, split, "image_2", name)
            rp = os.path.join(root, split, "image_3", name)
            if not (os.path.exists(lp) and os.path.exists(rp)):
                ok = False
                break
            entry = {"left_image_path": _rel(lp, root),
                     "right_image_path": _rel(rp, root)}
            if ff == 10:
                for gt_dir, key in (("disp_occ_0", "left_disp_path"),
                                    ("disp_occ_1", "right_disp_path")):
                    gt = os.path.join(root, split, gt_dir, name)
                    if os.path.exists(gt):
                        entry[key] = _rel(gt, root)
            item[str(fi)] = entry
        if not ok:
            continue
        pose = os.path.join(root, split, "poses", f"{sid}.txt")
        if os.path.exists(pose):
            item["extrinsic_path"] = _rel(pose, root)
        calib = os.path.join(root, split, "calib_cam_to_cam", f"{sid}.txt")
        if os.path.exists(calib):
            item["intrinsic_path"] = _rel(calib, root)
        items.append(item)
    return items


# -------------------------------------------------------------- sequence --

def scan_sequence(left_dir: str, right_dir: str,
                  disp_dir: Optional[str], pose_file: Optional[str],
                  frame_idxs: List[int], root: Optional[str] = None
                  ) -> List[Dict]:
    """Generic stereo video: parallel left/right (and optional disparity)
    directories with sorted matching filenames — the video_inference /
    KITTIRAW layout."""
    root = root or os.path.dirname(os.path.abspath(left_dir.rstrip("/")))
    frames = sorted(f for f in os.listdir(left_dir)
                    if f.lower().endswith(IMAGE_EXTS))
    items = []
    lo = -min(frame_idxs)
    for i in range(lo, len(frames)):
        item: Dict = {}
        for fi in frame_idxs:
            f = frames[i + fi]
            entry = {
                "left_image_path": _rel(os.path.join(left_dir, f), root),
                "right_image_path": _rel(os.path.join(right_dir, f), root),
            }
            if disp_dir:
                stem = os.path.splitext(f)[0]
                for ext in (".png", ".pfm", ".npy"):
                    d = os.path.join(disp_dir, stem + ext)
                    if os.path.exists(d):
                        entry["left_disp_path"] = _rel(d, root)
                        break
            item[str(fi)] = entry
        if pose_file:
            item["extrinsic_path"] = _rel(pose_file, root)
        items.append(item)
    return items


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="dataset", required=True)

    sf = sub.add_parser("sceneflow")
    sf.add_argument("--data-root", required=True)
    sf.add_argument("--split", default="TRAIN")
    sf.add_argument("--pass-name", default="frames_cleanpass")

    kt = sub.add_parser("kitti2015")
    kt.add_argument("--data-root", required=True)
    kt.add_argument("--split", default="training")

    sq = sub.add_parser("sequence")
    sq.add_argument("--left-dir", required=True)
    sq.add_argument("--right-dir", required=True)
    sq.add_argument("--disp-dir", default=None)
    sq.add_argument("--pose-file", default=None)
    sq.add_argument("--data-root", default=None)

    for s in (sf, kt, sq):
        s.add_argument("--frame-idxs", nargs="+", default=["0"])
        s.add_argument("--output", required=True)

    args = p.parse_args(argv)
    frame_idxs = sorted(_parse_frame_idxs(args.frame_idxs))

    if args.dataset == "sceneflow":
        items = scan_sceneflow(args.data_root, args.split, frame_idxs,
                               args.pass_name)
    elif args.dataset == "kitti2015":
        items = scan_kitti2015(args.data_root, args.split, frame_idxs)
    else:
        items = scan_sequence(args.left_dir, args.right_dir, args.disp_dir,
                              args.pose_file, frame_idxs, args.data_root)

    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    with open(args.output, "w") as fp:
        json.dump(items, fp, indent=1)
    print(f"wrote {len(items)} items -> {args.output}")


if __name__ == "__main__":
    main()
