"""The port's data path against the JAX package on the CPU: file readers
and writers, KITTI calibration, the training transforms, the datasets
(``getitem_seeded``) and the loader's epochs.

Tolerances and why:
  * readers, calibration, crops, intrinsics, poses, ``pad_mask``, order:
    exact (the same numpy arithmetic, or integers);
  * ``color_jitter`` 1e-6 against the JAX package's numpy path
    (``use_native=False``; the same f32 arithmetic) and 3e-5 against its
    default, the native C++ kernel, which tests/test_visualization_native.py
    pins to the numpy path at 3e-5;
  * datasets and loader batches: images within 3e-5 / min(std) = 1.4e-4
    after normalisation, where the JAX side's colour jitter runs natively;
    everything else exact.  The JAX side of these comparisons reads PNGs
    and resizes with the native library (the port matches the native
    align-corners resize, not Pillow's), so the tests assert it is built.
"""
import json
import os
import signal

import numpy as np
import pytest
from PIL import Image

from temporalstereo_tpu.config import get_cfg as jax_get_cfg
from temporalstereo_tpu.data import calibration as jax_calibration
from temporalstereo_tpu.data import formats as jax_formats
from temporalstereo_tpu.data import native
from temporalstereo_tpu.data import transforms as jax_transforms
from temporalstereo_tpu.data.datasets.builder import (
    build_stereo_dataset as jax_build_stereo_dataset)
from temporalstereo_tpu.data.loader import DataLoader as JaxDataLoader

from temporalstereo_tpu_torch.config import get_cfg
from temporalstereo_tpu_torch.data import (DataLoader, build_dataloader,
                                           build_stereo_dataset, calibration,
                                           formats, transforms)
from temporalstereo_tpu_torch.data.png import write_png
from temporalstereo_tpu_torch.data.synthetic import write_kitti2015_split

TOL = 1e-6
NATIVE_TOL = 3e-5
IMAGE_TOL = NATIVE_TOL / 0.225          # / min(std): 1.4e-4 normalised
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KITTI = os.path.join(REPO, "configs", "kitti2015-multi.yaml")
H, W = 30, 44                           # stored frames
CROP_H, CROP_W, EVAL_H, EVAL_W = 16, 24, 24, 40


# ------------------------------------------------------------ readers ----

@pytest.mark.parametrize("shape", [(9, 13), (9, 13, 3)], ids=["gray", "rgb"])
def test_pfm_written_by_each_read_by_both(shape, tmp_path):
    data = np.random.RandomState(1).randn(*shape).astype(np.float32)
    for name, write in (("ours", formats.write_pfm),
                        ("jax", jax_formats.write_pfm)):
        path = str(tmp_path / f"{name}.pfm")
        write(path, data, scale=2.0)
        np.testing.assert_array_equal(formats.load_pfm(path)[0], data)
        np.testing.assert_array_equal(jax_formats.load_pfm(path)[0], data)
    assert (tmp_path / "ours.pfm").read_bytes() == (
        tmp_path / "jax.pfm").read_bytes()


def test_flow_files_against_jax(tmp_path):
    rng = np.random.RandomState(2)
    flow = rng.randn(7, 11, 2).astype(np.float32) * 20
    formats.write_flo(str(tmp_path / "ours.flo"), flow)
    jax_formats.write_flo(str(tmp_path / "jax.flo"), flow)
    assert (tmp_path / "ours.flo").read_bytes() == (
        tmp_path / "jax.flo").read_bytes()
    np.testing.assert_array_equal(formats.load_flo(str(tmp_path / "jax.flo")),
                                  flow)
    # KITTI flow: 16-bit RGB, (value - 2^15) / 64 and a valid channel
    raw = np.stack([rng.randint(0, 65536, (7, 11)), rng.randint(0, 65536,
                                                               (7, 11)),
                    rng.randint(0, 2, (7, 11))], -1).astype(np.uint16)
    path = str(tmp_path / "flow.png")
    write_png(path, raw, filter_type=4)
    assert native.available()
    ours, theirs = formats.load_kitti_flow(path), \
        jax_formats.load_kitti_flow(path)
    np.testing.assert_array_equal(ours[0], theirs[0])
    np.testing.assert_array_equal(ours[1], theirs[1])
    assert ours[1].sum() == (raw[..., 2] > 0).sum()


def test_depth_and_camera_readers_against_jax(tmp_path):
    rng = np.random.RandomState(3)
    depth16 = rng.randint(0, 65536, (6, 8)).astype(np.uint16)
    Image.fromarray(depth16).save(tmp_path / "d.png")
    path = str(tmp_path / "d.png")
    for ours, theirs in ((formats.load_kitti_depth,
                          jax_formats.load_kitti_depth),
                         (formats.load_vkitti_depth,
                          jax_formats.load_vkitti_depth)):
        np.testing.assert_array_equal(ours(path), theirs(path))
    np.save(tmp_path / "d.npy", rng.rand(6, 8) * 5000)
    np.testing.assert_array_equal(
        formats.load_npy_depth(str(tmp_path / "d.npy")),
        jax_formats.load_npy_depth(str(tmp_path / "d.npy")))
    disp = rng.uniform(-1, 100, (6, 8)).astype(np.float32)
    np.testing.assert_array_equal(formats.sceneflow_disp_to_depth(disp),
                                  jax_formats.sceneflow_disp_to_depth(disp))
    lines = []
    for frame in (6, 7):
        lines.append(f"Frame {frame}")
        for side in "LR":
            lines.append(side + " " + " ".join(
                f"{v:.7f}" for v in rng.randn(16)))
        lines.append("")
    (tmp_path / "camera_data.txt").write_text("\n".join(lines))
    ours = formats.load_sceneflow_camera_data(str(tmp_path /
                                                  "camera_data.txt"))
    theirs = jax_formats.load_sceneflow_camera_data(str(tmp_path /
                                                        "camera_data.txt"))
    assert ours.keys() == theirs.keys() == {6, 7}
    for f in ours:
        for side in ("l", "r"):
            for a, b in zip(ours[f][side], theirs[f][side]):
                np.testing.assert_array_equal(a, b)


def test_non_png_images_read_with_pillow(tmp_path):
    rng = np.random.RandomState(4)
    img = (rng.rand(10, 14, 3) * 255).astype(np.uint8)
    for name in ("a.jpg", "b.bmp"):
        Image.fromarray(img).save(tmp_path / name)
        path = str(tmp_path / name)
        np.testing.assert_array_equal(formats.load_image(path),
                                      jax_formats.load_image(path))


# -------------------------------------------------------- calibration ----

def test_calibration_against_jax(tmp_path):
    rng = np.random.RandomState(5)
    text = ("calib_time: 09-Jan-2012 13:57:47\n"
            "P_rect_02: 7.215377e+02 0 6.095593e+02 4.485728e+01 0 "
            "7.215377e+02 1.728540e+02 2.163791e-01 0 0 1 2.745884e-03\n"
            "S_rect_02: 1.242e+03 3.75e+02\n"
            "R_rect_00: " + " ".join(f"{v:.6f}" for v in np.eye(3).ravel()
                                     + rng.randn(9) * 0.01) + "\n"
            "Tr_velo_to_cam: " + " ".join(f"{v:.6f}" for v in rng.randn(12))
            + "\n")
    path = str(tmp_path / "calib.txt")
    with open(path, "w") as fp:
        fp.write(text)
    ours, theirs = calibration.read_calib_file(path), \
        jax_calibration.read_calib_file(path)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])
    p, q = calibration.Projection(ours), jax_calibration.Projection(theirs)
    pts = rng.uniform(-10, 10, (50, 3)) + [0, 0, 20]
    depth = rng.uniform(0, 30, (12, 16)) * (rng.rand(12, 16) < 0.5)
    image = rng.rand(12, 16, 3)
    for name, args in (("velo_to_rect", (pts,)), ("rect_to_velo", (pts,)),
                       ("rect_to_image", (pts,)), ("velo_to_image", (pts,)),
                       ("depth_to_velo", (depth,)),
                       ("velo_to_depth_map", (pts, (12, 16))),
                       ("depth_to_disparity", (depth, 0.54)),
                       ("disparity_to_depth", (depth, 0.54))):
        np.testing.assert_array_equal(getattr(p, name)(*args),
                                      getattr(q, name)(*args), err_msg=name)
    for a, b in zip(p.depth_to_rect(depth, image), q.depth_to_rect(depth,
                                                                   image)):
        np.testing.assert_array_equal(a, b)
    assert p.tx == q.tx


# --------------------------------------------------------- transforms ----

def test_color_jitter_against_jax():
    """The same RandomState: the numpy paths at 1e-6, the native kernel at
    3e-5; the generator ends in the same state."""
    img = np.random.RandomState(6).rand(20, 30, 3).astype(np.float32)
    assert native.available()
    for seed in range(8):
        ours_rng, np_rng, nat_rng = (np.random.RandomState(seed)
                                     for _ in range(3))
        ours = transforms.color_jitter(img, ours_rng)
        np.testing.assert_allclose(
            ours, jax_transforms.color_jitter(img, np_rng, use_native=False),
            rtol=0, atol=TOL)
        np.testing.assert_allclose(
            ours, jax_transforms.color_jitter(img, nat_rng), rtol=0,
            atol=NATIVE_TOL)
        assert ours_rng.rand() == np_rng.rand() == nat_rng.rand()


def test_crop_occlusion_and_intrinsics_against_jax():
    img = np.random.RandomState(7).rand(40, 60, 3).astype(np.float32)
    K = np.array([[50.0, 0, 30], [0, 50.0, 20], [0, 0, 1]])
    for seed in range(6):
        a, b = np.random.RandomState(seed), np.random.RandomState(seed)
        y, x = transforms.random_crop_params(a, 40, 60, 16, 24)
        assert (y, x) == jax_transforms.random_crop_params(b, 40, 60, 16, 24)
        np.testing.assert_array_equal(transforms.crop(img, y, x, 16, 24),
                                      jax_transforms.crop(img, y, x, 16, 24))
        np.testing.assert_array_equal(
            transforms.right_occlusion_aug(img, a, patch_h=(5, 20),
                                           patch_w=(5, 30)),
            jax_transforms.right_occlusion_aug(img, b, patch_h=(5, 20),
                                               patch_w=(5, 30)))
        np.testing.assert_array_equal(
            transforms.crop_intrinsics(K, y, x),
            jax_transforms.crop_intrinsics(K, y, x))
    np.testing.assert_array_equal(transforms.scale_intrinsics(K, 0.5, 2.0),
                                  jax_transforms.scale_intrinsics(K, 0.5,
                                                                  2.0))


# ----------------------------------------------------------- datasets ----

def _image(path, rng, h=H, w=W):
    write_png(str(path), rng.randint(0, 256, (h, w, 3)).astype(np.uint8))


def _sceneflow(root, rng, n=3):
    lines = []
    for frame in range(4):
        lines.append(f"Frame {frame}")
        for side in "LR":
            T = np.eye(4)
            T[:3, 3] = rng.randn(3)
            lines.append(side + " " + " ".join(f"{v:.6f}" for v in T.ravel()))
    (root / "camera_data.txt").write_text("\n".join(lines) + "\n")
    items = []
    for s in range(n):
        item = {"extrinsic_path": "camera_data.txt"}
        for f in (-1, 0):
            cur = {}
            for side in ("left", "right"):
                _image(root / f"{side}_{s}_{f + 2:04d}.png", rng)
                cur[f"{side}_image_path"] = f"{side}_{s}_{f + 2:04d}.png"
                disp = rng.uniform(-5, 60, (H, W)).astype(np.float32)
                disp[0, :3] = np.nan
                formats.write_pfm(str(root / f"{side}_{s}_{f}.pfm"), disp)
                cur[f"{side}_disp_path"] = f"{side}_{s}_{f}.pfm"
            item[str(f)] = cur
        items.append(item)
    return items


def _tartanair(root, rng):
    rows = []
    for f in range(3):
        q = rng.randn(4)
        rows.append(" ".join(f"{v:.6f}" for v in (*rng.randn(3), *q)))
    (root / "pose_left.txt").write_text("\n".join(rows) + "\n")
    item = {"extrinsic_path": "pose_left.txt"}
    for f in (-1, 0):
        _image(root / f"{f + 1:06d}_left.png", rng)
        _image(root / f"{f + 1:06d}_right.png", rng)
        np.save(root / f"{f + 1:06d}_depth.npy",
                rng.uniform(0.5, 50, (H, W)).astype(np.float32))
        item[str(f)] = {"left_image_path": f"{f + 1:06d}_left.png",
                        "right_image_path": f"{f + 1:06d}_right.png",
                        "left_depth_path": f"{f + 1:06d}_depth.npy"}
    return [item]


def _vkitti(root, rng):
    rows = ["frame cameraID r1,1 r1,2 r1,3 t1 r2,1 r2,2 r2,3 t2 r3,1 r3,2 "
            "r3,3 t3 0 0 0 1"]
    for f in range(3):
        for cam in (0, 1):
            T = np.eye(4)
            T[:3, 3] = rng.randn(3) + cam
            rows.append(f"{f} {cam} " + " ".join(f"{v:.6f}"
                                                 for v in T.ravel()))
    (root / "extrinsic.txt").write_text("\n".join(rows) + "\n")
    item = {"extrinsic_path": "extrinsic.txt"}
    for f in (-1, 0):
        _image(root / f"rgb_{f + 1:05d}_l.png", rng)
        _image(root / f"rgb_{f + 1:05d}_r.png", rng)
        write_png(str(root / f"depth_{f + 1:05d}.png"),
                  rng.randint(100, 60000, (H, W)).astype(np.uint16))
        item[str(f)] = {"left_image_path": f"rgb_{f + 1:05d}_l.png",
                        "right_image_path": f"rgb_{f + 1:05d}_r.png",
                        "left_depth_path": f"depth_{f + 1:05d}.png",
                        "right_depth_path": f"depth_{f + 1:05d}.png"}
    return [item]


def _eth3d(root, rng):
    (root / "cameras.txt").write_text(
        "# Camera list\n0 PINHOLE 44 30 40.5 41.5 21.0 14.5\n")
    disp = rng.uniform(0, 20, (H, W)).astype(np.float32)
    disp[2, :5] = np.inf
    formats.write_pfm(str(root / "disp0GT.pfm"), disp)
    _image(root / "im0.png", rng)
    _image(root / "im1.png", rng)
    return [{"intrinsic_path": "cameras.txt", "0": {
        "left_image_path": "im0.png", "right_image_path": "im1.png",
        "left_disp_path": "disp0GT.pfm"}}]


def _drivingstereo(root, rng):
    _image(root / "left.png", rng)
    _image(root / "right.png", rng)
    formats.write_kitti_disp(str(root / "disp.png"),
                             rng.uniform(0, 80, (H, W)) * (rng.rand(H, W)
                                                           < 0.4))
    return [{"0": {"left_image_path": "left.png",
                   "right_image_path": "right.png",
                   "left_disp_path": "disp.png"}}]


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    """One synthetic split per dataset type: (root, annfile, frames)."""
    rng = np.random.RandomState(8)
    out = {}
    for kind, make, frames in (("SceneFlow", _sceneflow, [-1, 0]),
                               ("TartanAir", _tartanair, [-1, 0]),
                               ("VKITTI2", _vkitti, [-1, 0]),
                               ("ETH3D", _eth3d, [0]),
                               ("DrivingStereo", _drivingstereo, [0])):
        root = tmp_path_factory.mktemp(kind)
        (root / "split.json").write_text(json.dumps(make(root, rng)))
        out[kind] = (str(root), str(root / "split.json"), frames)
    root = tmp_path_factory.mktemp("KITTI2015")
    out["KITTI2015"] = (str(root), write_kitti2015_split(
        str(root), 3, [-1, 0], H, W, seed=9, filter_type=4), [-1, 0])
    return out


def _opts(kind, root, annfile, frames, node, h, w, extra=()):
    return ["MODEL.BACKBONE.VARIANT", "tiny",
            f"DATA.{node}.TYPE", kind, f"DATA.{node}.DATA_ROOT", root,
            f"DATA.{node}.ANNFILE", annfile, f"DATA.{node}.HEIGHT", str(h),
            f"DATA.{node}.WIDTH", str(w), f"DATA.{node}.FRAME_IDXS",
            str(frames), *extra]


def _datasets(splits, kind, phase, extra=()):
    assert native.available()
    node = {"train": "TRAIN", "val": "VAL"}[phase]
    h, w = (CROP_H, CROP_W) if phase == "train" else (EVAL_H, EVAL_W)
    opts = _opts(kind, *splits[kind], node, h, w, extra)
    return (build_stereo_dataset(get_cfg(KITTI, opts).DATA[node], phase),
            jax_build_stereo_dataset(jax_get_cfg(KITTI, opts).DATA[node],
                                     phase))


def _same_sample(ours, theirs):
    assert ours.keys() == theirs.keys()
    for k, v in theirs.items():
        tol = IMAGE_TOL if k in ("left", "right") else 0
        assert ours[k].shape == v.shape and ours[k].dtype == v.dtype, k
        np.testing.assert_allclose(ours[k], v, rtol=0, atol=tol, err_msg=k)


@pytest.mark.parametrize("phase", ["train", "val"])
@pytest.mark.parametrize("kind", ["SceneFlow", "KITTI2015"])
@pytest.mark.parametrize("same_lr", [True, False])
def test_dataset_samples_match_jax(kind, phase, same_lr, splits):
    """Every sample, a few seeds each: the crop, the jitter (both
    DO_SAME_LR_TRANSFORM choices), the occlusion patch, the eval resize
    with the ground truth at its own size, K, poses and baseline."""
    ours, theirs = _datasets(splits, kind, phase, [
        f"DATA.{'TRAIN' if phase == 'train' else 'VAL'}.DO_SAME_LR_TRANSFORM",
        str(same_lr)])
    assert len(ours) == len(theirs) > 0
    for idx in range(len(ours)):
        for seed in (idx, 1000 + idx, 77 * idx + 5):
            a, b = ours.getitem_seeded(idx, seed), theirs.getitem_seeded(
                idx, seed)
            _same_sample(a, b)
    sample = ours.getitem_seeded(0, 0)
    if phase == "val":
        assert sample["left"].shape[1:3] == (EVAL_H, EVAL_W)
        assert sample["disp_gt"].shape[1:3] == (H, W)
    if kind == "KITTI2015":
        assert "disp_gt_right" in sample
        assert not np.allclose(sample["T_cam"][0], sample["T_cam"][1])


@pytest.mark.parametrize("kind", ["TartanAir", "VKITTI2", "ETH3D",
                                  "DrivingStereo"])
def test_other_dataset_types_match_jax(kind, splits):
    ours, theirs = _datasets(splits, kind, "train")
    _same_sample(ours.getitem_seeded(0, 3), theirs.getitem_seeded(0, 3))
    ours, theirs = _datasets(splits, kind, "val")
    _same_sample(ours.getitem_seeded(0, 3), theirs.getitem_seeded(0, 3))


# ------------------------------------------------------------- loader ----

def _loaders(splits, shards, shard, batch, shuffle, drop_last):
    ours, theirs = _datasets(splits, "SceneFlow", "train")
    kw = dict(batch_size=batch, shuffle=shuffle, drop_last=drop_last,
              num_workers=2, num_shards=shards, shard_index=shard,
              use_processes=False)
    return DataLoader(ours, **kw), JaxDataLoader(theirs, **kw)


@pytest.mark.parametrize("shards,shard", [(1, 0), (3, 1), (5, 4)],
                         ids=["one_shard", "three_shards", "empty_shard"])
def test_loader_epochs_match_jax(shards, shard, splits):
    """Two epochs: the shuffle, strided shards wrap-padded to one length
    (shard 4 of 5 over 3 samples is empty and pads from the whole list),
    per-sample seeds, ``pad_mask``, time-major collation; then an eval
    loader that keeps the last partial batch."""
    for shuffle, drop_last, batch in ((True, True, 1), (False, False, 2)):
        ours, theirs = _loaders(splits, shards, shard, batch, shuffle,
                                drop_last)
        assert len(ours) == len(theirs)
        for _ in range(2):
            got, want = list(ours), list(theirs)
            assert len(got) == len(want) > 0
            for a, b in zip(got, want):
                _same_sample(a, b)
                assert a["left"].shape[:2] == (2, len(a["pad_mask"]))
        if shards == 5:
            assert got[0]["pad_mask"].tolist() == [0.0]


def test_loader_threads_and_processes_give_the_same_batches(splits):
    """The KITTI val loader (eval transform, both views' ground truth) with
    forkserver workers against threads; the pool's wait is bounded so that
    a hung worker fails the test instead of the suite."""
    opts = _opts("KITTI2015", *splits["KITTI2015"], "VAL", EVAL_H, EVAL_W,
                 ["DATA.VAL.BATCH_SIZE", "2", "DATA.VAL.NUM_WORKERS", "2"])
    batches = {}

    def timeout(signum, frame):
        raise TimeoutError("the process pool did not deliver in 120 s")
    previous = signal.signal(signal.SIGALRM, timeout)
    try:
        for processes in (False, True):
            cfg = get_cfg(KITTI, opts + ["DATA.VAL.PROCESS_WORKERS",
                                         str(processes)])
            loader = build_dataloader(cfg.DATA.VAL, "val")
            assert loader.use_processes == processes
            signal.alarm(120)
            try:
                batches[processes] = list(loader)
            finally:
                signal.alarm(0)
                loader.close()
    finally:
        signal.signal(signal.SIGALRM, previous)
    assert [len(b["pad_mask"]) for b in batches[False]] == [2, 1]
    for a, b in zip(batches[False], batches[True]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
