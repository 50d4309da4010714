"""The port's inference surface on the CPU: its PNG codec against Pillow,
its file readers, transforms and colour maps against the JAX package's
numpy functions, and ``python -m temporalstereo_tpu_torch.cli.video_inference``
end to end on the tiny model.

Tolerances: the codec bit-exact; readers, transforms and colour maps 1e-6
(float32 copies of the same arithmetic; the TartanAir quaternion and the
resize differ in rounding order only); the CLI's uint16 disparities within
1/256 px of the port's own ``streaming_step`` on the same frames (the
PNG's quantisation step).  tests/test_torch_model.py holds
``streaming_step`` to the JAX package.
"""
import functools
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
from scipy.spatial.transform import Rotation

from temporalstereo_tpu.data import formats as jax_formats
from temporalstereo_tpu.data import transforms as jax_transforms
from temporalstereo_tpu.ops.interpolate import (
    resize_bilinear as jax_resize_bilinear)
from temporalstereo_tpu.visualization import (
    disp_err_to_colorbar as jax_disp_err_to_colorbar)
from temporalstereo_tpu.visualization import colormap as jax_colormap
from temporalstereo_tpu.visualization import disp_to_color as jax_disp_to_color

from temporalstereo_tpu_torch.cli import video_inference
from temporalstereo_tpu_torch.config import get_cfg
from temporalstereo_tpu_torch.data import formats, transforms
from temporalstereo_tpu_torch.data.png import read_png, write_png
from temporalstereo_tpu_torch.models import (backbone_memory_shapes,
                                             build_model, init_prev_info,
                                             streaming_step)
from temporalstereo_tpu_torch.utils.fold_bn import fold_batch_norms
from temporalstereo_tpu_torch.visualization import (colormap,
                                                    disp_err_to_colorbar,
                                                    disp_to_color)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KITTI = os.path.join(REPO, "configs", "kitti2015-multi.yaml")
TOL = 1e-6
TINY = ["MODEL.BACKBONE.VARIANT", "tiny",
        "MODEL.AGGREGATION.COARSE.C", "8",
        "MODEL.AGGREGATION.FINE.C", "8",
        "MODEL.AGGREGATION.PRECISE.C", "8",
        "TRAINER.PRECISION", "f32"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny model's small ops cost more CPU spread over threads than
    on one, and the suite runs files side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _image(kind, rng, h=29, w=47):
    """Smooth ramps plus noise, so that Pillow's adaptive filtering picks
    several row filters."""
    shape, top = {"rgb8": ((h, w, 3), 256), "rgba8": ((h, w, 4), 256),
                  "gray8": ((h, w), 256), "gray16": ((h, w), 65536)}[kind]
    base = np.cumsum(rng.randint(0, 9, shape), axis=1)
    base = base * (1 if top == 256 else 211) + rng.randint(0, 40, shape)
    return (base % top).astype(np.uint8 if top == 256 else np.uint16)


@pytest.mark.parametrize("kind", ["rgb8", "rgba8", "gray8", "gray16"])
def test_png_codec_against_pil(kind, tmp_path):
    """Pillow writes (adaptive filters), the port reads; the port writes
    with each of the five filters, Pillow and the port read back."""
    img = _image(kind, np.random.RandomState(len(kind)))
    Image.fromarray(img).save(tmp_path / "pil.png")
    got = read_png(str(tmp_path / "pil.png"))
    assert got.dtype == img.dtype and np.array_equal(got, img)
    for f in range(5):
        path = str(tmp_path / f"ours{f}.png")
        write_png(path, img, filter_type=f)
        assert np.array_equal(np.asarray(Image.open(path)), img), f
        assert np.array_equal(read_png(path), img), f


def test_png_refuses_what_it_does_not_read(tmp_path):
    Image.fromarray(np.zeros((4, 5, 3), np.uint8)).convert("P").save(
        tmp_path / "p.png")
    with pytest.raises(ValueError, match="colour type 3"):
        read_png(str(tmp_path / "p.png"))


def test_image_and_kitti_disparity_against_jax(tmp_path):
    rng = np.random.RandomState(1)
    for kind in ("rgb8", "gray8"):
        Image.fromarray(_image(kind, rng)).save(tmp_path / f"{kind}.png")
        path = str(tmp_path / f"{kind}.png")
        np.testing.assert_array_equal(formats.load_image(path),
                                      jax_formats.load_image(path))
    disp = rng.uniform(0, 200, (23, 31)).astype(np.float32)
    jax_formats.write_kitti_disp(str(tmp_path / "jax.png"), disp)
    formats.write_kitti_disp(str(tmp_path / "ours.png"), disp)
    for name in ("jax.png", "ours.png"):
        path = str(tmp_path / name)
        np.testing.assert_array_equal(formats.load_disparity(path),
                                      jax_formats.load_disparity(path))
    np.testing.assert_array_equal(read_png(str(tmp_path / "ours.png")),
                                  np.asarray(Image.open(tmp_path / "jax.png")))


@pytest.mark.parametrize("shape", [(13, 17), (13, 17, 3)],
                         ids=["gray", "color"])
def test_pfm_against_jax(shape, tmp_path):
    data = np.random.RandomState(2).randn(*shape).astype(np.float32)
    path = str(tmp_path / "d.pfm")
    jax_formats.write_pfm(path, data, scale=2.0)
    ours, theirs = formats.load_pfm(path), jax_formats.load_pfm(path)
    np.testing.assert_array_equal(ours[0], theirs[0])
    # the scale as written (the JAX package's native decoder reports 1.0)
    assert ours[1] == 2.0
    np.testing.assert_array_equal(ours[0], data)


def test_pose_files_against_jax(tmp_path):
    rng = np.random.RandomState(3)
    mats = []
    for i in range(4):
        T = np.eye(4)
        T[:3, :3] = Rotation.from_rotvec(rng.randn(3) * 0.1).as_matrix()
        T[:3, 3] = rng.randn(3)
        mats.append(T)
    rows12 = [" ".join(f"{v:.9f}" for v in T[:3].ravel()) for T in mats]
    rows16 = [f"{i * 0.1:.3f} " + " ".join(f"{v:.9f}" for v in T.ravel())
              for i, T in enumerate(mats)]
    quats = [" ".join(f"{v:.9f}" for v in (*rng.randn(3),
                                            *Rotation.from_rotvec(
                                                rng.randn(3) * 0.2).as_quat()))
             for _ in range(4)]
    for name, rows, fmt in (("m12.txt", rows12, "matrix"),
                            ("m16.txt", rows16, "matrix"),
                            ("ta.txt", quats, "tartanair")):
        path = str(tmp_path / name)
        with open(path, "w") as fp:
            fp.write("\n".join(rows) + "\n\n")
        assert formats.sniff_pose_format(path) == fmt \
            == jax_formats.sniff_pose_format(path)
        if fmt == "matrix":
            for invert in (True, False):
                np.testing.assert_allclose(
                    formats.load_pose_file(path, invert),
                    jax_formats.load_pose_file(path, invert), atol=TOL)
        else:
            np.testing.assert_allclose(
                formats.load_tartanair_pose_file(path),
                jax_formats.load_tartanair_pose_file(path), atol=TOL)
            line = np.array([float(v) for v in quats[0].split()])
            np.testing.assert_allclose(
                formats.tartanair_pose_to_matrix(line),
                jax_formats.tartanair_pose_to_matrix(line), atol=TOL)


@jax.default_matmul_precision("highest")
def test_transforms_against_jax():
    """The resize against the JAX package's align-corners resize, which its
    native ts_resize_bilinear matches (CPU matmuls at full f32)."""
    rng = np.random.RandomState(4)
    img = rng.rand(37, 53, 3).astype(np.float32)
    np.testing.assert_array_equal(transforms.normalize(img),
                                  jax_transforms.normalize(img))
    np.testing.assert_allclose(
        transforms.denormalize(transforms.normalize(img)),
        jax_transforms.denormalize(jax_transforms.normalize(img)), atol=TOL)
    for size in ((64, 96), (20, 31), (37, 53)):
        ref = np.asarray(jax_resize_bilinear(jnp.asarray(img), size))
        np.testing.assert_allclose(transforms.resize_image(img, size), ref,
                                   atol=TOL)
        disp = img[..., 0] * 100
        ref = np.asarray(jax_resize_bilinear(jnp.asarray(disp[..., None]),
                                             size))[..., 0] * (size[1] / 53)
        np.testing.assert_allclose(transforms.resize_disparity(disp, size),
                                   ref, rtol=TOL, atol=100 * TOL)


def test_color_maps_against_jax():
    rng = np.random.RandomState(5)
    est = rng.rand(24, 40) * 60
    gt = rng.rand(24, 40) * 60 * (rng.rand(24, 40) > 0.3)
    np.testing.assert_allclose(disp_to_color(est), jax_disp_to_color(est),
                               atol=TOL)
    for with_bar in (False, True):
        np.testing.assert_allclose(
            disp_err_to_colorbar(est, gt, with_bar),
            jax_disp_err_to_colorbar(est, gt, with_bar), atol=TOL)
    gray = lambda x: np.repeat(x[..., None], 3, axis=-1)  # noqa: E731
    for cmap in ("jet", gray):
        for fmt in ("HWC", "CHW"):
            np.testing.assert_allclose(
                colormap(cmap, est[None], output_format=fmt),
                jax_colormap(cmap, est[None], output_format=fmt), atol=TOL)


H, W, N, FOCAL, BASELINE = 96, 128, 3, 60.0, 2.0


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """N frames of left/right PNGs at H x W, ground truth at 120 x 160 and
    TartanAir poses moving forward."""
    root = tmp_path_factory.mktemp("seq")
    _sequence(root, N, H, W, 120, 160, np.random.RandomState(6))
    return root


def _sequence(root, n, h, w, gh, gw, rng):
    for sub in ("left", "right", "disp_gt"):
        os.makedirs(root / sub)
    rows = []
    for i in range(n):
        for sub in ("left", "right"):
            write_png(str(root / sub / f"{i:04d}.png"),
                      (rng.rand(h, w, 3) * 255).astype(np.uint8))
        formats.write_kitti_disp(str(root / "disp_gt" / f"{i:04d}.png"),
                                 rng.uniform(1, 20, (gh, gw)))
        q = Rotation.from_rotvec([0.0, 0.002 * i, 0.0]).as_quat()
        rows.append(" ".join(f"{v:.8f}" for v in (0.05 * i, 0.0, 0.01 * i,
                                                  *q)))
    (root / "pose_left.txt").write_text("\n".join(rows) + "\n")


@functools.lru_cache(maxsize=None)
def _reference(root, fold):
    """The port's streaming_step on the frames the CLI reads (one run per
    sequence and fold: the eager and the bundle cases share it)."""
    model = build_model(get_cfg(KITTI, TINY), device="cpu")
    if fold:
        fold_batch_norms(model)
    poses = formats.load_tartanair_pose_file(str(root / "pose_left.txt"))
    K = torch.tensor([[[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1]]])
    prev = init_prev_info(model, 1, (H, W),
                          backbone_memory_shapes(model.backbone_cfg, (H, W)),
                          2, local_map_channels=0)
    out = []
    for i in range(N):
        l, r = (torch.from_numpy(transforms.normalize(formats.load_image(
            str(root / side / f"{i:04d}.png"))))[None]
            for side in ("left", "right"))
        T = torch.eye(4)[None] if i == 0 else torch.from_numpy(
            poses[i] @ np.linalg.inv(poses[i - 1]))[None]
        o, prev = streaming_step(model, l, r, prev, K,
                                 torch.tensor([BASELINE]), T)
        out.append(o["disps"][0][0, :, :, 0].numpy())
    return out


@pytest.mark.parametrize("flags", [[], ["--fold-bn"], ["--export-bundle"]],
                         ids=["eager", "fold_bn", "bundle"])
def test_video_inference_cli(flags, sequence, tmp_path, capsys):
    """96x128, 3 frames, TartanAir poses, ground truth at 120x160; eagerly,
    with --fold-bn, and through an exported bundle (run eagerly on the
    CPU)."""
    if flags == ["--export-bundle"]:
        flags = flags + [str(tmp_path / "bundle.json")]
    out = tmp_path / "out"
    video_inference.main([
        "--config-file", KITTI, "--data-root", str(sequence),
        "--log-dir", str(out), "--height", str(H), "--width", str(W),
        "--focal", str(FOCAL), "--baseline", str(BASELINE),
        "--device", "cpu", *flags, *TINY])
    printed = capsys.readouterr().out
    assert "poses: 3 frames (tartanair format)" in printed
    assert sorted(os.listdir(out)) == [
        "0000.png", "0000_color.png", "0001.png", "0001_color.png",
        "0002.png", "0002_color.png", "error.txt"]
    lines = (out / "error.txt").read_text().strip().splitlines()
    assert len(lines) == N + 1
    for i in range(N):
        idx, epe, perct = lines[i].split()
        assert idx == f"{i:04d}:"
        assert 0.0 <= float(epe) < 192.0 and 0.0 <= float(perct) <= 100.0
    assert lines[-1].startswith("Sequence average EPE:")
    avg = np.mean([float(line.split()[1]) for line in lines[:-1]])
    assert abs(float(lines[-1].split()[3].rstrip(",")) - avg) < 1e-3
    for i, want in enumerate(_reference(sequence, "--fold-bn" in flags)):
        got = read_png(str(out / f"{i:04d}.png"))
        assert got.dtype == np.uint16 and got.shape == (H, W)
        assert np.abs(got / 256.0 - np.clip(want, 0, None)).max() <= 1 / 256
        color = read_png(str(out / f"{i:04d}_color.png"))
        assert color.shape == (H, W, 3) and color.dtype == np.uint8
