"""The port's native data library (``temporalstereo_tpu_torch/data/native.py``
over its own ``data/csrc/tsnative.cpp``) on the CPU: every entry point
against the JAX package's native library on the same bytes or arrays, and
against the port's numpy path; a KITTI 2015 sample against the JAX
package's default one.

Tolerances and why:
  * against the JAX package's library: bit-equal everywhere (the same
    source, built with the same flags by the same compiler);
  * the decoders (PFM, PNG at every filter, bit depth and channel count)
    and normalisation against the port's numpy path: bit-equal (integer
    arithmetic, or the same IEEE operations);
  * the resize against the numpy path 1e-6 (the compiler contracts the
    native blends into FMAs), the colour jitter 3e-5 (the JAX package's
    own native-against-numpy tolerance);
  * a KITTI 2015 sample (train: jitter and crop; val: the resize) equal to
    the JAX package's default sample, where tests/test_torch_data.py
    allows 1.4e-4 on the images.
The library is built once per test run: the first test process to need it
compiles it under a lock file, the others load the result.
"""
import os
import re

import numpy as np
import pytest

from temporalstereo_tpu.config import get_cfg as jax_get_cfg
from temporalstereo_tpu.data import native as jax_native
from temporalstereo_tpu.data.datasets.builder import (
    build_stereo_dataset as jax_build_stereo_dataset)

from temporalstereo_tpu_torch.config import get_cfg
from temporalstereo_tpu_torch.data import formats, native, png, transforms
from temporalstereo_tpu_torch.data.datasets.builder import (
    build_stereo_dataset)
from temporalstereo_tpu_torch.data.synthetic import write_kitti2015_split

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KITTI = os.path.join(REPO, "configs", "kitti2015-multi.yaml")
RESIZE_TOL = 1e-6
JITTER_TOL = 3e-5


@pytest.fixture(scope="module", autouse=True)
def libraries():
    assert jax_native.available()
    native.library()


@pytest.mark.parametrize("shape", [(9, 13), (9, 13, 3)], ids=["gray", "rgb"])
def test_decode_pfm(shape, tmp_path):
    """Both byte orders: JAX's native array, the port's numpy reader's
    array and scale."""
    img = np.random.RandomState(1).randn(*shape).astype(np.float32)
    path = tmp_path / "a.pfm"
    for order, scale in (("<", 2.5), (">", 1.0)):
        # a negative scale marks little-endian data
        head = (b"PF" if img.ndim == 3 else b"Pf") + (
            f"\n{shape[1]} {shape[0]}\n{-scale if order == '<' else scale}"
            "\n").encode()
        path.write_bytes(head + np.flipud(img).astype(order + "f4").tobytes())
        buf = path.read_bytes()
        got, got_scale = native.decode_pfm(buf)
        want, _ = jax_native.decode_pfm(buf)
        np.testing.assert_array_equal(got, want)
        ref, ref_scale = formats.load_pfm(str(path), use_native=False)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, img)
        assert got.dtype == np.float32 and got_scale == ref_scale == scale
    with pytest.raises(ValueError, match="PFM"):
        native.decode_pfm(b"Pf\n12 x\n")


@pytest.mark.parametrize("filter_type", range(5),
                         ids=["none", "sub", "up", "average", "paeth"])
def test_decode_png(filter_type, tmp_path):
    """8 and 16 bits, gray, gray + alpha, RGB and RGBA: JAX's native
    decoder and the port's numpy unfiltering."""
    rng = np.random.RandomState(filter_type)
    path = str(tmp_path / "a.png")
    for dtype in (np.uint8, np.uint16):
        for channels in (1, 2, 3, 4):
            img = rng.randint(0, np.iinfo(dtype).max + 1, (11, 17, channels)
                              ).astype(dtype)
            png.write_png(path, img[..., 0] if channels == 1 else img,
                          filter_type)
            buf = open(path, "rb").read()
            got = native.decode_png(buf)
            want = jax_native.decode_png(buf)
            assert got.dtype == want.dtype == dtype
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                got, png.read_png(path, use_native=False))
            np.testing.assert_array_equal(got, png.read_png(path))
    bad = np.frombuffer(b"\x07" + bytes(3), np.uint8).reshape(1, 4)
    with pytest.raises(ValueError, match="filter"):
        native.png_unfilter(bad, 3, 8)


@pytest.mark.parametrize("src,dst", [((30, 44), (24, 40)),
                                     ((37, 53), (80, 91)),
                                     ((5, 7), (5, 19)), ((9, 1), (4, 3))])
def test_resize_bilinear(src, dst):
    """Up, down and one axis, [H, W] and [H, W, 3]."""
    rng = np.random.RandomState(sum(src))
    for shape in (src, src + (3,)):
        img = rng.rand(*shape).astype(np.float32)
        got = native.resize_bilinear(img, dst)
        np.testing.assert_array_equal(got, jax_native.resize_bilinear(
            img, dst))
        if img.ndim == 3:
            np.testing.assert_array_equal(
                transforms.resize_image(img, dst), got)
            np.testing.assert_allclose(
                transforms.resize_image(img, dst, use_native=False), got,
                rtol=0, atol=RESIZE_TOL)
    disp = rng.rand(*src).astype(np.float32) * 50
    np.testing.assert_allclose(
        transforms.resize_disparity(disp, dst),
        transforms.resize_disparity(disp, dst, use_native=False), rtol=0,
        atol=RESIZE_TOL * 50 * dst[1] / src[1])


def test_color_jitter_normalize_and_crop():
    """The jitter kernel on the same factors and order as JAX's, in place;
    ``color_jitter``'s default path is the kernel and its numpy path is
    within 3e-5; normalisation and the crop against JAX's library and
    numpy."""
    rng = np.random.RandomState(3)
    img = rng.rand(23, 31, 3).astype(np.float32)
    for seed in range(6):
        r = np.random.RandomState(seed)
        order = r.permutation(4)
        factors = (r.uniform(0.4, 2.0), r.uniform(0.5, 1.5),
                   r.uniform(0.5, 1.5), r.uniform(-0.1, 0.1),
                   r.uniform(0.8, 1.2))
        got = native.color_jitter_inplace(img.copy(), order, *factors)
        want = jax_native.color_jitter_inplace(img.copy(), order, *factors)
        np.testing.assert_array_equal(got, want)
        ours = transforms.color_jitter(img, np.random.RandomState(seed))
        np.testing.assert_allclose(
            ours, transforms.color_jitter(img, np.random.RandomState(seed),
                                          use_native=False),
            rtol=0, atol=JITTER_TOL)
    mean, std = transforms.IMAGENET_MEAN, transforms.IMAGENET_STD
    got = native.normalize_inplace(img.copy(), mean, std)
    np.testing.assert_array_equal(
        got, jax_native.normalize_inplace(img.copy(), mean, std))
    np.testing.assert_array_equal(
        got, transforms.normalize(img, use_native=False))
    np.testing.assert_array_equal(got, transforms.normalize(img))
    crop = native.ts_crop(img, 4, 7, 11, 20)
    np.testing.assert_array_equal(crop, transforms.crop(img, 4, 7, 11, 20))
    want = np.empty_like(crop)
    jax_native._load().ts_crop(img.ctypes.data, 23, 31, 3, 4, 7, 11, 20,
                               want.ctypes.data)
    np.testing.assert_array_equal(crop, want)
    with pytest.raises(ValueError, match="outside"):
        native.ts_crop(img, 20, 0, 11, 20)


@pytest.mark.parametrize("phase", ["train", "val"])
def test_kitti2015_sample_equals_jax_default(phase, tmp_path):
    """Paeth-filtered PNGs, sparse ground truth of both views: the port's
    default sample (native decode, jitter and resize) equal to the JAX
    package's default sample, every key, several seeds."""
    root = str(tmp_path)
    ann = write_kitti2015_split(root, 2, [-1, 0], 30, 44, seed=4,
                                filter_type=4)
    node = {"train": "TRAIN", "val": "VAL"}[phase]
    h, w = (16, 24) if phase == "train" else (24, 40)
    opts = ["MODEL.BACKBONE.VARIANT", "tiny",
            f"DATA.{node}.TYPE", "KITTI2015", f"DATA.{node}.DATA_ROOT", root,
            f"DATA.{node}.ANNFILE", ann, f"DATA.{node}.HEIGHT", str(h),
            f"DATA.{node}.WIDTH", str(w), f"DATA.{node}.FRAME_IDXS",
            "[-1, 0]"]
    ours = build_stereo_dataset(get_cfg(KITTI, opts).DATA[node], phase)
    theirs = jax_build_stereo_dataset(jax_get_cfg(KITTI, opts).DATA[node],
                                      phase)
    for idx in range(len(ours)):
        for seed in (idx, 1000 + idx, 7):
            a, b = ours.getitem_seeded(idx, seed), theirs.getitem_seeded(
                idx, seed)
            assert a.keys() == b.keys()
            for k, v in b.items():
                assert a[k].dtype == v.dtype, k
                np.testing.assert_array_equal(a[k], v, err_msg=k)


def test_build_raises_with_the_compiler_message_and_numpy_switch(
        tmp_path, monkeypatch):
    """A source that does not compile raises RuntimeError carrying g++'s
    message, and nothing falls back; the default path is the library's,
    and only use_native=False is numpy's; the library's source lies inside
    the port."""
    assert native.SOURCE.is_file()
    assert "temporalstereo_tpu_torch" in native.SOURCE.parts
    bad = tmp_path / "bad.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="error"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))
    assert native.resolve(None) and native.resolve(True)
    assert not native.resolve(False)
    text = open(native.__file__).read()
    assert not re.search(r"libtsnative\.so\b|[\"']native[\"']\s*[,)]", text)
