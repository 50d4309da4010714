"""Three faults of the port against the JAX package, each held on the CPU:

1. The video CLI brings its estimate to the ground truth's resolution as
   the JAX CLI does, with Pillow's bilinear filter (half-pixel centres, a
   support that widens when it shrinks): ``transforms.resize_pil_bilinear``
   against Pillow itself at 1e-5, and the CLI's ``error.txt`` against the
   JAX CLI's within 1e-4 (its printed precision) on frames whose ground
   truth has another size.  With the align-corners resize the two files
   were up to 0.015 px of EPE apart.
2. ``utils/checkpoint.py:load_weights`` merges as the JAX package's
   ``load_any_weights`` does (``warm_start(strict=False)``): a checkpoint
   holding only part of the model loads in both, and the two models then
   compute the same disparities (2e-3, the single-frame tolerance of
   tests/test_torch_model.py).
3. ``serving.cast_params_bf16`` takes a model that computes in f32: each
   bf16-stored weight is cast to f32 where a layer uses it, as flax casts
   to the compute type; against JAX's ``cast_params_bf16`` then a forward,
   at 2e-3.
"""
import re
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from temporalstereo_tpu.cli import video_inference as jax_video_inference
from temporalstereo_tpu.config import get_cfg as jax_get_cfg
from temporalstereo_tpu.models import build_model as jax_build_model
from temporalstereo_tpu.models.backbone import TINY_GROUPS as JAX_TINY
from temporalstereo_tpu.serving import cast_params_bf16 as jax_cast_bf16
from temporalstereo_tpu.training.checkpoint import load_any_weights
from temporalstereo_tpu.utils.torch_export import save_reference_checkpoint

from temporalstereo_tpu_torch.cli import video_inference
from temporalstereo_tpu_torch.config import get_cfg
from temporalstereo_tpu_torch.data.transforms import resize_pil_bilinear
from temporalstereo_tpu_torch.models import build_model
from temporalstereo_tpu_torch.models.backbone import TINY_GROUPS
from temporalstereo_tpu_torch.serving import cast_params_bf16
from temporalstereo_tpu_torch.utils.checkpoint import load_weights
from temporalstereo_tpu_torch.utils.convert import state_dict_from_jax

from tests.test_torch_cli import _sequence
from tests.test_torch_model import TINY, _jax_variables, _rel

RESIZE_TOL = 1e-5
ERROR_TXT_TOL = 1e-4
SINGLE_TOL = 2e-3
H, W = 96, 128


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("src,dst", [((384, 1248), (375, 1242)),
                                     ((375, 1242), (384, 1248)),
                                     ((96, 128), (120, 160)),
                                     ((37, 53), (20, 31)),
                                     ((10, 10), (3, 17)),
                                     ((13, 11), (13, 40))])
def test_resize_matches_pillow_bilinear(src, dst):
    """Up, down, one axis only and KITTI's 384x1248 -> 375x1242."""
    img = (np.random.RandomState(sum(src)).rand(*src) * 200).astype(
        np.float32)
    want = np.asarray(Image.fromarray(img).resize(dst[::-1], Image.BILINEAR))
    got = resize_pil_bilinear(img, dst)
    assert got.dtype == np.float32 and got.shape == dst
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_TOL)
    rgb = np.stack([img, img * 0.5, img + 1], -1)
    np.testing.assert_allclose(resize_pil_bilinear(rgb, dst)[..., 1],
                               resize_pil_bilinear(img * 0.5, dst),
                               rtol=0, atol=0)


@pytest.fixture(scope="module")
def jax_single():
    """The tiny single-frame JAX model, random variables and a second set
    (each value scaled by 1.25 and moved by 0.01)."""
    jmodel = jax_build_model(jax_get_cfg(opts=TINY), dtype=None)
    variables = _jax_variables(jmodel, H, W, seed=51)
    return (jmodel, variables,
            jax.tree.map(lambda x: x * 1.25 + 0.01, variables))


def _jax_disps(jmodel, variables, left, right):
    with jax.default_matmul_precision("highest"):
        out, _ = jax.jit(lambda v, l, r: jmodel.apply(v, l, r, None, False))(
            variables, jnp.asarray(left), jnp.asarray(right))
    return out["disps"]


def _frames():
    rng = np.random.RandomState(53)
    return (rng.rand(1, H, W, 3).astype(np.float32),
            rng.rand(1, H, W, 3).astype(np.float32))


def test_video_cli_error_txt_matches_jax(jax_single, tmp_path, monkeypatch):
    """Both CLIs on the same three 96x128 frames with ground truth at
    120x160 and the same weights (the JAX exporter's .ckpt)."""
    jmodel, variables, _ = jax_single
    seq = tmp_path / "seq"
    seq.mkdir()
    _sequence(seq, 3, H, W, 120, 160, np.random.RandomState(54))
    ckpt = str(tmp_path / "w.ckpt")
    save_reference_checkpoint(variables, ckpt, JAX_TINY)
    config = tmp_path / "single.yaml"
    config.write_text("MODEL:\n  WITH_PREVIOUS: False\n")
    common = ["--config-file", str(config), "--data-root", str(seq),
              "--height", str(H), "--width", str(W), "--checkpoint", ckpt]
    video_inference.main(common + ["--log-dir", str(tmp_path / "ours"),
                                   "--device", "cpu", *TINY])
    cache_dir = jax.config.jax_compilation_cache_dir
    monkeypatch.setattr(sys, "argv", ["video_inference", *common,
                                      "--log-dir", str(tmp_path / "jax"),
                                      *TINY])
    try:
        with jax.default_matmul_precision("highest"):
            jax_video_inference.main()
    finally:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    ours = (tmp_path / "ours" / "error.txt").read_text().splitlines()
    theirs = (tmp_path / "jax" / "error.txt").read_text().splitlines()
    assert len(ours) == len(theirs) == 4
    for a, b in zip(ours, theirs):
        na, nb = (list(map(float, re.findall(r"\d+\.\d+", x)))
                  for x in (a, b))
        assert len(na) == len(nb) == 2
        np.testing.assert_allclose(na, nb, rtol=0,
                                   atol=ERROR_TXT_TOL + 1e-9, err_msg=a)


def test_partial_checkpoint_loads_as_in_jax(jax_single, tmp_path):
    """Weights B over a model holding weights A: the .ckpt of B without the
    whole backbone and the coarse and fine stages' fusion blocks (33% of
    its entries, groups the JAX importer may miss), one more entry of
    another shape.  Each side keeps A where B has nothing that fits.
    Counts: the port counts state_dict entries, JAX flax leaves; a torch
    BatchNorm has one entry more (``num_batches_tracked``), so the port's
    count is JAX's plus the BatchNorms the file still holds."""
    jmodel, fresh, other = jax_single
    ckpt = str(tmp_path / "b.ckpt")
    save_reference_checkpoint(other, ckpt, JAX_TINY)
    sd = torch.load(ckpt, map_location="cpu", weights_only=True)[
        "state_dict"]
    n_all = len(sd)
    dropped = ("backbone.", "aggregation.coarse.fuse.",
               "aggregation.fine.fuse.")
    partial = {k: v for k, v in sd.items() if not k.startswith(dropped)}
    assert 0.3 < 1 - len(partial) / n_all < 0.37
    reshaped = "aggregation.fine.pred_heads.cost_head.0.norm.weight"
    partial[reshaped] = torch.cat([partial[reshaped], torch.ones(1)])
    torch.save({"state_dict": partial}, ckpt)

    merged, n_jax = load_any_weights(fresh, ckpt)
    model = build_model(get_cfg(opts=TINY), device="cpu")
    model.load_state_dict(state_dict_from_jax(
        fresh["params"], fresh["batch_stats"], TINY_GROUPS))
    n_port = load_weights(model, ckpt)
    bns = sum(k.endswith("num_batches_tracked") for k in partial)
    assert n_port == n_jax + bns == len(partial) - 1

    want = state_dict_from_jax(merged["params"], merged["batch_stats"],
                               TINY_GROUPS)
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k]), k
    kept = state_dict_from_jax(fresh["params"], fresh["batch_stats"],
                               TINY_GROUPS)
    assert torch.equal(model.state_dict()[reshaped], kept[reshaped])
    left, right = _frames()
    jdisps = _jax_disps(jmodel, merged, left, right)
    with torch.inference_mode():
        out, _ = model(torch.from_numpy(left), torch.from_numpy(right))
    for i, (t, j) in enumerate(zip(out["disps"], jdisps)):
        rel = _rel(t.numpy(), j)
        assert rel < SINGLE_TOL, f"disparity {i}: rel={rel:.2e}"


def test_f32_model_takes_bf16_weights(jax_single):
    """The tiny f32 model with every weight stored in bf16 against JAX's
    cast then a forward; it computes in f32 and differs from the model
    with its f32 weights."""
    jmodel, variables, _ = jax_single
    model = build_model(get_cfg(opts=TINY), device="cpu")
    model.load_state_dict(state_dict_from_jax(
        variables["params"], variables["batch_stats"], TINY_GROUPS))
    left, right = _frames()
    with torch.inference_mode():
        full, _ = model(torch.from_numpy(left), torch.from_numpy(right))
    cast_params_bf16(model)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    with torch.inference_mode():
        out, _ = model(torch.from_numpy(left), torch.from_numpy(right))
    jdisps = _jax_disps(jmodel, jax_cast_bf16(variables), left, right)
    for i, (t, j) in enumerate(zip(out["disps"], jdisps)):
        assert t.dtype == torch.float32
        rel = _rel(t.numpy(), j)
        assert rel < SINGLE_TOL, f"disparity {i}: rel={rel:.2e}"
    assert not torch.equal(out["disps"][0], full["disps"][0])
