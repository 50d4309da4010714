"""Five faults of the port against the JAX package, each held on the CPU:

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
4. The GN, IN and LN norm kinds exist (``nn/layers.py:get_norm`` raised
   ValueError for them): the tiny model with GN in its FPN and GN, IN and
   LN in its three stages builds, loads JAX's variables through
   ``state_dict_from_jax`` (GroupNorm and LayerNorm ``scale/bias``) and
   streams two frames as JAX does: 2e-3 on the first (single-frame), 5e-3
   on the second (streamed, tests/test_temporal_parity.py's tolerance).
5. ``FrozenBN`` normalises with its running statistics in train mode and
   leaves them unchanged, as flax's ``BatchNorm(use_running_average=True)``
   (it was a trainable BatchNorm): a train-mode conv + FrozenBN against
   JAX's at 1e-5, its statistics bit-unchanged.
The JAX forwards compile with XLA's CPU optimisations off, as in
tests/test_torch_model.py.
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
from temporalstereo_tpu.models.stereo import (
    backbone_memory_shapes as jax_memory_shapes)
from temporalstereo_tpu.models.stereo import init_prev_info as jax_init_prev
from temporalstereo_tpu.models.temporal import (
    streaming_step as jax_streaming_step)
from temporalstereo_tpu.nn.layers import Conv3d as JaxConv3d
from temporalstereo_tpu.serving import cast_params_bf16 as jax_cast_bf16
from temporalstereo_tpu.training.checkpoint import load_any_weights
from temporalstereo_tpu.utils.torch_export import save_reference_checkpoint

from temporalstereo_tpu_torch.cli import video_inference
from temporalstereo_tpu_torch.config import get_cfg
from temporalstereo_tpu_torch.data.transforms import resize_pil_bilinear
from temporalstereo_tpu_torch.models import (backbone_memory_shapes,
                                             build_model, init_prev_info,
                                             streaming_step)
from temporalstereo_tpu_torch.nn.layers import Conv3d
from temporalstereo_tpu_torch.models.backbone import TINY_GROUPS
from temporalstereo_tpu_torch.serving import cast_params_bf16
from temporalstereo_tpu_torch.utils.checkpoint import load_weights
from temporalstereo_tpu_torch.utils.convert import state_dict_from_jax

from tests.test_torch_cli import _sequence
from tests.test_torch_model import (FAST_COMPILE, TEMPORAL, TINY,
                                    _geometry, _jax_variables, _rel)

RESIZE_TOL = 1e-5
ERROR_TXT_TOL = 1e-4
SINGLE_TOL = 2e-3
TEMPORAL_TOL = 5e-3
NORM_TOL = 1e-5
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
        out, _ = jax.jit(lambda v, l, r: jmodel.apply(v, l, r, None, False),
                         compiler_options=FAST_COMPILE)(
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


def test_group_instance_layer_norm_model_matches_jax():
    """Fault 4: GN in the FPN, GN / IN / LN in the coarse / fine / precise
    stages; two streamed frames (the second warps the first's state)."""
    opts = TINY + TEMPORAL + ["MODEL.BACKBONE.NORM", "GN",
                              "MODEL.AGGREGATION.COARSE.NORM", "GN",
                              "MODEL.AGGREGATION.FINE.NORM", "IN",
                              "MODEL.AGGREGATION.PRECISE.NORM", "LN"]
    jmodel = jax_build_model(jax_get_cfg(opts=opts), dtype=None)
    variables = _jax_variables(jmodel, H, W, seed=55)
    assert "GroupNorm_0" in variables["params"]["backbone"]["deconv8_4_0"][
        "Norm_0"]
    model = build_model(get_cfg(opts=opts), device="cpu")
    model.load_state_dict(state_dict_from_jax(
        variables["params"], variables["batch_stats"], TINY_GROUPS),
        strict=True)
    K, baseline, T = (jnp.asarray(a) for a in _geometry(H, W))
    jprev = jax_init_prev(jmodel, 1, (H, W),
                          jax_memory_shapes(jmodel.backbone_cfg, (H, W)), 2,
                          jnp.float32, local_map_channels=0)
    tprev = init_prev_info(model, 1, (H, W),
                           backbone_memory_shapes(model.backbone_cfg, (H, W)),
                           2, local_map_channels=0)
    rng = np.random.RandomState(56)
    for f, tol in enumerate((SINGLE_TOL, TEMPORAL_TOL)):
        left, right = (rng.rand(1, H, W, 3).astype(np.float32)
                       for _ in range(2))
        with jax.default_matmul_precision("highest"):
            jout, jprev = jax.jit(
                lambda v, l, r, p, warp=f > 0: jax_streaming_step(
                    jmodel, v, l, r, p, K, baseline, T, warp=warp),
                compiler_options=FAST_COMPILE)(
                variables, jnp.asarray(left), jnp.asarray(right), jprev)
        with torch.inference_mode():
            tout, tprev = streaming_step(
                model, torch.from_numpy(left), torch.from_numpy(right),
                tprev, *(torch.tensor(np.asarray(a))
                         for a in (K, baseline, T)))
        for i, (j, t) in enumerate(zip(jout["disps"], tout["disps"])):
            rel = _rel(t.numpy(), j)
            assert rel < tol, f"frame {f} disparity {i}: rel={rel:.2e}"


def test_frozen_batch_norm_stays_frozen_in_train_mode():
    """Fault 5: a (1,3,3) conv + FrozenBN in train mode against JAX's
    (train=True, statistics mutable), and a second call: the output equals
    the first, the running statistics are bit-unchanged."""
    rng = np.random.RandomState(57)
    x = rng.randn(2, 3, 6, 7, 16).astype(np.float32)
    jconv = JaxConv3d(16, (1, 3, 3), 1, (0, 1, 1), use_bias=False,
                      norm="FrozenBN")
    variables = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x), True)
    bn = {"mean": rng.randn(16) * 0.3, "var": rng.rand(16) + 0.5}
    variables = {
        "params": {**variables["params"], "Norm_0": {"BatchNorm_0": {
            "scale": jnp.asarray(rng.rand(16) + 0.5, jnp.float32),
            "bias": jnp.asarray(rng.randn(16) * 0.1, jnp.float32)}}},
        "batch_stats": {"Norm_0": {"BatchNorm_0": {
            k: jnp.asarray(v, jnp.float32) for k, v in bn.items()}}}}
    with jax.default_matmul_precision("highest"):
        jy, updates = jconv.apply(variables, jnp.asarray(x), True,
                                  mutable=["batch_stats"])
    jstats = updates["batch_stats"]["Norm_0"]["BatchNorm_0"]

    conv = Conv3d(16, 16, (1, 3, 3), 1, (0, 1, 1), bias=False,
                  norm="FrozenBN")
    p = variables["params"]
    conv.load_state_dict({
        "weight": torch.from_numpy(np.asarray(p["Conv_0"]["kernel"]).transpose(
            3, 2, 0, 1)[:, :, None].copy()),
        "norm.weight": torch.tensor(np.asarray(
            p["Norm_0"]["BatchNorm_0"]["scale"])),
        "norm.bias": torch.tensor(np.asarray(
            p["Norm_0"]["BatchNorm_0"]["bias"])),
        "norm.running_mean": torch.tensor(bn["mean"], dtype=torch.float32),
        "norm.running_var": torch.tensor(bn["var"], dtype=torch.float32),
        "norm.num_batches_tracked": torch.zeros((), dtype=torch.long)})
    before = {k: v.clone() for k, v in conv.norm.state_dict().items()}
    conv.train()
    tx = torch.from_numpy(x.transpose(0, 4, 1, 2, 3).copy())
    outs = [conv(tx).detach() for _ in range(2)]
    got = outs[0].permute(0, 2, 3, 4, 1).numpy()
    np.testing.assert_allclose(got, jy, rtol=NORM_TOL, atol=NORM_TOL)
    assert torch.equal(outs[0], outs[1])
    for k, v in conv.norm.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k in ("mean", "var"):
        np.testing.assert_array_equal(np.asarray(jstats[k]),
                                      np.asarray(bn[k], np.float32))
