"""The port's evaluation path against the JAX package on the CPU: the
disparity and flow metrics, ``grid_sample`` / ``inverse_warp``,
``make_eval_step`` on a batch of the port's loader, and the
``kitti_submission`` CLI end to end.

Tolerances and why:
  * metrics and warps 1e-6: the same f32 arithmetic on identical inputs
    (sums in another order);
  * ``make_eval_step`` (tiny f32 model, T=2, B=2): ``weight`` and the
    per-split weights exact (they depend on the ground truth only); EPE
    within the largest disparity difference the streamed-model tolerance
    of tests/test_torch_model.py allows (5e-3 of the mean disparity); an
    outlier percentage is a step function, so it may differ by exactly the
    pixels that lie within 1e-3 px of its threshold on the JAX side, and
    the test checks that the two models' disparities are that close;
  * the CLI's PNGs within 1/256 px (their quantisation step) of the port's
    own ``multi_frame_forward``, its 3PE equal to JAX's ``calc_error`` on
    the same arrays at the printed precision.
"""
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from temporalstereo_tpu.config import get_cfg as jax_get_cfg
from temporalstereo_tpu.data.evaluation import (
    calc_error as jax_calc_error)
from temporalstereo_tpu.data.evaluation import (
    calc_flow_error as jax_calc_flow_error)
from temporalstereo_tpu.data.evaluation import (
    do_occlusion_evaluation as jax_occlusion)
from temporalstereo_tpu.models import build_model as jax_build_model
from temporalstereo_tpu.ops import warp as jax_warp
from temporalstereo_tpu.ops.interpolate import (
    resize_bilinear as jax_resize_bilinear)
from temporalstereo_tpu.training import step as jax_step

from temporalstereo_tpu_torch.cli import kitti_submission
from temporalstereo_tpu_torch.config import get_cfg
from temporalstereo_tpu_torch.data import (batch_to_device,
                                           build_dataloader,
                                           build_stereo_dataset, collate)
from temporalstereo_tpu_torch.data.evaluation import (
    calc_error, calc_flow_error, do_evaluation, do_flow_evaluation,
    do_occlusion_evaluation)
from temporalstereo_tpu_torch.data.png import read_png
from temporalstereo_tpu_torch.data.synthetic import write_kitti2015_split
from temporalstereo_tpu_torch.data.transforms import resize_disparity
from temporalstereo_tpu_torch.models import build_model, multi_frame_forward
from temporalstereo_tpu_torch.models.backbone import TINY_GROUPS
from temporalstereo_tpu_torch.ops import (grid_sample, inverse_warp,
                                          resize_bilinear)
from temporalstereo_tpu_torch.training import make_eval_step
from temporalstereo_tpu_torch.utils.convert import state_dict_from_jax

from tests.test_torch_model import TEMPORAL, TINY, _jax_variables

TOL = 1e-6
TEMPORAL_TOL = 5e-3
THRESHOLDS = (1, 2, 3, 5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KITTI = os.path.join(REPO, "configs", "kitti2015-multi.yaml")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(ours, theirs, tol=TOL):
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(v), rtol=tol,
                                   atol=tol, err_msg=k)


def _disparities(rng, shape, lo=-5.0, hi=200.0, valid=0.6):
    """A ground truth reaching past both bounds, partly invalid (0), and an
    estimate near it with outliers."""
    gt = rng.uniform(lo, hi, shape) * (rng.rand(*shape) < valid)
    est = gt + rng.standard_normal(shape) * 3
    return est.astype(np.float32), gt.astype(np.float32)


@pytest.mark.parametrize("case", ["bounds", "lb_only", "none", "empty",
                                  "count"])
def test_calc_error_matches_jax(case):
    est, gt = _disparities(np.random.RandomState(1), (2, 17, 23, 1))
    lb, ub = {"bounds": (0, 192), "lb_only": (0, None), "none": (None, None),
              "empty": (300, 400), "count": (0, 192)}[case]
    kw = {"return_count": case == "count"}
    ours = calc_error(torch.from_numpy(est), torch.from_numpy(gt), lb, ub,
                      **kw)
    theirs = jax_calc_error(jnp.asarray(est), jnp.asarray(gt), lb, ub, **kw)
    _close(ours, theirs)
    if case == "empty":
        assert all(float(v) == 0.0 for v in ours.values())
    assert set(do_evaluation(torch.from_numpy(est), torch.from_numpy(gt),
                             0, 192)) == {"1px", "2px", "3px", "5px", "epe"}
    assert do_evaluation(None, torch.from_numpy(gt), 0, 192) == {}


@pytest.mark.parametrize("case", ["lr_pair", "all_occluded"])
def test_occlusion_evaluation_matches_jax(case):
    """A left ground truth and the right view's, consistent where the
    warp lands inside the image; all-zero right ground truth makes every
    pixel occluded and the non-occluded split empty."""
    rng = np.random.RandomState(2)
    b, h, w = 2, 13, 29
    gt = np.broadcast_to(rng.uniform(1, 9, (b, h, 1, 1)),
                         (b, h, w, 1)).astype(np.float32).copy()
    gt *= rng.rand(b, h, w, 1) < 0.8
    gt_right = gt.copy() if case == "lr_pair" else np.zeros_like(gt)
    est = (gt + rng.standard_normal(gt.shape) * 2).astype(np.float32)
    for counts in (False, True):
        ours = do_occlusion_evaluation(*map(torch.from_numpy,
                                            (est, gt, gt_right)), 0, 192,
                                       return_counts=counts)
        theirs = jax_occlusion(jnp.asarray(est), jnp.asarray(gt),
                               jnp.asarray(gt_right), 0, 192,
                               return_counts=counts)
        _close(ours, theirs)
    if case == "all_occluded":
        assert float(ours["noc_count"]) == 0 and float(ours["noc_epe"]) == 0
    else:
        assert float(ours["noc_count"]) > 0 and float(ours["occ_count"]) > 0


@pytest.mark.parametrize("sparse", [False, True])
def test_flow_error_matches_jax(sparse):
    """NaN ground truth, zero fill (sparse), magnitudes past the upper
    bound and a caller mask."""
    rng = np.random.RandomState(3)
    gt = rng.uniform(-300, 300, (2, 11, 19, 2)).astype(np.float32)
    gt[0, :3] = np.nan
    gt[1, 4:6] = 0.0
    est = (gt + rng.standard_normal(gt.shape) * 4).astype(np.float32)
    est[0, :3] = 1.0
    mask = (rng.rand(2, 11, 19) < 0.7).astype(np.float32)
    for m in (None, mask):
        ours = calc_flow_error(torch.from_numpy(est), torch.from_numpy(gt),
                               None if m is None else torch.from_numpy(m),
                               sparse=sparse)
        theirs = jax_calc_flow_error(jnp.asarray(est), jnp.asarray(gt),
                                     None if m is None else jnp.asarray(m),
                                     sparse=sparse)
        _close(ours, theirs)
    assert do_flow_evaluation(None, torch.from_numpy(gt)) == {}


@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_grid_sample_matches_jax(padding):
    """Coordinates inside, on every edge and outside the image, integer
    and fractional."""
    rng = np.random.RandomState(4)
    img = rng.randn(2, 7, 9, 3).astype(np.float32)
    coords = rng.uniform(-2.5, 10.5, (2, 5, 6, 2)).astype(np.float32)
    coords[0, 0, :, 0] = [0, 8, -1, 9, 3, 8.5]
    coords[0, 1, :, 1] = [0, 6, -1, 7, 2, 6.5]
    ours = grid_sample(torch.from_numpy(img), torch.from_numpy(coords),
                       padding)
    theirs = jax_warp.grid_sample(jnp.asarray(img), jnp.asarray(coords),
                                  padding)
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mode", ["disparity", "flow", "depth"])
@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_inverse_warp_matches_jax(mode, padding):
    rng = np.random.RandomState(5)
    b, h, w = 2, 8, 12
    img = rng.randn(b, h, w, 3).astype(np.float32)
    kw_t, kw_j = {}, {}
    if mode == "disparity":
        motion = rng.uniform(-14, 14, (b, h, w, 1))
    elif mode == "flow":
        motion = rng.uniform(-10, 10, (b, h, w, 2))
    else:
        motion = rng.uniform(2, 20, (b, h, w, 1))
        K = np.array([[[6.0, 0, w / 2], [0, 6.0, h / 2], [0, 0, 1]]] * b,
                     np.float32)
        T = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
        T[:, 0, 3], T[:, 2, 3] = 0.8, -0.5
        kw_t = {"K": torch.from_numpy(K), "T_target_to_source":
                torch.from_numpy(T), "output_all": True}
        kw_j = {"K": jnp.asarray(K), "T_target_to_source": jnp.asarray(T),
                "output_all": True}
    motion = motion.astype(np.float32)
    ours = inverse_warp(torch.from_numpy(img), torch.from_numpy(motion), mode,
                        padding_mode=padding, **kw_t)
    theirs = jax_warp.inverse_warp(jnp.asarray(img), jnp.asarray(motion),
                                   mode, padding_mode=padding, **kw_j)
    if mode == "depth":
        (ours, extra), (theirs, jextra) = ours, theirs
        assert set(extra) == set(jextra)
        for k, v in jextra.items():
            np.testing.assert_allclose(extra[k].numpy(), v, rtol=TOL,
                                       atol=1e-5, err_msg=k)
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=TOL, atol=TOL)


# ------------------------------------------------ the evaluation step ----

IN_H, IN_W, GT_H, GT_W = 96, 128, 120, 160
EVAL_OPTS = TINY + TEMPORAL + ["VAL.DO_OCCLUSION_EVALUATION", "True"]


def _split_opts(root, annfile, node="VAL"):
    return [f"DATA.{node}.DATA_ROOT", root, f"DATA.{node}.ANNFILE", annfile,
            f"DATA.{node}.HEIGHT", str(IN_H), f"DATA.{node}.WIDTH", str(IN_W),
            f"DATA.{node}.FRAME_IDXS", "[-1, 0]", f"DATA.{node}.BATCH_SIZE",
            "2", f"DATA.{node}.NUM_WORKERS", "1",
            f"DATA.{node}.PROCESS_WORKERS", "False"]


@pytest.fixture(scope="module")
def kitti_split(tmp_path_factory):
    """Two samples of T=2 at 120x160, ground truth of both views."""
    root = str(tmp_path_factory.mktemp("kitti"))
    return root, write_kitti2015_split(root, 2, [-1, 0], GT_H, GT_W, seed=7)


def test_make_eval_step_matches_jax(kitti_split):
    """T=2, B=2 from the port's loader (images resized to 96x128, ground
    truth at its own 120x160), the second sample marked a pad, the
    occluded / non-occluded split on."""
    opts = EVAL_OPTS + _split_opts(*kitti_split)
    cfg = get_cfg(KITTI, opts)
    batch = next(iter(build_dataloader(cfg.DATA.VAL, "val")))
    assert batch["left"].shape == (2, 2, IN_H, IN_W, 3)
    assert batch["disp_gt"].shape == (2, 2, GT_H, GT_W, 1)
    batch["pad_mask"] = np.array([1.0, 0.0], np.float32)

    jmodel = jax_build_model(jax_get_cfg(KITTI, opts), dtype=None)
    variables = _jax_variables(jmodel, IN_H, IN_W, seed=31)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(
        variables["params"], variables["batch_stats"], TINY_GROUPS))

    jeval = jax_step.make_eval_step(jmodel, jax_get_cfg(KITTI, opts))
    real = jax_step.multi_frame_forward

    def metrics_and_disps(v, b):
        seen = {}

        def spy(*args, **kwargs):
            out = real(*args, **kwargs)
            seen["disps"] = out[0]["disps"]
            return out
        jax_step.multi_frame_forward = spy
        try:
            return jeval(v, b), seen["disps"]
        finally:
            jax_step.multi_frame_forward = real

    with jax.default_matmul_precision("highest"):
        theirs, jdisps = jax.jit(metrics_and_disps)(
            variables, {k: jnp.asarray(v) for k, v in batch.items()})
    tbatch = batch_to_device(batch, "cpu")
    ours = make_eval_step(model, cfg)(tbatch)
    with torch.no_grad():
        tdisps = multi_frame_forward(model, tbatch)[0]["disps"]
    assert set(ours) == set(theirs)
    assert all(v.dim() == 0 for v in ours.values())
    assert float(ours["weight"]) == 1.0

    gt = batch["disp_gt"][-1]
    for i, d in enumerate(jdisps):
        jd = np.asarray(jax_resize_bilinear(d * (GT_W / d.shape[2]),
                                            (GT_H, GT_W)))
        td = resize_bilinear(tdisps[i] * (GT_W / tdisps[i].shape[2]),
                             (GT_H, GT_W)).numpy()
        valid = (gt > 0) & (gt < 192)
        # the flip allowance below assumes the two models this close
        assert np.abs(td - jd)[valid].max() < 1e-3, i
        err = np.abs(gt - jd)
        for px in THRESHOLDS:
            key = f"metric_disparity_{i}/all_{px}px"
            near = ((np.abs(err - px) < 1e-3) & valid)[0].sum()
            allowed = near / valid[0].sum() * 100 + TOL
            assert abs(float(ours[key]) - float(theirs[key])) <= allowed, key
        key = f"metric_disparity_{i}/all_epe"
        assert abs(float(ours[key]) - float(theirs[key])) <= (
            TEMPORAL_TOL * np.abs(jd).mean()), key
        for split in ("occ", "noc"):
            key = f"metric_disparity_{i}/{split}_epe"
            assert float(ours[f"weight:{key}"]) == float(
                theirs[f"weight:{key}"]) == 1.0
            assert abs(float(ours[key]) - float(theirs[key])) <= (
                TEMPORAL_TOL * np.abs(jd).mean()), key


def test_kitti_submission_cli(kitti_split, tmp_path, capsys):
    """The TEST split through the CLI on the CPU: one PNG a sample, a 3PE
    line each and the average."""
    root, annfile = kitti_split
    opts = TINY + TEMPORAL + _split_opts(root, annfile, "TEST")
    out = tmp_path / "disp_0"
    kitti_submission.main(["--config-file", KITTI, "--output-dir", str(out),
                           "--device", "cpu", *opts])
    printed = capsys.readouterr().out
    names = sorted(os.listdir(out))
    assert names == ["000000_10.png", "000001_10.png"]
    p3 = [float(v) for v in re.findall(r"3PE=([0-9.]+)%", printed)]
    assert len(p3) == 2 and "average 3PE" in printed

    cfg = get_cfg(KITTI, opts)
    model = build_model(cfg, device="cpu")
    dataset = build_stereo_dataset(cfg.DATA.TEST, "test")
    for idx, name in enumerate(names):
        batch = collate([dataset[idx]])
        with torch.no_grad():
            outputs, _ = multi_frame_forward(
                model, batch_to_device(batch, "cpu"))
        want = outputs["disps"][0][0, :, :, 0].numpy()
        got = read_png(str(out / name))
        assert got.dtype == np.uint16 and got.shape == (IN_H, IN_W)
        assert np.abs(got / 256.0 - np.clip(want, 0, None)).max() <= 1 / 256
        gt = batch["disp_gt"][-1][0, :, :, 0]
        est = resize_disparity(want, gt.shape)
        ref = float(jax_calc_error(jnp.asarray(est), jnp.asarray(gt), lb=0,
                                   ub=192)["3px"])
        assert abs(p3[idx] - ref) <= 5e-4 + TOL


def test_no_cpu_fallback(kitti_split, monkeypatch):
    """Without a card, moving a batch and the CLI raise unless the CPU is
    asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    batch = {"x": np.zeros((2, 3), np.float32)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch_to_device(batch)
    assert batch_to_device(batch, "cpu")["x"].device.type == "cpu"
    root, annfile = kitti_split
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kitti_submission.main(["--config-file", KITTI, *TINY,
                               *_split_opts(root, annfile, "TEST")])
