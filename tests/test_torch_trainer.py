"""The port's ``Trainer`` (temporalstereo_tpu_torch.training.trainer)
against the JAX package's on the CPU, and its own checkpoint cadence,
image logs, ``test()``, CLI and failures.

Parity: both trainers fit the tiny f32 model (stage C=8) on a synthetic
SceneFlow annfile (4 samples of 96x128 noise PNGs read as [0, 1] images,
a ground truth valid at 30% of the pixels, B=1, single frame) from one
``.ckpt`` that the JAX package's ``export_reference_checkpoint`` wrote,
through ``TRAINER.LOAD_FROM_CHECKPOINT``: a FAST_DEV_RUN epoch (2 train
steps, 2 val batches) with SWA from step 0 and the BatchNorm re-estimate
over 1 batch, at a learning rate of 1e-6.  Then each resumes from its own
``checkpoints/`` for one more such epoch.  After each leg the step, the
SWA count, every parameter and BatchNorm statistic and the validation
table are compared.  The window is one frame, not two: on an 8-core CPU
the JAX trainer's fit and resume took 236 s at T=1 and 9 min at T=2, and
the temporal training step is held to JAX by
tests/test_torch_train_step.py.

The inputs and weights are those of tests/test_torch_train_step.py (its
weight recipe and seed, images in [0, 1], a sparse ground truth), where a
train-mode step at B=1 is well conditioned.  It is not everywhere: with
ImageNet-normalised images and other draws of the weights, JAX's own
train-mode forward moved its fine-stage hypotheses by up to 6.4 px under
1e-4 of input noise, and its coarse costs by 6e-4 under 1e-5, the size
of the difference between the two sides' float rounding; there the two
trainers' updates parted by up to 10% of a tensor's change.

Tolerances (those of tests/test_torch_train_step.py, whose docstring says
why):
  * parameters: max|d| <= 2e-2 * m + 2^-21 * max|p| + 1e-6 * M, m the
    change JAX's fit made to that tensor from the warm start, M the
    largest such change; 4 ulps where the step test allows 2, because
    the parameters at the end of a fit with SWA are the running average,
    which rounds again at every snapshot;
  * BatchNorm statistics: max|d| <= 1e-3 * max|ref|;
  * each value of the validation table within 2e-3 relative, the loss
    tolerance (the cascade's top-k amplifies float rounding);
  * the step, the SWA count and the warm start's tensor count exact.
"""
import contextlib
import json
import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec

from temporalstereo_tpu.config import get_cfg as jax_get_cfg
from temporalstereo_tpu.data import native as jax_native
from temporalstereo_tpu.data.formats import write_pfm
from temporalstereo_tpu.models import build_model as jax_build_model
from temporalstereo_tpu.models.backbone import TINY_GROUPS as JAX_TINY_GROUPS
from temporalstereo_tpu.training.state import TrainState as JaxTrainState
from temporalstereo_tpu.training.trainer import Trainer as JaxTrainer
from temporalstereo_tpu.utils.logging import MetricLogger as JaxMetricLogger
from temporalstereo_tpu.utils.torch_export import save_reference_checkpoint

from temporalstereo_tpu_torch.cli import train as train_cli
from temporalstereo_tpu_torch.config import get_cfg
from temporalstereo_tpu_torch.data.loader import (batch_to_device,
                                                  prefetch_to_device)
from temporalstereo_tpu_torch.models import build_model
from temporalstereo_tpu_torch.models.backbone import TINY_GROUPS
from temporalstereo_tpu_torch.training import trainer as trainer_module
from temporalstereo_tpu_torch.training.checkpoint import CheckpointManager
from temporalstereo_tpu_torch.training.trainer import Trainer
from temporalstereo_tpu_torch.utils.checkpoint import (load_weights,
                                                       read_state_dict)
from temporalstereo_tpu_torch.utils.convert import state_dict_from_jax

H, W = 96, 128
SAMPLES = 4
STATS_TOL, PARAM_TOL, FLOOR, TABLE_TOL = 1e-3, 2e-2, 1e-6, 2e-3
ULPS = 2 ** -21       # 4 f32 ulps: 2 of the steps, 2 of the SWA average
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """A SceneFlow annfile of 4 samples with frames -1 and 0."""
    root = tmp_path_factory.mktemp("sceneflow")
    rng = np.random.RandomState(0)
    items = []
    for idx in range(SAMPLES):
        item = {}
        for fi in (-1, 0):
            lp, rp, dp = (f"L_{idx}_{fi}.png", f"R_{idx}_{fi}.png",
                          f"D_{idx}_{fi}.pfm")
            for name in (lp, rp):
                Image.fromarray((rng.rand(H, W, 3) * 255).astype(
                    np.uint8)).save(root / name)
            gt = rng.uniform(1, 40, (H, W)).astype(np.float32)
            gt[rng.rand(H, W) < 0.7] = np.nan          # invalid
            write_pfm(str(root / dp), gt)
            item[str(fi)] = {"left_image_path": lp, "right_image_path": rp,
                             "left_disp_path": dp}
        items.append(item)
    (root / "ann.json").write_text(json.dumps(items))
    return str(root)


def _opts(root, log_dir, frames=(0,), batch=1):
    opts = ["LOG_DIR", str(log_dir),
            "TRAINER.MAX_EPOCHS", "1",
            "TRAINER.FAST_DEV_RUN", "True",
            "TRAINER.PRECISION", "f32",
            "TRAINER.SWA.START_FRACTION", "0.0",
            "TRAINER.SWA.BN_UPDATE_STEPS", "1",
            "MODEL.BACKBONE.VARIANT", "tiny",
            "MODEL.AGGREGATION.COARSE.C", "8",
            "MODEL.AGGREGATION.FINE.C", "8",
            "MODEL.AGGREGATION.PRECISE.C", "8",
            "VAL.EVAL_DISPARITY_IDS", "[0, 1]",
            "VAL.VIS_BATCH_INDEX", "0",
            "OPTIMIZER.RMSPROP.LR", "1e-6",
            "FRAME_IDXS", str(list(frames))]
    if len(frames) > 1:
        opts += ["MODEL.WITH_PREVIOUS", "True", "MODEL.USE_PAST_COST", "True",
                 "MODEL.LOCAL_MAP_SIZE", "3",
                 "MODEL.BACKBONE.MEMORY_PERCENT", "0.5"]
    for phase in ("TRAIN", "VAL", "TEST"):
        opts += [f"DATA.{phase}.DATA_ROOT", root,
                 f"DATA.{phase}.ANNFILE", os.path.join(root, "ann.json"),
                 f"DATA.{phase}.TYPE", "SceneFlow",
                 f"DATA.{phase}.HEIGHT", str(H),
                 f"DATA.{phase}.WIDTH", str(W),
                 f"DATA.{phase}.BATCH_SIZE", str(batch),
                 f"DATA.{phase}.NUM_WORKERS", "1",
                 f"DATA.{phase}.PROCESS_WORKERS", "False",
                 f"DATA.{phase}.MEAN", "(0.0, 0.0, 0.0)",
                 f"DATA.{phase}.STD", "(1.0, 1.0, 1.0)",
                 f"DATA.{phase}.FRAME_IDXS", str(list(frames))]
    return opts


def _shapes(jmodel):
    x = jax.ShapeDtypeStruct((1, H, W, 3), jnp.float32)
    return jax.eval_shape(
        lambda r, x: jmodel.init({"params": r}, x, x, None, False),
        jax.random.PRNGKey(0), x)


def _random_variables(shapes, seed=41):
    """The weights of tests/test_torch_train_step.py (its recipe and
    seed): conv kernels N(0, 1/fan_in), BatchNorm affine parameters and
    running statistics away from identity, small biases, numpy draws."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            v = rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ("scale", "var"):
            v = rng.rand(*s.shape) * 0.5 + 0.75
        elif name in ("bias", "mean"):
            v = rng.randn(*s.shape) * 0.1
        else:
            v = np.zeros(s.shape)
        return jnp.asarray(v, jnp.float32)
    return {c: jax.tree_util.tree_map_with_path(leaf, shapes[c])
            for c in ("params", "batch_stats")}


@pytest.fixture(scope="module")
def init_ckpt(split, tmp_path_factory):
    """(path, shapes): the warm start of both trainers."""
    jmodel = jax_build_model(jax_get_cfg(opts=_opts(split, "unused")),
                             dtype=None)
    shapes = _shapes(jmodel)
    path = str(tmp_path_factory.mktemp("weights") / "init.ckpt")
    save_reference_checkpoint(_random_variables(shapes), path,
                              JAX_TINY_GROUPS)
    return path, shapes


@contextlib.contextmanager
def _fast_jax(shapes):
    """jax.jit with XLA's CPU optimisations off, the JAX trainer's random
    init replaced by zeros of the same shapes, and the JAX loader's colour
    jitter on its numpy path."""
    jit = jax.jit

    def fast_jit(fun=None, **kw):
        kw.setdefault("compiler_options", FAST_COMPILE)
        return (lambda f: jit(f, **kw)) if fun is None else jit(fun, **kw)

    def zeros_init(self, with_swa):
        v = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
        return JaxTrainState.create(v["params"], v["batch_stats"], self.tx,
                                    with_swa=with_swa)
    init, jitter = JaxTrainer._init_state, jax_native.color_jitter_inplace
    jax.jit, JaxTrainer._init_state = fast_jit, zeros_init
    jax_native.color_jitter_inplace = lambda *args: None
    try:
        yield
    finally:
        jax.jit, JaxTrainer._init_state = jit, init
        jax_native.color_jitter_inplace = jitter


def _log(exp_dir):
    """(warm-start count, validation lines of metrics.jsonl)."""
    with open(os.path.join(exp_dir, "log.txt")) as f:
        counts = re.findall(r"warm-started (\d+) tensors", f.read())
    with open(os.path.join(exp_dir, "tb", "metrics.jsonl")) as f:
        val = [r for r in map(json.loads, f) if any(
            k.startswith("val/") for k in r)]
    return [int(c) for c in counts], val


def _jax_leg(trainer):
    state = trainer.state
    sd = state_dict_from_jax(state.params, state.batch_stats, TINY_GROUPS)
    return {"step": int(state.step), "swa_count": int(state.swa_count),
            "sd": {k: v.numpy() for k, v in sd.items()},
            "log": _log(trainer.exp_dir)}


def _port_leg(trainer):
    state = trainer.state
    sd = {**state.params, **state.batch_stats}
    return {"step": state.step, "swa_count": state.swa_count,
            "sd": {k: v.numpy() for k, v in sd.items()},
            "log": _log(trainer.exp_dir)}


@pytest.fixture(scope="module")
def jax_legs(split, init_ckpt, tmp_path_factory):
    """The JAX trainer's fit and its resume (the one JAX fit of the
    suite's port tests)."""
    path, shapes = init_ckpt
    opts = _opts(split, tmp_path_factory.mktemp("jax"))
    legs = []
    with _fast_jax(shapes):
        trainer = JaxTrainer(jax_get_cfg(
            opts=opts + ["TRAINER.LOAD_FROM_CHECKPOINT", path]))
        replicated = NamedSharding(trainer.mesh, PartitionSpec())
        trainer.state = jax.device_put(trainer.state, replicated)
        trainer.fit()
        legs.append(_jax_leg(trainer))
        trainer.metrics.close()
        trainer.metrics = JaxMetricLogger(os.path.join(trainer.exp_dir,
                                                       "tb"))
        trainer.cfg = jax_get_cfg(opts=opts + [
            "TRAINER.RESUME_FROM_CHECKPOINT",
            os.path.join(trainer.exp_dir, "checkpoints")])
        trainer._maybe_restore()
        trainer.state = jax.device_put(trainer.state, replicated)
        trainer.train_loader.epoch = trainer.val_loader.epoch = 0
        trainer.fit()
        legs.append(_jax_leg(trainer))
        trainer.metrics.close()
    return legs


@pytest.fixture(scope="module")
def port_legs(split, init_ckpt, tmp_path_factory):
    path, _ = init_ckpt
    opts = _opts(split, tmp_path_factory.mktemp("port"))
    trainer = Trainer(get_cfg(
        opts=opts + ["TRAINER.LOAD_FROM_CHECKPOINT", path]), device="cpu")
    trainer.fit()
    legs = [_port_leg(trainer)]
    trainer.close()
    ckpt_dir = os.path.join(trainer.exp_dir, "checkpoints")
    trainer = Trainer(get_cfg(
        opts=opts + ["TRAINER.RESUME_FROM_CHECKPOINT", ckpt_dir]),
        device="cpu")
    saved = CheckpointManager(ckpt_dir).read()
    restored = {"params": trainer.state.params,
                "batch_stats": trainer.state.batch_stats,
                "swa_params": trainer.state.swa_params,
                "opt_state": trainer.state.opt_state,
                "swa_count": trainer.state.swa_count}
    legs.append({"restored": restored, "saved": saved,
                 "restored_step": trainer.state.step})
    trainer.fit()
    legs[-1].update(_port_leg(trainer))
    trainer.close()
    return legs


@pytest.mark.parametrize("leg", [0, 1], ids=["fit", "resume"])
def test_fit_matches_jax(jax_legs, port_legs, init_ckpt, leg):
    init = {k: v.numpy() for k, v in read_state_dict(init_ckpt[0]).items()}
    jax_leg, port_leg = jax_legs[leg], port_legs[leg]
    assert port_leg["step"] == jax_leg["step"] == 2 * (leg + 1)
    assert port_leg["swa_count"] == jax_leg["swa_count"] == 2 * (leg + 1)

    (port_counts, port_val), (jax_counts, jax_val) = (port_leg["log"],
                                                     jax_leg["log"])
    assert port_counts == jax_counts and port_counts[0] > 0
    assert port_counts[0] == len(port_leg["sd"])   # every tensor warm-started
    assert len(port_val) == len(jax_val) == leg + 1
    for p, j in zip(port_val, jax_val):
        assert p.keys() == j.keys() and p["step"] == j["step"]
        for k in j:
            assert abs(p[k] - j[k]) <= TABLE_TOL * abs(j[k]), (k, p[k], j[k])

    moved = {k: float(np.abs(jax_leg["sd"][k] - init[k]).max())
             for k in port_leg["sd"] if "running" not in k}
    assert max(moved.values()) > 1e-7
    for k, p in port_leg["sd"].items():
        ref = jax_leg["sd"][k]
        err = float(np.abs(p - ref).max())
        top = float(np.abs(ref).max())
        if "running" in k:
            assert err <= STATS_TOL * top, f"statistic {k}: {err:.3g}"
        else:
            assert err <= (PARAM_TOL * moved[k] + ULPS * top
                           + FLOOR * max(moved.values())), \
                f"parameter {k}: {err:.3g}"


def test_resume_restores_the_saved_state_bit_equal(port_legs):
    """The resumed trainer holds exactly what the checkpoint holds, and its
    step carries on from it.  The checkpoint is the first leg's epoch-end
    save: its final save after the SWA finish is at the same step and, as
    with the JAX package's orbax manager, not written."""
    resumed = port_legs[1]
    saved, restored = resumed["saved"], resumed["restored"]
    assert resumed["restored_step"] == saved["step"] == 2
    assert resumed["step"] == 4
    for part in ("params", "batch_stats", "swa_params"):
        assert saved[part].keys() == restored[part].keys()
        for k, v in saved[part].items():
            assert torch.equal(v, restored[part][k]), (part, k)
    assert restored["swa_count"] == saved["swa_count"] == 2
    saved_opt = _leaves(saved["opt_state"])
    restored_opt = _leaves(restored["opt_state"])
    assert len(saved_opt) == len(restored_opt) > 0
    for a, b in zip(saved_opt, restored_opt):
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _port_trainer(split, log_dir, extra=(), frames=(0,), batch=1):
    return Trainer(get_cfg(opts=_opts(split, log_dir, frames, batch)
                           + list(extra)), device="cpu")


@pytest.mark.parametrize("every_n_steps, every_n_epochs, keep, want", [
    (1, 1, 2, [3, 4]), (3, 1, -1, [2, 3, 4])],
    ids=["every_step_keep_2", "every_3_steps_and_epoch"])
def test_checkpoint_cadence(split, tmp_path, every_n_steps, every_n_epochs,
                            keep, want):
    """Two epochs of 2 steps (B=2), no validation, no SWA: checkpoints at
    the train-step and epoch cadences, a step already saved is not saved
    again, KEEP keeps the newest, hparams for every save."""
    trainer = _port_trainer(split, tmp_path, [
        "TRAINER.FAST_DEV_RUN", "False", "TRAINER.MAX_EPOCHS", "2",
        "TRAINER.CHECK_VAL_EVERY_N_EPOCHS", "100",
        "TRAINER.SWA.ENABLED", "False",
        "CHECKPOINT.EVERY_N_TRAIN_STEPS", str(every_n_steps),
        "CHECKPOINT.EVERY_N_EPOCHS", str(every_n_epochs),
        "CHECKPOINT.KEEP", str(keep)], batch=2)
    trainer.fit()
    trainer.close()
    assert trainer.state.step == 4
    assert trainer.ckpt.all_steps() == want
    assert trainer.ckpt.read()["step"] == 4
    assert trainer.ckpt.load_hparams()["CHECKPOINT"]["KEEP"] == keep
    weights = os.path.join(trainer.exp_dir, "weights_final.pth")
    fresh = build_model(trainer.cfg, device="cpu", seed=1)
    assert load_weights(fresh, weights) == (len(trainer.state.params)
                                            + len(trainer.state.batch_stats))
    for k, p in trainer.state.params.items():
        assert torch.equal(fresh.state_dict()[k], p), k


def test_swa_finish_keeps_masters_and_optimizer(split, tmp_path):
    """The SWA finish swaps the average into the masters and re-estimates
    only the BatchNorm statistics: the optimizer state and the step stay,
    and the masters stay the average."""
    trainer = _port_trainer(split, tmp_path)
    trainer._train_epoch(0, fast_dev=True)
    before = trainer.state
    trainer._finalize_swa()
    after = trainer.state
    trainer.close()
    assert after.step == before.step == 2 and after.swa_count == 2
    assert after.opt_state is before.opt_state
    for k, v in before.swa_params.items():
        assert torch.equal(after.params[k], v), k
    moved = [k for k, v in after.batch_stats.items()
             if not torch.equal(v, before.batch_stats[k])]
    assert moved, "the BatchNorm statistics were not re-estimated"


def test_image_logs(split, tmp_path):
    """Train and val image dumps of the temporal model (T=2): input,
    ground truth, each disparity and its error bar, the local map and the
    search ranges, as [H, W, 3] images in [0, 1]."""
    trainer = _port_trainer(split, tmp_path, [
        "VAL.VIS_BATCH_INDEX", "1", "TRAINER.VIS_EVERY_N_TRAIN_STEPS", "1"],
        frames=(-1, 0))
    images = {}
    trainer.metrics.log_image = (
        lambda step, name, image: images.setdefault(name, image))
    trainer._train_epoch(0, fast_dev=True)
    trainer.validate(0)
    trainer.close()
    for prefix in ("train_", "val/"):
        names = {n[len(prefix):] for n in images if n.startswith(prefix)}
        want = {f"{k}/0" for k in ["color_0_l", "disparity_gt", "local_map"]
                + [f"disparity_{i}" for i in range(4)]
                + [f"disp_errorbar_{i}" for i in range(4)]}
        assert want <= names, sorted(want - names)
        ranges = {n.split("/")[0] for n in names if "search_range" in n}
        assert ranges and all(
            {f"low_disparity_{r[-1]}/0", f"high_disparity_{r[-1]}/0"}
            <= names for r in ranges), sorted(names)
    for name, image in images.items():
        assert image.ndim == 3 and image.shape[2] == 3, name
        assert np.isfinite(image).all(), name
        rows = H + 50 if "errorbar" in name else H
        if "local_map" in name:      # its channels stacked: 1 at T=2
            rows = image.shape[0] // H * H
        assert image.shape[:2] == (rows, W), (name, image.shape)


def test_image_log_forward_failure_propagates(split, tmp_path, monkeypatch):
    """A failure of the image log's forward (the cost-base and softsplat
    kernels run there) ends the run; it is not swallowed."""
    trainer = _port_trainer(split, tmp_path, ["VAL.VIS_BATCH_INDEX", "1"])

    def broken(*args, **kwargs):
        raise RuntimeError("kernel launch failed")
    monkeypatch.setattr(trainer_module, "multi_frame_forward", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        trainer.validate(0)
    trainer.close()


def test_train_cli_fit_and_test(split, tmp_path):
    """``cli.train --device cpu``: fit, then ``test()`` on DATA.TEST; the
    checkpoints, ``weights_final.pth``, the val/ and test/ tables and the
    summary line."""
    train_cli.main(["--device", "cpu"] + _opts(split, tmp_path)
                   + ["TRAINER.VERSION", "cli"])
    exp = tmp_path / "TemporalStereo" / "cli"
    assert CheckpointManager(str(exp / "checkpoints")).all_steps() == [2]
    assert (exp / "weights_final.pth").exists()
    assert (exp / "code" / "temporalstereo_tpu_torch" / "training"
            / "trainer.py").exists()
    records = [json.loads(line) for line in
               (exp / "tb" / "metrics.jsonl").read_text().splitlines()]
    for prefix in ("val/", "test/"):
        row = [r for r in records if any(k.startswith(prefix) for k in r)]
        assert len(row) == 1
        assert np.isfinite(row[0][f"{prefix}metric_disparity_0/all_epe"])
    summary = (exp / "log.txt").read_text().splitlines()[-1]
    assert summary.startswith("train summary: ")
    timings = json.loads(summary[len("train summary: "):])
    assert timings["step"] == 2 and timings["step_s"]["n"] == 2
    assert timings["val_sample_s"]["n"] == 2 + 2


def test_trainer_refuses_without_a_card(split, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_cfg(opts=_opts(split, tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(_opts(split, tmp_path))
    assert not os.path.exists(tmp_path / "TemporalStereo")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="one process"):
        Trainer(cfg, device="cpu")


def test_prefetch_on_the_cpu_is_batch_to_device():
    rng = np.random.RandomState(3)
    batches = [{"left": rng.rand(1, 2, 4, 5, 3).astype(np.float32),
                "baseline": rng.rand(2).astype(np.float32)}
               for _ in range(3)]
    out = list(prefetch_to_device(iter(batches), 2, "cpu"))
    assert len(out) == 3
    for (dev, host), ref in zip(out, batches):
        assert host is ref
        want = batch_to_device(ref, "cpu")
        assert all(torch.equal(dev[k], want[k]) for k in want)
