"""The port's checkpoints, weights files, warm starts, logging, trainer
config keys and ``sanity_train``'s synthetic batches against the JAX
package's own functions on the CPU (no JAX ``Trainer``).

  * ``CheckpointManager``: the same sequence of saves (a step saved twice,
    a lower step, ``keep``) leaves the same steps as orbax's manager does
    and restores the same values, exactly; hparams the same dict;
  * ``save_weights`` / ``load_any_weights`` / ``warm_start`` against the
    JAX package's msgpack round trip, and a partial ``.ckpt`` (no
    backbone, one reshaped entry) against its ``load_any_weights``: the
    same count and bit-equal tensors;
  * the backbone warm start from a timm-named state_dict against
    ``utils/torch_import.py:warm_start_backbone``: the same count and
    bit-equal tensors;
  * ``format_error_table``, ``MetricLogger``'s JSONL and
    ``FileWriter.log_time``: the same strings;
  * every CHECKPOINT and TRAINER key, TPU.HOST_PREFETCH and
    MODEL.BACKBONE.PRETRAINED equal in the defaults and two YAMLs;
  * ``sanity_train.make_synthetic_batch`` bit-equal for the same seed.
"""
import json
import pathlib

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from temporalstereo_tpu.cli import sanity_train as jax_sanity
from temporalstereo_tpu.config import get_cfg as jax_get_cfg
from temporalstereo_tpu.models import build_model as jax_build_model
from temporalstereo_tpu.models.backbone import TINY_GROUPS as JAX_TINY_GROUPS
from temporalstereo_tpu.training import checkpoint as jax_ckpt
from temporalstereo_tpu.training.state import TrainState as JaxTrainState
from temporalstereo_tpu.utils import logging as jax_logging
from temporalstereo_tpu.utils.torch_export import save_reference_checkpoint
from temporalstereo_tpu.utils.torch_import import (
    warm_start_backbone as jax_warm_start_backbone)

from temporalstereo_tpu_torch.cli import sanity_train
from temporalstereo_tpu_torch.config import get_cfg
from temporalstereo_tpu_torch.models.backbone import TINY_GROUPS
from temporalstereo_tpu_torch.training import TrainState
from temporalstereo_tpu_torch.training import checkpoint as ckpt
from temporalstereo_tpu_torch.training.optim import rmsprop
from temporalstereo_tpu_torch.utils import logging as port_logging
from temporalstereo_tpu_torch.utils.convert import state_dict_from_jax

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = ["MODEL.BACKBONE.VARIANT", "tiny",
        "MODEL.AGGREGATION.COARSE.C", "8",
        "MODEL.AGGREGATION.FINE.C", "8",
        "MODEL.AGGREGATION.PRECISE.C", "8",
        "TRAINER.PRECISION", "f32"]


@pytest.fixture(scope="module")
def jax_variables():
    """Random variables of the tiny single-frame model (numpy draws over
    the JAX model's shapes)."""
    jmodel = jax_build_model(jax_get_cfg(opts=TINY), dtype=None)
    x = jax.ShapeDtypeStruct((1, 96, 128, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda r, x: jmodel.init({"params": r}, x, x, None, False),
        jax.random.PRNGKey(0), x)
    rng = np.random.RandomState(9)

    def leaf(s):
        return jnp.asarray(rng.randn(*s.shape), jnp.float32)
    return {c: jax.tree.map(leaf, shapes[c])
            for c in ("params", "batch_stats")}


def _masters(variables):
    """(params, batch_stats) of the port: the JAX variables by the port's
    names, split as ``master_copies`` splits them."""
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"],
                             TINY_GROUPS)
    stats = {k: v for k, v in sd.items()
             if k.endswith(("running_mean", "running_var"))}
    params = {k: v for k, v in sd.items()
              if k not in stats and not k.endswith("num_batches_tracked")}
    return params, stats


def _zeros(tree):
    return {k: torch.zeros_like(v) for k, v in tree.items()}


def test_checkpoint_manager_matches_orbax(tmp_path):
    """A step saved twice keeps its first contents, a step below the
    latest is not written, ``keep`` keeps the newest: as orbax does."""
    def jax_state(v):
        s = JaxTrainState.create({"w": jnp.full((3,), v)},
                                 {"bn": {"mean": jnp.full((2,), -v)}},
                                 optax.rmsprop(0.1), with_swa=True)
        return s.replace(step=jnp.asarray(int(v), jnp.int32),
                         swa_count=jnp.asarray(int(v) + 1, jnp.int32))

    def port_state(v):
        s = TrainState.create({"w": torch.full((3,), v)},
                              {"bn.running_mean": torch.full((2,), -v)},
                              rmsprop(lambda step: 0.1), with_swa=True)
        return TrainState(step=int(v), params=s.params,
                          batch_stats=s.batch_stats, opt_state=s.opt_state,
                          tx=s.tx, swa_params=s.swa_params,
                          swa_count=int(v) + 1)

    jmgr = jax_ckpt.CheckpointManager(str(tmp_path / "jax"), keep=2)
    pmgr = ckpt.CheckpointManager(str(tmp_path / "port"), keep=2)
    hparams = {"TRAINER": {"MAX_EPOCHS": 3, "NAME": "x"}, "LR": 1e-4}
    written = []
    for step, v in [(2, 2.0), (2, 7.0), (1, 1.0), (4, 4.0), (6, 6.0)]:
        jmgr.save(step, jax_state(v), hparams=hparams)
        written.append(pmgr.save(step, port_state(v), hparams=hparams))
    assert written == [True, False, False, True, True]
    assert pmgr.all_steps() == list(jmgr.mgr.all_steps()) == [4, 6]
    assert pmgr.latest_step() == jmgr.latest_step() == 6
    assert pmgr.load_hparams() == jmgr.load_hparams() == hparams
    assert pmgr.load_hparams(2) == jmgr.load_hparams(2) == hparams

    for step in (4, 6):
        j = jmgr.restore(jax_state(0.0), step=step)
        p = pmgr.restore(port_state(0.0), step=step)
        assert p.step == int(j.step) == step
        assert p.swa_count == int(j.swa_count) == step + 1
        np.testing.assert_array_equal(p.params["w"].numpy(),
                                      np.asarray(j.params["w"]))
        np.testing.assert_array_equal(
            p.batch_stats["bn.running_mean"].numpy(),
            np.asarray(j.batch_stats["bn"]["mean"]))
        np.testing.assert_array_equal(p.swa_params["w"].numpy(),
                                      np.asarray(j.swa_params["w"]))
    with pytest.raises(FileNotFoundError):
        ckpt.CheckpointManager(str(tmp_path / "empty")).restore(port_state(0))


def test_weights_round_trip_matches_jax(jax_variables, tmp_path):
    """Standalone weights: the JAX package's msgpack round trip and
    ``warm_start`` into fresh trees against the port's ``.pth``
    (``save_weights``, ``load_any_weights``): the same count, the same
    tensors; and a ``CheckpointManager`` directory as the source."""
    jp, js = jax_variables["params"], jax_variables["batch_stats"]
    jpath = str(tmp_path / "w.msgpack")
    jax_ckpt.save_weights(jpath, jp, js)
    zeros = jax.tree.map(jnp.zeros_like, jax_variables)
    jparams, jstats, jn = jax_ckpt.warm_start(
        zeros["params"], zeros["batch_stats"], jax_ckpt.load_weights(jpath))

    params, stats = _masters(jax_variables)
    ppath = str(tmp_path / "weights_final.pth")
    ckpt.save_weights(ppath, params, stats)
    pparams, pstats, pn = ckpt.load_any_weights(_zeros(params),
                                                _zeros(stats), ppath)
    assert pn == jn == len(jax.tree.leaves(jax_variables))
    want = state_dict_from_jax(jparams, jstats, TINY_GROUPS)
    for k, v in {**pparams, **pstats}.items():
        assert torch.equal(v, want[k]), k

    mgr = ckpt.CheckpointManager(str(tmp_path / "checkpoints"))
    mgr.save(3, TrainState.create(params, stats, rmsprop(lambda s: 0.1)))
    dparams, dstats, dn = ckpt.load_any_weights(
        _zeros(params), _zeros(stats), str(tmp_path / "checkpoints"))
    assert dn == pn
    assert all(torch.equal(dparams[k], pparams[k]) for k in params)


def test_partial_checkpoint_matches_jax(jax_variables, tmp_path):
    """A reference ``.ckpt`` without the backbone and with one reshaped
    entry merges into fresh trees as the JAX package's
    ``load_any_weights`` merges it."""
    path = str(tmp_path / "partial.ckpt")
    n_saved = save_reference_checkpoint(jax_variables, path, JAX_TINY_GROUPS)
    assert n_saved > 0
    payload = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k: v for k, v in payload["state_dict"].items()
          if not k.startswith("backbone.")}
    reshaped = next(k for k in sd if k.endswith("weight") and sd[k].dim() == 4)
    sd[reshaped] = sd[reshaped][:-1].clone()      # one channel fewer
    torch.save({"state_dict": sd}, path)

    zeros = jax.tree.map(jnp.zeros_like, jax_variables)
    merged, jn = jax_ckpt.load_any_weights(zeros, path)
    params, stats = _masters(jax_variables)
    pparams, pstats, pn = ckpt.load_any_weights(_zeros(params),
                                                _zeros(stats), path)
    assert pn == jn
    assert 0 < pn < len(params) + len(stats)
    want = state_dict_from_jax(merged["params"], merged["batch_stats"],
                               TINY_GROUPS)
    for k, v in {**pparams, **pstats}.items():
        assert torch.equal(v, want[k]), k
    assert not pparams["backbone.conv_stem.weight"].any()
    assert not pparams[reshaped].any()


def _timm_names(name):
    """The port's backbone trunk name -> timm's (stage flat index S of
    group g, stage s)."""
    parts = name.split(".")[1:]
    if parts[0] in ("conv_stem", "bn1"):
        return ".".join(parts)
    if not parts[0].startswith("block"):
        return None
    g, s = int(parts[0][len("block"):]), int(parts[1])
    flat = sum(len(group) for group in TINY_GROUPS[:g]) + s
    return ".".join(["blocks", str(flat)] + parts[2:])


def test_backbone_warm_start_matches_jax(jax_variables, tmp_path):
    """A timm EfficientNetV2 state_dict (random tensors under timm's names
    for the tiny trunk, plus timm's head and ``num_batches_tracked``)
    warm-starts the same tensors, with the same count, as the JAX
    package's ``warm_start_backbone``."""
    params, stats = _masters(jax_variables)
    rng = np.random.RandomState(4)
    timm = {}
    for k, v in {**params, **stats}.items():
        name = _timm_names(k) if k.startswith("backbone.") else None
        if name is not None:
            timm[name] = torch.from_numpy(
                rng.randn(*v.shape).astype(np.float32))
            if name.endswith("running_var"):
                timm[name[:-len("running_var")] + "num_batches_tracked"] = (
                    torch.tensor(5))
    timm["conv_head.weight"] = torch.ones(8, 4, 1, 1)
    timm["bn2.weight"] = torch.ones(8)
    timm["classifier.weight"] = torch.ones(10, 8)
    path = str(tmp_path / "efficientnetv2_rw_s.pth")
    torch.save({"state_dict": timm}, path)

    zeros = jax.tree.map(jnp.zeros_like, jax_variables)
    merged, jn = jax_warm_start_backbone(zeros, path, JAX_TINY_GROUPS)
    pparams, pstats, pn = ckpt.warm_start_backbone(
        _zeros(params), _zeros(stats), path, TINY_GROUPS)
    trunk = [k for k in timm if "num_batches" not in k
             and not k.startswith(("conv_head", "bn2", "classifier"))]
    assert pn == jn == len(trunk)
    want = state_dict_from_jax(merged["params"], merged["batch_stats"],
                               TINY_GROUPS)
    for k, v in {**pparams, **pstats}.items():
        assert torch.equal(v, want[k]), k
    assert pparams["backbone.block3.1.1.se.conv_reduce.bias"].any()
    assert not pparams["backbone.conv32.weight"].any()


@pytest.mark.parametrize("means", [
    {"metric_disparity_0/all_epe": 1.23, "metric_disparity_0/all_3px": 0.05,
     "metric_disparity_0/occ_epe": 2.5, "metric_disparity_1/all_epe": 1.5,
     "loss": 0.7},
    {"metric_disparity_3/noc_1px": 12.345678, "metric_disparity_2/all": 3.0,
     "grad_norm": 1e5, "metric_x": -0.5},
    {}], ids=["regions", "odd_keys", "empty"])
def test_format_error_table_matches_jax(means):
    assert (port_logging.format_error_table(means)
            == jax_logging.format_error_table(means))


def test_metric_logger_and_file_writer_match_jax(tmp_path):
    """The JSONL records and the step line (without an ETA) are the same
    strings; images are written only where TensorBoard is."""
    for name, mod in (("jax", jax_logging), ("port", port_logging)):
        logger = mod.MetricLogger(str(tmp_path / name))
        logger.log_scalars(3, {"loss": np.float32(0.25), "epe": 1.5},
                           prefix="train/")
        logger.log_scalars(4, {"a": 2})
        logger.close()
    lines = [(tmp_path / n / "metrics.jsonl").read_text()
             for n in ("jax", "port")]
    assert lines[0] == lines[1]
    assert json.loads(lines[1].splitlines()[0]) == {
        "step": 3, "train/loss": 0.25, "train/epe": 1.5}

    writer = port_logging.FileWriter(str(tmp_path / "log"))
    writer.log_time(12, 1, 3, 4, 0.5, 0.123456)
    writer.close()
    text = (tmp_path / "log" / "log.txt").read_text().splitlines()
    assert text[0].startswith("python: ")
    jwriter = jax_logging.FileWriter(str(tmp_path / "jlog"))
    jwriter.log_time(12, 1, 3, 4, 0.5, 0.123456)
    jtext = (tmp_path / "jlog" / "log.txt").read_text().splitlines()
    assert text[-1] == jtext[-1]


def _trainer_keys(cfg):
    keys = {f"CHECKPOINT.{k}": v for k, v in cfg.CHECKPOINT.items()}
    keys.update({f"TRAINER.{k}": v for k, v in cfg.TRAINER.items()
                 if k != "SWA"})
    keys.update({f"TRAINER.SWA.{k}": v for k, v in cfg.TRAINER.SWA.items()})
    keys["TPU.HOST_PREFETCH"] = cfg.TPU.HOST_PREFETCH
    keys["MODEL.BACKBONE.PRETRAINED"] = cfg.MODEL.BACKBONE.PRETRAINED
    return keys


@pytest.mark.parametrize("config", ["", "kitti2015-multi.yaml",
                                    "sceneflow.yaml"])
def test_trainer_config_keys_match_jax(config):
    path = str(REPO / "configs" / config) if config else ""
    port, ref = _trainer_keys(get_cfg(path)), _trainer_keys(jax_get_cfg(path))
    assert port == ref
    assert len(port) >= 3 + 12 + 4 + 2


@pytest.mark.parametrize("t, tx", [(1, 0.0), (3, 0.05)],
                         ids=["single_frame", "video"])
def test_sanity_batch_matches_jax(t, tx):
    """``make_synthetic_batch`` from the same RandomState: every array
    bit-equal, and the generator left in the same state."""
    rngs = np.random.RandomState(7), np.random.RandomState(7)
    port = sanity_train.make_synthetic_batch(rngs[0], 2, 48, 64, t=t, tx=tx)
    ref = jax_sanity.make_synthetic_batch(rngs[1], 2, 48, 64, t=t, tx=tx)
    assert port.keys() == ref.keys()
    for k, v in ref.items():
        assert port[k].dtype == v.dtype and port[k].shape == v.shape, k
        np.testing.assert_array_equal(port[k], v, err_msg=k)
    assert port["left"].shape == (t, 2, 48, 64, 3)
    assert rngs[0].rand() == rngs[1].rand()
