"""``TPU.REMAT`` in the port: the BPTT training step (MODEL.PREVIOUS_WITH_
GRADIENT, every frame in train mode with gradients) with each frame's
activations recomputed in the backward (``torch.utils.checkpoint``) against
the same step without it, port against port on the CPU.  The port's plain
BPTT step is held to the JAX package by tests/test_torch_train_bptt.py.

Tolerances: the recompute runs the same CPU kernels on the same inputs, so
losses and gradients agree to 1e-6 of their size (in practice bit for bit)
and the BatchNorm running statistics are required identical: the
recompute must not blend them a second time.
"""
import contextlib
import pathlib

import numpy as np
import pytest
import torch

from temporalstereo_tpu_torch.config import get_cfg
from temporalstereo_tpu_torch.models import build_model
from temporalstereo_tpu_torch.models import temporal
from temporalstereo_tpu_torch.models.temporal import multi_frame_forward
from temporalstereo_tpu_torch.nn.layers import BatchNorm, recomputing
from temporalstereo_tpu_torch.training import (TrainState, build_optimizer,
                                               make_train_step, master_copies)
from temporalstereo_tpu_torch.training.optim import (GradientTransformation,
                                                     chain)

REPO = pathlib.Path(__file__).resolve().parents[1]
KITTI = str(REPO / "configs" / "kitti2015-multi.yaml")
TINY = ["MODEL.BACKBONE.VARIANT", "tiny",
        "MODEL.AGGREGATION.COARSE.C", "8",
        "MODEL.AGGREGATION.FINE.C", "8",
        "MODEL.AGGREGATION.PRECISE.C", "8",
        "TRAINER.PRECISION", "f32",
        "MODEL.PREVIOUS_WITH_GRADIENT", "True",
        "OPTIMIZER.RMSPROP.LR", "1e-6"]
H, W, T = 96, 128, 3
REL_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(t, seed):
    """A window of t frames as tests/test_torch_train_step.py builds it."""
    rng = np.random.RandomState(seed)
    T_cam = np.tile(np.eye(4, dtype=np.float32), (t, 1, 1, 1))
    for i in range(t):
        T_cam[i, 0, 0, 3], T_cam[i, 0, 2, 3] = 0.03 * i, -0.05 * i
    gt = rng.uniform(1.0, 40.0, (t, 1, H, W, 1)).astype(np.float32)
    gt[rng.rand(*gt.shape) < 0.7] = 0.0
    batch = {"left": rng.rand(t, 1, H, W, 3).astype(np.float32),
             "right": rng.rand(t, 1, H, W, 3).astype(np.float32),
             "disp_gt": gt, "T_cam": T_cam, "inv_T": np.linalg.inv(T_cam),
             "K": np.array([[[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]]],
                           np.float32),
             "baseline": np.array([2.0], np.float32)}
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _stash():
    """Passes the gradients on and keeps them as its state."""
    return GradientTransformation(
        lambda p: {k: torch.zeros_like(v) for k, v in p.items()},
        lambda g, s, p=None: (g, g))


def _step(remat):
    """One BPTT step of the seeded tiny model -> (metrics, gradients,
    statistics, the model's BatchNorm update count)."""
    cfg = get_cfg(KITTI, opts=TINY + ["TPU.REMAT", str(remat)])
    model = build_model(cfg, device="cpu", seed=3)
    state = TrainState.create(*master_copies(model),
                              chain(_stash(), build_optimizer(cfg, 10)))
    new, metrics = make_train_step(model, cfg)(state, _batch(T, seed=4))
    updates = sum(int(m.num_batches_tracked) for m in model.modules()
                  if isinstance(m, BatchNorm))
    return ({k: float(v) for k, v in metrics.items()}, new.opt_state[0],
            new.batch_stats, updates)


@pytest.fixture(scope="module")
def plain_step():
    return _step(False)


def test_remat_bptt_step_matches_plain(plain_step):
    """Same loss terms and gradients (1e-6 of their size) and identical
    BatchNorm statistics, each BatchNorm updated once per frame."""
    metrics, grads, stats, updates = plain_step
    r_metrics, r_grads, r_stats, r_updates = _step(True)
    assert set(r_metrics) == set(metrics)
    assert {f"{-i}_l1_loss_lvl0" for i in range(T)} <= set(metrics)
    for k, v in metrics.items():
        assert abs(r_metrics[k] - v) <= REL_TOL * abs(v), k
    top = max(float(g.abs().max()) for g in grads.values())
    assert top > 0
    for k, g in grads.items():
        err = float((r_grads[k] - g).abs().max())
        assert err <= REL_TOL * top, f"gradient {k}: {err:.3g}"
    for k, s in stats.items():
        assert torch.equal(r_stats[k], s), f"statistic {k}"
    assert r_updates == updates > 0


def test_remat_recompute_without_skip_changes_statistics(plain_step,
                                                         monkeypatch):
    """The statistics check has teeth: when the recompute is let update the
    BatchNorms (the fault put back), they are blended twice per frame and
    differ."""
    monkeypatch.setattr(temporal, "recomputing", contextlib.nullcontext)
    _, _, stats, updates = plain_step
    _, _, r_stats, r_updates = _step(True)
    assert r_updates > updates
    assert any(not torch.equal(r_stats[k], s) for k, s in stats.items())


def test_recomputing_context_leaves_statistics():
    """A train-mode BatchNorm inside ``recomputing()`` normalises with the
    batch statistics and updates nothing; outside it blends them in."""
    bn = BatchNorm(4)
    x = torch.randn(2, 4, 3, 5, generator=torch.Generator().manual_seed(0))
    with recomputing():
        y = bn(x)
    assert torch.equal(bn.running_mean, torch.zeros(4))
    assert int(bn.num_batches_tracked) == 0
    z = bn(x)
    assert torch.equal(y, z)
    assert not torch.equal(bn.running_mean, torch.zeros(4))


def test_remat_without_bptt_is_the_plain_window():
    """Without BPTT nothing is checkpointed: the final frame's outputs are
    bit-equal with and without ``remat``."""
    cfg = get_cfg(KITTI, opts=TINY[:-4])
    model = build_model(cfg, device="cpu", seed=3)
    batch = _batch(2, seed=5)
    outs = [multi_frame_forward(model, batch, train=False, remat=r)[0]
            for r in (False, True)]
    for a, b in zip(outs[0]["disps"], outs[1]["disps"]):
        assert torch.equal(a, b)
