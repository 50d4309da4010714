"""The port's training step (temporalstereo_tpu_torch.training) against the
JAX package's ``make_train_step`` on the CPU.

The tiny temporal model of tests/test_torch_model.py, f32, in the
configuration of configs/kitti2015-multi.yaml (RMSProp at 1e-4 with the 0.1
global-norm clip, sparse smooth-L1 + Wasserstein losses, past cost, a
3-channel local map, 0.5 backbone memory), over a window of T=3 frames so
that the local map grows.  Both sides start from the same weights (the JAX
variables moved by ``state_dict_from_jax``) and take the same numpy batch.
Each side's optimizer is chained behind a transformation that keeps the raw
gradients in the optimizer state, so the gradients that the step itself
computed are compared.  The JAX side runs jitted at
``default_matmul_precision("highest")``.

Tolerances, and why:
  * loss terms: 2e-3 relative, as the model's single-frame parity
    (tests/test_torch_model.py): the cascade's top-k and sort amplify
    float-rounding differences near ties;
  * every gradient tensor: max|d| <= 1e-2 * max|ref| + 1e-6 * G, G the
    largest gradient of the model: the same discontinuities, seen through
    the backward's sums.  The floor is for the biases of convolutions that
    feed a train-mode BatchNorm: their gradient is exactly 0 in exact
    arithmetic (the normalisation removes a per-channel constant), and both
    sides hold only rounding noise there, ~1e-8 G;
  * BatchNorm running statistics after the step: max|d| <= 1e-3 * max|ref|
    (one update of 0.1 of a batch statistic);
  * parameters after two steps: max|d| <= 2e-2 * m + 2^-22 * max|p|
    + 1e-6 * M, m the change the two JAX steps made to that tensor, p the
    tensor and M the largest change: RMSProp divides each gradient by its
    own running root mean square, so a gradient's relative error carries
    into its update; each parameter rounds to f32 (2 ulps); and the noise
    of the zero gradients above moves its bias by ~1e-10.

The steps run at a learning rate of 1e-6, not the YAML's 1e-4 (the
optimizer itself is held to optax at the YAML's rate in
tests/test_torch_train_ops.py).  At 1e-4 the first step's parameter
differences (up to 1e-2 of its update) move the second step's forward
enough to flip near-ties of the cascade's top-k and sort: 2% apart in the
BPTT loss.  At 1e-6 the second step starts from weights that differ by
float rounding only.

The JAX step is compiled with XLA's CPU backend optimisations off, which
shortens its compile (the result agrees to float rounding).
"""
import pathlib

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from temporalstereo_tpu.config import get_cfg as jax_get_cfg
from temporalstereo_tpu.models import build_model as jax_build_model
from temporalstereo_tpu.models.temporal import (
    multi_frame_forward as jax_multi_frame_forward)
from temporalstereo_tpu.training import TrainState as JaxTrainState
from temporalstereo_tpu.training import build_optimizer as jax_optimizer
from temporalstereo_tpu.training import make_train_step as jax_train_step
from temporalstereo_tpu.training.step import build_losses as jax_build_losses
from temporalstereo_tpu.training.step import (
    compute_losses as jax_compute_losses)

from temporalstereo_tpu_torch.config import get_cfg
from temporalstereo_tpu_torch.models import build_model, multi_frame_forward
from temporalstereo_tpu_torch.models.backbone import TINY_GROUPS
from temporalstereo_tpu_torch.training import (GradientTransformation,
                                               TrainState, build_losses,
                                               build_optimizer,
                                               compute_losses,
                                               make_train_step, master_copies)
from temporalstereo_tpu_torch.training.optim import chain
from temporalstereo_tpu_torch.utils.convert import state_dict_from_jax

REPO = pathlib.Path(__file__).resolve().parents[1]
KITTI = str(REPO / "configs" / "kitti2015-multi.yaml")
TINY = ["MODEL.BACKBONE.VARIANT", "tiny",
        "MODEL.AGGREGATION.COARSE.C", "8",
        "MODEL.AGGREGATION.FINE.C", "8",
        "MODEL.AGGREGATION.PRECISE.C", "8",
        "TRAINER.PRECISION", "f32"]
NO_PYRAMID = ["MODEL.AGGREGATION.FINE.BLOCK_COST_SCALE", "0",
              "MODEL.AGGREGATION.PRECISE.BLOCK_COST_SCALE", "0"]
H, W = 96, 128
LOSS_TOL, GRAD_TOL, STATS_TOL, PARAM_TOL, FLOOR = 2e-3, 1e-2, 1e-3, 2e-2, 1e-6
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _jax_variables(jmodel, seed):
    """Random variables drawn with numpy from the JAX model's variable
    shapes: conv kernels N(0, 1/fan_in), non-trivial BN affine parameters
    and running statistics, small biases."""
    x = jax.ShapeDtypeStruct((1, H, W, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda r, x: jmodel.init({"params": r}, x, x, None, False),
        jax.random.PRNGKey(0), x)
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
        return np.asarray(v, np.float32)
    return {c: jax.tree_util.tree_map_with_path(leaf, shapes[c])
            for c in ("params", "batch_stats")}


def _batch(t, seed):
    """A window of t frames: images, a sparse positive disparity ground
    truth (0 = invalid), a slow sideways-forward camera motion, K and the
    baseline."""
    rng = np.random.RandomState(seed)
    T_cam = np.tile(np.eye(4, dtype=np.float32), (t, 1, 1, 1))
    for i in range(t):
        T_cam[i, 0, 0, 3], T_cam[i, 0, 2, 3] = 0.03 * i, -0.05 * i
    gt = rng.uniform(1.0, 40.0, (t, 1, H, W, 1)).astype(np.float32)
    gt[rng.rand(*gt.shape) < 0.7] = 0.0
    return {"left": rng.rand(t, 1, H, W, 3).astype(np.float32),
            "right": rng.rand(t, 1, H, W, 3).astype(np.float32),
            "disp_gt": gt, "T_cam": T_cam, "inv_T": np.linalg.inv(T_cam),
            "K": np.array([[[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]]],
                          np.float32),
            "baseline": np.array([2.0], np.float32)}


def _jax_stash():
    """Passes the gradients on and keeps them as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda u, s, p=None: (u, u))


def _port_stash():
    return GradientTransformation(
        lambda p: {k: torch.zeros_like(v) for k, v in p.items()},
        lambda g, s, p=None: (g, g))


def _as_port(params, stats, names, groups):
    sd = state_dict_from_jax(params, stats, groups)
    return {k: sd[k].numpy() for k in names}


def _max_abs(x):
    return float(np.abs(np.asarray(x, np.float64)).max())


@pytest.mark.parametrize("extra", [[], NO_PYRAMID],
                         ids=["block_cost_scale_3", "block_cost_scale_0"])
def test_train_step_matches_jax(extra):
    """The fused cost base (scale 3) and the shift (scale 0) path."""
    check_train_step(3, extra)


@pytest.mark.slow
def test_full_width_gradients_match_jax():
    """v2s trunk and the stage widths of kitti2015-multi, f32, T=2: the
    step's loss terms, every gradient and one optimizer step on them, with
    the BatchNorms reading their running statistics.  In train mode the
    gradients of a B=1 frame through this depth are chaotic in the weights:
    with the steps of ``check_train_step`` the two sides' losses agreed to
    2.1e-3 and their stem gradients differed by 16.6.  So train mode is
    held at the tiny widths above."""
    opts = ["TRAINER.PRECISION", "f32", "OPTIMIZER.RMSPROP.LR", "1e-6"]
    jcfg, cfg = jax_get_cfg(KITTI, opts=opts), get_cfg(KITTI, opts=opts)
    jmodel = jax_build_model(jcfg, dtype=None)
    variables = _jax_variables(jmodel, seed=43)
    stats = variables["batch_stats"]
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables["params"], stats),
                          strict=True)
    nb = _batch(2, seed=44)
    jlosses_fns = jax_build_losses(jcfg)

    def jloss(params, batch):
        outputs, _, _ = jax_multi_frame_forward(
            jmodel, {"params": params, "batch_stats": stats}, batch)
        losses = jax_compute_losses(outputs, batch["disp_gt"][-1],
                                    *jlosses_fns)
        return losses["loss"], losses
    with jax.default_matmul_precision("highest"):
        (_, jl), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True),
                              compiler_options=FAST_COMPILE)(
            variables["params"], {k: jnp.asarray(v) for k, v in nb.items()})
    params, _ = master_copies(model)
    outputs, _ = multi_frame_forward(
        model, {k: torch.from_numpy(v) for k, v in nb.items()})
    losses = compute_losses(outputs, torch.from_numpy(nb["disp_gt"][-1]),
                            *build_losses(cfg))
    losses["loss"].backward()
    for k in jl:
        rel = abs(float(losses[k]) - float(jl[k])) / abs(float(jl[k]))
        assert rel < LOSS_TOL, f"{k}: {float(losses[k])} vs {float(jl[k])}"
    grads = {k: p.grad.float() if p.grad is not None
             else torch.zeros_like(params[k])
             for k, p in model.named_parameters()}
    jgrads = _as_port(jg, stats, grads, None)
    top = max(_max_abs(g) for g in jgrads.values())
    for k, g in grads.items():
        err = _max_abs(g.numpy() - jgrads[k])
        assert err <= GRAD_TOL * _max_abs(jgrads[k]) + FLOOR * top, \
            f"gradient {k}: {err:.3g}"

    jstate = JaxTrainState.create(variables["params"], stats,
                                  jax_optimizer(jcfg, 10)).apply_gradients(jg)
    state = TrainState.create(params, {}, build_optimizer(cfg, 10)
                              ).apply_gradients(grads)
    jparams = _as_port(jstate.params, stats, params, None)
    moved = {k: _max_abs(jparams[k] - params[k].numpy()) for k in jparams}
    for k, p in state.params.items():
        err = _max_abs(p.numpy() - jparams[k])
        assert err <= (PARAM_TOL * moved[k] + 2 ** -22 * _max_abs(jparams[k])
                       + FLOOR * max(moved.values())), \
            f"parameter {k}: {err:.3g}"


def check_train_step(t, extra, tiny=True):
    """Two steps of both sides over a window of t frames, compared as the
    module docstring states (tests/test_torch_train_bptt.py runs BPTT)."""
    opts = ((TINY if tiny else ["TRAINER.PRECISION", "f32"]) + extra
            + ["OPTIMIZER.RMSPROP.LR", "1e-6"])
    groups = TINY_GROUPS if tiny else None
    jcfg, cfg = jax_get_cfg(KITTI, opts=opts), get_cfg(KITTI, opts=opts)
    jmodel = jax_build_model(jcfg, dtype=None)
    variables = _jax_variables(jmodel, seed=41)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(
        variables["params"], variables["batch_stats"], groups),
        strict=True)
    params, stats = master_copies(model)
    state = TrainState.create(params, stats,
                              chain(_port_stash(), build_optimizer(cfg, 10)))
    jstate = JaxTrainState.create(
        variables["params"], variables["batch_stats"],
        optax.chain(_jax_stash(), jax_optimizer(jcfg, 10)))

    nb = _batch(t, seed=42)
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    step = make_train_step(model, cfg)
    jstep = jax.jit(jax_train_step(jmodel, jcfg),
                    compiler_options=FAST_COMPILE)
    history = []
    for _ in range(2):
        with jax.default_matmul_precision("highest"):
            jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v)
                                              for k, v in nb.items()})
        state, metrics = step(state, batch)
        history.append((jstate, jmetrics, state, metrics))

    jstate1, jm, state1, m = history[0]
    assert set(m) == set(jm)
    if "MODEL.PREVIOUS_WITH_GRADIENT" in extra:
        assert {f"{-i}_l1_loss_lvl0" for i in range(t)} <= set(m)
    for k in jm:
        rel = abs(float(m[k]) - float(jm[k])) / abs(float(jm[k]))
        assert rel < LOSS_TOL, f"{k}: {float(m[k])} vs {float(jm[k])}"

    jgrads = _as_port(jstate1.opt_state[0], jstate1.batch_stats,
                      state1.params, groups)
    top = max(_max_abs(g) for g in jgrads.values())
    for k, g in state1.opt_state[0].items():
        err = _max_abs(g.numpy() - jgrads[k])
        assert err <= GRAD_TOL * _max_abs(jgrads[k]) + FLOOR * top, \
            f"gradient {k}: {err:.3g}"

    jstats = _as_port(jstate1.params, jstate1.batch_stats,
                      state1.batch_stats, groups)
    for k, s in state1.batch_stats.items():
        err = _max_abs(s.numpy() - jstats[k])
        assert err <= STATS_TOL * _max_abs(jstats[k]), f"statistic {k}"
    # only the final frame updates the statistics, and it does update them
    assert not np.array_equal(
        state1.batch_stats["backbone.bn1.running_mean"].numpy(),
        stats["backbone.bn1.running_mean"].numpy())

    jstate2, _, state2, _ = history[1]
    assert state2.step == int(jstate2.step) == 2
    jparams = _as_port(jstate2.params, jstate2.batch_stats, state2.params,
                       groups)
    moved = {k: _max_abs(jparams[k] - params[k].numpy()) for k in jparams}
    assert max(moved.values()) > 1e-6            # the steps moved the weights
    for k, p in state2.params.items():
        err = _max_abs(p.numpy() - jparams[k])
        assert err <= (PARAM_TOL * moved[k] + 2 ** -22 * _max_abs(jparams[k])
                       + FLOOR * max(moved.values())), \
            f"parameter {k}: {err:.3g}"
