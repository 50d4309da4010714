"""The port's training pieces against the JAX package on the CPU: the two
differentiable kernels' plain versions (forward and vjp), the 2D pools, the
losses, BatchNorm's train-mode statistics, the optimizers, clip, schedules
and SWA, and the configuration the training path reads.

Inputs come from numpy seeds and go through both sides.  The JAX side runs
at ``default_matmul_precision("highest")``; its Pallas kernels run in
interpret mode, as tests/test_pallas.py runs them.  On CPU tensors the
port's kernel wrappers run their plain versions under torch autograd, which
is what these tests hold against ``jax.vjp`` of the Pallas kernels; the CUDA
kernels are held against the same plain versions by chip_smoke.py.  f32
everywhere, tolerance 1e-5 (the same arithmetic in another order).
"""
import pathlib

import flax.linen as fnn
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from temporalstereo_tpu.config import get_cfg as jax_get_cfg
from temporalstereo_tpu.losses import (DispSmoothL1Loss as JaxL1,
                                       WassersteinDistanceLoss as JaxWars)
from temporalstereo_tpu.ops import interpolate as jinterp
from temporalstereo_tpu.ops.pallas.cost import fused_cost_base_pallas
from temporalstereo_tpu.ops.pallas.shift import shift_1d_pallas
from temporalstereo_tpu.training import TrainState as JaxTrainState
from temporalstereo_tpu.training import build_optimizer as jax_optimizer
from temporalstereo_tpu.training.optim import build_schedule as jax_schedule

from temporalstereo_tpu_torch import kernels
from temporalstereo_tpu_torch.config import get_cfg
from temporalstereo_tpu_torch.kernels.launches import (PAIRS, RING_PAIRS,
                                                      row_plan)
from temporalstereo_tpu_torch.losses import (DispSmoothL1Loss,
                                             WassersteinDistanceLoss)
from temporalstereo_tpu_torch.nn.layers import BatchNorm
from temporalstereo_tpu_torch.ops import interpolate
from temporalstereo_tpu_torch.training import TrainState, build_optimizer
from temporalstereo_tpu_torch.training.optim import build_schedule

REPO = pathlib.Path(__file__).resolve().parents[1]
KITTI = str(REPO / "configs" / "kitti2015-multi.yaml")
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _t(x, grad=False):
    return torch.tensor(np.asarray(x, np.float32), requires_grad=grad)


def _close(port, ref, **tol):
    if isinstance(port, torch.Tensor):
        port = port.detach().numpy()
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               **(tol or TOL))


# ------------------------------------------------------------- kernels ----

def _colliding_positions(rng, b, d, h, w):
    """Sampling positions x + shift that put many (x, d) on a few target
    columns: integer and fractional, on and past both edges."""
    cols = np.array([-1.0, -0.5, 0.0, 3.0, 3.5, w - 2.0, w - 1.5, w - 1.0],
                    np.float32)
    return cols[rng.randint(0, len(cols), (b, d, h, w))]


@pytest.mark.parametrize("broadcast,collide", [(True, False), (False, False),
                                               (True, True), (False, True)])
def test_shift_1d_forward_and_vjp_match_pallas(broadcast, collide):
    rng = np.random.RandomState(11)
    b, d, h, w, c = 2, 3, 4, 16, 8
    img = rng.randn(b, 1 if broadcast else d, h, w, c).astype(np.float32)
    shift = rng.uniform(-20, 6, (b, d, h, w)).astype(np.float32)
    # integer shifts (fraction 0), a tap exactly on each edge and taps off
    # both edges
    shift[0, 0, 0, :6] = [0.0, -1.0, -15.0, 2.0, 15.0, -3.5]
    shift[1, 1, 2, -3:] = [3.0, 1.0, 0.25]
    if collide:
        shift = _colliding_positions(rng, b, d, h, w) - np.arange(
            w, dtype=np.float32)
    g = rng.randn(b, d, h, w, c).astype(np.float32)

    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(shift_1d_pallas, jnp.asarray(img),
                           jnp.asarray(shift))
        g_img, g_shift = vjp(jnp.asarray(g))
    ti, ts = _t(img, True), _t(shift, True)
    ours = kernels.shift_1d(ti, ts)
    ours.backward(_t(g))
    _close(ours, out)
    _close(ti.grad, g_img)
    _close(ts.grad, g_shift)


@pytest.mark.parametrize("collide", [False, True])
def test_fused_cost_base_forward_and_vjp_match_pallas(collide):
    rng = np.random.RandomState(12)
    b, d, h, w, c = 2, 3, 4, 24, 16
    ref = rng.randn(b, h, w, c).astype(np.float32)
    tgt = rng.randn(b, h, w, c).astype(np.float32)
    disp = rng.uniform(-3, 27, (b, d, h, w)).astype(np.float32)
    disp[0, 0, 0, :4] = [0.0, 3.0, 24.0, -1.0]       # integer hypotheses
    if collide:    # the warp samples at x - disp
        disp = np.arange(w, dtype=np.float32) - _colliding_positions(
            rng, b, d, h, w)
    g = rng.randn(b, d, h, w, 2 * c + c // 8).astype(np.float32)

    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(fused_cost_base_pallas, jnp.asarray(ref),
                           jnp.asarray(tgt), jnp.asarray(disp))
        grads = vjp(jnp.asarray(g))
    inputs = [_t(ref, True), _t(tgt, True), _t(disp, True)]
    ours = kernels.fused_cost_base(*inputs)
    ours.backward(_t(g))
    _close(ours, out)
    for name, x, ref_grad in zip(("ref", "tgt", "disp"), inputs, grads):
        _close(x.grad, ref_grad, err_msg=name, **TOL)


def test_cpu_wrappers_launch_nothing():
    rng = np.random.RandomState(13)
    img, shift = _t(rng.rand(1, 1, 2, 8, 4), True), _t(rng.rand(1, 2, 2, 8))
    ref, tgt = _t(rng.rand(1, 2, 8, 8), True), _t(rng.rand(1, 2, 8, 8), True)
    disp = _t(rng.rand(1, 3, 2, 8) * 8, True)
    kernels.reset_launches()
    kernels.shift_1d(img, shift).sum().backward()
    kernels.fused_cost_base(ref, tgt, disp).sum().backward()
    assert set(kernels.LAUNCHES.values()) == {0}
    assert ref.grad is not None and disp.grad is not None
    with pytest.raises(ValueError):
        kernels.shift_1d(img, shift[:, :, :1])
    # the backward kernels themselves take CUDA tensors only
    go = torch.zeros((1, 3, 2, 8, 2 * 8 + 1))
    with pytest.raises(ValueError, match="no kernel"):
        kernels.fused_cost_base_backward(go, ref.detach(), tgt.detach(),
                                         disp.detach())
    with pytest.raises(ValueError, match="no kernel"):
        kernels.shift_1d_backward(torch.zeros((1, 2, 2, 8, 4)), img.detach(),
                                  shift)
    assert set(kernels.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("c,w,pairs,elems,size,stage", [
    (128, 148, 8 * 148, 5 * 32 + 8, 2, 8 * (16 + 128)),   # cost, fine, bf16
    (128, 296, 5 * 296, 5 * 32 + 8, 4, 8 * (16 + 256)),   # cost, precise, f32
    (128, 312, 5 * 312, 3 * 32, 4, 128),   # shift, 1248 / 4, f32
    (24, 37, 37, 3 * 32, 2, 128)])         # one partial slice
def test_row_plan_covers_the_channels_and_fits(c, w, pairs, elems, size,
                                               stage):
    slices, shared = row_plan(c, w, pairs, elems, size, stage)
    assert (slices - 1) * 32 < c <= slices * 32 <= 8 * 32
    need = (4 * 32 * (w + 1) + 4 * (-(-pairs // PAIRS) + 1) * PAIRS
            + RING_PAIRS * elems * size + 2 * stage)
    assert need <= shared < need + 16 and shared <= 232448


@pytest.mark.parametrize("c,w,pairs", [(264, 148, 8 * 148),  # 9 slices
                                       (128, 2048, 5 * 2048)])  # too wide
def test_row_plan_refuses_a_shape_that_does_not_fit(c, w, pairs):
    with pytest.raises(ValueError):
        row_plan(c, w, pairs, 5 * 32 + 8, 4, 8 * (16 + 256))


# --------------------------------------------------------------- pools ----

@pytest.mark.parametrize("shape,size", [((2, 8, 12, 1), (4, 3)),
                                        ((1, 6, 6, 2), (6, 6)),
                                        ((3, 4, 8, 3), (1, 2))])
def test_adaptive_pools(shape, size):
    x = np.random.RandomState(14).randn(*shape).astype(np.float32)
    _close(interpolate.adaptive_avg_pool2d(_t(x), size),
           jinterp.adaptive_avg_pool2d(jnp.asarray(x), size))
    _close(interpolate.adaptive_max_pool2d(_t(x), size),
           jinterp.adaptive_max_pool2d(jnp.asarray(x), size))
    window = (shape[-3] // size[0], shape[-2] // size[1])
    _close(interpolate.avg_pool2d(_t(x), window),
           jinterp.avg_pool2d(jnp.asarray(x), window))
    _close(interpolate.max_pool2d(_t(x), window),
           jinterp.max_pool2d(jnp.asarray(x), window))
    with pytest.raises(ValueError):
        interpolate.adaptive_avg_pool2d(_t(x), (5, 5))


# -------------------------------------------------------------- losses ----

@pytest.mark.parametrize("sparse,empty", [(True, False), (False, False),
                                          (True, True)])
def test_losses_and_their_gradients(sparse, empty):
    rng = np.random.RandomState(15)
    b, h, w = 2, 16, 24
    gt = rng.uniform(0.5, 40, (b, h, w, 1)).astype(np.float32)
    gt[rng.rand(b, h, w, 1) < 0.6] = 0.0          # sparse: 0 is invalid
    if empty:
        gt[:] = 0.0                               # the empty-mask fallback
    disps = [rng.uniform(0, 40, (b, h // s, w // s, 1)).astype(np.float32)
             for s in (1, 1, 2, 4)]
    d = 7
    costs = [rng.randn(b, h // s, w // s, d).astype(np.float32)
             for s in (2, 4, 8)]
    offs = [rng.randn(b, h // s, w // s, d).astype(np.float32) * 0.3
            for s in (2, 4, 8)]
    samples = [np.sort(rng.uniform(0, 20, (b, h // s, w // s, d)), -1)
               .astype(np.float32) for s in (2, 4, 8)]
    kw = dict(global_weight=2.0, weights=[1.0, 0.7], sparse=sparse)

    def jax_total(disps, costs, offs):
        out = dict(JaxL1(**kw)(disps, jnp.asarray(gt)))
        out.update(JaxWars(**kw)(costs, offs, [jnp.asarray(s)
                                               for s in samples],
                                 jnp.asarray(gt)))
        return sum(out.values()), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jax_total, argnums=(0, 1, 2), has_aux=True))(
        [jnp.asarray(x) for x in disps], [jnp.asarray(x) for x in costs],
        [jnp.asarray(x) for x in offs])
    tdisps = [_t(x, True) for x in disps]
    tcosts = [_t(x, True) for x in costs]
    toffs = [_t(x, True) for x in offs]
    tout = dict(DispSmoothL1Loss(**kw)(tdisps, _t(gt)))
    tout.update(WassersteinDistanceLoss(**kw)(tcosts, toffs,
                                              [_t(s) for s in samples],
                                              _t(gt)))
    sum(tout.values()).backward()
    assert set(tout) == set(jout)
    for k in jout:
        _close(tout[k], jout[k], err_msg=k, **TOL)
    for tgroup, jgroup in zip((tdisps, tcosts, toffs), jgrads):
        for tx, jg in zip(tgroup, jgroup):
            _close(tx.grad, jg)


# ----------------------------------------------------------- BatchNorm ----

@pytest.mark.parametrize("spatial", [2, 3])
def test_batchnorm_train_mode_matches_flax(spatial):
    """Normalisation, its gradients and the running statistics' update
    (momentum 0.9 on the biased batch variance) after two batches."""
    rng = np.random.RandomState(16 + spatial)
    c = 6
    shape = (3, c) + (5, 7, 4)[-spatial:]
    xs = [rng.randn(*shape).astype(np.float32) * 3 + 1 for _ in range(2)]
    g = rng.randn(*shape).astype(np.float32)
    scale = rng.rand(c).astype(np.float32) + 0.5
    bias = rng.randn(c).astype(np.float32)
    mean0 = rng.randn(c).astype(np.float32)
    var0 = rng.rand(c).astype(np.float32) + 0.5

    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5, use_fast_variance=False)
    stats = {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    port = BatchNorm(c).train()
    with torch.no_grad():
        port.weight.copy_(_t(scale))
        port.bias.copy_(_t(bias))
        port.running_mean.copy_(_t(mean0))
        port.running_var.copy_(_t(var0))
    to_last = (0,) + tuple(range(2, 2 + spatial)) + (1,)
    to_first = (0, spatial + 1) + tuple(range(1, spatial + 1))
    for x in xs:
        y, upd = bn.apply({"params": params, "batch_stats": stats},
                          jnp.asarray(x.transpose(to_last)),
                          mutable=["batch_stats"])
        stats = upd["batch_stats"]
        _close(port(_t(x)), np.asarray(y).transpose(to_first))
    _close(port.running_mean, stats["mean"])
    _close(port.running_var, stats["var"])

    # eval mode reads the running statistics and updates nothing
    port.eval()
    before = port.running_var.clone()
    y_eval = bn.clone(use_running_average=True).apply(
        {"params": params, "batch_stats": stats},
        jnp.asarray(xs[0].transpose(to_last)))
    _close(port(_t(xs[0])), np.asarray(y_eval).transpose(to_first))
    torch.testing.assert_close(port.running_var, before)
    port.train()

    # gradients of the last batch's normalisation
    def loss(p, x):
        y, _ = bn.apply({"params": p, "batch_stats": stats}, x,
                        mutable=["batch_stats"])
        return jnp.sum(y * jnp.asarray(g.transpose(to_last)))
    gp, gx = jax.grad(loss, argnums=(0, 1))(
        params, jnp.asarray(xs[-1].transpose(to_last)))
    port.zero_grad()
    tx = _t(xs[-1], True)
    (port(tx) * _t(g)).sum().backward()
    _close(tx.grad, np.asarray(gx).transpose(to_first))
    _close(port.weight.grad, gp["scale"])
    _close(port.bias.grad, gp["bias"])


# ------------------------------------------------- optimizer, clip, SWA ----

def _trees(seed, scale):
    rng = np.random.RandomState(seed)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    return {k: (rng.randn(*s) * scale).astype(np.float32)
            for k, s in shapes.items()}


def _run_optimizer(opts, grad_scales, swa=False):
    """Three steps of the JAX and the port optimizer on the same trees ->
    per step (jax params, port params), plus the SWA averages."""
    jcfg = jax_get_cfg(KITTI, opts=opts)
    cfg = get_cfg(KITTI, opts=opts)
    params = _trees(0, 1.0)
    jstate = JaxTrainState.create({k: jnp.asarray(v) for k, v in
                                   params.items()}, {},
                                  jax_optimizer(jcfg, 2), with_swa=swa)
    state = TrainState.create({k: _t(v) for k, v in params.items()}, {},
                              build_optimizer(cfg, 2), with_swa=swa)
    steps = []
    for i, scale in enumerate(grad_scales):
        grads = _trees(100 + i, scale)
        active = swa and i >= 1
        jstate = jstate.apply_gradients(
            {k: jnp.asarray(v) for k, v in grads.items()},
            swa_active=jnp.asarray(active) if swa else None)
        state = state.apply_gradients({k: _t(v) for k, v in grads.items()},
                                      swa_active=active)
        steps.append((jstate.params, state.params))
    return steps, jstate, state


@pytest.mark.parametrize("kind", ["RMSProp", "Adam", "AdamW"])
@pytest.mark.parametrize("clip_side", ["below", "above"])
def test_optimizers_with_clip_match_optax(kind, clip_side):
    """Gradient norms ~0.03 (below the 0.1 clip) or ~30 (above it)."""
    scale = 0.01 if clip_side == "below" else 10.0
    opts = ["OPTIMIZER.TYPE", kind, f"OPTIMIZER.{kind.upper()}.LR", "1e-2",
            "SCHEDULER.MULTI_STEP_LR.MILESTONES", "[1]"]
    steps, _, _ = _run_optimizer(opts, [scale] * 3)
    for jp, tp in steps:
        for k in jp:
            _close(tp[k], jp[k], rtol=1e-5, atol=1e-7, err_msg=k)


def test_rmsprop_eps_inside_the_root_matters():
    """Gradients of 1e-5 and no clip: nu ~ 1e-12 << eps, where optax's
    sqrt(nu + eps) and torch's sqrt(nu) + eps give updates ~100x apart."""
    opts = ["TRAINER.GRADIENT_CLIP_VAL", "0.0", "SCHEDULER.TYPE", "None"]
    steps, _, _ = _run_optimizer(opts, [1e-5] * 3)
    params0 = _trees(0, 1.0)
    jp, tp = steps[0]
    g = _trees(100, 1e-5)
    torch_style = {k: params0[k] - 1e-4 * g[k] / (np.sqrt(0.01 * g[k] ** 2)
                                                  + 1e-8) for k in g}
    for k in jp:
        _close(tp[k], jp[k], rtol=1e-6, atol=1e-9, err_msg=k)
        step_optax = np.abs(np.asarray(jp[k]) - params0[k]).max()
        step_torch = np.abs(torch_style[k] - params0[k]).max()
        assert step_torch > 50 * step_optax


def test_swa_running_average_matches_jax():
    steps, jstate, state = _run_optimizer([], [10.0] * 3, swa=True)
    assert state.swa_count == int(jstate.swa_count) == 2
    for k in jstate.swa_params:
        _close(state.swa_params[k], jstate.swa_params[k], rtol=1e-6,
               atol=1e-8, err_msg=k)
        _close(state.swa_model_params()[k], jstate.swa_model_params()[k],
               rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("kind", ["None", "StepLR", "MultiStepLR",
                                  "ExponentialLR"])
def test_schedules_map_epochs_to_steps_as_jax(kind):
    opts = ["SCHEDULER.TYPE", kind, "SCHEDULER.STEP_LR.STEP_SIZE", "2",
            "SCHEDULER.MULTI_STEP_LR.MILESTONES", "[2, 5]"]
    jsched = jax_schedule(jax_get_cfg(KITTI, opts=opts), 1e-3, 3)
    sched = build_schedule(get_cfg(KITTI, opts=opts), 1e-3, 3)
    for step in range(20):
        np.testing.assert_allclose(sched(step), float(jsched(step)),
                                   rtol=1e-6, err_msg=f"step {step}")


# -------------------------------------------------------------- config ----

def test_config_reads_what_jax_reads():
    """Every key of the port's tree, read from configs/kitti2015-multi.yaml,
    equals the JAX package's value at the same path."""
    ours, theirs = get_cfg(KITTI), jax_get_cfg(KITTI)

    def walk(a, b, path):
        for k, v in a.items():
            assert k in b, f"{path}{k} missing in the JAX tree"
            if isinstance(v, dict):
                walk(v, b[k], f"{path}{k}.")
            else:
                assert v == b[k], f"{path}{k}: {v!r} != {b[k]!r}"
    walk(ours, theirs, "")
    assert ours.OPTIMIZER.RMSPROP.LR == 1e-4
    assert ours.MODEL.LOSSES.WARSSERSTEIN_DISTANCE_LOSS.GLOBAL_WEIGHT == 2.0
    assert ours.DATA.TRAIN.FRAME_IDXS == list(range(-10, 1))
