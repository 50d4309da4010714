"""The port's ops (temporalstereo_tpu_torch.ops / .kernels) against their
JAX counterparts on the CPU, at f32 with a tolerance of 1e-5.

Every input comes from a numpy seed and goes through both sides.  The JAX
side runs at ``default_matmul_precision("highest")`` (CPU matmuls default to
bf16-level precision), and its Pallas kernels run in interpret mode, as
tests/test_pallas.py runs them.  On CPU tensors the port's kernel wrappers
run their plain versions, which is what these tests hold against JAX; the
CUDA kernels are held against the same plain versions by chip_smoke.py.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from temporalstereo_tpu.ops import cost as jcost
from temporalstereo_tpu.ops import interpolate as jinterp
from temporalstereo_tpu.ops import sampling as jsampling
from temporalstereo_tpu.ops import upsample as jupsample
from temporalstereo_tpu.ops import warp as jwarp
from temporalstereo_tpu.ops.pallas.cost import fused_cost_base_pallas
from temporalstereo_tpu.ops.pallas.splat import summation_splat_pallas
from temporalstereo_tpu.ops.softsplat import softsplat as jax_softsplat
from temporalstereo_tpu.ops.softsplat import summation_splat_scatter

from temporalstereo_tpu_torch import kernels
from temporalstereo_tpu_torch.ops import cost, interpolate, sampling
from temporalstereo_tpu_torch.ops import upsample, warp
from temporalstereo_tpu_torch.ops.softsplat import softsplat as port_softsplat

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               **(tol or TOL))


@pytest.mark.parametrize("shape,size", [((2, 6, 10, 3), (11, 19)),
                                        ((1, 12, 20, 4), (6, 10)),
                                        ((1, 1, 7, 2), (5, 7)),
                                        ((1, 5, 8, 2), (5, 8))])
def test_resize_bilinear(shape, size):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    _close(interpolate.resize_bilinear(_t(x), size),
           jinterp.resize_bilinear(jnp.asarray(x), size))


def test_resize_trilinear_and_pools():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 9, 14, 8).astype(np.float32)
    for size in ((5, 18, 28), (3, 4, 7), (5, 9, 14)):
        _close(interpolate.resize_trilinear(_t(x), size),
               jinterp.resize_trilinear(jnp.asarray(x), size))
    for window in ((1, 2, 2), (1, 4, 4)):         # block_cost pyramid, floor
        _close(interpolate.avg_pool3d(_t(x), window),
               jinterp.avg_pool3d(jnp.asarray(x), window))


def test_mesh_grid_and_project_to_3d():
    rng = np.random.RandomState(2)
    b, h, w, c = 2, 6, 10, 3
    depth = (2.0 + 5.0 * rng.rand(b, h, w, c)).astype(np.float32)
    K = np.tile(np.array([[30.0, 0, w / 2], [0, 30.0, h / 2], [0, 0, 1]],
                         np.float32), (b, 1, 1))
    T = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    T[:, 0, 3], T[:, 2, 3] = 0.05, -0.2
    T[:, :3, :3] = np.array([[0.999, -0.04, 0], [0.04, 0.999, 0], [0, 0, 1]])
    _close(warp.mesh_grid(b, h, w), jwarp.mesh_grid(b, h, w))
    ours = warp.project_to_3d(_t(depth), _t(K), None, _t(T))
    ref = jwarp.project_to_3d(jnp.asarray(depth), jnp.asarray(K), None,
                              jnp.asarray(T))
    assert set(ours) == set(ref)
    for k in ref:
        if k == "flow_mask":
            np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))
        else:
            _close(ours[k], ref[k], rtol=1e-5, atol=1e-4)


def test_shift_1d():
    rng = np.random.RandomState(3)
    img = rng.randn(2, 1, 4, 16, 8).astype(np.float32)
    shift = rng.uniform(-20, 6, (2, 3, 4, 16)).astype(np.float32)
    shift[0, 0, 0, :4] = [0.0, -1.0, -15.0, 2.5]   # integer and edge taps
    _close(warp.shift_1d(_t(img), _t(shift)),
           jwarp.shift_1d(jnp.asarray(img), jnp.asarray(shift)))


def test_correlation_and_integer_shift():
    rng = np.random.RandomState(4)
    a = rng.randn(1, 3, 4, 5, 16).astype(np.float32)
    bb = rng.randn(1, 3, 4, 5, 16).astype(np.float32)
    _close(cost.groupwise_correlation(_t(a), _t(bb)),
           jcost.groupwise_correlation(jnp.asarray(a), jnp.asarray(bb)))
    t = rng.randn(2, 3, 6, 4).astype(np.float32)
    for d in (4, 9):                              # 9 > W: all-zero tail
        _close(cost.shift_right_features(_t(t), d),
               jcost.shift_right_features(jnp.asarray(t), d))


@pytest.mark.parametrize("disp,c,scale", [(12, 16, 3),      # coarse, int
                                          ("tensor", 16, 3),  # fused base
                                          ("tensor", 16, 1),
                                          ("tensor", 12, 0)])  # unfused
def test_block_cost(disp, c, scale):
    rng = np.random.RandomState(5)
    b, h, w = 1, 8, 14
    ref = rng.randn(b, h, w, c).astype(np.float32)
    tgt = rng.randn(b, h, w, c).astype(np.float32)
    if disp == "tensor":
        d = rng.uniform(-2, 16, (b, 6, h, w)).astype(np.float32)
        ours = cost.block_cost(_t(ref), _t(tgt), _t(d), scale)
        theirs = jcost.block_cost(jnp.asarray(ref), jnp.asarray(tgt),
                                  jnp.asarray(d), scale)
    else:
        ours = cost.block_cost(_t(ref), _t(tgt), disp, scale)
        theirs = jcost.block_cost(jnp.asarray(ref), jnp.asarray(tgt), disp,
                                  scale)
    assert tuple(ours.shape) == theirs.shape
    _close(ours, theirs)


def test_fused_cost_base_plain_matches_pallas_and_block_cost():
    """The plain fused base (what a CPU tensor runs) equals the TPU kernel
    in interpret mode and the first 2C + C/8 channels of block_cost."""
    rng = np.random.RandomState(6)
    b, d, h, w, c = 2, 3, 8, 24, 16
    ref = rng.rand(b, h, w, c).astype(np.float32)
    tgt = rng.rand(b, h, w, c).astype(np.float32)
    disp = rng.uniform(-2, 28, (b, d, h, w)).astype(np.float32)
    ours = kernels.fused_cost_base(_t(ref), _t(tgt), _t(disp))
    assert tuple(ours.shape) == (b, d, h, w, 2 * c + c // 8)
    with pltpu.force_tpu_interpret_mode():
        pallas = fused_cost_base_pallas(jnp.asarray(ref), jnp.asarray(tgt),
                                        jnp.asarray(disp))
    _close(ours, pallas)
    _close(ours, jcost.block_cost(jnp.asarray(ref), jnp.asarray(tgt),
                                  jnp.asarray(disp), 1))


def test_kernel_wrappers_on_cpu_run_plain_and_refuse_grad():
    rng = np.random.RandomState(7)
    ref = _t(rng.rand(1, 4, 8, 8))
    disp = _t(rng.rand(1, 2, 4, 8))
    vals, metric = _t(rng.rand(1, 4, 8, 3)), _t(rng.rand(1, 4, 8, 1))
    # a strided flow, as update_prev_info slices it out of project_to_3d's
    flow = _t(rng.randn(1, 4, 8, 3, 2))[:, :, :, 0, :]
    kernels.reset_launches()
    torch.testing.assert_close(kernels.fused_cost_base(ref, ref, disp),
                               kernels.fused_cost_base_plain(ref, ref, disp))
    for mode in ("summation", "softmax"):
        torch.testing.assert_close(
            kernels.softsplat(vals, flow, metric, mode),
            kernels.softsplat_plain(vals, flow.contiguous(), metric, mode))
    assert set(kernels.LAUNCHES.values()) == {0}
    # the cost base and the splat are differentiable (plain autograd on
    # the CPU)
    assert kernels.fused_cost_base(ref.requires_grad_(), ref,
                                   disp).grad_fn is not None
    assert kernels.softsplat(vals, flow, metric.requires_grad_(),
                             "softmax").grad_fn is not None
    with pytest.raises(ValueError, match="metric"):
        kernels.softsplat(vals, flow, None, "softmax")
    with pytest.raises(TypeError):
        kernels.fused_cost_base(ref.detach().double(), ref.detach().double(),
                                disp)


def test_topk_soft_argmin_breaks_ties_to_lowest_index():
    rng = np.random.RandomState(8)
    b, h, w, d = 2, 3, 4, 7
    cst = rng.randn(b, h, w, d).astype(np.float32)
    cst[0, 0, 0] = [1, 3, 3, 3, 0, 2, 3]          # a three-way tie at the top
    cst[0, 0, 1] = 5.0                             # all equal
    cst[1, 2, 3, 2:5] = cst[1, 2, 3].max() + 1     # tie for both places
    samples = np.tile(np.arange(d, dtype=np.float32), (b, h, w, 1)) * 1.5
    off = rng.uniform(-1, 1, (b, h, w, d)).astype(np.float32)
    ours = sampling.topk_soft_argmin(_t(cst), _t(samples), _t(off), 2)
    theirs = jsampling.topk_soft_argmin(jnp.asarray(cst),
                                        jnp.asarray(samples),
                                        jnp.asarray(off), 2)
    for o, t in zip(ours, theirs):
        _close(o, t)


def test_sort_samples_with_duplicates_is_stable():
    """Frame 0 appends zero memory samples to the coarse samples 0..11:
    three hypotheses equal 0, and their volume slices must keep JAX's
    stable rank order."""
    rng = np.random.RandomState(9)
    b, h, w, c = 1, 3, 4, 5
    samples = np.concatenate([
        np.tile(np.arange(12, dtype=np.float32), (b, h, w, 1)),
        np.zeros((b, h, w, 2), np.float32)], axis=-1)
    samples[0, 1, 2, 12:] = [4.0, 4.0]             # duplicates mid-range
    d = samples.shape[-1]
    vol = rng.randn(b, d, h, w, c).astype(np.float32)
    ours = sampling.sort_samples_with_volume(_t(samples), _t(vol))
    theirs = jsampling.sort_samples_with_volume(jnp.asarray(samples),
                                                jnp.asarray(vol))
    for o, t in zip(ours, theirs):
        np.testing.assert_array_equal(o.numpy(), np.asarray(t))
    # the model's channels-first volume [B, C, D, H, W]
    _, cf = sampling.sort_samples_with_volume(
        _t(samples), _t(vol.transpose(0, 4, 1, 2, 3)), dim=2)
    np.testing.assert_array_equal(cf.numpy().transpose(0, 2, 3, 4, 1),
                                  np.asarray(theirs[1]))


def test_disparity_samples():
    rng = np.random.RandomState(10)
    low = rng.uniform(-5, 40, (2, 3, 4, 1)).astype(np.float32)
    high = low + rng.uniform(-8, 8, low.shape).astype(np.float32)
    _close(sampling.fractional_disparity_samples(_t(low), _t(high)),
           jsampling.fractional_disparity_samples(jnp.asarray(low),
                                                  jnp.asarray(high)))
    _close(sampling.linear_disparity_samples(2, 3, 4, 12),
           jsampling.linear_disparity_samples(2, 3, 4, 12))


def test_upsampling_ops():
    rng = np.random.RandomState(11)
    x = rng.randn(2, 5, 6, 3).astype(np.float32)
    _close(upsample.unfold3x3(_t(x)), jupsample.unfold3x3(jnp.asarray(x)))
    disp = rng.uniform(0, 20, (2, 5, 6, 1)).astype(np.float32)
    mask = rng.randn(2, 5, 6, 36).astype(np.float32)
    _close(upsample.convex_upsample(_t(disp), _t(mask)),
           jupsample.convex_upsample(jnp.asarray(disp), jnp.asarray(mask)))
    mask9 = rng.randn(2, 20, 24, 9).astype(np.float32)
    _close(upsample.mask_upsample_9(_t(disp), _t(mask9)),
           jupsample.mask_upsample_9(jnp.asarray(disp), jnp.asarray(mask9)))


def test_summation_splat_plain_matches_pallas_and_scatter():
    rng = np.random.RandomState(12)
    b, h, w, c = 2, 6, 16, 8
    vals = rng.rand(b, h, w, c).astype(np.float32)
    flow = rng.uniform(-5, 5, (b, h, w, 2)).astype(np.float32)
    flow[0, 0, :3] = [[-100.0, 0.0], [0.0, 1e9], [2.0, 1.0]]  # off-frame taps
    ours = kernels.softsplat(_t(vals), _t(flow), None, "summation")
    with pltpu.force_tpu_interpret_mode():
        pallas = summation_splat_pallas(jnp.asarray(vals), jnp.asarray(flow))
    _close(ours, pallas)
    _close(ours, summation_splat_scatter(jnp.asarray(vals),
                                                jnp.asarray(flow)))


@pytest.mark.parametrize("mode", ["summation", "average", "linear",
                                  "softmax"])
def test_softsplat_modes(mode):
    rng = np.random.RandomState(13)
    b, h, w, c = 1, 6, 10, 4
    inputs = rng.randn(b, h, w, c).astype(np.float32)
    flow = rng.uniform(-3, 3, (b, h, w, 2)).astype(np.float32)
    metric = rng.uniform(0.1, 2, (b, h, w, 1)).astype(np.float32)
    ours = port_softsplat(_t(inputs), _t(flow), _t(metric), mode)
    theirs = jax_softsplat(jnp.asarray(inputs), jnp.asarray(flow),
                              jnp.asarray(metric), mode, method="scatter")
    _close(ours, theirs, rtol=1e-5, atol=1e-4)


def _splat_case(case, rng, b=2, h=5, w=12, c=3):
    """(inputs, flow, metric) of one splat case; flows in f32 pixels."""
    inputs = rng.rand(b, h, w, c).astype(np.float32) * 4 - 1
    metric = rng.uniform(-1, 1, (b, h, w, 1)).astype(np.float32)
    flow = rng.uniform(-3, 3, (b, h, w, 2)).astype(np.float32)
    if case == "one_target":
        # every source onto one point: four buckets of h*w keys each
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
        flow = np.stack([w // 2 + 0.25 - xs, h // 2 + 0.5 - ys], -1)
        flow = np.broadcast_to(flow, (b, h, w, 2)).copy()
    elif case == "off_edges":
        # taps off each edge, one of each pair kept, and whole sources off
        flow[:, :, 0, 0] = -0.5
        flow[:, :, -1, 0] = 0.5
        flow[:, 0, :, 1] = -0.25
        flow[:, -1, :, 1] = 0.75
        flow[0, 2, 3:7] = [[1e9, 0.0], [-1e9, 0.0], [0.0, 1e9], [-100.0, 2.0]]
    elif case == "metric_50":
        # the model clamps the metric to +-50 before exp (EXPMAX)
        metric = rng.choice([-50.0, 50.0, 0.0], (b, h, w, 1)).astype(
            np.float32)
    return inputs, flow, metric


@pytest.mark.parametrize("mode,case", [
    (mode, case) for mode in ("summation", "average", "linear", "softmax")
    for case in ("uniform", "one_target", "off_edges")]
    + [("linear", "metric_50"), ("softmax", "metric_50")])
def test_softsplat_plain_matches_jax(mode, case):
    """softsplat_plain against JAX softsplat (the scatter, and in summation
    mode the Pallas kernel in interpret mode).  Tolerance f32
    1e-5 |p| + 1e-6 max|p|: the contributions are the same products, but the
    three formulations add a target's taps in different orders."""
    rng = np.random.RandomState(14)
    inputs, flow, metric = _splat_case(case, rng)
    ours = kernels.softsplat_plain(_t(inputs), _t(flow), _t(metric), mode)
    refs = [jax_softsplat(jnp.asarray(inputs), jnp.asarray(flow),
                          jnp.asarray(metric), mode, method="scatter")]
    if mode == "summation":
        with pltpu.force_tpu_interpret_mode():
            refs.append(summation_splat_pallas(jnp.asarray(inputs),
                                               jnp.asarray(flow)))
    for ref in refs:
        ref = np.asarray(ref)
        assert np.isfinite(ref).all()
        bound = 1e-5 * np.abs(ref) + 1e-6 * np.abs(ref).max()
        err = np.abs(ours.numpy() - ref)
        assert (err <= bound).all(), float(err.max())


def test_splat_plan_tiles_the_port_paths_and_refuses_larger():
    # the stream's and the training step's temporal update (1/8 of
    # 384x1248 and 320x1184) on a card of 132 SMs: about one block per SM
    assert kernels.splat_plan(1, 48, 156, 132) == 57
    assert kernels.splat_plan(4, 40, 148, 132) == 128
    assert kernels.splat_plan(2, 5, 12, 132) == 1
    with pytest.raises(ValueError, match="int32"):
        kernels.splat_plan(1, 2 ** 14, 2 ** 14, 132)
