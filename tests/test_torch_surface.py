"""The port's surface off the main path against the JAX package on the CPU:
the norm kinds, the prediction heads and registries, the ops (argmins,
``upsample_disp``, ``max_pool3d``, both branches of ``inverse_warp_3d``,
``summation_splat``), the blocks (ResidualBlock2D, BasicBlock,
StereoDRNetRefinement, SPP3D, ConvGRU) with JAX's variables moved by
``module_state_dict_from_jax``, folding and serving a GroupNorm model, and
the colour maps.

Both sides get the same numpy inputs, made from a seed; the JAX side runs
at ``default_matmul_precision("highest")``.  Tolerances, stated per test:
  * each norm kind's output and gradients 1e-5 (f32; the same statistics,
    one-pass variance for GN and LN as flax computes them, two-pass for IN
    and the train-mode BatchNorm);
  * the ops 1e-5 (the same f32 arithmetic, summed in another order);
  * the blocks and the prediction heads 1e-4 (convolutions summed in
    another order);
  * a folded GroupNorm model against the unfolded one 2e-3 relative, the
    single-frame tolerance of tests/test_torch_model.py;
  * the colour maps equal.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from temporalstereo_tpu.config import get_cfg as jax_get_cfg
from temporalstereo_tpu.models import build_model as jax_build_model
from temporalstereo_tpu.models.prediction import (
    build_prediction as jax_build_prediction)
from temporalstereo_tpu.nn import blocks as jax_blocks
from temporalstereo_tpu.nn import layers as jax_layers
from temporalstereo_tpu.ops import interpolate as jax_interpolate
from temporalstereo_tpu.ops import sampling as jax_sampling
from temporalstereo_tpu.ops.softsplat import (
    summation_splat as jax_summation_splat)
from temporalstereo_tpu.ops.warp import inverse_warp_3d as jax_warp_3d
from temporalstereo_tpu.training.checkpoint import (
    save_weights as jax_save_weights)
from temporalstereo_tpu.utils import registry as jax_registry
from temporalstereo_tpu.utils.fold_bn import (
    fold_batch_norms as jax_fold_batch_norms)
from temporalstereo_tpu.visualization import disparity as jax_disparity
from temporalstereo_tpu.visualization import flow as jax_flow

from temporalstereo_tpu_torch import nn as port_nn
from temporalstereo_tpu_torch import ops
from temporalstereo_tpu_torch.config import get_cfg
from temporalstereo_tpu_torch.models import build_model, build_prediction
from temporalstereo_tpu_torch.models.backbone import TINY_GROUPS
from temporalstereo_tpu_torch.serving import (StreamingBundle, bundle_meta,
                                              cast_params_bf16)
from temporalstereo_tpu_torch.utils import registry
from temporalstereo_tpu_torch.utils.checkpoint import load_weights
from temporalstereo_tpu_torch.utils.convert import (
    module_state_dict_from_jax, state_dict_from_jax)
from temporalstereo_tpu_torch.utils.fold_bn import fold_batch_norms
from temporalstereo_tpu_torch.visualization import (disp_err_to_color,
                                                    flow_err_to_color,
                                                    flow_to_color)

from tests.test_torch_model import TEMPORAL, TINY, _jax_variables, _rel

NORM_TOL = 1e-5
OP_TOL = 1e-5
BLOCK_TOL = 1e-4
SINGLE_TOL = 2e-3
GN_NORMS = ["MODEL.BACKBONE.NORM", "GN",
            "MODEL.AGGREGATION.COARSE.NORM", "GN",
            "MODEL.AGGREGATION.FINE.NORM", "GN",
            "MODEL.AGGREGATION.PRECISE.NORM", "GN"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _variables(jmodule, *args, seed, train=None):
    """Random variables of a flax module, drawn with numpy over its variable
    shapes (``eval_shape`` runs no model code): kernels N(0, 1/fan_in),
    scales and variances in [0.75, 1.25), biases and means N(0, 0.1^2)."""
    extra = () if train is None else (train,)
    tree = jax.eval_shape(
        lambda *a: jmodule.init(jax.random.PRNGKey(0), *a, *extra), *args)
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = path[-1].key
        if name == "kernel":
            v = rng.randn(*x.shape) / np.sqrt(np.prod(x.shape[:-1]))
        elif name in ("scale", "var"):
            v = rng.rand(*x.shape) * 0.5 + 0.75
        else:
            v = rng.randn(*x.shape) * 0.1
        return jnp.asarray(v, jnp.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _cf(x):
    """Channels-last numpy -> channels-first tensor."""
    return _t(np.moveaxis(x, -1, 1))


def _cl(t):
    """Channels-first tensor -> channels-last numpy."""
    return np.moveaxis(t.detach().numpy(), 1, -1)


# ----------------------------------------------------------------- norms ----

@pytest.mark.parametrize("shape", [(2, 3, 5, 6, 64), (2, 7, 9, 96)],
                         ids=["volume", "image"])
@pytest.mark.parametrize("kind", ["BN", "FrozenBN", "GN", "IN", "LN"])
def test_norm_matches_jax(kind, shape):
    """Train mode: the output, the input's gradient and the affine
    weights' gradients (1e-5); a BatchNorm's running statistics updated as
    JAX updates them, a FrozenBN's left as they were."""
    rng = np.random.RandomState(len(shape))
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    jnorm = jax_layers.Norm(kind=kind)
    variables = _variables(jnorm, jnp.asarray(x), seed=5, train=True)

    def loss(params, x):
        y, upd = jnorm.apply({**variables, "params": params}, x, True,
                             mutable=["batch_stats"])
        return (y * g).sum(), (y, upd)
    with jax.default_matmul_precision("highest"):
        (_, (jy, jupd)), (jgp, jgx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(
                variables.get("params", {}), jnp.asarray(x))

    norm = port_nn.get_norm(kind, shape[-1]).train()
    sd = {}
    params = variables.get("params", {})
    stats = variables.get("batch_stats", {})
    sub = next(iter(params.values()), {})
    if sub:
        sd["weight"], sd["bias"] = _t(np.asarray(sub["scale"])), _t(
            np.asarray(sub["bias"]))
    if stats:
        st = next(iter(stats.values()))
        sd["running_mean"] = _t(np.asarray(st["mean"]))
        sd["running_var"] = _t(np.asarray(st["var"]))
        sd["num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    norm.load_state_dict(sd, strict=True)
    tx = _cf(x).requires_grad_(True)
    y = norm(tx)
    (y * _cf(g)).sum().backward()
    tol = dict(rtol=NORM_TOL, atol=NORM_TOL)
    np.testing.assert_allclose(_cl(y), jy, **tol)
    np.testing.assert_allclose(_cl(tx.grad), jgx, **tol)
    if sub:
        jsub = next(iter(jgp.values()))
        np.testing.assert_allclose(norm.weight.grad.numpy(),
                                   jsub["scale"], **tol)
        np.testing.assert_allclose(norm.bias.grad.numpy(), jsub["bias"],
                                   **tol)
    if stats:
        new = next(iter(jupd["batch_stats"].values()))
        np.testing.assert_allclose(norm.running_mean.numpy(), new["mean"],
                                   **tol)
        np.testing.assert_allclose(norm.running_var.numpy(), new["var"],
                                   **tol)
        if kind == "FrozenBN":
            assert torch.equal(norm.running_mean, sd["running_mean"])
            assert torch.equal(norm.running_var, sd["running_var"])


def test_norm_kinds_and_bf16_statistics():
    """The config names of each kind; GroupNorm's groups (max(1, C // 32));
    a bf16 input normalised with f32 statistics, returned in bf16."""
    kinds = {"BN": port_nn.BatchNorm, "SyncBN": port_nn.BatchNorm,
             "BN3d": port_nn.BatchNorm, "FrozenBN": port_nn.FrozenBatchNorm,
             "GN": port_nn.GroupNorm, "IN": port_nn.InstanceNorm,
             "LN": port_nn.LayerNorm}
    for kind, cls in kinds.items():
        assert type(port_nn.get_norm(kind, 64)) is cls
    assert port_nn.get_norm(None, 8) is None
    assert port_nn.get_norm("None", 8) is None
    with pytest.raises(ValueError, match="unsupported norm"):
        port_nn.get_norm("XN", 8)
    assert [port_nn.GroupNorm(c).groups for c in (8, 48, 64, 96, 320)] == [
        1, 1, 2, 3, 10]
    x = torch.randn(2, 64, 3, 5, generator=torch.Generator().manual_seed(0))
    for kind in ("GN", "IN", "LN"):
        norm = port_nn.get_norm(kind, 64)
        want = norm(x.bfloat16().float())
        got = norm(x.bfloat16())
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.bfloat16().float(),
                                   rtol=0, atol=0)


# ------------------------------------------------------------ prediction ----

def test_prediction_heads_and_registries_match_jax():
    """build_prediction's modules with their config (1e-4), hard_argmin's
    ties to the first index; the four registries hold what JAX's do."""
    rng = np.random.RandomState(1)
    cost = np.round(rng.randn(2, 5, 7, 9), 1).astype(np.float32)
    sample = (rng.rand(2, 5, 7, 9) * 30).astype(np.float32)
    for opts in (["MODEL.PREDICTION.TEMPERATURE", "2.5"],
                 ["MODEL.PREDICTION.NORMALIZE", "False"],
                 ["MODEL.PREDICTION.NAME", "ARGMIN"]):
        want = jax_build_prediction(jax_get_cfg(opts=opts))(
            jnp.asarray(cost), jnp.asarray(sample))
        got = build_prediction(get_cfg(opts=opts))(_t(cost), _t(sample))
        np.testing.assert_allclose(got.numpy(), want, rtol=BLOCK_TOL,
                                   atol=BLOCK_TOL)
    ties = np.zeros((1, 1, 1, 4), np.float32)
    assert float(ops.hard_argmin(_t(ties), _t(sample[:1, :1, :1, :4]))) \
        == sample[0, 0, 0, 0]
    for name in ("BACKBONE", "AGGREGATION", "PREDICTION"):
        ours = getattr(registry, f"{name}_REGISTRY")
        theirs = getattr(jax_registry, f"{name}_REGISTRY")
        assert sorted(ours.keys()) == sorted(theirs.keys())
    assert set(jax_registry.DATASET_REGISTRY.keys()) <= set(
        registry.DATASET_REGISTRY.keys())


# ------------------------------------------------------------------- ops ----

def test_argmins_and_resizes_match_jax():
    """soft_argmin (both branches), hard_argmin and upsample_disp (1e-5)."""
    rng = np.random.RandomState(2)
    cost = rng.randn(2, 6, 8, 11).astype(np.float32)
    sample = (rng.rand(2, 6, 8, 11) * 40).astype(np.float32)
    tol = dict(rtol=OP_TOL, atol=OP_TOL)
    for temperature, normalize in ((1.0, True), (3.0, True), (1.0, False)):
        np.testing.assert_allclose(
            ops.soft_argmin(_t(cost), _t(sample), temperature,
                            normalize).numpy(),
            jax_sampling.soft_argmin(jnp.asarray(cost), jnp.asarray(sample),
                                     temperature, normalize), **tol)
    np.testing.assert_array_equal(
        ops.hard_argmin(_t(cost), _t(sample)).numpy(),
        jax_sampling.hard_argmin(jnp.asarray(cost), jnp.asarray(sample)))
    disp = (rng.rand(2, 6, 8, 1) * 20).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        for size in ((24, 32), (13, 29), (6, 8)):
            want = jax_interpolate.upsample_disp(jnp.asarray(disp), size)
            np.testing.assert_allclose(
                ops.upsample_disp(_t(disp), size).numpy(), want,
                rtol=OP_TOL, atol=OP_TOL * float(np.abs(want).max()))


@pytest.mark.parametrize("window,stride,padding", [
    ((5, 5, 5), (1, 1, 1), (2, 2, 2)),
    ((2, 2, 2), None, (0, 0, 0)),
    ((3, 3, 5), (2, 1, 2), (1, 1, 2)),
    ((3, 1, 1), (1, 1, 1), (1, 0, 0))])
def test_max_pool3d_matches_jax(window, stride, padding):
    """Overlapping, strided and -inf-padded windows, exact (a max)."""
    x = np.random.RandomState(3).randn(2, 7, 9, 10, 4).astype(np.float32)
    want = jax_interpolate.max_pool3d(jnp.asarray(x), window, stride,
                                      padding)
    got = ops.max_pool3d(_t(x), window, stride, padding)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["zeros", "border"])
@pytest.mark.parametrize("with_y", [False, True], ids=["x_only", "x_and_y"])
@pytest.mark.parametrize("depth", [1, 4], ids=["broadcast", "volume"])
def test_inverse_warp_3d_matches_jax(mode, with_y, depth):
    """Both branches (the shift's plain version here, the 4-tap gather),
    a broadcast [B, H, W, C] or a [B, D, H, W, C] volume, shifts that
    leave the image (1e-5)."""
    rng = np.random.RandomState(depth + 2 * with_y)
    b, d, h, w, c = 2, 4, 6, 9, 5
    img = rng.randn(b, h, w, c) if depth == 1 else rng.randn(b, d, h, w, c)
    img = img.astype(np.float32)
    disp = (rng.rand(b, d, h, w) * 12 - 4).astype(np.float32)
    disp_y = ((rng.rand(b, d, h, w) * 8 - 3).astype(np.float32)
              if with_y else None)
    want = jax_warp_3d(jnp.asarray(img), jnp.asarray(disp), mode,
                       None if disp_y is None else jnp.asarray(disp_y))
    got = ops.inverse_warp_3d(_t(img), _t(disp), mode,
                              None if disp_y is None else _t(disp_y))
    assert got.shape == want.shape == (b, d, h, w, c)
    np.testing.assert_allclose(got.numpy(), want, rtol=OP_TOL, atol=OP_TOL)


def test_summation_splat_matches_jax():
    """The bare splat against JAX's einsum and scatter forms, flows that
    send sources out of the frame (1e-5)."""
    rng = np.random.RandomState(4)
    values = rng.randn(2, 7, 10, 3).astype(np.float32)
    flow = (rng.rand(2, 7, 10, 2) * 8 - 4).astype(np.float32)
    got = ops.summation_splat(_t(values), _t(flow)).numpy()
    with jax.default_matmul_precision("highest"):
        for method in ("einsum", "scatter"):
            want = jax_summation_splat(jnp.asarray(values),
                                       jnp.asarray(flow), method)
            np.testing.assert_allclose(got, want, rtol=OP_TOL, atol=OP_TOL)


# ---------------------------------------------------------------- blocks ----

def _block_pair(name, jmodule, args, port_module, seed, train=False):
    variables = _variables(jmodule, *args, seed=seed, train=train)
    sd = module_state_dict_from_jax(name, variables["params"],
                                    variables.get("batch_stats"))
    port_module.load_state_dict(sd, strict=True)
    return variables, port_module.eval()


def _apply(jmodule, variables, *args, train=None):
    """JAX's jitted eval forward (``train`` False, or absent for ConvGRU)."""
    extra = () if train is None else (train,)
    with jax.default_matmul_precision("highest"):
        return np.asarray(jax.jit(
            lambda v, *a: jmodule.apply(v, *a, *extra))(variables, *args))


@pytest.mark.parametrize("norm", ["BN", "GN"])
def test_residual_and_basic_blocks_match_jax(norm):
    """ResidualBlock2D (odd sizes: the skips resize) and a dilated
    BasicBlock, eval mode, with JAX's variables (1e-4)."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 13, 18, 32).astype(np.float32)
    jres = jax_blocks.ResidualBlock2D(32, norm=norm)
    variables, res = _block_pair("ResidualBlock2D", jres,
                                 (jnp.asarray(x),),
                                 port_nn.ResidualBlock2D(32, norm=norm), 6)
    with torch.inference_mode():
        got = _cl(res(_cf(x)))
    np.testing.assert_allclose(
        got, _apply(jres, variables, jnp.asarray(x), train=False),
        rtol=BLOCK_TOL, atol=BLOCK_TOL)

    jbasic = jax_blocks.BasicBlock(32, dilation=2, norm=norm)
    variables, basic = _block_pair(
        "BasicBlock", jbasic, (jnp.asarray(x),),
        port_nn.BasicBlock(32, 32, dilation=2, norm=norm), 7)
    with torch.inference_mode():
        got = _cl(basic(_cf(x)))
    np.testing.assert_allclose(
        got, _apply(jbasic, variables, jnp.asarray(x), train=False),
        rtol=BLOCK_TOL, atol=BLOCK_TOL)


def test_refinement_spp3d_and_gru_match_jax():
    """StereoDRNetRefinement, SPP3D (a volume smaller than the largest
    strides) and ConvGRU, eval mode, with JAX's variables (1e-4)."""
    rng = np.random.RandomState(8)
    h, w = 20, 28
    disp = (rng.rand(1, h, w, 1) * 6).astype(np.float32)
    left, right = (rng.rand(1, h, w, 3).astype(np.float32) for _ in range(2))
    args = tuple(jnp.asarray(a) for a in (disp, left, right))
    jdr = jax_blocks.StereoDRNetRefinement()
    variables, drnet = _block_pair("StereoDRNetRefinement", jdr,
                                   args,
                                   port_nn.StereoDRNetRefinement(), 9)
    with torch.inference_mode():
        got = _cl(drnet(_cf(disp), _cf(left), _cf(right)))
    np.testing.assert_allclose(got, _apply(jdr, variables, *args, train=False),
                               rtol=BLOCK_TOL, atol=BLOCK_TOL)

    vol = rng.randn(1, 6, 18, 20, 12).astype(np.float32)
    jspp = jax_blocks.SPP3D(12)
    variables, spp = _block_pair("SPP3D", jspp, (jnp.asarray(vol),),
                                 port_nn.SPP3D(12), 10)
    with torch.inference_mode():
        got = _cl(spp(_cf(vol)))
    np.testing.assert_allclose(
        got, _apply(jspp, variables, jnp.asarray(vol), train=False),
        rtol=BLOCK_TOL, atol=BLOCK_TOL)

    hid = rng.randn(2, 10, 12, 8).astype(np.float32)
    inp = rng.randn(2, 10, 12, 6).astype(np.float32)
    jgru = jax_layers.ConvGRU(hidden=8)
    variables, gru = _block_pair("ConvGRU", jgru,
                                 (jnp.asarray(hid), jnp.asarray(inp)),
                                 port_nn.ConvGRU(8, 6), 11, train=None)
    with torch.inference_mode():
        got = _cl(gru(_cf(hid), _cf(inp)))
    np.testing.assert_allclose(
        got, _apply(jgru, variables, jnp.asarray(hid), jnp.asarray(inp)),
        rtol=BLOCK_TOL, atol=BLOCK_TOL)


# --------------------------------------------------- a GroupNorm model ----

def test_group_norm_model_folds_casts_and_serves(tmp_path):
    """The tiny model with GN everywhere JAX allows it: a JAX ``.msgpack``
    of its variables loads every tensor, equal to ``state_dict_from_jax``;
    the port folds the BatchNorms JAX folds (the trunk's, the convex
    upsamplers', the UNet's) and leaves every GroupNorm in the forward;
    folded against unfolded at 2e-3; with bf16-stored weights it still
    runs in f32; the CPU bundle gives streaming_step's frames bit for
    bit."""
    from tests.test_torch_serving import H, W, _frames, _stream

    opts = TINY + TEMPORAL + GN_NORMS
    jmodel = jax_build_model(jax_get_cfg(opts=opts), dtype=None)
    variables = _jax_variables(jmodel, H, W, seed=12)
    _, paths = jax_fold_batch_norms(variables)

    def port():
        model = build_model(get_cfg(opts=opts), device="cpu")
        model.load_state_dict(state_dict_from_jax(
            variables["params"], variables["batch_stats"], TINY_GROUPS),
            strict=True)
        return model
    model = port()
    path = str(tmp_path / "gn.msgpack")
    jax_save_weights(path, variables["params"], variables["batch_stats"])
    loaded = build_model(get_cfg(opts=opts), device="cpu", seed=1)
    assert load_weights(loaded, path) == len(loaded.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    groups = sum(isinstance(m, port_nn.GroupNorm) for m in model.modules())
    folded, names = fold_batch_norms(port())
    assert len(names) == len(paths) > 0 and groups > 0
    assert sum(isinstance(m, port_nn.GroupNorm)
               for m in folded.modules()) == groups
    frames = _frames(2, seed=44)
    ref = _stream(model, frames)
    for f, (want, got) in enumerate(zip(ref, _stream(folded, frames))):
        for i, (r, g) in enumerate(zip(want, got)):
            rel = _rel(g.numpy(), r.numpy())
            assert rel < SINGLE_TOL, f"frame {f} disparity {i}: {rel:.2e}"
    for f, out in enumerate(_stream(cast_params_bf16(port()), frames)):
        assert all(d.dtype == torch.float32 and torch.isfinite(d).all()
                   for d in out), f
    from tests.test_torch_serving import _geometry

    K, bl, T = _geometry()
    bundle = StreamingBundle(bundle_meta(model, 1, H, W), model)
    for (left, right), want in zip(frames, ref):
        assert torch.equal(bundle.step(left, right, K, bl, T), want[0])


# ------------------------------------------------------------ colour maps ---

def test_colour_maps_equal_jax():
    """flow_to_color (own and given maximum), flow_err_to_color (with and
    without a valid mask, errors across every bin) and
    disp_err_to_color, equal to JAX's."""
    rng = np.random.RandomState(13)
    flow = (rng.randn(17, 23, 2) * 5).astype(np.float32)
    for max_flow in (None, 4.0):
        np.testing.assert_array_equal(
            flow_to_color(flow, max_flow),
            jax_flow.flow_to_color(flow, max_flow))
    est = flow + (rng.randn(17, 23, 2) * np.logspace(-2, 2, 23)[None, :, None]
                  ).astype(np.float32)
    valid = rng.rand(17, 23) > 0.3
    for mask in (None, valid):
        np.testing.assert_array_equal(
            flow_err_to_color(est, flow, mask),
            jax_flow.flow_err_to_color(est, flow, mask))
    gt = rng.rand(17, 23) * (rng.rand(17, 23) > 0.2)
    dest = gt + rng.randn(17, 23) * np.logspace(-4, 0, 23)[None, :]
    np.testing.assert_array_equal(disp_err_to_color(dest, gt),
                                  jax_disparity.disp_err_to_color(dest, gt))
