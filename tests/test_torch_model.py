"""The port's model (temporalstereo_tpu_torch) against the JAX package on
the CPU: the weight converter, the single-frame forward and the temporal
stream with exact local-map growth.

Both sides get the same weights (the JAX model's variables, moved by the
port's ``state_dict_from_jax``) and the same numpy inputs.  The JAX side runs
jitted (eager op-by-op dispatch compiles every op on its first call, ten
times slower here) at ``default_matmul_precision("highest")``: CPU matmuls
default to bf16-level precision.  Tolerances are relative, max|d| / mean|ref|, and no
looser than the repo's torch-mirror parity tests: 2e-3 single-frame
(tests/test_torch_export.py) and 5e-3 for streamed frames
(tests/test_temporal_parity.py).  The cascade's top-k and sort amplify
float-rounding differences near ties, which is why they are not 1e-5.
The tiny model's JAX jits compile with XLA's CPU optimisations off
(``FAST_COMPILE``, as tests/test_torch_train_step.py's): the stream's
growth frames each compile their own program, and the unoptimised ones
compile in about half the time and agree with the port as closely.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from temporalstereo_tpu.config import get_cfg as jax_get_cfg
from temporalstereo_tpu.models import build_model as jax_build_model
from temporalstereo_tpu.models.backbone import TINY_GROUPS as JAX_TINY
from temporalstereo_tpu.models.stereo import (
    backbone_memory_shapes as jax_memory_shapes)
from temporalstereo_tpu.models.stereo import init_prev_info as jax_init_prev
from temporalstereo_tpu.models.temporal import (
    streaming_step as jax_streaming_step)
from temporalstereo_tpu.utils.torch_export import export_reference_checkpoint

from temporalstereo_tpu_torch.config import get_cfg
from temporalstereo_tpu_torch.models import (backbone_memory_shapes,
                                             build_model, init_prev_info,
                                             streaming_step)
from temporalstereo_tpu_torch.models.backbone import TINY_GROUPS
from temporalstereo_tpu_torch.utils.convert import state_dict_from_jax

SINGLE_TOL = 2e-3
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
TEMPORAL_TOL = 5e-3
TINY = ["MODEL.BACKBONE.VARIANT", "tiny",
        "MODEL.AGGREGATION.COARSE.C", "8",
        "MODEL.AGGREGATION.FINE.C", "8",
        "MODEL.AGGREGATION.PRECISE.C", "8",
        "TRAINER.PRECISION", "f32"]
TEMPORAL = ["MODEL.WITH_PREVIOUS", "True",
            "MODEL.USE_PAST_COST", "True",
            "MODEL.LOCAL_MAP_SIZE", "3",
            "MODEL.BACKBONE.MEMORY_PERCENT", "0.5"]


def _jax_variables(jmodel, h, w, seed):
    """Random variables for the JAX model, drawn with numpy from its
    variable shapes (``eval_shape`` runs no model code): conv kernels
    N(0, 1/fan_in), non-trivial BN affine params and running statistics,
    small biases."""
    x = jax.ShapeDtypeStruct((1, h, w, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda r, x: jmodel.init({"params": r}, x, x, None, False),
        jax.random.PRNGKey(0), x)
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            v = rng.randn(*s.shape) / np.sqrt(fan_in)
        elif name in ("scale", "var"):
            v = rng.rand(*s.shape) * 0.5 + 0.75
        elif name in ("bias", "mean"):
            v = rng.randn(*s.shape) * 0.1
        else:
            v = np.zeros(s.shape)
        return np.asarray(v, np.float32)
    return {c: jax.tree_util.tree_map_with_path(leaf, shapes[c])
            for c in ("params", "batch_stats")}


def _pair(opts, h, w, seed):
    """The JAX model with random variables and the port model loaded with
    the same weights."""
    jmodel = jax_build_model(jax_get_cfg(opts=opts), dtype=None)
    variables = _jax_variables(jmodel, h, w, seed)
    tmodel = build_model(get_cfg(opts=opts), device="cpu")
    groups = TINY_GROUPS if "tiny" in opts else None
    tmodel.load_state_dict(
        state_dict_from_jax(variables["params"], variables["batch_stats"],
                            groups), strict=True)
    return jmodel, variables, tmodel


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).mean() + 1e-6)


def test_converter_bit_equal_to_exporter_and_strict_loads():
    jmodel = jax_build_model(jax_get_cfg(opts=TINY + TEMPORAL), dtype=None)
    variables = _jax_variables(jmodel, 64, 96, seed=3)
    params, stats = variables["params"], variables["batch_stats"]

    ours = state_dict_from_jax(params, stats, TINY_GROUPS)
    ref = export_reference_checkpoint(params, stats, JAX_TINY)
    assert set(ours) == set(ref)
    for k, v in ref.items():
        got = ours[k].numpy()
        assert got.dtype == v.dtype and got.shape == v.shape, k
        np.testing.assert_array_equal(got, v, err_msg=k)

    model = build_model(get_cfg(opts=TINY + TEMPORAL), device="cpu")
    model.load_state_dict(ours, strict=True)


def test_single_frame_matches_jax():
    h, w = 96, 160
    jmodel, variables, tmodel = _pair(TINY, h, w, seed=11)
    rng = np.random.RandomState(12)
    left = rng.rand(1, h, w, 3).astype(np.float32)
    right = rng.rand(1, h, w, 3).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        jout, _ = jax.jit(lambda v, l, r: jmodel.apply(v, l, r, None, False),
                          compiler_options=FAST_COMPILE)(
            variables, jnp.asarray(left), jnp.asarray(right))
    with torch.inference_mode():
        tout, tprev = tmodel(torch.from_numpy(left), torch.from_numpy(right))
    assert tprev is None and len(tout["disps"]) == 4
    for i, (j, t) in enumerate(zip(jout["disps"], tout["disps"])):
        assert t.shape == j.shape
        rel = _rel(t.numpy(), j)
        assert rel < SINGLE_TOL, f"disparity {i}: rel={rel:.2e}"


def _geometry(h, w):
    K = np.array([[[30.0, 0, w / 2], [0, 30.0, h / 2], [0, 0, 1]]],
                 np.float32)
    baseline = np.array([2.0], np.float32)
    T = np.eye(4, dtype=np.float32)[None]
    T[0, 0, 3], T[0, 2, 3] = 0.03, -0.05
    return K, baseline, T


def _check_state(jprev, tprev, tol):
    pairs = [("cost_memory.disp_sample", jprev.cost_memory.disp_sample,
              tprev.cost_memory.disp_sample),
             ("cost_memory.cost_volume", jprev.cost_memory.cost_volume,
              tprev.cost_memory.cost_volume),
             ("prev_disp", jprev.prev_disp, tprev.prev_disp),
             ("local_map", jprev.local_map, tprev.local_map)]
    # backbone memories: the port keeps them [2B, mc, h, w] (channels-first)
    pairs += [(f"memories[{i}]", jm, tm.permute(0, 2, 3, 1))
              for i, (jm, tm) in enumerate(zip(jprev.memories,
                                                tprev.memories))]
    assert len(jprev.memories) == len(tprev.memories)
    for name, j, t in pairs:
        assert tuple(t.shape) == j.shape, name
        if j.size:
            rel = _rel(t.numpy(), j)
            assert rel < tol, f"state {name}: rel={rel:.2e}"
    assert tprev.cost_memory.valid == bool(jprev.cost_memory.valid)
    assert tprev.local_map_valid == bool(jprev.local_map_valid)


def test_streaming_matches_jax_with_exact_growth():
    """Five frames: the local map grows 0 -> 3 channels, then the stream
    reaches its steady state (fine stage D = 8)."""
    h, w, frames = 96, 160, 5
    opts = TINY + TEMPORAL
    jmodel, variables, tmodel = _pair(opts, h, w, seed=21)
    K, baseline, T = _geometry(h, w)
    rng = np.random.RandomState(22)

    jprev = jax_init_prev(jmodel, 1, (h, w),
                          jax_memory_shapes(jmodel.backbone_cfg, (h, w)), 2,
                          jnp.float32, local_map_channels=0)
    tprev = init_prev_info(tmodel, 1, (h, w),
                           backbone_memory_shapes(tmodel.backbone_cfg, (h, w)),
                           2, local_map_channels=0)
    jax_step = {warp: jax.jit(lambda v, l, r, p, warp=warp: jax_streaming_step(
        jmodel, v, l, r, p, jnp.asarray(K), jnp.asarray(baseline),
        jnp.asarray(T), warp=warp), compiler_options=FAST_COMPILE)
        for warp in (False, True)}
    for f in range(frames):
        left = rng.rand(1, h, w, 3).astype(np.float32)
        right = rng.rand(1, h, w, 3).astype(np.float32)
        with jax.default_matmul_precision("highest"):
            jout, jprev = jax_step[f > 0](variables, jnp.asarray(left),
                                          jnp.asarray(right), jprev)
        tout, tprev = streaming_step(
            tmodel, torch.from_numpy(left), torch.from_numpy(right), tprev,
            torch.from_numpy(K), torch.from_numpy(baseline),
            torch.from_numpy(T))
        assert tout["disp_samples"][1].shape[-1] == 5 + min(f, 3) + 2
        for i, (j, t) in enumerate(zip(jout["disps"], tout["disps"])):
            rel = _rel(t.numpy(), j)
            assert rel < TEMPORAL_TOL, f"frame {f} disparity {i}: {rel:.2e}"
        if f > 0:
            rel = _rel(tout["local_map"].numpy(), jout["local_map"])
            assert rel < TEMPORAL_TOL, f"frame {f} local map: {rel:.2e}"
        _check_state(jprev, tprev, TEMPORAL_TOL)


@pytest.mark.slow
def test_single_frame_matches_jax_full_width():
    """v2s trunk and full stage widths (the flagship's), f32."""
    h, w = 128, 256
    jmodel, variables, tmodel = _pair(["TRAINER.PRECISION", "f32"], h, w,
                                      seed=31)
    rng = np.random.RandomState(32)
    left = rng.rand(1, h, w, 3).astype(np.float32)
    right = rng.rand(1, h, w, 3).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        jout, _ = jax.jit(lambda v, l, r: jmodel.apply(v, l, r, None, False))(
            variables, jnp.asarray(left), jnp.asarray(right))
    with torch.inference_mode():
        tout, _ = tmodel(torch.from_numpy(left), torch.from_numpy(right))
    for i, (j, t) in enumerate(zip(jout["disps"], tout["disps"])):
        rel = _rel(t.numpy(), j)
        assert rel < SINGLE_TOL, f"disparity {i}: rel={rel:.2e}"
