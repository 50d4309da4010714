"""The tiny GroupNorm / InstanceNorm / LayerNorm temporal stream, the port
against the JAX package frame by frame on the CPU, each frame from JAX's
own carried state.  Each test prints what it measured (``pytest -s``).

1. The stream of tests/test_torch_faults.py (GN in the FPN and the coarse
   stage, IN fine, LN precise; 96x128, 3 cm sideways and 5 cm forward a
   frame) for five frames: every disparity within 2e-3 on the first frame
   and 5e-3 on the streamed ones, the model tests' tolerances (measured:
   2.2e-6 at most, on every frame), JAX compiled with XLA's CPU
   optimisations off as in tests/test_torch_model.py.
2. The stream that ``chip_smoke.py`` phase 15 runs (GN in the FPN, IN
   coarse, LN fine, FrozenBN precise; 96x160, 2 cm sideways and 0.5 m
   forward a frame), on JAX's weights: from JAX's state after the first
   frame, the port's forward from JAX's *warped* state holds 5e-3
   (measured 4.6e-6), while the warp itself (``update_prev_info``) is
   discontinuous in JAX as in the port.  The softmax splat divides each
   1/8-grid cell's sum by its total weight (+ 1e-22), so a point that
   lands within rounding of a grid line moves a neighbouring cell between
   empty and its full value: JAX's own warp, from its state scaled by
   1 + N(0, 1e-7^2), moves a few of the 720 cells of the warped cost
   memory and local map by more than 0.1 px (measured over 4 draws: 7-19
   cells, up to 7.87 px), and the port's warp differs from JAX's in as
   few (13 cells, up to 33.4 px).  Through the stream's later frames that
   amplifies into the whole disparity map: that is the ill-conditioning
   that phase 15 holds to its first two frames, and it is the model's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from temporalstereo_tpu.config import get_cfg as jax_get_cfg
from temporalstereo_tpu.models import build_model as jax_build_model
from temporalstereo_tpu.models.stereo import (
    backbone_memory_shapes as jax_memory_shapes)
from temporalstereo_tpu.models.stereo import init_prev_info as jax_init_prev
from temporalstereo_tpu.models.stereo import (
    update_prev_info as jax_update_prev_info)
from temporalstereo_tpu.models.temporal import (
    streaming_step as jax_streaming_step)

from temporalstereo_tpu_torch.config import get_cfg
from temporalstereo_tpu_torch.models import build_model, streaming_step
from temporalstereo_tpu_torch.models.aggregation import CostMemory
from temporalstereo_tpu_torch.models.backbone import TINY_GROUPS
from temporalstereo_tpu_torch.models.stereo import (PrevInfo,
                                                    update_prev_info)
from temporalstereo_tpu_torch.utils.convert import state_dict_from_jax

from tests.test_torch_model import (FAST_COMPILE, TEMPORAL, TINY,
                                    _geometry, _jax_variables, _rel)

SINGLE_TOL, TEMPORAL_TOL = 2e-3, 5e-3
FAULTS_NORMS = ["MODEL.BACKBONE.NORM", "GN",
                "MODEL.AGGREGATION.COARSE.NORM", "GN",
                "MODEL.AGGREGATION.FINE.NORM", "IN",
                "MODEL.AGGREGATION.PRECISE.NORM", "LN"]
PHASE15_NORMS = ["MODEL.BACKBONE.NORM", "GN",
                 "MODEL.AGGREGATION.COARSE.NORM", "IN",
                 "MODEL.AGGREGATION.FINE.NORM", "LN",
                 "MODEL.AGGREGATION.PRECISE.NORM", "FrozenBN"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _to_port(p) -> PrevInfo:
    """JAX's carried state in the port's layout (backbone memories
    channels-first)."""
    def t(a):
        return torch.from_numpy(np.array(a))
    return PrevInfo(
        memories=tuple(t(m).permute(0, 3, 1, 2).contiguous()
                       for m in p.memories),
        has_memory=bool(p.has_memory),
        cost_memory=CostMemory(t(p.cost_memory.disp_sample),
                               t(p.cost_memory.cost_volume),
                               bool(p.cost_memory.valid)),
        prev_disp=t(p.prev_disp), local_map=t(p.local_map),
        local_map_valid=bool(p.local_map_valid))


def _scaled(tree, rng, eps):
    """Every f32 array of a state scaled by 1 + N(0, eps^2)."""
    def leaf(a):
        a = np.asarray(a)
        if a.dtype != np.float32 or a.size == 0:
            return jnp.asarray(a)
        return jnp.asarray(a * (1 + eps * rng.randn(*a.shape)).astype(
            np.float32))
    return jax.tree.map(leaf, tree)


def _setup(norms, h, w, motion, compiler_options=None):
    opts = TINY + TEMPORAL + norms
    jmodel = jax_build_model(jax_get_cfg(opts=opts), dtype=None)
    variables = _jax_variables(jmodel, h, w, seed=55)
    model = build_model(get_cfg(opts=opts), device="cpu")
    model.load_state_dict(state_dict_from_jax(
        variables["params"], variables["batch_stats"], TINY_GROUPS),
        strict=True)
    K, baseline, T = _geometry(h, w)
    T[0, 0, 3], T[0, 2, 3] = motion
    geometry = tuple(jnp.asarray(a) for a in (K, baseline, T))
    steps = {warp: jax.jit(lambda v, l, r, p, warp=warp: jax_streaming_step(
        jmodel, v, l, r, p, *geometry, warp=warp),
        compiler_options=compiler_options) for warp in (False, True)}
    jprev = jax_init_prev(jmodel, 1, (h, w),
                          jax_memory_shapes(jmodel.backbone_cfg, (h, w)), 2,
                          jnp.float32, local_map_channels=0)
    return (model, variables, steps, jprev, geometry,
            tuple(torch.from_numpy(a) for a in (K, baseline, T)))


def test_gn_stream_matches_jax_frame_by_frame_from_jax_state():
    h, w = 96, 128
    model, variables, steps, jprev, _, tgeo = _setup(
        FAULTS_NORMS, h, w, (0.03, -0.05), FAST_COMPILE)
    rng = np.random.RandomState(56)
    worst = []
    for f in range(5):
        left, right = (rng.rand(1, h, w, 3).astype(np.float32)
                       for _ in range(2))
        with jax.default_matmul_precision("highest"):
            jout, jnext = steps[f > 0](variables, jnp.asarray(left),
                                       jnp.asarray(right), jprev)
        with torch.inference_mode():
            tout, _ = streaming_step(model, torch.from_numpy(left),
                                     torch.from_numpy(right), _to_port(jprev),
                                     *tgeo, warp=f > 0)
        tol = SINGLE_TOL if f == 0 else TEMPORAL_TOL
        rels = [_rel(t.numpy(), j)
                for j, t in zip(jout["disps"], tout["disps"])]
        worst.append(max(rels))
        for i, rel in enumerate(rels):
            assert rel < tol, f"frame {f} disparity {i}: rel={rel:.2e}"
        jprev = jnext
    print(f"port from JAX's state, worst disparity rel by frame: "
          f"{[float(f'{x:.3g}') for x in worst]}")


def _warped(prev):
    """(cost-memory samples, local map) of a warped state, as numpy."""
    return (np.asarray(prev.cost_memory.disp_sample),
            np.asarray(prev.local_map))


def test_phase15_stream_warp_is_discontinuous_in_jax_itself():
    h, w = 96, 160
    model, variables, steps, jprev, geometry, tgeo = _setup(
        PHASE15_NORMS, h, w, (0.02, -0.5))
    rng = np.random.RandomState(56)
    frames = [[rng.rand(1, h, w, 3).astype(np.float32) for _ in range(2)]
              for _ in range(2)]
    with jax.default_matmul_precision("highest"):
        _, jprev = steps[False](variables, *map(jnp.asarray, frames[0]),
                                jprev)
        jout, _ = steps[True](variables, *map(jnp.asarray, frames[1]), jprev)
    warp = jax.jit(lambda p: jax_update_prev_info(
        p, *geometry, (h, w), True, 3))
    jwarped = warp(jprev)
    ref = _warped(jwarped)
    # JAX against itself: its state scaled by 1 + N(0, 1e-7^2)
    noise = np.random.RandomState(9)
    jax_moves = [[np.abs(a - b) for a, b in zip(
        _warped(warp(_scaled(jprev, noise, 1e-7))), ref)] for _ in range(4)]
    jax_px = [max(float(d.max()) for d in m) for m in jax_moves]
    jax_cells = [sum(int((d > 1e-3).sum()) for d in m) for m in jax_moves]
    assert max(jax_px) > 0.1 and max(jax_cells) <= 32
    # the port's warp from the same state parts from JAX's in as few cells
    ours = update_prev_info(_to_port(jprev), *tgeo, (h, w), True, 3)
    port_moves = [np.abs(a - b) for a, b in zip(
        (ours.cost_memory.disp_sample.numpy(), ours.local_map.numpy()), ref)]
    port_cells = [int((d > 1e-3).sum()) for d in port_moves]
    assert sum(port_cells) <= 32
    # the port's forward from JAX's warped state holds
    with torch.inference_mode():
        tout, _ = streaming_step(model, *map(torch.from_numpy, frames[1]),
                                 _to_port(jwarped), *tgeo, warp=False)
    rels = [_rel(t.numpy(), j) for j, t in zip(jout["disps"], tout["disps"])]
    print(f"frame 1's warp: JAX from its state x (1 + N(0, 1e-7^2)), 4 "
          f"draws: max px moved {[float(f'{x:.3g}') for x in jax_px]}, "
          f"cells moved > 1e-3 {jax_cells} of {sum(d.size for d in ref)}; "
          f"the port from JAX's state: cells apart (cost memory, local "
          f"map) {port_cells}, max px "
          f"{max(float(d.max()) for d in port_moves):.3g}; "
          f"the port's forward from JAX's warped state: worst disparity rel "
          f"{max(rels):.3g}")
    for i, rel in enumerate(rels):
        assert rel < TEMPORAL_TOL, f"disparity {i}: rel={rel:.2e}"
