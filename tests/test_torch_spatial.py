"""The port's W-axis spatial sharding (temporalstereo_tpu_torch.parallel.
spatial) on four gloo ranks on the CPU, against the JAX package's
``make_spatial_forward`` and the port's own unsharded forward.

Four processes (``tests/torch_spatial_ranks.py``) join a gloo group
through a file store under the test's temporary directory, while this
process computes the references; the group has a deadline (``DEADLINE``
seconds, after which every rank is killed and the test fails) and each of
its collectives a 60 s timeout.  On the tiny f32 model with the weights of
a JAX variable tree (``utils/convert.py:state_dict_from_jax``), the ranks
run the single-frame eval forward sharded along W:
  * at the JAX test's [2, 32, 128, 3] (``tests/test_parallel.py:158``) on
    a (1 data x 4 spatial) grid, one column of the 1/32 level a rank and
    shards of none at 1/64, and on a (2 x 2) grid;
  * at [2, 32, 160, 3] on a (2 x 2) grid with uneven shards of 64 and 96
    columns;
each rank's disparity slice held within ``ATOL`` (the JAX test's 1e-4)
of JAX's ``make_spatial_forward`` over ``make_2d_mesh(2, 4)`` (conftest's
8 virtual devices) and of the port's unsharded forward; a second frame
equal to the first; the slices gathered over a row equal to the row's
whole disparity.  Each exchange primitive (a convolution halo of four
one-column shards, a strided one, one down to ranks with no column and a
transposed one back up, the squeeze-excite mean, resizes in the frame's
coordinates, the dense and the offset cost volumes with their pooled
pyramid, the fusion's pools, the convex and mask upsamples) is held on a
(1 x 4) grid against its full-width op within ``PRIM_TOL`` of the output's
largest value.  The grid's and the forward's refusals are checked, and the
offset forms of the cost base and the shift against their full-width
calls in this process.
"""
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax

from temporalstereo_tpu.config import get_cfg as jax_get_cfg
from temporalstereo_tpu.models import build_model as jax_build_model
from temporalstereo_tpu.parallel import spatial as jax_spatial

from temporalstereo_tpu_torch.config import get_cfg
from temporalstereo_tpu_torch.kernels import (fused_cost_base,
                                              fused_cost_base_plain, shift_1d)
from temporalstereo_tpu_torch.models import build_model
from temporalstereo_tpu_torch.models.backbone import TINY_GROUPS
from temporalstereo_tpu_torch.parallel import (active_plan, column_bounds,
                                               make_2d_mesh,
                                               make_spatial_forward,
                                               shard_images)
from temporalstereo_tpu_torch.utils.convert import state_dict_from_jax

from tests.test_torch_train_step import FAST_COMPILE, _jax_variables

REPO = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
DEADLINE = 120
ATOL = 1e-4               # tests/test_parallel.py:test_spatial_sharded_...
PRIM_TOL = 1e-5
OPTS = ["MODEL.BACKBONE.VARIANT", "tiny",
        "MODEL.AGGREGATION.COARSE.C", "8",
        "MODEL.AGGREGATION.FINE.C", "8",
        "MODEL.AGGREGATION.PRECISE.C", "8",
        "TRAINER.PRECISION", "f32"]
B, H = 2, 32
# name: (data, spatial, image width); 160 on 2 splits 64 + 96
LAYOUTS = {"1x4": (1, 4, 128), "2x2": (2, 2, 128),
           "2x2_uneven_160": (2, 2, 160)}
PRIMITIVES = ("conv_halo_of_four", "conv_stride_bn_silu",
              "conv_down_to_empty", "conv_transpose_from_empty",
              "squeeze_excite", "resize_bilinear_up",
              "resize_trilinear_down", "block_cost_dense",
              "block_cost_fused_offset", "block_cost_shift_offset",
              "pyramid_fusion_pools", "convex_upsample", "mask_upsample_9")


def _images(width, seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.rand(B, H, width, 3).astype(np.float32)
                 for _ in range(2))


def _launch(directory):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_spatial_ranks", str(directory),
         str(r), str(WORLD)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]


def _join(procs, directory, t_end):
    """Each rank's result; every rank killed at the deadline or when one
    fails."""
    try:
        for r, p in enumerate(procs):
            log = p.communicate(timeout=max(t_end - time.time(), 1))[0]
            if p.returncode != 0:
                raise AssertionError(f"rank {r} exited {p.returncode}:\n"
                                     f"{log[-4000:]}")
    except subprocess.TimeoutExpired:
        raise AssertionError(f"the ranks passed their {DEADLINE} s "
                             "deadline") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [torch.load(directory / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _jax_spatial_forward(jmodel, variables, left, right):
    """JAX's make_spatial_forward over a (2, 4) mesh of conftest's virtual
    devices, XLA's CPU optimisations off."""
    jit = jax.jit
    jax.jit = lambda fun, **kw: jit(fun, compiler_options=FAST_COMPILE, **kw)
    try:
        run = jax_spatial.make_spatial_forward(
            jmodel, variables, jax_spatial.make_2d_mesh(2, 4))
        with jax.default_matmul_precision("highest"):
            return np.array(run(left, right))
    finally:
        jax.jit = jit


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' results, JAX's sharded disparity at width 128, the
    port's unsharded disparity at each width)."""
    directory = tmp_path_factory.mktemp("spatial")
    jmodel = jax_build_model(jax_get_cfg(opts=OPTS), dtype=None)
    variables = _jax_variables(jmodel, seed=5)
    images = {128: _images(128, 0), 160: _images(160, 1)}
    state_dict = state_dict_from_jax(variables["params"],
                                     variables["batch_stats"], TINY_GROUPS)
    job = {"opts": OPTS, "state_dict": state_dict, "images": images,
           "layouts": LAYOUTS, "bounds": column_bounds(128, WORLD)}
    torch.save(job, directory / "job.pt")
    t_end = time.time() + DEADLINE
    procs = _launch(directory)
    try:
        jout = _jax_spatial_forward(jmodel, variables, *images[128])
        model = build_model(get_cfg(opts=OPTS), device="cpu")
        model.load_state_dict(state_dict, strict=True)
        model.eval()
        with torch.no_grad():
            plain = {w: model(torch.from_numpy(l), torch.from_numpy(r),
                              None)[0]["disps"][0]
                     for w, (l, r) in images.items()}
    finally:
        ranks = _join(procs, directory, t_end)
    return {"ranks": ranks, "jax": jout, "plain": plain, "model": model,
            "images": images}


def test_port_unsharded_forward_matches_jax_sharded_forward(runs):
    assert runs["jax"].shape == (B, H, 128, 1)
    np.testing.assert_allclose(runs["plain"][128].numpy(), runs["jax"],
                               atol=ATOL)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sharded_forward_matches_jax_and_unsharded(runs, layout):
    data, spatial, width = LAYOUTS[layout]
    bounds = column_bounds(width, spatial)
    rows = B // data
    for r, out in enumerate(runs["ranks"]):
        got = out["forwards"][layout]
        row, col = divmod(r, spatial)
        x0, x1 = bounds[col], bounds[col + 1]
        assert got["columns"] == (x0, x1)
        assert got["disp"].shape == (rows, H, x1 - x0, 1)
        assert got["again_equal"], f"rank {r}: the second frame differs"
        assert got["stats"]["fetches"] > 0 and "discoveries" not in \
            got["stats"], got["stats"]
        batch = slice(row * rows, (row + 1) * rows)
        refs = [runs["plain"][width][batch]]
        if width == 128:
            refs.append(torch.from_numpy(runs["jax"][batch]))
        for ref in refs:
            np.testing.assert_allclose(got["disp"].numpy(),
                                       ref[:, :, x0:x1].numpy(), atol=ATOL)
            np.testing.assert_allclose(got["gathered"].numpy(), ref.numpy(),
                                       atol=ATOL)


@pytest.mark.parametrize("name", PRIMITIVES)
def test_exchange_primitive_matches_full_width(runs, name):
    for r, out in enumerate(runs["ranks"]):
        err, shape, ref_shape, top = out["primitives"][name]
        assert shape == ref_shape, f"rank {r}: {shape} != {ref_shape}"
        assert err <= PRIM_TOL * top, f"rank {r}: {err:.3g} of {top:.3g}"


def test_grid_and_forward_refusals(runs):
    for out in runs["ranks"]:
        assert "needs 3 rank(s) but 4 were launched" in out["refusals"][
            "grid"]
        assert "has no ranks" in out["refusals"]["empty"]
        assert "inference only" in out["forwards"]["grad_refusal"]
        assert "GroupNorm" in out["forwards"]["gn_refusal"]
    with pytest.raises(ValueError, match="do not split"):
        column_bounds(64, 4)


def test_spatial_size_one_is_the_plain_forward(runs):
    """Without a group every exchange is the identity: no plan is active
    and the disparity is the plain forward's, bit for bit."""
    mesh = make_2d_mesh(1, 1)
    assert not mesh.active and active_plan() is None
    assert column_bounds(1248, 2) == (0, 640, 1248)
    assert column_bounds(160, 2) == (0, 64, 160)
    left, right = runs["images"][160]
    run = make_spatial_forward(runs["model"], mesh)
    assert torch.equal(run(left, right), runs["plain"][160])
    assert run.columns == (0, 160)
    _, _, cols = shard_images(mesh, left, right)
    assert cols == (0, 160)
    with pytest.raises(RuntimeError, match="inference only"):
        run(torch.from_numpy(left).requires_grad_(), right)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_offset_cost_base_and_shift_match_full_width(dtype):
    """The cost base and the shift at a column offset against a target of
    another width: this shard's columns of the full-width call, bit for
    bit; offset 0 is the plain call."""
    g = torch.Generator().manual_seed(3)
    b, h, w, c, d = 1, 3, 40, 16, 5
    ref = torch.randn((b, h, w, c), generator=g).to(dtype)
    tgt = torch.randn((b, h, w, c), generator=g).to(dtype)
    disp = torch.rand((b, d, h, w), generator=g) * (w + 6) - 3
    full = fused_cost_base(ref, tgt, disp)
    assert torch.equal(fused_cost_base(ref, tgt, disp, 0, 0), full)
    x0, x1 = 12, 28
    part = (ref[:, :, x0:x1].contiguous(), tgt,
            disp[..., x0:x1].contiguous())
    assert torch.equal(fused_cost_base(*part, x0, 0), full[:, :, :, x0:x1])
    assert torch.equal(fused_cost_base_plain(*part, x0, 0),
                       full[:, :, :, x0:x1])
    # a target window [t0, t1) that holds every tap these hypotheses reach
    near = disp[..., x0:x1].clamp(0, 4).contiguous()
    t0, t1 = x0 - 5, x1
    windowed = fused_cost_base(part[0], tgt[:, :, t0:t1].contiguous(), near,
                               x0, t0)
    assert torch.equal(windowed, fused_cost_base(ref, tgt, torch.cat(
        [disp[..., :x0], near, disp[..., x1:]], -1))[:, :, :, x0:x1])
    img = tgt[:, None].contiguous()
    shifted = shift_1d(img, -disp)
    assert torch.equal(shift_1d(img, -disp[..., x0:x1].contiguous(), x0, 0),
                       shifted[:, :, :, x0:x1])
    with pytest.raises(ValueError, match="does not match"):
        shift_1d(img[:, :, :2].contiguous(), -disp)
