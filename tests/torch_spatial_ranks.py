"""One rank of tests/test_torch_spatial.py's four-rank gloo group.

    python -m tests.torch_spatial_ranks DIR RANK WORLD

Joins the group through the file store ``DIR/store`` (every collective
raises after 60 s), reads the job that the test wrote to ``DIR/job.pt``
and writes what this rank computed to ``DIR/rank<RANK>.pt``: the grid's
refusals; for each of the job's layouts, the W-sharded forward of the tiny
model (two frames, the second from the widths the first learnt), its
columns, its collectives and the disparity gathered over its row; and, on
a (1, 4) grid, each exchange primitive's max |sharded - full width| on this
rank's columns.  It imports torch and the port only.
"""
import datetime
import os
import sys

import torch
import torch.distributed as dist

from temporalstereo_tpu_torch.config import get_cfg
from temporalstereo_tpu_torch.models import build_model
from temporalstereo_tpu_torch.models.backbone import SqueezeExcite
from temporalstereo_tpu_torch.nn.blocks import PyramidFusion
from temporalstereo_tpu_torch.nn.layers import Conv2d, Conv3d, ConvTranspose3d
from temporalstereo_tpu_torch.ops.cost import block_cost
from temporalstereo_tpu_torch.ops.interpolate import (resize_bilinear,
                                                      resize_trilinear)
from temporalstereo_tpu_torch.ops.upsample import (convex_upsample,
                                                   mask_upsample_9)
from temporalstereo_tpu_torch.parallel import (gather_width, make_2d_mesh,
                                               make_spatial_forward)
from temporalstereo_tpu_torch.parallel.spatial import SpatialPlan


def refusals(world):
    out = {}
    for name, grid in (("grid", (3, 1)), ("empty", (0, world))):
        try:
            make_2d_mesh(*grid)
            out[name] = None
        except ValueError as exc:
            out[name] = str(exc)
    return out


def forwards(job):
    model = build_model(get_cfg(opts=job["opts"]), device="cpu")
    model.load_state_dict(job["state_dict"], strict=True)
    out = {}
    for name, (data, spatial, width) in job["layouts"].items():
        left, right = job["images"][width]
        mesh = make_2d_mesh(data, spatial)
        run = make_spatial_forward(model, mesh)
        first = run(left, right)
        again = run(left, right)
        out[name] = {"disp": first, "again_equal": torch.equal(first, again),
                     "columns": run.columns, "stats": dict(run.stats),
                     "gathered": gather_width(mesh, first)}
    try:
        left, right = job["images"][128]
        left = torch.from_numpy(left).requires_grad_()
        make_spatial_forward(model, make_2d_mesh(1, dist.get_world_size()))(
            left, torch.from_numpy(right))
        out["grad_refusal"] = None
    except RuntimeError as exc:
        out["grad_refusal"] = str(exc)
    gn = build_model(get_cfg(opts=job["opts"] + [
        "MODEL.BACKBONE.NORM", "GN"]), device="cpu")
    try:
        make_spatial_forward(gn, make_2d_mesh(1, dist.get_world_size()))
        out["gn_refusal"] = None
    except ValueError as exc:
        out["gn_refusal"] = str(exc)
    return out


def _slice(plan, full, dim):
    """This rank's columns of a full-width tensor, in the plan's layout."""
    a, b = plan.part(full.shape[dim])[plan.index]
    return full.narrow(dim, a, b - a)


def primitives(job):
    """max |sharded - full width| of each exchange primitive on this
    rank's columns, on a (1, world) grid over the job's column bounds."""
    torch.manual_seed(0)
    g = torch.Generator().manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=g)
    mesh = make_2d_mesh(1, dist.get_world_size())
    plan = SpatialPlan(mesh, job["bounds"])
    cases = {}
    # name: (function, full-width inputs, W axis of each input, output's)
    w4, w8, w16 = (job["bounds"][-1] // s for s in (32, 16, 8))
    dilated = Conv2d(4, 5, 5, 1, 4, 2)               # a halo of 4 columns
    strided = Conv2d(4, 6, 3, 2, 1, norm="BN", activation="SiLU").eval()
    up = ConvTranspose3d(3, 2, (1, 3, 3), (1, 2, 2), (0, 1, 1), (0, 1, 1))
    down = Conv3d(3, 3, (1, 3, 3), (1, 2, 2), (0, 1, 1))
    fusion = PyramidFusion(4).eval()
    hyps = torch.rand((2, 5, 3, w8), generator=g) * (w8 + 4) - 2
    cases["conv_halo_of_four"] = (dilated, [randn(2, 4, 3, w4)], [3], 3)
    cases["conv_stride_bn_silu"] = (strided, [randn(2, 4, 3, w8)], [3], 3)
    # w4 -> w4 / 2: fewer columns than ranks, some hold none
    cases["conv_down_to_empty"] = (down, [randn(2, 3, 2, 3, w4)], [4], 4)
    cases["conv_transpose_from_empty"] = (
        lambda x: up(down(x)), [randn(2, 3, 2, 3, w4)], [4], 4)
    cases["squeeze_excite"] = (SqueezeExcite(5, 2), [randn(2, 5, 3, w8)],
                               [3], 3)
    cases["resize_bilinear_up"] = (
        lambda x: resize_bilinear(x, (6, 2 * x.shape[2])),
        [randn(2, 3, w4, 2)], [2], 2)
    cases["resize_trilinear_down"] = (
        lambda x: resize_trilinear(x, (4, 3, x.shape[4] // 2), (2, 3, 4)),
        [randn(2, 2, 4, 6, w16)], [4], 4)
    cases["block_cost_dense"] = (
        lambda r, t: block_cost(r, t, 7, 3),
        [randn(2, 3, w8, 16), randn(2, 3, w8, 16)], [2, 2], 3)
    cases["block_cost_fused_offset"] = (
        lambda r, t, d: block_cost(r, t, d, 3),
        [randn(2, 3, w8, 16), randn(2, 3, w8, 16), hyps], [2, 2, 3], 3)
    # no pyramid: the unfused branch, the shift with a column offset
    cases["block_cost_shift_offset"] = (
        lambda r, t, d: block_cost(r, t, d, 0),
        [randn(2, 3, w8, 12), randn(2, 3, w8, 12), hyps], [2, 2, 3], 3)
    cases["pyramid_fusion_pools"] = (fusion, [randn(1, 4, 6, 3, w8)], [4], 4)
    cases["convex_upsample"] = (
        lambda d, m: convex_upsample(d, m), [randn(2, 3, w8, 1) * 5,
                                             randn(2, 3, w8, 36)], [2, 2], 2)
    cases["mask_upsample_9"] = (
        lambda d, m: mask_upsample_9(d, m), [randn(2, 3, w8, 1) * 5,
                                             randn(2, 12, 4 * w8, 9)],
        [2, 2], 2)
    errs = {}
    with torch.no_grad():
        for name, (fn, inputs, dims, out_dim) in cases.items():
            full = fn(*inputs)
            with plan.frame(name):
                ours = fn(*[_slice(plan, x, d) for x, d in zip(inputs, dims)])
            ref = full if out_dim is None else _slice(plan, full, out_dim)
            errs[name] = (float((ours - ref).abs().max()) if ref.numel()
                          else 0.0, tuple(ours.shape), tuple(ref.shape),
                          float(full.abs().max()))
    return errs


def main(directory, rank, world):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(directory, 'store')}",
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        job = torch.load(os.path.join(directory, "job.pt"),
                         weights_only=False)
        out = {"refusals": refusals(world), "forwards": forwards(job),
               "primitives": primitives(job)}
        torch.save(out, os.path.join(directory, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
