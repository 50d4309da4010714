"""The reference TemporalStereo network, its carried state and the temporal
update, in plain PyTorch and float32, built from a benchmark configuration
file's ``options`` (the configuration tree's keys, as run).

``step(net, left, right, state, K, baseline, T)`` is one frame of the
stream: the carried state is warped into the current camera (when it holds
a frame) and the network runs on it -> (full-resolution disparity
[B, H, W, 1], the state the next frame reads).  It imports nothing of the
measured program.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from .backbone import Backbone, memory_shapes
from .blocks import (ConvexUpsample, DepthwiseConv3D, PredictionHeads,
                     PyramidFusion, ResidualBlock3D, UNet)
from .layers import ROUNDING, Conv3d
from .ops import (block_cost, fractional_samples, linear_samples,
                  project_to_3d, resize_bilinear, softmax_splat,
                  sort_samples_with_volume, topk_soft_argmin)

EXPMAX = 50.0          # the splat metric's clamp
DISP_RANGE = 4.0       # search range between stages: disparity +/- 4


@dataclasses.dataclass
class State:
    """The state one frame hands the next: backbone memories [2B, mc, h, w]
    (left rows, then right rows), the cost memory [B, H/8, W/8, topk] and
    its validity, the full-resolution disparity and the local map
    [B, H/8, W/8, S]."""
    memories: Tuple[torch.Tensor, ...]
    has_memory: bool
    mem_sample: torch.Tensor
    mem_cost: torch.Tensor
    mem_valid: bool
    prev_disp: torch.Tensor
    local_map: torch.Tensor
    local_map_valid: bool


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


def _volume(raw):
    return raw.permute(0, 4, 1, 2, 3)


def _planes(cin, scale, sparse):
    return (2 if sparse else 1) * cin + scale * cin // 8


class Init3D(nn.Sequential):
    def __init__(self, cin, C, norm, act):
        super().__init__(
            DepthwiseConv3D(cin, C, 3, 1, 1, bias=True, norm=norm,
                            activation=act),
            ResidualBlock3D(C, 3, 2, 1, norm=norm, activation=act),
            DepthwiseConv3D(C, C, 3, 1, 2, d=2, bias=False, norm=norm,
                            activation=act))


class _Stage(nn.Module):
    """Coarse (dense hypotheses @1/16) or fine (fractional and local-map
    hypotheses @1/8) aggregation with the past-cost memory."""

    def __init__(self, cfg, sparse):
        super().__init__()
        cin, C = cfg["IN_PLANES"], cfg["C"]
        norm, act = cfg["NORM"], cfg["ACTIVATION"]
        self.scale, self.topk = cfg["BLOCK_COST_SCALE"], cfg["TOPK"]
        self.num_sample = cfg["NUM_SAMPLE"]
        if sparse:
            self.phi = nn.Parameter(torch.zeros(1))
        self.init3d = Init3D(_planes(cin, self.scale, sparse), C, norm, act)
        self.past_conv = Conv3d(1, C, 1, 1, 0, bias=False, norm=norm,
                                activation=act)
        self.fuse = (PyramidFusion(C, norm, act) if cfg["SPATIAL_FUSION"]
                     else None)
        self.pred_heads = PredictionHeads(C, cfg["DELTA"], norm, act)
        self.convex_upsample = ConvexUpsample(cin)

    def forward(self, left, right, samples, memory):
        b, _, h, w = left.shape
        if samples is None:
            raw = block_cost(_nhwc(left), _nhwc(right), self.num_sample,
                             self.scale)
            samples = linear_samples(b, h, w, self.num_sample, left.device)
        else:
            raw = block_cost(_nhwc(left), _nhwc(right),
                             samples.permute(0, 3, 1, 2), self.scale)
        volume = self.init3d(_volume(raw))
        ms, mv = memory
        if ms.shape[1:3] != (h, w):           # the 1/8 memory on 1/16
            ms = resize_bilinear(ms * (w / ms.shape[2]), (h, w))
            mv = resize_bilinear(mv, (h, w))
        volume = torch.cat([volume, self.past_conv(
            mv.permute(0, 3, 1, 2)[:, None])], dim=2)
        samples, volume = sort_samples_with_volume(
            torch.cat([samples, ms], dim=-1), volume, dim=2)
        if self.fuse is not None:
            volume = self.fuse(volume)
        cost, off = self.pred_heads(volume)
        disp = topk_soft_argmin(cost, samples, off, self.topk)[0]
        return self.convex_upsample(left, disp)


class Precise(nn.Module):
    """Image-guided aggregation @1/4 and the full-resolution decode; it
    writes the next frame's cost memory."""

    def __init__(self, cfg):
        super().__init__()
        cin, C = cfg["IN_PLANES"], cfg["C"]
        norm, act = cfg["NORM"], cfg["ACTIVATION"]
        self.scale, self.topk = cfg["BLOCK_COST_SCALE"], cfg["TOPK"]
        self.refinement = UNet(out_planes=cin)
        self.init3d = Init3D(_planes(2 * cin, self.scale, True), C, norm, act)
        self.pred_heads = PredictionHeads(C, cfg["DELTA"], norm, act)

    def forward(self, left, right, low, high, left_image, right_image):
        spx2l, spx4l = self.refinement.encode_one(left_image)
        _, spx4r = self.refinement.encode_one(right_image)
        left = torch.cat([left, spx4l], dim=1)
        right = torch.cat([right, spx4r], dim=1)
        samples = fractional_samples(low, high)
        raw = block_cost(_nhwc(left), _nhwc(right),
                         samples.permute(0, 3, 1, 2), self.scale)
        cost, off = self.pred_heads(self.init3d(_volume(raw)))
        disp, top_disp, top_cost = topk_soft_argmin(cost, samples, off,
                                                    self.topk)
        full = self.refinement.decode(disp, left, spx2l)
        h, w = disp.shape[1:3]
        return (full, resize_bilinear(top_disp / 2, (h // 2, w // 2)),
                resize_bilinear(top_cost, (h // 2, w // 2)))


class Aggregation(nn.Module):
    def __init__(self, coarse, fine, precise):
        super().__init__()
        self.coarse = _Stage(coarse, sparse=False)
        self.fine = _Stage(fine, sparse=True)
        self.precise = Precise(precise)


class Net(nn.Module):
    """forward(left, right [B, 3, H, W], state warped into this camera or
    None) -> (full disparity [B, H, W, 1], new state or None)."""

    def __init__(self, options: Dict[str, Any]):
        super().__init__()
        o = options
        self.with_previous = bool(o["MODEL.WITH_PREVIOUS"])
        self.use_past_cost = bool(o["MODEL.USE_PAST_COST"])
        self.local_map_size = int(o["MODEL.LOCAL_MAP_SIZE"])
        mp = (float(o["MODEL.BACKBONE.MEMORY_PERCENT"])
              if self.with_previous else 0.0)
        self.variant = o["MODEL.BACKBONE.VARIANT"]
        self.memory_percent = mp
        self.backbone = Backbone(self.variant, mp, o["MODEL.BACKBONE.NORM"],
                                 o["MODEL.BACKBONE.ACTIVATION"])

        def stage(name):
            p = f"MODEL.AGGREGATION.{name}."
            return {k[len(p):]: v for k, v in o.items() if k.startswith(p)}
        self.topk = int(stage("PRECISE")["TOPK"])
        self.aggregation = Aggregation(stage("COARSE"), stage("FINE"),
                                       stage("PRECISE"))

    def forward(self, left, right, state: Optional[State]):
        b = left.shape[0]
        l_fms, r_fms, new_memories = self.backbone(
            left, right, state.memories if state is not None else None,
            state is not None and state.has_memory)
        (l4, l8, l16), (r4, r8, r16) = l_fms, r_fms
        _, _, H, W = left.shape
        if state is not None and self.use_past_cost and state.mem_valid:
            memory = (state.mem_sample, state.mem_cost)
        else:
            zeros = l8.new_zeros((b, l8.shape[2], l8.shape[3], self.topk))
            memory = (zeros, zeros)
        agg = self.aggregation
        disp = agg.coarse(l16, r16, None, memory)
        samples = fractional_samples(disp - DISP_RANGE, disp + DISP_RANGE)
        if (state is not None and self.local_map_size > 0
                and state.local_map.shape[-1] > 0):
            lm = state.local_map
            if lm.shape[-1] >= self.local_map_size \
                    and not state.local_map_valid:
                lm = torch.zeros_like(lm)
            w8 = l8.shape[3]
            samples = torch.cat([resize_bilinear(
                lm * (w8 / lm.shape[2]), (l8.shape[2], w8)), samples], -1)
        disp = agg.fine(l8, r8, samples, memory)
        full, mem_sample, mem_cost = agg.precise(
            l4, r4, disp - DISP_RANGE, disp + DISP_RANGE, left, right)
        full = resize_bilinear(full * (W / full.shape[2]), (H, W))
        if state is None:
            return full, None
        return full, State(new_memories, True, mem_sample, mem_cost, True,
                           full, state.local_map, state.local_map_valid)


def update_state(state: State, K, baseline, T, full_size,
                 use_past_cost: bool, local_map_size: int,
                 rounding: Optional[str] = None) -> State:
    """Warp the carried state into the current camera: one reprojection of
    the 1/8 disparity, the cost memory's hypotheses and the local map, and
    one softmax splat of the updated hypotheses, the cost memory and the
    map, weighted by the disparity less its mean over the batch (nearer
    pixels win), so the streams of a batch are warped together.
    ``rounding`` ("bf16"): the reprojection's and the splat's inputs
    rounded so, the control's precision for this float32 step."""
    rnd = ROUNDING[rounding] if rounding else (lambda x: x)
    if not use_past_cost and local_map_size <= 0:
        return state
    full_h, full_w = full_size
    h, w = state.local_map.shape[1:3]
    k = state.mem_sample.shape[-1] if use_past_cost else 0
    scale = full_w / w
    dK = torch.cat([K[:, 0:1] / scale, K[:, 1:2] / scale, K[:, 2:]], dim=1)
    focal = dK[:, 0, 0].reshape(-1, 1, 1, 1)
    bl = baseline.reshape(-1, 1, 1, 1)
    pd = resize_bilinear(state.prev_disp * (w / full_w), (h, w))
    parts = [pd]
    if use_past_cost:
        parts.append(state.mem_sample)
    lm = None
    if local_map_size > 0:
        lm = torch.cat([pd, state.local_map], dim=-1)[..., :local_map_size]
        if state.local_map.shape[-1] >= local_map_size \
                and not state.local_map_valid:
            lm = pd.expand_as(lm)
        parts.append(lm)
    disps = torch.cat(parts, dim=-1)
    outs = project_to_3d(rnd(bl * focal / (disps + 1e-5)), dK,
                         torch.linalg.inv(dK), T)
    flow = outs["optical_flow"][:, :, :, 0, :]
    updated = bl * focal / (outs["triangular_depth"] + 1e-5)
    splat_in = []
    if use_past_cost:
        splat_in += [updated[..., 1:1 + k], state.mem_cost]
    if lm is not None:
        splat_in.append(updated[..., 1 + k:])
    warped = softmax_splat(rnd(torch.cat(splat_in, dim=-1)), rnd(flow),
                           rnd(torch.clamp(pd - pd.mean(), -EXPMAX, EXPMAX)))
    new = dataclasses.replace(state)
    if use_past_cost:
        new.mem_sample, new.mem_cost = warped[..., :k], warped[..., k:2 * k]
    if lm is not None:
        new.local_map, new.local_map_valid = warped[..., 2 * k:], True
    return new


def run(net: Net, left, right, state: Optional[State]):
    """The network on NHWC images [B, H, W, 3] and a state already in
    their camera -> (disparity [B, H, W, 1], the next state)."""
    dtype = next(net.parameters()).dtype
    return net(left.permute(0, 3, 1, 2).to(dtype),
               right.permute(0, 3, 1, 2).to(dtype), state)


def step(net: Net, left, right, state: Optional[State], K, baseline, T,
         warp_rounding: Optional[str] = None):
    """One frame: the state warped into this camera (once it holds a
    frame), then the network."""
    if state is not None and state.has_memory:
        state = update_state(state, K.float(), baseline.float(), T.float(),
                             tuple(left.shape[1:3]), net.use_past_cost,
                             net.local_map_size, warp_rounding)
    return run(net, left, right, state)


def zero_state(net: Net, b: int, h: int, w: int, device) -> Optional[State]:
    """The state of a stream's first frame (None without temporal state)."""
    if not net.with_previous:
        return None
    mem = tuple(torch.zeros((2 * b, c, mh, mw), device=device)
                for mh, mw, c in memory_shapes(net.variant,
                                               net.memory_percent, h, w))
    z = torch.zeros((b, h // 8, w // 8, net.topk), device=device)
    return State(mem, False, z, z.clone(), False,
                 torch.zeros((b, h, w, 1), device=device),
                 torch.zeros((b, h // 8, w // 8, 0), device=device), False)


def rows(state: State, index: slice) -> State:
    """The state of some rows (streams) of a batch."""
    b = state.prev_disp.shape[0]
    ri = range(b)[index]
    pick = torch.tensor(list(ri), device=state.prev_disp.device)
    both = torch.cat([pick, pick + b])
    return dataclasses.replace(
        state, memories=tuple(m[both] for m in state.memories),
        mem_sample=state.mem_sample[pick], mem_cost=state.mem_cost[pick],
        prev_disp=state.prev_disp[pick], local_map=state.local_map[pick])
