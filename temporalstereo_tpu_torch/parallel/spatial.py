"""W-axis spatial sharding of the single-frame forward.

Counterpart of the JAX package's ``parallel/spatial.py``: the dense
per-frame compute is sharded along the image's W axis over a 2-D
``(data, spatial)`` grid of ranks, batch parallelism riding the ``data``
axis, so that a frame too large for one card's memory or latency budget
splits across the ranks of a row.  There, XLA's SPMD partitioner inserts
the halo exchanges and collectives unasked.  Here each one is written out,
and the model's layers consult the plan of the running sharded forward
through one context (``active_plan``), as ``nn/layers.py:recomputing``
marks a recompute:

  * convolutions (``nn/layers.py``, plain and transposed, 2-D and 3-D)
    take the W halo their kernel, stride and dilation read from the
    neighbouring ranks, however many columns that spans, with zero padding
    at the frame's edges only;
  * the squeeze-excite mean (``models/backbone.py``) is a sum over the
    frame, all-reduced over the row;
  * align-corners resizes (``ops/interpolate.py``) map each output column
    to x * (W_in - 1) / (W_out - 1) in the frame's coordinates and take
    the input columns that range reads;
  * the cost volume (``ops/cost.py``): the dense integer path takes D - 1
    columns from the left; the sparse path gathers the right view's
    features along W once per stage (the hypotheses may reach any column)
    and runs the cost-base kernel (or the shift) with a column offset; the
    pyramid's pools fall on the frame's windows;
  * the convex and mask upsamples' 3x3 unfolds take a halo of 1, and the
    pyramid fusion's 5x5x5 pools one of 2.
Everything else on the path is per pixel and stays local.

Every W-sharded tensor of the frame's width ``Wg`` at some level is laid
out the same way: rank i of the row holds the frame's columns
[ceil(b_i Wg / W), ceil(b_{i+1} Wg / W)), where b are the image's column
bounds (``column_bounds``) and W its width.  A rank may hold no column at
a level narrower than the row.  A tensor carries no record of its frame
width, so the first frame at an image shape learns each one with a sum of
the local widths over the row, in the forward's order of calls, and the
later frames read them back: they exchange data only.

The forward is inference only (eval mode, no previous frame, no
gradients).  With no process group, or a spatial size of 1, no plan is
active: the forward is the plain one, bit for bit, and launches nothing
more.  Under NCCL the exchanges are point-to-point; under gloo on CUDA
tensors (ranks sharing one card) they go through the host.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

ALIGN = 32          # column bounds are multiples of the trunk's stride
_PLAN = contextvars.ContextVar("spatial_plan", default=None)

Ranges = List[Tuple[int, int]]


@dataclasses.dataclass(frozen=True)
class SpatialMesh:
    """This process's place on the (data, spatial) grid: rank r of the
    default group sits at row r // spatial, column r % spatial.  ``group``
    is its row (None without a process group or with one column) and
    ``peers`` the row's ranks in the default group, by column."""
    rank: int
    data: int
    spatial: int
    device: torch.device
    group: Optional[Any] = None
    peers: Tuple[int, ...] = (0,)

    @property
    def data_index(self) -> int:
        return self.rank // self.spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.spatial

    @property
    def active(self) -> bool:
        """Whether the frame is split across ranks."""
        return self.group is not None and self.spatial > 1


def make_2d_mesh(data: int, spatial: int, device=None) -> SpatialMesh:
    """The ranks of the default group (one rank without a group) on a
    ``data`` x ``spatial`` grid, with one process group per row.

    A torch rank that was launched cannot sit idle, so the grid must hold
    exactly the launched ranks; any other grid is refused (JAX's mesh takes
    the first data x spatial devices)."""
    if data < 1 or spatial < 1:
        raise ValueError(f"a ({data}, {spatial}) grid has no ranks")
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = 0, 1
    if data * spatial != world:
        raise ValueError(f"a ({data}, {spatial}) grid needs {data * spatial} "
                         f"rank(s) but {world} were launched")
    device = torch.device("cpu" if device is None else device)
    row = rank // spatial
    peers = tuple(range(row * spatial, (row + 1) * spatial))
    group = None
    if world > 1 and spatial > 1:
        # every rank creates every row's group, in the same order
        for d in range(data):
            g = dist.new_group(list(range(d * spatial, (d + 1) * spatial)))
            if d == row:
                group = g
    return SpatialMesh(rank, data, spatial, device, group, peers)


def column_bounds(width: int, spatial: int) -> Tuple[int, ...]:
    """Column bounds of ``spatial`` shards of an image ``width`` wide: as
    even as multiples of the trunk's stride make them (1248 on 2: 640 and
    608; 160 on 2: 64 and 96)."""
    bounds = [0] + [int(round(i * width / spatial / ALIGN)) * ALIGN
                    for i in range(1, spatial)] + [width]
    if any(b1 <= b0 for b0, b1 in zip(bounds, bounds[1:])):
        raise ValueError(f"{width} columns do not split into {spatial} "
                         f"shards on multiples of {ALIGN}")
    return tuple(bounds)


def _rows(x, mesh: SpatialMesh):
    n = x.shape[0]
    if n % mesh.data:
        raise ValueError(f"{mesh.data} data rows do not divide the batch of "
                         f"{n}")
    b = n // mesh.data
    return slice(mesh.data_index * b, (mesh.data_index + 1) * b)


def shard_images(mesh: SpatialMesh, left, right):
    """This rank's shard of [B, H, W, 3] images (numpy arrays or tensors):
    its row's slice of the batch and its columns [x0, x1) of
    ``column_bounds``, on the mesh's device -> (left, right, (x0, x1))."""
    bounds = column_bounds(left.shape[2], mesh.spatial)
    x0, x1 = bounds[mesh.spatial_index], bounds[mesh.spatial_index + 1]
    rows = _rows(left, mesh)
    out = [torch.as_tensor(v[rows, :, x0:x1]).to(mesh.device)
           for v in (left, right)]
    return out[0], out[1], (x0, x1)


class _Transport:
    """Point-to-point messages within a row: NCCL's batched sends and
    receives, or gloo's (through the host for CUDA tensors)."""

    def __init__(self, mesh: SpatialMesh):
        self.mesh = mesh
        self.nccl = dist.get_backend(mesh.group) == "nccl"
        self.host = not self.nccl and mesh.device.type == "cuda"
        self.stats = Counter()

    def exchange(self, sends: List[Tuple[int, torch.Tensor]],
                 recvs: List[Tuple[int, Tuple[int, ...]]], like: torch.Tensor
                 ) -> List[torch.Tensor]:
        """Send each (column, tensor) and receive a tensor of each (column,
        shape) -> the received tensors on ``like``'s device."""
        if not sends and not recvs:
            return []
        stage = torch.device("cpu") if self.host else like.device
        out = [t.contiguous().to(stage) for _, t in sends]
        bufs = [torch.empty(shape, dtype=like.dtype, device=stage)
                for _, shape in recvs]
        peers, group = self.mesh.peers, self.mesh.group
        if self.nccl:
            ops = ([dist.P2POp(dist.isend, t, peers[q], group)
                    for (q, _), t in zip(sends, out)]
                   + [dist.P2POp(dist.irecv, b, peers[q], group)
                      for (q, _), b in zip(recvs, bufs)])
            works = dist.batch_isend_irecv(ops)
        else:
            works = ([dist.isend(t, peers[q], group=group)
                      for (q, _), t in zip(sends, out)]
                     + [dist.irecv(b, peers[q], group=group)
                        for (q, _), b in zip(recvs, bufs)])
        for w in works:
            w.wait()
        self.stats["messages"] += len(sends)
        self.stats["bytes"] += sum(t.numel() * t.element_size() for t in out)
        return [b.to(like.device) for b in bufs]

    def fetch(self, x: torch.Tensor, dim: int, ranges: Ranges,
              windows: Ranges) -> torch.Tensor:
        """Collective over the row: ``x`` holds the frame's columns
        ``ranges[i]`` (this rank's i) along ``dim``; each rank j gets the
        frame's columns ``windows[j]`` from whichever ranks hold them,
        zeros outside the frame [0, ranges[-1][1])."""
        me = self.mesh.spatial_index
        dim = dim % x.dim()
        a, b = ranges[me]
        if x.shape[dim] != b - a:
            raise RuntimeError(f"a shard of {x.shape[dim]} columns where the "
                               f"plan has [{a}, {b})")
        lo, hi = windows[me]
        sends, recvs = [], []
        for q, ((qa, qb), (qlo, qhi)) in enumerate(zip(ranges, windows)):
            if q == me:
                continue
            s0, s1 = max(qlo, a), min(qhi, b)
            if s1 > s0:
                sends.append((q, x.narrow(dim, s0 - a, s1 - s0)))
            r0, r1 = max(lo, qa), min(hi, qb)
            if r1 > r0:
                shape = list(x.shape)
                shape[dim] = r1 - r0
                recvs.append((q, tuple(shape)))
        got = iter(self.exchange(sends, recvs, x))
        self.stats["fetches"] += 1
        wg = ranges[-1][1]

        def zeros(n):
            shape = list(x.shape)
            shape[dim] = n
            return x.new_zeros(shape)
        pieces = []
        if lo < min(0, hi):
            pieces.append(zeros(min(0, hi) - lo))
        for q, (qa, qb) in enumerate(ranges):
            r0, r1 = max(lo, qa), min(hi, qb)
            if r1 > r0:
                pieces.append(x.narrow(dim, r0 - a, r1 - r0) if q == me
                              else next(got))
        if hi > max(wg, lo):
            pieces.append(zeros(hi - max(wg, lo)))
        if not pieces:
            return x.narrow(dim, 0, 0)
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the row, in place."""
        dist.all_reduce(t, group=self.mesh.group)
        self.stats["reduces"] += 1
        return t


class SpatialPlan:
    """The partition of every level of one image shape over a row, and the
    collectives the model's layers make through it (``active_plan``)."""

    def __init__(self, mesh: SpatialMesh, bounds: Sequence[int]):
        self.mesh = mesh
        self.bounds = tuple(bounds)
        self.width = self.bounds[-1]
        self.index = mesh.spatial_index
        self.transport = _Transport(mesh)
        self._widths: Dict[Any, List[Tuple[int, int]]] = {}
        self._seen: List[Tuple[int, int]] = []
        self._cursor = 0

    @property
    def stats(self) -> Counter:
        return self.transport.stats

    @contextlib.contextmanager
    def frame(self, key):
        """The plan active for one forward at an image shape ``key``."""
        self._seen = self._widths.setdefault(key, [])
        self._cursor = 0
        self.transport.stats.clear()
        token = _PLAN.set(self)
        try:
            yield self
        finally:
            _PLAN.reset(token)

    # --- the partition ---------------------------------------------------

    def part(self, wg: int) -> Ranges:
        """Every rank's columns of a tensor ``wg`` columns wide."""
        cuts = [0] + [min(-(-b * wg // self.width), wg)
                      for b in self.bounds[1:-1]] + [wg]
        return list(zip(cuts, cuts[1:]))

    def global_width(self, local: int) -> int:
        """The frame width of a tensor this rank holds ``local`` columns of;
        a sum over the row the first time at this call of the forward."""
        i = self._cursor
        self._cursor += 1
        if i < len(self._seen):
            seen_local, wg = self._seen[i]
            if seen_local != local:
                raise RuntimeError(f"call {i} of the sharded forward saw "
                                   f"{local} columns, {seen_local} before")
            return wg
        dev = (torch.device("cpu") if not self.transport.nccl
               else self.mesh.device)
        t = torch.tensor([local], dtype=torch.int64, device=dev)
        self.transport.all_reduce(t)
        self.transport.stats["discoveries"] += 1
        wg = int(t.item())
        a, b = self.part(wg)[self.index]
        if b - a != local:
            raise RuntimeError(f"a tensor {wg} columns wide would give this "
                               f"rank [{a}, {b}), but it holds {local}")
        self._seen.append((local, wg))
        return wg

    # --- data movement ---------------------------------------------------

    def fetch(self, x, dim, wg, windows):
        """``_Transport.fetch`` of a tensor ``wg`` columns wide, laid out
        as the plan lays out that width."""
        return self.transport.fetch(x, dim, self.part(wg), windows)

    def halo(self, x: torch.Tensor, dim: int, wg: int, left: int,
             right: int) -> torch.Tensor:
        """This rank's columns with ``left`` and ``right`` more on either
        side, zeros outside the frame."""
        windows = [(a - left, b + right) if b > a else (a, a)
                   for a, b in self.part(wg)]
        return self.fetch(x, dim, wg, windows)

    def gather(self, x: torch.Tensor, dim: int, wg: int) -> torch.Tensor:
        """The whole frame's width, on every rank of the row."""
        return self.fetch(x, dim, wg, [(0, wg)] * self.mesh.spatial)

    def repartition(self, x: torch.Tensor, dim: int, ranges: Ranges
                    ) -> torch.Tensor:
        """``x``, laid out as ``ranges``, in the plan's layout of its
        width."""
        target = self.part(ranges[-1][1])
        if target == ranges:
            return x
        return self.transport.fetch(x, dim, ranges, target)

    # --- the layers' sharded forms ---------------------------------------

    def conv(self, x: torch.Tensor, weight, bias, stride, padding, dilation,
             groups) -> torch.Tensor:
        """``F.conv{2,3}d`` over the frame's W (the last axis)."""
        fn = F.conv2d if x.dim() == 4 else F.conv3d
        k, s, p, d = weight.shape[-1], stride[-1], padding[-1], dilation[-1]
        pads = tuple(padding[:-1]) + (0,)

        def conv(t):
            return fn(t, weight, bias, stride, pads, dilation, groups)
        if k == 1 and s == 1 and p == 0:
            return _per_column(conv, x, 1)
        wg = self.global_width(x.shape[-1])
        wo = (wg + 2 * p - d * (k - 1) - 1) // s + 1
        outs = self.part(wo)
        windows = [(s * o0 - p, s * (o1 - 1) - p + d * (k - 1) + 1)
                   if o1 > o0 else (0, 0) for o0, o1 in outs]
        window = self.fetch(x, -1, wg, windows)
        o0, o1 = outs[self.index]
        if o1 == o0:
            return _empty(conv, x, d * (k - 1) + 1)
        return conv(window)

    def conv_transpose(self, x: torch.Tensor, weight, bias, stride, padding,
                       output_padding, groups, dilation) -> torch.Tensor:
        """``F.conv_transpose{2,3}d`` over the frame's W (the last axis)."""
        fn = F.conv_transpose2d if x.dim() == 4 else F.conv_transpose3d
        k, s, p = weight.shape[-1], stride[-1], padding[-1]
        op, d = output_padding[-1], dilation[-1]
        pads = tuple(padding[:-1]) + (0,)
        opads = tuple(output_padding[:-1]) + (0,)

        def conv(t):
            return fn(t, weight, bias, stride, pads, opads, groups, dilation)
        if k == 1 and s == 1 and p == 0 and op == 0:
            return _per_column(conv, x, 1)
        if s > d * (k - 1) + 1:
            raise NotImplementedError(f"a transposed convolution of stride {s}"
                                      f" wider than its kernel ({k}, dilation "
                                      f"{d}) leaves columns no input reaches")
        wg = self.global_width(x.shape[-1])
        wo = (wg - 1) * s - 2 * p + d * (k - 1) + op + 1
        outs = self.part(wo)
        # output column o reads inputs i with s i - p + d t = o, 0 <= t < k
        windows = [(-(-(o0 + p - d * (k - 1)) // s), (o1 - 1 + p) // s + 1)
                   if o1 > o0 else (0, 0) for o0, o1 in outs]
        window = self.fetch(x, -1, wg, windows)
        o0, o1 = outs[self.index]
        if o1 == o0:
            return _empty(conv, x, 1)
        # the window's output column u is the frame's column s lo - p + u
        lo = windows[self.index][0]
        return conv(window).narrow(-1, o0 - (s * lo - p), o1 - o0)

    def resize(self, x: torch.Tensor, size: Sequence[int],
               axes: Sequence[int], mode: str,
               local_resize: Callable) -> torch.Tensor:
        """An align-corners resize whose last axis is the frame's W: the W
        pass in the frame's coordinates, then ``local_resize`` over the
        other axes (W unchanged)."""
        axes = [a % x.dim() for a in axes]
        wax = axes[-1]
        wg_in = self.global_width(x.shape[wax])
        wg_out = self.global_width(size[-1])
        rest_in = tuple(x.shape[a] for a in axes[:-1])
        rest_out = tuple(size[:-1])
        if wg_in == wg_out and rest_in == rest_out:
            return x
        y = x if x.dtype == torch.float32 else x.float()
        if wg_in != wg_out:
            y = self.lerp_columns(y, wax, wg_in, wg_out)
        if rest_in != rest_out:
            y = local_resize(y, rest_out, axes[:-1],
                             {"bilinear": "linear",
                              "trilinear": "bilinear"}[mode])
        return y.to(x.dtype)

    def lerp_windows(self, wg_in: int, wg_out: int):
        """(scale, every rank's input window) of an align-corners linear
        resize of the frame's W from ``wg_in`` to ``wg_out`` columns."""
        scale = (np.float32(wg_in - 1) / np.float32(wg_out - 1)
                 if wg_out > 1 else np.float32(0.0))
        windows = []
        for o0, o1 in self.part(wg_out):
            if o1 == o0:
                windows.append((0, 0))
                continue
            first = int(np.floor(scale * np.float32(o0)))
            last = int(np.floor(scale * np.float32(o1 - 1)))
            windows.append((first, min(last + 1, wg_in - 1) + 1))
        return scale, windows

    def lerp_columns(self, x: torch.Tensor, dim: int, wg_in: int,
                     wg_out: int) -> torch.Tensor:
        """The W pass of an align-corners resize of ``x`` (f32)."""
        scale, windows = self.lerp_windows(wg_in, wg_out)
        window = self.fetch(x, dim, wg_in, windows)
        o0, o1 = self.part(wg_out)[self.index]
        return lerp(window, dim, windows[self.index][0], wg_in, scale, o0, o1)

    def spatial_mean(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, H, W] -> its mean over H and the frame's W, [B, C, 1, 1]
        in x's type: f32 sums and the count, summed over the row."""
        b, c = x.shape[:2]
        sums = x.float().sum((2, 3)).reshape(-1)
        t = torch.cat([sums, sums.new_tensor([x.shape[2] * x.shape[3]])])
        self.transport.all_reduce(t)
        return (t[:-1] / t[-1]).view(b, c, 1, 1).to(x.dtype)

    def box_pools(self, cost: torch.Tensor, k: int):
        """``F.avg_pool3d(cost, k, 1, k // 2)`` and ``F.max_pool3d`` of the
        same window over a [B, C, D, H, W] volume."""
        r = k // 2
        wg = self.global_width(cost.shape[-1])
        window = self.halo(cost, -1, wg, r, r)
        a, b = self.part(wg)[self.index]

        def pools(t):
            # the padding of D and H written out: avg_pool3d refuses an
            # axis shorter than its window whatever its padding
            outside = t.clone()
            lo = a - r
            if lo < 0:
                outside[..., :-lo] = float("-inf")
            if b + r > wg:
                outside[..., t.shape[-1] - (b + r - wg):] = float("-inf")
            pad = (0, 0, r, r, r, r)
            return (F.avg_pool3d(F.pad(t, pad), k, 1, 0),
                    F.max_pool3d(F.pad(outside, pad, value=float("-inf")), k,
                                 1, 0))
        if b == a:
            return tuple(_empty(lambda t: pools(t)[i], cost, k)
                         for i in range(2))
        return pools(window)


def lerp(window: torch.Tensor, dim: int, lo: int, wg_in: int, scale,
         o0: int, o1: int) -> torch.Tensor:
    """Output columns [o0, o1) of an align-corners linear resize along
    ``dim`` of a frame ``wg_in`` wide, from ``window``, its columns from
    ``lo``: source x = scale * o in f32, (1 - f) x[floor] + f x[floor + 1],
    as ``F.interpolate`` takes them."""
    pos = (torch.arange(o0, o1, dtype=torch.float32, device=window.device)
           * torch.tensor(float(scale), dtype=torch.float32))
    i0 = torch.floor(pos)
    lam = (pos - i0).clamp(0.0, 1.0)
    i0 = i0.long()
    i1 = i0 + (i0 < wg_in - 1).long()
    shape = [1] * window.dim()
    shape[dim] = -1
    lam = lam.view(shape)
    return (window.index_select(dim, i0 - lo) * (1.0 - lam)
            + window.index_select(dim, i1 - lo) * lam)


def _empty(fn: Callable, x: torch.Tensor, width: int) -> torch.Tensor:
    """``fn``'s output for a rank that holds no column of its output: run
    on ``width`` zero columns, then none of them kept."""
    z = x.new_zeros(tuple(x.shape[:-1]) + (width,))
    return fn(z).narrow(-1, 0, 0)


def _per_column(fn: Callable, x: torch.Tensor, width: int) -> torch.Tensor:
    """``fn`` of an op that maps each column to itself."""
    return fn(x) if x.shape[-1] else _empty(fn, x, width)


def active_plan() -> Optional[SpatialPlan]:
    """The plan of the sharded forward running in this context, if any."""
    return _PLAN.get()


def width_ratio(num: int, den: int) -> float:
    """``num / den`` of two W axes' frame widths."""
    plan = _PLAN.get()
    if plan is None:
        return num / den
    return plan.global_width(num) / plan.global_width(den)


_PER_PIXEL_NORMS = ("GroupNorm", "InstanceNorm")


class SpatialForward:
    """``run(left, right)`` -> this rank's [B / data, H, x1 - x0, 1] slice of
    ``outputs["disps"][0]`` of the single-frame eval forward (no previous
    frame), for [B, H, W, 3] images (numpy arrays or tensors).  ``columns``
    is this rank's [x0, x1) of the last call and ``stats`` the collectives
    of its frame (fetches, messages, bytes sent, reductions, and the frame
    widths it learnt)."""

    def __init__(self, model, mesh: SpatialMesh):
        if mesh.active:
            bad = sorted({type(m).__name__ for m in model.modules()
                          if type(m).__name__ in _PER_PIXEL_NORMS})
            if bad:
                raise ValueError(f"{bad} normalise over the whole frame; the "
                                 "W-sharded forward takes BatchNorm, "
                                 "FrozenBN or LayerNorm")
        self.model, self.mesh = model, mesh
        self.columns: Optional[Tuple[int, int]] = None
        self.plans: Dict[int, SpatialPlan] = {}
        self.stats: Counter = Counter()

    def __call__(self, left, right) -> torch.Tensor:
        for t in (left, right):
            if torch.is_tensor(t) and t.requires_grad:
                raise RuntimeError("the W-sharded forward is inference only; "
                                   "its images must not require gradients")
        if self.model.training:
            self.model.eval()
        width = left.shape[2]
        left, right, self.columns = shard_images(self.mesh, left, right)
        with torch.no_grad():
            if not self.mesh.active:
                return self.model(left, right, None)[0]["disps"][0]
            plan = self.plans.get(width)
            if plan is None:
                plan = self.plans[width] = SpatialPlan(
                    self.mesh, column_bounds(width, self.mesh.spatial))
            with plan.frame(tuple(left.shape[:2])):
                out = self.model(left, right, None)[0]["disps"][0]
            self.stats = Counter(plan.stats)
            return out


def make_spatial_forward(model, mesh: SpatialMesh) -> SpatialForward:
    """The single-frame eval forward with images sharded along W over each
    row of ``mesh`` (at ``column_bounds``) and the batch over its rows;
    parameters replicated (each rank holds the whole model).  Puts
    ``model`` in eval mode."""
    model.eval()
    return SpatialForward(model, mesh)


def gather_width(mesh: SpatialMesh, x: torch.Tensor, dim: int = 2
                 ) -> torch.Tensor:
    """The whole frame of a tensor sharded along ``dim`` over the row (each
    rank's columns in column order), on every rank of the row."""
    if not mesh.active:
        return x
    transport = _Transport(mesh)
    dev = torch.device("cpu") if not transport.nccl else mesh.device
    widths = torch.zeros(mesh.spatial, dtype=torch.int64, device=dev)
    widths[mesh.spatial_index] = x.shape[dim]
    transport.all_reduce(widths)
    cuts = np.concatenate([[0], np.cumsum(widths.cpu().numpy())]).tolist()
    ranges = list(zip(cuts, cuts[1:]))
    return transport.fetch(x, dim, ranges, [(0, cuts[-1])] * mesh.spatial)
