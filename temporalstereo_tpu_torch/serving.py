"""Serving the flagship stream: CUDA-graph stage bundles, bf16 weights and
the model identity hash.

Counterpart of the JAX package's ``serving.py``.  There, a bundle file holds
the AOT-compiled XLA executable of every streaming stage, which saves
minutes of compilation on a fresh host.  PyTorch has no counterpart of a
serialized XLA executable, and capturing the stages as CUDA graphs takes
seconds, so the port's bundle file is JSON meta only (no pickle, nothing
executable): version, platform, device kind, torch version, b/h/w, input
type, stages, the model's flags, ``fold_bn`` and ``model_hash``.  Loading a
bundle checks the hash against the model it is given and captures the
stages anew.  Weights are not in the bundle: load them into the model first.

Stage schedule (exact local-map growth, ``models/temporal.py``):
  g0        first frame: no warp, a local map of 0 channels
  g1..gS    growth frames: warp, the local map grows k-1 -> k channels
  steady    the full map, warp
  single    without WITH_PREVIOUS: ``model(left, right, None)``

On a CUDA model each stage is one ``torch.cuda.CUDAGraph``, captured once
after warm-up runs on a side stream (which build and load the kernels and
let cuDNN and the allocator settle), all in one memory pool.  ``step``
copies the frame, K, baseline and T into static inputs shared by all
stages and replays the stage's graph.  The carried state needs no copy
between stages: stage k+1 is captured reading stage k's output tensors.
That is also what makes the capture right: the state's flags
(``has_memory``, ``valid``, ``local_map_valid``) are Python bools that
choose code paths, so a stage is captured on the state the stage before it
really hands over, not on a fresh ``init_prev_info(local_map_channels=k)``
as the JAX package traces its stages.
The steady graph ends with a copy of its new state into its own inputs
(one copy inside the graph, rather than a ping-pong pair of graphs).
Stages sharing the pool are replayed in the order they were captured
(g0, g1, ..., steady, steady, ...; ``reset`` starts again at g0), which a
shared pool requires: a stage may reuse memory that was an earlier stage's
scratch.  A capture or replay that fails raises; nothing falls back to
eager.  On a CPU model (the tests) the same stage functions run eagerly.

Each stage graph also holds the device marks of ``tracing.py`` (the model's
stages on the device's clock, every replay), ``step`` records its host
spans and counts replays, and ``stats()`` sums them up for an operator.

Operating points (the JAX package's ``LatencyModel`` and
``select_operating_point``): a latency model fit to measured (streams,
chunk, wall ms) points, where ``streams`` is the bundle's batch (one
stream per batch row), a chunk is the number of frames stepped between two
host synchronisations, and ``wall`` is the time of that chunk: wall =
d(streams) + chunk * t(streams).  A frame waits for its whole chunk, so a
larger chunk trades latency for throughput.  ``measure_latency_table``
measures the points on the card with this module's bundle; the default
table, ``H100_SXM_700W``, is its measurement at 384x1248 (bf16 v2s, the
flagship stream) on one H100 SXM at a 700 W power limit.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from . import tracing
from .kernels import LAUNCHES
from .models import backbone_memory_shapes, init_prev_info, streaming_step
from .models.stereo import PrevInfo, TemporalStereoNet

BUNDLE_VERSION = 1
WARMUP = 3              # eager runs of a stage before its capture


class LatencyModel:
    """Linear-per-chunk latency model fit from measured (streams, chunk,
    wall_ms) points; interpolates the per-chunk and per-frame costs between
    measured stream counts and extrapolates beyond the last one."""

    def __init__(self, points: Dict[int, Tuple[float, float]],
                 name: str = "custom"):
        # streams -> (per-chunk ms, per-frame ms)
        self.points = dict(sorted(points.items()))
        self.name = name

    @classmethod
    def fit(cls, measurements, name: str = "fit") -> "LatencyModel":
        """Least-squares fit of wall = d + chunk * t per stream count
        (at least two chunk sizes per stream count)."""
        by_s: Dict[int, list] = {}
        for s, c, w in measurements:
            by_s.setdefault(int(s), []).append((float(c), float(w)))
        pts = {}
        for s, cw in by_s.items():
            if len(cw) < 2:
                raise ValueError(f"streams={s}: need >=2 chunk sizes")
            n = len(cw)
            sx = sum(c for c, _ in cw)
            sy = sum(w for _, w in cw)
            sxx = sum(c * c for c, _ in cw)
            sxy = sum(c * w for c, w in cw)
            t = (n * sxy - sx * sy) / max(n * sxx - sx * sx, 1e-9)
            d = (sy - t * sx) / n
            pts[s] = (max(d, 0.0), max(t, 1e-6))
        return cls(pts, name)

    def params(self, streams: int) -> Tuple[float, float]:
        """(per-chunk ms, per-frame ms) at a stream count, interpolated."""
        ks = list(self.points)
        if streams <= ks[0]:
            return self.points[ks[0]]
        if streams >= ks[-1]:
            # extrapolate the frame time with the last measured slope
            if len(ks) >= 2:
                (d1, t1), (d0, t0) = self.points[ks[-1]], self.points[ks[-2]]
                slope = (t1 - t0) / max(ks[-1] - ks[-2], 1)
                return d1, t1 + slope * (streams - ks[-1])
            return self.points[ks[-1]]
        for lo, hi in zip(ks, ks[1:]):
            if lo <= streams <= hi:
                f = (streams - lo) / (hi - lo)
                d0, t0 = self.points[lo]
                d1, t1 = self.points[hi]
                return d0 + f * (d1 - d0), t0 + f * (t1 - t0)
        raise AssertionError

    def wall_ms(self, streams: int, chunk: int) -> float:
        d, t = self.params(streams)
        return d + chunk * t

    def fps_per_stream(self, streams: int, chunk: int) -> float:
        return 1000.0 * chunk / self.wall_ms(streams, chunk)


# (streams, chunk, wall ms) of the flagship stream's bundle (v2s, bf16,
# 384x1248) on one NVIDIA H100 80GB HBM3 (SXM) at a 700.00 W power limit,
# measured by chip_smoke.py's planner phase (measure_latency_table, median
# of 5 chunks a point).  A frame costs ~11.1 ms for one stream and ~52.6 ms
# for eight: the card is busy with one stream's frame, so streams add
# device time nearly linearly; a chunk's own cost is under 0.4 ms.
H100_SXM_700W = LatencyModel.fit(
    [(1, 1, 11.215), (1, 2, 22.442), (1, 8, 89.232),
     (2, 1, 16.803), (2, 2, 33.489), (2, 8, 133.498),
     (4, 1, 28.418), (4, 2, 56.804), (4, 8, 226.347),
     (8, 1, 53.015), (8, 2, 105.643), (8, 8, 421.393)],
    name="H100_SXM_700W")
LATENCY_MODELS = {H100_SXM_700W.name: H100_SXM_700W}


def select_operating_point(streams: int, target_fps: float,
                           latency_model: Optional[LatencyModel] = None,
                           max_chunk: int = 32) -> Dict[str, Any]:
    """The smallest chunk (the lowest latency) whose predicted fps per
    stream meets ``target_fps`` -> {chunk, fps_per_stream, latency_ms,
    feasible, model, note}.  When no chunk up to ``max_chunk`` reaches it,
    ``feasible`` is False, ``chunk`` is the best-throughput choice,
    ``max_streams`` the most streams one card serves at the target, and
    ``note`` says so."""
    lm = latency_model or H100_SXM_700W
    best_chunk, best_fps = 1, lm.fps_per_stream(streams, 1)
    chunk = 1
    while chunk <= max_chunk:
        fps = lm.fps_per_stream(streams, chunk)
        if fps > best_fps:
            best_chunk, best_fps = chunk, fps
        if fps >= target_fps:
            return {"chunk": chunk, "fps_per_stream": round(fps, 1),
                    "latency_ms": round(lm.wall_ms(streams, chunk), 1),
                    "feasible": True, "model": lm.name, "note": ""}
        chunk *= 2
    max_streams = streams
    while max_streams > 1 and lm.fps_per_stream(
            max_streams, max_chunk) < target_fps:
        max_streams -= 1
    note = (f"{streams} stream(s) cannot reach {target_fps:.0f} fps/stream "
            f"on one card (best {best_fps:.1f} fps at chunk {best_chunk}); "
            f"serve <= {max_streams} stream(s) per card (streams are "
            "independent)")
    return {"chunk": best_chunk, "fps_per_stream": round(best_fps, 1),
            "latency_ms": round(lm.wall_ms(streams, best_chunk), 1),
            "feasible": False, "max_streams": max_streams,
            "model": lm.name, "note": note}


def cast_params_bf16(model: TemporalStereoNet) -> TemporalStereoNet:
    """Store every floating parameter as bf16, BatchNorm's affine ones
    included, in place; buffers (BatchNorm's running statistics) and the
    carried geometry stay f32, as in the JAX package.  Inference only.

    A model that computes in f32 takes each bf16 weight in f32 where it
    uses it (``nn/layers.py:at_use``), as flax casts to the compute type;
    in a bf16 model the convolution weights are bf16 already."""
    with torch.no_grad():
        for p in model.parameters():
            if p.is_floating_point():
                p.data = p.data.to(torch.bfloat16)
    return model


def model_identity_hash(model: TemporalStereoNet) -> str:
    """Digest of the architecture: the model's flags and compute type and
    the name, shape and type of every state_dict entry.  A folded model
    (its BatchNorms gone, its convolutions with biases) hashes differently
    from the unfolded one."""
    ident = {
        "with_previous": model.with_previous,
        "local_map_size": model.local_map_size,
        "use_past_cost": model.use_past_cost,
        "dtype": str(model.dtype),
        "state": [(k, list(v.shape), str(v.dtype))
                  for k, v in model.state_dict().items()],
    }
    blob = json.dumps(ident, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


def stage_list(model: TemporalStereoNet) -> List[Tuple[str, int, bool]]:
    """[(name, local-map channels coming in, warp)] of the exact-growth
    schedule."""
    if not model.with_previous:
        return [("single", 0, False)]
    s = model.local_map_size
    return ([("g0", 0, False)]
            + [(f"g{k}", k - 1, True) for k in range(1, s + 1)]
            + [("steady", s, True)])


def stage_fn(model: TemporalStereoNet, warp: bool) -> Callable:
    """(left, right, prev, K, baseline, T) -> (full-resolution disparity
    [B, H, W, 1], new prev) of one stage."""
    def fn(left, right, prev, K, baseline, T_past_to_now):
        outputs, new_prev = streaming_step(
            model, left, right, prev, K, baseline, T_past_to_now,
            warp=warp if prev is not None else False)
        return outputs["disps"][0], new_prev
    return fn


def initial_prev(model: TemporalStereoNet, b: int, h: int,
                 w: int) -> Optional[PrevInfo]:
    """The zero state that stage g0 reads (None without WITH_PREVIOUS)."""
    if not model.with_previous:
        return None
    return init_prev_info(
        model, b, (h, w), backbone_memory_shapes(model.backbone_cfg, (h, w)),
        model.precise_cfg.get("topk", 2), local_map_channels=0)


def _state_tensors(prev: Optional[PrevInfo]) -> List[torch.Tensor]:
    if prev is None:
        return []
    return [*prev.memories, prev.cost_memory.disp_sample,
            prev.cost_memory.cost_volume, prev.prev_disp, prev.local_map]


def capture_graph(fn: Callable, pool=None,
                  warm_fn: Optional[Callable] = None):
    """Run ``warm_fn`` (default ``fn``) WARMUP times on a side stream, then
    capture ``fn`` as a CUDA graph in ``pool`` -> (graph, fn's output in
    the graph's memory, the last warm-up output)."""
    warm_fn = warm_fn or fn
    current = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(current)
    warm = None
    with torch.cuda.stream(side):
        for _ in range(WARMUP):
            warm = warm_fn()
    current.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        out = fn()
    return graph, out, warm


def bundle_meta(model: TemporalStereoNet, b: int, h: int, w: int,
                fold_bn: bool = False,
                input_dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """The bundle's meta for ``model`` at a batch and frame size."""
    device = next(model.parameters()).device
    return {
        "version": BUNDLE_VERSION,
        "platform": "gpu" if device.type == "cuda" else device.type,
        "device_kind": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else device.type),
        "torch_version": torch.__version__,
        "b": b, "h": h, "w": w,
        "input_dtype": str(input_dtype).split(".")[-1],
        "stages": [s[0] for s in stage_list(model)],
        "with_previous": model.with_previous,
        "local_map_size": model.local_map_size,
        "fold_bn": fold_bn,
        "model_hash": model_identity_hash(model),
    }


class StreamingBundle:
    """A stateful streaming session over the stage schedule: ``reset()``,
    then ``step(left, right, K, baseline, T)`` per frame -> disparity
    [B, H, W, 1] f32 (a tensor of its own, which later steps leave alone).

    left/right [B, H, W, 3] of the meta's input type, K [B, 3, 3],
    baseline [B] and T [B, 4, 4] f32, on the model's device.
    ``capture_seconds`` holds each stage's warm-up and capture time;
    ``records`` (``tracing.Records``) its stages' marks, host spans and
    counters, ``stats()`` their summary."""

    def __init__(self, meta: Dict[str, Any], model: TemporalStereoNet,
                 progress: Callable = print):
        self.meta = meta
        self.model = model
        self.device = next(model.parameters()).device
        b, h, w = meta["b"], meta["h"], meta["w"]
        self._shapes = {
            "left": ((b, h, w, 3), getattr(torch, meta["input_dtype"])),
            "right": ((b, h, w, 3), getattr(torch, meta["input_dtype"])),
            "K": ((b, 3, 3), torch.float32),
            "baseline": ((b,), torch.float32),
            "T": ((b, 4, 4), torch.float32)}
        self._fns = {name: stage_fn(model, warp)
                     for name, _, warp in stage_list(model)}
        self._graphs: Dict[str, Tuple[torch.cuda.CUDAGraph,
                                      torch.Tensor]] = {}
        self.capture_seconds: Dict[str, float] = {}
        self.records = tracing.Records(
            [(name, warp) for name, _, warp in stage_list(model)],
            self.device)
        tracing.keep(self.records)
        if self.device.type == "cuda":
            self._capture(progress)
        self.reset()

    @torch.inference_mode()
    def _capture(self, progress: Callable) -> None:
        meta = self.meta
        b, h, w = meta["b"], meta["h"], meta["w"]
        dev = self.device
        # static inputs of every stage: zero frames and a unit camera until
        # the first step writes real ones
        inputs = self._inputs = {
            key: torch.zeros(shape, dtype=dtype, device=dev)
            for key, (shape, dtype) in self._shapes.items()}
        inputs["K"].copy_(torch.eye(3, device=dev))
        inputs["baseline"].fill_(0.54)
        inputs["T"].copy_(torch.eye(4, device=dev))
        frame = (inputs["left"], inputs["right"])
        geometry = (inputs["K"], inputs["baseline"], inputs["T"])
        # the graphs read `prev`, the static state; the warm-up runs read
        # the eager chain's own state, so that no stage warms up on memory
        # that a graph has not written yet
        prev = eager_prev = initial_prev(self.model, b, h, w)
        pool = torch.cuda.graph_pool_handle()
        with torch.cuda.device(dev):
            for name, channels, warp in stage_list(self.model):
                t0 = time.perf_counter()
                fn = self._fns[name]

                def captured(fn=fn, prev=prev, name=name):
                    before = dict(LAUNCHES)
                    with self.records.marks[name].around(self.model):
                        disp, new_prev = fn(*frame, prev, *geometry)
                        if name == "steady":
                            for dst, src in zip(_state_tensors(prev),
                                                _state_tensors(new_prev)):
                                if dst.data_ptr() != src.data_ptr():
                                    dst.copy_(src)
                    self.records.captured(name, before)
                    return disp, new_prev

                graph, (disp, new_prev), warm = capture_graph(
                    captured, pool,
                    lambda fn=fn, p=eager_prev: fn(*frame, p, *geometry))
                torch.cuda.synchronize(dev)
                self._graphs[name] = (graph, disp)
                self.capture_seconds[name] = time.perf_counter() - t0
                progress(f"bundle: captured stage '{name}' (local map "
                         f"{channels} ch, warp {warp}) in "
                         f"{self.capture_seconds[name]:.2f} s")
                prev, eager_prev = new_prev, warm[1]

    def reset(self) -> None:
        """Start a new stream at stage g0."""
        self._frame = 0
        self._prev = None
        if not self._graphs:
            self._prev = initial_prev(self.model, self.meta["b"],
                                       self.meta["h"], self.meta["w"])

    def stage_name(self) -> str:
        """The stage the next ``step`` runs."""
        if not self.meta["with_previous"]:
            return "single"
        if self._frame <= self.meta["local_map_size"]:
            return f"g{self._frame}"
        return "steady"

    @torch.inference_mode()
    def step(self, left: torch.Tensor, right: torch.Tensor, K: torch.Tensor,
             baseline: torch.Tensor, T_past_to_now: torch.Tensor
             ) -> torch.Tensor:
        """One frame -> full-resolution disparity [B, H, W, 1]."""
        t_step = time.perf_counter_ns()
        args = {"left": left, "right": right, "K": K, "baseline": baseline,
                "T": T_past_to_now}
        for key, x in args.items():
            shape, dtype = self._shapes[key]
            if tuple(x.shape) != shape or x.dtype != dtype:
                raise ValueError(f"bundle input {key}: expected {shape} "
                                 f"{dtype}, got {tuple(x.shape)} {x.dtype}")
        name = self.stage_name()
        if self._graphs:
            for key, x in args.items():
                self._inputs[key].copy_(x)
            graph, disp = self._graphs[name]
            t_replay = time.perf_counter_ns()
            graph.replay()
            t_replayed = time.perf_counter_ns()
            disp = disp.clone()
        else:
            t_replay = time.perf_counter_ns()
            with self.records.marks[name].around(self.model):
                disp, new_prev = self._fns[name](left, right, self._prev, K,
                                                 baseline, T_past_to_now)
            t_replayed = time.perf_counter_ns()
            self._prev = new_prev
        self._frame += 1
        self.records.stepped(name, t_step, t_replay, t_replayed,
                             time.perf_counter_ns())
        return disp

    def stats(self, n: Optional[int] = None) -> Dict[str, Any]:
        """Replays by stage, each stage's segments' p50 / p99 device ms
        over its newest n replays, the p50 / p99 host ms of ``step`` and
        ``replay`` over the newest n steps, and ``kernels.LAUNCHES``
        (``tracing.Records.stats``; reading the device marks waits for the
        card)."""
        return self.records.stats(n)


def export_streaming_bundle(model: TemporalStereoNet, path: str, b: int,
                            h: int, w: int, fold_bn: bool = False,
                            input_dtype: torch.dtype = torch.float32,
                            progress: Callable = print,
                            operating_point: Optional[Dict[str, Any]] = None
                            ) -> Dict[str, Any]:
    """Write the bundle (JSON meta) of ``model`` at a batch and frame size,
    with the ``select_operating_point`` choice it was planned for (None:
    not planned); ``load_streaming_bundle`` captures its stages."""
    meta = bundle_meta(model, b, h, w, fold_bn, input_dtype)
    meta["operating_point"] = operating_point
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fp:
        json.dump(meta, fp, indent=1)
    progress(f"bundle: wrote {len(meta['stages'])} stages -> {path}")
    return meta


def load_streaming_bundle(path: str, model: TemporalStereoNet,
                          progress: Callable = print) -> StreamingBundle:
    """Read a bundle, check its ``model_hash`` against ``model`` (raises
    ValueError on a mismatch) and capture its stages on the model's
    device."""
    with open(path) as fp:
        meta = json.load(fp)
    if meta.get("version") != BUNDLE_VERSION:
        raise ValueError(f"bundle {path}: version {meta.get('version')} "
                         f"!= {BUNDLE_VERSION}")
    got = model_identity_hash(model)
    if got != meta["model_hash"]:
        raise ValueError(
            f"bundle {path} was exported for a different model: model_hash "
            f"{meta['model_hash'][:12]}... != {got[:12]}... (check "
            "WITH_PREVIOUS / LOCAL_MAP_SIZE / the backbone, the compute "
            "type, --fold-bn and the weights file)")
    return StreamingBundle(meta, model, progress)


def measure_latency_table(model: TemporalStereoNet, h: int, w: int,
                          streams=(1, 2, 4, 8), chunks=(1, 2, 8),
                          reps: int = 5, progress: Callable = print
                          ) -> List[Tuple[int, int, float]]:
    """(streams, chunk, wall ms) on the card: for each stream count a
    bundle of that batch is captured and run through its growth stages,
    then, per chunk size, the median over ``reps`` of the host time from a
    synchronised start to the synchronisation after ``chunk`` steady
    frames."""
    device = next(model.parameters()).device
    if device.type != "cuda":
        raise RuntimeError("measure_latency_table: the model is not on a "
                           "card")
    g = torch.Generator(device=device).manual_seed(0)
    table = []
    for s in streams:
        bundle = StreamingBundle(bundle_meta(model, s, h, w), model,
                                 progress=lambda msg: None)
        left = torch.rand((s, h, w, 3), generator=g, device=device)
        right = torch.rand((s, h, w, 3), generator=g, device=device)
        K = torch.tensor([[720.0, 0, w / 2], [0, 720.0, h / 2], [0, 0, 1]],
                         device=device).expand(s, 3, 3).contiguous()
        baseline = torch.full((s,), 0.54, device=device)
        T = torch.eye(4, device=device).expand(s, 4, 4).contiguous()
        for _ in range(len(bundle.meta["stages"])):
            bundle.step(left, right, K, baseline, T)
        for c in chunks:
            walls = []
            for _ in range(reps):
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                for _ in range(c):
                    bundle.step(left, right, K, baseline, T)
                torch.cuda.synchronize(device)
                walls.append(1e3 * (time.perf_counter() - t0))
            wall = sorted(walls)[len(walls) // 2]
            table.append((s, c, wall))
            progress(f"latency: {s} stream(s), chunk {c}: {wall:.3f} ms")
        del bundle
        torch.cuda.empty_cache()
    return table
