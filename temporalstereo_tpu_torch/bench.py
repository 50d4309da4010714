"""Benchmark of the port on one card: the flagship stream at KITTI size.

    python -m temporalstereo_tpu_torch.bench

Counterpart of the root ``bench.py`` (which benchmarks the JAX package): the
flagship stream (v2s, bf16, 384x1248, B=1, past-cost memory, a 3-channel
local map, 0.5 backbone memory), seeded random weights, frames fed as bf16
and bench.py's camera (focal 720 px, baseline 0.54 m, 2 cm right and 0.5 m
forward a frame).  Prints one JSON line on stdout:

  value             the marginal per-frame throughput of the CUDA-graph
                    stream (``serving.StreamingBundle.step``): the median
                    time of 16 frames minus that of 8 frames, over 8,
                    synchronised only at the ends of a chunk, each repeat on
                    other frames;
  chunked_fps       8 frames over the median time of a chunk of 8;
  single_frame_fps  ``model(left, right, None)`` as its own CUDA graph,
                    8 replays a chunk;
  eager_fps         the marginal throughput of the same stream run eagerly
                    (``streaming_step``): graphs off against graphs on;
  achieved_tflops   FLOPs of one steady frame over the marginal frame time,
  mfu               and that over the card's dense bf16 peak.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

BASELINE_FPS = 24.0       # the reference paper's end-to-end rate (bench.py)
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 (NVIDIA's data sheet)
FLAGSHIP = ["TRAINER.PRECISION", "bf16",
            "MODEL.WITH_PREVIOUS", "True",
            "MODEL.USE_PAST_COST", "True",
            "MODEL.LOCAL_MAP_SIZE", "3",
            "MODEL.BACKBONE.MEMORY_PERCENT", "0.5"]
B, H, W = 1, 384, 1248
CHUNK = 8
FRAMES = 2 * CHUNK
REPEATS = 5


def log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def camera(device):
    """(K, baseline, T) of bench.py: focal 720 px, 0.54 m, 2 cm right and
    0.5 m forward between frames."""
    K = torch.tensor([[[720.0, 0, W / 2], [0, 720.0, H / 2], [0, 0, 1]]],
                     device=device).repeat(B, 1, 1)
    T = torch.eye(4, device=device).repeat(B, 1, 1)
    T[:, 0, 3], T[:, 2, 3] = 0.02, -0.5
    return K, torch.full((B,), 0.54, device=device), T


def frames(device, n: int = FRAMES, seed: int = 0):
    """n distinct bf16 frame pairs, as bench.py: a seeded image + 0.01 i."""
    rng = np.random.RandomState(seed)
    left = torch.from_numpy(rng.rand(B, H, W, 3).astype(np.float32))
    right = torch.from_numpy(rng.rand(B, H, W, 3).astype(np.float32))
    return [((left + 0.01 * i).to(device, torch.bfloat16),
             (right + 0.01 * i).to(device, torch.bfloat16)) for i in range(n)]


def chunk_seconds(step, pairs, n: int) -> float:
    """Median over REPEATS of the time of ``n`` calls of step(left, right),
    synchronised only before the first and after the last; repeat r starts
    at frame r."""
    times = []
    for r in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            step(*pairs[(r + i) % len(pairs)])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def marginal_fps(step, pairs):
    """(marginal fps from chunks of CHUNK and 2 CHUNK frames, fps of a
    chunk of CHUNK, marginal seconds a frame)."""
    t1 = chunk_seconds(step, pairs, CHUNK)
    t2 = chunk_seconds(step, pairs, 2 * CHUNK)
    dt = max(t2 - t1, 1e-9) / CHUNK
    return B / dt, B * CHUNK / t1, dt


def main() -> int:
    if not torch.cuda.is_available():
        print("bench: no CUDA device", file=sys.stderr)
        return 2

    from torch.utils.flop_counter import FlopCounterMode

    from . import build_model, get_cfg, streaming_step
    from .serving import (StreamingBundle, bundle_meta, capture_graph,
                          initial_prev)

    dev = torch.device("cuda")
    card = card_line()
    log(card)
    model = build_model(get_cfg(opts=FLAGSHIP), seed=0)
    K, bl, T = camera(dev)
    pairs = frames(dev)
    growth = model.local_map_size + 1        # frames before the steady stage

    # the CUDA-graph stream
    t0 = time.perf_counter()
    bundle = StreamingBundle(bundle_meta(model, B, H, W,
                                         input_dtype=torch.bfloat16), model,
                             progress=log)
    capture_s = time.perf_counter() - t0
    for l, r in pairs[:growth]:
        bundle.step(l, r, K, bl, T)
    fps, chunked_fps, dt = marginal_fps(
        lambda l, r: bundle.step(l, r, K, bl, T), pairs)
    log(f"graphs: {fps:.2f} fps marginal ({1e3 * dt:.3f} ms/frame), "
        f"{chunked_fps:.2f} fps a chunk of {CHUNK}; capture {capture_s:.2f} s")
    del bundle

    # the same stream, eager
    state = {"prev": initial_prev(model, B, H, W)}

    def eager(l, r):
        _, state["prev"] = streaming_step(model, l, r, state["prev"], K, bl,
                                          T)
    for l, r in pairs[:growth]:
        eager(l, r)
    eager_fps, _, eager_dt = marginal_fps(eager, pairs)
    log(f"eager: {eager_fps:.2f} fps marginal ({1e3 * eager_dt:.3f} "
        "ms/frame)")
    # FlopCounterMode counts the convolutions and matrix products (aten
    # ops with a FLOP formula) of one steady frame, not the elementwise
    # work or the hand-written kernels, against the dense bf16 peak
    with FlopCounterMode(display=False) as counter:
        eager(*pairs[0])
    flops = counter.get_total_flops()
    achieved = flops * fps

    # one frame without the temporal state, as its own graph
    with torch.inference_mode():
        static = [x.clone() for x in pairs[0]]
        graph, _, _ = capture_graph(
            lambda: model(*static, None)[0]["disps"][0])

    def single(l, r):
        static[0].copy_(l)
        static[1].copy_(r)
        graph.replay()
    with torch.inference_mode():
        single_s = chunk_seconds(single, pairs, CHUNK)
    single_fps = B * CHUNK / single_s
    log(f"single frame: {single_fps:.2f} fps; {flops / 1e9:.2f} GFLOP a "
        f"steady frame, {achieved / 1e12:.2f} TFLOP/s")

    print(json.dumps({
        "metric": "temporalstereo_streaming_fps_384x1248",
        "value": round(fps, 2),
        "unit": "frames/s/chip",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
        "chunked_fps": round(chunked_fps, 2),
        "single_frame_fps": round(single_fps, 2),
        "eager_fps": round(eager_fps, 2),
        "achieved_tflops": round(achieved / 1e12, 3),
        "mfu": round(achieved / PEAK_BF16_FLOPS, 5),
        "device": card,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
