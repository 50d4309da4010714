#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure ends the script with a
non-zero exit code and no result line:
  1. environment: torch / CUDA versions, card name and power limit;
  2. build: every hand-written kernel, compiled with nvcc from the checkout;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes of the flagship path, with the stated tolerances and times;
  4. the tiny model on the card (kernels) against the same model on the
     CPU (plain versions): three streamed frames, f32, TF32 off;
  5. the flagship stream: v2s, bf16, 384x1248, seeded random weights,
     exact local-map growth; finite outputs, launch counts, per-frame time,
     then two steady frames under torch.profiler (device busy share and
     kernel time by name);
  6. one JSON line listing every kernel, then the result line.
It imports nothing of JAX and needs one card.
"""
import json
import subprocess
import sys
import time

FLAGSHIP = ["TRAINER.PRECISION", "bf16",
            "MODEL.WITH_PREVIOUS", "True",
            "MODEL.USE_PAST_COST", "True",
            "MODEL.LOCAL_MAP_SIZE", "3",
            "MODEL.BACKBONE.MEMORY_PERCENT", "0.5"]
TINY = ["MODEL.BACKBONE.VARIANT", "tiny",
        "MODEL.AGGREGATION.COARSE.C", "8",
        "MODEL.AGGREGATION.FINE.C", "8",
        "MODEL.AGGREGATION.PRECISE.C", "8",
        "TRAINER.PRECISION", "f32"] + FLAGSHIP[2:]
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, published
# |kernel - plain| <= RTOL * |plain| + ATOL * max|plain of that block|
COST_TOL = {"float32": (1e-5, 1e-6), "bfloat16": (2 ** -7, 2 ** -8)}
SPLAT_TOL = (1e-5, 1e-6)
CARD_VS_CPU_TOL = 5e-3          # max|d| / mean|cpu|, as the temporal parity tests


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=50, warmup=5):
    """Median over 5 batches of ``iters`` launches, CUDA-event timed."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[2]


def close(kernel, plain, rtol, atol_frac):
    """max |kernel - plain| and whether it is within the tolerance."""
    k, p = kernel.float(), plain.float()
    err = (k - p).abs()
    bound = rtol * p.abs() + atol_frac * p.abs().max()
    return float(err.max()), bool((err <= bound).all())


def phase_kernels(torch, kernels):
    """Phase 3: every kernel against its plain version at path shapes."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    detail = {"fused_cost_base": [], "summation_splat": []}

    # fine @1/8 at the steady state (3 map + 5 fractional hypotheses) and
    # precise @1/4 (5 hypotheses), C = 128
    for stage, (h, w, c, d) in (("fine", (48, 156, 128, 8)),
                                ("precise", (96, 312, 128, 5))):
        for dtype in (torch.float32, torch.bfloat16):
            ref = torch.randn((1, h, w, c), generator=g, device=dev).to(dtype)
            tgt = torch.randn((1, h, w, c), generator=g, device=dev).to(dtype)
            # hypotheses over the card's disparity range and past the edge
            disp = (torch.rand((1, d, h, w), generator=g, device=dev)
                    * (w + 8.0) - 4.0)
            out = kernels.fused_cost_base(ref, tgt, disp)
            plain = kernels.fused_cost_base_plain(ref, tgt, disp)
            torch.cuda.synchronize()
            rtol, atol = COST_TOL[str(dtype).split(".")[-1]]
            err_a, ok_a = close(out[..., :2 * c], plain[..., :2 * c], rtol,
                                atol)
            err_b, ok_b = close(out[..., 2 * c:], plain[..., 2 * c:], rtol,
                                atol)
            ms = cuda_ms(lambda: kernels.fused_cost_base(ref, tgt, disp))
            plain_ms = cuda_ms(
                lambda: kernels.fused_cost_base_plain(ref, tgt, disp), 10)
            size = ref.element_size()
            nbytes = (2 * h * w * c * size + d * h * w * 4
                      + d * h * w * (2 * c + c // 8) * size)
            row = {"stage": stage, "shape": [1, d, h, w, c],
                   "dtype": str(dtype).split(".")[-1],
                   "max_abs_err": max(err_a, err_b), "ms": ms,
                   "plain_ms": plain_ms, "bytes": nbytes,
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
            detail["fused_cost_base"].append(row)
            log(3, f"fused_cost_base {stage} {row['dtype']} {row['shape']}: "
                f"max|d| {row['max_abs_err']:.3g} (tol {rtol:g}*|p| + "
                f"{atol:g}*max|p|) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                f"bound {row['bound_ms']:.4f} ms")
            if not (ok_a and ok_b):
                raise AssertionError(f"fused_cost_base {stage} {dtype} "
                                     "disagrees with its plain version")

    # the temporal update's splat: 48x156, C = 8 (2 samples + 2 costs +
    # 3 local map + 1 weight), flows of a few pixels so targets collide
    b, h, w, c = 1, 48, 156, 8
    vals = torch.rand((b, h, w, c), generator=g, device=dev) * 10
    flow = (torch.rand((b, h, w, 2), generator=g, device=dev) - 0.5) * 6
    first = kernels.summation_splat(vals, flow)
    second = kernels.summation_splat(vals, flow)
    plain = kernels.summation_splat_plain(vals, flow)
    torch.cuda.synchronize()
    err, ok = close(first, plain, *SPLAT_TOL)
    err2, ok2 = close(second, plain, *SPLAT_TOL)
    spread = float((first - second).abs().max())
    ms = cuda_ms(lambda: kernels.summation_splat(vals, flow))
    plain_ms = cuda_ms(lambda: kernels.summation_splat_plain(vals, flow), 10)
    nbytes = 2 * b * h * w * c * 4 + b * h * w * 2 * 4
    row = {"stage": "update", "shape": [b, h, w, c], "dtype": "float32",
           "max_abs_err": max(err, err2), "run_to_run": spread, "ms": ms,
           "plain_ms": plain_ms, "bytes": nbytes,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    detail["summation_splat"].append(row)
    log(3, f"summation_splat {row['shape']} f32: max|d| {row['max_abs_err']:.3g}"
        f" (tol {SPLAT_TOL[0]:g}*|p| + {SPLAT_TOL[1]:g}*max|p|), run-to-run "
        f"{spread:.3g}, kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
        f"{row['bound_ms']:.5f} ms")
    if not (ok and ok2):
        raise AssertionError("summation_splat disagrees with its plain version")
    return detail


def _geometry(torch, h, w, dev, focal=720.0, baseline=0.54):
    """Camera and per-frame motion as in bench.py: focal 720 px, baseline
    0.54 m, 2 cm right and 0.5 m forward between frames."""
    K = torch.tensor([[[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]]],
                     device=dev)
    T = torch.eye(4, device=dev)[None].clone()
    T[0, 0, 3], T[0, 2, 3] = 0.02, -0.5
    return K, torch.full((1,), baseline, device=dev), T


def run_stream(torch, port, cfg, device, frames, h, w, seed=0, sync=False,
               camera=(720.0, 0.54)):
    """Stream ``frames`` seeded frames through the port -> (per-frame
    outputs on the CPU, final state, per-frame seconds)."""
    model = port.build_model(cfg, device=device, seed=seed)
    prev = port.init_prev_info(
        model, 1, (h, w), port.backbone_memory_shapes(model.backbone_cfg,
                                                      (h, w)),
        model.precise_cfg["topk"], local_map_channels=0)
    K, bl, T = _geometry(torch, h, w, device, *camera)
    g = torch.Generator().manual_seed(seed + 1)
    outs, secs = [], []
    for _ in range(frames):
        left = torch.rand((1, h, w, 3), generator=g).to(device)
        right = torch.rand((1, h, w, 3), generator=g).to(device)
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, prev = port.streaming_step(model, left, right, prev, K, bl, T)
        if sync:
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        outs.append([d.float().cpu() for d in out["disps"]])
    return outs, prev, secs


def phase_card_vs_cpu(torch, port):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = port.get_cfg(opts=TINY)
    h, w, frames = 96, 160, 3
    # a short focal length keeps the tiny frames' reprojection in view
    gpu, gprev, _ = run_stream(torch, port, cfg, "cuda", frames, h, w, 3,
                               camera=(30.0, 2.0))
    cpu, cprev, _ = run_stream(torch, port, cfg, "cpu", frames, h, w, 3,
                               camera=(30.0, 2.0))
    worst = 0.0
    pairs = [(f"frame {f} disparity {i}", a, b)
             for f in range(frames) for i, (a, b) in enumerate(zip(gpu[f],
                                                                   cpu[f]))]
    pairs += [("cost_memory.disp_sample", gprev.cost_memory.disp_sample,
               cprev.cost_memory.disp_sample),
              ("cost_memory.cost_volume", gprev.cost_memory.cost_volume,
               cprev.cost_memory.cost_volume),
              ("prev_disp", gprev.prev_disp, cprev.prev_disp),
              ("local_map", gprev.local_map, cprev.local_map)]
    pairs += [(f"memories[{i}]", a, b)
              for i, (a, b) in enumerate(zip(gprev.memories, cprev.memories))]
    for name, a, b in pairs:
        a, b = a.float().cpu(), b.float()
        rel = float((a - b).abs().max() / (b.abs().mean() + 1e-6))
        worst = max(worst, rel)
        if not rel < CARD_VS_CPU_TOL:
            raise AssertionError(f"card vs CPU: {name} rel {rel:.3g} >= "
                                 f"{CARD_VS_CPU_TOL}")
    log(4, f"tiny model {h}x{w} f32, {frames} frames, card (kernels) vs CPU "
        f"(plain): worst max|d|/mean|cpu| {worst:.3g} over {len(pairs)} "
        f"tensors (tol {CARD_VS_CPU_TOL})")


def phase_flagship(torch, port, kernels, card, frames=12, warm=4):
    cfg = port.get_cfg(opts=FLAGSHIP)
    h, w = 384, 1248
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    outs, prev, secs = run_stream(torch, port, cfg, "cuda", frames, h, w,
                                  seed=0, sync=True)
    launches = dict(kernels.LAUNCHES)
    for f, disps in enumerate(outs):
        for i, d in enumerate(disps):
            if d.shape != (1, h, w, 1) or not torch.isfinite(d).all():
                raise AssertionError(f"flagship frame {f} disparity {i} is "
                                     f"not finite of shape (1, {h}, {w}, 1)")
    state = [prev.cost_memory.disp_sample, prev.cost_memory.cost_volume,
             prev.prev_disp, prev.local_map, *prev.memories]
    if not all(bool(torch.isfinite(t).all()) for t in state):
        raise AssertionError("flagship carried state is not finite")
    if prev.local_map.shape[-1] != 3:
        raise AssertionError("local map did not grow to 3 channels")
    want = {"fused_cost_base": 2 * frames, "summation_splat": frames - 1}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    steady = sorted(secs[warm:])
    ms = 1e3 * steady[len(steady) // 2]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(5, f"flagship v2s bf16 {h}x{w}, {frames} frames (local map 0->3): "
        f"finite, launches {launches}; per-frame ms "
        f"{[round(1e3 * s, 2) for s in secs]}, steady median {ms:.2f} ms "
        f"(frames {warm}..{frames - 1}), peak memory {peak:.2f} GiB "
        f"on {card}")
    profile_stream(torch, port, cfg, h, w)
    return launches


def profile_stream(torch, port, cfg, h, w):
    """Kernel time by name over two steady-state frames (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    model = port.build_model(cfg, seed=0)
    prev = port.init_prev_info(
        model, 1, (h, w), port.backbone_memory_shapes(model.backbone_cfg,
                                                      (h, w)),
        2, local_map_channels=0)
    K, bl, T = _geometry(torch, h, w, "cuda")
    x = torch.rand((1, h, w, 3), device="cuda")
    for _ in range(5):
        _, prev = port.streaming_step(model, x, x, prev, K, bl, T)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            _, prev = port.streaming_step(model, x, x, prev, K, bl, T)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, reach = 0.0, float("-inf")
    for start, end in spans:              # union of kernel intervals, us
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    log(5, f"profile: 2 frames, wall {1e3 * wall:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms (share {busy / 1e6 / wall:.3f}), "
        f"{len(kernels) // 2} kernels/frame")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for name, (t, n) in top[:20]:
        log(5, f"  {t / 2e3:8.3f} ms/frame {n // 2:5d}/frame  {name[:100]}")


def kernels_line(detail, launches):
    cost = [r for r in detail["fused_cost_base"] if r["dtype"] == "bfloat16"]
    splat = detail["summation_splat"]
    entries = []
    for name, rows, source, replaces in (
            ("fused_cost_base", cost,
             "temporalstereo_tpu_torch/kernels/csrc/fused_cost_base.cu",
             "temporalstereo_tpu/ops/pallas/cost.py:118"),
            ("summation_splat", splat,
             "temporalstereo_tpu_torch/kernels/csrc/summation_splat.cu",
             "temporalstereo_tpu/ops/pallas/splat.py:72")):
        # one frame's launches: fine + precise for the cost base, one splat
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "bytes", "library_ms": None,
            "per": "one frame of the flagship stream", "detail": rows})
    return json.dumps({"kernels": entries})


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import temporalstereo_tpu_torch as port
        from temporalstereo_tpu_torch import kernels
        from temporalstereo_tpu_torch.kernels import build
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}",
              file=sys.stderr)
        return 2

    card = card_line()
    log(1, f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"CUDA {torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    print(card, flush=True)

    info = build.build_all(ptxas_info=True)
    log(2, f"built {info['built']} in {info['seconds']:.1f} s")
    for name, text in info["log"].items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(2, f"  {name}: {line.strip()}")

    detail = phase_kernels(torch, kernels)
    phase_card_vs_cpu(torch, port)
    launches = phase_flagship(torch, port, kernels, card)
    print(kernels_line(detail, launches), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
