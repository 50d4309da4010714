#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure ends the script with a
non-zero exit code and no result line:
  1. environment: torch / CUDA versions, card name and power limit;
  2. build: every hand-written kernel, compiled with nvcc from the checkout;
  3. each kernel against its plain PyTorch version on the card, with the
     stated tolerances and times (the wrapper's, CUDA events around many
     calls, and the kernel's own device time from torch.profiler): the
     cost base and the splat at the shapes of the flagship stream, the
     shift (forward and backward) and the cost base's backward at the
     shapes of the flagship training step (backward against torch autograd
     of the plain version, run twice to show it deterministic), the
     backwards on uniform hypotheses and on model-like ones (a smooth
     disparity field and the cascade's offsets around it);
  4. the tiny model on the card (kernels) against the same model on the
     CPU (plain versions), f32, TF32 off: three streamed frames, then one
     training step (T=3) with BLOCK_COST_SCALE 3 and 0 (its losses and
     BatchNorm statistics; every gradient and the parameters after one
     optimizer step with the BatchNorms on their running statistics);
  5. the flagship stream: v2s, bf16, 384x1248, seeded random weights,
     exact local-map growth; finite outputs, launch counts, per-frame time,
     then two steady frames under torch.profiler (device busy share and
     kernel time by name);
  6. the flagship training step: configs/kitti2015-multi.yaml (v2s, bf16,
     B=4, 320x1184, an 11-frame window), a seeded synthetic batch, three
     steps; finite losses, parameters moving by about the learning rate,
     launch counts, per-step time, peak memory, then one more step under
     torch.profiler;
  7. the same step with BLOCK_COST_SCALE 0 (the shift kernel's path) at
     T=2, B=1: launch counts, finite outputs;
  8. one JSON line listing every kernel, then the result line.
It imports nothing of JAX and needs one card.
"""
import json
import pathlib
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
KITTI = str(pathlib.Path(__file__).resolve().parent / "configs"
            / "kitti2015-multi.yaml")
NO_PYRAMID = ["MODEL.AGGREGATION.FINE.BLOCK_COST_SCALE", "0",
              "MODEL.AGGREGATION.PRECISE.BLOCK_COST_SCALE", "0"]
TINY_TRAIN = TINY[:10]           # tiny, stage C=8, f32 over the YAML
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, published
# |kernel - plain| <= RTOL * |plain| + ATOL * max|plain of that block|
COST_TOL = {"float32": (1e-5, 1e-6), "bfloat16": (2 ** -7, 2 ** -8)}
SPLAT_TOL = (1e-5, 1e-6)
# backward kernels against torch autograd of the plain version: in f32 the
# sums run in another order; in bf16 autograd rounds the warped side's
# gradient to bf16 where it meets the correlation's, and again when it sums
# the broadcast reference over D, where the kernels sum in f32 and round once
BWD_TOL = {"float32": (1e-5, 1e-6), "bfloat16": (2 ** -6, 2 ** -6)}
CARD_VS_CPU_TOL = 5e-3          # max|d| / mean|cpu|, as the temporal parity tests
# one training step, card vs CPU, with the tolerances that
# tests/test_torch_train_step.py holds the port to JAX with: losses
# relative; each gradient max|d| <= 1e-2 max|cpu| + 1e-6 of the largest
# gradient (a bias ahead of a train-mode BatchNorm has a gradient of
# exactly 0, i.e. rounding noise); statistics 1e-3 of their max + 1e-6
# of the largest (the batch mean of a bias-free convolution after a
# train-mode BatchNorm is exactly 0, i.e. rounding noise);
# parameters 2e-2 of the step's change + 2 f32 ulps + 1e-6 of the largest
# change
TRAIN_TOL = {"loss": 2e-3, "grad": 1e-2, "stats": 1e-3, "param": 2e-2,
             "floor": 1e-6}
# (stage, (B, H, W, C, D)) of the flagship training step: the fine stage at
# 1/8 of 320x1184 with 5 + 3 local-map hypotheses, the precise one at 1/4
TRAIN_SHAPES = (("fine", (4, 40, 148, 128, 8)),
                ("precise", (4, 80, 296, 128, 5)))


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms_spread(fn, iters=50, warmup=5):
    """(median, min, max) over 5 batches of ``iters`` launches, CUDA-event
    timed."""
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
    times.sort()
    return times[2], times[0], times[-1]


def cuda_ms(fn, iters=50, warmup=5):
    """Median over 5 batches of ``iters`` launches, CUDA-event timed."""
    return cuda_ms_spread(fn, iters, warmup)[0]


def device_ms(fn, kernel, iters=20):
    """The kernel's own device time per call: torch.profiler over ``iters``
    calls of ``fn``, the CUDA kernels whose name holds ``kernel``; None if
    the profiler saw none."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and kernel in e.name]
    if len(hits) != iters:
        return None
    return sum(e.time_range.elapsed_us() for e in hits) / iters / 1e3


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


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
            dev_ms = device_ms(lambda: kernels.fused_cost_base(ref, tgt, disp),
                               "fused_cost_base_kernel")
            plain_ms = cuda_ms(
                lambda: kernels.fused_cost_base_plain(ref, tgt, disp), 10)
            size = ref.element_size()
            nbytes = (2 * h * w * c * size + d * h * w * 4
                      + d * h * w * (2 * c + c // 8) * size)
            row = {"stage": stage, "shape": [1, d, h, w, c],
                   "dtype": str(dtype).split(".")[-1],
                   "max_abs_err": max(err_a, err_b), "ms": ms,
                   "device_ms": dev_ms, "plain_ms": plain_ms, "bytes": nbytes,
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
            detail["fused_cost_base"].append(row)
            log(3, f"fused_cost_base {stage} {row['dtype']} {row['shape']}: "
                f"max|d| {row['max_abs_err']:.3g} (tol {rtol:g}*|p| + "
                f"{atol:g}*max|p|) kernel {ms:.4f} ms (device "
                f"{fmt_ms(dev_ms)}) plain {plain_ms:.4f} ms "
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
    dev_ms = device_ms(lambda: kernels.summation_splat(vals, flow),
                       "summation_splat_kernel")
    plain_ms = cuda_ms(lambda: kernels.summation_splat_plain(vals, flow), 10)
    nbytes = 2 * b * h * w * c * 4 + b * h * w * 2 * 4
    row = {"stage": "update", "shape": [b, h, w, c], "dtype": "float32",
           "max_abs_err": max(err, err2), "run_to_run": spread, "ms": ms,
           "device_ms": dev_ms, "plain_ms": plain_ms, "bytes": nbytes,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    detail["summation_splat"].append(row)
    log(3, f"summation_splat {row['shape']} f32: max|d| {row['max_abs_err']:.3g}"
        f" (tol {SPLAT_TOL[0]:g}*|p| + {SPLAT_TOL[1]:g}*max|p|), run-to-run "
        f"{spread:.3g}, kernel {ms:.4f} ms (device {fmt_ms(dev_ms)}) plain "
        f"{plain_ms:.4f} ms bound "
        f"{row['bound_ms']:.5f} ms")
    if not (ok and ok2):
        raise AssertionError("summation_splat disagrees with its plain version")
    return detail


def _autograd(torch, fn, inputs, grad_out):
    """fn's gradients under torch autograd, and a closure that reruns only
    the backward (to time it)."""
    leaves = [x.detach().requires_grad_() for x in inputs]
    out = fn(*leaves)

    def backward():
        return torch.autograd.grad(out, leaves, grad_out, retain_graph=True)
    return backward(), backward


def _check_grads(name, kernel, plain, tol):
    """max|d| over the gradients; raises if one is outside ``tol``."""
    worst = 0.0
    for i, (k, p) in enumerate(zip(kernel, plain)):
        err, ok = close(k, p, *tol)
        worst = max(worst, err)
        if not ok:
            raise AssertionError(f"{name}: gradient {i} disagrees with "
                                 f"autograd of the plain version ({err:.3g})")
    return worst


def _spread(first, second):
    return max(float((a.float() - b.float()).abs().max())
               for a, b in zip(first, second))


def _row(stage, shape, dtype, err, ms, plain_ms, library_ms, nbytes,
         spread=None, dev_ms=None, case=None, ms_range=None):
    row = {"stage": stage, "shape": shape, "dtype": dtype,
           "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "bytes": nbytes,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    if spread is not None:
        row["run_to_run"] = spread
    if case is not None:
        row["case"] = case
    if ms_range is not None:
        row["ms_min_max"] = list(ms_range)
    return row


def _log_row(name, row, tol):
    log(3, f"{name} {row['stage']}"
        + (f" {row['case']}" if "case" in row else "")
        + f" {row['dtype']} {row['shape']}: max|d| "
        f"{row['max_abs_err']:.3g} (tol {tol[0]:g}*|p| + {tol[1]:g}*max|p|)"
        + (f", run-to-run {row['run_to_run']:.3g}" if "run_to_run" in row
           else "")
        + f", kernel {row['ms']:.4f} ms"
        + (" (5 batches {:.4f}-{:.4f})".format(*row["ms_min_max"])
           if "ms_min_max" in row else "")
        + f", device {fmt_ms(row['device_ms'])}, plain "
        f"{row['plain_ms']:.4f} ms "
        + (f"library {row['library_ms']:.4f} ms " if row['library_ms']
           is not None else "")
        + f"bound {row['bound_ms']:.4f} ms ({row['bytes'] / 1e6:.1f} MB)")


def model_like_disparity(torch, g, b, d, h, w, dev):
    """Hypotheses [B, D, H, W] as the cascade hands them to a stage: a
    smooth disparity field along each row (a seeded sinusoid up to ~w/6 px,
    and a surface slanted at 0.9 px/px over the last third, so that many
    pixels sample the same target column), the stage's 5 fractional samples
    at -4, -1, 0, +1, +4 px around it (fractional_disparity_samples over
    disp +/- 4), and at the fine stage (d = 8) first 3 local-map hypotheses
    within +/- 0.5 px of it."""
    import math

    x = torch.arange(w, device=dev, dtype=torch.float32)
    phase = torch.rand((b, 1, h, 1), generator=g, device=dev) * 2 * math.pi
    field = (w / 6) * (0.55 + 0.35 * torch.sin(2 * math.pi * x / w + phase))
    field = field + 0.9 * torch.clamp(x - 2 * w / 3, min=0)
    offsets = torch.tensor([-4.0, -1.0, 0.0, 1.0, 4.0], device=dev)
    disp = field + offsets.view(1, 5, 1, 1)
    if d > 5:
        local = field + torch.rand((b, d - 5, h, w), generator=g,
                                   device=dev) - 0.5
        disp = torch.cat([local, disp], 1)
    return disp.contiguous()


def _grid_sample_yardstick(torch, img, shift):
    """F.grid_sample computing the shift on the same data (img [B,1,H,W,C]
    read as [B,C,H,W], the D hypotheses as D*H output rows, align_corners so
    that pixel x is x): (forward closure, backward closure)."""
    import torch.nn.functional as F

    b, d, h, w = shift.shape
    img_nchw = img[:, 0].permute(0, 3, 1, 2).contiguous()
    xs = torch.arange(w, device=img.device).view(1, 1, 1, w) + shift
    ys = torch.arange(h, device=img.device, dtype=torch.float32).view(
        1, 1, h, 1).expand(b, d, h, w)
    grid = torch.stack([2 * xs / (w - 1) - 1, 2 * ys / (h - 1) - 1], -1)
    grid = grid.reshape(b, d * h, w, 2).to(img.dtype)

    def forward(x=img_nchw, g=grid):
        return F.grid_sample(x, g, mode="bilinear", padding_mode="zeros",
                             align_corners=True)
    out = forward()
    grad_out = torch.randn_like(out)
    _, backward = _autograd(torch, forward, (img_nchw, grid), grad_out)
    return forward, backward


def phase_train_kernels(torch, kernels, detail):
    """Phase 3, training shapes: the shift forward and backward and the
    cost base's backward against the plain version (autograd for the
    backward), bf16 and f32; the backwards on uniform and on model-like
    hypotheses."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    for name in ("shift_1d", "shift_1d_backward", "fused_cost_base_backward"):
        detail[name] = []
    for stage, (b, h, w, c, d) in TRAIN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            size = torch.empty((), dtype=dtype).element_size()
            shape = [b, d, h, w, c]
            # the shift: img broadcast over D, as block_cost calls it, and
            # shifts over the card's disparity range and past both edges
            img = torch.randn((b, 1, h, w, c), generator=g,
                              device=dev).to(dtype)
            uniform = (torch.rand((b, d, h, w), generator=g, device=dev)
                       * (w + 8.0) - 4.0)
            model = model_like_disparity(torch, g, b, d, h, w, dev)
            go = torch.randn((b, d, h, w, c), generator=g,
                             device=dev).to(dtype)
            shift = -uniform
            out = kernels.shift_1d(img, shift)
            plain = kernels.shift_1d_plain(img, shift)
            torch.cuda.synchronize()
            err, ok = close(out, plain, *COST_TOL[dname])
            if not ok:
                raise AssertionError(f"shift_1d {stage} {dname} disagrees "
                                     "with its plain version")
            lib_fwd, lib_bwd = _grid_sample_yardstick(torch, img, shift)
            row = _row(stage, shape, dname, err,
                       cuda_ms(lambda: kernels.shift_1d(img, shift)),
                       cuda_ms(lambda: kernels.shift_1d_plain(img, shift), 10),
                       cuda_ms(lib_fwd),
                       b * h * w * c * size + b * d * h * w * 4
                       + b * d * h * w * c * size,
                       dev_ms=device_ms(lambda: kernels.shift_1d(img, shift),
                                        "shift_1d_forward_kernel"))
            detail["shift_1d"].append(row)
            _log_row("shift_1d", row, COST_TOL[dname])
            del out, plain, lib_fwd
            for case, disp in (("uniform", uniform), ("model", model)):
                shift = -disp
                first = kernels.shift_1d_backward(go, img, shift)
                second = kernels.shift_1d_backward(go, img, shift)
                ref_grads, plain_bwd = _autograd(
                    torch, kernels.shift_1d_plain, (img, shift), go)
                torch.cuda.synchronize()
                berr = _check_grads(f"shift_1d_backward {stage} {case} "
                                    f"{dname}", first, ref_grads,
                                    BWD_TOL[dname])
                berr = max(berr, _check_grads("shift_1d_backward (rerun)",
                                              second, ref_grads,
                                              BWD_TOL[dname]))
                ms, lo, hi = cuda_ms_spread(
                    lambda: kernels.shift_1d_backward(go, img, shift))
                row = _row(stage, shape, dname, berr, ms,
                           cuda_ms(plain_bwd, 10),
                           cuda_ms(lib_bwd) if case == "uniform" else None,
                           b * d * h * w * c * size
                           + 2 * b * h * w * c * size + 2 * b * d * h * w * 4,
                           _spread(first, second),
                           device_ms(lambda: kernels.shift_1d_backward(
                               go, img, shift), "shift_1d_backward_kernel"),
                           case, (lo, hi))
                detail["shift_1d_backward"].append(row)
                _log_row("shift_1d_backward", row, BWD_TOL[dname])
                del first, second, ref_grads, plain_bwd
            del lib_bwd

            # the cost base's backward
            co = 2 * c + c // 8
            ref = torch.randn((b, h, w, c), generator=g, device=dev).to(dtype)
            tgt = torch.randn((b, h, w, c), generator=g, device=dev).to(dtype)
            go = torch.randn((b, d, h, w, co), generator=g,
                             device=dev).to(dtype)
            for case, disp in (("uniform", uniform), ("model", model)):
                first = kernels.fused_cost_base_backward(go, ref, tgt, disp)
                second = kernels.fused_cost_base_backward(go, ref, tgt, disp)
                ref_grads, plain_bwd = _autograd(
                    torch, kernels.fused_cost_base_plain, (ref, tgt, disp),
                    go)
                torch.cuda.synchronize()
                berr = _check_grads(f"fused_cost_base_backward {stage} {case} "
                                    f"{dname}", first, ref_grads,
                                    BWD_TOL[dname])
                berr = max(berr, _check_grads(
                    "fused_cost_base_backward (rerun)", second, ref_grads,
                    BWD_TOL[dname]))
                ms, lo, hi = cuda_ms_spread(
                    lambda: kernels.fused_cost_base_backward(go, ref, tgt,
                                                             disp))
                row = _row(stage, shape, dname, berr, ms,
                           cuda_ms(plain_bwd, 10), None,
                           b * d * h * w * co * size + 4 * b * h * w * c * size
                           + 2 * b * d * h * w * 4,
                           _spread(first, second),
                           device_ms(lambda: kernels.fused_cost_base_backward(
                               go, ref, tgt, disp),
                               "fused_cost_base_backward_kernel"),
                           case, (lo, hi))
                detail["fused_cost_base_backward"].append(row)
                _log_row("fused_cost_base_backward", row, BWD_TOL[dname])
                del first, second, ref_grads, plain_bwd
            del go, ref, tgt
            torch.cuda.empty_cache()


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
    want = {"fused_cost_base": 2 * frames, "fused_cost_base_backward": 0,
            "shift_1d": 0, "shift_1d_backward": 0,
            "summation_splat": frames - 1}
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


def train_batch(torch, t, b, h, w, device, seed=0, focal=720.0,
                baseline=0.54, motion=(0.02, -0.5)):
    """A synthetic training window from ``torch.Generator(seed)``: images,
    a sparse positive disparity ground truth (0 = invalid, 30% of the
    pixels valid, as a projected lidar scan), poses moving by ``motion``
    (x, z) per frame as bench.py's, K and the baseline."""
    g = torch.Generator().manual_seed(seed)
    step = torch.eye(4)
    step[0, 3], step[2, 3] = motion
    T_cam = [torch.eye(4)]
    for _ in range(t - 1):
        T_cam.append(step @ T_cam[-1])
    T_cam = torch.stack(T_cam)[:, None].expand(t, b, 4, 4).contiguous()
    gt = torch.rand((t, b, h, w, 1), generator=g) * 80 + 1
    gt = gt * (torch.rand((t, b, h, w, 1), generator=g) < 0.3)
    K = torch.tensor([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]])
    batch = {"left": torch.rand((t, b, h, w, 3), generator=g),
             "right": torch.rand((t, b, h, w, 3), generator=g),
             "disp_gt": gt, "T_cam": T_cam, "inv_T": torch.linalg.inv(T_cam),
             "K": K[None].expand(b, 3, 3).contiguous(),
             "baseline": torch.full((b,), baseline)}
    return {k: v.to(device) for k, v in batch.items()}


def _eval_bn_step(torch, port, cfg, model, batch):
    """The train step's loss, its gradients and one optimizer step on them
    with every BatchNorm reading its running statistics -> (grads, params
    before, params after)."""
    from temporalstereo_tpu_torch.training import build_losses, compute_losses

    params, stats = port.master_copies(model)
    state = port.TrainState.create(params, stats,
                                   port.build_optimizer(cfg, 10))
    model.zero_grad(set_to_none=True)
    outputs, _ = port.multi_frame_forward(model, batch, train=False)
    losses = compute_losses(outputs, batch["disp_gt"][-1], *build_losses(cfg))
    losses["loss"].backward()
    grads = {k: (torch.zeros_like(params[k]) if p.grad is None
                 else p.grad.float()) for k, p in model.named_parameters()}
    return grads, params, state.apply_gradients(grads).params


def phase_train_card_vs_cpu(torch, port):
    """One training step of the tiny model (T=3, f32, TF32 off) from the
    same weights on the card and on the CPU.

    The step itself (train-mode BatchNorm) is compared on its loss terms
    and the BatchNorm statistics it writes.  Its gradients are not: at this
    scale the batch statistics make them chaotic in the weights: on the
    CPU alone, a 1e-7 relative perturbation of the weights moves them by up
    to 4x the 1e-2 tolerance, a 1e-5 one by up to 1500x, and the card and
    the CPU differ by more than that (the streamed frames above by up to
    ~2e-4).  So every gradient, and the parameters after one optimizer step
    on them, are compared with the BatchNorms reading their running
    statistics, where the same 1e-7 perturbation moves them by 1e-3 of the
    tolerance.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    h, w, t = 96, 128, 3
    for name, extra in (("BLOCK_COST_SCALE 3", []),
                        ("BLOCK_COST_SCALE 0", NO_PYRAMID)):
        cfg = port.get_cfg(KITTI, opts=TINY_TRAIN + extra)
        runs = {}
        for dev in ("cuda", "cpu"):
            batch = train_batch(torch, t, 1, h, w, dev, seed=6, focal=30.0,
                                baseline=2.0, motion=(0.03, -0.05))
            model = port.build_model(cfg, device=dev, seed=5)
            grads, start, after = _eval_bn_step(torch, port, cfg, model,
                                                batch)
            state = port.TrainState.create(*port.master_copies(model),
                                           port.build_optimizer(cfg, 10))
            new, metrics = port.make_train_step(model, cfg)(state, batch)
            runs[dev] = {
                "metrics": {k: float(v) for k, v in metrics.items()},
                "stats": {k: v.cpu() for k, v in new.batch_stats.items()},
                "grads": {k: v.cpu() for k, v in grads.items()},
                "start": {k: v.cpu() for k, v in start.items()},
                "params": {k: v.cpu() for k, v in after.items()}}
        card, cpu = runs["cuda"], runs["cpu"]
        worst = {}
        for k, v in cpu["metrics"].items():
            if k == "grad_norm":
                continue
            rel = abs(card["metrics"][k] - v) / max(abs(v), 1e-12)
            worst["loss"] = max(worst.get("loss", 0.0), rel)
            if not rel < TRAIN_TOL["loss"]:
                raise AssertionError(f"train card vs CPU {name}: {k} "
                                     f"{card['metrics'][k]} vs {v}")

        def check(kind, ours, ref, scale, floor):
            for k, r in ref.items():
                err = float((ours[k] - r).abs().max())
                bound = scale(k) + floor
                worst[kind] = max(worst.get(kind, 0.0),
                                  err / max(bound, 1e-30))
                if not err <= bound:
                    raise AssertionError(f"train card vs CPU {name}: {kind} "
                                         f"{k} max|d| {err:.3g} > {bound:.3g}")
        check("stats", card["stats"], cpu["stats"],
              lambda k: TRAIN_TOL["stats"]
              * float(cpu["stats"][k].abs().max()),
              TRAIN_TOL["floor"] * max(float(v.abs().max())
                                       for v in cpu["stats"].values()))
        top = max(float(v.abs().max()) for v in cpu["grads"].values())
        check("grad", card["grads"], cpu["grads"],
              lambda k: TRAIN_TOL["grad"] * float(cpu["grads"][k].abs().max()),
              TRAIN_TOL["floor"] * top)
        moved = {k: float((v - cpu["start"][k]).abs().max())
                 for k, v in cpu["params"].items()}
        check("param", card["params"], cpu["params"],
              lambda k: TRAIN_TOL["param"] * moved[k]
              + 2 ** -22 * float(cpu["params"][k].abs().max()),
              TRAIN_TOL["floor"] * max(moved.values()))
        log(4, f"train step, tiny {h}x{w} T={t} f32 {name}, card vs CPU: "
            f"loss {cpu['metrics']['loss']:.6g}, worst loss rel "
            f"{worst['loss']:.3g} (tol {TRAIN_TOL['loss']}), BN statistics "
            f"{worst['stats']:.3g} of their tolerance; grad_norm "
            f"{card['metrics']['grad_norm']:.6g} vs "
            f"{cpu['metrics']['grad_norm']:.6g} (train-mode BN, not held); "
            f"with running-statistics BN, worst error / tolerance: "
            f"gradients {worst['grad']:.3g} over {len(cpu['grads'])} "
            f"tensors, parameters after the step {worst['param']:.3g}")


def _run_training(torch, port, kernels, cfg, steps, profile_phase=None):
    """``steps`` training steps of ``cfg`` on the card from seeded weights
    and a seeded batch -> (launch counts, per-step seconds, per-step max
    parameter change, share of parameters moved, metrics of the last
    step); then, with ``profile_phase``, one more step under the
    profiler."""
    b = cfg.DATA.TRAIN.BATCH_SIZE
    h, w = cfg.DATA.TRAIN.HEIGHT, cfg.DATA.TRAIN.WIDTH
    t = len(cfg.DATA.TRAIN.FRAME_IDXS)
    model = port.build_model(cfg, seed=0)
    params, stats = port.master_copies(model)
    state = port.TrainState.create(params, stats,
                                   port.build_optimizer(cfg, 1000))
    step = port.make_train_step(model, cfg)
    batch = train_batch(torch, t, b, h, w, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    secs, deltas, moved = [], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, metrics = step(state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if not all(bool(torch.isfinite(v)) for v in metrics.values()):
            raise AssertionError(f"training: non-finite metrics {metrics}")
        if any(p.dtype != torch.float32 for p in new.params.values()):
            raise AssertionError("training: master parameters are not f32")
        diff = [(new.params[k] - p).abs() for k, p in state.params.items()]
        deltas.append(max(float(d.max()) for d in diff))
        moved.append(sum(int((d > 0).sum()) for d in diff)
                     / sum(d.numel() for d in diff))
        state = new
    launches = dict(kernels.LAUNCHES)
    if profile_phase is not None:
        profile(torch, profile_phase, lambda: step(state, batch), 1, "step")
    with torch.no_grad():
        outputs, _ = port.multi_frame_forward(model, batch)
    for i, disp in enumerate(outputs["disps"]):
        if disp.shape != (b, h, w, 1) or not torch.isfinite(disp).all():
            raise AssertionError(f"training: disparity {i} after the steps "
                                 f"is not finite of shape ({b}, {h}, {w}, 1)")
    return launches, secs, deltas, moved, {k: float(v) for k, v in
                                          metrics.items()}


def phase_flagship_train(torch, port, kernels, card, steps=3):
    cfg = port.get_cfg(KITTI)
    b, t = cfg.DATA.TRAIN.BATCH_SIZE, len(cfg.DATA.TRAIN.FRAME_IDXS)
    h, w = cfg.DATA.TRAIN.HEIGHT, cfg.DATA.TRAIN.WIDTH
    lr = cfg.OPTIMIZER.RMSPROP.LR
    launches, secs, deltas, moved, metrics = _run_training(
        torch, port, kernels, cfg, steps, profile_phase=6)
    want = {"fused_cost_base": 2 * t * steps,
            "fused_cost_base_backward": 2 * steps, "shift_1d": 0,
            "shift_1d_backward": 0, "summation_splat": (t - 1) * steps}
    if launches != want:
        raise AssertionError(f"training launch counts {launches} != {want}")
    # RMSProp moves a weight by at most lr * |g| / sqrt(0.01 g^2) = 10 lr;
    # with bf16 storage most updates of ~lr would round away
    for i, (dmax, share) in enumerate(zip(deltas, moved)):
        if not (0.1 * lr <= dmax <= 10.01 * lr and share > 0.5):
            raise AssertionError(f"training step {i}: max parameter change "
                                 f"{dmax:.3g} (lr {lr:g}), share moved "
                                 f"{share:.3f}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(6, f"flagship training kitti2015-multi v2s bf16 B={b} {h}x{w} T={t}, "
        f"{steps} steps: loss {metrics['loss']:.6g}, grad_norm "
        f"{metrics['grad_norm']:.6g}, launches {launches}; max parameter "
        f"change per step / lr {[round(d / lr, 3) for d in deltas]}, share "
        f"of parameters moved {[round(m, 4) for m in moved]}; per-step ms "
        f"{[round(1e3 * x, 2) for x in secs]} (after the first: "
        f"{1e3 * sum(secs[1:]) / max(len(secs) - 1, 1):.2f}), peak memory "
        f"{peak:.2f} GiB on {card}")
    return launches


def phase_no_pyramid_train(torch, port, kernels):
    cfg = port.get_cfg(KITTI, opts=NO_PYRAMID + [
        "DATA.TRAIN.BATCH_SIZE", "1", "DATA.TRAIN.FRAME_IDXS", "[-1, 0]"])
    t = len(cfg.DATA.TRAIN.FRAME_IDXS)
    launches, secs, _, _, metrics = _run_training(torch, port, kernels, cfg,
                                                  1)
    want = {"fused_cost_base": 0, "fused_cost_base_backward": 0,
            "shift_1d": 2 * t, "shift_1d_backward": 2,
            "summation_splat": t - 1}
    if launches != want:
        raise AssertionError(f"BLOCK_COST_SCALE 0 launch counts {launches} "
                             f"!= {want}")
    log(7, f"training BLOCK_COST_SCALE 0, v2s bf16 B=1 "
        f"{cfg.DATA.TRAIN.HEIGHT}x{cfg.DATA.TRAIN.WIDTH} T={t}, one step: "
        f"loss {metrics['loss']:.6g}, finite, launches {launches}, "
        f"{1e3 * secs[0]:.1f} ms")
    return launches


def profile(torch, phase, fn, repeats, unit):
    """Device busy share and kernel time by name over ``repeats`` calls of
    ``fn`` (torch.profiler), each call one ``unit``."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn()
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
    log(phase, f"profile: {unit} x {repeats}, wall {1e3 * wall:.2f} ms, "
        f"device busy {busy / 1e3:.2f} ms (share {busy / 1e6 / wall:.3f}), "
        f"{len(kernels) // repeats} kernels/{unit}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for name, (t, n) in top[:20]:
        log(phase, f"  {t / repeats / 1e3:8.3f} ms/{unit} {n // repeats:5d}/"
            f"{unit}  {name[:100]}")


def profile_stream(torch, port, cfg, h, w):
    """Kernel time by name over two steady-state frames."""
    model = port.build_model(cfg, seed=0)
    state = {"prev": port.init_prev_info(
        model, 1, (h, w), port.backbone_memory_shapes(model.backbone_cfg,
                                                      (h, w)),
        2, local_map_channels=0)}
    K, bl, T = _geometry(torch, h, w, "cuda")
    x = torch.rand((1, h, w, 3), device="cuda")

    def frame():
        _, state["prev"] = port.streaming_step(model, x, x, state["prev"], K,
                                               bl, T)
    for _ in range(5):
        frame()
    profile(torch, 5, frame, 2, "frame")


KERNEL_SOURCES = {
    "fused_cost_base": ("fused_cost_base.cu",
                        "temporalstereo_tpu/ops/pallas/cost.py:118",
                        "one frame of the flagship stream"),
    "fused_cost_base_backward": (
        "fused_cost_base_backward.cu",
        "temporalstereo_tpu/ops/pallas/cost.py:130",
        "one flagship training step (fine + precise)"),
    "shift_1d": ("shift_1d.cu", "temporalstereo_tpu/ops/pallas/shift.py:50",
                 "one frame at the training shapes (fine + precise)"),
    "shift_1d_backward": ("shift_1d.cu",
                          "temporalstereo_tpu/ops/pallas/shift.py:88",
                          "one training step (fine + precise)"),
    "summation_splat": ("summation_splat.cu",
                        "temporalstereo_tpu/ops/pallas/splat.py:72",
                        "one frame of the flagship stream"),
}


def kernels_line(detail, launches_by_path):
    """One JSON line: per kernel its bf16 rows on uniform hypotheses summed
    over the stages (the splat's one f32 row), launches summed over the
    main paths and listed by path; every row in ``detail``."""
    entries = []
    for name, (src, replaces, per) in KERNEL_SOURCES.items():
        rows = ([r for r in detail[name] if r["dtype"] == "bfloat16"
                 and r.get("case", "uniform") == "uniform"] or detail[name])
        by_path = {path: counts[name]
                   for path, counts in launches_by_path.items()}
        lib = [r.get("library_ms") for r in rows]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"temporalstereo_tpu_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "device_ms": (None if any(r["device_ms"] is None for r in rows)
                          else sum(r["device_ms"] for r in rows)),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "bytes",
            "library_ms": (None if None in lib else sum(lib)),
            "per": per, "detail": detail[name]})
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
    phase_train_kernels(torch, kernels, detail)
    phase_card_vs_cpu(torch, port)
    phase_train_card_vs_cpu(torch, port)
    launches = {"stream": phase_flagship(torch, port, kernels, card)}
    launches["train"] = phase_flagship_train(torch, port, kernels, card)
    launches["train_block_cost_scale_0"] = phase_no_pyramid_train(
        torch, port, kernels)
    print(kernels_line(detail, launches), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
