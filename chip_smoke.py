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
     cost base at the shapes of the flagship stream; the one-launch
     softsplat in softmax and summation mode at the temporal update's
     shapes of the stream and of the training step, on uniform, rigid
     (reprojected) and all-on-one-target flows, each row run twice and
     required bit-identical, its device time summed over everything the
     call puts on the card; the shift (forward and backward) and the cost
     base's backward at the shapes of the flagship training step (backward
     against torch autograd of the plain version, run twice to show it
     deterministic), the backwards on uniform hypotheses and on model-like
     ones (a smooth disparity field and the cascade's offsets around it);
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
  8. serving: the flagship stream's stages captured as CUDA graphs
     (serving.StreamingBundle; capture time per stage), 12 replayed frames
     against the same stream run eagerly (gated at 5e-3, bit-equality
     reported), two replays of the same inputs bit-identical, the cost
     base's and the splat's kernels counted by name (torch.profiler) in
     the replayed stream and in one steady replay, the steady median and
     peak memory; the same with BatchNorm folded and with bf16 weights
     (finite; their difference from the unfolded model reported, each
     frame from its state and free-running), the folded tiny f32 model
     against the unfolded one, each frame from the unfolded model's state
     (gated at 2e-3); the video_inference CLI from a
     bundle at 384x1248 on six PNG frames the port's codec wrote; the
     bench (python -m temporalstereo_tpu_torch.bench) and its JSON line;
  9. evaluation: the tiny f32 model's eval metrics on the card against
     the CPU (T=3); a synthetic KITTI 2015 multiview split (two samples of
     11 frames of 375x1242 PNGs, both views' sparse ground truth, calib
     and pose files) through the port's loader with forkserver process
     workers and make_eval_step (configs/kitti2015-multi.yaml: v2s, bf16,
     384x1248, B=1, T=11, occ/noc on): loader wait and synchronised step
     time per sample, one sample's build time on one core, PNG decode
     time (Up and Paeth rows), peak memory, every metric (finite, weight
     = samples), launch counts, the cost-base and softsplat kernels of
     one step by name under torch.profiler; then python -m
     temporalstereo_tpu_torch.cli.kitti_submission on the same split;
 10. training: python -m temporalstereo_tpu_torch.cli.train with
     configs/kitti2015-multi.yaml at full width (v2s, bf16, B=4,
     320x1184, T=11, 8 process workers; validation at 384x1248, B=1) on
     a synthetic KITTI 2015 split of 8 train and 2 val samples: 2 epochs
     with validation and a checkpoint each, SWA from half-way with its
     BatchNorm re-estimate, a warm start from a .pth of the seeded model,
     then test(); exact launch counts, checkpoints and finite tables; the
     fit's step time against phase 6's, loader wait, checkpoint time and
     size, SWA finish, eval time per sample, peak memory; a resume from
     its checkpoints in this process for one more epoch (every restored
     tensor bit-equal to the file, the step and the SWA count carried
     on); one trainer step under torch.profiler; then
     temporalstereo_tpu_torch.cli.sanity_train (v2s, bf16, 256x512, B=4,
     150 steps), whose EPE must fall;
 11. one JSON line listing every kernel, then the result line.
It imports nothing of JAX and needs one card.
"""
import json
import math
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
MEASURED = {}                   # numbers one phase hands to a later one
# |kernel - plain| <= RTOL * |plain| + ATOL * max|plain of that block|
COST_TOL = {"float32": (1e-5, 1e-6), "bfloat16": (2 ** -7, 2 ** -8)}
# the splat's kernel adds each target's taps in source order, the plain
# version's index_add_ tap by tap: the same products, summed in another order
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


def _device_events(fn, iters):
    """The device events (kernels, memsets, copies) of ``iters`` calls of
    ``fn`` under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(fn, kernel, iters=20):
    """The kernel's own device time per call: torch.profiler over ``iters``
    calls of ``fn``, the CUDA kernels whose name holds ``kernel``; None if
    the profiler saw none."""
    hits = [e for e in _device_events(fn, iters) if kernel in e.name]
    if len(hits) != iters:
        return None
    return sum(e.time_range.elapsed_us() for e in hits) / iters / 1e3


def call_device_ms(fn, iters=20):
    """(device ms, device events) per call of ``fn``, summed over every
    kernel, memset and copy the call puts on the card; (None, 0) if the
    profiler saw none."""
    hits = _device_events(fn, iters)
    if not hits:
        return None, 0
    return (sum(e.time_range.elapsed_us() for e in hits) / iters / 1e3,
            len(hits) / iters)


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
    detail = {"fused_cost_base": []}

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


def splat_inputs(torch, case, b, h, w, g, dev):
    """(inputs [B,H,W,7], flow [B,H,W,2], metric [B,H,W,1]) of one splat
    row, as models/stereo.py:update_prev_info hands them over: 2 warped
    disparity samples + 2 costs + 3 local-map channels, and the metric
    clamp(disparity - its mean, +-50) of a model-like disparity field at
    1/8 (``model_like_disparity``).  The flow, by ``case``:
      uniform     uniform in +-3 px on both axes;
      rigid       that field's reprojection under bench.py's per-frame
                  motion (focal 720 / 8 px, baseline 0.54 m) through the
                  port's project_to_3d, sliced out of its [B,H,W,6,2]
                  output as update_prev_info slices it (strided);
      one_target  every source onto one point, (w/2 + 0.25, h/2 + 0.5)."""
    from temporalstereo_tpu_torch.ops.warp import project_to_3d

    disp = model_like_disparity(torch, g, b, 5, h, w, dev)[:, 2, ..., None]
    metric = torch.clamp(disp - disp.mean(), -50.0, 50.0)
    inputs = torch.rand((b, h, w, 7), generator=g, device=dev) * 10
    if case == "uniform":
        flow = (torch.rand((b, h, w, 2), generator=g, device=dev) - 0.5) * 6
    elif case == "rigid":
        K, bl, T = _geometry(torch, h, w, dev, focal=720.0 / 8)
        depth = bl.view(1, 1, 1, 1) * K[0, 0, 0] / (disp + 1e-5)
        outs = project_to_3d(depth.expand(b, h, w, 6).contiguous(),
                             K.expand(b, 3, 3), torch.linalg.inv(K).expand(
                                 b, 3, 3), T.expand(b, 4, 4))
        flow = outs["optical_flow"][:, :, :, 0, :]
    else:
        ys, xs = torch.meshgrid(torch.arange(h, device=dev),
                                torch.arange(w, device=dev), indexing="ij")
        flow = torch.stack([w // 2 + 0.25 - xs, h // 2 + 0.5 - ys], -1)
        flow = flow.float().expand(b, h, w, 2).contiguous()
    return inputs, flow, metric


# (path, (B, H, W)) of the temporal update: 1/8 of the flagship stream's
# 384x1248 and of the training crop 320x1184
SPLAT_SHAPES = (("stream", (1, 48, 156)), ("train", (4, 40, 148)))


def phase_splat(torch, kernels, detail):
    """Phase 3, the temporal update: the one-launch softsplat against its
    plain version in softmax mode (7 channels + the weight, as the model
    calls it) and summation mode (the TPU kernel's own function, 8
    channels), at the stream's and the training step's shapes, on three
    flows; each row twice, the two bit-identical."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    detail["softsplat"] = []
    for path, (b, h, w) in SPLAT_SHAPES:
        for case in ("uniform", "rigid", "one_target"):
            inputs, flow, metric = splat_inputs(torch, case, b, h, w, g, dev)
            for mode in ("softmax", "summation"):
                if mode == "summation":
                    # what the softmax mode splats: [inputs * e^m, e^m]
                    inputs = torch.cat([inputs * metric.exp(), metric.exp()],
                                       -1)
                    metric = None

                def call(x=inputs, f=flow, m=metric, mode=mode):
                    return kernels.softsplat(x, f, m, mode)
                first, second = call(), call()
                plain = kernels.softsplat_plain(inputs, flow, metric, mode)
                torch.cuda.synchronize()
                err, ok = close(first, plain, *SPLAT_TOL)
                spread = float((first - second).abs().max())
                same = torch.equal(first, second)
                ms, lo, hi = cuda_ms_spread(call)
                dev_ms, events = call_device_ms(call)
                c = inputs.shape[-1]
                nbytes = b * h * w * (2 * c * 4 + 8 + (4 if metric is not None
                                                       else 0))
                row = _row(path, [b, h, w, c + (mode != "summation")],
                           "float32", err, ms,
                           cuda_ms(lambda: kernels.softsplat_plain(
                               inputs, flow, metric, mode), 10),
                           None, nbytes, spread, dev_ms, f"{mode} {case}",
                           (lo, hi))
                row["device_events_per_call"] = events
                row["main"] = (path, mode, case) == ("stream", "softmax",
                                                     "rigid")
                detail["softsplat"].append(row)
                _log_row("softsplat", row, SPLAT_TOL)
                if not ok:
                    raise AssertionError(f"softsplat {path} {mode} {case} "
                                         "disagrees with its plain version")
                if not same:
                    raise AssertionError(f"softsplat {path} {mode} {case}: "
                                         f"two runs differ by {spread:.3g}")


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
            "softsplat": frames - 1}
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
    MEASURED["train_step_s"] = secs
    want = {"fused_cost_base": 2 * t * steps,
            "fused_cost_base_backward": 2 * steps, "shift_1d": 0,
            "shift_1d_backward": 0, "softsplat": (t - 1) * steps}
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
            "softsplat": t - 1}
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
    ``fn`` (torch.profiler), each call one ``unit`` -> ({name: (us,
    launches)}, device events)."""
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
    return by_name, len(kernels)


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


# the serving phase: replays against eager, folded against unfolded
FOLD_TOL = 2e-3                 # the single-frame model tolerance of the tests
COST_KERNEL = "fused_cost_base_kernel"
SPLAT_KERNEL = "softsplat_kernel"


def randomize_batch_norms(torch, model, seed):
    """Seeded BatchNorm parameters and statistics away from identity
    (scale and variance in [0.75, 1.25], shift and mean ~ N(0, 0.1)), so
    that folding and the bf16 cast change the arithmetic."""
    from temporalstereo_tpu_torch.nn.layers import BatchNorm

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                n = m.num_features
                for t, fill in ((m.weight, "rand"), (m.bias, "randn"),
                                (m.running_mean, "randn"),
                                (m.running_var, "rand")):
                    x = (torch.rand(n, generator=g) * 0.5 + 0.75
                         if fill == "rand" else torch.randn(n, generator=g)
                         * 0.1)
                    t.copy_(x)


def seeded_frames(torch, n, h, w, seed):
    g = torch.Generator().manual_seed(seed)
    return [(torch.rand((1, h, w, 3), generator=g).cuda(),
             torch.rand((1, h, w, 3), generator=g).cuda()) for _ in range(n)]


def kernel_counts(torch, fn):
    """(events, {kernel: launches}) that one call of ``fn`` puts on the
    card, by torch.profiler; the two kernels of the stream by name."""
    events = _device_events(fn, 1)
    return len(events), {
        "fused_cost_base": sum(COST_KERNEL in e.name for e in events),
        "softsplat": sum(SPLAT_KERNEL in e.name for e in events)}


def max_rel(torch, outs, refs):
    return max(float((a - b).abs().max() / (b.abs().mean() + 1e-6))
               for a, b in zip(outs, refs))


def agreement(torch, outs, refs):
    """How far disparities are from reference ones: (max|d| / mean|ref|,
    mean|d| / mean|ref|, share of pixels more than 3 px off)."""
    d = torch.stack([(a - b).abs() for a, b in zip(outs, refs)])
    scale = float(torch.stack(refs).abs().mean()) + 1e-6
    return (float(d.max()) / scale, float(d.mean()) / scale,
            float((d > 3).float().mean()))


def same_state(torch, port, serving, ref, model, pairs, K, bl, T):
    """(model's, ref's) four disparities of each frame when ``model``
    starts every frame from ``ref``'s state: what one step of the stream
    adds, without the recurrence."""
    prev = serving.initial_prev(ref, 1, *pairs[0][0].shape[1:3])
    got, want = [], []
    for left, right in pairs:
        out, nxt = port.streaming_step(ref, left, right, prev, K, bl, T)
        ours, _ = port.streaming_step(model, left, right, prev, K, bl, T)
        got += ours["disps"]
        want += out["disps"]
        prev = nxt
    return got, want


def serve(torch, serving, model, frames, K, bl, T, fold_bn=False):
    """Capture the model's stages and replay ``frames`` (each step timed
    with a synchronise) -> (bundle, disparities, per-frame seconds, bytes
    the capture left allocated)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    h, w = frames[0][0].shape[1:3]
    bundle = serving.StreamingBundle(
        serving.bundle_meta(model, 1, h, w, fold_bn), model,
        progress=lambda msg: None)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    outs, secs = [], []
    for left, right in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(bundle.step(left, right, K, bl, T))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return bundle, outs, secs, held


def eager_stream(torch, port, serving, model, frames, K, bl, T):
    prev = serving.initial_prev(model, 1, *frames[0][0].shape[1:3])
    outs = []
    for left, right in frames:
        out, prev = port.streaming_step(model, left, right, prev, K, bl, T)
        outs.append(out["disps"][0])
    return outs, prev


def serving_model(torch, port, cfg, prep=None):
    """The seeded model with seeded BatchNorms, prepared (folded, cast)."""
    model = port.build_model(cfg, seed=0)
    randomize_batch_norms(torch, model, seed=9)
    return model if prep is None else prep(model)


def phase_serving(torch, port, kernels, card, frames=12, warm=4):
    """Phase 8: the flagship stream as CUDA-graph replays
    (serving.StreamingBundle) against the same stream run eagerly, unfolded,
    with BatchNorm folded and with bf16 weights; the folded tiny f32 model
    against the unfolded one -> the launches of the unfolded replays."""
    from temporalstereo_tpu_torch import serving
    from temporalstereo_tpu_torch.utils.fold_bn import fold_batch_norms

    h, w = 384, 1248
    cfg = port.get_cfg(opts=FLAGSHIP)
    K, bl, T = _geometry(torch, h, w, "cuda")
    pairs = seeded_frames(torch, frames, h, w, seed=8)
    ref = serving_model(torch, port, cfg)
    base = launches = None
    variants = (("unfolded", None),
                ("fold_bn", lambda m: fold_batch_norms(m)[0]),
                ("bf16_params", serving.cast_params_bf16))
    for label, prep in variants:
        torch.cuda.empty_cache()
        model = ref if prep is None else serving_model(torch, port, cfg,
                                                        prep)
        weights = sum(t.numel() * t.element_size()
                      for t in model.state_dict().values())
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        bundle, outs, secs, held = serve(torch, serving, model, pairs, K, bl,
                                         T, label == "fold_bn")
        peak = torch.cuda.max_memory_allocated() - start
        stages = list(bundle.capture_seconds)
        if stages != bundle.meta["stages"]:
            raise AssertionError(f"serving {label}: captured {stages}")
        if not all(bool(torch.isfinite(o).all()) and o.shape == (1, h, w, 1)
                   for o in outs):
            raise AssertionError(f"serving {label}: disparities not finite")
        # a second pass of the same inputs, profiled: bit-identical, and the
        # kernels of the whole stream by name
        second = []

        def replay_all():
            bundle.reset()
            second.clear()
            for left, right in pairs:
                second.append(bundle.step(left, right, K, bl, T))
        _, per_run = kernel_counts(torch, replay_all)
        if not all(torch.equal(a, b) for a, b in zip(outs, second)):
            raise AssertionError(f"serving {label}: two replays differ")
        want = {"fused_cost_base": 2 * frames, "softsplat": frames - 1}
        if per_run != want:
            raise AssertionError(f"serving {label}: the replayed stream ran "
                                 f"{per_run}, not {want}")
        steady_events, steady = kernel_counts(
            torch, lambda: bundle.step(*pairs[0], K, bl, T))
        if steady != {"fused_cost_base": 2, "softsplat": 1}:
            raise AssertionError(f"serving {label}: a steady replay ran "
                                 f"{steady}")
        eager, prev = eager_stream(torch, port, serving, model, pairs, K, bl,
                                   T)
        eager_events, _ = kernel_counts(
            torch, lambda: port.streaming_step(model, *pairs[0], prev, K, bl,
                                               T))
        rel = max_rel(torch, outs, eager)
        equal = all(torch.equal(a, b) for a, b in zip(outs, eager))
        if not rel <= CARD_VS_CPU_TOL:
            raise AssertionError(f"serving {label}: replays vs eager rel "
                                 f"{rel:.3g} > {CARD_VS_CPU_TOL}")
        steady_ms = 1e3 * sorted(secs[warm:])[len(secs[warm:]) // 2]
        vs = ""
        if base is None:
            base = outs
        else:
            got, want = same_state(torch, port, serving, ref, model, pairs,
                                   K, bl, T)
            vs = ("; against the unfolded model (max|d|, mean|d| over "
                  "mean|ref|, share > 3 px): each frame from its state "
                  "%.3g, %.3g, %.4f; the free-running stream %.3g, %.3g, "
                  "%.4f" % (agreement(torch, got[::4], want[::4])
                            + agreement(torch, outs, base)))
        log(8, f"serving flagship {label} v2s bf16 {h}x{w}: captured "
            + ", ".join(f"{k} {v:.2f} s" for k, v in
                        bundle.capture_seconds.items())
            + f"; {frames} replayed frames finite, vs eager rel {rel:.3g} "
            f"(tol {CARD_VS_CPU_TOL}, bit-equal {equal}), two replays "
            f"bit-identical{vs}; per-frame ms "
            f"{[round(1e3 * x, 2) for x in secs]}, steady median "
            f"{steady_ms:.2f} ms; a steady replay {steady_events} device "
            f"events ({steady}), an eager steady frame {eager_events}; "
            f"weights {weights / 2 ** 30:.3f} GiB, the graphs hold "
            f"{held / 2 ** 30:.3f} GiB, peak {peak / 2 ** 30:.3f} GiB above "
            f"the weights and the frames on {card}")
        if label == "unfolded":
            launches = {name: 0 for name in kernels.LAUNCHES}
            launches.update(per_run)
        del bundle, outs, second, eager, prev
    del ref, model
    phase_fold_tiny(torch, port, serving, fold_batch_norms)
    return launches


def phase_fold_tiny(torch, port, serving, fold_batch_norms):
    """The tiny f32 model (TF32 off) with non-trivial BatchNorms, folded
    against unfolded: each of three frames from the unfolded model's state
    (gated), and the two free-running streams as replays (reported)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    h, w = 96, 160
    K, bl, T = _geometry(torch, h, w, "cuda", 30.0, 2.0)
    pairs = seeded_frames(torch, 3, h, w, seed=10)
    models = []
    for fold in (False, True):
        model = port.build_model(port.get_cfg(opts=TINY), seed=3)
        randomize_batch_norms(torch, model, seed=11)
        models.append(fold_batch_norms(model)[0] if fold else model)
    rel = max_rel(torch, *same_state(torch, port, serving, *models, pairs,
                                     K, bl, T))
    if not rel < FOLD_TOL:
        raise AssertionError(f"folded tiny model vs unfolded: rel {rel:.3g}")
    runs = [serve(torch, serving, m, pairs, K, bl, T, i == 1)[1]
            for i, m in enumerate(models)]
    log(8, f"tiny {h}x{w} f32, folded vs unfolded: each of 3 frames from "
        f"the unfolded state, max rel {rel:.3g} over the four disparities "
        f"(tol {FOLD_TOL}); the free-running replayed streams (max|d|, "
        "mean|d| over mean|ref|, share > 3 px) %.3g, %.3g, %.4f"
        % agreement(torch, runs[1], runs[0]))


def write_sequence(root, n, h, w, seed=12):
    """n seeded stereo frames at the KITTI raw size, written with the
    port's PNG codec, a ground truth of another size and matrix poses 0.5 m
    apart."""
    import numpy as np

    from temporalstereo_tpu_torch.data.formats import write_kitti_disp
    from temporalstereo_tpu_torch.data.png import write_png

    rng = np.random.RandomState(seed)
    for sub in ("left", "right", "disp_gt"):
        (root / sub).mkdir(parents=True)
    rows = []
    for i in range(n):
        for sub in ("left", "right"):
            write_png(str(root / sub / f"{i:06d}.png"),
                      (rng.rand(h, w, 3) * 255).astype(np.uint8))
        write_kitti_disp(str(root / "disp_gt" / f"{i:06d}.png"),
                         rng.uniform(1, 60, (h, w)).astype(np.float32))
        pose = np.eye(4)[:3]
        pose[2, 3] = 0.5 * i
        rows.append(" ".join(f"{v:.6f}" for v in pose.ravel()))
    (root / "pose_left.txt").write_text("\n".join(rows) + "\n")


def phase_cli(torch, port, card, frames=6):
    """The video_inference CLI from a bundle at 384x1248 on PNG frames the
    port's codec wrote (KITTI raw size, 375x1242)."""
    import re
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from temporalstereo_tpu_torch import serving
    from temporalstereo_tpu_torch.data.png import read_png

    repo = pathlib.Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = pathlib.Path(tmp)
        write_sequence(tmp / "seq", frames, 375, 1242)
        model = port.build_model(port.get_cfg(KITTI), seed=0)
        serving.export_streaming_bundle(model, str(tmp / "bundle.json"), 1,
                                        384, 1248, progress=lambda m: None)
        del model
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "temporalstereo_tpu_torch.cli."
             "video_inference", "--config-file", KITTI, "--data-root",
             str(tmp / "seq"), "--log-dir", str(tmp / "out"),
             "--load-bundle", str(tmp / "bundle.json")],
            cwd=repo, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if out.returncode != 0:
            raise AssertionError(f"video_inference failed:\n{out.stderr}")
        names = sorted(p.name for p in (tmp / "out").iterdir())
        want = sorted([f"{i:06d}{s}.png" for i in range(frames)
                       for s in ("", "_color")] + ["error.txt"])
        if names != want:
            raise AssertionError(f"video_inference wrote {names}")
        for i in range(frames):
            disp = read_png(str(tmp / "out" / f"{i:06d}.png"))
            if disp.dtype != np.uint16 or disp.shape != (384, 1248):
                raise AssertionError(f"frame {i}: {disp.dtype} {disp.shape}")
        errors = (tmp / "out" / "error.txt").read_text().splitlines()
        ms = [float(x) for x in re.findall(r": ([0-9.]+) ms", out.stdout)]
        if len(errors) != frames + 1 or len(ms) != frames:
            raise AssertionError(f"video_inference printed {out.stdout}")
    log(8, f"video_inference --load-bundle 384x1248, {frames} PNG frames of "
        f"375x1242: {len(names)} files, {errors[-1]}; per-frame ms {ms}; "
        f"process wall {wall:.1f} s on {card}")


def phase_bench(card):
    """python -m temporalstereo_tpu_torch.bench: its JSON line."""
    repo = pathlib.Path(__file__).resolve().parent
    out = subprocess.run([sys.executable, "-m",
                          "temporalstereo_tpu_torch.bench"], cwd=repo,
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"bench failed:\n{out.stderr}")
    line = out.stdout.strip().splitlines()[-1]
    result = json.loads(line)
    if not result["value"] > 0:
        raise AssertionError(f"bench: {line}")
    log(8, f"bench on {card}: {line}")


# the evaluation phase: the KITTI 2015 val path at full width
EVAL_FRAMES = list(range(-10, 1))
EVAL_SAMPLES = 2


def _median_ms(fn, n):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[n // 2]


def decode_ms(read_png, write_png, path, tmp):
    """Host ms to decode one of the split's 375x1242 RGB PNGs: as written
    (row filter Up, the codec's default) and rewritten with Paeth rows, as
    real KITTI files are."""
    img = read_png(path)
    paeth = str(tmp / "paeth.png")
    write_png(paeth, img, filter_type=4)
    return _median_ms(lambda: read_png(path), 5), \
        _median_ms(lambda: read_png(paeth), 3)


def eval_metrics_close(card_m, cpu_m, card_d, cpu_d, gt):
    """Card against CPU: each EPE within the largest disparity difference
    phase 4's tolerance allows (CARD_VS_CPU_TOL of the mean CPU
    disparity), each outlier percentage within the pixels whose CPU error
    lies that close to its threshold (a percentage is a step function);
    -> the worst max|d| / mean|cpu| of the disparities."""
    valid = (gt > 0) & (gt < 192)
    worst = 0.0
    for i, (a, b) in enumerate(zip(card_d, cpu_d)):
        scale = float(b.abs().mean()) + 1e-6
        gap = float((a - b).abs()[valid].max())
        worst = max(worst, gap / scale)
        if not gap / scale < CARD_VS_CPU_TOL:
            raise AssertionError(f"eval card vs CPU: disparity {i} "
                                 f"{gap / scale:.3g}")
        err = (gt - b).abs()
        for key in [k for k in cpu_m if k.startswith(
                f"metric_disparity_{i}/")]:
            d = abs(float(card_m[key]) - float(cpu_m[key]))
            stat = key.rsplit("_", 1)[1]
            if stat == "epe":
                limit = CARD_VS_CPU_TOL * scale
            else:
                px = int(stat[:-2])
                near = ((err - px).abs() <= gap) & valid
                limit = 100.0 * float(near.sum()) / float(valid.sum())
            if not d <= limit + 1e-6:
                raise AssertionError(f"eval card vs CPU: {key} {d:.3g} > "
                                     f"{limit:.3g}")
    for key in cpu_m:
        if key.startswith("weight") and float(card_m[key]) != float(
                cpu_m[key]):
            raise AssertionError(f"eval card vs CPU: {key}")
    return worst


def phase_eval_card_vs_cpu(torch, port, tmp):
    """The tiny f32 model's eval metrics on the card against the CPU: one
    sample of T=3 at 96x160 from ground truth at 120x200, occ/noc on."""
    from temporalstereo_tpu_torch.data import batch_to_device
    from temporalstereo_tpu_torch.data import build_dataloader
    from temporalstereo_tpu_torch.data.synthetic import write_kitti2015_split
    from temporalstereo_tpu_torch.ops import resize_bilinear
    from temporalstereo_tpu_torch.training import make_eval_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ann = write_kitti2015_split(str(tmp), 1, [-2, -1, 0], 120, 200, seed=3)
    cfg = port.get_cfg(KITTI, TINY_TRAIN + [
        "DATA.VAL.DATA_ROOT", str(tmp), "DATA.VAL.ANNFILE", ann,
        "DATA.VAL.HEIGHT", "96", "DATA.VAL.WIDTH", "160",
        "DATA.VAL.FRAME_IDXS", "[-2, -1, 0]",
        "DATA.VAL.PROCESS_WORKERS", "False",
        "VAL.DO_OCCLUSION_EVALUATION", "True"])
    batch = next(iter(build_dataloader(cfg.DATA.VAL, "val")))
    gt = torch.from_numpy(batch["disp_gt"][-1])
    runs = {}
    for device in ("cuda", "cpu"):
        model = port.build_model(cfg, device=device, seed=3)
        b = batch_to_device(batch, device)
        metrics = make_eval_step(model, cfg)(b)
        with torch.no_grad():
            disps = port.multi_frame_forward(model, b)[0]["disps"]
        disps = [resize_bilinear(d.float() * (gt.shape[2] / d.shape[2]),
                                 gt.shape[1:3]).cpu() for d in disps]
        runs[device] = ({k: v.cpu() for k, v in metrics.items()}, disps)
    worst = eval_metrics_close(runs["cuda"][0], runs["cpu"][0],
                               runs["cuda"][1], runs["cpu"][1], gt)
    log(9, f"tiny f32 eval step T=3 96x160 (gt 120x200), card vs CPU: "
        f"{len(runs['cpu'][0])} metrics within the allowance, disparities "
        f"max|d|/mean|cpu| {worst:.3g} (tol {CARD_VS_CPU_TOL})")


def phase_eval(torch, port, kernels, card):
    """Phase 9: the KITTI 2015 val path at full width through the port's
    loader and make_eval_step, then the kitti_submission CLI; -> the
    launch counts of the eval loop."""
    import re
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from temporalstereo_tpu_torch.data import batch_to_device
    from temporalstereo_tpu_torch.data import build_dataloader
    from temporalstereo_tpu_torch.data.png import read_png, write_png
    from temporalstereo_tpu_torch.data.synthetic import write_kitti2015_split
    from temporalstereo_tpu_torch.training import make_eval_step

    t_phase = time.perf_counter()
    repo = pathlib.Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        ann = write_kitti2015_split(str(tmp / "kitti"), EVAL_SAMPLES,
                                    EVAL_FRAMES)
        written = time.perf_counter() - t0
        split = ["DATA.VAL.DATA_ROOT", str(tmp / "kitti"),
                 "DATA.VAL.ANNFILE", ann, "DATA.VAL.FRAME_IDXS",
                 str(EVAL_FRAMES), "VAL.DO_OCCLUSION_EVALUATION", "True"]
        cfg = port.get_cfg(KITTI, split + ["DATA.VAL.PROCESS_WORKERS",
                                           "True"])
        loader = build_dataloader(cfg.DATA.VAL, "val")
        batches = iter(loader)
        waits, steps, totals, ready = [], [], {}, []
        try:
            # the workers start and build the first batch while the host
            # checks the tiny model, measures the decode and builds the model
            with ThreadPoolExecutor(1) as ahead:
                t_start = time.perf_counter()
                first = ahead.submit(next, batches, None)
                first.add_done_callback(
                    lambda f: ready.append(time.perf_counter()))
                phase_eval_card_vs_cpu(torch, port, tmp / "tiny")
                name = loader.dataset.data_list[0]["0"]["left_image_path"]
                up_ms, paeth_ms = decode_ms(read_png, write_png,
                                            str(tmp / "kitti" / name), tmp)
                sample_ms = _median_ms(
                    lambda: loader.dataset.getitem_seeded(0, 0), 1)
                model = port.build_model(cfg, seed=0)
                eval_step = make_eval_step(model, cfg)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated() / 2 ** 30
                kernels.reset_launches()
                t_wait = time.perf_counter()
                batch = first.result()
            while batch is not None:
                waits.append(time.perf_counter() - t_wait)
                t0 = time.perf_counter()
                tb = batch_to_device(batch)
                metrics = eval_step(tb)
                torch.cuda.synchronize()
                steps.append(time.perf_counter() - t0)
                for k, v in metrics.items():
                    totals.setdefault(k, []).append(float(v))
                t_wait = time.perf_counter()
                batch = next(batches, None)
        finally:
            loader.close()
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30

        b = cfg.DATA.VAL.BATCH_SIZE
        if len(steps) != EVAL_SAMPLES // b:
            raise AssertionError(f"eval loader gave {len(steps)} batches")
        bad = [k for k, v in totals.items()
               if not all(map(math.isfinite, v))]
        if bad:
            raise AssertionError(f"eval metrics not finite: {bad}")
        if sum(totals["weight"]) != EVAL_SAMPLES:
            raise AssertionError(f"eval weight {totals['weight']} != "
                                 f"{EVAL_SAMPLES} samples")
        if not any(k.startswith("weight:") for k in totals):
            raise AssertionError("eval: the occ/noc split did not run")
        t = len(EVAL_FRAMES)
        want = {"fused_cost_base": 2 * t * EVAL_SAMPLES, "softsplat":
                (t - 1) * EVAL_SAMPLES}
        if {k: launches[k] for k in want} != want:
            raise AssertionError(f"eval launches {launches}, want {want}")
        by_name, events = profile(torch, 9, lambda: eval_step(tb), 1,
                                  "sample")
        by_kernel = {key: sum(n for name, (_, n) in by_name.items()
                              if kernel in name)
                     for key, kernel in (("fused_cost_base", COST_KERNEL),
                                         ("softsplat", SPLAT_KERNEL))}
        log(9, f"KITTI 2015 val v2s bf16 384x1248 B={b} T={t}, "
            f"{EVAL_SAMPLES} samples of 375x1242 PNGs (split written in "
            f"{written:.1f} s), {loader.num_workers} process workers (first "
            f"batch {ready[0] - t_start:.1f} s after the pool's start, "
            f"overlapping the tiny check and the model's build): loader "
            f"wait per batch ms "
            f"{[round(1e3 * w, 1) for w in waits]}, "
            f"eval step ms (synchronised) "
            f"{[round(1e3 * s, 1) for s in steps]}; one sample built on one "
            f"core {sample_ms:.1f} ms; PNG decode per 375x1242 RGB image "
            f"{up_ms:.1f} ms (Up rows) / {paeth_ms:.1f} ms (Paeth rows); "
            f"peak memory {peak:.2f} GiB, {peak - held:.2f} GiB above the "
            f"{held:.2f} GiB held before the loop (the model and what "
            f"earlier phases keep); launches {launches} on {card}")
        log(9, "eval metrics (mean over samples): " + ", ".join(
            f"{k} {sum(v) / len(v):.4g}" for k, v in sorted(totals.items())))
        log(9, f"torch.profiler, one eval step: {events} device events, "
            f"{COST_KERNEL} {by_kernel['fused_cost_base']}, {SPLAT_KERNEL} "
            f"{by_kernel['softsplat']} (expected {2 * t} and {t - 1}: two "
            f"cost bases a frame, one splat a frame after the first)")
        if by_kernel != {"fused_cost_base": 2 * t, "softsplat": t - 1}:
            raise AssertionError(f"eval profiler counts {by_kernel}")
        del model, eval_step, tb
        torch.cuda.empty_cache()

        test = ["DATA.TEST.DATA_ROOT", str(tmp / "kitti"),
                "DATA.TEST.ANNFILE", ann, "DATA.TEST.FRAME_IDXS",
                str(EVAL_FRAMES)]
        out_dir = tmp / "submission"
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "temporalstereo_tpu_torch.cli."
             "kitti_submission", "--config-file", KITTI, "--output-dir",
             str(out_dir), *test], cwd=repo, capture_output=True, text=True,
            timeout=600)
        wall = time.perf_counter() - t0
        if out.returncode != 0:
            raise AssertionError(f"kitti_submission failed:\n{out.stderr}")
        names = sorted(p.name for p in out_dir.iterdir())
        if names != [f"{i:06d}_10.png" for i in range(EVAL_SAMPLES)]:
            raise AssertionError(f"kitti_submission wrote {names}")
        for name in names:
            disp = read_png(str(out_dir / name))
            if disp.dtype != np.uint16 or disp.shape != (384, 1248):
                raise AssertionError(f"{name}: {disp.dtype} {disp.shape}")
        ms = [float(x) for x in re.findall(r": ([0-9.]+) ms", out.stdout)]
        p3 = re.findall(r"3PE=([0-9.]+)%", out.stdout)
        if len(ms) != EVAL_SAMPLES or len(p3) != EVAL_SAMPLES or \
                "average 3PE" not in out.stdout:
            raise AssertionError(f"kitti_submission printed {out.stdout}")
    log(9, f"kitti_submission 384x1248 T={t}: {len(names)} PNGs, 3PE "
        f"{p3} %, forward ms per sample {ms}, process wall {wall:.1f} s "
        f"on {card}")
    log(9, f"phase 9 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# the fit phase: the training entry point at full width
FIT_TRAIN_SAMPLES = 8           # 2 steps an epoch at the YAML's B=4
FIT_VAL_SAMPLES = 2
FIT_EPOCHS = 2
SANITY_STEPS = 150             # the JAX CLI's default is 1000


def _train_summary(text):
    """The JSON of the ``train summary:`` line a trainer's log ends with."""
    lines = [ln for ln in text.splitlines()
             if ln.startswith("train summary: ")]
    if not lines:
        raise AssertionError(f"no train summary in:\n{text[-4000:]}")
    return json.loads(lines[-1][len("train summary: "):])


def _fit_launches(t, steps, evals, forwards):
    """Launches of ``steps`` train steps, ``evals`` eval samples and
    ``forwards`` other no-gradient windows (SWA batches, image logs) of
    a T-frame window: two cost bases a frame, one splat a frame after the
    first, the cost base's backward twice a step."""
    windows = steps + evals + forwards
    return {"fused_cost_base": 2 * t * windows,
            "fused_cost_base_backward": 2 * steps, "shift_1d": 0,
            "shift_1d_backward": 0, "softsplat": (t - 1) * windows}


def _ms(summary, key):
    return [round(1e3 * x, 1) for x in summary.get(key, {}).get("all", [])]


def _leaves(tree):
    """The leaves of a nested dict / tuple / list, dict keys in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def phase_fit(torch, port, kernels, card):
    """Phase 10: python -m temporalstereo_tpu_torch.cli.train on
    configs/kitti2015-multi.yaml at full width (a subprocess: fit, then
    test); a resume from its checkpoints in this process (restored
    tensors bit-equal, the step and the SWA count carried on); one
    profiled trainer step; then cli.sanity_train.  -> the launch counts
    of the CLI's run and of the resumed fit."""
    import re
    import tempfile

    import numpy as np

    from temporalstereo_tpu_torch.data.synthetic import write_kitti2015_split
    from temporalstereo_tpu_torch.training.checkpoint import (
        CheckpointManager, save_weights)
    from temporalstereo_tpu_torch.training.trainer import Trainer, _host

    t_phase = time.perf_counter()
    repo = pathlib.Path(__file__).resolve().parent
    cfg0 = port.get_cfg(KITTI)
    t = len(cfg0.DATA.TRAIN.FRAME_IDXS)
    b = cfg0.DATA.TRAIN.BATCH_SIZE
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fit_") as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        train_ann = write_kitti2015_split(str(tmp / "train"),
                                          FIT_TRAIN_SAMPLES, EVAL_FRAMES)
        val_ann = write_kitti2015_split(str(tmp / "val"), FIT_VAL_SAMPLES,
                                        EVAL_FRAMES, seed=1)
        written = time.perf_counter() - t0
        weights = str(tmp / "seeded.pth")
        model = port.build_model(cfg0, seed=0)
        save_weights(weights, *port.master_copies(model))
        del model
        torch.cuda.empty_cache()
        opts = ["LOG_DIR", str(tmp / "exps"),
                "TRAINER.MAX_EPOCHS", str(FIT_EPOCHS),
                "TRAINER.CHECK_VAL_EVERY_N_EPOCHS", "1",
                "CHECKPOINT.EVERY_N_EPOCHS", "1",
                "TRAINER.SWA.START_FRACTION", "0.5",
                "TRAINER.LOAD_FROM_CHECKPOINT", weights,
                "TRAINER.FLUSH_LOGS_EVERY_N_STEPS", "1",
                "TRAINER.LOG_EVERY_N_STEPS", "1",
                "DATA.TRAIN.DATA_ROOT", str(tmp / "train"),
                "DATA.TRAIN.ANNFILE", train_ann]
        for phase in ("VAL", "TEST"):
            opts += [f"DATA.{phase}.DATA_ROOT", str(tmp / "val"),
                     f"DATA.{phase}.ANNFILE", val_ann]

        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "temporalstereo_tpu_torch.cli.train",
             "--config-file", KITTI, *opts], cwd=repo, capture_output=True,
            text=True, timeout=900)
        cli_wall = time.perf_counter() - t0
        (tmp / "fit.log").write_text(out.stdout + out.stderr)
        if out.returncode != 0:
            raise AssertionError(f"cli.train failed ({out.returncode}):\n"
                                 f"{out.stdout[-3000:]}\n{out.stderr[-6000:]}")
        cli = _train_summary(out.stdout)
        steps = FIT_EPOCHS * FIT_TRAIN_SAMPLES // b
        swa_batches = min(FIT_TRAIN_SAMPLES // b,
                          cfg0.TRAINER.SWA.BN_UPDATE_STEPS)
        want = _fit_launches(t, steps, (FIT_EPOCHS + 1) * FIT_VAL_SAMPLES,
                             swa_batches + FIT_EPOCHS + 1)
        if cli["launches"] != want:
            raise AssertionError(f"cli.train launches {cli['launches']} != "
                                 f"{want}")
        n_warm = re.findall(r"warm-started (\d+) tensors", out.stdout)
        val = re.findall(r"disparity_0/all +([-0-9. ]+)", out.stdout)
        if cli["step"] != steps or not n_warm or len(val) != FIT_EPOCHS + 1:
            raise AssertionError(f"cli.train: step {cli['step']}, warm "
                                 f"start {n_warm}, tables {val}")
        if not all(math.isfinite(float(x)) for row in val
                   for x in row.split()):
            raise AssertionError(f"cli.train: non-finite tables {val}")
        exp = tmp / "exps" / cfg0.TRAINER.NAME / cfg0.TRAINER.VERSION
        ckpt_dir = str(exp / "checkpoints")
        saved_steps = CheckpointManager(ckpt_dir).all_steps()
        if saved_steps != [steps // FIT_EPOCHS * (e + 1)
                           for e in range(FIT_EPOCHS)] or \
                not (exp / "weights_final.pth").exists():
            raise AssertionError(f"cli.train checkpoints {saved_steps}")
        bare = MEASURED["train_step_s"][1:]
        fit_steps = cli["step_s"]["all"]
        log(10, f"cli.train kitti2015-multi v2s bf16 B={b} "
            f"{cfg0.DATA.TRAIN.HEIGHT}x{cfg0.DATA.TRAIN.WIDTH} T={t}, "
            f"{FIT_TRAIN_SAMPLES} train + {FIT_VAL_SAMPLES} val samples "
            f"(split written in {written:.1f} s), {FIT_EPOCHS} epochs of "
            f"{steps // FIT_EPOCHS} steps, {cfg0.DATA.TRAIN.NUM_WORKERS} "
            f"process workers: warm start {n_warm[0]} tensors, SWA "
            f"{cli['swa_count']} snapshots, checkpoints {saved_steps}; "
            f"process wall {cli_wall:.1f} s on {card}")
        log(10, f"fit step ms (synchronised by the loss read-back) "
            f"{_ms(cli, 'step_s')} against phase 6's bare step ms "
            f"{[round(1e3 * x, 1) for x in bare]} (median ratio "
            f"{np.median(fit_steps[1:]) / np.median(bare):.3f} after the "
            f"first); loader wait per step ms {_ms(cli, 'loader_wait_s')}; "
            f"checkpoint save ms {_ms(cli, 'checkpoint_s')} of "
            f"{[round(x, 1) for x in cli['checkpoint_mb']['all']]} MB; SWA "
            f"finish ms {_ms(cli, 'swa_finish_s')}; val and test ms per "
            f"sample {_ms(cli, 'val_sample_s')}; peak memory "
            f"{cli['peak_gib']:.2f} GiB; launches {cli['launches']}")
        log(10, "val tables (disparity_0/all: 1px 2px 3px 5px epe): "
            + "; ".join(" ".join(row.split()) for row in val))

        # resume for one more epoch in this process; its SWA finish skips
        # the BatchNorm pass (one more loader epoch) that the CLI ran
        resume = port.get_cfg(KITTI, opts + [
            "TRAINER.MAX_EPOCHS", "1",
            "TRAINER.SWA.BN_UPDATE_STEPS", "0",
            "TRAINER.RESUME_FROM_CHECKPOINT", ckpt_dir])
        saved = CheckpointManager(ckpt_dir).read()
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = Trainer(resume)
        try:
            state = trainer.state
            pairs = [(saved[part], getattr(state, part))
                     for part in ("params", "batch_stats", "swa_params")]
            unequal = [k for a, r in pairs for k in a
                       if not torch.equal(a[k].cuda(), r[k])]
            opt_saved = _leaves(saved["opt_state"])
            opt_restored = _leaves(state.opt_state)
            if len(opt_saved) != len(opt_restored) or not opt_saved:
                raise AssertionError(f"resume: {len(opt_restored)} optimizer "
                                     f"leaves, {len(opt_saved)} saved")
            unequal += [f"opt_state leaf {i}" for i, (a, r) in enumerate(
                zip(opt_saved, opt_restored))
                if not (torch.equal(a.cuda(), r) if torch.is_tensor(a)
                        else a == r)]
            if unequal or state.step != saved["step"] or \
                    state.swa_count != saved["swa_count"]:
                raise AssertionError(f"resume: {len(unequal)} tensors "
                                     f"differ ({unequal[:3]}), step "
                                     f"{state.step} vs {saved['step']}")
            trainer.fit()
        finally:
            trainer.close()
        resume_wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        summary = trainer.summary()
        resumed_steps = FIT_TRAIN_SAMPLES // b
        if trainer.state.step != saved["step"] + resumed_steps:
            raise AssertionError(f"resume: step {trainer.state.step}")
        want = _fit_launches(t, resumed_steps, FIT_VAL_SAMPLES, 1)
        if launches != want:
            raise AssertionError(f"resumed fit launches {launches} != {want}")
        if trainer.state.swa_count != saved["swa_count"] + resumed_steps:
            raise AssertionError(
                f"resume: SWA count {trainer.state.swa_count}")
        log(10, f"resume from step {saved['step']}: {len(pairs[0][0])} "
            f"parameters, {len(pairs[1][0])} statistics, the SWA average "
            f"and the {len(opt_saved)} leaves of the optimizer state "
            f"bit-equal to the checkpoint; step "
            f"{trainer.state.step} and {trainer.state.swa_count} SWA "
            f"snapshots after one more epoch; step ms "
            f"{_ms(summary, 'step_s')}, loader wait ms "
            f"{_ms(summary, 'loader_wait_s')}, val ms per sample "
            f"{_ms(summary, 'val_sample_s')}; {resume_wall:.1f} s; "
            f"launches {launches}")

        # one trainer step (the step, the loss and metrics read-backs)
        # under the profiler, on a window of the flagship's shapes
        batch = train_batch(torch, t, b, cfg0.DATA.TRAIN.HEIGHT,
                            cfg0.DATA.TRAIN.WIDTH, "cuda")
        box = {"state": trainer.state}

        def trainer_step():
            box["state"], metrics = trainer.train_step(box["state"], batch)
            float(metrics["loss"])
            _host(metrics)
        trainer_step()
        by_name, events = profile(torch, 10, trainer_step, 1, "step")
        del trainer, box, batch
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m",
             "temporalstereo_tpu_torch.cli.sanity_train", "--steps",
             str(SANITY_STEPS)], cwd=repo, capture_output=True, text=True,
            timeout=600)
        sanity_wall = time.perf_counter() - t0
        if out.returncode != 0:
            raise AssertionError(f"sanity_train failed:\n{out.stderr[-6000:]}")
        before = re.findall(r"EPE before training: ([0-9.]+) px", out.stdout)
        after = re.findall(r"EPE after training: train-batch ([0-9.]+) px, "
                           r"held-out ([0-9.]+) px", out.stdout)
        rate = re.findall(r"steps in ([0-9.]+)s", out.stdout)
        # the CLI's own criterion: the train-batch EPE at least halved
        if not before or not after or "SANITY PASS" not in out.stdout or \
                not float(after[0][0]) < 0.5 * float(before[0]):
            raise AssertionError(f"sanity_train EPE did not halve:\n"
                                 f"{out.stdout[-3000:]}")
        log(10, f"sanity_train v2s bf16 256x512 B=4, 8 batches, "
            f"{SANITY_STEPS} steps in {rate[0]} s: EPE {before[0]} -> "
            f"{after[0][0]} px (held-out {after[0][1]} px); "
            f"{out.stdout.strip().splitlines()[-1]}; process wall "
            f"{sanity_wall:.1f} s")
    log(10, f"phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return cli["launches"], launches


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
    "softsplat": ("softsplat.cu", "temporalstereo_tpu/ops/pallas/splat.py:72",
                  "one temporal update of the flagship stream (softmax, "
                  "rigid flow)"),
}


def kernels_line(detail, launches_by_path):
    """One JSON line: per kernel its bf16 rows on uniform hypotheses summed
    over the stages (the splat's row of the stream's temporal update),
    launches summed over the main paths and listed by path; every row in
    ``detail``."""
    entries = []
    for name, (src, replaces, per) in KERNEL_SOURCES.items():
        rows = ([r for r in detail[name] if r.get("main")]
                or [r for r in detail[name] if r["dtype"] == "bfloat16"
                    and r.get("case", "uniform") == "uniform"])
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
    phase_splat(torch, kernels, detail)
    phase_train_kernels(torch, kernels, detail)
    phase_card_vs_cpu(torch, port)
    phase_train_card_vs_cpu(torch, port)
    launches = {"stream": phase_flagship(torch, port, kernels, card)}
    launches["train"] = phase_flagship_train(torch, port, kernels, card)
    launches["train_block_cost_scale_0"] = phase_no_pyramid_train(
        torch, port, kernels)
    launches["stream_graphs"] = phase_serving(torch, port, kernels, card)
    phase_cli(torch, port, card)
    phase_bench(card)
    launches["eval"] = phase_eval(torch, port, kernels, card)
    launches["fit"], launches["fit_resume"] = phase_fit(torch, port,
                                                        kernels, card)
    print(kernels_line(detail, launches), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
