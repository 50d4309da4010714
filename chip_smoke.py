#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure ends the script with a
non-zero exit code and no result line:
  1. environment: torch / CUDA versions, card name and power limit;
  2. build: every hand-written kernel, compiled with nvcc from the checkout,
     and the native data library with g++ (the zstd decoder in phase 20);
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
     the splat's gradient: the forward's kept normaliser against its
     plain version (the output bit-equal with and without it), the
     backward kernel (the whole vjp, one launch) against its plain
     version, and the whole softsplat's backward (autograd through the
     kernel; torch.profiler finds the backward kernel alone on the card)
     against autograd of the plain version, in all four modes, at the
     splat's two shapes and three flows, each twice and bit-identical,
     as accurate against the plain version in f64 as the plain f32 one
     (SPLAT_BWD_TOL); then ops.softsplat differentiated from zeroed
     counts (one forward and one backward launch);
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
     stage marks of the flagship bundle at B=1 and B=8: each steady
     replay's segments from the marks' ring against the same segments
     between the mark kernels in a torch.profiler trace (within
     max(3%, 0.02 ms)), and the stream time the marks hold a replay;
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
     320x1184, 8 thread workers; validation at 384x1248, B=1) on
     3-frame windows (SHORT_WINDOW: each loader worker builds a whole
     batch first) of a synthetic KITTI 2015 split of 8 train and 2 val
     samples: one epoch of 2 steps (cut from 2 epochs to keep the script
     inside its limit) with validation and a checkpoint, SWA from
     half-way with its BatchNorm re-estimate, a warm start from a .pth of
     the seeded model, then test(); exact launch counts, checkpoints and finite
     tables; the fit's step time against phase 6's, loader wait, checkpoint
     time and size, SWA finish, eval time per sample, peak memory; a resume
     from its checkpoints in this process for one more epoch (every restored
     tensor bit-equal to the file, the step and the SWA count carried on); one
     trainer step under torch.profiler; then
     temporalstereo_tpu_torch.cli.sanity_train (v2s, bf16, 256x512, B=4, 130
     steps), whose train-batch EPE must at least halve;
 11. the demo: python -m temporalstereo_tpu_torch.cli.demo (run in this
     process) with configs/kitti2015-multi.yaml at 384x1248 over a
     synthetic KITTI 2015 split of two 11-frame samples: a panel PNG a
     sample of the expected shape, finite EPE and 3PE, exact launch
     counts;
 12. the tools: cli.benchmark_ops at KITTI sizes (its JSON line: device
     time per op beside the reference's own figures, labelled with the
     reference's hardware) and cli.profile_step --temporal --train (its
     top kernels, the scopes and the device busy share; 2 steps, not its
     default 6), each in its own process, with the launches they print;
 13. TPU.REMAT: the kitti2015-multi BPTT step (MODEL.PREVIOUS_WITH_GRADIENT,
     v2s, bf16, B=4, 320x1184) at T=3 with and without REMAT from the
     same weights and batch (the same loss; gradients within the stated
     bf16 tolerance of each other, beside two plain runs' own spread;
     BatchNorm statistics equal; step time and peak memory of both), then
     at T=11 with REMAT only (step time, peak memory);
 14. the planner: serving.measure_latency_table of the flagship bundle
     (v2s, bf16, 384x1248) for 1, 2, 4 and 8 streams and chunks of 1, 2
     and 8 frames, its LatencyModel fit, then python -m
     temporalstereo_tpu_torch.cli.video_inference --target-fps 30
     --streams 4 against that table with --export-bundle (the operating
     point it prints equal to select_operating_point's, and recorded in
     the bundle's meta);
 15. the norm variants: kitti2015-multi (v2s, bf16) with GroupNorm in
     the FPN and the three stages beside the same model with BatchNorm,
     in this run: a 12-frame eager stream at 384x1248 (per-frame ms,
     launches), the same served as CUDA graphs with BatchNorm folded and
     GroupNorm left in the forward (replayed ms a frame, against eager),
     two training steps at B=4, 320x1184, T=11 (step ms, peak memory,
     beside phase 6's); the tiny f32 model with GN, IN, LN and FrozenBN,
     card against CPU (2e-3 on the first frame, 5e-3 streamed); a
     FrozenBN training step whose frozen statistics stay bit-unchanged;
 16. the surface off the main path: inverse_warp_3d without a y shift
     (the shift kernel, held against the plain shift at phase 3's
     tolerance) and summation_splat (the softsplat kernel), counted; the
     4-tap warp, soft and hard argmin, max_pool3d, upsample_disp, SPP3D,
     ConvGRU, StereoDRNetRefinement, ResidualBlock2D (GN) and BasicBlock
     card against CPU at small shapes;
 17. the native data library: its g++ build (phase 2), a 375x1242 RGB
     Paeth PNG decoded natively and in numpy (bit-equal, ms each), one
     KITTI 2015 val sample built on one core each way, and phase 9's val
     loader (2 process workers, native) with make_eval_step over 6
     samples of Paeth PNGs: wait and step per sample, the step's share of
     the loop once the batches the pool held ahead are consumed;
 18. data parallelism (torch.distributed ranks; every kernel is built
     in phase 2, before a rank starts): (a) two gloo ranks sharing the card
     (NCCL refuses two ranks on one device; gloo reduces CUDA tensors
     through the host), the tiny f32 model with TF32 off, one training
     step (T=3, global B=2, a sample a rank) and one eval step of 3
     samples with a padded duplicate, against one process at B=2 (losses,
     grad_norm, gradients, parameters, BatchNorm statistics, eval metrics
     and weight, within DP_TOL; the ranks bit-equal); (b) two gloo ranks at
     full width (kitti2015-multi, v2s, bf16, 320x1184, T=11, global B=4),
     each sample's images scaled by its own factor, one step: the stem
     BatchNorm's running statistics against one process at B=4 (within
     DP_STEM_TOL), finite, the ranks bit-equal; the first step's loss
     terms and every statistic reported beside one process's own spread
     (the same step again, and with its samples reordered); each rank's
     step ms, peak memory and the gradient bucket's all-reduce alone
     (gloo through the host); (c) python -m
     temporalstereo_tpu_torch.cli.train --multihost at world size 1 under
     NCCL (kitti2015-multi, FAST_DEV_RUN, 3-frame windows of a synthetic
     KITTI 2015 split, thread workers:
     finite tables, one checkpoint, exact launches), then in this process
     the mesh's step against the plain one over 2 steps (the first step's
     loss terms gated at DP_NCCL_TOL, bit-equality reported; the second
     reported beside the plain step against itself), step ms of both and
     phase 6's, the collective kernels of one profiled step (none) and the
     gradient bucket all-reduced alone through NCCL (device time and CUDA
     events);
 19. W-axis spatial sharding (parallel/spatial.py; the ranks start after
     phase 2 has built every kernel): (a) two gloo ranks sharing the card,
     the tiny f32 model with TF32 off, its single-frame eval forward
     sharded along W with even (W = 256: 128 + 128) and uneven (W = 224:
     128 + 96) shards, each rank's slice against the unsharded forward on
     the card (SP_TINY_TOL, the JAX test's 1e-4); (b)
     configs/kitti2015.yaml (v2s, 384x1248, B=1, seeded random weights)
     on two gloo ranks of 640 + 608 columns: in f32 with TF32 off, each of
     the four disparities against the unsharded forward (max |d|, the
     share of pixels within 1e-2 px, the pixels past 1 px, and the shares
     in the band of SP_SEAM columns about the seam and outside it), beside
     the floor, one process with cuDNN off against itself with it on;
     gated on the coarsest's share, on every level against the floor, on
     the seam band against outside and the floor, and on the finest's
     pixels past 1 px; the seam gate must fail a column planted 1 px off;
     then in bf16, each rank's frame ms and peak memory beside one
     process's, the exchanges a frame and the cost base's launches a
     rank; (c) a spatial size of 1 under NCCL: bit-equal to the plain
     forward, with no collective kernel in its trace;
 20. the JAX package's orbax checkpoints read without orbax, tensorstore,
     JAX or a zstd module: the zstd decoder's g++ build, then the
     committed fixture tests/data/orbax_fixture read by utils/orbax.py,
     every leaf bit-equal to scripts/make_orbax_fixture.py's numpy
     regeneration from its seed;
 21. every phase's seconds, the script's, one JSON line listing every
     kernel (with its launches on each path), then the result line.
Phase 3 also holds the cost base and the shift at a column offset (a
shard's columns against the whole target, as the sharded forward calls
them) against their plain versions, and bit-equal to the slice of the
full-width call (the shift beside F.grid_sample on the same columns), and
the shift forward's other launch plans against the plain shift: a row too
wide for one block's shared memory (channel slices), a non-broadcast img
(Di = D), C = 12 (one channel a thread), integer shifts and shifts all out
of range.
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


def full_device_events(fn, iters=20, tries=5):
    """``_device_events`` of ``iters`` calls: the trace with the most events
    of up to ``tries`` (the profiler now and then drops records; a trace of
    ``iters`` events or more ends the tries)."""
    best = []
    for _ in range(tries):
        events = _device_events(fn, iters)
        if len(events) > len(best):
            best = events
        if len(best) >= iters:
            break
    return best


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
    tol_text = (tol if isinstance(tol, str)
                else f"{tol[0]:g}*|p| + {tol[1]:g}*max|p|")
    log(3, f"{name} {row['stage']}"
        + (f" {row['case']}" if "case" in row else "")
        + f" {row['dtype']} {row['shape']}: max|d| "
        f"{row['max_abs_err']:.3g} (tol {tol_text})"
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


def _grid_sample_yardstick(torch, img, shift, x0=0):
    """F.grid_sample computing the shift on the same data (img [B,1,H,Wt,C]
    read as [B,C,H,Wt], the D hypotheses as D*H output rows, align_corners
    so that pixel x is x; shift's column x is img's column x0 + x):
    (forward closure, backward closure)."""
    import torch.nn.functional as F

    b, d, h, w = shift.shape
    wt = img.shape[3]
    img_nchw = img[:, 0].permute(0, 3, 1, 2).contiguous()
    xs = torch.arange(x0, x0 + w, device=img.device).view(1, 1, 1, w) + shift
    ys = torch.arange(h, device=img.device, dtype=torch.float32).view(
        1, 1, h, 1).expand(b, d, h, w)
    grid = torch.stack([2 * xs / (wt - 1) - 1, 2 * ys / (h - 1) - 1], -1)
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


def phase_offset_kernels(torch, kernels, detail):
    """Phase 3, the W-sharded forward's calls: the cost base and the shift
    of rank 1 of 2 (the frame's columns from x0, 608 of 1248) against the
    whole target, bf16 and f32: against the plain version's offset form
    and bit-equal to the slice of the full-width call; offset 0 bit-equal
    to the default call."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    for stage, (h, w, c, d) in (("fine", (48, 156, 128, 8)),
                                ("precise", (96, 312, 128, 5))):
        x0 = w * 640 // 1248
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            size = torch.empty((), dtype=dtype).element_size()
            ref = torch.randn((1, h, w, c), generator=g, device=dev).to(dtype)
            tgt = torch.randn((1, h, w, c), generator=g, device=dev).to(dtype)
            disp = (torch.rand((1, d, h, w), generator=g, device=dev)
                    * (w + 8.0) - 4.0)
            part = (ref[:, :, x0:].contiguous(), tgt,
                    disp[..., x0:].contiguous())
            wr = w - x0
            full = kernels.fused_cost_base(ref, tgt, disp)
            out = kernels.fused_cost_base(*part, x0, 0)
            plain = kernels.fused_cost_base_plain(*part, x0, 0)
            same = (torch.equal(out, full[:, :, :, x0:]) and torch.equal(
                kernels.fused_cost_base(ref, tgt, disp, 0, 0), full))
            torch.cuda.synchronize()
            err, ok = close(out, plain, *COST_TOL[dname])
            if not (ok and same):
                raise AssertionError(f"fused_cost_base offset {stage} {dname}"
                                     f": plain {ok}, full-width slice {same}")
            row = _row(stage, [1, d, h, wr, c], dname, err,
                       cuda_ms(lambda: kernels.fused_cost_base(*part, x0, 0)),
                       cuda_ms(lambda: kernels.fused_cost_base_plain(
                           *part, x0, 0), 10), None,
                       h * wr * c * size + h * w * c * size + d * h * wr * 4
                       + d * h * wr * (2 * c + c // 8) * size,
                       dev_ms=device_ms(lambda: kernels.fused_cost_base(
                           *part, x0, 0), "fused_cost_base_kernel"),
                       case=f"offset x0={x0} of {w}, target {w} wide")
            detail["fused_cost_base"].append(row)
            _log_row("fused_cost_base", row, COST_TOL[dname])
            img = tgt[:, None].contiguous()
            shift = -part[2]
            full = kernels.shift_1d(img, -disp)
            out = kernels.shift_1d(img, shift, x0, 0)
            plain = kernels.shift_1d_plain(img, shift, x0, 0)
            same = torch.equal(out, full[:, :, :, x0:])
            torch.cuda.synchronize()
            err, ok = close(out, plain, *COST_TOL[dname])
            if not (ok and same):
                raise AssertionError(f"shift_1d offset {stage} {dname}: "
                                     f"plain {ok}, full-width slice {same}")
            lib_fwd, _ = _grid_sample_yardstick(torch, img, shift, x0)
            row = _row(stage, [1, d, h, wr, c], dname, err,
                       cuda_ms(lambda: kernels.shift_1d(img, shift, x0, 0)),
                       cuda_ms(lambda: kernels.shift_1d_plain(
                           img, shift, x0, 0), 10), cuda_ms(lib_fwd),
                       h * w * c * size + d * h * wr * 4
                       + d * h * wr * c * size,
                       dev_ms=device_ms(lambda: kernels.shift_1d(
                           img, shift, x0, 0), "shift_1d_forward_kernel"),
                       case=f"offset x0={x0} of {w}, img {w} wide")
            detail.setdefault("shift_1d", []).append(row)
            _log_row("shift_1d", row, COST_TOL[dname])
            del ref, tgt, disp, part, full, out, plain, img, shift, lib_fwd
    torch.cuda.empty_cache()


# (case, (B, Di, H, W, C, D)) of the shift forward's other launch plans
SHIFT_CASES = (("wide row", (1, 1, 8, 1248, 128, 5)),
               ("img not broadcast", (2, 5, 16, 148, 128, 5)),
               ("C=12", (2, 1, 16, 148, 12, 8)),
               ("C=12, img not broadcast", (2, 8, 16, 148, 12, 8)))


def phase_shift_cases(torch, kernels, detail):
    """Phase 3, the shift forward's other launch plans against the plain
    shift, bf16 and f32: a row too wide for one block (channel slices), a
    non-broadcast img, C = 12 (one channel a thread); hypotheses over the
    row and past both edges, integer ones, and ones all out of range (the
    output exactly 0)."""
    from temporalstereo_tpu_torch.kernels.launches import shift_forward_plan

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(23)
    for case, (b, di, h, w, c, d) in SHIFT_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            img = torch.randn((b, di, h, w, c), generator=g,
                              device=dev).to(dtype)
            disp = (torch.rand((b, d, h, w), generator=g, device=dev)
                    * (w + 8.0) - 4.0)
            far = w + 2.0 + torch.rand((b, d, h, w), generator=g,
                                       device=dev) * w
            side = torch.rand((b, d, h, w), generator=g, device=dev) < 0.5
            plan = shift_forward_plan(w, w, c, d if di == 1 else 1,
                                      img.element_size(), b * di * h)
            for kind, shift in (("uniform", -disp),
                                ("integer", -torch.round(disp)),
                                ("out of range", torch.where(side, -far,
                                                             far))):
                out = kernels.shift_1d(img, shift)
                plain = kernels.shift_1d_plain(img, shift)
                torch.cuda.synchronize()
                err, ok = close(out, plain, *COST_TOL[dname])
                if kind == "out of range":
                    ok = ok and not bool(out.any())
                detail["shift_1d"].append({
                    "stage": "plan", "case": f"{case}, {kind}",
                    "shape": [b, d, h, w, c], "img": [b, di, h, w, c],
                    "dtype": dname, "plan": list(plan), "max_abs_err": err})
                log(3, f"shift_1d plan {case}, {kind} {dname} img "
                    f"[{b},{di},{h},{w},{c}] x D={d}: plan (slices, "
                    f"hypotheses a block, shared bytes) {plan}, max|d| "
                    f"{err:.3g} (tol {COST_TOL[dname][0]:g}*|p| + "
                    f"{COST_TOL[dname][1]:g}*max|p|)")
                if not ok:
                    raise AssertionError(f"shift_1d {case}, {kind} {dname} "
                                         "disagrees with its plain version")
            del img, disp, far, side, out, plain
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
    flows; each row twice, the two bit-identical.  A softmax row also times
    the launch that keeps the normaliser (as a forward under autograd
    does)."""
    from temporalstereo_tpu_torch.kernels.splat import _launch

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
                if mode != "summation":
                    def kept(x=inputs, f=flow, m=metric, mode=mode):
                        return _launch(x, f, m, mode, 1e-22, keep_norm=True)
                    row["keep_norm_ms"] = cuda_ms(kept)
                    row["keep_norm_device_ms"] = device_ms(kept,
                                                           SPLAT_KERNEL)
                detail["softsplat"].append(row)
                _log_row("softsplat", row, SPLAT_TOL)
                if mode != "summation":
                    log(3, f"  keeping the normaliser: kernel "
                        f"{row['keep_norm_ms']:.4f} ms, device "
                        f"{fmt_ms(row['keep_norm_device_ms'])}")
                if not ok:
                    raise AssertionError(f"softsplat {path} {mode} {case} "
                                         "disagrees with its plain version")
                if not same:
                    raise AssertionError(f"softsplat {path} {mode} {case}: "
                                         f"two runs differ by {spread:.3g}")


# the splat's gradient, kernel against plain: the kernel's gradient (the
# backward kernel alone, and the whole softsplat's backward through
# autograd) may be no further from the plain version's in f64 than twice
# the plain version's own f32 gradient is, plus 1e-6 of the largest f64
# value.  The f32 flow gradient cancels terms (the taps' weights change in
# opposite directions), so f32 alone sits far from f64 in some rows; the
# kernel forms every product and quotient as the plain version does and
# only the sums over channels run in another order
SPLAT_BWD_TOL = (2.0, 1e-6)


def _splat_grad_leaves(torch, mode, inputs, flow, metric):
    """The leaves of one gradient row: summation splats the softmax mode's
    weighted values [inputs e^m, e^m]; linear weighs by |m| + 1 (linear
    weights are positive importances); average takes no metric."""
    if mode == "summation":
        return torch.cat([inputs * metric.exp(), metric.exp()], -1), flow, \
            None
    if mode == "linear":
        return inputs, flow, metric.abs() + 1
    return inputs, flow, None if mode == "average" else metric


def _softsplat_f64(inputs, flow, metric, mode, eps=1e-22):
    """softsplat_plain's arithmetic in f64 (softsplat_plain takes f32)."""
    from temporalstereo_tpu_torch.kernels.splat import (_summation_plain,
                                                        _weighted)

    out = _summation_plain(_weighted(inputs, metric, mode), flow)
    return out if mode == "summation" else out[..., :-1] / (out[..., -1:]
                                                            + eps)


def _as_accurate(kernel, plain, ref, floor):
    """(max |kernel - plain|, its largest share of max|plain| over the
    tensors, ok): ok if each kernel tensor is within SPLAT_BWD_TOL of
    ``ref`` (the plain version in f64)."""
    worst, rel, ok = 0.0, 0.0, True
    for k, p, r in zip(kernel, plain, ref):
        r = r.double()
        own = float((p.double() - r).abs().max())
        err = float((k.double() - r).abs().max())
        ok &= err <= SPLAT_BWD_TOL[0] * own + floor * float(r.abs().max())
        gap = float((k.double() - p.double()).abs().max())
        worst = max(worst, gap)
        rel = max(rel, gap / max(float(p.abs().max()), 1e-30))
    return worst, rel, ok


def _f64(t):
    return None if t is None else t.double()


def phase_splat_backward(torch, kernels, detail):
    """Phase 3, the splat's gradient, in all four modes, at the stream's and
    the training step's shapes, on the forward phase's three flows:
      the forward kernel's kept normaliser against its plain version, its
        output bit-equal with and without it;
      the backward kernel (csrc/softsplat_backward.cu, the whole vjp in one
        launch) against softsplat_vjp_plain on the same output and
        normaliser (the plain forward's);
      the whole softsplat's backward through autograd (kernels.softsplat)
        against autograd of softsplat_plain, its device events counted by
        torch.profiler: exactly one, the backward kernel;
    both as accurate against the f64 plain version as the f32 plain one,
    each twice, the two bit-identical.  Then ops.softsplat differentiated
    once at the training shape from zeroed counts -> those launches."""
    from temporalstereo_tpu_torch.kernels.splat import _launch
    from temporalstereo_tpu_torch.ops import softsplat as ops_softsplat

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(14)
    detail["softsplat_backward"] = []
    for path, (b, h, w) in SPLAT_SHAPES:
        for case in ("uniform", "rigid", "one_target"):
            base = splat_inputs(torch, case, b, h, w, g, dev)
            for mode in ("summation", "average", "linear", "softmax"):
                leaves = _splat_grad_leaves(torch, mode, *base)
                x, flow, metric = leaves
                c = x.shape[-1]
                weighted = mode != "summation"
                g_out = torch.randn(x.shape, generator=g, device=dev)
                out_p, norm_p = kernels.softsplat_plain(x, flow, metric, mode,
                                                        keep_norm=True)
                norm_err = None
                if weighted:
                    out_k, norm_k = _launch(x, flow, metric, mode, 1e-22,
                                            keep_norm=True)
                    same_out = torch.equal(
                        out_k, _launch(x, flow, metric, mode, 1e-22))
                    norm_err, norm_ok = close(norm_k, norm_p, *SPLAT_TOL)
                    if not (norm_ok and same_out):
                        raise AssertionError(
                            f"softsplat {path} {mode} {case}: the kept "
                            f"normaliser is {norm_err:.3g} from its plain "
                            f"version, the output with it bit-equal "
                            f"{same_out}")

                def bare(x=x, f=flow, m=metric, o=out_p, gv=g_out, mode=mode,
                         n=norm_p):
                    return [t for t in kernels.softsplat_vjp(
                        x, f, m, o, gv, mode, norm=n) if t is not None]
                first, second = bare(), bare()
                plain = [t for t in kernels.softsplat_vjp_plain(
                    x, flow, metric, out_p, g_out, mode, norm=norm_p)
                    if t is not None]
                out_r = _softsplat_f64(_f64(x), _f64(flow), _f64(metric),
                                       mode)
                ref = [t for t in kernels.softsplat_vjp_plain(
                    _f64(x), _f64(flow), _f64(metric), out_r,
                    g_out.double(), mode) if t is not None]
                torch.cuda.synchronize()
                err, rel, ok = _as_accurate(first, plain, ref,
                                            SPLAT_BWD_TOL[1])
                spread = _spread(first, second)
                same = all(torch.equal(a, b_) for a, b_ in zip(first, second))

                used = [t for t in leaves if t is not None]
                grads_k, backward_k = _autograd(
                    torch, lambda *a: kernels.softsplat(
                        *a[:2], a[2] if len(a) == 3 else None, mode),
                    used, g_out)
                again = backward_k()
                grads_p, backward_p = _autograd(
                    torch, lambda *a: kernels.softsplat_plain(
                        *a[:2], a[2] if len(a) == 3 else None, mode),
                    used, g_out)
                grads_r, _ = _autograd(
                    torch, lambda *a: _softsplat_f64(
                        *a[:2], a[2] if len(a) == 3 else None, mode),
                    [t.double() for t in used], g_out.double())
                torch.cuda.synchronize()
                err_vjp, rel_vjp, ok_vjp = _as_accurate(
                    grads_k, grads_p, grads_r, SPLAT_BWD_TOL[1])
                same_vjp = all(torch.equal(a, b_)
                               for a, b_ in zip(grads_k, again))
                # every device event of 20 backwards through autograd
                events = full_device_events(backward_k, 20)
                names = sorted({e.name for e in events})
                one_launch = (len(events) == 20 and len(names) == 1
                              and "softsplat_backward" in names[0])
                dev_ms = (sum(e.time_range.elapsed_us() for e in events)
                          / 20 / 1e3 if one_launch else None)

                ms, lo, hi = cuda_ms_spread(bare)
                nbytes = b * h * w * 4 * (
                    2 * c + 2 + (metric is not None)                # in, g
                    + (c + 1 if weighted else 0)                    # out, n
                    + c + 2 + (metric is not None))                 # grads
                row = _row(path, [b, h, w, c + weighted], "float32", err, ms,
                           cuda_ms(lambda: kernels.softsplat_vjp_plain(
                               x, flow, metric, out_p, g_out, mode,
                               norm=norm_p), 10),
                           None, nbytes, spread, dev_ms, f"{mode} {case}",
                           (lo, hi))
                row.update(max_rel_err=rel, softsplat_vjp_max_abs_err=err_vjp,
                           softsplat_vjp_max_rel_err=rel_vjp,
                           softsplat_vjp_ms=cuda_ms(backward_k, 20),
                           softsplat_vjp_plain_ms=cuda_ms(backward_p, 10),
                           device_events_per_backward=len(events) / 20,
                           norm_max_abs_err=norm_err,
                           main=(path, mode, case) == ("train", "softmax",
                                                       "rigid"))
                detail["softsplat_backward"].append(row)
                _log_row("softsplat_backward", row,
                         f"|k - f64| <= {SPLAT_BWD_TOL[0]:g}*|plain - f64| "
                         f"+ {SPLAT_BWD_TOL[1]:g}*max|f64|")
                norm_text = ("none" if norm_err is None
                             else f"{norm_err:.3g}")
                log(3, f"  max|d| / max|plain| {rel:.3g}; kept normaliser "
                    f"max|d| {norm_text}; "
                    f"backward through autograd: max|d| {err_vjp:.3g} "
                    f"({rel_vjp:.3g} of max|plain|) against autograd of the "
                    f"plain version, wall {row['softsplat_vjp_ms']:.4f} ms "
                    f"a call (CUDA events around 20; plain "
                    f"{row['softsplat_vjp_plain_ms']:.4f} ms), device "
                    f"events a backward {len(events) / 20:g} {names}")
                if not (ok and ok_vjp):
                    raise AssertionError(
                        f"softsplat_backward {path} {mode} {case} is less "
                        f"accurate than its plain version ({err:.3g}, "
                        f"{err_vjp:.3g})")
                if not (same and same_vjp):
                    raise AssertionError(
                        f"softsplat_backward {path} {mode} {case}: two runs "
                        "differ")
                if not one_launch:
                    raise AssertionError(
                        f"softsplat {path} {mode} {case}: a backward through "
                        f"autograd put {len(events) / 20:g} device events a "
                        f"call on the card ({names}), want the backward "
                        "kernel alone")

    b, h, w = dict(SPLAT_SHAPES)["train"]
    leaves = [t.detach().requires_grad_() for t in splat_inputs(
        torch, "rigid", b, h, w, g, dev)]
    g_out = torch.randn(leaves[0].shape, generator=g, device=dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    torch.autograd.backward(ops_softsplat(*leaves, mode="softmax"), g_out)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    want = {name: 0 for name in launches}
    want.update(softsplat=1, softsplat_backward=1)
    log(3, f"ops.softsplat softmax differentiated at {[b, h, w]}: launches "
        f"{launches}; gradients finite "
        f"{all(bool(torch.isfinite(t.grad).all()) for t in leaves)}")
    if launches != want or not all(bool(torch.isfinite(t.grad).all())
                                   for t in leaves):
        raise AssertionError(f"ops.softsplat's gradient launched {launches},"
                             f" want {want}")
    return launches


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
            "softsplat": frames - 1, "softsplat_backward": 0}
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
            "shift_1d_backward": 0, "softsplat": (t - 1) * steps,
            "softsplat_backward": 0}
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
    MEASURED["train_peak_gib"] = peak
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
            "softsplat": t - 1, "softsplat_backward": 0}
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


def kernel_counts(torch, fn, tries=3):
    """(events, {kernel: launches}) that one call of ``fn`` puts on the
    card, by torch.profiler; the two kernels of the stream by name.  The
    profiler now and then drops records of a graph replay (the same
    replay traced again shows more events), so the trace with the most
    events of ``tries`` counts."""
    events = max((_device_events(fn, 1) for _ in range(tries)), key=len)
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
            kernels.reset_launches()
            bundle.reset()
            second.clear()
            for left, right in pairs:
                second.append(bundle.step(left, right, K, bl, T))
        _, per_run = kernel_counts(torch, replay_all)
        replayed = dict(kernels.LAUNCHES)
        if not all(torch.equal(a, b) for a, b in zip(outs, second)):
            raise AssertionError(f"serving {label}: two replays differ")
        want = {"fused_cost_base": 2 * frames, "softsplat": frames - 1}
        if per_run != want:
            raise AssertionError(f"serving {label}: the replayed stream ran "
                                 f"{per_run}, not {want}")
        if replayed != {**{name: 0 for name in replayed}, **per_run}:
            raise AssertionError(f"serving {label}: LAUNCHES counted "
                                 f"{replayed} for replays that ran {per_run}")
        steady_events, steady = kernel_counts(
            torch, lambda: bundle.step(*pairs[0], K, bl, T))
        if steady != {"fused_cost_base": 2, "softsplat": 1}:
            raise AssertionError(f"serving {label}: a steady replay ran "
                                 f"{steady} in {steady_events} events")
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
            launches = replayed
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


MARK_KERNEL = "trace_mark_kernel"
MARK_TOL = (0.03, 0.02)         # ring against profiler: share, floor in ms


def _traced_marks(events, points, replays):
    """Each replay's marks (device events, in order) in a trace, or None
    where the profiler lost some."""
    events = sorted(events, key=lambda e: e.time_range.start)
    marks = [e for e in events if MARK_KERNEL in e.name]
    if len(marks) != points * replays:
        return None
    return [marks[i * points:(i + 1) * points] for i in range(replays)]


def _held_us(events, mark):
    """The stream time a mark holds: from the end of the device operation
    before it to the start of the one after it."""
    i = events.index(mark)
    return events[i + 1].time_range.start - events[i - 1].time_range.end


def phase_marks(torch, port, card, replays=10, tries=3):
    """The stage marks of the flagship bundle (tracing.py) at B=1 and B=8:
    ``replays`` steady replays under torch.profiler; each replay's
    segments from the marks' ring against the same segments between the
    mark kernels' starts in the trace, within max(3%, 0.02 ms); the marks'
    own device time and the stream time the inner ones hold (from the
    device operation before each to the one after it: an upper bound of
    their cost); stats() of the bundle."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from temporalstereo_tpu_torch import serving

    h, w = 384, 1248
    model = serving_model(torch, port, port.get_cfg(opts=FLAGSHIP))
    for b in (1, 8):
        bundle = serving.StreamingBundle(serving.bundle_meta(model, b, h, w),
                                         model, progress=lambda msg: None)
        g = torch.Generator(device="cuda").manual_seed(30 + b)
        left, right = (torch.rand((b, h, w, 3), generator=g, device="cuda")
                       for _ in range(2))
        K, bl, T = (x.expand(b, *x.shape[1:]).contiguous()
                    for x in _geometry(torch, h, w, "cuda"))
        for _ in range(len(bundle.meta["stages"]) + 2):
            bundle.step(left, right, K, bl, T)
        marks = bundle.records.marks["steady"]
        points = len(marks.points)
        for _ in range(tries):
            torch.cuda.synchronize()
            with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(replays):
                    bundle.step(left, right, K, bl, T)
                torch.cuda.synchronize()
            events = sorted((e for e in prof.events() if e.device_type
                             == torch.autograd.DeviceType.CUDA),
                            key=lambda e: e.time_range.start)
            traced = _traced_marks(events, points, replays)
            if traced is not None:
                break
        if traced is None:
            raise AssertionError(f"marks B={b}: the profiler lost mark "
                                 f"kernels in {tries} traces")
        ring = marks.segment_ms(replays)
        worst, rows = 0.0, {}
        for i, seg in enumerate(marks.segments):
            for r, row in enumerate(traced):
                prof_ms = (row[i + 1].time_range.start
                           - row[i].time_range.start) / 1e3
                gap = abs(float(ring[seg][r]) - prof_ms)
                if gap > max(MARK_TOL[0] * prof_ms, MARK_TOL[1]):
                    raise AssertionError(
                        f"marks B={b} replay {r} {seg}: ring "
                        f"{float(ring[seg][r]):.4f} ms, profiler "
                        f"{prof_ms:.4f} ms")
                worst = max(worst, gap)
            rows[seg] = round(float(sorted(ring[seg])[replays // 2]), 4)
        marked = sorted(sum(float(ring[s][r]) for s in marks.segments)
                        for r in range(replays))[replays // 2]
        own = sum(e.time_range.elapsed_us() for row in traced
                  for e in row) / replays
        held = sum(_held_us(events, e) for row in traced
                   for e in row[1:-1]) / replays
        stats = bundle.stats(replays)
        log(8, f"marks B={b}: {replays} steady replays, ring against "
            f"profiler worst {worst * 1e3:.2f} us (limit max(3%, 20 us)); "
            f"segment medians ms {rows}, marked replay {marked:.3f} ms; "
            f"{points} marks a replay: own device time {own:.2f} us, the "
            f"{points - 2} inner ones hold {held:.2f} us of the stream "
            f"({100 * held / 1e3 / marked:.3f}% of the replay); host ms "
            f"{stats['host_ms']}, replays {stats['replays']} on {card}")
        del bundle
    del model
    torch.cuda.empty_cache()


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


def eval_metrics_close(card_m, cpu_m, card_d, cpu_d, gt, gt_right):
    """Card against CPU on one sample: each EPE within the largest
    disparity difference phase 4's tolerance allows (CARD_VS_CPU_TOL of
    the mean CPU disparity), each outlier percentage within the pixels of
    its own split (all, occ or noc, the split's count its denominator)
    whose CPU error lies that close to its threshold (a percentage is a
    step function); -> the worst max|d| / mean|cpu| of the disparities.
    The split is the metric's own (do_occlusion_evaluation), here from
    the CPU's ground truth: its |warp - gt| lies a whole pixel from the
    threshold, so the card's split is the same."""
    from temporalstereo_tpu_torch.ops import inverse_warp

    assert gt.shape[0] == 1, gt.shape
    valid = (gt > 0) & (gt < 192)
    warp = inverse_warp(gt_right, -gt, mode="disparity")
    occluded = ((warp - gt).abs() > 1.0) | (warp.abs() < 1e-6)
    splits = {"all": valid, "occ": valid & occluded,
              "noc": valid & ~occluded}
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
            split, stat = key.rsplit("/", 1)[1].split("_")
            if stat == "epe":
                if not d <= CARD_VS_CPU_TOL * scale + 1e-6:
                    raise AssertionError(f"eval card vs CPU: {key} {d:.3g}")
                continue
            # in pixels: the flips the gap allows against those seen
            mask = splits[split]
            near = int((((err - int(stat[:-2])).abs() <= gap) & mask).sum())
            flips = d * float(mask.sum()) / 100.0
            if not flips <= near + 0.5:
                raise AssertionError(f"eval card vs CPU: {key} {d:.3g}: "
                                     f"{flips:.2f} pixels flipped, {near} "
                                     f"within {gap:.3g} of {stat}")
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
    gt_right = torch.from_numpy(batch["disp_gt_right"][-1])
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
                               runs["cuda"][1], runs["cpu"][1], gt,
                               gt_right)
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
FIT_EPOCHS = 1                  # each epoch restarts the loader workers
# the JAX CLI's default is 1000; the train-batch EPE must halve, and the
# card's nondeterministic backward spreads it (59.64 -> 13.5-25.3 px after
# 100 steps, 10.4-16.6 after 150, in PR 13-14's runs)
SANITY_STEPS = 130
# the loader-bound CLI runs (phases 10 and 18 (c)) train full-width
# kitti2015-multi on 3-frame windows: each loader worker builds a whole
# batch before the first step, 25-46 s for 11 frames on this host
SHORT_WINDOW = [-2, -1, 0]
SHORT_WINDOW_OPTS = [opt for key in ("FRAME_IDXS", "DATA.TRAIN.FRAME_IDXS",
                                     "DATA.VAL.FRAME_IDXS",
                                     "DATA.TEST.FRAME_IDXS")
                     for opt in (key, str(SHORT_WINDOW))]


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
            "shift_1d_backward": 0, "softsplat": (t - 1) * windows,
            "softsplat_backward": 0}


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
    cfg0 = port.get_cfg(KITTI, SHORT_WINDOW_OPTS)
    t = len(cfg0.DATA.TRAIN.FRAME_IDXS)
    b = cfg0.DATA.TRAIN.BATCH_SIZE
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fit_") as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        train_ann = write_kitti2015_split(str(tmp / "train"),
                                          FIT_TRAIN_SAMPLES, SHORT_WINDOW)
        val_ann = write_kitti2015_split(str(tmp / "val"), FIT_VAL_SAMPLES,
                                        SHORT_WINDOW, seed=1)
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
                "DATA.TRAIN.ANNFILE", train_ann, *SHORT_WINDOW_OPTS,
                # the train loader on threads: its process pool took ~20 s
                # to start on the card's host, twice in this phase; the
                # val and test loaders keep process workers, as phases 9
                # and 17 do
                "DATA.TRAIN.PROCESS_WORKERS", "False"]
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
        log(10, f"cli.train kitti2015-multi v2s bf16 B={b} "
            f"{cfg0.DATA.TRAIN.HEIGHT}x{cfg0.DATA.TRAIN.WIDTH} T={t}, "
            f"{FIT_TRAIN_SAMPLES} train + {FIT_VAL_SAMPLES} val samples "
            f"(split written in {written:.1f} s), {FIT_EPOCHS} epochs of "
            f"{steps // FIT_EPOCHS} steps, {cfg0.DATA.TRAIN.NUM_WORKERS} "
            f"thread workers: warm start {n_warm[0]} tensors, SWA "
            f"{cli['swa_count']} snapshots, checkpoints {saved_steps}; "
            f"process wall {cli_wall:.1f} s on {card}")
        log(10, f"fit step ms (synchronised by the loss read-back) "
            f"{_ms(cli, 'step_s')} (T={t}; phase 6's bare T=11 step ms "
            f"{[round(1e3 * x, 1) for x in bare]}); loader wait per step "
            f"ms {_ms(cli, 'loader_wait_s')}; "
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


# the phases of the remaining tools, TPU.REMAT and the planner
DEMO_SAMPLES = 2
PROFILE_ITERS = 2               # profile_step's default is 6
REMAT_T = 3
# REMAT against the plain BPTT step, all gradients together (L2 over
# every tensor): ||remat - plain|| <= REMAT_GRAD_TOL * ||plain' - plain||,
# plain' a second plain run.  The forward is deterministic (the loss and
# the BatchNorm statistics are required bit-equal); the backward is not:
# the card's unordered bf16 sums put two plain runs ~4% apart in L2 and a
# tensor up to twice its largest gradient apart (H100, this phase), so
# REMAT is held to that spread, with a factor of 2 for its own draw of it
REMAT_GRAD_TOL = 2.0
PLANNER_STREAMS = (1, 2, 4, 8)
PLANNER_CHUNKS = (1, 2, 8)


def quiet_main(main, argv):
    """A CLI's ``main(argv)`` in this process, its standard output kept ->
    (its return value, the text)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main(argv)
    return result, buf.getvalue()


def phase_demo(torch, port, kernels, card):
    """Phase 11: the demo CLI over a synthetic KITTI 2015 split."""
    import tempfile

    from temporalstereo_tpu_torch.cli import demo
    from temporalstereo_tpu_torch.data.png import read_png
    from temporalstereo_tpu_torch.data.synthetic import write_kitti2015_split

    t_phase = time.perf_counter()
    cfg = port.get_cfg(KITTI)
    h, w, t = cfg.DATA.VAL.HEIGHT, cfg.DATA.VAL.WIDTH, len(EVAL_FRAMES)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_demo_") as tmp:
        tmp = pathlib.Path(tmp)
        ann = write_kitti2015_split(str(tmp / "kitti"), DEMO_SAMPLES,
                                    EVAL_FRAMES)
        opts = ["DATA.VAL.DATA_ROOT", str(tmp / "kitti"), "DATA.VAL.ANNFILE",
                ann, "DATA.VAL.FRAME_IDXS", str(EVAL_FRAMES)]
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        summary, text = quiet_main(demo.main, [
            "--config-file", KITTI, "--output-dir", str(tmp / "demo"),
            *opts])
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        for line in text.strip().splitlines():
            log(11, f"demo: {line}")
        names = sorted(p.name for p in (tmp / "demo").iterdir())
        if names != [f"demo_{i:04d}.png" for i in range(DEMO_SAMPLES)]:
            raise AssertionError(f"demo wrote {names}")
        shapes = [read_png(str(tmp / "demo" / n)).shape for n in names]
    if summary["samples"] != DEMO_SAMPLES or shapes != [(3 * h, w, 3)] * 2:
        raise AssertionError(f"demo: {summary['samples']} samples, panels "
                             f"{shapes}, want {DEMO_SAMPLES} of "
                             f"{(3 * h, w, 3)}")
    errors = summary["epe"] + summary["3px"]
    if len(errors) != 2 * DEMO_SAMPLES or not all(map(math.isfinite, errors)):
        raise AssertionError(f"demo: EPE/3PE not finite: {summary}")
    want = {"fused_cost_base": 2 * t * DEMO_SAMPLES,
            "fused_cost_base_backward": 0, "shift_1d": 0,
            "shift_1d_backward": 0, "softsplat": (t - 1) * DEMO_SAMPLES,
            "softsplat_backward": 0}
    if launches != want or summary["launches"] != want:
        raise AssertionError(f"demo launches {launches}, want {want}")
    log(11, f"demo kitti2015-multi v2s bf16 {h}x{w} T={t}, {DEMO_SAMPLES} "
        f"samples of 375x1242 PNGs: panels {shapes[0]}, EPE "
        f"{summary['epe']} 3PE {summary['3px']} % (random weights), "
        f"ms per sample (synchronised forward) {summary['ms_per_sample']}, "
        f"launches {launches}; the CLI's call {wall:.1f} s, phase "
        f"{time.perf_counter() - t_phase:.1f} s on {card}")
    return launches


def run_cli(module, args, timeout=600):
    """``python -m temporalstereo_tpu_torch.cli.<module> args`` in its own
    process (its own CUDA context and profiler) -> its standard output;
    raises if it fails."""
    repo = pathlib.Path(__file__).resolve().parent
    out = subprocess.run(
        [sys.executable, "-m", f"temporalstereo_tpu_torch.cli.{module}",
         *args], cwd=repo, capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise AssertionError(f"{module} failed:\n{out.stderr[-4000:]}")
    return out.stdout


def phase_tools(card):
    """Phase 12: benchmark_ops and profile_step --temporal --train, each
    in its own process, as a user runs them (in a process that has
    already profiled for minutes, a new profiler session recorded few
    device events on an H100) -> their launches, as they print them."""
    t_phase = time.perf_counter()
    line = run_cli("benchmark_ops", []).strip().splitlines()[-1]
    result = json.loads(line)
    bench = result["launches"]
    bad = [k for k, v in result["ops"].items()
           if not (math.isfinite(v["ms"]) and v["ms"] > 0)]
    if bad or not bench["fused_cost_base"] or not bench["softsplat"]:
        raise AssertionError(f"benchmark_ops: ops {bad}, launches {bench}")
    log(12, f"benchmark_ops JSON: {line}")
    for name, op in result["ops"].items():
        ref = op["reference"]
        log(12, f"  {name} {op['shape']}: {op['ms']:.4f} ms device on "
            f"{card}" + (f"; {ref['ms']} ms on {ref['hardware']}" if ref
                         else ""))
    text = run_cli("profile_step", ["--temporal", "--train", "--top", "10",
                                    "--iters", str(PROFILE_ITERS)])
    last = text.strip().splitlines()[-1]
    summary = json.loads(last[len("profile summary: "):])
    prof = summary["launches"]
    want = {"fused_cost_base": 4 * PROFILE_ITERS,
            "fused_cost_base_backward": 2 * PROFILE_ITERS, "shift_1d": 0,
            "shift_1d_backward": 0, "softsplat": PROFILE_ITERS,
            "softsplat_backward": 0}
    if prof != want:
        raise AssertionError(f"profile_step launches {prof}, want {want}")
    if not (0 < summary["busy_share"] <= 1 and summary["top"]):
        raise AssertionError(f"profile_step: {summary}")
    top = sorted(summary["scopes"].items(), key=lambda kv: -kv[1])[:8]
    log(12, f"profile_step --temporal --train (v2s bf16 384x1248, B=1, "
        f"T=2): wall {summary['wall_ms']:.2f} ms a step, device busy "
        f"{summary['busy_ms']:.2f} ms (share {summary['busy_share']:.3f}), "
        f"{summary['events_per_step']:.0f} device events a step "
        f"({100 * summary['linked_share']:.1f}% of their time linked to "
        f"the launching operation), launches {prof} over {PROFILE_ITERS} "
        f"steps on {card}")
    for name, ms, n in summary["top"]:
        log(12, f"  {ms:8.3f} ms/step {n:5d}/step  {name[:90]}")
    log(12, "  scopes (ms/step): " + ", ".join(f"{k} {v:.2f}"
                                              for k, v in top))
    log(12, f"phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return bench, prof


def _stash(torch):
    """An optimizer stage that passes the gradients on and keeps them."""
    from temporalstereo_tpu_torch.training.optim import GradientTransformation

    return GradientTransformation(
        lambda p: {k: torch.zeros_like(v) for k, v in p.items()},
        lambda g, s, p=None: (g, g))


def remat_step(torch, port, kernels, t, remat, batch, steps=2):
    """``steps`` BPTT steps of kitti2015-multi (from the same state) ->
    (metrics, gradients, statistics of the first; launches of the first;
    seconds of each; peak bytes above what was held before)."""
    from temporalstereo_tpu_torch.training.optim import chain

    cfg = port.get_cfg(KITTI, opts=[
        "MODEL.PREVIOUS_WITH_GRADIENT", "True", "TPU.REMAT", str(remat),
        "DATA.TRAIN.FRAME_IDXS", str(list(range(1 - t, 1)))])
    model = port.build_model(cfg, seed=0)
    state = port.TrainState.create(*port.master_copies(model),
                                   chain(_stash(torch),
                                         port.build_optimizer(cfg, 1000)))
    step = port.make_train_step(model, cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    secs, first = [], None
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, metrics = step(state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if i == 0:
            launches = dict(kernels.LAUNCHES)
            first = ({k: float(v) for k, v in metrics.items()},
                     new.opt_state[0], new.batch_stats)
        del new, metrics
    peak = torch.cuda.max_memory_allocated() - held
    del model, state, step
    torch.cuda.empty_cache()
    return first, launches, secs, peak


def _grad_gap(torch, ours, ref):
    """(||ours - ref|| / ||ref|| over all gradients, the worst tensor's
    max|d| / max|ref|, its name)."""
    diff = sum(float((ours[k] - g).double().square().sum())
               for k, g in ref.items())
    norm = sum(float(g.double().square().sum()) for g in ref.values())
    worst = max(ref, key=lambda k: float((ours[k] - ref[k]).abs().max())
                / max(float(ref[k].abs().max()), 1e-30))
    return (math.sqrt(diff / norm),
            float((ours[worst] - ref[worst]).abs().max())
            / max(float(ref[worst].abs().max()), 1e-30), worst)


def phase_remat(torch, port, kernels, card):
    """Phase 13: the BPTT step with and without TPU.REMAT -> the launches
    of the REMAT steps (T=3 and T=11)."""
    t_phase = time.perf_counter()
    cfg = port.get_cfg(KITTI)
    b, h, w = (cfg.DATA.TRAIN.BATCH_SIZE, cfg.DATA.TRAIN.HEIGHT,
               cfg.DATA.TRAIN.WIDTH)
    batch = train_batch(torch, REMAT_T, b, h, w, "cuda")
    runs = {}
    for label, remat in (("plain", False), ("plain again", False),
                         ("remat", True)):
        runs[label] = remat_step(torch, port, kernels, REMAT_T, remat, batch)
    (pm, pg, ps), p_launch, p_secs, p_peak = runs["plain"]
    (qm, qg, qs), _, q_secs, q_peak = runs["plain again"]
    (rm, rg, rs), r_launch, r_secs, r_peak = runs["remat"]
    loss_rel = abs(rm["loss"] - pm["loss"]) / abs(pm["loss"])
    gap, spread = _grad_gap(torch, rg, pg), _grad_gap(torch, qg, pg)
    stats_equal = all(torch.equal(rs[k], v) for k, v in ps.items())
    plain_stats_equal = all(torch.equal(qs[k], v) for k, v in ps.items())
    stats_diff = max(float((rs[k] - v).abs().max()) for k, v in ps.items())
    frames_fwd = 2 * REMAT_T
    want_plain = {"fused_cost_base": frames_fwd,
                  "fused_cost_base_backward": frames_fwd, "shift_1d": 0,
                  "shift_1d_backward": 0, "softsplat": REMAT_T - 1,
                  "softsplat_backward": 0}
    log(13, f"BPTT kitti2015-multi v2s bf16 B={b} {h}x{w} T={REMAT_T}: "
        f"loss plain {pm['loss']:.8g} / again {qm['loss']:.8g} / REMAT "
        f"{rm['loss']:.8g} (rel {loss_rel:.3g}); gradients, ||d|| / "
        "||plain|| over all tensors and the worst tensor's max|d| / its "
        "max|plain|: REMAT vs plain %.3g, %.3g (%s), plain vs plain %.3g, "
        "%.3g (%s); tol: REMAT's L2 <= %g x plain's" % (
            gap + spread + (REMAT_GRAD_TOL,)))
    log(13, f"  BatchNorm statistics equal: REMAT {stats_equal} (max|d| "
        f"{stats_diff:.3g}), plain twice {plain_stats_equal}; launches "
        f"plain {p_launch}, REMAT {r_launch}")
    log(13, f"  step ms (first, second): plain "
        f"{[round(1e3 * x, 1) for x in p_secs]} / "
        f"{[round(1e3 * x, 1) for x in q_secs]}, REMAT "
        f"{[round(1e3 * x, 1) for x in r_secs]}; peak memory above the "
        f"model, state and batch: plain {p_peak / 2 ** 30:.2f} / "
        f"{q_peak / 2 ** 30:.2f} GiB, REMAT {r_peak / 2 ** 30:.2f} GiB on "
        f"{card}")
    if not (loss_rel == 0 and stats_equal
            and gap[0] <= REMAT_GRAD_TOL * spread[0]):
        raise AssertionError("REMAT step disagrees with the plain step")
    if p_launch != want_plain:
        raise AssertionError(f"plain BPTT launches {p_launch}, want "
                             f"{want_plain}")
    if not (r_launch["fused_cost_base"] > frames_fwd
            and {k: v for k, v in r_launch.items() if k != "fused_cost_base"}
            == {k: v for k, v in want_plain.items()
                if k != "fused_cost_base"}):
        raise AssertionError(f"REMAT launches {r_launch}: the recompute "
                             "did not run the cost base again")
    if not r_peak < p_peak:
        raise AssertionError("REMAT did not lower the peak memory")
    del runs
    t_long = len(cfg.DATA.TRAIN.FRAME_IDXS)
    batch = train_batch(torch, t_long, b, h, w, "cuda")
    (lm, _, _), l_launch, l_secs, l_peak = remat_step(
        torch, port, kernels, t_long, True, batch)
    if not math.isfinite(lm["loss"]):
        raise AssertionError(f"REMAT T={t_long}: loss {lm['loss']}")
    log(13, f"REMAT T={t_long} B={b} {h}x{w}: loss {lm['loss']:.6g}, step "
        f"ms {[round(1e3 * x, 1) for x in l_secs]}, peak memory above the "
        f"model, state and batch {l_peak / 2 ** 30:.2f} GiB, launches "
        f"{l_launch} on {card}")
    log(13, f"phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return r_launch, l_launch


def phase_planner(torch, port, card):
    """Phase 14: the latency table on the card, its fit, and the
    video_inference CLI's operating point against it."""
    import tempfile

    from temporalstereo_tpu_torch import serving
    from temporalstereo_tpu_torch.cli import video_inference

    t_phase = time.perf_counter()
    h, w = 384, 1248
    model = port.build_model(port.get_cfg(KITTI), seed=0)
    table = serving.measure_latency_table(
        model, h, w, PLANNER_STREAMS, PLANNER_CHUNKS, reps=5,
        progress=lambda msg: log(14, msg))
    del model
    torch.cuda.empty_cache()
    lm = serving.LatencyModel.fit(table, name=f"measured on {card}")
    default = serving.H100_SXM_700W
    log(14, "latency table (streams, chunk, wall ms) at 384x1248 bf16: "
        + json.dumps([[s, c, round(x, 3)] for s, c, x in table]))
    for s, (d, f) in lm.points.items():
        dd, df = default.points[s]
        log(14, f"  fit, {s} stream(s): {d:.3f} ms a chunk + {f:.3f} ms a "
            f"frame ({1e3 / (d / 8 + f):.1f} fps/stream at chunk 8); the "
            f"default table {default.name}: {dd:.3f} + {df:.3f} ms")
    want = serving.select_operating_point(4, 30.0, lm)
    want.update(target_fps=30.0, streams=4)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_plan_") as tmp:
        tmp = pathlib.Path(tmp)
        write_sequence(tmp / "seq", 2, 375, 1242)
        (tmp / "latency.json").write_text(json.dumps(
            {"name": lm.name, "measurements": table}))
        _, text = quiet_main(video_inference.main, [
            "--config-file", KITTI, "--data-root", str(tmp / "seq"),
            "--log-dir", str(tmp / "out"), "--target-fps", "30",
            "--streams", "4", "--latency-model", str(tmp / "latency.json"),
            "--export-bundle", str(tmp / "bundle.json")])
        meta = json.loads((tmp / "bundle.json").read_text())
    lines = [x for x in text.splitlines()
             if x.startswith(("operating point:", "WARNING:"))]
    expect = (f"operating point: chunk={want['chunk']} -> "
              f"{want['fps_per_stream']} fps/stream" if want["feasible"]
              else f"WARNING: {want['note']}")
    if len(lines) != 1 or not lines[0].startswith(expect) \
            or meta["operating_point"] != json.loads(json.dumps(want)):
        raise AssertionError(f"video_inference planned {lines}, bundle "
                             f"{meta.get('operating_point')}, want {want}")
    log(14, f"video_inference --target-fps 30 --streams 4 on the measured "
        f"table: {lines[0]}; recorded in the bundle's meta; the default "
        f"table would choose "
        f"{serving.select_operating_point(4, 30.0)}; phase "
        f"{time.perf_counter() - t_phase:.1f} s on {card}")


# the norm variants, the surface off the main path, the native data path
GN_NORMS = ["MODEL.BACKBONE.NORM", "GN",
            "MODEL.AGGREGATION.COARSE.NORM", "GN",
            "MODEL.AGGREGATION.FINE.NORM", "GN",
            "MODEL.AGGREGATION.PRECISE.NORM", "GN"]
# every norm kind once: the FPN GN, the coarse stage IN, the fine LN, the
# precise FrozenBN
MIX_NORMS = ["MODEL.BACKBONE.NORM", "GN",
             "MODEL.AGGREGATION.COARSE.NORM", "IN",
             "MODEL.AGGREGATION.FINE.NORM", "LN",
             "MODEL.AGGREGATION.PRECISE.NORM", "FrozenBN"]
FROZEN_NORMS = ["MODEL.BACKBONE.NORM", "FrozenBN"] + [
    x for stage in ("COARSE", "FINE", "PRECISE")
    for x in (f"MODEL.AGGREGATION.{stage}.NORM", "FrozenBN")]
SINGLE_TOL = 2e-3               # single-frame / streamed model tolerances
STREAM_TOL = CARD_VS_CPU_TOL
SURFACE_TOL = {"op": 1e-5, "block": 1e-4}   # card vs CPU, f32, TF32 off
NATIVE_SAMPLES = 6              # the 4 the pool holds ahead (2 workers +
                                # a prefetch of 2) and 2 for the steady loop
NOISE = 1e-7                    # phase 15 scales a state by 1 + N(0, NOISE^2)


def randomize_weights(torch, model, seed):
    """Seeded weights of the tests' draw (``_jax_variables``): conv kernels
    N(0, 1/fan_in), biases N(0, 0.1^2), norm scales and BatchNorm variances
    in [0.75, 1.25], shifts and means N(0, 0.1^2)."""
    from temporalstereo_tpu_torch.nn.layers import NORMS

    g = torch.Generator().manual_seed(seed)
    convs = (torch.nn.Conv2d, torch.nn.Conv3d, torch.nn.ConvTranspose2d,
             torch.nn.ConvTranspose3d)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, convs):
                w = m.weight
                fan_in = (w.shape[0] if isinstance(m, convs[2:]) else
                          w.shape[1]) * math.prod(w.shape[2:])
                w.copy_(torch.randn(w.shape, generator=g) / math.sqrt(fan_in))
                if m.bias is not None:
                    m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
            elif isinstance(m, NORMS) and hasattr(m, "weight"):
                n = m.weight.shape
                m.weight.copy_(torch.rand(n, generator=g) * 0.5 + 0.75)
                m.bias.copy_(torch.randn(n, generator=g) * 0.1)
                if hasattr(m, "running_mean"):
                    m.running_mean.copy_(torch.randn(n, generator=g) * 0.1)
                    m.running_var.copy_(torch.rand(n, generator=g) * 0.5
                                        + 0.75)


def _map_state(prev, fn):
    """A PrevInfo with ``fn`` applied to each of its tensors."""
    import dataclasses

    def move(x):
        if hasattr(x, "to"):
            return fn(x)
        if isinstance(x, tuple):
            return tuple(move(v) for v in x)
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{
                f.name: move(getattr(x, f.name))
                for f in dataclasses.fields(x)})
        return x
    return move(prev)


def _prev_to(prev, device):
    """A PrevInfo with its tensors copied to ``device``."""
    return _map_state(prev, lambda x: x.to(device))


def _jiggled(torch, prev, eps, gen):
    """A PrevInfo whose float tensors are scaled by 1 + N(0, eps^2)."""
    return _map_state(prev, lambda x: x * (
        1 + eps * torch.randn(x.shape, generator=gen))
        if x.is_floating_point() else x)


def _steady_ms(secs, warm=4):
    steady = sorted(secs[warm:])
    return 1e3 * steady[len(steady) // 2]


def phase_norms(torch, port, kernels, card, frames=12):
    """Phase 15: kitti2015-multi (v2s, bf16) with GroupNorm in the FPN and
    the three stages beside the same model with BatchNorm: a 12-frame eager
    stream at 384x1248, the same stream served as CUDA graphs with
    BatchNorm folded (GroupNorm stays in the forward), two training steps
    at B=4, 320x1184, T=11; then the tiny f32 model with GN, IN, LN and
    FrozenBN card against CPU, and a FrozenBN training step that leaves
    its statistics bit-unchanged -> launches of the GN stream, bundle and
    training steps."""
    from temporalstereo_tpu_torch import serving
    from temporalstereo_tpu_torch.nn.layers import FrozenBatchNorm, GroupNorm
    from temporalstereo_tpu_torch.utils.fold_bn import fold_batch_norms

    t_phase = time.perf_counter()
    h, w = 384, 1248
    out = {}
    stream_want = {"fused_cost_base": 2 * frames,
                   "fused_cost_base_backward": 0, "shift_1d": 0,
                   "shift_1d_backward": 0, "softsplat": frames - 1,
                   "softsplat_backward": 0}
    for label, opts in (("BN", []), ("GN", GN_NORMS)):
        cfg = port.get_cfg(KITTI, opts)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        outs, prev, secs = run_stream(torch, port, cfg, "cuda", frames, h, w,
                                      seed=0, sync=True)
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if not all(bool(torch.isfinite(d).all()) and d.shape == (1, h, w, 1)
                   for f in outs for d in f):
            raise AssertionError(f"norms {label} stream: not finite")
        if launches != stream_want:
            raise AssertionError(f"norms {label} stream launches {launches}"
                                 f" != {stream_want}")
        out[label] = {"stream_ms": _steady_ms(secs), "stream_launches":
                      launches}
        log(15, f"kitti2015-multi v2s bf16 {label} {h}x{w}, {frames} eager "
            f"frames: finite, launches {launches}; per-frame ms "
            f"{[round(1e3 * s, 2) for s in secs]}, steady median "
            f"{out[label]['stream_ms']:.2f} ms, peak {peak:.2f} GiB on "
            f"{card}")
        del outs, prev

    K, bl, T = _geometry(torch, h, w, "cuda")
    pairs = seeded_frames(torch, frames, h, w, seed=15)
    for label, opts in (("BN", []), ("GN", GN_NORMS)):
        cfg = port.get_cfg(KITTI, opts)
        torch.cuda.empty_cache()
        model = port.build_model(cfg, seed=0)
        randomize_batch_norms(torch, model, seed=16)
        groups = sum(isinstance(m, GroupNorm) for m in model.modules())
        model, folded = fold_batch_norms(model)
        kept = sum(isinstance(m, GroupNorm) for m in model.modules())
        if kept != groups or (label == "GN") != (groups > 0):
            raise AssertionError(f"norms {label}: {groups} GroupNorms before "
                                 f"the fold, {kept} after")
        bundle, outs, secs, held = serve(torch, serving, model, pairs, K, bl,
                                         T, fold_bn=True)
        eager, _ = eager_stream(torch, port, serving, model, pairs, K, bl, T)
        rel = max_rel(torch, outs, eager)
        if not rel <= CARD_VS_CPU_TOL:
            raise AssertionError(f"norms {label} bundle: replays vs eager "
                                 f"rel {rel:.3g} > {CARD_VS_CPU_TOL}")

        def replay_all():
            kernels.reset_launches()
            bundle.reset()
            for left, right in pairs:
                bundle.step(left, right, K, bl, T)
        _, per_run = kernel_counts(torch, replay_all)
        launches = dict(kernels.LAUNCHES)
        if per_run != {"fused_cost_base": 2 * frames,
                       "softsplat": frames - 1}:
            raise AssertionError(f"norms {label} bundle: replays ran "
                                 f"{per_run}")
        if launches != {**{name: 0 for name in launches}, **per_run}:
            raise AssertionError(f"norms {label} bundle: LAUNCHES counted "
                                 f"{launches} for replays that ran "
                                 f"{per_run}")
        out[label].update(bundle_ms=_steady_ms(secs),
                          bundle_launches=launches)
        log(15, f"kitti2015-multi {label} served, {len(folded)} BatchNorms "
            f"folded, {kept} GroupNorms left in the forward: captured "
            + ", ".join(f"{k} {v:.2f} s" for k, v in
                        bundle.capture_seconds.items())
            + f"; {frames} replays vs eager rel {rel:.3g} (tol "
            f"{CARD_VS_CPU_TOL}); per-frame ms "
            f"{[round(1e3 * x, 2) for x in secs]}, steady median "
            f"{out[label]['bundle_ms']:.2f} ms; replayed kernels {per_run}; "
            f"the graphs hold {held / 2 ** 30:.3f} GiB on {card}")
        del bundle, outs, eager, model

    torch.cuda.empty_cache()
    cfg = port.get_cfg(KITTI, GN_NORMS)
    t = len(cfg.DATA.TRAIN.FRAME_IDXS)
    b = cfg.DATA.TRAIN.BATCH_SIZE
    launches, secs, deltas, moved, metrics = _run_training(
        torch, port, kernels, cfg, 2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {"fused_cost_base": 2 * t * 2, "fused_cost_base_backward": 4,
            "shift_1d": 0, "shift_1d_backward": 0, "softsplat": (t - 1) * 2,
            "softsplat_backward": 0}
    if launches != want:
        raise AssertionError(f"norms GN training launches {launches} != "
                             f"{want}")
    lr = cfg.OPTIMIZER.RMSPROP.LR
    if not all(0.1 * lr <= d <= 10.01 * lr and m > 0.5
               for d, m in zip(deltas, moved)):
        raise AssertionError(f"norms GN training: parameter changes "
                             f"{deltas}, shares moved {moved}")
    out["GN"]["train_launches"] = launches
    bn_secs = MEASURED["train_step_s"]
    log(15, f"kitti2015-multi GN training B={b} "
        f"{cfg.DATA.TRAIN.HEIGHT}x{cfg.DATA.TRAIN.WIDTH} T={t}, 2 steps: "
        f"loss {metrics['loss']:.6g}, launches {launches}; per-step ms "
        f"{[round(1e3 * x, 2) for x in secs]}, peak {peak:.2f} GiB; the BN "
        f"model's steps (phase 6, this run) "
        f"{[round(1e3 * x, 2) for x in bn_secs]} ms, peak "
        f"{MEASURED['train_peak_gib']:.2f} GiB on {card}")
    log(15, f"GN against BN, this run: eager frame "
        f"{out['GN']['stream_ms']:.2f} / {out['BN']['stream_ms']:.2f} ms "
        f"({out['GN']['stream_ms'] / out['BN']['stream_ms']:.3f}x), replayed "
        f"frame {out['GN']['bundle_ms']:.2f} / {out['BN']['bundle_ms']:.2f} "
        f"ms ({out['GN']['bundle_ms'] / out['BN']['bundle_ms']:.3f}x), "
        f"second training step {1e3 * secs[1]:.2f} / "
        f"{1e3 * bn_secs[1]:.2f} ms ({secs[1] / bn_secs[1]:.3f}x)")

    # the tiny f32 model with every kind, card against CPU, each frame from
    # the CPU's state, held on the first two frames (single-frame and
    # streamed, the T=2 of the CPU tests against JAX).  From the third
    # frame on, this random-weight stream's step is ill-conditioned in its
    # carried state: the CPU's own step from the state scaled by
    # 1 + N(0, NOISE^2) moves as far as the card does (both in the log)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = port.get_cfg(opts=TINY + MIX_NORMS)
    th, tw, tframes, held = 96, 160, 5, 2
    cpu_model = port.build_model(cfg, device="cpu", seed=3)
    randomize_weights(torch, cpu_model, seed=21)
    gpu_model = port.build_model(cfg, device="cuda", seed=3)
    gpu_model.load_state_dict(cpu_model.state_dict())
    K, bl, T = _geometry(torch, th, tw, "cpu", 30.0, 2.0)
    prev = port.init_prev_info(
        cpu_model, 1, (th, tw), port.backbone_memory_shapes(
            cpu_model.backbone_cfg, (th, tw)), 2, local_map_channels=0)
    g = torch.Generator().manual_seed(22)
    noise = torch.Generator().manual_seed(23)
    worst, same, free, moved = [0.0, 0.0], [], [], []
    gprev = _prev_to(prev, "cuda")
    for f in range(tframes):
        left, right = (torch.rand((1, th, tw, 3), generator=g)
                       for _ in range(2))
        with torch.no_grad():
            cout, nprev = port.streaming_step(cpu_model, left, right, prev,
                                              K, bl, T)
            gout, _ = port.streaming_step(
                gpu_model, left.cuda(), right.cuda(), _prev_to(prev, "cuda"),
                K.cuda(), bl.cuda(), T.cuda())
            fout, gprev = port.streaming_step(
                gpu_model, left.cuda(), right.cuda(), gprev, K.cuda(),
                bl.cuda(), T.cuda())
            nouts = [port.streaming_step(
                cpu_model, left, right, _jiggled(torch, prev, NOISE, noise),
                K, bl, T)[0] for _ in range(4)]
        tol = SINGLE_TOL if f == 0 else STREAM_TOL
        for i, (a, c) in enumerate(zip(gout["disps"], cout["disps"])):
            rel = float((a.cpu() - c).abs().max() / (c.abs().mean() + 1e-6))
            if f < held:
                worst[f > 0] = max(worst[f > 0], rel)
                if not rel < tol:
                    raise AssertionError(
                        f"norms tiny GN/IN/LN/FrozenBN frame {f} disparity "
                        f"{i}: card vs CPU rel {rel:.3g} >= {tol}")
        same.append(max_rel(torch, [a.cpu() for a in gout["disps"]],
                            cout["disps"]))
        free.append(max_rel(torch, [a.cpu() for a in fout["disps"]],
                            cout["disps"]))
        moved.append(max(max_rel(torch, n["disps"], cout["disps"])
                         for n in nouts))
        prev = nprev
    log(15, f"tiny f32 {th}x{tw}, FPN GN, stages IN / LN / FrozenBN, "
        f"{tframes} frames, card (kernels) vs CPU (plain), each frame from "
        f"the CPU's state: worst max|d|/mean|cpu| {worst[0]:.3g} on the "
        f"first frame (tol {SINGLE_TOL}), {worst[1]:.3g} on the second "
        f"(tol {STREAM_TOL}); by frame, card vs CPU from the same state "
        f"{[float(f'{x:.3g}') for x in same]} (held on the first {held}), "
        f"the CPU's own step from that state scaled by 1 + N(0, "
        f"{NOISE:g}^2) {[float(f'{x:.3g}') for x in moved]} (worst of 4), "
        f"free-running streams {[float(f'{x:.3g}') for x in free]}")

    cfg = port.get_cfg(KITTI, opts=TINY_TRAIN + FROZEN_NORMS)
    model = port.build_model(cfg, device="cuda", seed=5)
    randomize_batch_norms(torch, model, seed=17)
    frozen = [f"{n}.{s}" for n, m in model.named_modules()
              if isinstance(m, FrozenBatchNorm)
              for s in ("running_mean", "running_var")]
    state = port.TrainState.create(*port.master_copies(model),
                                   port.build_optimizer(cfg, 10))
    batch = train_batch(torch, 3, 1, 96, 128, "cuda", seed=6, focal=30.0,
                        baseline=2.0, motion=(0.03, -0.05))
    new, metrics = port.make_train_step(model, cfg)(state, batch)
    changed = [k for k in frozen
               if not torch.equal(new.batch_stats[k], state.batch_stats[k])]
    others = [k for k in state.batch_stats if k not in frozen
              and not torch.equal(new.batch_stats[k], state.batch_stats[k])]
    if changed or not frozen or not others:
        raise AssertionError(f"FrozenBN training step: {len(changed)} of "
                             f"{len(frozen)} frozen statistics changed, "
                             f"{len(others)} BatchNorm ones moved")
    log(15, f"tiny f32 FrozenBN training step (T=3, 96x128): loss "
        f"{float(metrics['loss']):.6g}; {len(frozen)} FrozenBN statistics "
        f"bit-unchanged, {len(others)} of the trunk's BatchNorm statistics "
        f"updated; phase 15 took {time.perf_counter() - t_phase:.1f} s")
    del model, state, new
    torch.cuda.empty_cache()
    return (out["GN"]["stream_launches"], out["GN"]["bundle_launches"],
            out["GN"]["train_launches"])


def _card_vs_cpu(torch, name, fn, args, tol, cpu_module=None):
    """fn on the card and on the CPU (the same inputs; a module moved to
    each) -> max |card - cpu| / max(1, max|cpu|)."""
    import copy

    outs = []
    for dev in ("cuda", "cpu"):
        moved = [a.to(dev) if hasattr(a, "to") and not isinstance(
            a, torch.nn.Module) else a for a in args]
        if cpu_module is not None:
            mod = copy.deepcopy(cpu_module).to(dev).eval()
            with torch.no_grad():
                outs.append(mod(*moved).float().cpu())
        else:
            outs.append(fn(*moved).float().cpu())
    card, cpu = outs
    if card.shape != cpu.shape or not bool(torch.isfinite(card).all()):
        raise AssertionError(f"surface {name}: card {tuple(card.shape)} vs "
                             f"CPU {tuple(cpu.shape)} or not finite")
    err = float((card - cpu).abs().max()) / max(1.0, float(
        cpu.abs().max()))
    if not err <= tol:
        raise AssertionError(f"surface {name}: card vs CPU {err:.3g} > "
                             f"{tol}")
    return err


def phase_surface(torch, port, kernels, card):
    """Phase 16: the surface off the main path on the card.
    ``inverse_warp_3d`` without a y shift launches the shift kernel (held
    against its plain version at phase 3's tolerance) and
    ``summation_splat`` the softsplat kernel; the 4-tap warp, the argmins,
    ``max_pool3d``, ``upsample_disp`` and the blocks (SPP3D, ConvGRU,
    StereoDRNetRefinement, ResidualBlock2D with GN, BasicBlock) card
    against CPU at small shapes -> the kernels' launches."""
    from temporalstereo_tpu_torch import nn as pnn
    from temporalstereo_tpu_torch import ops
    from temporalstereo_tpu_torch.kernels.shift import shift_1d_plain

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(19)
    _, (b, h, w, c, d) = TRAIN_SHAPES[0]
    img = torch.randn((b, h, w, c), generator=g, device=dev).bfloat16()
    disp = (torch.rand((b, d, h, w), generator=g, device=dev) * (w + 8.0)
            - 4.0)
    values = torch.randn((1, 48, 156, 16), generator=g, device=dev)
    flow = torch.randn((1, 48, 156, 2), generator=g, device=dev) * 3
    torch.cuda.synchronize()
    kernels.reset_launches()
    warped = ops.inverse_warp_3d(img, disp)
    splat = ops.summation_splat(values, flow)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    want = {name: 0 for name in launches}
    want.update(shift_1d=1, softsplat=1)
    if launches != want:
        raise AssertionError(f"surface launches {launches} != {want}")
    err, ok = close(warped, shift_1d_plain(img[:, None], disp),
                    *COST_TOL["bfloat16"])
    if not ok:
        raise AssertionError("inverse_warp_3d (shift kernel) disagrees with "
                             "the plain shift")
    serr, ok = close(splat, kernels.softsplat_plain(values, flow, None,
                                                    "summation"), *SPLAT_TOL)
    if not ok:
        raise AssertionError("summation_splat disagrees with the plain "
                             "splat")
    log(16, f"inverse_warp_3d(disp_y=None) [{b},{h},{w},{c}] bf16 x "
        f"[{b},{d},{h},{w}] -> the shift kernel, max|d| {err:.3g} against "
        f"the plain shift (tol {COST_TOL['bfloat16']}); summation_splat "
        f"[1,48,156,16] -> the softsplat kernel, max|d| {serr:.3g} (tol "
        f"{SPLAT_TOL}); launches {launches}")

    gc = torch.Generator().manual_seed(20)
    rnd = (lambda *s: torch.randn(s, generator=gc))
    errs = {}
    small_img = rnd(2, 12, 20, 5)
    shift, shift_y = rnd(2, 4, 12, 20) * 4, rnd(2, 4, 12, 20) * 3
    errs["inverse_warp_3d(disp_y)"] = _card_vs_cpu(
        torch, "inverse_warp_3d", lambda i, x, y: ops.inverse_warp_3d(
            i, x, "zeros", y), (small_img, shift, shift_y),
        SURFACE_TOL["op"])
    cost, sample = rnd(2, 12, 20, 9), rnd(2, 12, 20, 9).abs() * 30
    errs["soft_argmin"] = _card_vs_cpu(
        torch, "soft_argmin", lambda a, s: ops.soft_argmin(a, s, 2.0),
        (cost, sample), SURFACE_TOL["op"])
    errs["hard_argmin"] = _card_vs_cpu(torch, "hard_argmin", ops.hard_argmin,
                                       (cost, sample), 0.0)
    vol = rnd(2, 7, 12, 20, 8)
    errs["max_pool3d"] = _card_vs_cpu(
        torch, "max_pool3d", lambda v: ops.max_pool3d(
            v, (5, 5, 5), (1, 1, 1), (2, 2, 2)), (vol,), 0.0)
    errs["upsample_disp"] = _card_vs_cpu(
        torch, "upsample_disp", lambda x: ops.upsample_disp(x, (48, 80)),
        (rnd(2, 12, 20, 1).abs() * 10,), SURFACE_TOL["op"])
    blocks = (
        ("SPP3D", pnn.SPP3D(8), (rnd(1, 8, 6, 18, 20),)),
        ("ConvGRU", pnn.ConvGRU(8, 6), (rnd(2, 8, 12, 20),
                                         rnd(2, 6, 12, 20))),
        ("StereoDRNetRefinement", pnn.StereoDRNetRefinement(),
         (rnd(1, 1, 24, 40).abs() * 5, rnd(1, 3, 24, 40),
          rnd(1, 3, 24, 40))),
        ("ResidualBlock2D GN", pnn.ResidualBlock2D(32, norm="GN"),
         (rnd(2, 32, 13, 18),)),
        ("BasicBlock", pnn.BasicBlock(32, 32, dilation=2),
         (rnd(2, 32, 13, 18),)))
    for name, module, args in blocks:
        for p in module.parameters():
            with torch.no_grad():
                p.copy_(torch.randn(p.shape, generator=gc) * 0.3)
        errs[name] = _card_vs_cpu(torch, name, None, args,
                                  SURFACE_TOL["block"], cpu_module=module)
    log(16, "card vs CPU, f32, TF32 off, max|d| / max(1, max|cpu|): "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f" (tol {SURFACE_TOL['op']} ops, 0 argmax and max pool, "
        f"{SURFACE_TOL['block']} blocks) on {card}")
    return launches


def phase_native(torch, port, kernels, card, build_info):
    """Phase 17: the native data library on the card's host: its build
    (phase 2), a 375x1242 RGB Paeth PNG decoded natively and in numpy
    (bit-equal), one KITTI 2015 val sample built on one core each way, and
    phase 9's val loader (2 process workers, native) with make_eval_step
    over a Paeth split: the wait and the step per sample, and the loop's
    time per sample against the step alone -> the launches of that eval
    loop."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from temporalstereo_tpu_torch.data import batch_to_device, native
    from temporalstereo_tpu_torch.data import (build_dataloader,
                                               build_stereo_dataset)
    from temporalstereo_tpu_torch.data.png import read_png
    from temporalstereo_tpu_torch.data.synthetic import write_kitti2015_split
    from temporalstereo_tpu_torch.training import make_eval_step

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_native_") as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        ann = write_kitti2015_split(str(tmp / "kitti"), NATIVE_SAMPLES,
                                    EVAL_FRAMES, filter_type=4)
        written = time.perf_counter() - t0
        split = ["DATA.VAL.DATA_ROOT", str(tmp / "kitti"),
                 "DATA.VAL.ANNFILE", ann, "DATA.VAL.FRAME_IDXS",
                 str(EVAL_FRAMES), "DATA.VAL.PROCESS_WORKERS", "True"]
        cfg = port.get_cfg(KITTI, split)
        # one sample on one core each way; the dataset reads with
        # use_native=None, sent down numpy's path here in this process only
        dataset = build_stereo_dataset(cfg.DATA.VAL, "val")
        sample_ms = {"library": _median_ms(
            lambda: dataset.getitem_seeded(0, 0), 1)}
        default = native.resolve
        native.resolve = bool
        try:
            sample_ms["numpy"] = _median_ms(
                lambda: dataset.getitem_seeded(0, 0), 1)
        finally:
            native.resolve = default
        loader = build_dataloader(cfg.DATA.VAL, "val")
        batches = iter(loader)
        waits, steps, ready, marks = [], [], [], []
        try:
            with ThreadPoolExecutor(1) as ahead:
                t_start = time.perf_counter()
                first = ahead.submit(next, batches, None)
                first.add_done_callback(
                    lambda f: ready.append(time.perf_counter()))
                name = loader.dataset.data_list[0]["0"]["left_image_path"]
                path = str(tmp / "kitti" / name)
                nat = read_png(path, use_native=True)
                ref = read_png(path, use_native=False)
                if nat.shape != (375, 1242, 3) or not np.array_equal(nat,
                                                                     ref):
                    raise AssertionError("native PNG decode differs from "
                                         "numpy's")
                nat_ms = _median_ms(lambda: read_png(path, use_native=True),
                                    5)
                np_ms = _median_ms(lambda: read_png(path, use_native=False),
                                   3)
                model = port.build_model(cfg, seed=0)
                eval_step = make_eval_step(model, cfg)
                torch.cuda.synchronize()
                kernels.reset_launches()
                t_loop = t_wait = time.perf_counter()
                batch = first.result()
            while batch is not None:
                marks.append(t_wait)
                waits.append(time.perf_counter() - t_wait)
                t0 = time.perf_counter()
                on_card = batch_to_device(batch)
                metrics = eval_step(on_card)
                torch.cuda.synchronize()
                steps.append(time.perf_counter() - t0)
                if not all(math.isfinite(float(v)) for v in metrics.values()):
                    raise AssertionError("native eval metrics not finite")
                t_wait = time.perf_counter()
                batch = next(batches, None)
            loop = time.perf_counter() - t_loop
        finally:
            loader.close()
        launches = dict(kernels.LAUNCHES)
    # the last batch's step again with no loader running: the step alone
    alone = []
    for _ in range(5):
        t0 = time.perf_counter()
        eval_step(on_card)
        torch.cuda.synchronize()
        alone.append(time.perf_counter() - t0)
    del on_card
    t = len(EVAL_FRAMES)
    if len(steps) != NATIVE_SAMPLES:
        raise AssertionError(f"native eval loader gave {len(steps)} batches")
    want = {"fused_cost_base": 2 * t * NATIVE_SAMPLES,
            "softsplat": (t - 1) * NATIVE_SAMPLES}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"native eval launches {launches}")
    # the batches the pool holds when the loop starts (its workers' and
    # its queue's) hide the loader; the loop after them is the steady one
    ahead = loader.num_workers + loader.prefetch
    per_sample = (t_loop + loop - marks[ahead]) / (len(steps) - ahead)
    alone_ms = 1e3 * sorted(alone)[len(alone) // 2]
    log(17, f"native library: g++ build {build_info['seconds']:.2f} s "
        f"(phase 2); 375x1242 RGB Paeth PNG decode {nat_ms:.2f} ms native, "
        f"{np_ms:.1f} ms numpy ({np_ms / nat_ms:.1f}x), bit-equal; one "
        f"KITTI 2015 val sample (11 frames, Paeth PNGs) built on one core "
        f"{sample_ms['library']:.1f} ms native, {sample_ms['numpy']:.1f} ms "
        f"numpy ({sample_ms['numpy'] / sample_ms['library']:.1f}x) on {card}")
    log(17, f"val loader, native, 2 process workers, {NATIVE_SAMPLES} "
        f"samples (split written in {written:.1f} s; first batch "
        f"{ready[0] - t_start:.1f} s after the pool's start, overlapping "
        f"the decode timings and the model's build): wait per "
        f"sample ms {[round(1e3 * x, 1) for x in waits]}, eval step ms "
        f"{[round(1e3 * s, 1) for s in steps]}; after the {ahead} batches "
        f"the pool holds ahead, the loop takes {1e3 * per_sample:.1f} ms a "
        f"sample (waits median "
        f"{1e3 * sorted(waits[ahead:])[len(waits[ahead:]) // 2]:.1f} ms) "
        f"against {alone_ms:.1f} ms for the step alone (its last batch "
        f"again, no loader running, median of "
        f"{[round(1e3 * s, 1) for s in alone]}): "
        f"{1e3 * per_sample / alone_ms:.2f}x; launches {launches}; "
        f"phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return launches


DP_WORLD = 2
DP_DEADLINE = 300               # seconds for a pair of phase 18 ranks
# phase 18 (a), two gloo ranks on the card against one process, tiny f32,
# TF32 off: losses and eval metrics relative, grad_norm relative, each
# gradient of the model's largest gradient, each parameter and statistic
# of its tensor's largest value (statistics plus 1e-6 of the largest).
# The CPU test (tests/test_torch_parallel.py) holds 1e-5 / 1e-6 / 1e-4 /
# 1e-4 / 1e-5 there; on the card a rank's B=1 and one process's B=2 may
# also run other cuDNN algorithms
DP_TOL = {"loss": 1e-4, "eval": 1e-4, "grad_norm": 1e-3, "grad": 1e-3,
          "param": 1e-4, "stats": 1e-4}
# (b) at full width, bf16: the stem BatchNorm's running statistics of their
# max.  The first step of this random-weight 11-frame window is itself
# ill-conditioned (one process against itself with its 4 samples
# reordered moved its loss terms by up to 0.78): its loss terms and the
# deeper statistics are reported beside that spread, not gated
DP_STEM_TOL = 1e-3
# (c) the first NCCL step's loss terms against the plain one (the same code
# at world size 1: its forward is deterministic); the second step's are
# reported beside the plain step's own spread, since cuDNN's backward is not
# deterministic and this random-weight window amplifies it
DP_NCCL_TOL = 2e-3
DP_VAL_SAMPLES = 2
DP_FULL_STEPS = 1               # (b)'s steps on each rank


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _digest(tensors):
    """sha256 of a dict of tensors' bytes, in key order."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(tensors[k].detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _cpu(tree):
    return {k: v.detach().cpu() for k, v in tree.items()}


def _floats(tree):
    return {k: float(v) for k, v in tree.items()}


def _tiny_dp_step(torch, port, kernels, job, mesh=None):
    """Phase 18 (a)'s training step and eval step of the tiny model, on
    ``mesh``'s shard of the job's global batches (one process: the whole
    train batch and the eval batch's real samples)."""
    from temporalstereo_tpu_torch.parallel import shard_batch
    from temporalstereo_tpu_torch.training import make_eval_step
    from temporalstereo_tpu_torch.training.optim import chain

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = port.get_cfg(KITTI, opts=job["opts"])
    model = port.build_model(cfg, device="cuda")
    model.load_state_dict(job["state_dict"])
    params, stats = port.master_copies(model)
    state = port.TrainState.create(
        params, stats, chain(_stash(torch), port.build_optimizer(cfg, 10)))
    step = port.make_train_step(model, cfg, mesh=mesh)
    evaluate = make_eval_step(model, cfg, mesh=mesh)
    if mesh is None:
        train = {k: v.cuda() for k, v in job["train"].items()}
        evaluated = {k: v.cuda() for k, v in job["eval_single"].items()}
    else:
        train = shard_batch(mesh, job["train"])
        evaluated = shard_batch(mesh, job["eval"])
    kernels.reset_launches()
    state, metrics = step(state, train)
    em = evaluate(evaluated)
    torch.cuda.synchronize()
    return {"metrics": _floats(metrics), "grads": _cpu(state.opt_state[0]),
            "params": _cpu(state.params), "stats": _cpu(state.batch_stats),
            "eval": _floats(em), "launches": dict(kernels.LAUNCHES)}


def _full_dp_steps(torch, port, kernels, job, mesh):
    """Phase 18 (b) on one rank: kitti2015-multi from seed 0, ``steps``
    steps on this rank's shard of the seeded global batch."""
    import torch.distributed as dist

    from temporalstereo_tpu_torch.parallel import shard_batch

    cfg = port.get_cfg(KITTI)
    t = len(cfg.DATA.TRAIN.FRAME_IDXS)
    h, w = cfg.DATA.TRAIN.HEIGHT, cfg.DATA.TRAIN.WIDTH
    model = port.build_model(cfg, device="cuda", seed=0)
    params, stats = port.master_copies(model)
    out = {"digest": _digest(params)}
    state = port.TrainState.create(params, stats,
                                   port.build_optimizer(cfg, 1000))
    step = port.make_train_step(model, cfg, mesh=mesh)
    local = shard_batch(mesh, _dp_full_batch(torch, t, job["global_batch"],
                                             h, w, "cpu"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    out["metrics"], out["step_s"] = [], []
    for i in range(job["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, local)
        torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t0)
        out["metrics"].append(_floats(metrics))
        if i == 0:
            out["stats"] = _cpu(state.batch_stats)
    out["launches"] = dict(kernels.LAUNCHES)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["final"] = _digest(state.params)
    # the step's gradient bucket, all-reduced alone through gloo
    flat = torch.zeros(sum(p.numel() for p in params.values()),
                       device="cuda")
    secs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(flat)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    out["bucket_ms"], out["bucket_mb"] = ([round(1e3 * s, 2) for s in secs],
                                          flat.numel() * 4 / 2 ** 20)
    return out


def _dp_rank(rank, world, port_no, directory, which):
    """One rank of phase 18, a spawned process: joins a gloo group on the
    one card through the port's ``init_distributed`` (NCCL refuses two
    ranks on one device), runs job ``which`` on its shard and saves what
    it computed under ``directory``."""
    import datetime
    import os

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port_no))
    import torch
    import torch.distributed as dist

    import temporalstereo_tpu_torch as port
    from temporalstereo_tpu_torch import kernels
    from temporalstereo_tpu_torch.parallel import (init_distributed,
                                                   make_data_mesh)

    directory = pathlib.Path(directory)
    device = init_distributed("cuda:0", backend="gloo",
                              timeout=datetime.timedelta(seconds=120))
    try:
        job = torch.load(directory / f"{which}.pt", weights_only=False)
        mesh = make_data_mesh(job["global_batch"], world, device)
        run = _tiny_dp_step if which == "tiny" else _full_dp_steps
        out = run(torch, port, kernels, job, mesh)
        out["backend"] = dist.get_backend()
        torch.save(out, directory / f"{which}_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _run_ranks(torch, directory, which):
    """Phase 18's two ranks of job ``which`` -> what each computed; both
    killed at the deadline, and any rank's failure fails the phase."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    port_no = _free_port()
    procs = [ctx.Process(target=_dp_rank,
                         args=(r, DP_WORLD, port_no, str(directory), which))
             for r in range(DP_WORLD)]
    for p in procs:
        p.start()
    t_end = time.time() + DP_DEADLINE
    try:
        for p in procs:
            p.join(max(t_end - time.time(), 1))
    finally:
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if late:
        raise AssertionError(f"phase 18 {which}: ranks {late} passed their "
                             f"{DP_DEADLINE} s deadline")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise AssertionError(f"phase 18 {which}: rank exit codes {codes}")
    return [torch.load(directory / f"{which}_rank{r}.pt", weights_only=False)
            for r in range(DP_WORLD)]


def _sum_launches(outs):
    return {k: sum(o["launches"][k] for o in outs)
            for k in outs[0]["launches"]}


def _max_rel_tree(ours, ref, floor=0.0):
    """max over tensors of max|d| / (max|ref| + floor)."""
    return max(float((ours[k] - v).abs().max())
               / max(float(v.abs().max()) + floor, 1e-30)
               for k, v in ref.items())


def _dp_tiny(torch, port, kernels, tmp):
    """Phase 18 (a) -> the launches of both ranks."""
    from temporalstereo_tpu_torch.parallel import TIME_MAJOR_KEYS

    opts = TINY_TRAIN + ["OPTIMIZER.RMSPROP.LR", "1e-6"]
    model = port.build_model(port.get_cfg(KITTI, opts=opts), device="cpu",
                             seed=3)
    randomize_weights(torch, model, seed=41)
    geometry = dict(focal=30.0, baseline=2.0, motion=(0.03, -0.05))
    # 3 real eval samples over 2 ranks: rank 1's second is a duplicate
    three = train_batch(torch, 3, 3, 96, 128, "cpu", seed=7, **geometry)
    order = [0, 2, 1, 1]
    evaluated = {k: v[:, order] if k in TIME_MAJOR_KEYS else v[order]
                 for k, v in three.items()}
    evaluated["pad_mask"] = torch.tensor([1, 1, 1, 0])
    job = {"global_batch": DP_WORLD, "opts": opts,
           "state_dict": model.state_dict(),
           "train": train_batch(torch, 3, DP_WORLD, 96, 128, "cpu", seed=6,
                                **geometry),
           "eval": evaluated, "eval_single": three}
    torch.save(job, tmp / "tiny.pt")
    single = _tiny_dp_step(torch, port, kernels, job)
    ranks = _run_ranks(torch, tmp, "tiny")
    a, b = ranks
    equal = (a["metrics"] == b["metrics"] and a["eval"] == b["eval"]
             and all(torch.equal(v, b[part][k]) for part in
                     ("grads", "params", "stats") for k, v in a[part].items()))
    if not equal or {r["backend"] for r in ranks} != {"gloo"}:
        raise AssertionError("phase 18 (a): the two ranks' states differ "
                             f"or not gloo ({[r['backend'] for r in ranks]})")
    gaps = {"loss": max(abs(a["metrics"][k] - v) / abs(v)
                        for k, v in single["metrics"].items()
                        if k != "grad_norm"),
            "grad_norm": abs(a["metrics"]["grad_norm"]
                             - single["metrics"]["grad_norm"])
            / single["metrics"]["grad_norm"],
            "eval": max(abs(a["eval"][k] - v) / max(abs(v), 1e-6)
                        for k, v in single["eval"].items()),
            "param": _max_rel_tree(a["params"], single["params"]),
            # floored as in (b): a zero batch mean is rounding noise
            "stats": _max_rel_tree(a["stats"], single["stats"], 1e-6 * max(
                float(v.abs().max()) for v in single["stats"].values()))}
    top = max(float(g.abs().max()) for g in single["grads"].values())
    gaps["grad"] = max(float((a["grads"][k] - g).abs().max())
                       for k, g in single["grads"].items()) / top
    want = _fit_launches(3, 1, 1, 0)
    if any(r["launches"] != want for r in ranks):
        raise AssertionError(f"phase 18 (a) launches "
                             f"{[r['launches'] for r in ranks]} != {want} "
                             "a rank")
    if a["eval"]["weight"] != 3.0 or single["eval"]["weight"] != 3.0:
        raise AssertionError(f"phase 18 (a): eval weight {a['eval']['weight']}"
                             f" / {single['eval']['weight']}, want 3")
    log(18, f"(a) two gloo ranks on one card, tiny f32 T=3, global B=2 (1 "
        f"a rank), TF32 off, against one process at B=2: the ranks "
        f"bit-equal; gaps {({k: float(f'{v:.3g}') for k, v in gaps.items()})}"
        f" (tolerances {DP_TOL}); eval over 3 samples with one padded "
        f"duplicate: weight {a['eval']['weight']:g}; launches a rank "
        f"{a['launches']}")
    failed = [k for k, v in gaps.items() if not v <= DP_TOL[k]]
    if failed:
        raise AssertionError(f"phase 18 (a): {failed} past the tolerance")
    return _sum_launches(ranks)


def _dp_full_batch(torch, t, b, h, w, device):
    """Phase 6's seeded batch with each sample's images scaled by its own
    factor (0.4 to 1.3), so that a BatchNorm's statistics over one rank's
    shard are far from those over the global batch."""
    batch = train_batch(torch, t, b, h, w, "cpu")
    scale = torch.linspace(0.4, 1.3, b).view(1, b, 1, 1, 1)
    for k in ("left", "right"):
        batch[k] = batch[k] * scale
    return {k: v.to(device) for k, v in batch.items()}


def _dp_full(torch, port, kernels, card, tmp):
    """Phase 18 (b) -> the launches of both ranks."""
    from temporalstereo_tpu_torch.parallel import TIME_MAJOR_KEYS

    cfg = port.get_cfg(KITTI)
    t, b = len(cfg.DATA.TRAIN.FRAME_IDXS), cfg.DATA.TRAIN.BATCH_SIZE
    h, w = cfg.DATA.TRAIN.HEIGHT, cfg.DATA.TRAIN.WIDTH
    model = port.build_model(cfg, seed=0)
    params, stats = port.master_copies(model)
    digest = _digest(params)
    state = port.TrainState.create(params, stats,
                                   port.build_optimizer(cfg, 1000))
    step = port.make_train_step(model, cfg)
    batch = _dp_full_batch(torch, t, b, h, w, "cuda")
    # one process against itself, and with its samples in another order
    order = list(range(b // 2, b)) + list(range(b // 2))
    shuffled = {k: v[:, order] if k in TIME_MAJOR_KEYS else v[order]
                for k, v in batch.items()}
    runs = [step(state, batch), step(state, batch), step(state, shuffled)]
    single = {"metrics": _floats(runs[0][1]),
              "stats": _cpu(runs[0][0].batch_stats)}

    def loss_gaps(metrics):
        return {k: abs(float(metrics[k]) - v) / abs(v)
                for k, v in single["metrics"].items() if "loss" in k}
    spread = [max(loss_gaps(r[1]).values()) for r in runs[1:]]
    del model, params, stats, state, step, batch, shuffled, runs
    torch.cuda.empty_cache()
    torch.save({"global_batch": b, "steps": DP_FULL_STEPS}, tmp / "full.pt")
    ranks = _run_ranks(torch, tmp, "full")
    if any(r["digest"] != digest for r in ranks):
        raise AssertionError("phase 18 (b): a rank's seeded weights differ "
                             "from this process's")
    if ranks[0]["final"] != ranks[1]["final"]:
        raise AssertionError("phase 18 (b): the ranks' parameters differ "
                             "after the steps")
    gaps = loss_gaps(ranks[0]["metrics"][0])
    stem = {k: v for k, v in single["stats"].items()
            if k.startswith("backbone.bn1.")}
    stem_gap = _max_rel_tree(ranks[0]["stats"], stem)
    # a bias-free convolution's output ahead of a train-mode BatchNorm has
    # a batch mean of exactly 0 in exact arithmetic: rounding noise, floored
    top = max(float(v.abs().max()) for v in single["stats"].values())
    stats_gap = _max_rel_tree(ranks[0]["stats"], single["stats"], 1e-6 * top)
    finite = all(math.isfinite(v) for r in ranks for m in r["metrics"]
                 for v in m.values())
    want = _fit_launches(t, DP_FULL_STEPS, 0, 0)
    log(18, f"(b) two gloo ranks on one card, kitti2015-multi v2s bf16 "
        f"{h}x{w} T={t}, global B={b} ({b // DP_WORLD} a rank, each "
        f"sample's images scaled by 0.4-1.3), {DP_FULL_STEPS} step from seed "
        f"0 against "
        f"one process at B={b}: the stem BatchNorm's running statistics "
        f"{stem_gap:.3g} of their max (tol {DP_STEM_TOL}), every "
        f"statistic {stats_gap:.3g}; first step loss terms "
        f"{max(gaps.values()):.3g} apart "
        f"({({k: float(f'{v:.3g}') for k, v in gaps.items()})}) where one "
        f"process against itself moves them {spread[0]:.3g} and with its "
        f"samples reordered {spread[1]:.3g}; the ranks' parameters "
        f"bit-equal, finite {finite}; gloo-through-host figures (they say "
        f"nothing of NCCL): step ms by rank "
        f"{[[round(1e3 * s, 2) for s in r['step_s']] for r in ranks]}, "
        f"peak GiB by rank {[round(r['peak_gib'], 2) for r in ranks]}, the "
        f"gradient bucket's all-reduce alone ({ranks[0]['bucket_mb']:.1f} "
        f"MB f32) ms by rank {[r['bucket_ms'] for r in ranks]}; launches a "
        f"rank {ranks[0]['launches']} on {card}")
    if (stem_gap > DP_STEM_TOL or not finite
            or any(r["launches"] != want for r in ranks)):
        raise AssertionError(f"phase 18 (b) failed (launches "
                             f"{[r['launches'] for r in ranks]}, want "
                             f"{want} a rank)")
    return _sum_launches(ranks)


def _dp_nccl(torch, port, kernels, card, tmp):
    """Phase 18 (c): world size 1 under NCCL -> the launches of the train
    CLI's --multihost run."""
    import os
    import re

    import torch.distributed as dist

    from temporalstereo_tpu_torch.data.synthetic import write_kitti2015_split
    from temporalstereo_tpu_torch.parallel import (init_distributed,
                                                   make_data_mesh)
    from temporalstereo_tpu_torch.training.checkpoint import (
        CheckpointManager)

    cfg = port.get_cfg(KITTI)
    t, b = len(cfg.DATA.TRAIN.FRAME_IDXS), cfg.DATA.TRAIN.BATCH_SIZE
    h, w = cfg.DATA.TRAIN.HEIGHT, cfg.DATA.TRAIN.WIDTH
    train_ann = write_kitti2015_split(str(tmp / "train"), b, SHORT_WINDOW)
    val_ann = write_kitti2015_split(str(tmp / "val"), DP_VAL_SAMPLES,
                                    SHORT_WINDOW, seed=1)
    opts = ["LOG_DIR", str(tmp / "exps"), "TRAINER.FAST_DEV_RUN", "True",
            "TRAINER.CHECK_VAL_EVERY_N_EPOCHS", "1",
            "DATA.TRAIN.DATA_ROOT", str(tmp / "train"),
            "DATA.TRAIN.ANNFILE", train_ann, *SHORT_WINDOW_OPTS,
            # thread workers for training, as in phase 10
            "DATA.TRAIN.PROCESS_WORKERS", "False"]
    for phase in ("VAL", "TEST"):
        opts += [f"DATA.{phase}.DATA_ROOT", str(tmp / "val"),
                 f"DATA.{phase}.ANNFILE", val_ann]
    env = dict(os.environ, RANK="0", LOCAL_RANK="0", WORLD_SIZE="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "temporalstereo_tpu_torch.cli.train",
         "--multihost", "--config-file", KITTI, *opts],
        cwd=pathlib.Path(__file__).resolve().parent, env=env,
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"cli.train --multihost failed "
                             f"({out.returncode}):\n{out.stdout[-3000:]}\n"
                             f"{out.stderr[-6000:]}")
    cli = _train_summary(out.stdout)
    exp = tmp / "exps" / cfg.TRAINER.NAME / cfg.TRAINER.VERSION
    saved = CheckpointManager(str(exp / "checkpoints")).all_steps()
    tables = re.findall(r"disparity_0/all +([-0-9. ]+)", out.stdout)
    # one step (SWA starts at 0.8 of 16 epochs: not reached), the val and
    # test samples, one image log each
    want = _fit_launches(len(SHORT_WINDOW), 1, 2 * DP_VAL_SAMPLES, 2)
    if (cli["launches"] != want or saved != [1] or len(tables) != 2
            or not all(math.isfinite(float(x)) for row in tables
                       for x in row.split())):
        raise AssertionError(f"cli.train --multihost: launches "
                             f"{cli['launches']} (want {want}), checkpoints "
                             f"{saved}, tables {tables}")
    log(18, f"(c) python -m temporalstereo_tpu_torch.cli.train --multihost "
        f"(RANK 0, WORLD_SIZE 1, NCCL), kitti2015-multi FAST_DEV_RUN "
        f"T={len(SHORT_WINDOW)} on a synthetic KITTI 2015 split ({b} "
        f"train, {DP_VAL_SAMPLES} val "
        f"samples): finite tables, checkpoints {saved}, launches "
        f"{cli['launches']}, step ms {_ms(cli, 'step_s')}, process wall "
        f"{wall:.1f} s")

    os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    try:
        device = init_distributed()
        mesh = make_data_mesh(b, -1, device)
        model = port.build_model(cfg, seed=0)
        params, stats = port.master_copies(model)
        batch = train_batch(torch, t, b, h, w, "cuda")
        plain = port.make_train_step(model, cfg)
        runs = {}
        for name, step in (("plain", plain), ("plain again", plain),
                           ("nccl", port.make_train_step(model, cfg,
                                                         mesh=mesh))):
            state = port.TrainState.create(params, stats,
                                           port.build_optimizer(cfg, 1000))
            metrics, secs = [], []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, batch)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                metrics.append(_floats(m))
            runs[name] = {"metrics": metrics, "secs": secs,
                          "params": state.params}

        def apart(a, b, i):
            """(loss terms' largest relative gap at step i, whether the
            two runs' metrics and parameters after step i are bit-equal)"""
            ma, mb = runs[a]["metrics"][i], runs[b]["metrics"][i]
            gap = max(abs(mb[k] - v) / abs(v) for k, v in ma.items()
                      if "loss" in k)
            same = ma == mb and (i == 0 or all(
                torch.equal(v, runs[b]["params"][k])
                for k, v in runs[a]["params"].items()))
            return gap, same
        first, second = apart("plain", "nccl", 0), apart("plain", "nccl", 1)
        own = apart("plain", "plain again", 1)
        # the NCCL step (the loop's last) once more, profiled
        events = _device_events(lambda: step(state, batch), 1)
        reduce_kernels = [e for e in events if "nccl" in e.name.lower()
                          or "allreduce" in e.name.lower()]
        flat = torch.zeros(sum(p.numel() for p in params.values()),
                           device=device)
        bucket_ms, bucket_events = call_device_ms(
            lambda: dist.all_reduce(flat), 5)
        bucket_wall = cuda_ms(lambda: dist.all_reduce(flat), iters=10)
        log(18, f"(c) in this process: NCCL group of one rank "
            f"(backend {dist.get_backend()}, mesh active {mesh.active}), 2 "
            f"steps of kitti2015-multi B={b} from seed 0, the mesh's step "
            f"against the plain one: first step loss terms {first[0]:.3g} "
            f"apart (tol {DP_NCCL_TOL}), bit-equal {first[1]}; second step "
            f"{second[0]:.3g} apart, bit-equal {second[1]}, where the plain "
            f"step against itself is {own[0]:.3g} apart, bit-equal {own[1]} "
            f"(cuDNN's backward is not deterministic); step ms NCCL "
            f"{[round(1e3 * x, 2) for x in runs['nccl']['secs']]}, plain "
            f"{[round(1e3 * x, 2) for x in runs['plain']['secs']]} and "
            f"{[round(1e3 * x, 2) for x in runs['plain again']['secs']]}, "
            f"phase 6's plain "
            f"{[round(1e3 * x, 2) for x in MEASURED['train_step_s']]}; "
            f"collective kernels in one profiled step: {len(reduce_kernels)} "
            f"(every reduction is the identity at world size 1); the "
            f"gradient bucket ({flat.numel() * 4 / 2 ** 20:.1f} MB f32) "
            f"all-reduced alone through NCCL: {fmt_ms(bucket_ms)} of device "
            f"time in {bucket_events} device events a call, "
            f"{bucket_wall:.4f} ms a call between CUDA events, on {card}")
        if first[0] > DP_NCCL_TOL or reduce_kernels or not all(
                math.isfinite(v) for r in runs.values()
                for m in r["metrics"] for v in m.values()):
            raise AssertionError("phase 18 (c): the NCCL step failed")
        del model, params, stats, batch, runs, state, flat
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR",
                  "MASTER_PORT"):
            os.environ.pop(k, None)
        torch.cuda.empty_cache()
    return cli["launches"]


def phase_data_parallel(torch, port, kernels, card):
    """Phase 18: data parallelism.  (a) two gloo ranks on the one card
    against one process, the tiny model; (b) the same at full width; (c)
    the train CLI with --multihost at world size 1 under NCCL, and the
    mesh's step against the plain one in this process.  -> the launches
    of the three paths."""
    import tempfile

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        tmp = pathlib.Path(tmp)
        launches = (_dp_tiny(torch, port, kernels, tmp),
                    _dp_full(torch, port, kernels, card, tmp),
                    _dp_nccl(torch, port, kernels, card, tmp))
    log(18, f"phase 18 took {time.perf_counter() - t_phase:.1f} s")
    return launches


SP_WORLD = 2
SP_DEADLINE = 300               # seconds for the pair of phase 19 ranks
SP_TINY_TOL = 1e-4              # tests/test_parallel.py's sharded forward
SP_TINY = (2, 96)               # B, H of (a)
SP_TINY_WIDTHS = {"even": 256, "uneven": 224}    # 128 + 128, 128 + 96
# (b) f32, the share of pixels within SP_PX of the unsharded forward.  With
# random weights the forward is well conditioned up to the coarse
# disparity only: the fine and precise stages amplify rounding (on the CPU
# the unsharded forward against itself at 1 and 6 threads moved 1.2% of
# the finest pixels past 1e-2 px, none past 1 px), so the coarsest is
# held within SP_PX; every level's share within SP_PX against the floor
# (one process with cuDNN off against itself with it on) less
# SP_FLOOR_MARGIN; the share in the band of SP_SEAM columns either side of
# each shard bound against the share outside it and against the floor's
# in the same band, less SP_SEAM_MARGIN, and its worst column's share
# against the worst column's outside, less SP_COLUMN_MARGIN (a column wrong
# by any amount drops to 0); and the finest within SP_FLIP_PX
SP_SHARE, SP_PX, SP_FLIP_PX = 0.999, 1e-2, 1.0
SP_FLOOR_MARGIN, SP_SEAM, SP_SEAM_MARGIN = 0.005, 32, 0.02
SP_COLUMN_MARGIN = 0.05
SP_FRAMES = 5                   # (b) bf16 timed frames, after 2 warm ones
KITTI_SINGLE = str(pathlib.Path(__file__).resolve().parent / "configs"
                   / "kitti2015.yaml")


def _sp_frames(torch, run, left, right, frames):
    """(the last disparity, seconds a frame) of ``frames`` synchronised
    calls."""
    secs = []
    for _ in range(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        disp = run(left, right)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return disp, secs


def _sp_tiny(torch, port, kernels, job, mesh):
    """Phase 19 (a) on one rank (or, with no mesh, the unsharded forward):
    the tiny f32 model's disparity for each column layout, with cuDNN on
    and, for the gate, off (both sides then run ATen's own convolutions)."""
    from temporalstereo_tpu_torch.parallel import make_spatial_forward

    model = port.build_model(port.get_cfg(opts=TINY_TRAIN), device="cuda")
    model.load_state_dict(job["tiny_state"])
    model.eval()
    out = {}
    kernels.reset_launches()
    for cudnn in (True, False):
        torch.backends.cudnn.enabled = cudnn
        try:
            for name, width in SP_TINY_WIDTHS.items():
                left, right = (x[:, :, :width].contiguous()
                               for x in job["tiny_images"])
                if mesh is None:
                    with torch.no_grad():
                        disp = model(left.cuda(), right.cuda(),
                                     None)[0]["disps"][0]
                    cols = (0, width)
                else:
                    run = make_spatial_forward(model, mesh)
                    disp = run(left, right)
                    cols = run.columns
                out[(name, cudnn)] = (disp.cpu(), cols)
        finally:
            torch.backends.cudnn.enabled = True
    out["launches"] = dict(kernels.LAUNCHES)
    return out


def _sp_kitti_f32(torch, port, kernels, job, mesh):
    """Phase 19 (b) in f32 (TF32 off) on one rank (or, with no mesh, in one
    process, there also with cuDNN off: the same forward, other rounding):
    every disparity of one frame of configs/kitti2015.yaml from seed 0, on
    this rank's columns."""
    from temporalstereo_tpu_torch.parallel import column_bounds, shard_images
    from temporalstereo_tpu_torch.parallel.spatial import SpatialPlan

    left, right = job["kitti_images"]
    cfg = port.get_cfg(KITTI_SINGLE, opts=["TRAINER.PRECISION", "f32"])
    model = port.build_model(cfg, device="cuda", seed=0)
    model.eval()
    out = {}
    with torch.no_grad():
        kernels.reset_launches()
        if mesh is None:
            out["columns"] = (0, left.shape[2])
            disps = model(left.cuda(), right.cuda(), None)[0]["disps"]
            out["launches"] = dict(kernels.LAUNCHES)
            torch.backends.cudnn.enabled = False
            try:
                out["floor"] = [d.cpu() for d in model(
                    left.cuda(), right.cuda(), None)[0]["disps"]]
            finally:
                torch.backends.cudnn.enabled = True
        else:
            left, right, out["columns"] = shard_images(mesh, left, right)
            plan = SpatialPlan(mesh, column_bounds(
                job["kitti_images"][0].shape[2], mesh.spatial))
            with plan.frame(tuple(left.shape)):
                disps = model(left, right, None)[0]["disps"]
            out["launches"] = dict(kernels.LAUNCHES)
        out["disps"] = [d.cpu() for d in disps]
    del model, disps
    torch.cuda.empty_cache()
    return out


def _sp_kitti(torch, port, kernels, job, mesh):
    """Phase 19 (b) on one rank (or, with no mesh, in one process):
    configs/kitti2015.yaml from seed 0, the f32 frame of
    ``_sp_kitti_f32``, then bf16 frames, 2 warm and SP_FRAMES timed, with
    this rank's peak memory and the launches and exchanges of the timed
    frames."""
    from temporalstereo_tpu_torch.parallel import make_spatial_forward

    out = {"f32": _sp_kitti_f32(torch, port, kernels, job, mesh)}
    left, right = (x.cuda() for x in job["kitti_images"])
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = port.build_model(port.get_cfg(KITTI_SINGLE), device="cuda",
                             seed=0)
    model.eval()
    if mesh is None:
        def run(l, r):
            with torch.no_grad():
                return model(l, r, None)[0]["disps"][0]
    else:
        run = make_spatial_forward(model, mesh)
    _sp_frames(torch, run, left, right, 2)
    kernels.reset_launches()
    disp, secs = _sp_frames(torch, run, left, right, SP_FRAMES)
    out["bf16"] = {
        "disp": disp.float().cpu(), "secs": secs,
        "launches": dict(kernels.LAUNCHES),
        "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
        "columns": getattr(run, "columns", (0, left.shape[2])),
        "stats": dict(getattr(run, "stats", {}))}
    del model, run
    return out


def _sp_rank(rank, world, port_no, directory):
    """One rank of phase 19, a spawned process: joins a gloo group on the
    one card (NCCL refuses two ranks on one device), runs (a) and (b) on
    its columns and saves what it computed under ``directory``."""
    import datetime
    import os

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port_no))
    import torch
    import torch.distributed as dist

    import temporalstereo_tpu_torch as port
    from temporalstereo_tpu_torch import kernels
    from temporalstereo_tpu_torch.parallel import (init_distributed,
                                                   make_2d_mesh)

    directory = pathlib.Path(directory)
    # the host's part of a rank is its staging copies: one thread each
    # keeps two ranks' thread pools from spinning against each other
    torch.set_num_threads(1)
    device = init_distributed("cuda:0", backend="gloo",
                              timeout=datetime.timedelta(seconds=120))
    try:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        job = torch.load(directory / "spatial.pt", weights_only=False)
        mesh = make_2d_mesh(1, world, device)
        out = {"backend": dist.get_backend(), "active": mesh.active,
               "tiny": _sp_tiny(torch, port, kernels, job, mesh),
               "kitti": _sp_kitti(torch, port, kernels, job, mesh)}
        torch.save(out, directory / f"spatial_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _sp_run_ranks(torch, directory):
    """Phase 19's two ranks -> what each computed; both killed at the
    deadline, and any rank's failure fails the phase."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    port_no = _free_port()
    procs = [ctx.Process(target=_sp_rank,
                         args=(r, SP_WORLD, port_no, str(directory)))
             for r in range(SP_WORLD)]
    for p in procs:
        p.start()
    t_end = time.time() + SP_DEADLINE
    try:
        for p in procs:
            p.join(max(t_end - time.time(), 1))
    finally:
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if late:
        raise AssertionError(f"phase 19: ranks {late} passed their "
                             f"{SP_DEADLINE} s deadline")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise AssertionError(f"phase 19: rank exit codes {codes}")
    return [torch.load(directory / f"spatial_rank{r}.pt", weights_only=False)
            for r in range(SP_WORLD)]


def _px_gaps(torch, ours, ref):
    """(max |d| px, share within SP_PX, pixels past SP_FLIP_PX)."""
    diff = (ours.float() - ref.float()).abs()
    return (float(f"{float(diff.max()):.4g}"),
            float(f"{float((diff <= SP_PX).float().mean()):.6f}"),
            int((diff > SP_FLIP_PX).sum()))


def _px_share(ours, ref, cols, worst=False):
    """The share of pixels within SP_PX over the columns ``cols`` (a mask
    of the W axis), or with ``worst`` the least such share of one
    column."""
    near = ((ours.float() - ref.float()).abs()[:, :, cols] <= SP_PX).float()
    share = near.mean((0, 1, 3)).min() if worst else near.mean()
    return float(f"{float(share):.6f}")


def _sp_levels(torch, disps, one, seams, width):
    """Every disparity (finest first) of a sharded frame against one
    process's: _px_gaps of it and of the floor (one process with cuDNN off
    against itself with it on), and the shares within SP_PX (sharded in the
    band of SP_SEAM columns either side of each seam, sharded outside it,
    floor in it; then the worst column's, sharded in and out).  ``seams``:
    the image's inner column bounds, of ``width``."""
    levels = []
    for i, (ours, ref) in enumerate(zip(disps, one["disps"])):
        if ours.shape != ref.shape:
            raise AssertionError(f"phase 19 (b): disparity {i} of shape "
                                 f"{tuple(ours.shape)}, want {tuple(ref.shape)}")
        floor = one["floor"][i]
        wl = ref.shape[2]
        cols = torch.arange(wl)
        band = torch.zeros(wl, dtype=torch.bool)
        for b in seams:
            c = -(-b * wl // width)
            band |= (cols >= c - SP_SEAM) & (cols < c + SP_SEAM)
        levels.append({"sharded": _px_gaps(torch, ours, ref),
                       "cudnn_off": _px_gaps(torch, floor, ref),
                       "seam_band": (_px_share(ours, ref, band),
                                     _px_share(ours, ref, ~band),
                                     _px_share(floor, ref, band),
                                     _px_share(ours, ref, band, True),
                                     _px_share(ours, ref, ~band, True)),
                       "max": float(ref.abs().max())})
    return levels


def _sp_gate(levels):
    """The phase 19 (b) f32 gates that ``levels`` (``_sp_levels``) fail."""
    n = levels[0]["pixels"]
    bad = []
    if levels[-1]["sharded"][1] < SP_SHARE:
        bad.append(f"the coarsest's share within {SP_PX} px")
    if levels[0]["sharded"][2] > (1 - SP_SHARE) * n:
        bad.append(f"the finest's pixels past {SP_FLIP_PX} px")
    for i, lv in enumerate(levels):
        if lv["sharded"][1] < lv["cudnn_off"][1] - SP_FLOOR_MARGIN:
            bad.append(f"level {i} under the floor")
        band, out, floor_band, band_col, out_col = lv["seam_band"]
        if (band < min(out, floor_band) - SP_SEAM_MARGIN
                or band_col < out_col - SP_COLUMN_MARGIN):
            bad.append(f"level {i} at the seams")
    return bad


def _stitch(torch, parts):
    """The whole frame from (slice, (x0, x1)) pairs."""
    return torch.cat([d for d, _ in sorted(parts, key=lambda p: p[1][0])],
                     dim=2)


def _sp_nccl(torch, port, kernels, card, job):
    """Phase 19 (c): a spatial size of 1 under NCCL in this process ->
    its launches."""
    import os

    import torch.distributed as dist

    from temporalstereo_tpu_torch.parallel import (init_distributed,
                                                   make_2d_mesh,
                                                   make_spatial_forward)

    os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    try:
        device = init_distributed()
        mesh = make_2d_mesh(1, 1, device)
        model = port.build_model(port.get_cfg(KITTI_SINGLE), device="cuda",
                                 seed=0)
        left, right = job["kitti_images"]
        run = make_spatial_forward(model, mesh)
        with torch.no_grad():
            plain = model(left.cuda(), right.cuda(), None)[0]["disps"][0]
        kernels.reset_launches()
        ours = run(left, right)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        events = _device_events(lambda: run(left, right), 1)
        collectives = [e.name for e in events if "nccl" in e.name.lower()
                       or "allreduce" in e.name.lower()]
        same = torch.equal(ours, plain)
        log(19, f"(c) spatial size 1 under NCCL (backend "
            f"{dist.get_backend()}, mesh active {mesh.active}), "
            f"kitti2015.yaml bf16 384x1248: bit-equal to the plain forward "
            f"{same}; {len(events)} device events a frame, collective "
            f"kernels {len(collectives)}; launches {launches} on {card}")
        if not same or collectives or launches["fused_cost_base"] != 2:
            raise AssertionError("phase 19 (c): the spatial size-1 forward "
                                 "is not the plain one")
        del model, plain, ours
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR",
                  "MASTER_PORT"):
            os.environ.pop(k, None)
        torch.cuda.empty_cache()
    return launches


def phase_spatial(torch, port, kernels, card):
    """Phase 19: W-axis spatial sharding.  (a) the tiny f32 model on two
    gloo ranks against the unsharded forward on the card; (b)
    configs/kitti2015.yaml at full width, f32 then bf16, against one
    process; (c) a spatial size of 1 under NCCL.  -> the launches of the
    paths."""
    import tempfile

    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    b, h = SP_TINY
    w = max(SP_TINY_WIDTHS.values())
    tiny = port.build_model(port.get_cfg(opts=TINY_TRAIN), device="cpu",
                            seed=3)
    randomize_weights(torch, tiny, seed=43)
    g = torch.Generator().manual_seed(19)
    job = {"tiny_state": tiny.state_dict(),
           "tiny_images": [torch.rand((b, h, w, 3), generator=g)
                           for _ in range(2)],
           "kitti_images": [torch.rand((1, 384, 1248, 3), generator=g)
                            for _ in range(2)]}
    single_tiny = _sp_tiny(torch, port, kernels, job, None)
    single = _sp_kitti(torch, port, kernels, job, None)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sp_") as tmp:
        tmp = pathlib.Path(tmp)
        torch.save(job, tmp / "spatial.pt")
        ranks = _sp_run_ranks(torch, tmp)
    if {r["backend"] for r in ranks} != {"gloo"} or not all(
            r["active"] for r in ranks):
        raise AssertionError("phase 19: the ranks are not an active gloo row")

    # (a)
    gaps = {}
    for key in single_tiny:
        if key == "launches":
            continue
        ours = _stitch(torch, [r["tiny"][key] for r in ranks])
        gaps[key] = float((ours - single_tiny[key][0]).abs().max())
    top = max(float(v[0].abs().max()) for k, v in single_tiny.items()
              if k != "launches")
    tiny_launches = _sum_launches([r["tiny"] for r in ranks])
    log(19, f"(a) two gloo ranks on one card, tiny f32 {b}x{h}x"
        f"{SP_TINY_WIDTHS}, TF32 "
        f"off, W-sharded against the unsharded forward on the card (max "
        f"|disparity| {top:.4g}): max|d| by (shards, cuDNN) "
        f"{({f'{k[0]}, cudnn {k[1]}': float(f'{v:.3g}') for k, v in gaps.items()})}"
        f" (tol {SP_TINY_TOL} with cuDNN off, where both sides run the same "
        f"convolution code; with cuDNN on each shape may take its own "
        f"algorithm); columns {[r['tiny'][('uneven', True)][1] for r in ranks]}"
        f" uneven; launches over both ranks {tiny_launches}")
    if any(v > SP_TINY_TOL for k, v in gaps.items() if not k[1]):
        raise AssertionError("phase 19 (a): the sharded tiny forward is off")

    # (b) f32, finest disparity first
    one = single["f32"]
    f32 = [r["kitti"]["f32"] for r in ranks]
    width = one["disps"][0].shape[2]
    seams = sorted({x["columns"][0] for x in f32} - {0})
    disps = [_stitch(torch, [(x["disps"][i], x["columns"]) for x in f32])
             for i in range(len(one["disps"]))]
    levels = _sp_levels(torch, disps, one, seams, width)
    levels[0]["pixels"] = n = disps[0].numel()
    # the gate must see a column wrong by 1 px at each seam
    planted = [d.clone() for d in disps]
    for b in seams:
        planted[0][:, :, b] += 1.0
    planted = _sp_levels(torch, planted, one, seams, width)
    planted[0]["pixels"] = n
    f32_launches = _sum_launches(f32)
    fails, planted_fails = _sp_gate(levels), _sp_gate(planted)
    log(19, f"(b) kitti2015.yaml v2s 384x1248 B=1 seed 0, f32 TF32 off, two "
        f"gloo ranks of columns {[x['columns'] for x in f32]} against one "
        f"process, each disparity (finest first) as sharded and cudnn_off "
        f"(one process with cuDNN off against itself with it on, rounding "
        f"alone): (max|d| px, share within {SP_PX} px, pixels past "
        f"{SP_FLIP_PX} px of {n}), seam_band: share within {SP_PX} px "
        f"within {SP_SEAM} columns of the seams {seams} (sharded in, "
        f"sharded out, cudnn_off in, then the worst column's share in and "
        f"out): {levels}; gates: the coarsest's "
        f"share >= {SP_SHARE}, the finest's within {SP_FLIP_PX} px >= "
        f"{SP_SHARE}, each level's share >= cudnn_off's - "
        f"{SP_FLOOR_MARGIN}, its band's >= min(out, cudnn_off in) - "
        f"{SP_SEAM_MARGIN} and its worst column's in >= out - "
        f"{SP_COLUMN_MARGIN}: failed {fails}; with the finest's seam "
        f"column{'s' * (len(seams) > 1)} planted 1 px off: band "
        f"{planted[0]['seam_band']}, failed {planted_fails}; launches "
        f"over both ranks {f32_launches}")
    if fails:
        raise AssertionError(f"phase 19 (b): the sharded f32 forward is off"
                             f" ({fails})")
    if "level 0 at the seams" not in planted_fails:
        raise AssertionError("phase 19 (b): the seam gate passes a planted "
                             "fault")

    # (b) bf16
    bf = [r["kitti"]["bf16"] for r in ranks]
    one = single["bf16"]
    med = (lambda xs: sorted(xs)[len(xs) // 2] * 1e3)
    finite = all(bool(torch.isfinite(x["disp"]).all()) for x in bf)
    want = {"fused_cost_base": 2 * SP_FRAMES}
    log(19, f"(b) bf16, {SP_FRAMES} frames after 2 warm: frame ms by rank "
        f"{[[round(1e3 * s, 2) for s in x['secs']] for x in bf]} (median "
        f"{[round(med(x['secs']), 2) for x in bf]}) against one process's "
        f"{[round(1e3 * s, 2) for s in one['secs']]} (median "
        f"{med(one['secs']):.2f}); peak GiB above the start by rank "
        f"{[round(x['peak_gib'], 3) for x in bf]} against one process's "
        f"{one['peak_gib']:.3f}; a frame's collectives by rank "
        f"{[x['stats'] for x in bf]}; launches a rank "
        f"{[x['launches'] for x in bf]} (one process {one['launches']}); "
        f"finite {finite}; gloo through the host on one shared card, on "
        f"{card}")
    bad = [x["launches"] for x in bf
           if any(x["launches"][k] != v for k, v in want.items())]
    if bad or not finite:
        raise AssertionError(f"phase 19 (b) bf16: launches {bad}, finite "
                             f"{finite}")
    launches = (tiny_launches, f32_launches, _sum_launches(bf),
                _sp_nccl(torch, port, kernels, card, job))
    log(19, f"phase 19 took {time.perf_counter() - t_phase:.1f} s")
    return launches


ORBAX_FIXTURE = "tests/data/orbax_fixture"
ORBAX_SCRIPT = "scripts/make_orbax_fixture.py"


def phase_orbax():
    """Phase 20: the JAX package's orbax checkpoints read without orbax,
    tensorstore, JAX or a zstd module (none is imported; the phase prints
    which are installed): the zstd decoder built with g++, then the
    committed fixture (tests/data/orbax_fixture, written by
    scripts/make_orbax_fixture.py with the JAX package's
    CheckpointManager) read by utils/orbax.py, every leaf bit-equal to the
    script's numpy regeneration from its seed."""
    import importlib.util

    from temporalstereo_tpu_torch.utils import orbax, zstd

    repo = pathlib.Path(__file__).resolve().parent
    t_phase = time.perf_counter()
    installed = [m for m in ("orbax", "tensorstore", "zstandard", "jax")
                 if importlib.util.find_spec(m) is not None]
    zstd.library()
    spec = importlib.util.spec_from_file_location("make_orbax_fixture",
                                                  repo / ORBAX_SCRIPT)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    want = script.fixture_tree()
    t0 = time.perf_counter()
    got = orbax.read_checkpoint(repo / ORBAX_FIXTURE)
    read_s = time.perf_counter() - t0
    hparams = orbax.load_hparams(repo / ORBAX_FIXTURE)
    got_flat, want_flat = _leaves(got), _leaves(want)
    unequal = [i for i, (a, b) in enumerate(zip(got_flat, want_flat))
               if type(a) is not type(b) or a.dtype != b.dtype
               or a.shape != b.shape or a.tobytes() != b.tobytes()]
    loaded = sorted(m for m in ("orbax", "tensorstore", "zstandard", "jax")
                    if m in sys.modules)
    nbytes = sum(v.nbytes for v in got_flat)
    log(20, f"orbax fixture {ORBAX_FIXTURE} (step "
        f"{orbax.latest_step(repo / ORBAX_FIXTURE)}, hparams {hparams}): "
        f"zstd decoder g++ build {zstd.BUILD['seconds']:.2f} s (built "
        f"{zstd.BUILD['built']}); read {len(got_flat)} leaves, {nbytes} "
        f"bytes, in {1e3 * read_s:.1f} ms; leaves unequal to the seed's "
        f"regeneration {unequal}; opt_state's empty tuple "
        f"{got['opt_state'][2]!r}; of orbax, tensorstore, zstandard and jax "
        f"installed here {installed}, imported {loaded}; phase 20 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    if (unequal or len(got_flat) != len(want_flat) or loaded
            or got["opt_state"][2] != () or hparams is None
            or sorted(got) != sorted(want)):
        raise AssertionError(f"phase 20: the fixture read back wrong "
                             f"({unequal}, imported {loaded})")


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
    "softsplat_backward": (
        "softsplat_backward.cu", "temporalstereo_tpu/ops/pallas/splat.py:104",
        "the splat's whole vjp at the training step's temporal update "
        "(softmax, rigid flow), one launch"),
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

    t_start = time.perf_counter()

    # --only=3,19: a development run of phases 1, 2 and those named (3, 8,
    # 19, 20); it prints no kernels line and no result line
    only = next((set(a.split("=", 1)[1].split(","))
                 for a in sys.argv[1:] if a.startswith("--only=")), None)

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
    from temporalstereo_tpu_torch.data import native

    native_info = native.build()
    log(2, f"native data library {pathlib.Path(native_info['path']).name}: "
        f"built {native_info['built']} in {native_info['seconds']:.2f} s")
    for name, text in info["log"].items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(2, f"  {name}: {line.strip()}")

    seconds = {}

    def timed(phase, fn, *args):
        """fn(*args), its seconds added to the phase's."""
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            seconds[phase] = round(seconds.get(phase, 0.0)
                                   + time.perf_counter() - t0, 1)

    def kernel_phases():
        detail = phase_kernels(torch, kernels)
        phase_splat(torch, kernels, detail)
        splat_grad = phase_splat_backward(torch, kernels, detail)
        phase_train_kernels(torch, kernels, detail)
        phase_offset_kernels(torch, kernels, detail)
        phase_shift_cases(torch, kernels, detail)
        return detail, splat_grad

    if only is not None:
        if "3" in only:
            timed(3, kernel_phases)
        if "8" in only:
            timed(8, phase_marks, torch, port, card)
            timed(8, phase_serving, torch, port, kernels, card)
        if "19" in only:
            timed(19, phase_spatial, torch, port, kernels, card)
        if "20" in only:
            timed(20, phase_orbax)
        log(21, f"phase seconds {seconds}")
        print(f"chip_smoke: partial run of phases 1, 2, {sorted(only)}",
              flush=True)
        return 0
    detail, splat_grad = timed(3, kernel_phases)
    launches = {"splat_grad": splat_grad}
    timed(4, phase_card_vs_cpu, torch, port)
    timed(4, phase_train_card_vs_cpu, torch, port)
    launches["stream"] = timed(5, phase_flagship, torch, port, kernels, card)
    launches["train"] = timed(6, phase_flagship_train, torch, port, kernels,
                              card)
    launches["train_block_cost_scale_0"] = timed(
        7, phase_no_pyramid_train, torch, port, kernels)
    launches["stream_graphs"] = timed(8, phase_serving, torch, port, kernels,
                                      card)
    timed(8, phase_cli, torch, port, card)
    timed(8, phase_marks, torch, port, card)
    launches["eval"] = timed(9, phase_eval, torch, port, kernels, card)
    launches["fit"], launches["fit_resume"] = timed(
        10, phase_fit, torch, port, kernels, card)
    launches["demo"] = timed(11, phase_demo, torch, port, kernels, card)
    launches["benchmark_ops"], launches["profile_step"] = timed(
        12, phase_tools, card)
    launches["remat_t3"], launches["remat_t11"] = timed(
        13, phase_remat, torch, port, kernels, card)
    timed(14, phase_planner, torch, port, card)
    (launches["norms_stream"], launches["norms_bundle"],
     launches["norms_train"]) = timed(15, phase_norms, torch, port, kernels,
                                      card)
    launches["surface"] = timed(16, phase_surface, torch, port, kernels, card)
    launches["eval_native"] = timed(17, phase_native, torch, port, kernels,
                                    card, native_info)
    (launches["train_dp_gloo2"], launches["train_dp_gloo2_full"],
     launches["fit_multihost"]) = timed(18, phase_data_parallel, torch, port,
                                        kernels, card)
    (launches["spatial_tiny_gloo2"], launches["spatial_kitti_gloo2_f32"],
     launches["spatial_kitti_gloo2_bf16"],
     launches["spatial_nccl1"]) = timed(19, phase_spatial, torch, port,
                                        kernels, card)
    timed(20, phase_orbax)
    log(21, f"phase seconds {seconds}")
    log(21, f"chip_smoke took {time.perf_counter() - t_start:.1f} s on "
        f"{card}")
    print(kernels_line(detail, launches), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
