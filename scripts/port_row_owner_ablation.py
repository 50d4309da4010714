"""Where the time of the port's row-owner backward kernels goes.

    python3 scripts/port_row_owner_ablation.py [cost|shift ...]

Builds variants of ``temporalstereo_tpu_torch/kernels/csrc`` with parts of
the walk switched off (a source patch each, into kernels/_build/ablation/),
and times each variant's backward kernel on the card at the two training
shapes of configs/kitti2015-multi.yaml (bf16, uniform hypotheses; CUDA
events, median of 5 batches of 20 launches).  A variant's outputs are
wrong by design: it measures what a part costs, nothing else.
  base      the kernel as it is
  no_fill   nothing staged into the ring (no global loads in the walk)
  no_owner  the owner stage's accumulator adds skipped
  no_gref   (cost base) no grad_ref stores
  ring3     a ring of 3 steps instead of 4
  nothing   neither staging nor adding: the row's prologue and epilogue
Prints the card's name and power limit, then one JSON line per kernel.
Needs one CUDA card and nvcc.
"""
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from temporalstereo_tpu_torch.kernels import build  # noqa: E402
from temporalstereo_tpu_torch.kernels import cost, shift  # noqa: E402
from temporalstereo_tpu_torch.kernels.launches import PAIRS, row_plan  # noqa: E402

OUT = build.BUILD_DIR / "ablation"
SOURCES = {"cost": "fused_cost_base_backward.cu", "shift": "shift_1d.cu"}
SHAPES = {"fine": (4, 40, 148, 128, 8), "precise": (4, 80, 296, 128, 5)}
WALK = "row_owner.cuh"
COMMON = {
    "no_fill": {WALK: [("    if (f < steps) fill(f * PAIRS",
                        "    if (f < 0) fill(f * PAIRS")]},
    "no_owner": {WALK: [("    add_taps<4>(col, off, c);",
                         "    if (c[0] == 12345.f) add_taps<4>(col, off, c);")]},
    "ring3": {WALK: [("constexpr int RING = 4;", "constexpr int RING = 3;")]},
    "nothing": {WALK: [("    if (f < steps) fill(f * PAIRS",
                        "    if (f < 0) fill(f * PAIRS"),
                       ("    own(k * PAIRS, slot(k), k & 1);",
                        "    if (n < 0) own(k * PAIRS, slot(k), k & 1);"),
                       ("    produce((k + 1) * PAIRS, (k + 1) & 1);",
                        "    if (n < 0) produce((k + 1) * PAIRS, (k + 1) & 1);")]},
}
NO_GREF = {"fused_cost_base_backward.cu": [
    ("tsk::store_if(grad_ref_col + xs[k] * C, gout[k], last[k]);",
     "tsk::store_if(grad_ref_col + xs[k] * C, gout[k], last[k] && W < 0);")]}


def variants(kernel):
    out = {"base": {}, **COMMON}
    if kernel == "cost":
        out["no_gref"] = NO_GREF
    return out


def build_all(kernel):
    """Patch and compile every variant, in parallel -> {name: library}."""
    procs = {}
    for name, patches in variants(kernel).items():
        src = OUT / kernel / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(build.CSRC, src)
        for fname, edits in patches.items():
            path = src / fname
            text = path.read_text()
            for old, new in edits:
                if old not in text:
                    raise RuntimeError(f"{name}: the patch anchor {old!r} is "
                                       f"not in {fname}")
                text = text.replace(old, new)
            path.write_text(text)
        lib = src / "lib.so"
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
             str(src / SOURCES[kernel])]), lib)
    for name, (proc, _) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {kernel} {name}")
    return {name: lib for name, (_, lib) in procs.items()}


def shared_bytes(kernel, name, c, w, pairs):
    ring, stage = ((cost._RING_ELEMS, cost._stage_bytes(2)) if kernel == "cost"
                   else (shift._RING_ELEMS, shift._STAGE_BYTES))
    slices, smem = row_plan(c, w, pairs, ring, 2, stage)
    if name == "ring3":   # one step of PAIRS pairs less in the ring
        smem -= PAIRS * ring * 2
    return slices, smem


def ms(fn, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return sorted(times)[2]


def time_kernel(kernel, libs):
    g = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    dev = "cuda"
    rows = {}
    for stage, (b, h, w, c, d) in SHAPES.items():
        disp = (torch.rand((b, d, h, w), generator=g, device=dev) * (w + 8.0)
                - 4.0)
        if kernel == "cost":
            ref = torch.randn((b, h, w, c), generator=g, device=dev).bfloat16()
            tgt = torch.randn((b, h, w, c), generator=g, device=dev).bfloat16()
            go = torch.randn((b, d, h, w, 2 * c + c // 8), generator=g,
                             device=dev).bfloat16()
            outs = [torch.empty_like(ref), torch.empty_like(tgt),
                    torch.empty_like(disp)]
            ptrs = [go, ref, tgt, disp, *outs]
            dims = [b, d, h, w, c]
        else:
            img = torch.randn((b, 1, h, w, c), generator=g,
                              device=dev).bfloat16()
            go = torch.randn((b, d, h, w, c), generator=g,
                             device=dev).bfloat16()
            neg = -disp
            outs = [torch.empty_like(img), torch.empty_like(disp)]
            ptrs = [go, img, neg, *outs]
            dims = [b, d, 1, h, w, c]
        for name, lib in libs.items():
            fn = getattr(ctypes.CDLL(str(lib)),
                         "fused_cost_base_backward" if kernel == "cost"
                         else "shift_1d_backward")
            fn.argtypes = ([ctypes.c_void_p] * len(ptrs)
                           + [ctypes.c_int] * (len(dims) + 4)
                           + [ctypes.c_void_p])
            slices, smem = shared_bytes(kernel, name, c, w, d * w)
            args = ([t.data_ptr() for t in ptrs] + dims
                    + [slices, smem, 1, 0, stream])

            def call():
                err = fn(*args)
                if err:
                    raise RuntimeError(f"{kernel} {name}: CUDA error {err}")
            rows.setdefault(name, {})[stage] = ms(call)
    return rows


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for kernel in sys.argv[1:] or ["cost", "shift"]:
        rows = time_kernel(kernel, build_all(kernel))
        print(json.dumps({"kernel": kernel, "dtype": "bfloat16",
                          "ms": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
