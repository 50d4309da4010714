"""The shift forward kernel's launch plans, and where its time goes.

    python3 scripts/port_shift_forward_sweep.py [--parent DIR]

Times ``csrc/shift_1d.cu``'s forward on the card (torch.profiler, the
kernel's own device time over 20 launches) at the shapes the port gives it,
bf16 and f32:
  train fine / precise   the BLOCK_COST_SCALE 0 training step's stages,
                         img [4,1,40,148,128] (D 8), [4,1,80,296,128] (D 5)
  offset fine / precise  rank 1 of 2 of the W-sharded stream: out
                         [1,8,48,76,128] from a 156-wide img, [1,5,96,152,128]
                         from 312 (x0 = 80, 160)
  stream fine / precise  the unsharded stream's [1,8,48,156,128],
                         [1,5,96,312,128]
  Di=D                   a non-broadcast img [4,8,40,148,128]
For each: the wrapper's plan (kernels/launches.py:shift_forward_plan);
every plan of 1, 2, 4 or 8 channel slices and each block of hypotheses that
fits; builds with the img row's staging copies removed (no_stage) and with
the output stores removed (no_store), source patches compiled into
kernels/_build/shift_sweep/ whose outputs are wrong by design; and two
yardsticks on the output's bytes, torch's fill (one write) and copy (one
read, one write).  ``--parent DIR``: also the forward of DIR's
``temporalstereo_tpu_torch/kernels/csrc`` (another checkout, e.g. the parent
commit unpacked with ``git archive``), timed in turns with this one, and
the SASS instruction counts of both forwards (``cuobjdump -sass``).
Prints the card's name and power limit, a line per shape and type, and one
JSON line.  Needs one CUDA card and nvcc.
"""
import ctypes
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from temporalstereo_tpu_torch.kernels import build  # noqa: E402
from temporalstereo_tpu_torch.kernels.launches import (  # noqa: E402
    MAX_SHARED, shift_forward_plan)

OUT = build.BUILD_DIR / "shift_sweep"
HBM_BYTES_PER_S = 3.35e12
# name: (B, Di, H, Wt, W, C, D, x0)
SHAPES = {"train fine": (4, 1, 40, 148, 148, 128, 8, 0),
          "train precise": (4, 1, 80, 296, 296, 128, 5, 0),
          "offset fine": (1, 1, 48, 156, 76, 128, 8, 80),
          "offset precise": (1, 1, 96, 312, 152, 128, 5, 160),
          "stream fine": (1, 1, 48, 156, 156, 128, 8, 0),
          "stream precise": (1, 1, 96, 312, 312, 128, 5, 0),
          "Di=D": (4, 8, 40, 148, 148, 128, 8, 0)}
VARIANTS = {
    "no_stage": [("tsk::cp16(row + t * Cs + tx * V, src + t * C);", "{}")],
    "no_store": [("      if (d[u] < dn) storev<V>(",
                  "      if (d[u] < dn && o[u][0] == 1234.5f) storev<V>(")],
}
C_TYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int}


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def forward_params(src):
    """The parameter names of ``shift_1d_forward`` in ``src``."""
    sig = re.search(r'extern "C" int shift_1d_forward\(([^)]*)\)',
                    src.read_text()).group(1)
    return [p.replace("*", " * ").split() for p in sig.split(",")]


def compile_all(sources):
    """{name: csrc directory} -> {name: (library, nvcc output)}, compiled
    in parallel."""
    procs = {}
    for name, src in sources.items():
        lib = OUT / f"lib{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               str(lib), str(src / "shift_1d.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        libs[name] = (lib, out + err)
    return libs


def sources(parent):
    srcs = {}
    for name, edits in VARIANTS.items():
        dst = OUT / name
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(build.CSRC, dst)
        text = (dst / "shift_1d.cu").read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the patch anchor {old!r} is not "
                                   "in shift_1d.cu")
            text = text.replace(old, new)
        (dst / "shift_1d.cu").write_text(text)
        srcs[name] = dst
    srcs["base"] = build.CSRC
    if parent is not None:
        srcs["parent"] = (pathlib.Path(parent) / "temporalstereo_tpu_torch"
                          / "kernels" / "csrc")
    return srcs


def entry(lib, params):
    fn = ctypes.CDLL(str(lib)).shift_1d_forward
    fn.argtypes = [C_TYPES["void*" if "*" in p else p[0]] for p in params]
    fn.restype = ctypes.c_int
    return fn


def sass_counts(lib):
    """{forward kernel instantiation: (instructions, CALLs)}."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts = {}
    for block in text.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        if "forward" in name:
            ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\w*)",
                             block)
            counts[name[-40:]] = (len(ops), ops.count("CALL"))
    return counts


def launcher(fn, planned, img, shift, x0, plan):
    b, d, h, w = shift.shape
    di, wt, c = img.shape[1], img.shape[3], img.shape[4]
    out = torch.empty((b, d, h, w, c), dtype=img.dtype, device=img.device)
    stream = torch.cuda.current_stream().cuda_stream
    args = ((img.data_ptr(), shift.data_ptr(), out.data_ptr(), b, d, di, h,
             w, c, x0, 0, wt) + (tuple(plan) if planned else ())
            + (0 if img.dtype == torch.float32 else 1, 0, stream))

    def call():
        err = fn(*args)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}, plan {plan}")
    return call


def device_ms(fn, name=None, iters=20):
    """Device ms per call: the kernels whose name holds ``name`` (every
    device event if None)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and (name is None or name in e.name)]
    if not hits:
        return None
    return sum(e.time_range.elapsed_us() for e in hits) / iters / 1e3


def fmt(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def plans(wt, w, c, hyp, size):
    for slices in (1, 2, 4, 8):
        for per in sorted({-(-hyp // n) for n in range(1, hyp + 1)}):
            shared = -(-wt * (c // slices) * size // 16) * 16 + 4 * per * w
            if shared <= MAX_SHARED:
                yield slices, per, shared


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    parent = (sys.argv[sys.argv.index("--parent") + 1]
              if "--parent" in sys.argv else None)
    line = card()
    print(line, flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    srcs = sources(parent)
    libs = compile_all(srcs)
    fns = {name: (entry(lib, forward_params(srcs[name] / "shift_1d.cu")),
                  any("slices" in p for p in forward_params(
                      srcs[name] / "shift_1d.cu")))
           for name, (lib, _) in libs.items()}
    result = {"card": line, "rows": []}
    if parent is not None:
        result["sass"] = {name: sass_counts(libs[name][0])
                          for name in ("parent", "base")}
        print(f"SASS forward (instructions, CALLs): {result['sass']}",
              flush=True)
    g = torch.Generator(device="cuda").manual_seed(17)
    kernel = "shift_1d_forward_kernel"
    for name, (b, di, h, wt, w, c, d, x0) in SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            size = torch.empty((), dtype=dtype).element_size()
            img = torch.randn((b, di, h, wt, c), generator=g,
                              device="cuda").to(dtype)
            shift = -(torch.rand((b, d, h, w), generator=g, device="cuda")
                      * (wt + 8.0) - 4.0)
            hyp = d if di == 1 else 1
            plan = shift_forward_plan(wt, w, c, hyp, size, b * di * h)
            nbytes = (img.numel() * size + shift.numel() * 4
                      + shift.numel() * c * size)
            row = {"shape": name, "dtype": str(dtype).split(".")[-1],
                   "out": [b, d, h, w, c], "img_width": wt, "plan": plan,
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}

            def run(variant, p=plan):
                fn, planned = fns[variant]
                return device_ms(launcher(fn, planned, img, shift, x0, p),
                                 kernel)
            order = ["parent", "base", "base", "parent"] if parent else \
                ["base", "base"]
            times = {}
            for variant in order:
                times.setdefault(variant, []).append(run(variant))
            row.update({f"{k}_ms": v for k, v in times.items()})
            for variant in VARIANTS:
                row[f"{variant}_ms"] = run(variant)
            out = torch.empty((b, d, h, w, c), dtype=dtype, device="cuda")
            out2 = torch.empty_like(out)
            row["fill_ms"] = device_ms(lambda: out.fill_(1.0))
            row["copy_ms"] = device_ms(lambda: out2.copy_(out))
            row["sweep"] = [[s, p, sh, run("base", (s, p, sh))]
                            for s, p, sh in plans(wt, w, c, hyp, size)]
            best = min(row["sweep"], key=lambda r: r[3] or 1e9)
            base = min((t for t in row["base_ms"] if t), default=None)
            share = f"{row['bound_ms'] / base:.0%}" if base else "-"
            print(f"{name} {row['dtype']} out {row['out']} img width {wt}: "
                  f"plan {plan} {fmt(base)} ms ({share} of the bound "
                  f"{row['bound_ms']:.4f})"
                  + (f", parent {row['parent_ms']}" if parent else "")
                  + f"; no_stage {fmt(row['no_stage_ms'])} no_store "
                  f"{fmt(row['no_store_ms'])}; fill {fmt(row['fill_ms'])} "
                  f"copy {fmt(row['copy_ms'])}; best plan {best[:2]} "
                  f"{fmt(best[3])}; plans " + " ".join(
                      f"{s}/{p}:{fmt(t)}" for s, p, _, t in row["sweep"]),
                  flush=True)
            result["rows"].append(row)
            del img, shift, out, out2
            torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
