"""Where the time of the port's one-launch softsplat kernel goes.

    python3 scripts/port_splat_phases.py

Builds a copy of ``temporalstereo_tpu_torch/kernels/csrc/softsplat.cu``
with a clock64() stamp by thread 0 of every block at each step boundary
(a source patch, into kernels/_build/phases/), runs it in softmax mode at
the temporal update's shapes of the flagship stream and of the training
step on the three flows of ``chip_smoke.py:splat_inputs``, checks that its
output equals the kernel's, and prints per step the median and the largest
SM cycles over the blocks:
  taps    the walk over the batch item's flow, each tap that lands in
          the block's tile taking a slot in its target's bucket;
  sort    each bucket in key order;
  contrib every tap's contributions;
  sum     each target's bucket added, normalised and stored;
  big     the targets of more than SMALL taps.
Prints the card's name and power limit first.  Needs one CUDA card and
nvcc.  Its patch anchors are lines of the kernel; it raises if an edit
moved one.
"""
import ctypes
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from temporalstereo_tpu_torch.kernels import build, splat  # noqa: E402

STEPS = ("taps", "sort", "contrib", "sum", "big")
MARKS = ("  // 1: the taps landing in the tile",
         "  // 2: each bucket in key order",
         "    // 3: every tap's contributions", "    // 4: one thread per",
         "  // 5: the targets of more than SMALL taps")


def stamped_source():
    src = (build.CSRC / "softsplat.cu").read_text()

    def stamp(k):
        return ("  if (threadIdx.x == 0) a.ts[(blockIdx.y * gridDim.x + "
                f"blockIdx.x) * 6 + {k}] = clock64();\n")
    for k, mark in enumerate(MARKS):
        if mark not in src:
            raise RuntimeError(f"patch anchor {mark!r} not in softsplat.cu")
        src = src.replace(mark, stamp(k) + mark, 1)
    last = "big_target(a, b, t0 + big[j], contrib);\n"
    edits = [(last, last + stamp(5)),
             ("  long long in_s[4], fl_s[4], me_s[3];",
              "  long long* ts;\n  long long in_s[4], fl_s[4], me_s[3];"),
             ("long long me_sw, int tile,",
              "long long me_sw, void* ts, int tile,"),
             ("  a.tile = tile;\n",
              "  a.tile = tile;\n  a.ts = (long long*)ts;\n")]
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"patch anchor {old!r} not in softsplat.cu")
        src = src.replace(old, new, 1)
    return src


def main():
    print(cs.card_line(), flush=True)
    out_dir = build.BUILD_DIR / "phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "softsplat_phases.cu"
    lib = out_dir / "libsoftsplat_phases.so"
    src.write_text(stamped_source())
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).softsplat
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_float] + [ctypes.c_longlong] * 11
                   + [ctypes.c_void_p]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(13)
    for path, (b, h, w) in cs.SPLAT_SHAPES:
        for case in ("uniform", "rigid", "one_target"):
            x, f, m = cs.splat_inputs(torch, case, b, h, w, g, dev)
            tile = splat.splat_plan(b, h, w, sms)
            blocks = b * -(-h * w // tile)
            out = torch.empty((b, h, w, x.shape[-1]), device=dev)
            ts = torch.zeros((blocks, 6), dtype=torch.int64, device=dev)
            for _ in range(3):
                err = fn(x.data_ptr(), f.data_ptr(), m.data_ptr(),
                         out.data_ptr(), None, b, h, w, x.shape[-1], 3,
                         1e-22,
                         *x.stride(), *f.stride(), *m.stride()[:3],
                         ts.data_ptr(), tile, dev.index or 0,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed, CUDA error {err}")
            torch.cuda.synchronize()
            if not torch.equal(out, splat.softsplat(x, f, m, "softmax")):
                raise AssertionError("the stamped kernel's output differs")
            t = ts.cpu().double()
            d = t[:, 1:] - t[:, :-1]
            print(json.dumps({
                "path": path, "case": case, "shape": [b, h, w, 8],
                "tile": tile, "blocks": blocks,
                "median_cycles": dict(zip(STEPS, d.median(0).values.tolist())),
                "max_cycles": dict(zip(STEPS, d.max(0).values.tolist())),
                "block_max_cycles": float((t[:, 5] - t[:, 0]).max())}),
                flush=True)


if __name__ == "__main__":
    main()
