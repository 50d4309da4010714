"""Op-level microbenchmarks of the port at KITTI sizes.

    python -m temporalstereo_tpu_torch.cli.benchmark_ops [--height 384]
        [--width 1248] [--device cuda]

Counterpart of the JAX package's ``cli/benchmark_ops.py``, for the ops
whose GPU times the reference records in comments (``BASELINE.md``):

  * ``block_cost`` @1/16, C=192, 12 dense samples (plain PyTorch);
  * ``block_cost`` @1/4, C=48, 4 per-pixel hypotheses (the fused cost
    base, ``kernels/csrc/fused_cost_base.cu``);
  * ``cat_fms`` and ``dif_fms``, 48 dense samples @1/4, C=48;
  * ``correlation2d``, patch 21 @1/16, C=64;
  * the cost base at the model's precise (1/4, D=5) and fine (1/8, D=10)
    shapes, C=128, bf16: the kernel and its plain version;
  * ``softsplat``, softmax @1/8, C=16 (``kernels/csrc/softsplat.cu``).

On the card each time is the device time per call (``utils/benchmark.py:
time_test_device``: the kernels, memsets and copies 8 calls put on the
card, from ``torch.profiler``, over 8); with ``--device cpu``
the host wall time per call.  The last line is one JSON object: per op its
time, shape and, where the reference records one, the reference's own
figure with the hardware it names, never the card's; the card's name and
power limit; the kernels' launches during the run.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

# BASELINE.md:11-17: the reference's op timings, from its code comments
REFERENCE = {
    "block_cost_1_4": (1.7147, "GTX 3090 (reference)"),
    "cat_fms_dense": (5.3421, "GTX 3090 (reference)"),
    "dif_fms_dense": (8.3691, "GTX 3090 (reference)"),
    "correlation2d": (0.6607, "unstated GPU (reference)"),
}


def card_line() -> str | None:
    """``nvidia-smi``'s name and power limit of the first card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def cases(h: int, w: int, device: torch.device):
    """(name, shape, fn, args) of every op, inputs from numpy seed 0."""
    from ..kernels import fused_cost_base, fused_cost_base_plain
    from ..ops import block_cost, cat_fms, dif_fms, softsplat
    from ..ops.correlation import correlation2d

    rng = np.random.RandomState(0)

    def t(*shape, scale=1.0, dtype=torch.float32):
        return (torch.from_numpy(rng.rand(*shape).astype(np.float32) * scale)
                .to(device=device, dtype=dtype))

    h16, w16, h8, w8, h4, w4 = h // 16, w // 16, h // 8, w // 8, h // 4, w // 4
    out = [("block_cost_int_1_16", [1, 12, h16, w16, 192],
            lambda l, r: block_cost(l, r, 12),
            (t(1, h16, w16, 192), t(1, h16, w16, 192)))]
    l4, r4 = t(1, h4, w4, 48), t(1, h4, w4, 48)
    out += [("block_cost_1_4", [1, 4, h4, w4, 48], block_cost,
             (l4, r4, t(1, 4, h4, w4, scale=w4))),
            ("cat_fms_dense", [1, 48, h4, w4, 48],
             lambda l, r: cat_fms(l, r, 48), (l4, r4)),
            ("dif_fms_dense", [1, 48, h4, w4, 48],
             lambda l, r: dif_fms(l, r, 48), (l4, r4)),
            ("correlation2d", [1, h16, w16, 21 * 21],
             lambda a, b: correlation2d(a, b, 21),
             (t(1, h16, w16, 64), t(1, h16, w16, 64)))]
    for tag, (hh, ww, d) in (("precise_1_4", (h4, w4, 5)),
                             ("fine_1_8", (h8, w8, 10))):
        args = (t(1, hh, ww, 128, dtype=torch.bfloat16),
                t(1, hh, ww, 128, dtype=torch.bfloat16),
                t(1, d, hh, ww, scale=24.0))
        out += [(f"cost_base_kernel_{tag}", [1, d, hh, ww, 128],
                 fused_cost_base, args),
                (f"cost_base_plain_{tag}", [1, d, hh, ww, 128],
                 fused_cost_base_plain, args)]
    out.append(("softsplat_1_8", [1, h8, w8, 16],
                lambda v, f, m: softsplat(v, f, m, "softmax"),
                (t(1, h8, w8, 16),
                 torch.from_numpy(rng.randn(1, h8, w8, 2).astype(np.float32)
                                  * 4).to(device),
                 torch.from_numpy(rng.randn(1, h8, w8, 1).astype(np.float32))
                 .to(device))))
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--width", type=int, default=1248)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from ..kernels import LAUNCHES, reset_launches
    from ..models import resolve_device
    from ..utils.benchmark import report, time_test, time_test_device

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    reset_launches()
    ops = {}
    for name, shape, fn, fn_args in cases(args.height, args.width, device):
        with torch.no_grad():
            seconds = (time_test_device(fn, *fn_args) if on_card
                       else time_test(fn, *fn_args, iters=3, warmup=1))
        report(name, seconds)
        # the reference timed its ops at the KITTI size only
        ref = (REFERENCE.get(name) if (args.height, args.width) == (384, 1248)
               else None)
        ops[name] = {"ms": 1e3 * seconds, "shape": shape,
                     "reference": (None if ref is None else
                                   {"ms": ref[0], "hardware": ref[1]})}
    result = {"timing": ("device ms per call (torch.profiler)" if on_card
                         else "host wall ms per call (cpu)"),
              "device": (torch.cuda.get_device_name(device) if on_card
                         else "cpu"),
              "card": card_line() if on_card else None,
              "size": [args.height, args.width], "ops": ops,
              "launches": dict(LAUNCHES)}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
