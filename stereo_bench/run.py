"""Run one cell of the port's benchmark once, on the card.

    python3 -m stereo_bench.run --workload NAME --seed N --seconds S \\
        --trace 0|1

from the root of a checkout.  The cell, its configuration, traffic mix and
metrics are found by name through ``BENCHMARK.json`` (``spec.py``).  With
``--trace 0`` the last line of standard output is the result with the
cell's end-to-end metrics, with ``--trace 1`` its per-layer ones; the last
lines of standard error give each number the check compared beside its
limit.  Without a card, or with fewer than the cell asks for, it prints no
result and exits 2; with the JAX package or JAX loaded once the window has
closed, 3.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# every cache the run writes stays at a fixed path inside the checkout
CACHE = ROOT / ".bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "temporalstereo_tpu")


def since_start() -> float:
    """Seconds since this process started (the kernel's clock: uptime less
    the process's start time)."""
    with open("/proc/self/stat") as fp:
        fields = fp.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as fp:
        return float(fp.read().split()[0]) - start


def log(msg: str) -> None:
    print(f"stereo_bench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def measure(args, device, check_device=True):
    """The run and its check -> the result object (without printing)."""
    import torch

    from . import check, counts, serve, spec

    cell = spec.resolve(args.workload)
    if check_device and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < cell.chips):
        raise SystemExit(f"stereo_bench: the cell needs {cell.chips} CUDA "
                         "card(s); this machine has "
                         f"{torch.cuda.device_count()}")
    run, checks, start_out, inputs = serve.run_cell(
        cell, args.seed, args.seconds, bool(args.trace), device, since_start,
        log)
    cfg = cell.config
    log(f"window: {len(run.ticks)} ticks, {run.frames_done} frames done in "
        f"{args.seconds} s; set-up {run.setup_s:.2f} s; peak "
        f"{run.memory_peak_bytes} B; checked ticks {[c.tick for c in checks]}"
        f", their largest |disparity| "
        f"{max((float(c.output.abs().max()) for c in checks), default=0.0)}")
    if args.trace:
        run.flops_per_frame = counts.frame_flops(cfg["options"], run.height,
                                                 run.width)
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        value = spec.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    numbers = check.readings(checks, start_out, inputs, cfg["options"],
                             device)["program"]
    correct, rows = check.verdict(numbers, cfg.get("limits", {}))
    if device.type == "cuda":
        card = {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": cell.chips,
                "memory_peak_bytes": run.memory_peak_bytes}
    else:
        card = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    result = {"correct": correct, "attempted": run.batch * len(run.ticks),
              "failed": run.batch * run.failed, "metrics": metrics,
              "device": card}
    if args.trace and run.trace is not None:
        card["busy_s"] = run.trace.busy_s()
        card["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["check"] = {name: {"value": v, "limit": lim}
                       for name, v, lim in rows}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    import torch

    if not torch.cuda.is_available():
        log("no CUDA card: nothing is measured")
        return 2
    result = measure(args, torch.device("cuda"))
    found = forbidden_modules()
    if found:
        log(f"the process holds {found} once the window has closed")
        return 3
    for name, c in result["check"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
