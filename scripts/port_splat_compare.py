"""The temporal update's softsplat in two checkouts of the port, on one card.

    python3 scripts/port_splat_compare.py OTHER_ROOT [--rounds N] [--json PATH]

OTHER_ROOT is another checkout of this repository (e.g. the parent commit,
unpacked with ``git archive`` into a directory that .gitignore lists).
Runs one worker process per checkout in turns, other, this, this, other
(N rounds of that), each importing its own ``temporalstereo_tpu_torch`` and
timing ``ops/softsplat.py:softsplat`` in softmax mode as
``models/stereo.py:update_prev_info`` calls it (7 channels + the weight, a
strided rigid flow; also a uniform +-3 px flow), at the temporal update's
shapes of the flagship stream and of the training step
(``chip_smoke.py:splat_inputs``, ``SPLAT_SHAPES``): the wrapper's time
(CUDA events, median of 5 batches of 50 calls), the device time summed
over everything one call puts on the card and the number of those device
events (torch.profiler), and the largest difference between 5 calls on
the same inputs; then the same for the whole backward through autograd
(``torch.autograd.grad`` of that softsplat in inputs, flow and metric,
CUDA events around batches of 20 calls).  The first outputs and gradients
of this checkout are held against the other checkout's (the largest
difference is printed, the gradients' as a share of their largest
value).
Prints the card's name and power limit, one JSON line per worker and a
summary JSON line; with --json PATH also writes all of it to PATH.  The
outputs pass through kernels/_build/splat_compare/, removed at the end.
Needs one CUDA card and nvcc.
"""
import argparse
import importlib.util
import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CASES = ("rigid", "uniform")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def worker(root, out_path):
    sys.path.insert(0, str(root))
    import torch

    from temporalstereo_tpu_torch.kernels import build
    from temporalstereo_tpu_torch.ops.softsplat import softsplat

    cs = _chip_smoke()
    build.build_all()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    rows, outputs = [], {}
    for path, (b, h, w) in cs.SPLAT_SHAPES:
        for case in CASES:
            inputs, flow, metric = cs.splat_inputs(torch, case, b, h, w, g,
                                                   dev)

            def call(x=inputs, f=flow, m=metric):
                return softsplat(x, f, m, "softmax")
            runs = [call() for _ in range(5)]
            torch.cuda.synchronize()
            spread = max(float((r - runs[0]).abs().max()) for r in runs)
            ms, lo, hi = cs.cuda_ms_spread(call)
            dev_ms, events = cs.call_device_ms(call)
            rows.append({"path": path, "shape": [b, h, w, 8], "case": case,
                         "ms": ms, "ms_min_max": [lo, hi], "device_ms": dev_ms,
                         "device_events_per_call": events,
                         "run_to_run": spread})
            outputs[f"{path} {case}"] = runs[0].cpu()

            leaves = [t.detach().requires_grad_()
                      for t in (inputs, flow, metric)]
            out = softsplat(*leaves, "softmax")
            g_out = torch.randn(out.shape, generator=g, device=dev)

            def backward():
                return torch.autograd.grad(out, leaves, g_out,
                                           retain_graph=True)
            grads = [backward() for _ in range(2)]
            torch.cuda.synchronize()
            ms, lo, hi = cs.cuda_ms_spread(backward, 20)
            events = cs.full_device_events(backward, 20)
            rows[-1].update(
                backward_ms=ms, backward_ms_min_max=[lo, hi],
                backward_device_ms=sum(e.time_range.elapsed_us()
                                       for e in events) / 20 / 1e3,
                backward_device_events_per_call=len(events) / 20,
                backward_run_to_run=max(float((a - b_).abs().max())
                                        for a, b_ in zip(*grads)))
            for name, t in zip(("g_inputs", "g_flow", "g_metric"), grads[0]):
                outputs[f"{path} {case} {name}"] = t.cpu()
    torch.save(outputs, out_path)
    print(json.dumps({"root": str(root), "rows": rows}), flush=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("other", type=pathlib.Path)
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--worker", action="store_true")
    parser.add_argument("--out")
    parser.add_argument("--json", type=pathlib.Path)
    args = parser.parse_args()
    if args.worker:
        return worker(args.other.resolve(), args.out)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    order = [args.other.resolve(), ROOT, ROOT, args.other.resolve()]
    results, files = [], []
    tmp = ROOT / "temporalstereo_tpu_torch" / "kernels" / "_build" / \
        "splat_compare"
    tmp.mkdir(parents=True, exist_ok=True)
    for i, root in enumerate(order * args.rounds):
        out = tmp / f"{i}.pt"
        proc = subprocess.run([sys.executable, __file__, str(root),
                               "--worker", "--out", str(out)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results.append(json.loads(line))
        files.append(out)

    import torch

    first = torch.load(files[0])
    mine = torch.load(files[1])
    diff = {k: float((first[k] - mine[k]).abs().max())
            / (float(first[k].abs().max()) if " g_" in k else 1.0)
            for k in first}
    summary = {"card": card, "max_diff_between_trees": diff}
    print(json.dumps(summary), flush=True)
    shutil.rmtree(tmp)
    if args.json:
        args.json.write_text(json.dumps({"summary": summary,
                                         "workers": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
