"""Profile one forward, streaming or training step of the port and print
where its time goes.

    python -m temporalstereo_tpu_torch.cli.profile_step [--temporal]
        [--train] [--height 384] [--width 1248] [--batch 1] [--top 40]
        [--scope-depth 3] [--iters 6] [--device cuda]

Counterpart of the JAX package's ``cli/profile_step.py``, which reads an
XPlane trace.  The port runs ``--iters`` steps under ``torch.profiler``
(after one warm-up step) and prints:

  * the model scopes: every module whose path has at most
    ``--scope-depth`` parts runs inside a ``record_function`` of its path,
    and each kernel counts for the innermost scope above the operation
    that launched it (``<backward>`` for the autograd engine's work,
    ``<other>`` outside the model), as far as the profiler links kernels
    to their launches (the share it links is printed);
  * the launching operations (the counterpart of JAX's HLO categories);
  * the top ``--top`` kernels by device time, with launches per step;
  * the host's wall time per step (synchronised loop over the steps),
    the device's busy time (the union of its kernel intervals) and their
    share.

The model is the flagship's (v2s, bf16), with ``--temporal`` the stream's
temporal options; ``--train`` profiles a training step (with
``--temporal`` on a window of two frames), built as the JAX CLI builds it
from ``numpy.random.RandomState(0)``.  With ``--device cpu`` the CPU
operations are ranked by their own CPU time and no busy share is given.
The last line is ``profile summary: {json}``.
"""
from __future__ import annotations

import argparse
import collections
import json
import time

import numpy as np
import torch

SCOPE = "scope:"


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--temporal", action="store_true")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--height", type=int, default=384)
    ap.add_argument("--width", type=int, default=1248)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--scope-depth", type=int, default=3,
                    help="module path depth of the scope table")
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("opts", nargs=argparse.REMAINDER, default=None,
                    help="config KEY VALUE pairs over the flagship's")
    return ap


def add_scopes(model: torch.nn.Module, depth: int) -> list:
    """A ``record_function`` of its path around the forward of every module
    whose path has at most ``depth`` parts -> the hook handles."""
    handles = []
    for name, module in model.named_modules():
        if not name or name.count(".") >= depth:
            continue

        def pre(mod, inputs, name=name):
            rf = torch.profiler.record_function(SCOPE + name)
            rf.__enter__()
            mod.__dict__.setdefault("_profile_scopes", []).append(rf)

        def post(mod, inputs, outputs):
            mod.__dict__["_profile_scopes"].pop().__exit__(None, None, None)

        handles += [module.register_forward_pre_hook(pre),
                    module.register_forward_hook(post)]
    return handles


def scope_of(event) -> str:
    """The innermost model scope above ``event`` (itself included)."""
    e = event
    while e is not None:
        if e.name.startswith(SCOPE):
            return e.name[len(SCOPE):]
        if e.name.startswith("autograd::engine"):
            return "<backward>"
        e = e.cpu_parent
    return "<other>"


def device_work(prof, on_card: bool):
    """-> ([(kernel name, us)] of every kernel, memset and copy the card
    ran, [(launching op, scope, us)] of those the profiler links to the
    CPU operation that launched them); on the CPU, every operation's own
    time in both."""
    kernels, launched = [], []
    for e in prof.events():
        if on_card and e.device_type == torch.autograd.DeviceType.CUDA \
                and not e.name.startswith(SCOPE):   # a scope's range
            kernels.append((e.name, e.time_range.elapsed_us()))
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        if on_card:
            for k in e.kernels:
                if k.name != e.name:      # not a scope's range on the card
                    launched.append((e.name, scope_of(e), k.duration))
        elif not e.name.startswith(SCOPE) and e.self_cpu_time_total > 0:
            kernels.append((e.name, e.self_cpu_time_total))
            launched.append((e.name, scope_of(e), e.self_cpu_time_total))
    return kernels, launched


def busy_us(prof) -> float:
    """The union of the card's event intervals, microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith(SCOPE))
    busy, reach = 0.0, float("-inf")
    for start, end in spans:
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


def build_step(args, device):
    """The model and the step to profile, as the JAX CLI builds them."""
    from ..config import get_cfg
    from ..models import (backbone_memory_shapes, build_model, init_prev_info,
                          streaming_step)

    opts = ["TRAINER.PRECISION", "bf16"]
    if args.temporal:
        opts += ["MODEL.WITH_PREVIOUS", "True",
                 "MODEL.USE_PAST_COST", "True",
                 "MODEL.LOCAL_MAP_SIZE", "3",
                 "MODEL.BACKBONE.MEMORY_PERCENT", "0.5"]
    cfg = get_cfg(opts=opts + list(args.opts or []))
    model = build_model(cfg, device=device, seed=0)
    b, h, w = args.batch, args.height, args.width
    rng = np.random.RandomState(0)

    def dev(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(device)

    left, right = dev(rng.rand(b, h, w, 3)), dev(rng.rand(b, h, w, 3))
    K = dev(np.tile(np.array([[720.0, 0, w / 2], [0, 720.0, h / 2],
                              [0, 0, 1]]), (b, 1, 1)))
    baseline = torch.full((b,), 0.54, device=device)
    if args.train:
        from ..training import (TrainState, build_optimizer, make_train_step,
                                master_copies)

        state = TrainState.create(*master_copies(model),
                                  build_optimizer(cfg, steps_per_epoch=1000))
        train_step = make_train_step(model, cfg)
        t = 2 if args.temporal else 1
        eye = np.tile(np.eye(4, dtype=np.float32), (t, b, 1, 1))
        batch = {"left": dev(rng.rand(t, b, h, w, 3)),
                 "right": dev(rng.rand(t, b, h, w, 3)),
                 "disp_gt": dev(20.0 * rng.rand(t, b, h, w, 1)),
                 "K": K, "baseline": baseline,
                 "T_cam": dev(eye), "inv_T": dev(eye)}

        def step():
            return train_step(state, batch)[1]["loss"]
        return cfg, model, step
    model.eval()
    if args.temporal:
        T = np.eye(4, dtype=np.float32)
        T[0, 3], T[2, 3] = 0.02, -0.5
        T = dev(np.tile(T, (b, 1, 1)))
        prev = init_prev_info(
            model, b, (h, w), backbone_memory_shapes(model.backbone_cfg,
                                                     (h, w)),
            model.precise_cfg.get("topk", 2), device=device)
        # one step first, so that the carried state holds a frame
        prev = streaming_step(model, left, right, prev, K, baseline, T)[1]

        def step():
            return streaming_step(model, left, right, prev, K, baseline,
                                  T)[0]["disps"][0]
        return cfg, model, step

    def step():
        with torch.inference_mode():
            return model(left, right, None)[0]["disps"][0]
    return cfg, model, step


def table(title: str, totals, counts, grand: float, iters: int, n: int,
          width: int) -> None:
    print(f"\n{title:<{width}} {'ms/step':>9} {'count':>6} {'%':>6}")
    for name, tot in totals.most_common(n):
        print(f"{name[:width]:<{width}} {tot / iters / 1e3:9.3f} "
              f"{counts[name] // iters:6d} {100 * tot / grand:6.1f}")


def main(argv=None) -> dict:
    args = get_parser().parse_args(argv)

    from torch.profiler import ProfilerActivity, profile

    from ..kernels import LAUNCHES, reset_launches
    from ..models import resolve_device

    device = resolve_device(args.device)
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    cfg, model, step = build_step(args, device)
    handles = add_scopes(model, args.scope_depth)
    step()                                   # builds kernels, warms caches
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if on_card else [])
    reset_launches()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            step()
        sync()
        wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    for handle in handles:
        handle.remove()

    kernel_rows, launched = device_work(prof, on_card)
    grand = sum(us for _, us in kernel_rows) or 1.0
    linked = sum(us for _, _, us in launched)
    kernels, ops, scopes = (collections.Counter() for _ in range(3))
    k_n, o_n, s_n = (collections.Counter() for _ in range(3))
    for name, us in kernel_rows:
        kernels[name] += us
        k_n[name] += 1
    for op, scope, us in launched:
        ops[op] += us
        o_n[op] += 1
        scopes[scope] += us
        s_n[scope] += 1
    table("model scope (module path)", scopes, s_n, grand, args.iters, 30, 52)
    table("launching operation", ops, o_n, grand, args.iters, 18, 52)
    table("kernel" if on_card else "operation (own CPU time)", kernels, k_n,
          grand, args.iters, args.top, 72)
    if on_card:
        print(f"\n{100 * linked / grand:.1f}% of the device time is linked "
              "to its launching operation (the scope tables)")
    busy = busy_us(prof) if on_card else None
    wall_ms = 1e3 * wall / args.iters
    print(f"\nstep wall (host, synchronised): {wall_ms:.2f} ms")
    if on_card:
        print(f"device busy: {busy / args.iters / 1e3:.2f} ms per step "
              f"(share {busy / 1e6 / wall:.3f}); kernel time "
              f"{grand / args.iters / 1e3:.2f} ms per step")
    summary = {
        "device": (torch.cuda.get_device_name(device) if on_card else "cpu"),
        "mode": ("train" if args.train else "stream" if args.temporal
                 else "forward"),
        "iters": args.iters, "wall_ms": wall_ms,
        "busy_ms": None if busy is None else busy / args.iters / 1e3,
        "busy_share": None if busy is None else busy / 1e6 / wall,
        "events_per_step": len(kernel_rows) / args.iters,
        "linked_share": linked / grand,
        "top": [[name, tot / args.iters / 1e3, k_n[name] // args.iters]
                for name, tot in kernels.most_common(args.top)],
        "scopes": {k: v / args.iters / 1e3 for k, v in scopes.items()},
        "launches": launches}
    print(f"profile summary: {json.dumps(summary)}", flush=True)
    return summary


if __name__ == "__main__":
    main()
