"""Microbenchmark harness.

Counterpart of the JAX package's ``utils/benchmark.py`` (the reference's
``time_test_template.py``).  Every timing says what it measured:

  * ``time_test``: median wall seconds per call, each call synchronised
    (dispatch included);
  * ``time_test_fused``: median seconds per call of ``reps`` calls between
    two CUDA events, or (``graph=True``) of one CUDA-graph replay of
    ``reps`` captured calls, over ``reps``: the device's time with the
    host's launch cost hidden or removed.  On CPU tensors the host clock
    around ``reps`` calls;
  * ``time_test_device``: device seconds per call, the kernels (and
    memsets and copies) the calls put on the card, from ``torch.profiler``,
    over the number of calls; raises without a card.
"""
from __future__ import annotations

import time
from typing import Callable, List

import torch


def _on_cuda(*args) -> bool:
    return any(torch.is_tensor(a) and a.is_cuda for a in args)


def _sync(cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


def _median(times: List[float]) -> float:
    times = sorted(times)
    return times[len(times) // 2]


def time_test(fn: Callable, *args, iters: int = 100, warmup: int = 3
              ) -> float:
    """Median seconds per call of ``fn(*args)``, each call waited for."""
    cuda = _on_cuda(*args)
    for _ in range(warmup):
        fn(*args)
    _sync(cuda)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync(cuda)
        times.append(time.perf_counter() - t0)
    return _median(times)


def time_test_fused(fn: Callable, *args, reps: int = 32, iters: int = 5,
                    warmup: int = 1, graph: bool = False) -> float:
    """Median seconds per call over ``iters`` runs of ``reps`` back-to-back
    calls (see the module docstring)."""
    if not _on_cuda(*args):
        if graph:
            raise ValueError("time_test_fused: a CUDA graph needs CUDA "
                             "tensors")
        times = []
        for _ in range(warmup + iters):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn(*args)
            times.append(time.perf_counter() - t0)
        return _median(times[warmup:]) / reps

    def run():
        for _ in range(reps):
            fn(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm-up off the capture stream
        for _ in range(max(warmup, 1)):
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        run = g.replay
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return _median(times) / reps


# the reference's name (time_test_template.py:4)
timeTestTemplate = time_test


def report(name: str, seconds: float) -> str:
    msg = (f"{name} forward once takes {seconds * 1000:.4f}ms, "
           f"i.e. {1.0 / seconds:.2f}fps")
    print(msg, flush=True)
    return msg


def time_test_device(fn: Callable, *args, iters: int = 8) -> float:
    """Device seconds per call of ``fn(*args)``: every event (kernel,
    memset, copy) the card ran during ``iters`` calls under
    ``torch.profiler``, summed, over ``iters`` (a mean; the JAX package's
    is a median of the executable's runs)."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_test_device: no CUDA device to trace")
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn(*args)
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        raise RuntimeError("time_test_device: the profiler saw no device "
                           "events")
    return sum(e.time_range.elapsed_us() for e in events) * 1e-6 / iters
