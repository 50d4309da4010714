"""Stage marks of the served stream: the wrapper of the one-thread CUDA
kernel ``csrc/trace_mark.cu`` and its plain version.

A mark writes a clock in nanoseconds into ``ring[cursor % slots, mark]``
of an int64 ring [slots, marks] and, with ``advance``, adds one to the
int64 ``cursor`` [1].  On CUDA tensors the kernel reads the device's
``%globaltimer`` when the work before it in the stream has ended, so it
times device work, also inside a CUDA graph's replay; on CPU tensors the
plain version reads ``time.perf_counter_ns()``.  Marks are not counted in
``LAUNCHES``: they time the stream and compute nothing of it.
"""
from __future__ import annotations

import ctypes
import time

import torch

from .launches import cuda_device_index

_FNS = {}
# the C entry point's parameters, in order
ARGTYPES = {"trace_mark": ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                           + [ctypes.c_void_p])}


def _kernel():
    if not _FNS:
        from .build import load

        fn = load("trace_mark").trace_mark
        fn.argtypes = ARGTYPES["trace_mark"]
        fn.restype = ctypes.c_int
        _FNS["trace_mark"] = fn
    return _FNS["trace_mark"]


def _check(ring: torch.Tensor, cursor: torch.Tensor, mark: int) -> None:
    if ring.dtype != torch.int64 or cursor.dtype != torch.int64:
        raise TypeError("the ring and its cursor must be int64")
    if ring.dim() != 2 or tuple(cursor.shape) != (1,):
        raise ValueError(f"ring {tuple(ring.shape)} / cursor "
                         f"{tuple(cursor.shape)}: want [slots, marks] / [1]")
    if not 0 <= mark < ring.shape[1]:
        raise ValueError(f"mark {mark} outside the ring's {ring.shape[1]}")


def trace_mark_plain(ring: torch.Tensor, cursor: torch.Tensor, mark: int,
                     advance: bool = False) -> None:
    """The mark on the host's clock, for CPU tensors."""
    _check(ring, cursor, mark)
    n = int(cursor[0])
    ring[n % ring.shape[0], mark] = time.perf_counter_ns()
    if advance:
        cursor[0] = n + 1


def trace_mark(ring: torch.Tensor, cursor: torch.Tensor, mark: int,
               advance: bool = False) -> None:
    """The mark: a launch on the current stream for CUDA tensors, the plain
    version for CPU ones."""
    if ring.device.type == "cpu":
        return trace_mark_plain(ring, cursor, mark, advance)
    _check(ring, cursor, mark)
    device = cuda_device_index("trace_mark", ring, cursor)
    stream = torch.cuda.current_stream(ring.device).cuda_stream
    err = _kernel()(ring.data_ptr(), cursor.data_ptr(), mark, ring.shape[1],
                    ring.shape[0], int(advance), device, stream)
    if err:
        raise RuntimeError(f"trace_mark: launch failed, CUDA error {err}")
