"""Bilinear forward splat (summation): the CUDA kernel's wrapper and its
plain PyTorch version.

Counterpart of the JAX package's ``ops/pallas/splat.py:summation_splat_pallas``
(kernel in ``csrc/summation_splat.cu``).  values [B, H, W, C] and flow
[B, H, W, 2] (x, y) in pixels, both f32 -> [B, H, W, C]: every source value
is added to its 4 bilinear neighbours at (x + fx, y + fy), each tap
bounds-checked on its own.  The kernel sums with atomicAdd, so its last bits
vary from run to run; the plain version is deterministic.
"""
from __future__ import annotations

import ctypes

import torch

from .launches import LAUNCHES, check_no_grad, cuda_device_index

_FN = None


def _kernel():
    global _FN
    if _FN is None:
        from .build import load

        fn = load("summation_splat").summation_splat
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(values, flow):
    b, h, w, _ = values.shape
    if flow.shape != (b, h, w, 2):
        raise ValueError(f"flow {tuple(flow.shape)} does not match values "
                         f"{tuple(values.shape)}")
    if values.dtype != torch.float32 or flow.dtype != torch.float32:
        raise TypeError(f"values and flow must be float32, got "
                        f"{values.dtype}/{flow.dtype}")


def summation_splat_plain(values: torch.Tensor, flow: torch.Tensor
                          ) -> torch.Tensor:
    """The same function in plain PyTorch: the 4-tap scatter of the JAX
    package's ``ops/softsplat.py:summation_splat_scatter`` (``index_add_``)."""
    _check(values, flow)
    b, h, w, c = values.shape
    xs = torch.arange(w, dtype=torch.float32, device=values.device
                      ).view(1, 1, w) + flow[..., 0]
    ys = torch.arange(h, dtype=torch.float32, device=values.device
                      ).view(1, h, 1) + flow[..., 1]
    x0, y0 = torch.floor(xs), torch.floor(ys)
    fx, fy = xs - x0, ys - y0
    batch = torch.arange(b, device=values.device).view(b, 1, 1) * (h * w)
    out = torch.zeros((b * h * w, c), dtype=values.dtype, device=values.device)
    for dx, dy, wgt in ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)),
                        (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
        tx, ty = x0 + dx, y0 + dy
        valid = (tx >= 0) & (tx <= w - 1) & (ty >= 0) & (ty <= h - 1)
        idx = (batch + ty.clamp(0, h - 1).long() * w
               + tx.clamp(0, w - 1).long())[valid]
        out.index_add_(0, idx, (values * wgt[..., None])[valid])
    return out.view(b, h, w, c)


def summation_splat(values: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """values [B,H,W,C], flow [B,H,W,2] (f32) -> [B,H,W,C].  CUDA tensors
    launch the kernel, CPU tensors run the plain version."""
    _check(values, flow)
    check_no_grad("summation_splat", values, flow)
    if values.device.type == "cpu":
        return summation_splat_plain(values, flow)
    device = cuda_device_index("summation_splat", values, flow)
    b, h, w, c = values.shape
    out = torch.zeros_like(values)
    stream = torch.cuda.current_stream(values.device).cuda_stream
    err = _kernel()(values.data_ptr(), flow.data_ptr(), out.data_ptr(),
                    b, h, w, c, device, stream)
    if err:
        raise RuntimeError(f"summation_splat: launch failed, CUDA error {err}")
    LAUNCHES["summation_splat"] += 1
    return out
