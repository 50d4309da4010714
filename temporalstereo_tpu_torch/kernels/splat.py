"""Softmax splatting (bilinear forward warp) in one launch: the CUDA
kernel's wrapper and its plain PyTorch version.

Counterpart of the JAX package's ``ops/softsplat.py:softsplat`` over
``ops/pallas/splat.py:summation_splat_pallas`` (kernel in
``csrc/softsplat.cu``).  inputs [B, H, W, C], flow [B, H, W, 2] (x, y) in
pixels and, in the linear and softmax modes, metric [B, H, W, 1], all f32
-> [B, H, W, C]: every source value, weighted by exp(metric) (softmax),
metric (linear) or 1 (average), is added with its weight to its 4 bilinear
neighbours at (x + fx, y + fy), each tap bounds-checked on its own, and
the sum is divided by (weight + eps); summation mode is the bare splat.
The kernel does all of it in one launch, and sums each target in a fixed
order: its output is bit-identical from run to run.
"""
from __future__ import annotations

import ctypes

import torch

from .launches import LAUNCHES, check_no_grad, cuda_device_index

MODES = ("summation", "average", "linear", "softmax")
MAX_TILE = 128               # targets per block (csrc/softsplat.cu)
_FN = None


def _kernel():
    global _FN
    if _FN is None:
        from .build import load

        fn = load("softsplat").softsplat
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_float] + [ctypes.c_longlong] * 11
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def splat_plan(b: int, h: int, w: int, sms: int) -> int:
    """Targets per block of the kernel for a batch of b frames of h x w
    pixels on a card of ``sms`` SMs: about one block per SM, at most
    MAX_TILE targets each (every block reads the whole flow of its batch
    item).  Raises ValueError for a frame whose keys (4 per pixel) do not
    fit the kernel's int32."""
    if 4 * h * w >= 2 ** 30:
        raise ValueError(f"softsplat: a {h}x{w} frame has more than 2^28 "
                         "pixels; the kernel's keys are int32")
    per_item = max(1, sms // max(b, 1))
    return min(MAX_TILE, max(1, -(-h * w // per_item)))


def _check(inputs, flow, metric, mode):
    if mode not in MODES:
        raise ValueError(f"unknown softsplat mode {mode!r}")
    if inputs.dim() != 4:
        raise ValueError(f"inputs {tuple(inputs.shape)} must be [B,H,W,C]")
    b, h, w, _ = inputs.shape
    if flow.shape != (b, h, w, 2):
        raise ValueError(f"flow {tuple(flow.shape)} does not match inputs "
                         f"{tuple(inputs.shape)}")
    tensors = [inputs, flow]
    if mode in ("linear", "softmax"):
        if metric is None or metric.shape != (b, h, w, 1):
            raise ValueError(f"{mode} mode needs a metric [B,H,W,1] of "
                             f"inputs {tuple(inputs.shape)}")
        tensors.append(metric)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("softsplat takes float32 inputs, flow and metric, "
                        f"got {[t.dtype for t in tensors]}")
    return tensors


def _summation_plain(values, flow):
    """The 4-tap scatter of the JAX package's
    ``ops/softsplat.py:summation_splat_scatter`` (``index_add_``)."""
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


def softsplat_plain(inputs: torch.Tensor, flow: torch.Tensor,
                    metric: torch.Tensor | None, mode: str = "softmax",
                    eps: float = 1e-22) -> torch.Tensor:
    """The same function in plain PyTorch: the JAX package's mode weighting
    and normalisation around the scatter splat."""
    _check(inputs, flow, metric, mode)
    if mode == "average":
        vals = torch.cat([inputs, torch.ones_like(inputs[..., :1])], dim=-1)
    elif mode == "linear":
        vals = torch.cat([inputs * metric, metric], dim=-1)
    elif mode == "softmax":
        emetric = torch.exp(metric)
        vals = torch.cat([inputs * emetric, emetric], dim=-1)
    else:
        vals = inputs
    out = _summation_plain(vals, flow)
    if mode == "summation":
        return out
    return out[..., :-1] / (out[..., -1:] + eps)


def softsplat(inputs: torch.Tensor, flow: torch.Tensor,
              metric: torch.Tensor | None, mode: str = "softmax",
              eps: float = 1e-22) -> torch.Tensor:
    """inputs [B,H,W,C], flow [B,H,W,2], metric [B,H,W,1] or None (f32, any
    strides) -> [B,H,W,C].  CUDA tensors launch the kernel, CPU tensors run
    the plain version."""
    tensors = _check(inputs, flow, metric, mode)
    check_no_grad("softsplat", *tensors)
    if inputs.device.type == "cpu":
        return softsplat_plain(inputs, flow, metric, mode, eps)
    device = cuda_device_index("softsplat", *tensors, contiguous=False)
    b, h, w, c = inputs.shape
    tile = splat_plan(b, h, w, torch.cuda.get_device_properties(
        device).multi_processor_count)
    out = torch.empty((b, h, w, c), dtype=torch.float32, device=inputs.device)
    has_metric = len(tensors) == 3
    m_strides = metric.stride()[:3] if has_metric else (0, 0, 0)
    stream = torch.cuda.current_stream(inputs.device).cuda_stream
    err = _kernel()(inputs.data_ptr(), flow.data_ptr(),
                    metric.data_ptr() if has_metric else None,
                    out.data_ptr(), b, h, w, c, MODES.index(mode), eps,
                    *inputs.stride(), *flow.stride(), *m_strides, tile,
                    device, stream)
    if err:
        raise RuntimeError(f"softsplat: launch failed, CUDA error {err}")
    LAUNCHES["softsplat"] += 1
    return out
