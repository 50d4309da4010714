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

On CUDA tensors that need a gradient, ``softsplat`` is an autograd
function, differentiable in inputs, flow and metric as the JAX package's
is (its ``ops/pallas/splat.py:104`` vjp).  The backward recomputes the
weighted values, gets the normaliser by one summation-mode launch of the
forward kernel over the weight channel (so the forward stays one launch
that writes nothing more), and makes one launch of the gather kernel
``csrc/softsplat_backward.cu`` over all C + 1 channels; the chain to
inputs and metric is torch.  ``summation_splat_vjp_plain`` is the gather
formula that kernel computes.
"""
from __future__ import annotations

import ctypes

import torch

from .launches import LAUNCHES, cuda_device_index

MODES = ("summation", "average", "linear", "softmax")
MAX_TILE = 128               # targets per block (csrc/softsplat.cu)
_FNS = {}
# the C entry points' parameters, in order
ARGTYPES = {"softsplat": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                          + [ctypes.c_float] + [ctypes.c_longlong] * 11
                          + [ctypes.c_int] * 2 + [ctypes.c_void_p]),
            "softsplat_backward": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                                   + [ctypes.c_longlong] * 12
                                   + [ctypes.c_int, ctypes.c_void_p])}


def _kernel(name: str = "softsplat"):
    fn = _FNS.get(name)
    if fn is None:
        from .build import load

        fn = getattr(load(name), name)
        fn.argtypes = ARGTYPES[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


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


def _taps(flow):
    """Per tap k of every source: (valid, flat target index, weight w_k,
    dw_k / dax, dw_k / day), floor() a constant."""
    b, h, w, _ = flow.shape
    xs = torch.arange(w, dtype=torch.float32, device=flow.device
                      ).view(1, 1, w) + flow[..., 0]
    ys = torch.arange(h, dtype=torch.float32, device=flow.device
                      ).view(1, h, 1) + flow[..., 1]
    x0, y0 = torch.floor(xs), torch.floor(ys)
    ax, ay = xs - x0, ys - y0
    batch = torch.arange(b, device=flow.device).view(b, 1, 1) * (h * w)
    for k in range(4):
        dx, dy = k & 1, k >> 1
        tx, ty = x0 + dx, y0 + dy
        valid = (tx >= 0) & (tx <= w - 1) & (ty >= 0) & (ty <= h - 1)
        idx = (batch + ty.clamp(0, h - 1).long() * w
               + tx.clamp(0, w - 1).long())
        wx, wy = (ax if dx else 1 - ax), (ay if dy else 1 - ay)
        yield (valid, idx, wx * wy, (wy if dx else -wy),
               (wx if dy else -wx))


def _summation_plain(values, flow):
    """The 4-tap scatter of the JAX package's
    ``ops/softsplat.py:summation_splat_scatter`` (``index_add_``)."""
    b, h, w, c = values.shape
    out = torch.zeros((b * h * w, c), dtype=values.dtype, device=values.device)
    for valid, idx, wk, _, _ in _taps(flow):
        out.index_add_(0, idx[valid], (values * wk[..., None])[valid])
    return out.view(b, h, w, c)


def _weighted(inputs, metric, mode):
    """The values the splat adds: the inputs weighted by the mode, with the
    weight as channel C (not in summation mode)."""
    if mode == "average":
        return torch.cat([inputs, torch.ones_like(inputs[..., :1])], dim=-1)
    if mode == "linear":
        return torch.cat([inputs * metric, metric], dim=-1)
    if mode == "softmax":
        emetric = torch.exp(metric)
        return torch.cat([inputs * emetric, emetric], dim=-1)
    return inputs


def softsplat_plain(inputs: torch.Tensor, flow: torch.Tensor,
                    metric: torch.Tensor | None, mode: str = "softmax",
                    eps: float = 1e-22) -> torch.Tensor:
    """The same function in plain PyTorch: the JAX package's mode weighting
    and normalisation around the scatter splat."""
    _check(inputs, flow, metric, mode)
    out = _summation_plain(_weighted(inputs, metric, mode), flow)
    if mode == "summation":
        return out
    return out[..., :-1] / (out[..., -1:] + eps)


def summation_splat_vjp_plain(values: torch.Tensor, flow: torch.Tensor,
                              g: torch.Tensor):
    """The vjp of the summation splat as the gather that
    ``csrc/softsplat_backward.cu`` computes, in plain PyTorch: values
    [B,H,W,C], flow [B,H,W,2], the output's gradient g [B,H,W,C] ->
    (g_values [B,H,W,C], g_flow [B,H,W,2]) with
    g_values[s] = sum_k w_k g[t_k] and g_flow[s] = sum_k (dw_k/dax,
    dw_k/day) <g[t_k], values[s]> over the valid taps t_k of source s."""
    c = values.shape[-1]
    flat = g.reshape(-1, c)
    g_values = torch.zeros_like(values, dtype=torch.float32)
    gx = torch.zeros(flow.shape[:3], dtype=torch.float32, device=flow.device)
    gy = torch.zeros_like(gx)
    for valid, idx, wk, dwx, dwy in _taps(flow):
        gk = torch.where(valid[..., None], flat[idx], 0)
        g_values = g_values + wk[..., None] * gk
        dot = (gk * values).sum(-1)
        gx = gx + dwx * dot
        gy = gy + dwy * dot
    return g_values, torch.stack([gx, gy], dim=-1)


def summation_splat_vjp(values: torch.Tensor, flow: torch.Tensor,
                        g: torch.Tensor):
    """``summation_splat_vjp_plain``'s function: one launch of
    ``csrc/softsplat_backward.cu`` on CUDA tensors (f32, any strides), the
    plain version on CPU tensors."""
    if values.device.type == "cpu":
        return summation_splat_vjp_plain(values, flow, g)
    b, h, w, c = values.shape
    if (flow.shape != (b, h, w, 2) or g.shape != values.shape
            or any(t.dtype != torch.float32 for t in (values, flow, g))):
        raise ValueError(f"softsplat_backward: values {tuple(values.shape)}, "
                         f"flow {tuple(flow.shape)}, g {tuple(g.shape)}, "
                         "all float32, [B,H,W,C], [B,H,W,2], [B,H,W,C]")
    device = cuda_device_index("softsplat_backward", values, flow, g,
                               contiguous=False)
    g_values = torch.empty((b, h, w, c), dtype=torch.float32,
                           device=values.device)
    g_flow = torch.empty((b, h, w, 2), dtype=torch.float32,
                         device=values.device)
    stream = torch.cuda.current_stream(values.device).cuda_stream
    err = _kernel("softsplat_backward")(
        values.data_ptr(), flow.data_ptr(), g.data_ptr(), g_values.data_ptr(),
        g_flow.data_ptr(), b, h, w, c, *values.stride(), *flow.stride(),
        *g.stride(), device, stream)
    if err:
        raise RuntimeError("softsplat_backward: launch failed, CUDA error "
                           f"{err}")
    LAUNCHES["softsplat_backward"] += 1
    return g_values, g_flow


def _launch(inputs, flow, metric, mode, eps):
    """One launch of the forward kernel."""
    has_metric = mode in ("linear", "softmax")
    tensors = [inputs, flow] + ([metric] if has_metric else [])
    device = cuda_device_index("softsplat", *tensors, contiguous=False)
    b, h, w, c = inputs.shape
    tile = splat_plan(b, h, w, torch.cuda.get_device_properties(
        device).multi_processor_count)
    out = torch.empty((b, h, w, c), dtype=torch.float32, device=inputs.device)
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


def softsplat_vjp(inputs: torch.Tensor, flow: torch.Tensor,
                  metric: torch.Tensor | None, out: torch.Tensor,
                  g: torch.Tensor, mode: str = "softmax", eps: float = 1e-22):
    """The vjp of ``softsplat`` at its output ``out`` for the output's
    gradient g -> (g_inputs, g_flow, g_metric or None).  Recomputes the
    weighted values, splats the weight channel for the normaliser n and
    takes the summation splat's vjp of g_S = [g / (n + eps), -sum_c g_c
    out_c / (n + eps)] over all C + 1 channels in one call: on CUDA tensors
    one launch of the forward kernel and one of the backward kernel, on CPU
    tensors their plain versions.  The flow's gradient comes from that call
    alone: the mode's weights depend on the metric only."""
    vals = _weighted(inputs, metric, mode)
    if mode == "summation":
        return (*summation_splat_vjp(vals, flow, g), None)
    weight = vals[..., -1:]
    if weight.device.type == "cpu":
        denom = _summation_plain(weight, flow) + eps
    else:
        denom = _launch(weight, flow, None, "summation", eps) + eps
    g_s = torch.cat([g / denom, -(g * out).sum(-1, keepdim=True) / denom],
                    dim=-1)
    g_vals, g_flow = summation_splat_vjp(vals, flow, g_s)
    g_in, g_w = g_vals[..., :-1], g_vals[..., -1:]
    if mode == "average":
        return g_in, g_flow, None
    g_metric = (g_in * inputs).sum(-1, keepdim=True) + g_w
    if mode == "softmax":
        g_metric = g_metric * weight
    return g_in * weight, g_flow, g_metric


class _Softsplat(torch.autograd.Function):
    """The kernel's softsplat, its vjp on the card."""

    @staticmethod
    def forward(ctx, inputs, flow, metric, mode, eps):
        out = _launch(inputs, flow, metric, mode, eps)
        ctx.mode, ctx.eps = mode, eps
        ctx.save_for_backward(inputs, flow, metric, out)
        return out

    @staticmethod
    def backward(ctx, g):
        inputs, flow, metric, out = ctx.saved_tensors
        return (*softsplat_vjp(inputs, flow, metric, out, g, ctx.mode,
                               ctx.eps), None, None)


def softsplat(inputs: torch.Tensor, flow: torch.Tensor,
              metric: torch.Tensor | None, mode: str = "softmax",
              eps: float = 1e-22) -> torch.Tensor:
    """inputs [B,H,W,C], flow [B,H,W,2], metric [B,H,W,1] or None (f32, any
    strides) -> [B,H,W,C].  CUDA tensors launch the kernel (and, where a
    gradient is needed, record its backward), CPU tensors run the plain
    version under autograd."""
    tensors = _check(inputs, flow, metric, mode)
    if inputs.device.type == "cpu":
        return softsplat_plain(inputs, flow, metric, mode, eps)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _Softsplat.apply(inputs, flow,
                                metric if len(tensors) == 3 else None, mode,
                                eps)
    return _launch(inputs, flow, metric, mode, eps)
