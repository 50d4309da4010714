"""Fused sparse cost-volume base: the CUDA kernels' wrapper (forward and
backward, as a ``torch.autograd.Function``) and its plain PyTorch version.

Counterpart of the JAX package's ``ops/pallas/cost.py:fused_cost_base_pallas``
(kernels in ``csrc/fused_cost_base.cu`` and
``csrc/fused_cost_base_backward.cu``).  For reference/target features
[B, H, W, C] and per-pixel hypotheses [B, D, H, W] it returns
[B, D, H, W, 2C + C//8] = concat(ref broadcast over D, target warped along W
to x - d with zero padding, scale-0 groupwise correlation).  Coordinates and
arithmetic are f32 for either I/O type; the warped value is rounded to the
I/O type before the correlation, and each output is rounded once.  The
backward gives the gradients of all three inputs (the hypotheses carry the
previous stage's gradient), as ``jax.vjp`` of the JAX formulation does,
in a fixed order of summation: the backward kernel is deterministic.

The forward also takes column offsets, for a W-sharded forward
(``parallel/spatial.py``): the reference's column x is the frame's column
x0 + x, and the target [B, H, Wt, C] holds the frame's columns
[t0, t0 + Wt), which must cover every column the hypotheses reach inside
the frame; a tap outside them reads zero.  The offset form has no
backward: the sharded forward is inference only.
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from .launches import (LAUNCHES, PAIRS, SLICE, check_no_grad,
                       cuda_device_index, row_plan)

GROUP = 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FNS = {}
# elements of the I/O type the backward kernel stages per (pixel,
# hypothesis) pair and slice: g_ref, g_w, ref and the two tgt taps (32
# each), g_corr (4, padded to 8)
_RING_ELEMS = 5 * SLICE + 8


def _stage_bytes(elem_size):
    """Bytes the backward kernel's producer stage hands its owner stage per
    step: each pair's taps (16) and two values per channel in the I/O
    type."""
    return PAIRS * (16 + 2 * SLICE * elem_size)


# the C entry points' parameters, in order (a pointer or the stream passed
# as an int would be cut to 32 bits)
ARGTYPES = {
    "fused_cost_base": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                        + [ctypes.c_void_p]),
    "fused_cost_base_backward": ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                                 + [ctypes.c_void_p]),
}


def _kernels():
    if not _FNS:
        from .build import load

        for key, name in (("forward", "fused_cost_base"),
                          ("backward", "fused_cost_base_backward")):
            fn = getattr(load(name), name)
            fn.argtypes = ARGTYPES[name]
            fn.restype = ctypes.c_int
            _FNS[key] = fn
    return _FNS


def _check(reference_fm, target_fm, disp_sample):
    """The target may hold another span of columns than the reference."""
    b, h, w, c = reference_fm.shape
    if target_fm.dim() != 4 or target_fm.shape[:2] != (b, h) \
            or target_fm.shape[3] != c:
        raise ValueError(f"target {tuple(target_fm.shape)} does not match "
                         f"reference {tuple(reference_fm.shape)}")
    if disp_sample.dim() != 4 or disp_sample.shape[0] != b \
            or disp_sample.shape[2:] != (h, w):
        raise ValueError(f"hypotheses {tuple(disp_sample.shape)} do not "
                         f"match features {tuple(reference_fm.shape)}")
    if c % GROUP:
        raise ValueError(f"channels {c} not divisible by {GROUP}")
    if reference_fm.dtype not in _DTYPES \
            or target_fm.dtype != reference_fm.dtype:
        raise TypeError("features must both be float32 or bfloat16, got "
                        f"{reference_fm.dtype}/{target_fm.dtype}")
    if disp_sample.dtype != torch.float32:
        raise TypeError(f"hypotheses must be float32, got {disp_sample.dtype}")


def fused_cost_base_plain(reference_fm: torch.Tensor, target_fm: torch.Tensor,
                          disp_sample: torch.Tensor, x0: int = 0,
                          t0: int = 0) -> torch.Tensor:
    """The same function in plain PyTorch: shift_1d + concat +
    groupwise_correlation (the JAX package's ``_xla_reference``); torch
    autograd differentiates it."""
    from ..ops.cost import groupwise_correlation
    from ..ops.warp import shift_1d

    _check(reference_fm, target_fm, disp_sample)
    b, h, w, c = reference_fm.shape
    d = disp_sample.shape[1]
    dtype = reference_fm.dtype
    ref = reference_fm[:, None].expand(b, d, h, w, c)
    warped = shift_1d(target_fm[:, None].float(), -disp_sample, x0,
                      t0).to(dtype)
    corr = groupwise_correlation(ref.float(), warped.float()).to(dtype)
    return torch.cat([ref, warped, corr], dim=-1)


def _forward(reference_fm, target_fm, disp_sample, x0=0, t0=0):
    device = cuda_device_index("fused_cost_base", reference_fm, target_fm,
                               disp_sample)
    b, h, w, c = reference_fm.shape
    d = disp_sample.shape[1]
    out = torch.empty((b, d, h, w, 2 * c + c // GROUP),
                      dtype=reference_fm.dtype, device=reference_fm.device)
    stream = torch.cuda.current_stream(reference_fm.device).cuda_stream
    err = _kernels()["forward"](
        reference_fm.data_ptr(), target_fm.data_ptr(), disp_sample.data_ptr(),
        out.data_ptr(), b, d, h, w, c, x0, t0, target_fm.shape[2],
        _DTYPES[reference_fm.dtype], device, stream)
    if err:
        raise RuntimeError(f"fused_cost_base: launch failed, CUDA error {err}")
    LAUNCHES["fused_cost_base"] += 1
    return out


def fused_cost_base_backward(grad_out: torch.Tensor,
                             reference_fm: torch.Tensor,
                             target_fm: torch.Tensor,
                             disp_sample: torch.Tensor):
    """The backward kernel: grad_out [B, D, H, W, 2C + C//8] -> (grad_ref,
    grad_tgt, grad_disp), in the inputs' types."""
    _check(reference_fm, target_fm, disp_sample)
    if target_fm.shape != reference_fm.shape:
        raise ValueError("the backward takes a target of the reference's "
                         f"shape, got {tuple(target_fm.shape)}")
    b, h, w, c = reference_fm.shape
    d = disp_sample.shape[1]
    if grad_out.shape != (b, d, h, w, 2 * c + c // GROUP) \
            or grad_out.dtype != reference_fm.dtype:
        raise ValueError(f"output gradient {tuple(grad_out.shape)} "
                         f"{grad_out.dtype} does not match the forward")
    size = reference_fm.element_size()
    slices, shared = row_plan(c, w, d * w, _RING_ELEMS, size,
                              _stage_bytes(size))
    device = cuda_device_index("fused_cost_base_backward", grad_out,
                               reference_fm, target_fm, disp_sample)
    grad_ref = torch.empty_like(reference_fm)
    grad_tgt = torch.empty_like(target_fm)
    grad_disp = torch.empty_like(disp_sample)
    stream = torch.cuda.current_stream(reference_fm.device).cuda_stream
    err = _kernels()["backward"](
        grad_out.data_ptr(), reference_fm.data_ptr(), target_fm.data_ptr(),
        disp_sample.data_ptr(), grad_ref.data_ptr(), grad_tgt.data_ptr(),
        grad_disp.data_ptr(), b, d, h, w, c, slices, shared,
        _DTYPES[reference_fm.dtype], device, stream)
    if err:
        raise RuntimeError("fused_cost_base_backward: launch failed, CUDA "
                           f"error {err}")
    LAUNCHES["fused_cost_base_backward"] += 1
    return grad_ref, grad_tgt, grad_disp


class _FusedCostBase(torch.autograd.Function):
    @staticmethod
    def forward(ctx, reference_fm, target_fm, disp_sample):
        ctx.save_for_backward(reference_fm, target_fm, disp_sample)
        return _forward(reference_fm, target_fm, disp_sample)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        return fused_cost_base_backward(grad_out.contiguous(),
                                        *ctx.saved_tensors)


def fused_cost_base(reference_fm: torch.Tensor, target_fm: torch.Tensor,
                    disp_sample: torch.Tensor, x0: int = 0,
                    t0: int = 0) -> torch.Tensor:
    """ref/tgt [B,H,W,C] (f32 or bf16) + hypotheses [B,D,H,W] (f32) ->
    [B, D, H, W, 2C + C//8].  CUDA tensors launch the kernels (forward, and
    backward under autograd), CPU tensors run the plain version.  With
    column offsets (``x0``, ``t0``, or a target of another width) the
    forward only, outside autograd."""
    _check(reference_fm, target_fm, disp_sample)
    if reference_fm.device.type == "cpu":
        return fused_cost_base_plain(reference_fm, target_fm, disp_sample,
                                     x0, t0)
    if x0 or t0 or target_fm.shape != reference_fm.shape:
        check_no_grad("fused_cost_base with column offsets", reference_fm,
                      target_fm, disp_sample)
        return _forward(reference_fm, target_fm, disp_sample, x0, t0)
    return _FusedCostBase.apply(reference_fm, target_fm, disp_sample)
