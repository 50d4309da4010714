"""W-axis bilinear shift of a volume: the CUDA kernels' wrapper (forward
and backward, as a ``torch.autograd.Function``) and its plain PyTorch
version.

Counterpart of the JAX package's ``ops/pallas/shift.py:shift_1d_pallas``
(kernels in ``csrc/shift_1d.cu``), reached as JAX's ``ops/cost.py:_shift``
is: from the unfused tensor branch of ``block_cost``.  img [B, D, H, W, C]
or [B, 1, H, W, C] (broadcast over D without a copy), f32 or bf16, and
shift [B, D, H, W] f32 -> [B, D, H, W, C]:
out[.., x, c] = (1 - f) img[x0, c] + f img[x0 + 1, c], x0 = floor(x + shift)
in f32, out-of-range taps 0.  The taps are weighted in f32 and the sum is
rounded once to img's type, as the plain version ``ops/warp.py:shift_1d``
does.  The backward kernel sums in a fixed order: it is deterministic.

The forward also takes column offsets, for a W-sharded forward
(``parallel/spatial.py``): shift's column x is the frame's column x0 + x,
and img [B, D|1, H, Wt, C] holds the frame's columns [t0, t0 + Wt); a tap
outside them is 0.  The offset form has no backward: the sharded forward
is inference only.
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from .launches import (LAUNCHES, PAIRS, SLICE, check_no_grad,
                       cuda_device_index, row_plan, shift_forward_plan)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FNS = {}
# elements of img's type the backward kernel stages per (pixel, hypothesis)
# pair and slice: g and the two img taps, 32 each; and the bytes its
# producer stage hands the owner stage per step: each pair's taps
_RING_ELEMS = 3 * SLICE
_STAGE_BYTES = PAIRS * 16


# the C entry points' parameters, in order (a pointer or the stream passed
# as an int would be cut to 32 bits)
ARGTYPES = {
    "shift_1d_forward": ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 14
                         + [ctypes.c_void_p]),
    "shift_1d_backward": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
                          + [ctypes.c_void_p]),
}


def _kernels():
    if not _FNS:
        from .build import load

        lib = load("shift_1d")
        for key in ("forward", "backward"):
            fn = getattr(lib, f"shift_1d_{key}")
            fn.argtypes = ARGTYPES[f"shift_1d_{key}"]
            fn.restype = ctypes.c_int
            _FNS[key] = fn
    return _FNS


def _check(img, shift):
    """img may hold another span of columns than shift."""
    if shift.dim() != 4 or img.dim() != 5:
        raise ValueError(f"img {tuple(img.shape)} must be [B,D,H,W,C] and "
                         f"shift {tuple(shift.shape)} [B,D,H,W]")
    b, d, h, w = shift.shape
    if img.shape[0] != b or img.shape[1] not in (1, d) \
            or img.shape[2] != h:
        raise ValueError(f"img {tuple(img.shape)} does not match shift "
                         f"{tuple(shift.shape)}")
    if img.dtype not in _DTYPES:
        raise TypeError(f"img must be float32 or bfloat16, got {img.dtype}")
    if shift.dtype != torch.float32:
        raise TypeError(f"shift must be float32, got {shift.dtype}")


def shift_1d_plain(img: torch.Tensor, shift: torch.Tensor, x0: int = 0,
                   t0: int = 0) -> torch.Tensor:
    """The same function in plain PyTorch (``ops/warp.py:shift_1d``); torch
    autograd differentiates it."""
    from ..ops.warp import shift_1d as plain

    _check(img, shift)
    return plain(img, shift, x0, t0)


def _dims(img, shift):
    b, d, h, w = shift.shape
    return b, d, img.shape[1], h, w, img.shape[-1]


def _forward(img, shift, x0=0, t0=0):
    device = cuda_device_index("shift_1d", img, shift)
    b, d, di, h, w, c = _dims(img, shift)
    wt = img.shape[3]
    # a block's img row serves its D hypotheses when broadcast, else one
    slices, per, shared = shift_forward_plan(wt, w, c, d if di == 1 else 1,
                                             img.element_size(), b * di * h)
    out = torch.empty((b, d, h, w, c), dtype=img.dtype, device=img.device)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    err = _kernels()["forward"](img.data_ptr(), shift.data_ptr(),
                                out.data_ptr(), b, d, di, h, w, c, x0, t0,
                                wt, slices, per, shared, _DTYPES[img.dtype],
                                device, stream)
    if err:
        raise RuntimeError(f"shift_1d: launch failed, CUDA error {err}")
    LAUNCHES["shift_1d"] += 1
    return out


def shift_1d_backward(grad_out: torch.Tensor, img: torch.Tensor,
                      shift: torch.Tensor):
    """The backward kernel: grad_out [B, D, H, W, C] -> (grad_img in img's
    shape and type, grad_shift [B, D, H, W] f32)."""
    _check(img, shift)
    if img.shape[3] != shift.shape[3]:
        raise ValueError("the backward takes img of shift's width, got "
                         f"{tuple(img.shape)} for {tuple(shift.shape)}")
    b, d, di, h, w, c = _dims(img, shift)
    if grad_out.shape != (b, d, h, w, c) or grad_out.dtype != img.dtype:
        raise ValueError(f"output gradient {tuple(grad_out.shape)} "
                         f"{grad_out.dtype} does not match the forward")
    # a gradient row is (b, h) with D pairs per pixel for a broadcast img,
    # else (b, d, h) with one
    slices, shared = row_plan(c, w, (d if di == 1 else 1) * w, _RING_ELEMS,
                              img.element_size(), _STAGE_BYTES)
    device = cuda_device_index("shift_1d_backward", grad_out, img, shift)
    grad_img = torch.empty_like(img)
    grad_shift = torch.empty_like(shift)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    err = _kernels()["backward"](grad_out.data_ptr(), img.data_ptr(),
                                 shift.data_ptr(), grad_img.data_ptr(),
                                 grad_shift.data_ptr(), b, d, di, h, w, c,
                                 slices, shared, _DTYPES[img.dtype], device,
                                 stream)
    if err:
        raise RuntimeError("shift_1d_backward: launch failed, CUDA error "
                           f"{err}")
    LAUNCHES["shift_1d_backward"] += 1
    return grad_img, grad_shift


class _Shift1d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, shift):
        ctx.save_for_backward(img, shift)
        return _forward(img, shift)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        return shift_1d_backward(grad_out.contiguous(), *ctx.saved_tensors)


def shift_1d(img: torch.Tensor, shift: torch.Tensor, x0: int = 0,
             t0: int = 0) -> torch.Tensor:
    """img [B,D|1,H,W,C] (f32 or bf16) + shift [B,D,H,W] (f32) ->
    [B,D,H,W,C].  CUDA tensors launch the kernels (forward, and backward
    under autograd), CPU tensors run the plain version.  With column
    offsets (``x0``, ``t0``, or img of another width) the forward only,
    outside autograd."""
    _check(img, shift)
    if img.device.type == "cpu":
        return shift_1d_plain(img, shift, x0, t0)
    if x0 or t0 or img.shape[3] != shift.shape[3]:
        check_no_grad("shift_1d with column offsets", img, shift)
        return _forward(img, shift, x0, t0)
    if torch.is_grad_enabled() and (img.requires_grad or shift.requires_grad):
        return _Shift1d.apply(img, shift)
    return _forward(img, shift)   # nothing to differentiate: no autograd node
