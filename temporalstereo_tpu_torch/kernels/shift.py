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
does.  The backward's img gradient sums with atomicAdd, so its last bits
vary from run to run.
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from .launches import LAUNCHES, cuda_device_index

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FNS = {}


def _kernels():
    if not _FNS:
        from .build import load

        lib = load("shift_1d")
        fwd, bwd = lib.shift_1d_forward, lib.shift_1d_backward
        fwd.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                        + [ctypes.c_void_p])
        bwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                        + [ctypes.c_void_p])
        fwd.restype = bwd.restype = ctypes.c_int
        _FNS.update(forward=fwd, backward=bwd)
    return _FNS


def _check(img, shift):
    if shift.dim() != 4 or img.dim() != 5:
        raise ValueError(f"img {tuple(img.shape)} must be [B,D,H,W,C] and "
                         f"shift {tuple(shift.shape)} [B,D,H,W]")
    b, d, h, w = shift.shape
    if img.shape[0] != b or img.shape[1] not in (1, d) \
            or img.shape[2:4] != (h, w):
        raise ValueError(f"img {tuple(img.shape)} does not match shift "
                         f"{tuple(shift.shape)}")
    if img.dtype not in _DTYPES:
        raise TypeError(f"img must be float32 or bfloat16, got {img.dtype}")
    if shift.dtype != torch.float32:
        raise TypeError(f"shift must be float32, got {shift.dtype}")


def shift_1d_plain(img: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch (``ops/warp.py:shift_1d``); torch
    autograd differentiates it."""
    from ..ops.warp import shift_1d as plain

    _check(img, shift)
    return plain(img, shift)


def _dims(img, shift):
    b, d, h, w = shift.shape
    return b, d, img.shape[1], h, w, img.shape[-1]


def _forward(img, shift):
    device = cuda_device_index("shift_1d", img, shift)
    b, d, di, h, w, c = _dims(img, shift)
    out = torch.empty((b, d, h, w, c), dtype=img.dtype, device=img.device)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    err = _kernels()["forward"](img.data_ptr(), shift.data_ptr(),
                                out.data_ptr(), b, d, di, h, w, c,
                                _DTYPES[img.dtype], device, stream)
    if err:
        raise RuntimeError(f"shift_1d: launch failed, CUDA error {err}")
    LAUNCHES["shift_1d"] += 1
    return out


def shift_1d_backward(grad_out: torch.Tensor, img: torch.Tensor,
                      shift: torch.Tensor):
    """The backward kernel: grad_out [B, D, H, W, C] -> (grad_img in img's
    shape and type, grad_shift [B, D, H, W] f32)."""
    _check(img, shift)
    b, d, di, h, w, c = _dims(img, shift)
    if grad_out.shape != (b, d, h, w, c) or grad_out.dtype != img.dtype:
        raise ValueError(f"output gradient {tuple(grad_out.shape)} "
                         f"{grad_out.dtype} does not match the forward")
    device = cuda_device_index("shift_1d_backward", grad_out, img, shift)
    grad_img = torch.zeros(img.shape, dtype=torch.float32, device=img.device)
    grad_shift = torch.zeros_like(shift)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    err = _kernels()["backward"](grad_out.data_ptr(), img.data_ptr(),
                                 shift.data_ptr(), grad_img.data_ptr(),
                                 grad_shift.data_ptr(), b, d, di, h, w, c,
                                 _DTYPES[img.dtype], device, stream)
    if err:
        raise RuntimeError("shift_1d_backward: launch failed, CUDA error "
                           f"{err}")
    LAUNCHES["shift_1d_backward"] += 1
    return grad_img.to(img.dtype), grad_shift


class _Shift1d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, shift):
        ctx.save_for_backward(img, shift)
        return _forward(img, shift)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        return shift_1d_backward(grad_out.contiguous(), *ctx.saved_tensors)


def shift_1d(img: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """img [B,D|1,H,W,C] (f32 or bf16) + shift [B,D,H,W] (f32) ->
    [B,D,H,W,C].  CUDA tensors launch the kernels (forward, and backward
    under autograd), CPU tensors run the plain version."""
    _check(img, shift)
    if img.device.type == "cpu":
        return shift_1d_plain(img, shift)
    return _Shift1d.apply(img, shift)
