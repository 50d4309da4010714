"""Plain layers of the reference: convolutions with an optional BatchNorm
(eval mode: the running statistics) and activation, channels-first.

Module and parameter names follow the measured program's state_dict
(``{prefix}.weight``, ``{prefix}.norm.*``), so one state_dict loads into
both.  Every convolution runs in the type of its input (float32 here);
``rounding = "fp8"`` on a convolution rounds its input and weight to
float8 e4m3 with one scale each, the control of the benchmark's check.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5
FP8_MAX = 448.0          # largest finite float8_e4m3fn


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale (its largest magnitude
    maps to the largest finite value), back in ``x``'s type."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


ROUNDING = {"fp8": round_fp8, "bf16": round_bf16}


def activation(name: Optional[str]):
    if name is None:
        return lambda x: x
    table = {"silu": F.silu, "swish": F.silu, "relu": F.relu}
    if name.lower() not in table:
        raise ValueError(f"unsupported activation {name!r}")
    return table[name.lower()]


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """Eval-mode BatchNorm over [B, C, ...]: the running statistics."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS)

    def _check_input_dim(self, x):
        if x.dim() < 3:
            raise ValueError(f"expected [B, C, ...] input, got {x.dim()}D")

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


BATCH_NORMS = ("BN", "BN1d", "BN3d", "SyncBN", "nnSyncBN", "naiveSyncBN")


def norm(kind: Optional[str], channels: int) -> Optional[nn.Module]:
    if kind is None or kind == "None":
        return None
    if kind in BATCH_NORMS:
        return BatchNorm(channels)
    raise ValueError(f"the reference has no norm {kind!r}")


class _Conv:
    rounding: Optional[str] = None

    def _setup(self, norm_kind, act):
        self.norm = norm(norm_kind, self.out_channels)
        self.act = activation(act)

    def _operands(self, x):
        w, b = self.weight.to(x.dtype), self.bias
        b = None if b is None else b.to(x.dtype)
        if self.rounding is not None:
            rnd = ROUNDING[self.rounding]
            return rnd(x), rnd(w), b
        return x, w, b

    def _post(self, y):
        if self.norm is not None:
            y = self.norm(y)
        return self.act(y)


class Conv2d(_Conv, nn.Conv2d):
    def __init__(self, cin, cout, kernel_size=3, stride=1, padding=0,
                 dilation=1, bias=True, norm=None, activation=None, groups=1):
        super().__init__(cin, cout, kernel_size, stride, padding, dilation,
                         groups=groups, bias=bias)
        self._setup(norm, activation)

    def forward(self, x):
        x, w, b = self._operands(x)
        return self._post(F.conv2d(x, w, b, self.stride, self.padding,
                                   self.dilation, self.groups))


class Conv3d(_Conv, nn.Conv3d):
    def __init__(self, cin, cout, kernel_size=3, stride=1, padding=0,
                 dilation=1, bias=True, norm=None, activation=None):
        super().__init__(cin, cout, kernel_size, stride, padding, dilation,
                         bias=bias)
        self._setup(norm, activation)

    def forward(self, x):
        x, w, b = self._operands(x)
        return self._post(F.conv3d(x, w, b, self.stride, self.padding,
                                   self.dilation, self.groups))


class ConvTranspose2d(_Conv, nn.ConvTranspose2d):
    def __init__(self, cin, cout, kernel_size=3, stride=2, padding=1,
                 output_padding=1, bias=True, norm=None, activation=None):
        super().__init__(cin, cout, kernel_size, stride, padding,
                         output_padding, bias=bias)
        self._setup(norm, activation)

    def forward(self, x):
        x, w, b = self._operands(x)
        return self._post(F.conv_transpose2d(
            x, w, b, self.stride, self.padding, self.output_padding,
            self.groups, self.dilation))


class ConvTranspose3d(_Conv, nn.ConvTranspose3d):
    def __init__(self, cin, cout, kernel_size=3, stride=2, padding=1,
                 output_padding=1, bias=True, norm=None, activation=None):
        super().__init__(cin, cout, kernel_size, stride, padding,
                         output_padding, bias=bias)
        self._setup(norm, activation)

    def forward(self, x):
        x, w, b = self._operands(x)
        return self._post(F.conv_transpose3d(
            x, w, b, self.stride, self.padding, self.output_padding,
            self.groups, self.dilation))


def set_rounding(model: nn.Module, rounding: Optional[str]) -> None:
    """Round every convolution's operands (a key of ``ROUNDING``) or not
    (None)."""
    for m in model.modules():
        if isinstance(m, _Conv):
            m.rounding = rounding
