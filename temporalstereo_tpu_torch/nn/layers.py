"""Conv wrappers with a fused ``.norm`` and activation (channels-first).

Counterpart of the JAX package's ``nn/layers.py``.  Each wrapper is the torch
conv itself plus an optional BatchNorm under ``.norm`` (eps 1e-5, used in
eval mode) and an activation, so its ``state_dict`` keys are those of the
reference implementation (``{prefix}.weight``, ``{prefix}.norm.*``).  Unlike
the JAX package, separable 3D kernels stay ``nn.Conv3d`` with (1,k,k) and
(k,1,1) kernels: the JAX package folds depth into 2D convs for XLA.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

Activation = Union[str, Sequence, None]
BN_EPS = 1e-5


def get_activation(activation: Activation) -> Callable[[torch.Tensor],
                                                       torch.Tensor]:
    """Activation by name (case-insensitive); None is the identity."""
    if activation is None:
        return lambda x: x
    if isinstance(activation, (tuple, list)):
        name, *args = activation
    else:
        name, args = activation, []
    name = name.lower()
    if name == "leakyrelu":
        slope = args[0] if args else 0.01
        return lambda x: F.leaky_relu(x, negative_slope=slope)
    table = {
        "relu": F.relu,
        "silu": F.silu,
        "swish": F.silu,
        "elu": F.elu,
        "selu": F.selu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu
        "hardswish": F.hardswish,
        "mish": F.mish,
        "sigmoid": torch.sigmoid,
        "tanh": torch.tanh,
    }
    if name not in table:
        raise ValueError(f"unsupported activation {activation!r}")
    return table[name]


def _norm(kind: Optional[str], channels: int, dims: int) -> Optional[nn.Module]:
    if kind is None or kind == "None":
        return None
    if kind in ("BN", "BN1d", "BN3d", "SyncBN", "nnSyncBN", "naiveSyncBN",
                "FrozenBN"):
        return (nn.BatchNorm3d if dims == 3 else nn.BatchNorm2d)(
            channels, eps=BN_EPS)
    raise ValueError(f"unsupported norm {kind!r}")


class _NormAct:
    def _setup(self, norm, activation, channels, dims):
        self.norm = _norm(norm, channels, dims)
        self.act = get_activation(activation)

    def _post(self, y):
        if self.norm is not None:
            y = self.norm(y)
        return self.act(y)


class Conv2d(nn.Conv2d, _NormAct):
    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=0, dilation=1, bias=True, norm=None, activation=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, bias=bias)
        self._setup(norm, activation, out_channels, 2)

    def forward(self, x):
        return self._post(super().forward(x))


class Conv3d(nn.Conv3d, _NormAct):
    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=0, dilation=1, bias=True, norm=None, activation=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, bias=bias)
        self._setup(norm, activation, out_channels, 3)

    def forward(self, x):
        return self._post(super().forward(x))


class ConvTranspose2d(nn.ConvTranspose2d, _NormAct):
    def __init__(self, in_channels, out_channels, kernel_size=3, stride=2,
                 padding=1, output_padding=1, bias=True, norm=None,
                 activation=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, bias=bias)
        self._setup(norm, activation, out_channels, 2)

    def forward(self, x):
        return self._post(super().forward(x))


class ConvTranspose3d(nn.ConvTranspose3d, _NormAct):
    def __init__(self, in_channels, out_channels, kernel_size=3, stride=2,
                 padding=1, output_padding=1, bias=True, norm=None,
                 activation=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, bias=bias)
        self._setup(norm, activation, out_channels, 3)

    def forward(self, x):
        return self._post(super().forward(x))
