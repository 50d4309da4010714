"""Conv wrappers with a fused ``.norm`` and activation (channels-first).

Counterpart of the JAX package's ``nn/layers.py``.  Each wrapper is the torch
conv itself plus an optional ``BatchNorm`` under ``.norm`` (eps 1e-5, flax
semantics, below) and an activation, so its ``state_dict`` keys are those of
the reference implementation (``{prefix}.weight``, ``{prefix}.norm.*``).
Unlike the JAX package, separable 3D kernels stay ``nn.Conv3d`` with (1,k,k)
and (k,1,1) kernels: the JAX package folds depth into 2D convs for XLA.

Every layer here takes a weight stored in bf16 (``serving.cast_params_bf16``)
in the type of its input when that is not bf16 (``at_use``), as flax casts
parameters to the compute type at each use: a model that computes in f32
runs with bf16-stored weights.  In a bf16 model nothing is cast.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

Activation = Union[str, Sequence, None]
BN_EPS = 1e-5


def at_use(p: Optional[torch.Tensor], x: torch.Tensor
           ) -> Optional[torch.Tensor]:
    """A bf16-stored weight in ``x``'s type where ``x`` is not bf16; any
    other weight as it is."""
    if p is not None and p.dtype == torch.bfloat16 and x.dtype != p.dtype:
        return p.to(x.dtype)
    return p


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


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """BatchNorm over [B, C, ...] with the JAX package's flax semantics
    (``nn/layers.py:Norm``: ``nn.BatchNorm(momentum=0.9,
    use_fast_variance=False)``).

    Eval mode normalises with the running statistics.  Train mode
    normalises with the batch mean and biased variance (as torch does) and
    updates ``running_mean``/``running_var`` as 0.9 * old + 0.1 * batch
    statistic, with the *biased* variance (torch's own layer takes the
    unbiased one there).  The batch statistics for that update are computed
    in f32 whatever the input type, the variance in two passes.  Weights and
    statistics may stay f32 under a bf16 input; the output takes the input's
    type.
    """

    FLAX_MOMENTUM = 0.9

    def __init__(self, num_features: int, eps: float = BN_EPS):
        super().__init__(num_features, eps=eps,
                         momentum=1.0 - self.FLAX_MOMENTUM)

    def _check_input_dim(self, x):
        if x.dim() < 3:
            raise ValueError(f"expected [B, C, ...] input, got {x.dim()}D")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = at_use(self.weight, x), at_use(self.bias, x)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                weight, bias, False, 0.0, self.eps)
        with torch.no_grad():
            dims = [0] + list(range(2, x.dim()))
            xf = x.detach().float()
            mean = xf.mean(dims)
            shape = [1, -1] + [1] * (x.dim() - 2)
            var = (xf - mean.view(shape)).square().mean(dims)
            m = self.FLAX_MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
            self.num_batches_tracked += 1
        return F.batch_norm(x, None, None, weight, bias, True, 0.0, self.eps)


def _norm(kind: Optional[str], channels: int) -> Optional[nn.Module]:
    if kind is None or kind == "None":
        return None
    if kind in ("BN", "BN1d", "BN3d", "SyncBN", "nnSyncBN", "naiveSyncBN",
                "FrozenBN"):
        return BatchNorm(channels)
    raise ValueError(f"unsupported norm {kind!r}")


class _NormAct:
    def _setup(self, norm, activation, channels):
        self.norm = _norm(norm, channels)
        self.act = get_activation(activation)

    def _post(self, y):
        if self.norm is not None:
            y = self.norm(y)
        return self.act(y)


class _CastAtUse:
    """A convolution that takes its weights ``at_use``."""

    def _conv_forward(self, x, weight, bias):
        return super()._conv_forward(x, at_use(weight, x), at_use(bias, x))


class Conv2d(_CastAtUse, nn.Conv2d, _NormAct):
    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=0, dilation=1, bias=True, norm=None, activation=None,
                 groups=1):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups=groups, bias=bias)
        self._setup(norm, activation, out_channels)

    def forward(self, x):
        return self._post(super().forward(x))


class Conv3d(_CastAtUse, nn.Conv3d, _NormAct):
    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=0, dilation=1, bias=True, norm=None, activation=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, bias=bias)
        self._setup(norm, activation, out_channels)

    def forward(self, x):
        return self._post(super().forward(x))


class ConvTranspose2d(nn.ConvTranspose2d, _NormAct):
    def __init__(self, in_channels, out_channels, kernel_size=3, stride=2,
                 padding=1, output_padding=1, bias=True, norm=None,
                 activation=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, bias=bias)
        self._setup(norm, activation, out_channels)

    def forward(self, x):
        return self._post(F.conv_transpose2d(
            x, at_use(self.weight, x), at_use(self.bias, x), self.stride,
            self.padding, self.output_padding, self.groups, self.dilation))


class ConvTranspose3d(nn.ConvTranspose3d, _NormAct):
    def __init__(self, in_channels, out_channels, kernel_size=3, stride=2,
                 padding=1, output_padding=1, bias=True, norm=None,
                 activation=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, bias=bias)
        self._setup(norm, activation, out_channels)

    def forward(self, x):
        return self._post(F.conv_transpose3d(
            x, at_use(self.weight, x), at_use(self.bias, x), self.stride,
            self.padding, self.output_padding, self.groups, self.dilation))
