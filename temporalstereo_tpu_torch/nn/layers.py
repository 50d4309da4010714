"""Conv wrappers with a fused ``.norm`` and activation (channels-first).

Counterpart of the JAX package's ``nn/layers.py``.  Each wrapper is the torch
conv itself plus an optional norm under ``.norm`` (``get_norm``: BatchNorm,
FrozenBN, GroupNorm, InstanceNorm or LayerNorm, eps 1e-5, flax semantics,
below) and an activation, so its ``state_dict`` keys are those of the
reference implementation (``{prefix}.weight``, ``{prefix}.norm.*``).
Unlike the JAX package, separable 3D kernels stay ``nn.Conv3d`` with (1,k,k)
and (k,1,1) kernels: the JAX package folds depth into 2D convs for XLA.

Every layer here takes a weight stored in bf16 (``serving.cast_params_bf16``)
in the type of its input when that is not bf16 (``at_use``), as flax casts
parameters to the compute type at each use: a model that computes in f32
runs with bf16-stored weights.  In a bf16 model nothing is cast.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.mesh import DataMesh, all_reduce_sum
from ..parallel.spatial import active_plan

Activation = Union[str, Sequence, None]
BN_EPS = 1e-5
_RECOMPUTING = contextvars.ContextVar("recomputing", default=False)


@contextlib.contextmanager
def recomputing():
    """The context of an activation-checkpoint recompute
    (``models/temporal.py``, ``TPU.REMAT``), which runs a frame's forward
    a second time in the backward: a train-mode ``BatchNorm`` normalises
    with the batch statistics as before but leaves its running statistics
    alone, so that they are blended once per frame, as without the
    recompute (JAX's ``jax.checkpoint`` is functional and has no such
    effect to repeat)."""
    token = _RECOMPUTING.set(True)
    try:
        yield
    finally:
        _RECOMPUTING.reset(token)


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
    type.  Inside ``recomputing()`` train mode updates nothing.

    With ``mesh`` set to a mesh of more than one rank
    (``synchronise_batch_norms``), train mode takes the statistics over the
    global batch, as JAX's SPMD partitioner does: the f32 sums of the
    values and the count, then of the squared deviations from the global
    mean, each summed over the ranks by ``all_reduce_sum`` (whose backward
    sums the gradients over the ranks), and normalises and updates the
    running statistics with them, identically on every rank.  A recompute
    reduces again, in the same order on every rank, and updates nothing.
    """

    FLAX_MOMENTUM = 0.9
    mesh: Optional[DataMesh] = None

    def __init__(self, num_features: int, eps: float = BN_EPS):
        super().__init__(num_features, eps=eps,
                         momentum=1.0 - self.FLAX_MOMENTUM)

    def _check_input_dim(self, x):
        if x.dim() < 3:
            raise ValueError(f"expected [B, C, ...] input, got {x.dim()}D")

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.FLAX_MOMENTUM
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)
        self.num_batches_tracked += 1

    def _synchronised(self, x: torch.Tensor, weight, bias) -> torch.Tensor:
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        xf = x.float()
        sums = all_reduce_sum(torch.cat([
            xf.sum(dims), xf.new_tensor([xf.numel() // xf.shape[1]])]),
            self.mesh)
        n = sums[-1]
        centred = xf - (sums[:-1] / n).view(shape)
        var = all_reduce_sum(centred.square().sum(dims), self.mesh) / n
        if not _RECOMPUTING.get():
            with torch.no_grad():
                self._update_running(sums[:-1].detach() / n, var.detach())
        y = centred * torch.rsqrt(var + self.eps).view(shape)
        if weight is not None:
            y = y * weight.float().view(shape) + bias.float().view(shape)
        return y.to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = at_use(self.weight, x), at_use(self.bias, x)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                weight, bias, False, 0.0, self.eps)
        if self.mesh is not None and self.mesh.active:
            return self._synchronised(x, weight, bias)
        if not _RECOMPUTING.get():
            with torch.no_grad():
                dims = [0] + list(range(2, x.dim()))
                xf = x.detach().float()
                mean = xf.mean(dims)
                shape = [1, -1] + [1] * (x.dim() - 2)
                var = (xf - mean.view(shape)).square().mean(dims)
                self._update_running(mean, var)
        return F.batch_norm(x, None, None, weight, bias, True, 0.0, self.eps)


def synchronise_batch_norms(model: nn.Module,
                            mesh: Optional[DataMesh]) -> None:
    """Let every train-mode ``BatchNorm`` of ``model`` take its statistics
    over the ranks of ``mesh``: only where the mesh crosses processes, so
    that a one-rank run keeps ``F.batch_norm``'s path bit for bit."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.mesh = mesh if mesh is not None and mesh.active else None


class FrozenBatchNorm(BatchNorm):
    """The JAX package's ``FrozenBN``: a BatchNorm that normalises with its
    running statistics in every mode and never updates them (flax
    ``BatchNorm(use_running_average=True)``).  Its affine weights train."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            at_use(self.weight, x), at_use(self.bias, x),
                            False, 0.0, self.eps)


class _AffineNorm(nn.Module):
    """A per-channel scale and bias over dim 1 (``weight``, ``bias``, f32
    like BatchNorm's); the statistics run in f32 and the output takes the
    input's type, as flax's norms compute under a bf16 policy.  torch's
    norms take the variance in two passes where flax's take
    max(0, E[x^2] - mean^2): the two agree within 1e-5 on the inputs of
    ``tests/test_torch_surface.py``."""

    def __init__(self, num_features: int, eps: float = BN_EPS):
        super().__init__()
        self.num_features, self.eps = num_features, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()


class GroupNorm(_AffineNorm):
    """flax ``GroupNorm(num_groups=max(1, C // 32))`` over [B, C, ...]:
    each group of C / G channels is normalised over its channels and every
    spatial position."""

    def __init__(self, num_features: int, eps: float = BN_EPS):
        super().__init__(num_features, eps)
        self.groups = max(1, num_features // 32)
        if num_features % self.groups:
            raise ValueError(f"{self.groups} groups do not divide "
                             f"{num_features} channels")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # F.group_norm reduces each (sample, group) in one thread block,
        # which leaves most of the card idle at B=1 with a few groups
        # (PERF.md §6): one reduction over the whole tensor for the
        # statistics, then one multiply-add with per-channel factors
        b, c = x.shape[:2]
        xf = x.float()
        var, mean = torch.var_mean(xf.reshape(b, self.groups, -1), -1,
                                   correction=0)
        per = c // self.groups
        scale = (torch.rsqrt(var + self.eps).repeat_interleave(per, 1)
                 * self.weight.float())
        shift = self.bias.float() - mean.repeat_interleave(per, 1) * scale
        shape = (b, c) + (1,) * (x.dim() - 2)
        return torch.addcmul(shift.view(shape), xf,
                             scale.view(shape)).to(x.dtype)


class LayerNorm(_AffineNorm):
    """flax ``LayerNorm`` of a channels-last tensor: each position is
    normalised over its channels only, here dim 1 of [B, C, ...] (moved
    last for ``F.layer_norm``, which normalises the trailing dims)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float().movedim(1, -1), (self.num_features,),
                         self.weight.float(), self.bias.float(), self.eps)
        return y.movedim(-1, 1).to(x.dtype)


class InstanceNorm(nn.Module):
    """The JAX package's ``IN``: each channel of each sample normalised
    over every spatial position, with the biased variance and no
    parameters; f32 statistics, the output in the input's type."""

    def __init__(self, num_features: int, eps: float = BN_EPS):
        super().__init__()
        self.num_features, self.eps = num_features, eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.instance_norm(x.float(), eps=self.eps).to(x.dtype)


BATCH_NORMS = ("BN", "BN1d", "BN3d", "SyncBN", "nnSyncBN", "naiveSyncBN")
NORMS = (BatchNorm, GroupNorm, LayerNorm, InstanceNorm)


def get_norm(kind: Optional[str], channels: int) -> Optional[nn.Module]:
    """The norm a config names (``MODEL.BACKBONE.NORM``, each stage's
    ``NORM``): the JAX package's ``nn/layers.py:Norm`` kinds."""
    if kind is None or kind == "None":
        return None
    if kind in BATCH_NORMS:
        return BatchNorm(channels)
    table = {"FrozenBN": FrozenBatchNorm, "GN": GroupNorm, "IN": InstanceNorm,
             "LN": LayerNorm}
    if kind not in table:
        raise ValueError(f"unsupported norm {kind!r}")
    return table[kind](channels)


class _NormAct:
    def _setup(self, norm, activation, channels):
        self.norm = get_norm(norm, channels)
        self.act = get_activation(activation)

    def _post(self, y):
        if self.norm is not None:
            y = self.norm(y)
        return self.act(y)


class _CastAtUse:
    """A convolution that takes its weights ``at_use``; inside a W-sharded
    forward (``parallel/spatial.py``) it takes its W halo from the
    neighbouring ranks."""

    def _conv_forward(self, x, weight, bias):
        weight, bias = at_use(weight, x), at_use(bias, x)
        plan = active_plan()
        if plan is not None:
            return plan.conv(x, weight, bias, self.stride, self.padding,
                             self.dilation, self.groups)
        return super()._conv_forward(x, weight, bias)


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


class _Transposed:
    """A transposed convolution that takes its weights ``at_use`` (and its
    W halo inside a W-sharded forward)."""

    def forward(self, x):
        weight, bias = at_use(self.weight, x), at_use(self.bias, x)
        plan = active_plan()
        if plan is not None:
            y = plan.conv_transpose(x, weight, bias, self.stride,
                                    self.padding, self.output_padding,
                                    self.groups, self.dilation)
        else:
            fn = F.conv_transpose2d if x.dim() == 4 else F.conv_transpose3d
            y = fn(x, weight, bias, self.stride, self.padding,
                   self.output_padding, self.groups, self.dilation)
        return self._post(y)


class ConvTranspose2d(_Transposed, nn.ConvTranspose2d, _NormAct):
    def __init__(self, in_channels, out_channels, kernel_size=3, stride=2,
                 padding=1, output_padding=1, bias=True, norm=None,
                 activation=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, bias=bias)
        self._setup(norm, activation, out_channels)


class ConvTranspose3d(_Transposed, nn.ConvTranspose3d, _NormAct):
    def __init__(self, in_channels, out_channels, kernel_size=3, stride=2,
                 padding=1, output_padding=1, bias=True, norm=None,
                 activation=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, bias=bias)
        self._setup(norm, activation, out_channels)


class ConvGRU(nn.Module):
    """Convolutional GRU cell (the JAX package's ``nn/layers.py:ConvGRU``):
    h, x [B, C, H, W] -> the next h [B, hidden, H, W].  ``MODEL.BACKBONE.
    USE_GRU`` leaves it unused; it is here for the API."""

    def __init__(self, hidden_planes: int, in_planes: int,
                 kernel_size: int = 3):
        super().__init__()
        pad = kernel_size // 2
        c = hidden_planes + in_planes
        self.convz = Conv2d(c, hidden_planes, kernel_size, 1, pad)
        self.convr = Conv2d(c, hidden_planes, kernel_size, 1, pad)
        self.convq = Conv2d(c, hidden_planes, kernel_size, 1, pad)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q
