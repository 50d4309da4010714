"""JAX package variables -> the port's ``state_dict``.

A copy of the numpy mapping of the JAX package's
``utils/torch_export.py:export_reference_checkpoint``: the flax ``params``
and ``batch_stats`` trees, as nested dicts of arrays, become the reference
implementation's state_dict, which is the port's.  Kernel layouts:

  Conv2d   (kh,kw,I,O)  -> [O,I,kh,kw]
  Conv3d   spatial (kh,kw,I,O) -> [O,I,1,kh,kw]; depth (kd,1,I,O) -> [O,I,kd,1,1]
  ConvT2d  (kh,kw,I,O)  -> [I,O,kh,kw]
  ConvT3d  spatial (kh,kw,I,O) -> [I,O,1,kh,kw]; depth (kd,1,I,O) -> [I,O,kd,1,1]

  Conv3d   full (kd,kh,kw,I,O) -> [O,I,kd,kh,kw] (SPP3D's 3x3x3 fuse)

A conv's ``Norm_0``: BatchNorm (BN and FrozenBN) ``scale/bias/mean/var``
become ``weight/bias/running_mean/running_var`` (``num_batches_tracked``
0); GroupNorm's and LayerNorm's ``scale/bias`` become ``weight/bias``; an
instance norm has no variables.  A conv whose norm keeps no statistics has
no subtree in ``batch_stats``: the statistics tree is always read as a
partial one.

``module_state_dict_from_jax`` converts the variables of one block off the
main path (ResidualBlock2D, BasicBlock, StereoDRNetRefinement, SPP3D,
ConvGRU) to the port module's state_dict.

With ``partial=True`` a tree that lacks some subtrees or leaves (a weights
file of part of a model) converts the tensors it holds and skips the rest.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


class _Absent:
    """A subtree or leaf a partial tree lacks: every lookup, slice and
    transpose of it is itself, and it holds no key."""

    def __getitem__(self, key):
        return self

    def get(self, key, default=None):
        return self

    def __contains__(self, key):
        return False

    def transpose(self, *axes):
        return self


ABSENT = _Absent()


class _Partial(dict):
    """A tree whose missing keys read as ``ABSENT``."""

    def __getitem__(self, key):
        value = dict.get(self, key, ABSENT)
        return _Partial(value) if isinstance(value, dict) else value

    def get(self, key, default=None):
        return self[key]


def _np(x) -> np.ndarray:
    if x is ABSENT:
        return x
    return np.asarray(x, dtype=np.float32)


class _Converter:
    def __init__(self):
        self.sd: Dict[str, np.ndarray] = {}

    def _put_bn(self, prefix: str, p: Dict[str, Any], s: Dict[str, Any]):
        self.sd[f"{prefix}.weight"] = _np(p["scale"])
        self.sd[f"{prefix}.bias"] = _np(p["bias"])
        self.sd[f"{prefix}.running_mean"] = _np(s["mean"])
        self.sd[f"{prefix}.running_var"] = _np(s["var"])
        if s["mean"] is not ABSENT:
            self.sd[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)

    def _put_norm(self, prefix: str, p, s):
        """The ``Norm_0`` subtree of a conv, if it has one."""
        if "Norm_0" not in p:
            return
        n = p["Norm_0"]
        for affine in ("GroupNorm_0", "LayerNorm_0"):
            if affine in n:
                self.sd[f"{prefix}.weight"] = _np(n[affine]["scale"])
                self.sd[f"{prefix}.bias"] = _np(n[affine]["bias"])
                return
        self._put_bn(prefix, n["BatchNorm_0"], s["Norm_0"]["BatchNorm_0"])

    def conv2d(self, prefix: str, p, s: Optional[Dict[str, Any]]):
        self.sd[f"{prefix}.weight"] = _np(p["Conv_0"]["kernel"]).transpose(
            3, 2, 0, 1)
        if "bias" in p["Conv_0"]:
            self.sd[f"{prefix}.bias"] = _np(p["Conv_0"]["bias"])
        self._put_norm(f"{prefix}.norm", p, s)

    def convt2d(self, prefix: str, p, s: Optional[Dict[str, Any]]):
        self.sd[f"{prefix}.weight"] = _np(p["kernel"]).transpose(2, 3, 0, 1)
        if "bias" in p:
            self.sd[f"{prefix}.bias"] = _np(p["bias"])
        self._put_norm(f"{prefix}.norm", p, s)

    def conv3d(self, prefix: str, kind: str, p, s: Optional[Dict[str, Any]]):
        k = _np(p["Conv_0"]["kernel"])
        if kind == "spatial":
            w = k.transpose(3, 2, 0, 1)[:, :, None]
        elif kind == "full":
            w = k.transpose(4, 3, 0, 1, 2)
        else:
            w = k[:, 0].transpose(2, 1, 0)[..., None, None]
        self.sd[f"{prefix}.weight"] = w
        if "bias" in p["Conv_0"]:
            self.sd[f"{prefix}.bias"] = _np(p["Conv_0"]["bias"])
        self._put_norm(f"{prefix}.norm", p, s)

    def convt3d(self, prefix: str, kind: str, p, s: Optional[Dict[str, Any]]):
        k = _np(p["ConvTranspose2d_0"]["kernel"])
        if kind == "spatial":
            w = k.transpose(2, 3, 0, 1)[:, :, None]
        else:
            w = k[:, 0].transpose(1, 2, 0)[..., None, None]
        self.sd[f"{prefix}.weight"] = w
        self._put_norm(f"{prefix}.norm", p, s)

    def dw3d(self, prefix: str, p, s):
        self.conv3d(f"{prefix}.conv.0", "spatial", p["Conv3d_0"],
                    s.get("Conv3d_0"))
        self.conv3d(f"{prefix}.conv.1", "depth", p["Conv3d_1"],
                    s.get("Conv3d_1"))

    def dwt3d(self, prefix: str, p, s):
        self.convt3d(f"{prefix}.conv.0", "spatial", p["ConvTranspose3d_0"],
                     s.get("ConvTranspose3d_0"))
        self.convt3d(f"{prefix}.conv.1", "depth", p["ConvTranspose3d_1"],
                     s.get("ConvTranspose3d_1"))

    def resblock3d(self, prefix: str, p, s):
        for ours, ref in (("DepthwiseConv3D_0", "conv1"),
                          ("DepthwiseConv3D_1", "conv2"),
                          ("DepthwiseConv3D_2", "conv3"),
                          ("DepthwiseConv3D_3", "conv4"),
                          ("DepthwiseConv3D_4", "shortcut5"),
                          ("DepthwiseConv3D_5", "shortcut6"),
                          ("DepthwiseConvTranspose3D_0", "conv5"),
                          ("DepthwiseConvTranspose3D_1", "conv6")):
            fn = self.dwt3d if "Transpose" in ours else self.dw3d
            fn(f"{prefix}.{ref}", p[ours], s[ours])

    def init3d(self, prefix: str, p, s):
        self.dw3d(f"{prefix}.0", p["DepthwiseConv3D_0"],
                  s["DepthwiseConv3D_0"])
        self.resblock3d(f"{prefix}.1", p["ResidualBlock3D_0"],
                        s["ResidualBlock3D_0"])
        self.dw3d(f"{prefix}.2", p["DepthwiseConv3D_1"],
                  s["DepthwiseConv3D_1"])

    def pred_heads(self, prefix: str, p, s):
        for head in ("cost_head", "off_head"):
            self.conv3d(f"{prefix}.{head}.0", "depth", p[f"{head}_0"],
                        s[f"{head}_0"])
            self.conv3d(f"{prefix}.{head}.1", "spatial", p[f"{head}_1"], None)

    def pyramid_fusion(self, prefix: str, p, s):
        self.conv3d(f"{prefix}.conv_5x5", "depth", p["Conv3d_0"],
                    s["Conv3d_0"])
        self.dw3d(f"{prefix}.conv_fuse", p["DepthwiseConv3D_0"],
                  s["DepthwiseConv3D_0"])

    def convex_upsample(self, prefix: str, p, s):
        c0, c1 = p["Conv2d_0"], p["Conv2d_1"]
        self.sd[f"{prefix}.mask.0.weight"] = _np(
            c0["Conv_0"]["kernel"]).transpose(3, 2, 0, 1)
        self.sd[f"{prefix}.mask.0.bias"] = _np(c0["Conv_0"]["bias"])
        self._put_bn(f"{prefix}.mask.1", c0["Norm_0"]["BatchNorm_0"],
                     s["Conv2d_0"]["Norm_0"]["BatchNorm_0"])
        self.sd[f"{prefix}.mask.3.weight"] = _np(
            c1["Conv_0"]["kernel"]).transpose(3, 2, 0, 1)
        self.sd[f"{prefix}.mask.3.bias"] = _np(c1["Conv_0"]["bias"])

    def unet(self, prefix: str, p, s):
        for ours, ref in (("conv2_0", "conv2.0"), ("conv2_1", "conv2.1"),
                          ("conv4_0", "conv4.0"), ("conv4_1", "conv4.1"),
                          ("fuse_0", "fuse.0"), ("fuse_1", "fuse.1"),
                          ("concat", "concat")):
            self.conv2d(f"{prefix}.{ref}", p[ours], s.get(ours))
        self.sd[f"{prefix}.deconv4.weight"] = _np(
            p["deconv4"]["kernel"]).transpose(2, 3, 0, 1)
        self.sd[f"{prefix}.deconv4.bias"] = _np(p["deconv4"]["bias"])
        self._put_norm(f"{prefix}.deconv4.norm", p["deconv4"], s["deconv4"])
        self.sd[f"{prefix}.deconv2.weight"] = _np(
            p["deconv2"]["kernel"]).transpose(2, 3, 0, 1)
        self.sd[f"{prefix}.deconv2.bias"] = _np(p["deconv2"]["bias"])

    def stage(self, prefix: str, which: str, p, s):
        self.init3d(f"{prefix}.init3d", p["Init3D_0"], s["Init3D_0"])
        self.pred_heads(f"{prefix}.pred_heads", p["PredictionHeads_0"],
                        s["PredictionHeads_0"])
        if which in ("coarse", "fine"):
            self.conv3d(f"{prefix}.past_conv", "spatial", p["past_conv"],
                        s["past_conv"])
            if "PyramidFusion_0" in p:
                self.pyramid_fusion(f"{prefix}.fuse", p["PyramidFusion_0"],
                                    s["PyramidFusion_0"])
            self.convex_upsample(f"{prefix}.convex_upsample",
                                 p["ConvexUpsample_0"], s["ConvexUpsample_0"])
        if which == "fine":
            self.sd[f"{prefix}.phi"] = _np(p["phi"])
        if which == "precise":
            self.unet(f"{prefix}.refinement", p["refinement"],
                      s["refinement"])

    def trunk_block(self, prefix: str, block_type: str, p, s):
        if block_type == "er":
            for conv, bn in (("conv_exp", "bn1"), ("conv_pwl", "bn2")):
                self.sd[f"{prefix}.{conv}.weight"] = _np(
                    p[conv]["Conv_0"]["kernel"]).transpose(3, 2, 0, 1)
                self._put_bn(f"{prefix}.{bn}",
                             p[conv]["Norm_0"]["BatchNorm_0"],
                             s[conv]["Norm_0"]["BatchNorm_0"])
            return
        self.sd[f"{prefix}.conv_pw.weight"] = _np(
            p["conv_pw"]["Conv_0"]["kernel"]).transpose(3, 2, 0, 1)
        self._put_bn(f"{prefix}.bn1", p["conv_pw"]["Norm_0"]["BatchNorm_0"],
                     s["conv_pw"]["Norm_0"]["BatchNorm_0"])
        self.sd[f"{prefix}.conv_dw.weight"] = _np(
            p["conv_dw"]["Conv_0"]["kernel"]).transpose(3, 2, 0, 1)
        self._put_bn(f"{prefix}.bn2", p["conv_dw"]["BatchNorm_0"],
                     s["conv_dw"]["BatchNorm_0"])
        if "se" in p:
            for part, ref in (("reduce", "conv_reduce"),
                              ("expand", "conv_expand")):
                self.sd[f"{prefix}.se.{ref}.weight"] = _np(
                    p["se"][part]["kernel"]).transpose(3, 2, 0, 1)
                self.sd[f"{prefix}.se.{ref}.bias"] = _np(p["se"][part]["bias"])
        self.sd[f"{prefix}.conv_pwl.weight"] = _np(
            p["conv_pwl"]["Conv_0"]["kernel"]).transpose(3, 2, 0, 1)
        self._put_bn(f"{prefix}.bn3", p["conv_pwl"]["Norm_0"]["BatchNorm_0"],
                     s["conv_pwl"]["Norm_0"]["BatchNorm_0"])

    def resblock2d(self, prefix: str, p, s):
        for ours, ref in (("Conv2d_0", "conv1"), ("Conv2d_1", "conv2"),
                          ("Conv2d_2", "conv3"), ("Conv2d_3", "conv4"),
                          ("Conv2d_4", "shortcut5"), ("Conv2d_5", "shortcut6")):
            self.conv2d(f"{prefix}{ref}", p[ours], s[ours])
        for ours, ref in (("ConvTranspose2d_0", "conv5"),
                          ("ConvTranspose2d_1", "conv6")):
            self.convt2d(f"{prefix}{ref}", p[ours], s[ours])

    def basic_block(self, prefix: str, p, s):
        self.conv2d(f"{prefix}conv1", p["Conv2d_0"], s["Conv2d_0"])
        self.conv2d(f"{prefix}conv2", p["Conv2d_1"], s["Conv2d_1"])

    def drnet(self, prefix: str, p, s):
        for ours, ref in (("Conv2d_0", "feat_conv"), ("Conv2d_1", "disp_conv"),
                          ("Conv2d_2", "final_conv")):
            self.conv2d(f"{prefix}{ref}", p[ours], s[ours])
        for i in range(6):
            self.basic_block(f"{prefix}dilated_block.{i}.",
                             p[f"BasicBlock_{i}"], s[f"BasicBlock_{i}"])

    def spp3d(self, prefix: str, p, s):
        i = 0
        while f"pool_conv_{i}" in p:
            self.conv3d(f"{prefix}pools.{i}", "spatial", p[f"pool_conv_{i}"],
                        s[f"pool_conv_{i}"])
            i += 1
        self.conv3d(f"{prefix}fuse.0", "full", p["fuse_0"], s["fuse_0"])
        self.conv3d(f"{prefix}fuse.1", "spatial", p["fuse_1"], s["fuse_1"])

    def conv_gru(self, prefix: str, p, s):
        for gate in ("convz", "convr", "convq"):
            self.conv2d(f"{prefix}{gate}", p[gate], s[gate])

    def backbone(self, p, s, groups):
        self.sd["backbone.conv_stem.weight"] = _np(
            p["conv_stem"]["Conv_0"]["kernel"]).transpose(3, 2, 0, 1)
        self._put_bn("backbone.bn1", p["conv_stem"]["Norm_0"]["BatchNorm_0"],
                     s["conv_stem"]["Norm_0"]["BatchNorm_0"])
        for gi, group in enumerate(groups):
            for si, spec in enumerate(group):
                for b in range(spec.repeats):
                    name = f"g{gi}_s{si}_b{b}"
                    self.trunk_block(f"backbone.block{gi}.{si}.{b}",
                                     spec.block_type, p[name], s[name])
        self.conv2d("backbone.conv32", p["conv32"], None)
        for name in ("deconv32_16", "deconv16_8", "deconv8_4"):
            self.conv2d(f"backbone.{name}.0", p[f"{name}_0"], s[f"{name}_0"])
            self.conv2d(f"backbone.{name}.1", p[f"{name}_1"], None)


def state_dict_from_jax(params: Dict[str, Any], batch_stats: Dict[str, Any],
                        groups=None, partial: bool = False
                        ) -> Dict[str, torch.Tensor]:
    """Flax (params, batch_stats) of the JAX package -> the port's
    state_dict (CPU tensors; load with ``strict=True``, or, of a
    ``partial`` tree, merge by name and shape)."""
    from ..models.backbone import V2S_GROUPS

    if partial:
        params = _Partial(params)
    # the convs of a GN, LN or IN norm keep no statistics
    batch_stats = _Partial(batch_stats)
    conv = _Converter()
    conv.backbone(params["backbone"], batch_stats["backbone"],
                  V2S_GROUPS if groups is None else groups)
    for which in ("coarse", "fine", "precise"):
        conv.stage(f"aggregation.{which}", which,
                   params["aggregation"][which],
                   batch_stats["aggregation"][which])
    return _tensors(conv.sd)


def _tensors(sd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, order="C"))
            for k, v in sd.items() if v is not ABSENT}


_MODULES = {"ResidualBlock2D": _Converter.resblock2d,
            "BasicBlock": _Converter.basic_block,
            "StereoDRNetRefinement": _Converter.drnet,
            "SPP3D": _Converter.spp3d,
            "ConvGRU": _Converter.conv_gru}


def module_state_dict_from_jax(module: str, params: Dict[str, Any],
                               batch_stats: Optional[Dict[str, Any]] = None
                               ) -> Dict[str, torch.Tensor]:
    """The flax variables of one JAX block (``module`` is its class name:
    ResidualBlock2D, BasicBlock, StereoDRNetRefinement, SPP3D or ConvGRU)
    -> the state_dict of the port's module of that name."""
    if module not in _MODULES:
        raise ValueError(f"no conversion for {module!r}; known: "
                         f"{sorted(_MODULES)}")
    conv = _Converter()
    _MODULES[module](conv, "", params, _Partial(batch_stats or {}))
    return _tensors(conv.sd)
