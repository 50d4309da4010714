"""Config tree -> the TemporalStereo network on a device.

Counterpart of the JAX package's ``models/builder.py``, with the same
variant logic.  Weights are random, drawn from a ``torch.Generator`` seeded
with ``seed`` (load real ones with ``load_state_dict``); the model is
returned in eval mode.  Convolution weights are stored in the compute type
that TRAINER.PRECISION selects; BatchNorm weights and running statistics
stay f32, as do the weights of the other norms (GN, LN), as flax keeps them
under its bf16 policy (the normalisation runs in f32 and returns the compute
type).  Training keeps f32 master copies of
every parameter in its ``TrainState`` and refreshes this working copy from
them before each step (``training/step.py``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ..config import ConfigNode
from ..nn.layers import NORMS
from .backbone import TINY_GROUPS
from .stereo import TemporalStereoNet


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; without one that is an error, not the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    return device


def _stage_cfg(node: ConfigNode, with_fusion: bool = True) -> Dict[str, Any]:
    cfg = {
        "in_planes": node.get("IN_PLANES"),
        "C": node.get("C"),
        "num_sample": node.get("NUM_SAMPLE"),
        "delta": node.get("DELTA", 1.0),
        "block_cost_scale": node.get("BLOCK_COST_SCALE", 3),
        "topk": node.get("TOPK", 2),
        "norm": node.get("NORM", "BN3d"),
        "activation": node.get("ACTIVATION", "SiLU"),
    }
    if with_fusion:
        cfg["spatial_fusion"] = node.get("SPATIAL_FUSION", True)
    return cfg


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Conv kernels ~ N(0, 2 / fan_out), biases 0, BatchNorm at identity
    statistics; every draw comes from ``generator``."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d,
                          nn.ConvTranspose3d)):
            w = m.weight
            out_ch = w.shape[1] if isinstance(
                m, (nn.ConvTranspose2d, nn.ConvTranspose3d)) else w.shape[0]
            fan_out = out_ch * math.prod(w.shape[2:])
            w.copy_(torch.randn(w.shape, generator=generator)
                    * math.sqrt(2.0 / fan_out))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, NORMS) and hasattr(m, "reset_parameters"):
            m.reset_parameters()


def build_model(cfg: ConfigNode, device=None,
                dtype: Optional[torch.dtype] = None,
                seed: int = 0) -> TemporalStereoNet:
    """Build the flagship network from a config tree, on ``device`` (the
    card by default)."""
    device = resolve_device(device)
    m = cfg.MODEL
    backbone_cfg = {
        "memory_percent": (m.BACKBONE.get("MEMORY_PERCENT", 0.0)
                           if m.get("WITH_PREVIOUS", False) else 0.0),
        "norm": m.BACKBONE.get("NORM", "BN"),
        "activation": m.BACKBONE.get("ACTIVATION", "SiLU"),
    }
    variant = m.BACKBONE.get("VARIANT", "v2s")
    if variant == "tiny":
        backbone_cfg["groups"] = TINY_GROUPS
        backbone_cfg["out_channels"] = (0, 64, 128, 256, 96)
    elif variant != "v2s":
        raise ValueError(f"unknown backbone variant {variant!r}")
    if dtype is None:
        precision = str(cfg.TRAINER.get("PRECISION", "f32"))
        dtype = torch.bfloat16 if precision in ("bf16", "16") else torch.float32
    model = TemporalStereoNet(
        backbone_cfg=backbone_cfg,
        coarse_cfg=_stage_cfg(m.AGGREGATION.COARSE),
        fine_cfg=_stage_cfg(m.AGGREGATION.FINE),
        precise_cfg=_stage_cfg(m.AGGREGATION.PRECISE, with_fusion=False),
        with_previous=m.get("WITH_PREVIOUS", False),
        use_past_cost=m.get("USE_PAST_COST", False),
        local_map_size=m.get("LOCAL_MAP_SIZE", 0),
        dtype=dtype,
    )
    init_weights(model, torch.Generator().manual_seed(seed))
    model.to(device=device, dtype=dtype)
    for m in model.modules():
        if isinstance(m, NORMS):
            m.float()
    return model.eval()
