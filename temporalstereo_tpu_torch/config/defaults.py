"""Default configuration tree: the subset of the JAX package's
``config/defaults.py`` that ``models.build_model`` reads (MODEL and
TRAINER.PRECISION), with the same keys and default values.
"""
from __future__ import annotations

from .config import ConfigNode as CN


def get_default_config() -> CN:
    _C = CN()
    _C.TRAINER = CN()
    _C.TRAINER.PRECISION = "bf16"  # "f32" | "bf16" (compute dtype policy)

    _C.MODEL = CN()
    _C.MODEL.WITH_PREVIOUS = False
    _C.MODEL.USE_PAST_COST = False
    _C.MODEL.LOCAL_MAP_SIZE = 0

    _C.MODEL.BACKBONE = CN()
    _C.MODEL.BACKBONE.VARIANT = "v2s"  # "v2s" | "tiny" (tests)
    _C.MODEL.BACKBONE.MEMORY_PERCENT = 1 / 8
    _C.MODEL.BACKBONE.NORM = "BN"
    _C.MODEL.BACKBONE.ACTIVATION = "SiLU"

    _C.MODEL.AGGREGATION = CN()
    for stage, (planes, c, nsample) in {
        "COARSE": (256, 32, 12),
        "FINE": (128, 16, 5),
        "PRECISE": (64, 8, 5),
    }.items():
        node = CN()
        node.IN_PLANES = planes
        node.C = c
        node.NUM_SAMPLE = nsample
        node.DELTA = 1.0
        node.BLOCK_COST_SCALE = 3
        node.TOPK = 2
        node.SPATIAL_FUSION = True  # ignored by PRECISE
        node.NORM = "BN3d"
        node.ACTIVATION = "SiLU"
        _C.MODEL.AGGREGATION[stage] = node
    return _C


def get_cfg(config_file: str = "", opts: list | None = None) -> CN:
    """Build a frozen config: defaults <- YAML overlay <- CLI opts."""
    cfg = get_default_config()
    if config_file:
        cfg.merge_from_file(config_file)
    if opts:
        cfg.merge_from_list(list(opts))
    cfg.freeze()
    return cfg
