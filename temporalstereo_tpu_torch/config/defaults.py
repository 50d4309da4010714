"""Default configuration tree: the subset of the JAX package's
``config/defaults.py`` that the port reads (``models.build_model`` and the
training step: MODEL, the TRAIN data shape, TRAINER precision, clip and
SWA, OPTIMIZER, SCHEDULER), with the same keys and default values.
"""
from __future__ import annotations

from .config import ConfigNode as CN


def get_default_config() -> CN:
    _C = CN()
    _C.FRAME_IDXS = [0, -1]

    _C.DATA = CN()
    _C.DATA.TRAIN = CN()
    _C.DATA.TRAIN.HEIGHT = 512
    _C.DATA.TRAIN.WIDTH = 960
    _C.DATA.TRAIN.BATCH_SIZE = 8
    _C.DATA.TRAIN.FRAME_IDXS = [0]

    _C.TRAINER = CN()
    _C.TRAINER.PRECISION = "bf16"  # "f32" | "bf16" (compute dtype policy)
    _C.TRAINER.GRADIENT_CLIP_VAL = 0.1
    _C.TRAINER.SWA = CN()
    _C.TRAINER.SWA.ENABLED = True
    _C.TRAINER.SWA.START_FRACTION = 0.8
    _C.TRAINER.SWA.LR = 0.0  # 0 => keep scheduler lr
    _C.TRAINER.SWA.BN_UPDATE_STEPS = 50

    _C.OPTIMIZER = CN()
    _C.OPTIMIZER.TYPE = "RMSProp"
    _C.OPTIMIZER.RMSPROP = CN()
    _C.OPTIMIZER.RMSPROP.LR = 1e-3
    _C.OPTIMIZER.ADAM = CN()
    _C.OPTIMIZER.ADAM.LR = 1e-3
    _C.OPTIMIZER.ADAM.BETAS = (0.9, 0.999)
    _C.OPTIMIZER.ADAMW = CN()
    _C.OPTIMIZER.ADAMW.LR = 1e-3
    _C.OPTIMIZER.ADAMW.BETAS = (0.9, 0.999)
    _C.OPTIMIZER.ADAMW.WEIGHT_DECAY = 1e-4

    _C.SCHEDULER = CN()
    _C.SCHEDULER.TYPE = "MultiStepLR"
    _C.SCHEDULER.STEP_LR = CN()
    _C.SCHEDULER.STEP_LR.STEP_SIZE = 10
    _C.SCHEDULER.STEP_LR.GAMMA = 0.1
    _C.SCHEDULER.MULTI_STEP_LR = CN()
    _C.SCHEDULER.MULTI_STEP_LR.MILESTONES = [10, 20]
    _C.SCHEDULER.MULTI_STEP_LR.GAMMA = 0.1
    _C.SCHEDULER.EXPONENTIAL_LR = CN()
    _C.SCHEDULER.EXPONENTIAL_LR.GAMMA = 0.9

    _C.MODEL = CN()
    _C.MODEL.WITH_PREVIOUS = False
    _C.MODEL.PREVIOUS_WITH_GRADIENT = False
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

    _C.MODEL.LOSSES = CN()
    # the JAX package's (and the reference's) spelling
    _C.MODEL.LOSSES.WARSSERSTEIN_DISTANCE_LOSS = CN()
    _C.MODEL.LOSSES.WARSSERSTEIN_DISTANCE_LOSS.MAX_DISP = 192
    _C.MODEL.LOSSES.WARSSERSTEIN_DISTANCE_LOSS.START_DISP = 0
    _C.MODEL.LOSSES.WARSSERSTEIN_DISTANCE_LOSS.GLOBAL_WEIGHT = 1.0
    _C.MODEL.LOSSES.WARSSERSTEIN_DISTANCE_LOSS.WEIGHTS = [1.2, 0.3, 0.1]
    _C.MODEL.LOSSES.WARSSERSTEIN_DISTANCE_LOSS.SPARSE = False
    _C.MODEL.LOSSES.SMOOTH_L1_LOSS = CN()
    _C.MODEL.LOSSES.SMOOTH_L1_LOSS.MAX_DISP = 192
    _C.MODEL.LOSSES.SMOOTH_L1_LOSS.START_DISP = 0
    _C.MODEL.LOSSES.SMOOTH_L1_LOSS.GLOBAL_WEIGHT = 1.0
    # 4 levels: [full, 1/4-refined, 1/4, 1/8]
    _C.MODEL.LOSSES.SMOOTH_L1_LOSS.WEIGHTS = [2.0, 1.0, 0.7, 0.5]
    _C.MODEL.LOSSES.SMOOTH_L1_LOSS.SPARSE = False
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
