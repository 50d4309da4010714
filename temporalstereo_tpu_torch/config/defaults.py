"""Default configuration tree: the subset of the JAX package's
``config/defaults.py`` that the port reads (``models.build_model``, the
training and evaluation steps, the datasets and loaders, the trainer:
MODEL, DATA, CHECKPOINT, TRAINER, TPU.HOST_PREFETCH, TPU.REMAT,
TPU.MESH.DATA, OPTIMIZER, SCHEDULER, VAL), with the same keys and default
values.
"""
from __future__ import annotations

import os

from .config import ConfigNode as CN


def get_default_config() -> CN:
    _C = CN()
    _C.MAX_DISP = 192
    _C.FRAME_IDXS = [0, -1]
    _C.LOG_DIR = os.path.join("./exps/")
    _C.SEED = 43

    _C.DATA = CN()
    for phase, (h, w, bs, same_lr) in {
        "TRAIN": (512, 960, 8, False),
        "VAL": (544, 960, 4, True),
        "TEST": (544, 960, 1, True),
    }.items():
        node = CN()
        node.DATA_ROOT = os.path.join("./datasets/SceneFlow/Flyingthings3D")
        node.TYPE = "SceneFlow"
        node.ANNFILE = ("./splits/flyingthings3d/train.json"
                        if phase == "TRAIN"
                        else "./splits/flyingthings3d/test.json")
        node.HEIGHT = h
        node.WIDTH = w
        node.USE_COMMON_INTRINSICS = True
        node.DO_SAME_LR_TRANSFORM = same_lr
        node.MEAN = (0.485, 0.456, 0.406)
        node.STD = (0.229, 0.224, 0.225)
        node.FRAME_IDXS = [0]
        node.BATCH_SIZE = bs
        node.NUM_WORKERS = 4
        # forkserver process workers; False: a thread pool
        node.PROCESS_WORKERS = True
        _C.DATA[phase] = node

    _C.CHECKPOINT = CN()
    _C.CHECKPOINT.EVERY_N_TRAIN_STEPS = 0
    _C.CHECKPOINT.EVERY_N_EPOCHS = 1
    _C.CHECKPOINT.KEEP = -1  # keep all

    _C.TRAINER = CN()
    _C.TRAINER.NAME = "TemporalStereo"
    _C.TRAINER.VERSION = "default"
    _C.TRAINER.MAX_EPOCHS = 10
    _C.TRAINER.MIN_EPOCHS = 1
    _C.TRAINER.PRECISION = "bf16"  # "f32" | "bf16" (compute dtype policy)
    _C.TRAINER.GRADIENT_CLIP_VAL = 0.1
    _C.TRAINER.LOG_EVERY_N_STEPS = 50
    _C.TRAINER.FLUSH_LOGS_EVERY_N_STEPS = 100
    # train-batch image dumps every N steps; 0 disables
    _C.TRAINER.VIS_EVERY_N_TRAIN_STEPS = 2000
    _C.TRAINER.CHECK_VAL_EVERY_N_EPOCHS = 1
    _C.TRAINER.RESUME_FROM_CHECKPOINT = ""
    _C.TRAINER.LOAD_FROM_CHECKPOINT = ""
    _C.TRAINER.FAST_DEV_RUN = False
    _C.TRAINER.SWA = CN()
    _C.TRAINER.SWA.ENABLED = True
    _C.TRAINER.SWA.START_FRACTION = 0.8
    _C.TRAINER.SWA.LR = 0.0  # 0 => keep scheduler lr
    _C.TRAINER.SWA.BN_UPDATE_STEPS = 50

    # batches copied to the card ahead of the running step; 0 disables
    _C.TPU = CN()
    _C.TPU.HOST_PREFETCH = 2
    # ranks of a --multihost run (parallel/mesh.py:make_data_mesh): above 0
    # it must equal the number launched; -1 takes every rank
    _C.TPU.MESH = CN()
    _C.TPU.MESH.DATA = -1
    # recompute each gradient-carrying frame's activations in the backward
    # (torch.utils.checkpoint, models/temporal.py): the BPTT memory lever
    _C.TPU.REMAT = False

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
    # a timm EfficientNetV2 state_dict (.pth) warm-starting the trunk
    _C.MODEL.BACKBONE.PRETRAINED = ""

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

    _C.MODEL.PREDICTION = CN()
    _C.MODEL.PREDICTION.NAME = "SOFTARGMIN"      # "SOFTARGMIN" | "ARGMIN"
    _C.MODEL.PREDICTION.TEMPERATURE = 1.0
    _C.MODEL.PREDICTION.NORMALIZE = True

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

    _C.VAL = CN()
    _C.VAL.VIS_INTERVAL = 8
    _C.VAL.VIS_BATCH_INDEX = 4
    _C.VAL.LOWERBOUND = 0
    _C.VAL.UPPERBOUND = 192
    _C.VAL.DO_OCCLUSION_EVALUATION = True
    _C.VAL.EVAL_DISPARITY_IDS = [0, 1, 2, 3]
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
