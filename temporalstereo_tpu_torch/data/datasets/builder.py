"""Dataset and loader from a config node.

Counterpart of the JAX package's ``data/datasets/builder.py``.
"""
from __future__ import annotations

from ...config import ConfigNode
from ...utils.registry import DATASET_REGISTRY
from ..loader import DataLoader
from . import extra_formats, kitti, scene_flow, tartanair, vkitti  # noqa: F401

_TYPE_ALIASES = {
    "SceneFlow": "SceneFlow",
    "KITTI2015": "KITTI2015",
    "KITTIRAW": "KITTIRAW",
    "TartanAir": "TartanAir",
    "TARTANAIR": "TartanAir",
    "VKITTI2": "VKITTI2",
    "VKITTI": "VKITTI2",
    "ETH3D": "ETH3D",
    "DrivingStereo": "DrivingStereo",
}


def build_stereo_dataset(node: ConfigNode, phase: str):
    """node: cfg.DATA.TRAIN / VAL / TEST; phase: 'train' | 'val' | 'test'."""
    cls = DATASET_REGISTRY.get(_TYPE_ALIASES.get(node.TYPE, node.TYPE))
    return cls(
        annfile=node.ANNFILE,
        root=node.DATA_ROOT,
        height=node.HEIGHT,
        width=node.WIDTH,
        frame_idxs=list(node.FRAME_IDXS),
        is_train=(phase == "train"),
        use_common_intrinsics=node.get("USE_COMMON_INTRINSICS", True),
        do_same_lr_transform=node.get("DO_SAME_LR_TRANSFORM", True),
        mean=tuple(node.get("MEAN", (0.485, 0.456, 0.406))),
        std=tuple(node.get("STD", (0.229, 0.224, 0.225))),
    )


def build_dataloader(node: ConfigNode, phase: str, num_shards: int = 1,
                     shard_index: int = 0) -> DataLoader:
    """Training shuffles and drops the last partial batch; evaluation
    keeps the dataset's order and every sample."""
    return DataLoader(
        build_stereo_dataset(node, phase),
        batch_size=node.BATCH_SIZE,
        shuffle=(phase == "train"),
        drop_last=(phase == "train"),
        num_workers=node.get("NUM_WORKERS", 4),
        num_shards=num_shards,
        shard_index=shard_index,
        use_processes=node.get("PROCESS_WORKERS", True),
    )
