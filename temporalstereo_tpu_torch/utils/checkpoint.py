"""Load weights into the port's model.

Counterpart of the torch branch of the JAX package's
``training/checkpoint.py:load_any_weights``.  The port reads the reference
layout that the JAX package's ``utils/torch_export.py`` writes (a
Lightning ``.ckpt`` with a ``state_dict``) and that
``utils/convert.py:state_dict_from_jax`` produces: ``.ckpt``, ``.pth`` and
``.pt`` files of a state_dict, bare or under ``"state_dict"`` or
``"model"``.  They merge as the JAX package's ``warm_start(strict=False)``
does: a tensor whose name and shape match the model's is loaded, every
other tensor of the model keeps its value, and the file's other entries
are ignored.  (A 0-d entry stored as shape [1], as the exporter writes
BatchNorm's ``num_batches_tracked``, matches: ``load_state_dict`` takes it
so.)  The JAX package's own ``.msgpack`` weights files
(``training/checkpoint.py:save_weights``) are read without JAX by
``utils/flax_msgpack.py``, and the ``params`` and ``batch_stats`` of its
orbax ``CheckpointManager`` directories (the latest step) without orbax,
tensorstore or JAX by ``utils/orbax.py``; both merge the same way, as the
JAX package's ``load_any_weights`` merges them.

``backbone_from_timm`` renames a timm EfficientNetV2 state_dict (ImageNet
weights of the trunk) to the port's backbone names; the trainer merges it
the same way (``MODEL.BACKBONE.PRETRAINED``).
"""
from __future__ import annotations

import os
from typing import Dict, Sequence

import torch
import torch.nn as nn

TORCH_EXTENSIONS = (".ckpt", ".pth", ".pt")
MSGPACK_EXTENSION = ".msgpack"

# the tensors of a timm block that the port's blocks hold, by block type
_BN = ("weight", "bias", "running_mean", "running_var")
_TIMM_BLOCK_KEYS = {
    "er": (["conv_exp.weight", "conv_pwl.weight"]
           + [f"bn{i}.{s}" for i in (1, 2) for s in _BN]),
    "ir": (["conv_pw.weight", "conv_dw.weight", "conv_pwl.weight",
            "se.conv_reduce.weight", "se.conv_reduce.bias",
            "se.conv_expand.weight", "se.conv_expand.bias"]
           + [f"bn{i}.{s}" for i in (1, 2, 3) for s in _BN]),
}


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a torch checkpoint file, or of the JAX package's
    ``.msgpack`` weights or orbax checkpoint directory (its latest step's
    ``params`` and ``batch_stats``) by the port's names, on the CPU."""
    if path.endswith(MSGPACK_EXTENSION):
        from .flax_msgpack import read_state_dict as read_msgpack

        return read_msgpack(path)
    if os.path.isdir(path):
        from .flax_msgpack import tree_state_dict
        from .orbax import is_orbax_directory, read_checkpoint

        if not is_orbax_directory(path):
            raise FileNotFoundError(f"{path}: no orbax checkpoint steps "
                                    "(<step>/_CHECKPOINT_METADATA)")
        return tree_state_dict(read_checkpoint(path))
    if not path.endswith(TORCH_EXTENSIONS):
        raise ValueError(
            f"{path}: the port loads {'/'.join(TORCH_EXTENSIONS)} "
            f"checkpoints, {MSGPACK_EXTENSION} weights and orbax checkpoint "
            "directories; convert other weights with python -m "
            "temporalstereo_tpu.cli.export_reference")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    if "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    return {k: v for k, v in sd.items() if torch.is_tensor(v)}


def matching_entries(own: Dict[str, torch.Tensor],
                     sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The entries of ``sd`` whose name is in ``own`` with the same shape
    (or a 0-d target stored as [1])."""
    def fits(name, value):
        target = own.get(name)
        return (target is not None
                and (value.shape == target.shape
                     or (target.dim() == 0 and value.shape == (1,))))
    return {k: v for k, v in sd.items() if fits(k, v)}


def load_weights(model: nn.Module, path: str) -> int:
    """Merge a torch checkpoint or a JAX ``.msgpack`` weights file into
    ``model`` (in place) -> the number of its tensors loaded (those whose
    name and shape match)."""
    matched = matching_entries(model.state_dict(), read_state_dict(path))
    model.load_state_dict(matched, strict=False)
    return len(matched)


def backbone_from_timm(sd: Dict[str, torch.Tensor], groups: Sequence
                       ) -> Dict[str, torch.Tensor]:
    """A timm EfficientNetV2 state_dict -> the port's names for its trunk.

    timm numbers the trunk's stages flat (``blocks.{S}.{B}``); the port
    keeps the reference's FPN groups (``block{g}.{s}.{B}``), S enumerating
    (g, s) in order.  The stem is ``conv_stem`` + ``bn1`` in both.  Only
    the convolutions, squeeze-excite and BatchNorm weights and running
    statistics are taken (not ``num_batches_tracked`` nor timm's head).
    """
    out = {}
    if "conv_stem.weight" in sd:
        out["backbone.conv_stem.weight"] = sd["conv_stem.weight"]
        for s in _BN:
            if f"bn1.{s}" in sd:
                out[f"backbone.bn1.{s}"] = sd[f"bn1.{s}"]
    flat = 0
    for gi, group in enumerate(groups):
        for si, spec in enumerate(group):
            for b in range(spec.repeats):
                for key in _TIMM_BLOCK_KEYS[spec.block_type]:
                    name = f"blocks.{flat}.{b}.{key}"
                    if name in sd:
                        out[f"backbone.block{gi}.{si}.{b}.{key}"] = sd[name]
            flat += 1
    return out
