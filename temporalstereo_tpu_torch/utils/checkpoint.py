"""Load weights into the port's model.

Counterpart of the torch branch of the JAX package's
``training/checkpoint.py:load_any_weights``.  The port reads the reference
layout that the JAX package's ``utils/torch_export.py`` writes (a
Lightning ``.ckpt`` with a ``state_dict``) and that
``utils/convert.py:state_dict_from_jax`` produces: ``.ckpt``, ``.pth`` and
``.pt`` files of a state_dict, bare or under ``"state_dict"`` or
``"model"``, loaded strictly.  Weights in the JAX package's own formats
(msgpack, orbax) are converted first with
``python -m temporalstereo_tpu.cli.export_reference``.
"""
from __future__ import annotations

import torch
import torch.nn as nn

TORCH_EXTENSIONS = (".ckpt", ".pth", ".pt")


def load_weights(model: nn.Module, path: str) -> int:
    """Strict-load a torch checkpoint into ``model`` (in place) -> the number
    of tensors loaded."""
    if not path.endswith(TORCH_EXTENSIONS):
        raise ValueError(
            f"{path}: the port loads {'/'.join(TORCH_EXTENSIONS)} "
            "checkpoints; convert other weights with python -m "
            "temporalstereo_tpu.cli.export_reference")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    if "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    model.load_state_dict(sd, strict=True)
    return len(sd)
