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
so.)  Weights in the JAX package's own formats (msgpack, orbax)
are converted first with ``python -m temporalstereo_tpu.cli.export_reference``.
"""
from __future__ import annotations

import torch
import torch.nn as nn

TORCH_EXTENSIONS = (".ckpt", ".pth", ".pt")


def load_weights(model: nn.Module, path: str) -> int:
    """Merge a torch checkpoint into ``model`` (in place) -> the number of
    its tensors loaded (those whose name and shape match)."""
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
    own = model.state_dict()

    def fits(name, value):
        target = own.get(name)
        return (torch.is_tensor(value) and target is not None
                and (value.shape == target.shape
                     or (target.dim() == 0 and value.shape == (1,))))
    matched = {k: v for k, v in sd.items() if fits(k, v)}
    model.load_state_dict(matched, strict=False)
    return len(matched)
