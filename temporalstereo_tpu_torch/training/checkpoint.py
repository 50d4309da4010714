"""Checkpoint save and restore, and weights-only warm starts.

Counterpart of the JAX package's ``training/checkpoint.py``.  The JAX
package writes orbax directories; the port writes one ``torch.save`` file
a step, ``checkpoint-<step>.pt``, with the same contents: ``params``,
``batch_stats``, ``opt_state``, ``step`` and, with SWA, ``swa_params`` and
``swa_count``, every tensor on the CPU.  Like orbax's manager, ``save``
writes nothing for a step at or below the latest one it holds, and a
``keep`` above 0 keeps only that many of the newest checkpoints.
``hparams-<step>.json`` is the config the run was started with.

Standalone weights (``save_weights``) are a ``.pth`` state_dict in the
reference's names, which ``utils/checkpoint.py:load_weights`` (into a
module) and ``load_any_weights`` (into a train state) read; the JAX package writes msgpack there.  Warm
starts merge as the JAX package's ``warm_start(strict=False)``: a tensor
whose name and shape match is taken, every other one keeps its value.
They act on the train state's f32 masters, so a bf16 model starts from
the file's full-precision values.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import torch

from ..utils.checkpoint import (backbone_from_timm, matching_entries,
                                read_state_dict)
from .state import TrainState

Tree = Dict[str, torch.Tensor]
_NAME = re.compile(r"checkpoint-(\d+)\.pt$")


def _to(tree, device):
    """Every tensor of a nested dict / tuple / list moved to ``device``."""
    if torch.is_tensor(tree):
        return tree.detach().to(device, copy=True)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


class CheckpointManager:
    def __init__(self, directory: str, keep: int = -1):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"checkpoint-{step}.pt")

    def all_steps(self):
        steps = (_NAME.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in steps if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState,
             hparams: Optional[Dict[str, Any]] = None) -> bool:
        """-> whether a checkpoint was written (not for a step at or below
        the latest).  ``hparams`` is written as ``hparams-<step>.json``
        either way."""
        latest = self.latest_step()
        written = latest is None or step > latest
        if written:
            payload = {"params": state.params,
                       "batch_stats": state.batch_stats,
                       "opt_state": state.opt_state, "step": int(state.step)}
            if state.swa_params is not None:
                payload["swa_params"] = state.swa_params
                payload["swa_count"] = int(state.swa_count)
            tmp = self.path(step) + ".tmp"
            torch.save(_to(payload, "cpu"), tmp)
            os.replace(tmp, self.path(step))
            if self.keep is not None and self.keep > 0:
                for old in self.all_steps()[:-self.keep]:
                    os.remove(self.path(old))
        if hparams is not None:
            path = os.path.join(self.directory, f"hparams-{step}.json")
            with open(path, "w") as f:
                json.dump(hparams, f, indent=1, default=str)
        return written

    def load_hparams(self, step: Optional[int] = None
                     ) -> Optional[Dict[str, Any]]:
        """The config saved with a checkpoint (the latest by default)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        path = os.path.join(self.directory, f"hparams-{step}.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def read(self, step: Optional[int] = None) -> Dict[str, Any]:
        """The payload of a checkpoint (the latest by default), on the
        CPU."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self.path(step), map_location="cpu",
                          weights_only=True)

    def restore(self, state: TrainState, step: Optional[int] = None
                ) -> TrainState:
        """Full-trainer resume: params, batch_stats, optimizer state, step
        and SWA, on the device of ``state``'s params."""
        saved = self.read(step)
        device = next(iter(state.params.values())).device
        saved = _to(saved, device)
        return TrainState(
            step=saved["step"], params=saved["params"],
            batch_stats=saved["batch_stats"], opt_state=saved["opt_state"],
            tx=state.tx,
            swa_params=saved.get("swa_params", state.swa_params),
            swa_count=saved.get("swa_count", state.swa_count))


def save_weights(path: str, params: Tree,
                 batch_stats: Optional[Tree] = None) -> None:
    """A standalone ``.pth`` state_dict of the parameters and running
    statistics, on the CPU."""
    sd = dict(params)
    if batch_stats is not None:
        sd.update(batch_stats)
    torch.save(_to(sd, "cpu"), path)


def warm_start(params: Tree, batch_stats: Tree, weights: Tree,
               strict: bool = False) -> Tuple[Tree, Tree, int]:
    """Merge ``weights`` (a state_dict) into the master trees -> (params,
    batch_stats, number of tensors taken).  With ``strict`` every tensor
    must be present with its shape."""
    n = 0
    out = []
    for tree in (params, batch_stats):
        taken = matching_entries(tree, weights)
        if strict and len(taken) != len(tree):
            missing = sorted(set(tree) - set(taken))
            raise KeyError(f"missing or reshaped in the weights: "
                           f"{missing[:5]}")
        n += len(taken)
        out.append({k: (taken[k].reshape(v.shape).to(v.device, v.dtype)
                        if k in taken else v) for k, v in tree.items()})
    return out[0], out[1], n


def load_any_weights(params: Tree, batch_stats: Tree, path: str
                     ) -> Tuple[Tree, Tree, int]:
    """Warm-start from a torch checkpoint file or a ``CheckpointManager``
    directory (its latest step) -> (params, batch_stats, count)."""
    if os.path.isdir(path):
        mgr = CheckpointManager(path)
        if mgr.latest_step() is None:
            raise FileNotFoundError(f"no checkpoint steps in {path}")
        saved = mgr.read()
        weights = {**saved["params"], **saved.get("batch_stats", {})}
    else:
        weights = read_state_dict(path)
    return warm_start(params, batch_stats, weights, strict=False)


def warm_start_backbone(params: Tree, batch_stats: Tree, path: str, groups
                        ) -> Tuple[Tree, Tree, int]:
    """Merge a timm EfficientNetV2 ``.pth`` into the backbone's trunk
    (``MODEL.BACKBONE.PRETRAINED``) -> (params, batch_stats, count)."""
    sd = backbone_from_timm(read_state_dict(path), groups)
    return warm_start(params, batch_stats, sd, strict=False)
