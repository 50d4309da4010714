"""Train state with SWA (stochastic weight averaging).

Counterpart of the JAX package's ``training/state.py``.  ``params`` are the
f32 master copies of every parameter of the model and ``batch_stats`` the
f32 BatchNorm running statistics, both keyed by ``state_dict`` name; the
model's own parameters are a working copy in its compute type, refreshed
from ``params`` before each step (``training/step.py``), so an update far
below bf16's resolution still accumulates.  ``apply_gradients`` returns a
new state and leaves this one as it was.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from .optim import GradientTransformation, apply_updates

Tree = Dict[str, torch.Tensor]


def master_copies(model: nn.Module) -> Tuple[Tree, Tree]:
    """(params, batch_stats): f32 copies of the model's parameters and of
    its BatchNorm running means and variances."""
    params = {k: p.detach().float().clone()
              for k, p in model.named_parameters()}
    stats = {k: b.detach().float().clone()
             for k, b in model.named_buffers()
             if k.endswith(("running_mean", "running_var"))}
    return params, stats


@dataclasses.dataclass(frozen=True)
class TrainState:
    step: int
    params: Tree
    batch_stats: Tree
    opt_state: Any
    tx: GradientTransformation
    swa_params: Optional[Tree] = None
    swa_count: Optional[int] = None

    @classmethod
    def create(cls, params: Tree, batch_stats: Tree,
               tx: GradientTransformation, with_swa: bool = False
               ) -> "TrainState":
        return cls(step=0, params=params, batch_stats=batch_stats,
                   opt_state=tx.init(params), tx=tx,
                   swa_params=({k: torch.zeros_like(p)
                                for k, p in params.items()}
                               if with_swa else None),
                   swa_count=0 if with_swa else None)

    def apply_gradients(self, grads: Tree,
                        new_batch_stats: Optional[Tree] = None,
                        swa_active: bool = False) -> "TrainState":
        updates, opt_state = self.tx.update(grads, self.opt_state,
                                            self.params)
        params = apply_updates(self.params, updates)
        kwargs = dict(step=self.step + 1, params=params, opt_state=opt_state,
                      batch_stats=(self.batch_stats if new_batch_stats is None
                                   else new_batch_stats))
        if self.swa_params is not None and swa_active:
            # running average of the parameters while SWA is active
            count = self.swa_count + 1
            kwargs["swa_params"] = {k: sw + (params[k] - sw) / count
                                    for k, sw in self.swa_params.items()}
            kwargs["swa_count"] = count
        return dataclasses.replace(self, **kwargs)

    def swa_model_params(self) -> Tree:
        """The SWA average, or the current parameters if SWA never ran."""
        if self.swa_params is None or self.swa_count == 0:
            return self.params
        return self.swa_params
