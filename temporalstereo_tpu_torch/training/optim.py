"""Optimizers and learning-rate schedules with optax's update rules.

Counterpart of the JAX package's ``training/optim.py``, which builds optax
transformations.  ``torch.optim`` differs from optax in ways that change
the trajectory: ``torch.optim.RMSprop`` divides by ``sqrt(nu) + eps`` where
optax's ``rmsprop`` divides by ``sqrt(nu + eps)``, and
``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm where
``optax.clip_by_global_norm`` scales by ``max_norm / norm`` only when
``norm >= max_norm``.  So this module implements optax's rules on
dictionaries of f32 tensors (name -> tensor), as optax's
``GradientTransformation``s: ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``; ``apply_updates``
adds the updates.  Schedules map a step count to a learning rate, with the
epoch milestones of the config turned into step counts as the JAX package
does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from ..config import ConfigNode

Tree = Dict[str, torch.Tensor]
Schedule = Callable[[int], float]


@dataclasses.dataclass(frozen=True)
class GradientTransformation:
    init: Callable[[Tree], Any]
    update: Callable[[Tree, Any, Optional[Tree]], Tuple[Tree, Any]]


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of every element's square (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(torch.square(x)) for x in tree.values()))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def update(grads, state, params=None):
        norm = global_norm(grads)
        keep = norm < max_norm      # a device tensor: no host sync
        return {k: torch.where(keep, g, g / norm * max_norm)
                for k, g in grads.items()}, state
    return GradientTransformation(lambda params: (), update)


def scale_by_rms(decay: float = 0.9, eps: float = 1e-8
                 ) -> GradientTransformation:
    """nu = decay nu + (1 - decay) g^2 from nu = 0, g / sqrt(nu + eps): no
    bias correction, eps inside the root."""
    def init(params):
        return {"nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(grads, state, params=None):
        nu = {k: (1 - decay) * torch.square(g) + decay * state["nu"][k]
              for k, g in grads.items()}
        return ({k: g * torch.rsqrt(nu[k] + eps) for k, g in grads.items()},
                {"nu": nu})
    return GradientTransformation(init, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
                  ) -> GradientTransformation:
    """Bias-corrected moments, m_hat / (sqrt(v_hat) + eps)."""
    def init(params):
        return {"count": 0,
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(grads, state, params=None):
        mu = {k: (1 - b1) * g + b1 * state["mu"][k] for k, g in grads.items()}
        nu = {k: (1 - b2) * torch.square(g) + b2 * state["nu"][k]
              for k, g in grads.items()}
        count = state["count"] + 1
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
        updates = {k: (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
                   for k in grads}
        return updates, {"count": count, "mu": mu, "nu": nu}
    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def update(grads, state, params=None):
        return {k: g + weight_decay * params[k] for k, g in grads.items()}, \
            state
    return GradientTransformation(lambda params: (), update)


def scale_by_learning_rate(schedule: Schedule) -> GradientTransformation:
    """updates * -lr(count), count starting at 0."""
    def update(grads, state, params=None):
        lr = schedule(state["count"])
        return ({k: -lr * g for k, g in grads.items()},
                {"count": state["count"] + 1})
    return GradientTransformation(lambda params: {"count": 0}, update)


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(grads, state, params=None):
        new_state = []
        for tx, s in zip(txs, state):
            grads, s = tx.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)
    return GradientTransformation(init, update)


def rmsprop(schedule: Schedule, decay: float = 0.9, eps: float = 1e-8
            ) -> GradientTransformation:
    return chain(scale_by_rms(decay, eps), scale_by_learning_rate(schedule))


def adam(schedule: Schedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps), scale_by_learning_rate(schedule))


def adamw(schedule: Schedule, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4
          ) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps),
                 add_decayed_weights(weight_decay),
                 scale_by_learning_rate(schedule))


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return {k: p + updates[k] for k, p in params.items()}


def piecewise_constant(base_lr: float, boundaries: Sequence[int],
                       gamma: float) -> Schedule:
    """base_lr times gamma for every boundary the step has reached."""
    return lambda step: base_lr * gamma ** sum(step >= b for b in boundaries)


def build_schedule(cfg: ConfigNode, base_lr: float,
                   steps_per_epoch: int) -> Schedule:
    """Epoch-milestone schedules mapped onto step counts."""
    kind = cfg.SCHEDULER.get("TYPE", "None")
    if kind is None or kind == "None":
        return lambda step: base_lr
    if kind == "StepLR":
        size = cfg.SCHEDULER.STEP_LR.STEP_SIZE * steps_per_epoch
        gamma = cfg.SCHEDULER.STEP_LR.GAMMA
        return lambda step: base_lr * gamma ** (step // size)
    if kind == "MultiStepLR":
        node = cfg.SCHEDULER.MULTI_STEP_LR
        return piecewise_constant(
            base_lr, [m * steps_per_epoch for m in node.MILESTONES],
            node.GAMMA)
    if kind == "ExponentialLR":
        gamma = cfg.SCHEDULER.EXPONENTIAL_LR.GAMMA
        return lambda step: base_lr * gamma ** math.floor(
            step / steps_per_epoch)
    raise NotImplementedError(f"scheduler {kind} not supported")


def build_optimizer(cfg: ConfigNode, steps_per_epoch: int
                    ) -> GradientTransformation:
    kind = cfg.OPTIMIZER.TYPE
    if kind == "Adam":
        node = cfg.OPTIMIZER.ADAM
        tx = adam(build_schedule(cfg, node.LR, steps_per_epoch),
                  *node.get("BETAS", (0.9, 0.999)))
    elif kind == "RMSProp":
        node = cfg.OPTIMIZER.RMSPROP
        # the JAX package's choice: torch RMSprop's alpha 0.99 and eps 1e-8
        tx = rmsprop(build_schedule(cfg, node.LR, steps_per_epoch),
                     decay=0.99, eps=1e-8)
    elif kind == "AdamW":
        node = cfg.OPTIMIZER.ADAMW
        tx = adamw(build_schedule(cfg, node.LR, steps_per_epoch),
                   *node.get("BETAS", (0.9, 0.999)),
                   weight_decay=node.get("WEIGHT_DECAY", 1e-4))
    else:
        raise NotImplementedError(f"optimizer {kind} not supported")

    clip = cfg.TRAINER.get("GRADIENT_CLIP_VAL", 0.0)
    if clip and clip > 0:
        tx = chain(clip_by_global_norm(clip), tx)
    return tx
