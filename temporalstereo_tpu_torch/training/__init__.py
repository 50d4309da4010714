"""Training of the port: optimizers with optax's rules, the train state
(f32 masters, SWA), the training step and the evaluation step."""
from .optim import (GradientTransformation, apply_updates, build_optimizer,
                    build_schedule, global_norm)
from .state import TrainState, master_copies
from .step import (build_losses, compute_losses, make_eval_step,
                   make_train_step)

__all__ = ["GradientTransformation", "TrainState", "apply_updates",
           "build_losses", "build_optimizer", "build_schedule",
           "compute_losses", "global_norm", "make_eval_step",
           "make_train_step", "master_copies"]
