"""Training: the state (Adam + EMA), the steps, checkpoints, logging and the
loop (port of diffse_tpu/train)."""

from .checkpoints import CheckpointManager
from .state import TrainState, ema_decay_schedule, eval_variables
from .steps import make_eval_step, make_train_step

__all__ = [
    "TrainState",
    "ema_decay_schedule",
    "eval_variables",
    "make_train_step",
    "make_eval_step",
    "CheckpointManager",
]
