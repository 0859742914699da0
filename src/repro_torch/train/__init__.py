"""Training: the synthetic stream, AdamW, schedules, the fused cross-entropy,
the train step, and erasure-coded checkpointing of training state."""
from .data import DataConfig, SyntheticStream
from .optimizer import AdamWConfig, adamw_update, init_opt_state, opt_state_axes
from .schedule import ScheduleConfig, learning_rate
from .train_step import TrainConfig, init_train_state, loss_fn, make_train_step, train_state
from .xent import sharded_xent

__all__ = [
    "DataConfig", "SyntheticStream", "AdamWConfig", "adamw_update",
    "init_opt_state", "opt_state_axes", "ScheduleConfig", "learning_rate",
    "TrainConfig", "init_train_state", "loss_fn", "make_train_step", "train_state",
    "sharded_xent",
]
