"""Training (the port of the JAX package's ``repro.train``): AdamW and its
schedules, the microbatched train step, gradient compression with error
feedback."""

from .optimizer import AdamWConfig, AdamWState, adamw_init, adamw_update, \
    make_schedule
from .train_step import TrainState, init_train_state, make_train_step, \
    restore_train_state, train_state_tree

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "make_schedule", "TrainState", "init_train_state",
           "make_train_step", "train_state_tree", "restore_train_state"]
