"""Training runtime: hand-rolled AdamW (+fp32 master weights), schedules,
microbatched train step (on one device or over a mesh), gradient
compression — the port of ``repro/train``."""
from .optimizer import AdamWConfig, adamw_init, adamw_update, warmup_cosine
from .train_lib import (TrainConfig, TrainState, init_train_state,
                        make_train_step, train_state_from_reference)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "warmup_cosine",
           "TrainConfig", "TrainState", "make_train_step",
           "init_train_state", "train_state_from_reference"]
