"""Training layer of the port: AdamW, the train step, the loop and its
elastic restart (see ``loop.py``)."""

from .loop import ElasticController, LoopConfig, StragglerEvent, TrainLoop
from .optimizer import AdamWConfig, OptState, adamw_init, adamw_update
from .train_step import TrainState, init_train_state, make_train_step

__all__ = [
    "AdamWConfig", "OptState", "adamw_init", "adamw_update",
    "TrainState", "init_train_state", "make_train_step",
    "LoopConfig", "StragglerEvent", "TrainLoop", "ElasticController",
]
