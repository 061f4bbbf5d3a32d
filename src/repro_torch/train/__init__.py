"""Training on one device (``init_state``, ``make_train_step``) and the
serving lowerings (``make_prefill_step``, ``make_serve_step``)."""
from .trainer import TrainState, init_state, make_prefill_step, make_serve_step, make_train_step

__all__ = ["TrainState", "init_state", "make_prefill_step", "make_serve_step",
           "make_train_step"]
