"""Training on one device: ``init_state`` and ``make_train_step``."""
from .trainer import TrainState, init_state, make_train_step

__all__ = ["TrainState", "init_state", "make_train_step"]
