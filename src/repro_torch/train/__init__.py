"""Training on one device or a dp x ep process grid (``init_state``,
``make_train_step``; the SO/EPSO layout ``opt_layout``, the placement of
every leaf of a state ``state_layout``) and the serving
lowerings (``make_prefill_step``,
``make_serve_step``)."""
from .trainer import (TrainState, init_state, make_prefill_step, make_serve_step,
                      make_train_step, opt_layout, state_layout)

__all__ = ["TrainState", "init_state", "make_prefill_step", "make_serve_step",
           "make_train_step", "opt_layout", "state_layout"]
