"""Dual and model-only checkpointing (paper §4): port of the JAX package's
``checkpoint`` package, file for file compatible with it."""
from .checkpointer import (Checkpointer, broadcast_params, dp_scattered_writers, load_pytree,
                           save_pytree)

__all__ = ["Checkpointer", "broadcast_params", "dp_scattered_writers", "load_pytree",
           "save_pytree"]
