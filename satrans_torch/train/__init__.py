"""Training (twin of ``satrans_tpu/train``): the dense single-step
``Trainer``, losses, metrics and callbacks."""

from . import callbacks, losses, metrics
from .trainer import SingleTask, Trainer

__all__ = ["SingleTask", "Trainer", "callbacks", "losses", "metrics"]
