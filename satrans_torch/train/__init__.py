"""Training (twin of ``satrans_tpu/train``): the single-step ``Trainer``
with the dense and sparse bank updates (``bank_optimizer``), the
optimizers other than Adam (``optimizers``), losses, metrics, callbacks,
checkpoints (``checkpoint``) and the attention probes
(``attention_probe``)."""

from . import callbacks, losses, metrics
from .trainer import DomainRouted, SingleTask, Trainer

__all__ = ["DomainRouted", "SingleTask", "Trainer", "callbacks", "losses",
           "metrics"]
