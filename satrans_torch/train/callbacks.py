"""Keras-style callbacks (twin of ``satrans_tpu/train/callbacks.py``): the
lifecycle hooks, ``History``, ``ModelCheckpoint``, ``EarlyStopping`` and
``TestCrashProbe`` (the CLI's ``test`` flag)."""

from __future__ import annotations

import numpy as np


class Callback:
    def set_trainer(self, trainer):
        self.trainer = trainer

    def on_train_begin(self, logs=None): ...
    def on_train_end(self, logs=None): ...
    def on_epoch_begin(self, epoch, logs=None): ...
    def on_epoch_end(self, epoch, logs=None): ...
    def on_batch_begin(self, step, logs=None): ...
    def on_batch_end(self, step, logs=None): ...


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def set_trainer(self, trainer):
        for c in self.callbacks:
            c.set_trainer(trainer)

    def __getattr__(self, name):
        if not name.startswith("on_"):
            raise AttributeError(name)

        def fire(*args, **kwargs):
            for c in self.callbacks:
                getattr(c, name)(*args, **kwargs)

        return fire


class History(Callback):
    """Records per-epoch logs (reference History.history semantics)."""

    def __init__(self):
        self.history: dict[str, list] = {}
        self.epoch: list[int] = []

    def on_epoch_end(self, epoch, logs=None):
        self.epoch.append(epoch)
        for k, v in (logs or {}).items():
            self.history.setdefault(k, []).append(v)


class ModelCheckpoint(Callback):
    """Save the trainer (``train/checkpoint.py``: parameters, optimizer
    state, model state, offset) at each epoch's end, or only when
    ``monitor`` improves in the direction of ``mode`` - the reference's
    ModelCheckpoint."""

    def __init__(self, path: str, monitor: str | None = None,
                 mode: str = "max"):
        self.path = path
        self.monitor = monitor
        self.sign = 1.0 if mode == "max" else -1.0
        self.best = -np.inf

    def on_epoch_end(self, epoch, logs=None):
        from . import checkpoint
        if self.monitor is not None:
            value = (logs or {}).get(self.monitor)
            if value is None or self.sign * value <= self.best:
                return
            self.best = self.sign * value
        checkpoint.save(self.path, self.trainer)


class EarlyStopping(Callback):
    def __init__(self, monitor="val_auc", patience=0, mode="max",
                 min_delta=0.0):
        self.monitor = monitor
        self.patience = patience
        self.sign = 1.0 if mode == "max" else -1.0
        self.min_delta = min_delta
        self.best = -np.inf
        self.wait = 0

    def on_epoch_end(self, epoch, logs=None):
        value = (logs or {}).get(self.monitor)
        if value is None:
            return
        if self.sign * value > self.best + self.min_delta:
            self.best = self.sign * value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait > self.patience:
                self.trainer.stop_training = True


class TestCrashProbe(Callback):
    """The reference's ``'test' in flag`` probe: print the loss after a few
    steps then abort (meta_basemodel.py:321-323) - a quick end-to-end smoke
    of the step without a full epoch."""

    def __init__(self, after_steps: int = 5):
        self.after_steps = after_steps
        self.count = 0

    def on_batch_end(self, step, logs=None):
        self.count += 1
        if self.count >= self.after_steps:
            loss = (logs or {}).get("loss")
            print(f"\ntest out: {None if loss is None else float(loss)}")
            raise AssertionError("test probe abort (flag 'test')")
