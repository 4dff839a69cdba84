"""Serving (twin of ``satrans_tpu/serving.py``).

:class:`Predictor` scores a feature dict with a frozen model: a fixed
batch size, the tail padded with zero rows, float64 scores out.  Batches
are staged and run without a synchronisation per batch; the one copy back
to the host at the end waits for the device.  :meth:`Predictor.
from_trainer` serves a trainer's model; :func:`save` writes a trainer's
checkpoint (``train/checkpoint.py``) and :func:`load` rebuilds a Predictor
from one and a model of the same configuration.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils import resolve_device


class Predictor:
    def __init__(self, model: torch.nn.Module, *, batch_size: int = 4096,
                 device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.layout = model.layout
        self.batch_size = int(batch_size)

    @classmethod
    def from_trainer(cls, trainer, *, batch_size: int = 4096) -> "Predictor":
        """A Predictor of ``trainer``'s model on its device."""
        return cls(trainer.model, batch_size=batch_size,
                   device=trainer.device)

    def _stage(self, data: dict, start: int, end: int) -> dict:
        """Pad one batch to ``batch_size`` rows and copy it to the device."""
        bs = self.batch_size
        batch = {}
        for k, v in data.items():
            part = v[start:end]
            if len(part) < bs:
                part = np.pad(part, [(0, bs - len(part))]
                              + [(0, 0)] * (part.ndim - 1))
            batch[k] = torch.from_numpy(np.ascontiguousarray(part)).to(
                self.device, non_blocking=True)
        return batch

    def _example_batch(self) -> dict:
        n = self.batch_size
        data = {}
        if self.layout.sparse:
            data["sparse"] = np.ones((n, len(self.layout.sparse)), np.int32)
        if self.layout.dense:
            data["dense"] = np.zeros((n, self.layout.dense_dim), np.float32)
        if self.layout.varlen:
            data["varlen"] = np.zeros(
                (n, len(self.layout.varlen), self.layout.varlen[0].maxlen),
                np.int32)
        return data

    def warmup(self) -> "Predictor":
        """Run one dummy batch (the kernels build and load here)."""
        with torch.inference_mode():
            self.model(self._stage(self._example_batch(), 0,
                                   self.batch_size)).cpu()
        return self

    def __call__(self, x: dict) -> np.ndarray:
        data = self.layout.batch_from_dict(x)
        n = len(next(iter(data.values())))
        bs = self.batch_size
        spans = [(s, min(s + bs, n)) for s in range(0, n, bs)]
        with torch.inference_mode():
            outs = [self.model(self._stage(data, s, e))[:e - s]
                    for s, e in spans]
            scores = torch.cat(outs).cpu()
        return scores.numpy().astype("float64")


def save(path: str, trainer) -> None:
    """Persist a trainer's parameters and state for serving
    (``train/checkpoint.save``)."""
    from .train import checkpoint
    checkpoint.save(path, trainer)


def load(path: str, model: torch.nn.Module, *, batch_size: int = 4096,
         device="cuda") -> Predictor:
    """Rebuild a Predictor from a checkpoint and a model of the same
    configuration: the checkpoint's parameters are loaded into ``model``
    (its optimizer state, which serving does not need, is not read, so a
    checkpoint of any bank mode loads)."""
    from .train import checkpoint
    dev = resolve_device(device)
    model = model.to(dev)
    model.load_state_dict(checkpoint.read(path, dev)["params"])
    return Predictor(model, batch_size=batch_size, device=dev)
