"""Training losses (twin of ``satrans_tpu/train/losses.py``).

The reference's objective (basemodel.py:313-327) is

    total = BCE(pred, y, reduction='sum') + l2_reg + aux_loss

with sum reduction, not the mean.  BCE is that of
``torch.nn.functional.binary_cross_entropy`` on probabilities, including
its clamp of the log terms at -100, written out so that a pad weight can
multiply each element.
"""

from __future__ import annotations

import torch


def bce_elementwise(pred, y):
    """-(y log p + (1-y) log(1-p)) with torch's log clamp at -100."""
    log_p = torch.clamp(torch.log(pred), min=-100.0)
    log_1p = torch.clamp(torch.log1p(-pred), min=-100.0)
    return -(y * log_p + (1.0 - y) * log_1p)


def bce_sum(pred, y):
    """reduction='sum' (reference basemodel.py:316)."""
    return torch.sum(bce_elementwise(pred, y))


def mse_sum(pred, y):
    return torch.sum(torch.square(pred - y))


def mae_sum(pred, y):
    return torch.sum(torch.abs(pred - y))


_SINGLE = {"binary_crossentropy": bce_sum, "mse": mse_sum, "mae": mae_sum}


def get_loss(name):
    if callable(name):
        return name
    try:
        return _SINGLE[name]
    except KeyError:
        raise NotImplementedError(f"loss {name!r}") from None
