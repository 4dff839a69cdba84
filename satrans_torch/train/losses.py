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


def masked_multitask_bce_sum(pred, y, domain_ids, offset: int,
                             num_tasks: int, weight=None):
    """``sum_i BCE_sum(pred[:, i][d == i + offset], y[d == i + offset])``:
    head ``i``'s loss over domain ``i``'s examples, with static shapes
    (twin of losses.py:57-66; reference mtl_basemodel.py:262-269).
    ``weight``, the 0/1 pad mask, also leaves out the pad rows, as the
    JAX Trainer's ``DomainRouted.loss`` does (trainer.py:110-116)."""
    total = 0.0
    for i in range(num_tasks):
        mask = (domain_ids == (i + offset)).to(pred.dtype)
        if weight is not None:
            mask = mask * weight
        total = total + torch.sum(mask * bce_elementwise(pred[:, i], y))
    return total


def route_by_domain(pred, domain_ids, offset: int):
    """Each example's score from its domain's head: ``pred[:, i]`` where
    ``domain_ids == i + offset``, 0 where the id matches no head (twin of
    the JAX Trainer's ``DomainRouted.route``, trainer.py:122-128)."""
    out = torch.zeros(pred.shape[0], dtype=pred.dtype, device=pred.device)
    for i in range(pred.shape[1]):
        out = torch.where(domain_ids == (i + offset), pred[:, i], out)
    return out


_SINGLE = {"binary_crossentropy": bce_sum, "mse": mse_sum, "mae": mae_sum}


def get_loss(name):
    if callable(name):
        return name
    try:
        return _SINGLE[name]
    except KeyError:
        raise NotImplementedError(f"loss {name!r}") from None
