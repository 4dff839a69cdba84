"""MetaNet: scenario-conditioned hypernetwork applicator (twin of
``satrans_tpu/nn/metanet.py``).

Given field embeddings ``x: [B, F, d]`` and flat parameters with
``P = sum(units[i] * units[i+1])``, slice the flat vector into weight
matrices ``W_i: [units[i], units[i+1]]`` and apply a bias-free MLP (ReLU
between layers, not after the last), then the residual add and the
LayerNorm.  Dropout is a ``mask`` (0 or the keep scale, one value per
output element) multiplied into the MLP's output before the residual, as
the fused kernels do; ``ops/prng.py`` draws it.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from . import core


def param_size(units: Sequence[int]) -> int:
    """Total flat parameter size."""
    return sum(units[i] * units[i + 1] for i in range(len(units) - 1))


def slice_weights(flat: torch.Tensor, units: Sequence[int]):
    """``[..., P] -> [ [..., u_i, u_{i+1}] ]``."""
    ws = []
    offset = 0
    for i in range(len(units) - 1):
        n = units[i] * units[i + 1]
        w = flat[..., offset:offset + n]
        ws.append(w.reshape(*flat.shape[:-1], units[i], units[i + 1]))
        offset += n
    return ws


class MetaNet(nn.Module):
    """Only the LayerNorm is a trained parameter (torch defaults: ones and
    zeros); the weights are generated by the scenario encoder."""

    def __init__(self, gen: torch.Generator, hidden_dim: int):
        super().__init__()
        self.ln = core.LayerNorm(gen, hidden_dim)


def _mlp_chain(x, weights):
    """x -> x@W_0 -> relu -> ... -> x@W_last, per-example weights."""
    for i, w in enumerate(weights):
        x = torch.einsum("bfi,bio->bfo", x, w)
        if i < len(weights) - 1:
            x = torch.relu(x)
    return x


def _residual(y, x, mask):
    """The pre-LayerNorm sum ``y * mask + x``."""
    return (y if mask is None else y * mask) + x


def flat_sum(x, mlp_params, units: Sequence[int], *, mask=None):
    """Per-example flat params ``[B, P]`` (only the first
    ``param_size(units)`` entries are read): the MLP on ``x``, masked,
    plus ``x``; the MetaNet's LayerNorm of it is the output."""
    weights = slice_weights(mlp_params[:, :param_size(units)], units)
    return _residual(_mlp_chain(x, weights), x, mask)


def domainwise_sum(x, domain_ids, domain_params, units: Sequence[int], *,
                   dense_select: bool = False, mask=None):
    """``domain_params [D, P]`` indexed by ``domain_ids [B]``: the MLP of
    each example's domain on ``x``, masked, plus ``x``.

    ``dense_select=False`` gathers each example's own weights (the
    kernel's arithmetic); ``True`` runs every domain's MLP on every row and
    selects with a one-hot (the JAX package's fast path)."""
    weights = slice_weights(domain_params[..., :param_size(units)], units)
    if dense_select:
        num_domains = domain_params.shape[0]
        onehot = torch.nn.functional.one_hot(
            domain_ids.long(), num_domains).to(x.dtype)       # [B, D]
        ys = []
        for d in range(num_domains):
            h = x
            for i, w in enumerate(weights):
                h = h @ w[d]
                if i < len(weights) - 1:
                    h = torch.relu(h)
            ys.append(h)
        y = torch.einsum("dbfo,bd->bfo", torch.stack(ys), onehot)
    else:
        y = _mlp_chain(x, [w[domain_ids] for w in weights])
    return _residual(y, x, mask)

