"""MetaNet: scenario-conditioned hypernetwork applicator (twin of
``satrans_tpu/nn/metanet.py``).

Given field embeddings ``x: [B, F, d]`` and flat parameters with
``P = sum(units[i] * units[i+1])``, slice the flat vector into weight
matrices ``W_i: [units[i], units[i+1]]`` and apply a bias-free MLP (ReLU
between layers, not after the last), then the residual add and the
LayerNorm.  Dropout is ``drop``, a function applied to the MLP's output
before the residual: the fused kernels' mask (``ops/prng.py``) multiplied
in, or the JAX package's XLA dropout (``core.dropout``).
:func:`apply_domainwise` is the whole MetaNet with the XLA dropout, the
baseline zoo's ``metatrans`` hook (``satrans_tpu/nn/metanet.py:71-76``,
``:91-112``).
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
    zeros); the weights are generated by the scenario encoder.  Without
    ``use_norm`` there is no LayerNorm and no parameter."""

    def __init__(self, gen: torch.Generator, hidden_dim: int, *,
                 use_norm: bool = True):
        super().__init__()
        self.ln = core.LayerNorm(gen, hidden_dim) if use_norm else None


def _mlp_chain(x, weights):
    """x -> x@W_0 -> relu -> ... -> x@W_last, per-example weights."""
    for i, w in enumerate(weights):
        x = torch.einsum("bfi,bio->bfo", x, w)
        if i < len(weights) - 1:
            x = torch.relu(x)
    return x


def _residual(y, x, drop):
    """The pre-LayerNorm sum ``drop(y) + x``."""
    return (y if drop is None else drop(y)) + x


def flat_sum(x, mlp_params, units: Sequence[int], *, drop=None):
    """Per-example flat params ``[B, P]`` (only the first
    ``param_size(units)`` entries are read): the MLP on ``x``, dropped,
    plus ``x``; the MetaNet's LayerNorm of it is the output."""
    weights = slice_weights(mlp_params[:, :param_size(units)], units)
    return _residual(_mlp_chain(x, weights), x, drop)


def domainwise_sum(x, domain_ids, domain_params, units: Sequence[int], *,
                   dense_select: bool = False, drop=None):
    """``domain_params [D, P]`` indexed by ``domain_ids [B]``: the MLP of
    each example's domain on ``x``, dropped, plus ``x``.

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
    return _residual(y, x, drop)


def apply_domainwise(net: MetaNet, x, domain_ids, domain_params,
                     units: Sequence[int], *, dropout_rate: float = 0.1,
                     train: bool = False, key=None):
    """The MetaNet of each example's domain on ``x`` (the gather path),
    the JAX package's dropout of ``key`` on its output, the residual and
    the LayerNorm if ``net`` has one.  ``domain_ids`` index the rows of
    ``domain_params`` as a JAX gather does: a negative id counts from the
    end, and every id is clamped into the table."""
    ids = core.jax_rows(domain_ids, domain_params.shape[0])
    y = domainwise_sum(x, ids, domain_params, units,
                       drop=lambda t: core.dropout(t, dropout_rate, train,
                                                   key))
    return y if net.ln is None else net.ln(y)

