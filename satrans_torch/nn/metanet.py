"""MetaNet: scenario-conditioned hypernetwork applicator (twin of
``satrans_tpu/nn/metanet.py``).

Given field embeddings ``x: [B, F, d]`` and flat parameters with
``P = sum(units[i] * units[i+1])``, slice the flat vector into weight
matrices ``W_i: [units[i], units[i+1]]`` and apply a bias-free MLP (ReLU
between layers, not after the last), then the residual add and the
LayerNorm.  No dropout: the MetaNet's dropout site comes with the
in-kernel dropout (ROADMAP queue 2, K1-stash and K1-bwd-stash).
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


def apply_flat(meta: MetaNet, x, mlp_params, units: Sequence[int]):
    """Per-example flat params ``[B, P]``; only the first
    ``param_size(units)`` entries are read."""
    weights = slice_weights(mlp_params[:, :param_size(units)], units)
    return meta.ln(_mlp_chain(x, weights) + x)


def apply_domainwise(meta: MetaNet, x, domain_ids, domain_params,
                     units: Sequence[int], *, dense_select: bool = False):
    """``domain_params [D, P]`` indexed by ``domain_ids [B]``.

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
    return meta.ln(y + x)
