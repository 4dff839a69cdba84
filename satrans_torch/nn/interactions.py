"""Feature-interaction layers of the baseline zoo (twin of
``satrans_tpu/nn/interactions.py``, deepctr-torch 0.2.9 semantics).

All take field embeddings ``x`` ``[B, F, d]`` unless noted.  The JAX
package computes them with plain XLA products and sums, outside any
Pallas kernel, and so does the port, with ``torch.matmul`` and
``einsum``:

* :func:`fm` and :func:`bi_interaction_pooling` - the FM second-order term
  (DeepFM, AFM without attention) and its pooling (NFM);
* :class:`CrossNet` - DCN's cross network, vector or matrix kernels;
* :class:`CIN` and :func:`cin_output_dim` - xDeepFM's compressed
  interaction network;
* :class:`SENET` and :class:`Bilinear` (all, each, interaction) -
  FiBiNET's;
* :class:`AFMLayer` - AFM's attention over the pairwise products, with
  its dropout;
* :func:`inner_product` and :class:`OuterProduct` (mat, vec, num) - PNN's.

Parameters are stored as the JAX package stores them (``w`` ``[in,
out]``), under its names, with its initial distributions drawn from a
``torch.Generator``.
"""

from __future__ import annotations

import itertools
import math
from typing import Sequence

import torch
from torch import nn

from . import core, initializers as init


def _xavier_normal(gen: torch.Generator, shape) -> torch.Tensor:
    return init.normal(gen, shape, math.sqrt(2.0 / (shape[0] + shape[-1])))


def _xavier_uniform(gen: torch.Generator, shape) -> torch.Tensor:
    return init.uniform(gen, shape, math.sqrt(6.0 / (shape[0] + shape[-1])))


def _pairs(x: torch.Tensor):
    """The field pairs ``i < j`` of ``x`` ``[B, F, ...]`` in
    ``itertools.combinations`` order, as two index vectors on ``x``'s
    device (device constants: a Python list as an index is copied from the
    host at every call)."""
    from ..embeddings import device_constant
    pi, pj = zip(*itertools.combinations(range(x.shape[1]), 2))
    return device_constant(pi, x.device), device_constant(pj, x.device)


# ---------------------------------------------------------------------------
# FM second-order term and BiInteraction pooling
# ---------------------------------------------------------------------------

def fm(x: torch.Tensor) -> torch.Tensor:
    """0.5 * sum_d((sum_f v)^2 - sum_f v^2) -> ``[B, 1]``."""
    square_of_sum = torch.square(x.sum(dim=1))
    sum_of_square = torch.square(x).sum(dim=1)
    return 0.5 * (square_of_sum - sum_of_square).sum(dim=1, keepdim=True)


def bi_interaction_pooling(x: torch.Tensor) -> torch.Tensor:
    """The FM term without the final d-sum -> ``[B, 1, d]`` (NFM)."""
    square_of_sum = torch.square(x.sum(dim=1, keepdim=True))
    sum_of_square = torch.square(x).sum(dim=1, keepdim=True)
    return 0.5 * (square_of_sum - sum_of_square)


# ---------------------------------------------------------------------------
# CrossNet (DCN)
# ---------------------------------------------------------------------------

class CrossNet(nn.Module):
    """``kernels`` ``[L, in, 1]`` (vector) or ``[L, in, in]`` (matrix),
    Xavier-normal; ``bias`` ``[L, in, 1]`` zeros."""

    def __init__(self, gen: torch.Generator, in_dim: int,
                 layer_num: int = 2, parameterization: str = "vector"):
        super().__init__()
        if parameterization not in ("vector", "matrix"):
            raise ValueError("parameterization must be vector or matrix")
        out = 1 if parameterization == "vector" else in_dim
        self.parameterization = parameterization
        self.kernels = nn.Parameter(torch.stack(
            [_xavier_normal(gen, (in_dim, out)) for _ in range(layer_num)]))
        self.bias = nn.Parameter(torch.zeros(
            (layer_num, in_dim, 1), device=gen.device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` ``[B, in]`` flat -> ``[B, in]``."""
        x0 = x[:, :, None]                                  # [B, in, 1]
        xl = x0
        for i in range(self.kernels.shape[0]):
            if self.parameterization == "vector":
                xl_w = torch.einsum("bik,io->bok", xl, self.kernels[i])
                xl = x0 * xl_w + self.bias[i] + xl
            else:
                xl_w = torch.einsum("ij,bjk->bik", self.kernels[i], xl)
                xl = x0 * (xl_w + self.bias[i]) + xl
        return xl[:, :, 0]


# ---------------------------------------------------------------------------
# CIN (xDeepFM): a kernel-1 Conv1d is a per-channel weighted sum of the
# h * m field products
# ---------------------------------------------------------------------------

class _Conv(nn.Module):
    """One CIN layer's kernel-1 convolution: ``w`` ``[in_ch, size]``,
    ``b`` ``[size]``, torch's Conv1d default U(+-1/sqrt(in_ch))."""

    def __init__(self, gen: torch.Generator, in_ch: int, size: int):
        super().__init__()
        bound = 1.0 / math.sqrt(in_ch)
        self.w = nn.Parameter(init.uniform(gen, (in_ch, size), bound))
        self.b = nn.Parameter(init.uniform(gen, (size,), bound))


class CIN(nn.Module):
    def __init__(self, gen: torch.Generator, field_num: int,
                 layer_sizes: Sequence[int] = (256, 128),
                 split_half: bool = True, act: str = "relu"):
        super().__init__()
        convs = []
        h = field_num
        for i, size in enumerate(layer_sizes):
            convs.append(_Conv(gen, h * field_num, size))
            if split_half and i != len(layer_sizes) - 1:
                if size % 2 > 0:
                    raise ValueError(
                        "layer_size must be even with split_half")
                h = size // 2
            else:
                h = size
        self.convs = nn.ModuleList(convs)
        self.split_half = split_half
        self.act = core.activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, F, d]`` -> ``[B, cin_output_dim]``."""
        x0 = hidden = x
        outs = []
        for i, conv in enumerate(self.convs):
            # the outer product over fields, flattened: [B, h * m, d]
            z = torch.einsum("bhd,bmd->bhmd", hidden, x0)
            b, h, m, d = z.shape
            z = z.reshape(b, h * m, d)
            z = self.act(torch.einsum("bcd,cs->bsd", z, conv.w)
                         + conv.b[None, :, None])
            if self.split_half and i != len(self.convs) - 1:
                size = z.shape[1]
                hidden, direct = z[:, :size // 2], z[:, size // 2:]
            else:
                direct = hidden = z
            outs.append(direct)
        return torch.cat(outs, dim=1).sum(dim=-1)


def cin_output_dim(layer_sizes: Sequence[int], split_half: bool = True
                   ) -> int:
    if split_half:
        return sum(layer_sizes[:-1]) // 2 + layer_sizes[-1]
    return sum(layer_sizes)


# ---------------------------------------------------------------------------
# SENET + Bilinear interaction (FiBiNET)
# ---------------------------------------------------------------------------

class SENET(nn.Module):
    """``w1`` ``[F, max(1, F // ratio)]`` and ``w2`` back, ``nn.Linear``
    default init, no biases."""

    def __init__(self, gen: torch.Generator, field_num: int,
                 reduction_ratio: int = 3):
        super().__init__()
        red = max(1, field_num // reduction_ratio)
        self.w1 = nn.Parameter(init.torch_linear_weight(gen, (field_num,
                                                               red)))
        self.w2 = nn.Parameter(init.torch_linear_weight(gen, (red,
                                                              field_num)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = x.mean(dim=-1)                                  # [B, F]
        a = torch.relu(torch.relu(z @ self.w1) @ self.w2)
        return x * a[:, :, None]


class Bilinear(nn.Module):
    """``w`` ``[n, d, d]``: one map (``all``), one a field (``each``) or
    one a field pair (``interaction``), ``nn.Linear`` default init."""

    def __init__(self, gen: torch.Generator, field_num: int, dim: int,
                 bilinear_type: str = "interaction"):
        super().__init__()
        n = {"all": 1, "each": field_num,
             "interaction": field_num * (field_num - 1) // 2}.get(
            bilinear_type)
        if n is None:
            raise ValueError("bilinear_type must be all/each/interaction")
        self.bilinear_type = bilinear_type
        self.w = nn.Parameter(torch.stack(
            [init.torch_linear_weight(gen, (dim, dim)) for _ in range(n)]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, F, d]`` -> ``[B, F * (F - 1) / 2, d]``, the pairwise
        bilinear interactions."""
        pi, pj = _pairs(x)
        if self.bilinear_type == "all":
            proj = (x @ self.w[0])[:, pi]
        elif self.bilinear_type == "each":
            proj = torch.einsum("bfd,fde->bfe", x, self.w)[:, pi]
        else:  # pair k's own map on its first field, all pairs at once
            proj = torch.einsum("bkd,kde->bke", x[:, pi], self.w)
        return proj * x[:, pj]


# ---------------------------------------------------------------------------
# AFM attention layer
# ---------------------------------------------------------------------------

class AFMLayer(nn.Module):
    """``att_w`` ``[d, A]`` (Xavier-normal), ``att_b`` ``[A]`` zeros,
    ``proj_h`` ``[A, 1]`` and ``proj_p`` ``[d, 1]`` (Xavier-normal)."""

    def __init__(self, gen: torch.Generator, dim: int,
                 attention_factor: int = 8):
        super().__init__()
        self.att_w = nn.Parameter(_xavier_normal(gen, (dim,
                                                       attention_factor)))
        self.att_b = nn.Parameter(torch.zeros(attention_factor,
                                              device=gen.device))
        self.proj_h = nn.Parameter(_xavier_normal(gen, (attention_factor,
                                                        1)))
        self.proj_p = nn.Parameter(_xavier_normal(gen, (dim, 1)))

    def forward(self, x: torch.Tensor, *, dropout_rate: float = 0.0,
                train: bool = False, key=None) -> torch.Tensor:
        """``[B, F, d]`` -> ``[B, 1]``, the attentional FM logit; the
        pooled vector's dropout drawn from ``key``."""
        pi, pj = _pairs(x)
        prod = x[:, pi] * x[:, pj]                          # [B, pairs, d]
        att = torch.relu(prod @ self.att_w + self.att_b)
        scores = torch.softmax(att @ self.proj_h, dim=1)    # [B, pairs, 1]
        out = (scores * prod).sum(dim=1)                    # [B, d]
        if dropout_rate > 0.0 and train:
            out = core.dropout(out, dropout_rate, train, key)
        return out @ self.proj_p


# ---------------------------------------------------------------------------
# PNN product layers
# ---------------------------------------------------------------------------

def inner_product(x: torch.Tensor) -> torch.Tensor:
    """``[B, F, d]`` -> ``[B, F * (F - 1) / 2]``, the pairwise dots."""
    pi, pj = _pairs(x)
    return (x[:, pi] * x[:, pj]).sum(dim=-1)


class OuterProduct(nn.Module):
    """``kernel`` ``[d, pairs, d]`` (mat), ``[pairs, d]`` (vec) or
    ``[pairs, 1]`` (num), Xavier-uniform."""

    def __init__(self, gen: torch.Generator, field_num: int, dim: int,
                 kernel_type: str = "mat"):
        super().__init__()
        pairs = field_num * (field_num - 1) // 2
        shape = {"mat": (dim, pairs, dim), "vec": (pairs, dim),
                 "num": (pairs, 1)}.get(kernel_type)
        if shape is None:
            raise ValueError("kernel_type must be mat/vec/num")
        self.kernel_type = kernel_type
        self.kernel = nn.Parameter(_xavier_uniform(gen, shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pi, pj = _pairs(x)
        p, q = x[:, pi], x[:, pj]                           # [B, pairs, d]
        if self.kernel_type == "mat":
            # torch: sum(p.unsqueeze(1) * kernel, -1).permute(0, 2, 1) * q
            kp = (p[:, None] * self.kernel[None]).sum(dim=-1)  # [B, d, pairs]
            return (kp.permute(0, 2, 1) * q).sum(dim=-1)
        return (p * q * self.kernel[None]).sum(dim=-1)
