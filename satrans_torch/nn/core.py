"""Core NN building blocks (twin of ``satrans_tpu/nn/core.py``).

* :func:`activation` - an activation by the reference's name
* :func:`dropout`    - ``nn.Dropout`` with the JAX package's masks
                       (``jax.random.bernoulli``, ``ops/threefry.py``)
* :class:`Linear`    - ``y = x @ w + b`` with ``w`` stored ``[in, out]``
                       (``use_bias=False``: no ``b``)
* :class:`MLP`       - deepctr ``DNN`` (``final_activation=True``) or
                       ``DNN_v2`` (False: the last layer has no activation;
                       the scenario encoder), with the dropout of the JAX
                       package's ``mlp_apply``
* :class:`LayerNorm` - ``nn.LayerNorm(eps=1e-6)`` with ``scale``/``bias``
* :func:`prediction` - deepctr ``PredictionLayer``

BatchNorm is not ported: no model of the port enables it.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn

from . import initializers as init
from ..ops import threefry

_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    # jax.nn.gelu's default is the tanh approximation
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    "leaky_relu": lambda x: torch.nn.functional.leaky_relu(x, 0.01),
    "elu": torch.nn.functional.elu,
    "linear": lambda x: x,
    "none": lambda x: x,
}


def activation(name: str) -> Callable:
    try:
        return _ACTIVATIONS[name.lower()]
    except KeyError:
        raise ValueError(f"Unknown activation {name!r}") from None


def dropout(x: torch.Tensor, rate: float, train: bool, key) -> torch.Tensor:
    """Inverted dropout (scale by ``1 / (1 - rate)``), the keep mask
    ``jax.random.bernoulli(key, 1 - rate, x.shape)`` of the threefry
    ``key``, as ``satrans_tpu/nn/core.py:59-64``."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = threefry.bernoulli(key, keep, x.shape, x.device)
    return torch.where(mask, x / keep, 0.0)


class Linear(nn.Module):
    def __init__(self, gen: torch.Generator, in_dim: int, out_dim: int, *,
                 weight_init: Callable = init.torch_linear_weight,
                 use_bias: bool = True):
        super().__init__()
        self.w = nn.Parameter(weight_init(gen, (in_dim, out_dim)))
        self.b = nn.Parameter(init.torch_linear_bias(
            gen, (out_dim,), in_dim)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.w
        return y if self.b is None else y + self.b


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis with two-pass moments."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


class LayerNorm(nn.Module):
    def __init__(self, gen: torch.Generator, dim: int, *,
                 weight_init: Callable = init.ones,
                 bias_init: Callable = init.zeros):
        super().__init__()
        self.scale = nn.Parameter(weight_init(gen, (dim,)))
        self.bias = nn.Parameter(bias_init(gen, (dim,)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias)


class MLP(nn.Module):
    """Weights ~ N(0, init_std); biases keep the ``nn.Linear`` default
    U(+-1/sqrt(fan_in)).  ReLU after every layer, or after every layer but
    the last with ``final_activation=False``; in training each activation
    is followed by its dropout, layer ``i``'s drawn from ``fold_in(key,
    i)`` (``mlp_apply``, core.py:138-170)."""

    def __init__(self, gen: torch.Generator, in_dim: int,
                 hidden_units: Sequence[int], *, init_std: float = 1e-4,
                 final_activation: bool = True):
        super().__init__()
        if len(hidden_units) == 0:
            raise ValueError("hidden_units is empty")
        dims = [in_dim] + list(hidden_units)
        self.layers = nn.ModuleList(
            Linear(gen, dims[i], dims[i + 1],
                   weight_init=lambda g, s: init.normal(g, s, init_std))
            for i in range(len(dims) - 1))
        self.final_activation = final_activation

    def forward(self, x: torch.Tensor, *, dropout_rate: float = 0.0,
                train: bool = False, key=None) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if self.final_activation or i < len(self.layers) - 1:
                x = torch.relu(x)
                if dropout_rate > 0.0 and train:
                    x = dropout(x, dropout_rate, train,
                                threefry.fold_in(key, i))
        return x


def prediction(logit: torch.Tensor, task: str = "binary") -> torch.Tensor:
    if task == "binary":
        return torch.sigmoid(logit)
    if task == "regression":
        return logit
    raise ValueError(f"task must be binary or regression, got {task!r}")
