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
* :func:`one_hot`    - ``jax.nn.one_hot``: a zero row for an id outside
                       ``[0, n)``
* :func:`batch_norm_apply` / :class:`BatchNorm` - BatchNorm1d on explicit
                       running statistics with the masked moments of the
                       JAX package (STAR's domain BatchNorm)
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


def one_hot(ids: torch.Tensor, n: int, dtype=torch.float32) -> torch.Tensor:
    """``jax.nn.one_hot(ids, n)``: ``[..., n]``, with a zero row where an
    id lies outside ``[0, n)`` (``torch.nn.functional.one_hot`` raises
    there).  The zero row keeps a pad row, whose domain id is 0 (-1 after
    the offset), out of every domain."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).to(dtype)


def batch_norm_state(dim: int, device="cpu") -> dict:
    """Running statistics of :func:`batch_norm_apply`: ``mean`` 0, ``var``
    1 and the int32 ``count`` of train-mode calls."""
    return {"mean": torch.zeros(dim, device=device),
            "var": torch.ones(dim, device=device),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def batch_norm_apply(x: torch.Tensor, state: dict, *, train: bool,
                     scale: torch.Tensor, bias: torch.Tensor,
                     momentum: float = 0.1, eps: float = 1e-5,
                     batch_weight: torch.Tensor | None = None):
    """BatchNorm1d with torch semantics on explicit ``state`` (twin of
    ``batch_norm_apply``, satrans_tpu/nn/core.py:187-235); returns ``(y,
    new_state)``, the new state detached.

    In training ``x`` is normalized with the biased variance of the batch,
    or with ``batch_weight`` (a ``[B]`` 0/1 mask) of its weighted subset
    over ``n = max(sum w, 1)`` rows; the running variance moves toward
    the unbiased ``var * n / max(n - 1, 1)``.  A subset with no row keeps
    its ``mean`` and ``var``; ``count`` rises by one all the same.  In
    eval mode the running statistics normalize and the state is
    returned as it is."""
    if train:
        if batch_weight is None:
            n = float(x.shape[0])
            mean = torch.mean(x, dim=0)
            var = torch.mean(torch.square(x - mean), dim=0)
        else:
            w = batch_weight.to(x.dtype)[:, None]
            n = torch.clamp(torch.sum(w), min=1.0)
            mean = torch.sum(x * w, dim=0) / n
            var = torch.sum(torch.square(x - mean) * w, dim=0) / n
        with torch.no_grad():
            # torch tracks the unbiased variance in its running statistics
            if batch_weight is None:
                unbiased = var * (n / max(n - 1.0, 1.0))
            else:
                unbiased = var * (n / torch.clamp(n - 1.0, min=1.0))
            new_mean = (1 - momentum) * state["mean"] + momentum * mean
            new_var = (1 - momentum) * state["var"] + momentum * unbiased
            if batch_weight is not None:
                has = torch.sum(batch_weight.to(x.dtype)) > 0
                new_mean = torch.where(has, new_mean, state["mean"])
                new_var = torch.where(has, new_var, state["var"])
            new_state = {"mean": new_mean.detach(), "var": new_var.detach(),
                         "count": state["count"] + 1}
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    y = (x - mean) * torch.rsqrt(var + eps) * scale + bias
    return y, new_state


class BatchNorm(nn.Module):
    """The running statistics of one BatchNorm as buffers (``mean``,
    ``var``, ``count``; the affine comes from the caller).  A train-mode
    call updates them in place, once, without gradient; an eval-mode call
    reads them and leaves them as they are."""

    def __init__(self, dim: int, device="cpu"):
        super().__init__()
        for k, v in batch_norm_state(dim, device).items():
            self.register_buffer(k, v)

    def forward(self, x: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor, *, train: bool,
                batch_weight: torch.Tensor | None = None) -> torch.Tensor:
        state = {"mean": self.mean, "var": self.var, "count": self.count}
        y, new = batch_norm_apply(x, state, train=train, scale=scale,
                                  bias=bias, batch_weight=batch_weight)
        if train:
            with torch.no_grad():
                for k, v in new.items():
                    getattr(self, k).copy_(v)
        return y
