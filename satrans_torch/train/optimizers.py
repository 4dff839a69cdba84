"""The Trainer's optimizers other than Adam, with optax's update rules
(the JAX Trainer's ``optax.sgd(0.01)``, ``optax.adagrad(0.01)`` and
``optax.rmsprop(learning_rate)``, trainer.py:233-247), not the defaults of
``torch.optim``'s namesakes:

* :class:`SGD`: ``p += -lr * g``.
* :class:`Adagrad`: the accumulator starts at 0.1 and the update is
  ``-lr * g * rsqrt(sum + 1e-7)``, the eps inside the square root
  (``torch.optim.Adagrad`` starts at 0 and adds its eps outside).
* :class:`RMSprop`: ``nu = 0.9 nu + 0.1 g^2`` from 0 and the update
  ``-lr * g * rsqrt(nu + 1e-8)`` (``eps_in_sqrt=True``;
  ``torch.optim.RMSprop`` decays by 0.99 and adds its eps outside).

Each step is a few ``torch._foreach_*`` passes over all parameters, each
operation rounded where optax rounds it (no fused multiply-add).  The
state of a parameter is one tensor under ``state[p]`` (``sum`` or
``nu``), which ``train/checkpoint.py`` saves by parameter name.
"""

from __future__ import annotations

import torch


class _Foreach(torch.optim.Optimizer):
    """The parameters of one group with a gradient, and their states."""

    state_key: str | None = None
    initial: float = 0.0

    def __init__(self, params, lr: float):
        super().__init__(params, {"lr": float(lr)})

    def _live(self, group):
        params = [p for p in group["params"] if p.grad is not None]
        if self.state_key is None:
            return params, [p.grad for p in params], []
        states = []
        for p in params:
            st = self.state[p]
            if not st:
                st[self.state_key] = torch.full_like(
                    p, self.initial, memory_format=torch.preserve_format)
            states.append(st[self.state_key])
        return params, [p.grad for p in params], states

    def _apply(self, params, scaled, lr):
        # optax: updates * -lr, then params + updates
        if params:
            torch._foreach_mul_(scaled, -lr)
            torch._foreach_add_(params, scaled)


class SGD(_Foreach):
    """``optax.sgd(lr)`` without momentum."""

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params, grads, _ = self._live(group)
            self._apply(params, [g.clone() for g in grads], group["lr"])


class Adagrad(_Foreach):
    """``optax.adagrad(lr)``: ``scale_by_rss(0.1, 1e-7)``."""

    state_key, initial, eps = "sum", 0.1, 1e-7

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params, grads, sums = self._live(group)
            if not params:
                continue
            torch._foreach_add_(sums, torch._foreach_mul(grads, grads))
            # where(sum > 0, rsqrt(sum + eps), 0): the sum starts at 0.1
            inv = torch._foreach_rsqrt(torch._foreach_add(sums, self.eps))
            self._apply(params, torch._foreach_mul(inv, grads), group["lr"])


class RMSprop(_Foreach):
    """``optax.rmsprop(lr)``: ``scale_by_rms(0.9, 1e-8, 0.0,
    eps_in_sqrt=True)``."""

    state_key, initial, decay, eps = "nu", 0.0, 0.9, 1e-8

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params, grads, nus = self._live(group)
            if not params:
                continue
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, 1.0 - self.decay)
            torch._foreach_mul_(nus, self.decay)
            torch._foreach_add_(nus, sq)
            inv = torch._foreach_rsqrt(torch._foreach_add(nus, self.eps))
            self._apply(params, torch._foreach_mul(inv, grads), group["lr"])


# the JAX Trainer's named optimizers: sgd and adagrad at 0.01 whatever the
# learning rate (trainer.py:239-240), rmsprop at the learning rate
NAMED = {"sgd": lambda params, lr: SGD(params, 0.01),
         "adagrad": lambda params, lr: Adagrad(params, 0.01),
         "rmsprop": lambda params, lr: RMSprop(params, lr)}
