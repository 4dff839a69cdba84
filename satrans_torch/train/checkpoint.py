"""Checkpoint save and restore (twin of ``satrans_tpu/train/checkpoint.py``).

A checkpoint is one file written with ``torch.save``, of plain tensors and
ints only, so that ``torch.load(weights_only=True)`` reads it.  It carries
what the JAX package's checkpoint carries:

* ``params``: the model's ``state_dict()``, its buffers (the model
  state: STAR's BatchNorm statistics) included;
* ``opt_state``: Adam's moments and step of every parameter it has updated
  (``torch.optim.Adam``'s state, keyed by parameter name), and under
  ``bank_update='lazy'`` the lazy bank's ``mu``, ``nu``, ``last`` and
  ``count`` (``Trainer._lazy``, which the port keeps outside torch's
  optimizer), and the bank mode the trainer was compiled under;
* ``meta``: the fit-learned ``domain_id_offset``, or the no-offset
  sentinel ``-2**31`` for a model without one (SATrans has none).

The Trainer's step key for the dropout seeds is not saved: the JAX
package's ``fit`` draws its step key anew at every call and its checkpoint
holds none, and so does the port's.

The reference only has a post-training ``torch.save(state_dict)`` without
a load path (main.py:399-401); save and resume are the JAX package's
capability.  Orbax checkpoints of the JAX package and these files are not
interchangeable: parameters move from JAX with
``satrans_torch.bridge.from_jax_params``.
"""

from __future__ import annotations

import os

import torch

_NO_OFFSET = -(2 ** 31)  # sentinel: model has no fit-learned domain offset
_MODES = ("dense", "fused", "fused_eq", "lazy")
_LAZY_KEYS = ("mu", "nu", "last")


def _adam_state(trainer) -> dict:
    """``{parameter name: {'exp_avg', 'exp_avg_sq', 'step'}}`` of the
    parameters Adam has state for."""
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    return {names[id(p)]: dict(st)
            for p, st in trainer.optimizer.state.items()}


def save(path: str, trainer) -> None:
    """Write ``trainer``'s parameters, optimizer state and fit-learned
    config to the file ``path`` (its directory is created; the file is
    replaced atomically)."""
    if trainer.optimizer is None:
        raise RuntimeError("call compile() before saving a checkpoint")
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    offset = getattr(trainer.model, "domain_id_offset", None)
    opt = {"adam": _adam_state(trainer),
           "bank_mode": _MODES.index(trainer._bank_mode)}
    if trainer._lazy is not None:
        opt["lazy"] = {**{k: trainer._lazy[k] for k in _LAZY_KEYS},
                       "count": int(trainer._lazy["count"])}
    payload = {"params": trainer.model.state_dict(), "opt_state": opt,
               "meta": {"domain_id_offset": _NO_OFFSET if offset is None
                        else int(offset)}}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def read(path: str, device) -> dict:
    """The checkpoint at ``path`` with its tensors on ``device``."""
    return torch.load(os.path.abspath(path), map_location=device,
                      weights_only=True)


def load_model(payload: dict, model) -> None:
    """Load a read checkpoint's parameters and buffers into ``model`` and
    set its fit-learned ``domain_id_offset`` (checkpoint.py:69-71)."""
    model.load_state_dict(payload["params"])
    offset = int(payload["meta"]["domain_id_offset"])
    if offset != _NO_OFFSET and hasattr(model, "set_domain_offset"):
        model.set_domain_offset(offset)


def restore(path: str, trainer) -> None:
    """Restore in place into a compiled trainer (shapes must match): the
    parameters and buffers, Adam's state, the lazy bank's state and the
    fit-learned ``domain_id_offset``.  A checkpoint of another bank mode
    raises."""
    if trainer.optimizer is None:
        raise RuntimeError("call compile() before restoring a checkpoint")
    payload = read(path, trainer.device)
    opt = payload["opt_state"]
    saved_mode = _MODES[opt["bank_mode"]]
    if saved_mode != trainer._bank_mode:
        raise ValueError(
            f"checkpoint {path} was written under bank_update="
            f"{saved_mode!r}, the trainer is compiled under "
            f"{trainer._bank_mode!r}")
    load_model(payload, trainer.model)
    params = dict(trainer.model.named_parameters())
    trainer.optimizer.state.clear()
    for name, st in opt["adam"].items():
        trainer.optimizer.state[params[name]] = dict(st)
    if trainer._lazy is not None:
        lazy = opt["lazy"]
        for k in _LAZY_KEYS:
            trainer._lazy[k].copy_(lazy[k])
        trainer._lazy["count"] = int(lazy["count"])
