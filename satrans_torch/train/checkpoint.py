"""Checkpoint save and restore (twin of ``satrans_tpu/train/checkpoint.py``).

A checkpoint is one file written with ``torch.save``, of plain tensors and
ints only, so that ``torch.load(weights_only=True)`` reads it.  It carries
what the JAX package's checkpoint carries:

* ``params``: the model's ``state_dict()``, its buffers (the model
  state: STAR's BatchNorm statistics) included;
* ``opt_state``: the optimizer's kind (``'adam'``, ``'sgd'``,
  ``'adagrad'``, ``'rmsprop'`` or ``'custom:<class>'``) and its state of
  every parameter it has updated (the ``torch.optim.Optimizer`` state:
  Adam's moments and step, Adagrad's ``sum``, RMSprop's ``nu``), keyed by
  parameter name; under ``bank_update='lazy'`` the lazy bank's ``mu``,
  ``nu``, ``last`` and ``count`` (``Trainer._lazy``, which the port keeps
  outside torch's optimizer); and the bank mode the trainer was compiled
  under;
* ``meta``: the fit-learned ``domain_id_offset``, or the no-offset
  sentinel ``-2**31`` for a model without one (SATrans has none).

Under a mesh the first rank writes the file a single card writes: a
row-sharded bank and its state are gathered from every rank first, and
every rank waits at a barrier until the file is whole.  A restore under
a mesh takes this rank's rows, so a checkpoint moves between a mesh and
one card either way.

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
_BANK = "emb.bank"


def _optimizer_state(trainer) -> dict:
    """``{parameter name: state dict}`` of the parameters the optimizer
    has state for."""
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    return {names[id(p)]: dict(st)
            for p, st in trainer.optimizer.state.items()}


def _shard(trainer):
    """The row-sharded bank's ``BankShard``, or None."""
    return getattr(getattr(trainer.model, "emb", None), "shard", None)


def _whole(trainer, payload: dict) -> dict:
    """``payload`` with the row-sharded bank, its Adam moments and the
    lazy ``mu``, ``nu`` and ``last`` gathered from every rank and cut to
    the unpadded bank: the file a single card writes."""
    from ..parallel.sharding import gather_bank
    shard = _shard(trainer)
    rp = trainer.model.emb.rp
    params = dict(payload["params"])
    params[_BANK] = gather_bank(params[_BANK], shard, rp)
    state = payload["opt_state"]["state"]
    if _BANK in state:
        state[_BANK] = {k: gather_bank(v, shard, rp) if v.dim() else v
                        for k, v in state[_BANK].items()}
    lazy = payload["opt_state"].get("lazy")
    if lazy is not None:
        for k in _LAZY_KEYS:
            lazy[k] = gather_bank(lazy[k], shard, rp)
    payload["params"] = params
    return payload


def _place(trainer, payload: dict) -> dict:
    """``payload`` (a single card's file) with this rank's rows of the
    bank, of its Adam moments and of the lazy state."""
    from ..parallel.sharding import shard_of
    shard = _shard(trainer)
    rp = trainer.model.emb.rp
    params = dict(payload["params"])
    params[_BANK] = shard_of(params[_BANK], shard, rp)
    state = payload["opt_state"]["state"]
    if _BANK in state:
        state[_BANK] = {k: shard_of(v, shard, rp) if v.dim() else v
                        for k, v in state[_BANK].items()}
    lazy = payload["opt_state"].get("lazy")
    if lazy is not None:
        for k in _LAZY_KEYS:
            lazy[k] = shard_of(lazy[k], shard, 1)
    payload["params"] = params
    return payload


def save(path: str, trainer) -> None:
    """Write ``trainer``'s parameters, optimizer state and fit-learned
    config to the file ``path`` (its directory is created; the file is
    replaced atomically)."""
    if trainer.optimizer is None:
        raise RuntimeError("call compile() before saving a checkpoint")
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    offset = getattr(trainer.model, "domain_id_offset", None)
    opt = {"optimizer": trainer.optimizer_kind,
           "state": _optimizer_state(trainer),
           "bank_mode": _MODES.index(trainer._bank_mode)}
    if trainer._lazy is not None:
        opt["lazy"] = {**{k: trainer._lazy[k] for k in _LAZY_KEYS},
                       "count": int(trainer._lazy["count"])}
    payload = {"params": trainer.model.state_dict(), "opt_state": opt,
               "meta": {"domain_id_offset": _NO_OFFSET if offset is None
                        else int(offset)}}
    mesh = getattr(trainer, "mesh", None)
    if _shard(trainer) is not None:
        payload = _whole(trainer, payload)
    if mesh is None or mesh.rank == 0:
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
    if mesh is not None:
        mesh.barrier()  # the file is whole before any rank reads it


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
    parameters and buffers, the optimizer's state, the lazy bank's state
    and the fit-learned ``domain_id_offset``.  A checkpoint of another
    optimizer or bank mode raises."""
    if trainer.optimizer is None:
        raise RuntimeError("call compile() before restoring a checkpoint")
    payload = read(path, trainer.device)
    if _shard(trainer) is not None:
        payload = _place(trainer, payload)
    opt = payload["opt_state"]
    saved_mode = _MODES[opt["bank_mode"]]
    if saved_mode != trainer._bank_mode:
        raise ValueError(
            f"checkpoint {path} was written under bank_update="
            f"{saved_mode!r}, the trainer is compiled under "
            f"{trainer._bank_mode!r}")
    if opt["optimizer"] != trainer.optimizer_kind:
        raise ValueError(
            f"checkpoint {path} was written with optimizer "
            f"{opt['optimizer']!r}, the trainer is compiled with "
            f"{trainer.optimizer_kind!r}")
    load_model(payload, trainer.model)
    params = dict(trainer.model.named_parameters())
    trainer.optimizer.state.clear()
    for name, st in opt["state"].items():
        trainer.optimizer.state[params[name]] = dict(st)
    if trainer._lazy is not None:
        lazy = opt["lazy"]
        for k in _LAZY_KEYS:
            trainer._lazy[k].copy_(lazy[k])
        trainer._lazy["count"] = int(lazy["count"])
