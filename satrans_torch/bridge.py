"""Move parameters of the JAX package into the port.

:func:`from_jax_params` takes the parameter pytree that
``satrans_tpu.models.SATrans.init`` returns, with its leaves converted to
numpy arrays, and gives a ``state_dict`` for the port's model.  The port's
modules carry the pytree's own names, so a key is the pytree path joined
with dots (``layers.0.q_meta.ln.scale``); the gate and bilinear layers
have no ``q_meta`` and an ``only_emb`` model no ``encoder``, in both
packages, and a 'pos' model has ``layerid_emb``, ``qkvid_emb`` and, in
its metanet layers, ``k_meta`` and ``v_meta`` (``layers.0.k_meta.ln.
scale``), and a model of several scenario columns ``domain_bank``.  A
tree of another configuration than the model's (a 'pos' tree into a
shared model) raises.  The one change of layout is the embedding banks
(``emb.bank``, ``domain_bank.bank``): the JAX package packs ``128 // d``
logical rows into one 128-lane row; the port keeps the same rows, pad
rows included, as logical ``[R, d]`` rows, so each bank is reshaped.

The module imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def from_jax_params(params_np: dict, model: torch.nn.Module) -> dict:
    """State dict for ``model`` (a whole model or one of its modules) from
    the JAX pytree ``params_np``; raises when a name or shape does not
    match (an unported variant)."""
    want = model.state_dict()
    flat = dict(_flatten(params_np))
    if set(flat) != set(want):
        raise KeyError(f"JAX parameters {sorted(set(flat) - set(want))} have "
                       f"no place in {type(model).__name__}, and "
                       f"{sorted(set(want) - set(flat))} have no JAX twin")
    out = {}
    for key, arr in flat.items():
        if key.rsplit(".", 1)[-1] == "bank":  # emb, domain_bank
            arr = arr.reshape(-1, want[key].shape[1])
        if tuple(arr.shape) != tuple(want[key].shape):
            raise ValueError(f"{key}: JAX shape {arr.shape}, port shape "
                             f"{tuple(want[key].shape)}")
        out[key] = torch.tensor(arr, dtype=want[key].dtype)
    return out
