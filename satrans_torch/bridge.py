"""Move parameters of the JAX package into the port.

:func:`from_jax_params` takes the parameter pytree that a model's
``init`` returns in the JAX package (any model of its registry),
with its leaves converted to numpy arrays, and gives a ``state_dict`` for
the port's model.  The port's
modules carry the pytree's own names, so a key is the pytree path joined
with dots (``layers.0.q_meta.ln.scale``); the gate and bilinear layers
have no ``q_meta`` and an ``only_emb`` model no ``encoder``, in both
packages, and a 'pos' model has ``layerid_emb``, ``qkvid_emb`` and, in
its metanet layers, ``k_meta`` and ``v_meta`` (``layers.0.k_meta.ln.
scale``), and a model of several scenario columns ``domain_bank``.  A
tree of another configuration than the model's (a 'pos' tree into a
shared model) raises.  A zoo model's keys are its pytree's too: ``linear.emb.bank``
and ``linear.dense_w`` of the linear model, ``domain_map.layers.0.w`` of
the meta module, and lists of layers (``cin.convs``, ``int_layers``,
``dnn_layers``, ``pruners``) by index.  The one change of layout is the
embedding banks (``emb.bank``, ``domain_bank.bank``, the linear model's
dimension-1 ``linear.emb.bank``): the JAX package packs ``128 // d``
logical rows into one 128-lane row; the port keeps the same rows, pad
rows included, as logical ``[R, d]`` rows, so each bank is reshaped.
STAR's stacked per-domain layers are lists too (``domain_w.0``), and the
multi-task models' nested lists of MLPs take one index a level
(``specific_experts.1.0.0.layers.0.w``).  The legacy Star-Trans trees
hold the lists ``int_layers``, ``domain_int_layers``, ``weight_dnns``,
``encoders`` and ``layers`` (``domain_int_layers.0.wq_domain``,
``weight_dnns.1.layers.0.w``, ``encoders.1.layers.0.b``) and the tables
``head_w`` / ``head_b``, ``domain_emb``, ``layerid_emb`` and
``qkvid_emb``, under the same rule.

The JAX model state (``init``'s second value) becomes the port's buffers
under the same rule: STAR's ``state["bn"][d]`` is ``bn.<d>.mean``,
``var`` and ``count``.

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


def from_jax_params(params_np: dict, model: torch.nn.Module,
                    state_np: dict | None = None) -> dict:
    """State dict for ``model`` (a whole model or one of its modules) from
    the JAX pytree ``params_np`` and, with ``state_np``, the JAX model
    state; raises when a name or shape does not match (an unported
    variant)."""
    want = model.state_dict()
    flat = dict(_flatten(params_np))
    flat.update(_flatten(state_np or {}))
    if set(flat) != set(want):
        raise KeyError(f"JAX parameters {sorted(set(flat) - set(want))} have "
                       f"no place in {type(model).__name__}, and "
                       f"{sorted(set(want) - set(flat))} have no JAX twin")
    out = {}
    for key, arr in flat.items():
        if key.rsplit(".", 1)[-1] == "bank":  # emb, domain_bank, linear.emb
            arr = arr.reshape(-1, want[key].shape[1])
        if tuple(arr.shape) != tuple(want[key].shape):
            raise ValueError(f"{key}: JAX shape {arr.shape}, port shape "
                             f"{tuple(want[key].shape)}")
        out[key] = torch.tensor(arr, dtype=want[key].dtype)
    return out
