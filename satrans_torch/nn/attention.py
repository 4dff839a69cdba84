"""The SATrans meta-transformer layer (twin of the ``meta_transformer_*``
part of ``satrans_tpu/nn/attention.py``).

:func:`meta_transformer_apply` is the plain PyTorch version of the layer
kernels at model level: shared W_Q/K/V, a scenario transform of Q (and K)
per ``meta_mode``, per-head softmax attention over the F fields, the
bias-free output linear, the residual from the raw input and the
LayerNorm.  The scenario transform is the layer's ``variant``:

* ``metanet`` - a MetaNet with scenario-generated weights, its dropout,
  residual and LayerNorm (``csrc/meta_block_fwd.cu``, K1);
* ``gate`` - ``t * g[dom] * 2`` with a per-domain d-vector gate;
* ``bilinear`` - a per-(domain, head) ``[dh, dh]`` map on Q after the
  head split, always, whatever the mode (``csrc/gate_block_fwd.cu``, K6).

Head split follows torch's ``torch.stack(torch.split(q, dh, dim=2))``:
``[B, F, d] -> [B, H, F, d/H]``.

The metanet layer's MetaNets are shared (one ``q_meta`` LayerNorm for Q
and K) or, under the reference's 'pos' flag (``share_kv_metanet=False``),
separate: K normalised with its own ``k_meta`` LayerNorm, and a
``v_meta`` that is never applied, as in the reference.  Dropout is given
as ``masks``, one per site, drawn by ``ops/prng.py`` as the fused kernels
draw them: on each MetaNet's output before its residual, on the attention
probabilities after the softmax and on the output projection after the
optional relu.  ``clamp`` clamps the attention logits to [-60, 60] as the
Pallas kernels do, with the gradient passed through as if unclamped; the
JAX package's XLA layer does not clamp.  Autograd of this function is the
plain version of the backward kernels.  The rest raises
``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from . import core, initializers as init, metanet


def _split_heads(x, head_num: int):
    """[B, F, d] -> [B, H, F, d/H]"""
    b, f, d = x.shape
    return x.reshape(b, f, head_num, d // head_num).permute(0, 2, 1, 3)


def _merge_heads(x):
    """[B, H, F, dh] -> [B, F, H*dh]"""
    b, h, f, dh = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, f, h * dh)


LOGIT_CLAMP = 60.0  # the Pallas kernels' _clip_logits (meta_block.py:61-69)


def _mha(q, k, v, head_num: int, mask=None, clamp: bool = False):
    """Multi-head attention over the F field axis, logits scaled by
    1/sqrt(dh) (and with ``clamp`` clamped to [-60, 60], the gradient
    passing straight through), the probabilities ``[B, H, F, F]``
    multiplied by ``mask`` before the values.  Returns the output and the
    probabilities before the mask."""
    dh = q.shape[-1] // head_num
    qh, kh, vh = (_split_heads(t, head_num) for t in (q, k, v))
    scores = torch.einsum("bhik,bhjk->bhij", qh, kh) / math.sqrt(dh)
    if clamp:
        scores = scores + (scores.clamp(-LOGIT_CLAMP, LOGIT_CLAMP)
                           - scores).detach()
    probs = torch.softmax(scores, dim=-1)
    used = probs if mask is None else probs * mask
    return _merge_heads(torch.einsum("bhij,bhjk->bhik", used, vh)), probs


VARIANTS = ("metanet", "gate", "bilinear")


class MetaTransformerLayer(nn.Module):
    """Parameters of one layer: ``wq/wk/wv/wout`` ``[d, d]``, the
    post-residual ``ln`` and, for the metanet variant only, the MetaNets'
    LayerNorms: ``q_meta.ln``, and without ``share_kv_metanet`` also
    ``k_meta.ln`` and the never-applied ``v_meta.ln`` (the JAX param tree,
    attention.py:135-161)."""

    def __init__(self, gen: torch.Generator, dim: int, *,
                 variant: str = "metanet", share_kv_metanet: bool = True,
                 std: float = 0.05):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"unknown variant {variant!r}")
        self.variant = variant
        self.wq = nn.Parameter(init.normal(gen, (dim, dim), std))
        self.wk = nn.Parameter(init.normal(gen, (dim, dim), std))
        self.wv = nn.Parameter(init.normal(gen, (dim, dim), std))
        self.wout = nn.Parameter(init.normal(gen, (dim, dim), std))
        # Quirk of the reference: this LN sits inside its N(0, 0.05) init
        # loop, so scale and bias are drawn too.
        self.ln = core.LayerNorm(
            gen, dim, weight_init=lambda g, s: init.normal(g, s, std),
            bias_init=lambda g, s: init.normal(g, s, std))
        if variant == "metanet":
            self.q_meta = metanet.MetaNet(gen, dim)
            if not share_kv_metanet:
                self.k_meta = metanet.MetaNet(gen, dim)
                # Quirk of the reference, kept: initialised, never applied
                # (JAX attention.py:153-160)
                self.v_meta = metanet.MetaNet(gen, dim)


def meta_transformer_init(gen: torch.Generator, dim: int,
                          meta_units: Sequence[int], *,
                          variant: str = "metanet",
                          share_kv_metanet: bool = True,
                          std: float = 0.05) -> MetaTransformerLayer:
    """A layer; its MetaNets' weights come from the tables, of any depth
    (``meta_units``), so its parameters do not depend on it."""
    return MetaTransformerLayer(gen, dim, variant=variant,
                                share_kv_metanet=share_kv_metanet, std=std)


def meta_transformer_apply(layer: MetaTransformerLayer, x, meta_params,
                           meta_units: Sequence[int], *, mode: str = "QK",
                           head_num: int = 4, relu_out: bool = False,
                           domain_ids=None, dense_select: bool = False,
                           masks=None, residuals: dict | None = None,
                           clamp: bool = False):
    """One SATrans block of ``layer.variant``.

    ``meta_params``: dict with keys 'Q' and 'K' (and 'bilinear' for that
    variant).  Each value is either per-example ``[B, P]`` flat params
    or, when ``domain_ids`` is given, per-domain ``[D, P]`` tables.  A
    projection is transformed iff its letter appears in ``mode`` (so
    'Query' transforms Q only; V is never transformed, as in the
    reference); the bilinear map applies to Q in every mode.  ``masks``:
    ``(m_yq, m_yk, m_s, m_z)`` dropout masks of the four sites
    (``ops/prng.dropout_masks``; an unapplied projection's is ``None``,
    and gate and bilinear have none there), or ``None`` for no dropout.
    ``clamp``: the Pallas kernels' logit clamp (see :func:`_mha`).  A
    ``residuals`` dict receives what the stash kernel writes: ``qkv``
    ``[B, F, 3d]``, the pre-LayerNorm sums ``uq``/``uk`` (the raw
    projection where it is not transformed), the probabilities ``s``
    before dropout and the attention output ``o``."""
    m_q, m_k, m_s, m_z = masks if masks is not None else (None,) * 4
    q0, k0, v = x @ layer.wq, x @ layer.wk, x @ layer.wv

    def rows(params):
        return params if domain_ids is None else params[domain_ids]

    def pre_ln(t, params, mask):
        if domain_ids is None:
            return metanet.flat_sum(t, params, meta_units, mask=mask)
        return metanet.domainwise_sum(t, domain_ids, params, meta_units,
                                      dense_select=dense_select, mask=mask)

    uq, uk, q, k = q0, k0, q0, k0
    if layer.variant == "metanet":
        if "Q" in mode:
            uq = pre_ln(q0, meta_params["Q"], m_q)
            q = layer.q_meta.ln(uq)
        if "K" in mode:
            uk = pre_ln(k0, meta_params["K"], m_k)
            k = getattr(layer, "k_meta", layer.q_meta).ln(uk)
    elif layer.variant == "gate":
        d = x.shape[-1]
        # t * g * 2, the gate broadcast over fields (satrans.py:61-62)
        if "Q" in mode:
            q = q0 * rows(meta_params["Q"][..., :d])[:, None, :] * 2.0
        if "K" in mode:
            k = k0 * rows(meta_params["K"][..., :d])[:, None, :] * 2.0
    else:
        # per-head bilinear map on Q (satrans.py:79-81)
        dh = x.shape[-1] // head_num
        w = rows(meta_params["bilinear"][..., :head_num * dh * dh]).reshape(
            -1, head_num, dh, dh)
        q = _merge_heads(torch.einsum("bhfk,bhkl->bhfl",
                                      _split_heads(q0, head_num), w))
    o, probs = _mha(q, k, v, head_num, m_s, clamp)
    out = o @ layer.wout                          # bias-free output linear
    if relu_out:                                  # the 'relu' flag
        out = torch.relu(out)
    if m_z is not None:
        out = out * m_z
    if residuals is not None:
        residuals.update(qkv=torch.cat([q0, k0, v], dim=-1), uq=uq, uk=uk,
                         s=probs, o=o)
    return layer.ln(out + x)
