"""Field-wise multi-head self-attention layers (twin of
``satrans_tpu/nn/attention.py``).

* :class:`InteractingLayer` - deepctr-torch's ``InteractingLayer``
  (AutoInt): no scaling, no dropout, no LayerNorm; the residual through
  ``wres``; ReLU after the residual.
* :class:`SelfAttentionLayer` - the reference's ``SelfAttention_Layer``
  (AdaSparse's ``usetrans``): 1/sqrt(dh) scaling, attention and output
  dropout 0.1, a LayerNorm after the ReLU.
* :func:`meta_transformer_apply` - the SATrans meta-transformer layer, the
  plain PyTorch version of the layer kernels at model level: shared
  W_Q/K/V, a scenario transform of Q (and K) per ``meta_mode``, per-head
  softmax attention over the F fields, the bias-free output linear, the
  residual from the raw input and the LayerNorm.  The scenario transform
  is the layer's ``variant``:

  * ``metanet`` - a MetaNet with scenario-generated weights, its dropout,
    residual and LayerNorm (``csrc/meta_block_fwd.cu``, K1);
  * ``gate`` - ``t * g[dom] * 2`` with a per-domain d-vector gate;
  * ``bilinear`` - a per-(domain, head) ``[dh, dh]`` map on Q after the
    head split, always, whatever the mode (``csrc/gate_block_fwd.cu``,
    K6).

Head split follows torch's ``torch.stack(torch.split(q, dh, dim=2))``:
``[B, F, d] -> [B, H, F, d/H]``.

The metanet layer's MetaNets are shared (one ``q_meta`` LayerNorm for Q
and K) or, under the reference's 'pos' flag (``share_kv_metanet=False``),
separate: K normalised with its own ``k_meta`` LayerNorm, and a
``v_meta`` that is never applied, as in the reference.  Dropout hits
three sites: each MetaNet's output before its residual, the attention
probabilities after the softmax, and the output projection after the
optional relu.  Its masks come from one of two sources, chosen by the
caller: ``masks``, drawn by ``ops/prng.py`` as the fused kernels draw
them (the kernels' plain versions), or ``drop_key``, the JAX package's
XLA layer's ``jax.random.bernoulli`` masks (``ops/threefry.py``): the
key split four ways, for the Q and K MetaNets, the probabilities and the
output (attention.py:182-184).  ``clamp`` clamps the attention logits to
[-60, 60] as the Pallas kernels do, with the gradient passed through as
if unclamped; the JAX package's XLA layer does not clamp.  Autograd of
this function is the plain version of the backward kernels.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from . import core, initializers as init, metanet
from ..ops import threefry


def _split_heads(x, head_num: int):
    """[B, F, d] -> [B, H, F, d/H]"""
    b, f, d = x.shape
    return x.reshape(b, f, head_num, d // head_num).permute(0, 2, 1, 3)


def _merge_heads(x):
    """[B, H, F, dh] -> [B, F, H*dh]"""
    b, h, f, dh = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, f, h * dh)


LOGIT_CLAMP = 60.0  # the Pallas kernels' _clip_logits (meta_block.py:61-69)


def _mha(q, k, v, head_num: int, drop=None, clamp: bool = False,
         scaling: bool = True):
    """Multi-head attention over the F field axis, logits scaled by
    1/sqrt(dh) (unless not ``scaling``; with ``clamp`` clamped to [-60,
    60], the gradient passing straight through), the probabilities
    ``[B, H, F, F]`` passed through ``drop`` before the values.  Returns
    the output and the probabilities before the dropout."""
    dh = q.shape[-1] // head_num
    qh, kh, vh = (_split_heads(t, head_num) for t in (q, k, v))
    scores = torch.einsum("bhik,bhjk->bhij", qh, kh)
    if scaling:
        scores = scores / math.sqrt(dh)
    if clamp:
        scores = scores + (scores.clamp(-LOGIT_CLAMP, LOGIT_CLAMP)
                           - scores).detach()
    probs = torch.softmax(scores, dim=-1)
    used = probs if drop is None else drop(probs)
    return _merge_heads(torch.einsum("bhij,bhjk->bhik", used, vh)), probs


def _masked(mask):
    """A dropout site of the kernels' masks: the mask multiplied in."""
    return None if mask is None else (lambda t: t * mask)


def _bernoulli(rate: float, key):
    """A dropout site of the JAX XLA layer: ``core.dropout`` of ``key``."""
    return lambda t: core.dropout(t, rate, True, key)


# ---------------------------------------------------------------------------
# deepctr InteractingLayer (AutoInt)
# ---------------------------------------------------------------------------

ATT_INIT_STD = 0.05  # both layers' N(0, 0.05) init (attention.py:73-118)


class InteractingLayer(nn.Module):
    """``wq/wk/wv`` (and with ``use_res`` ``wres``) ``[d, d]``,
    N(0, 0.05) (attention.py:73-94)."""

    def __init__(self, gen: torch.Generator, dim: int, *,
                 use_res: bool = True):
        super().__init__()
        std = ATT_INIT_STD
        self.wq = nn.Parameter(init.normal(gen, (dim, dim), std))
        self.wk = nn.Parameter(init.normal(gen, (dim, dim), std))
        self.wv = nn.Parameter(init.normal(gen, (dim, dim), std))
        self.wres = nn.Parameter(init.normal(gen, (dim, dim), std)) \
            if use_res else None

    def forward(self, x: torch.Tensor, head_num: int) -> torch.Tensor:
        out, _ = _mha(x @ self.wq, x @ self.wk, x @ self.wv, head_num,
                      scaling=False)
        if self.wres is not None:
            out = out + x @ self.wres
        return torch.relu(out)


# ---------------------------------------------------------------------------
# SelfAttention_Layer (reference submodules.py:178-238)
# ---------------------------------------------------------------------------

class SelfAttentionLayer(nn.Module):
    """``wq/wk/wv/wres`` ``[d, d]`` and the LayerNorm after the ReLU, all
    N(0, 0.05): the reference's init loop runs over the LayerNorm too
    (attention.py:96-118).  AdaSparse builds it with the JAX defaults: the
    residual, the 1/sqrt(dh) scaling and dropout 0.1."""

    DROPOUT = 0.1

    def __init__(self, gen: torch.Generator, dim: int):
        super().__init__()
        std = ATT_INIT_STD
        self.wq = nn.Parameter(init.normal(gen, (dim, dim), std))
        self.wk = nn.Parameter(init.normal(gen, (dim, dim), std))
        self.wv = nn.Parameter(init.normal(gen, (dim, dim), std))
        self.ln = core.LayerNorm(
            gen, dim, weight_init=lambda g, s: init.normal(g, s, std),
            bias_init=lambda g, s: init.normal(g, s, std))
        self.wres = nn.Parameter(init.normal(gen, (dim, dim), std))

    def forward(self, x: torch.Tensor, head_num: int, *,
                train: bool = False, key=None) -> torch.Tensor:
        """The JAX ``self_attention_apply``: ``key`` (default
        ``PRNGKey(0)``) split in two, for the probabilities and the
        output."""
        if key is None:
            key = threefry.PRNGKey(0)
        r1, r2 = threefry.split(key)
        drop = _bernoulli(self.DROPOUT, r1) if train else None
        out, _ = _mha(x @ self.wq, x @ self.wk, x @ self.wv, head_num, drop)
        out = core.dropout(out, self.DROPOUT, train, r2)
        return self.ln(torch.relu(out + x @ self.wres))


# ---------------------------------------------------------------------------
# Meta_Transformer_Layer (reference satrans.py:13-100)
# ---------------------------------------------------------------------------


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
                           masks=None, drop_rate: float = 0.0,
                           drop_key=None, residuals: dict | None = None,
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
    and gate and bilinear have none there), or ``None``.  ``drop_key``
    instead: the JAX XLA layer's dropout at ``drop_rate`` (skipped at 0),
    each site's mask ``jax.random.bernoulli`` of its quarter of
    ``split(drop_key, 4)``.  Neither: no dropout.  ``clamp``: the Pallas kernels' logit clamp (see :func:`_mha`).  A
    ``residuals`` dict receives what the stash kernel writes: ``qkv``
    ``[B, F, 3d]``, the pre-LayerNorm sums ``uq``/``uk`` (the raw
    projection where it is not transformed), the probabilities ``s``
    before dropout and the attention output ``o``."""
    if masks is not None:
        d_q, d_k, d_s, d_z = (_masked(m) for m in masks)
    elif drop_key is not None and drop_rate > 0.0:
        d_q, d_k, d_s, d_z = (_bernoulli(drop_rate, k)
                              for k in threefry.split(drop_key, 4))
    else:
        d_q = d_k = d_s = d_z = None
    q0, k0, v = x @ layer.wq, x @ layer.wk, x @ layer.wv

    def rows(params):
        return params if domain_ids is None else params[domain_ids]

    def pre_ln(t, params, drop):
        if domain_ids is None:
            return metanet.flat_sum(t, params, meta_units, drop=drop)
        return metanet.domainwise_sum(t, domain_ids, params, meta_units,
                                      dense_select=dense_select, drop=drop)

    uq, uk, q, k = q0, k0, q0, k0
    if layer.variant == "metanet":
        if "Q" in mode:
            uq = pre_ln(q0, meta_params["Q"], d_q)
            q = layer.q_meta.ln(uq)
        if "K" in mode:
            uk = pre_ln(k0, meta_params["K"], d_k)
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
    o, probs = _mha(q, k, v, head_num, d_s, clamp)
    out = o @ layer.wout                          # bias-free output linear
    if relu_out:                                  # the 'relu' flag
        out = torch.relu(out)
    if d_z is not None:
        out = d_z(out)
    if residuals is not None:
        residuals.update(qkv=torch.cat([q0, k0, v], dim=-1), uq=uq, uk=uk,
                         s=probs, o=o)
    return layer.ln(out + x)
