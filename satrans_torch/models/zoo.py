"""The single-task baseline zoo (twin of ``satrans_tpu/models/zoo.py``):
WDL, DeepFM, DCN, xDeepFM, NFM, AFM, PNN, AutoInt, FiBiNET, AdaSparse.

Each mirrors its reference counterpart (models/<name>.py) with the
reference's quirks that change behaviour:

* WDL's linear term is commented out upstream (wdl.py:69-70): DNN only.
* AutoInt and PNN use no linear logit (autoint.py:93, pnn.py:286); AutoInt
  still builds the linear model, whose L2 is in its ``reg_loss``.
* DeepFM honours the ``nofm`` / ``nodnn`` ablation flags (deepfm.py:95,
  100) and the ``metatrans`` hook (deepfm.py:91-93); AutoInt's hook is
  ``usemetatrans``.
* AdaSparse prunes each DNN layer with ``pi = beta * sigmoid(alpha *
  W_p [x; dom])``, zeroed where ``|pi| <= epsilon`` (adasparse.py:88-106),
  and reads the scenario embedding from the bank with a second lookup, so
  it has no ``standard_bank_access``; ``usetrans`` puts self-attention
  layers before its DNN.

``forward(batch, feed=None, key=None)`` returns the predictions ``[B]``;
in training mode every dropout is the JAX model's, drawn from the
threefry ``key`` as its ``apply`` draws from ``rng``: the DNN layer ``i``
from ``fold_in(key, i)``, the metatrans hook, NFM's pooling and AFM's
attention from ``key`` itself, AdaSparse's attention layer ``i`` from
``fold_in(key, 100 + i)``.  The zoo's interaction layers are plain
PyTorch (``nn/interactions.py``); on the card the training step's bank
kernels K2-K5 (``train/bank_optimizer.py``) are what runs by hand.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .. import embeddings
from ..nn import attention, core, initializers as init, interactions
from ..ops import threefry
from .common import ZooBase


def _l2(l2: float, *weights) -> torch.Tensor | float:
    """``l2 * sum(w**2)`` over ``weights``, 0 when ``l2`` is not positive."""
    if l2 <= 0.0:
        return 0.0
    return l2 * sum(torch.sum(torch.square(w)) for w in weights)


class _DNNModel(ZooBase):
    """The DNN tower and its head: ``dnn`` over ``dnn_in`` and ``dnn_out``
    from its last width (the models whose head reads the tower only)."""

    def _dnn_l2(self):
        return _l2(self.l2_reg_dnn, *(l.w for l in self.dnn.layers),
                   self.dnn_out.w)

    def _tower(self, h, train, key):
        return self.dnn_out(self.dnn(h, dropout_rate=self.dnn_dropout,
                                     train=train, key=key))


# ---------------------------------------------------------------------------
# WDL (reference wdl.py)
# ---------------------------------------------------------------------------

class WDL(_DNNModel):
    def __init__(self, layout, *, dnn_hidden_units: Sequence[int] = (256, 128),
                 dnn_dropout: float = 0.0, l2_reg_dnn: float = 0.0, **kw):
        super().__init__(layout, **kw)
        gen = self._take_generator()
        self.dnn_dropout, self.l2_reg_dnn = dnn_dropout, l2_reg_dnn
        self.dnn = self._mlp(gen, layout.input_dim, dnn_hidden_units)
        self.dnn_out = self._head(gen, dnn_hidden_units[-1])

    def forward(self, batch, feed=None, key=None):
        train, key = self._train_key(key)
        x = self._embed(batch, feed, train=train, key=key)
        # the linear logit left out, as the reference (wdl.py:69-70)
        return self._prediction(self._tower(self._dnn_input(x, batch),
                                            train, key))

    def reg_loss(self, feed=None):
        return self._base_reg(feed) + self._dnn_l2()


# ---------------------------------------------------------------------------
# DeepFM (reference deepfm.py)
# ---------------------------------------------------------------------------

class DeepFM(_DNNModel):
    meta_flags = ("metatrans",)

    def __init__(self, layout, *, dnn_hidden_units: Sequence[int] = (256, 128),
                 dnn_dropout: float = 0.0, l2_reg_dnn: float = 0.0,
                 use_fm: bool = True, **kw):
        super().__init__(layout, **kw)
        gen = self._take_generator()
        self.dnn_dropout, self.l2_reg_dnn = dnn_dropout, l2_reg_dnn
        self.use_fm = use_fm and "nofm" not in self.flag
        self.use_dnn = "nodnn" not in self.flag
        self.dnn = self._mlp(gen, layout.input_dim, dnn_hidden_units)
        self.dnn_out = self._head(gen, dnn_hidden_units[-1])

    def forward(self, batch, feed=None, key=None):
        train, key = self._train_key(key)
        x = self._embed(batch, feed, train=train, key=key)
        logit = self.linear(self.layout, batch)
        if self.use_fm:
            logit = logit + interactions.fm(x)
        if self.use_dnn:
            logit = logit + self._tower(self._dnn_input(x, batch), train, key)
        return self._prediction(logit)

    def reg_loss(self, feed=None):
        return self._base_reg(feed) + self._dnn_l2()


# ---------------------------------------------------------------------------
# DCN (reference dcn.py)
# ---------------------------------------------------------------------------

class DCN(ZooBase):
    meta_flags = ("metatrans",)

    def __init__(self, layout, *, cross_num: int = 2,
                 cross_parameterization: str = "vector",
                 dnn_hidden_units: Sequence[int] = (128, 128),
                 dnn_dropout: float = 0.0, l2_reg_dnn: float = 0.0,
                 l2_reg_cross: float = 1e-5, **kw):
        super().__init__(layout, **kw)
        gen = self._take_generator()
        self.cross_num = cross_num
        self.dnn_hidden_units = tuple(dnn_hidden_units)
        self.dnn_dropout, self.l2_reg_dnn = dnn_dropout, l2_reg_dnn
        self.l2_reg_cross = l2_reg_cross
        in_dim = layout.input_dim
        self.dnn = self._mlp(gen, in_dim, dnn_hidden_units)
        self.cross = interactions.CrossNet(gen, in_dim, cross_num,
                                           cross_parameterization)
        last = dnn_hidden_units[-1] if dnn_hidden_units else in_dim
        head_in = in_dim + last if dnn_hidden_units and cross_num > 0 \
            else last
        self.dnn_out = self._head(gen, head_in)

    def forward(self, batch, feed=None, key=None):
        train, key = self._train_key(key)
        logit = self.linear(self.layout, batch)
        x = self._embed(batch, feed, train=train, key=key)
        dnn_in = self._dnn_input(x, batch)
        parts = []
        if self.cross_num > 0:
            parts.append(self.cross(dnn_in))
        if self.dnn_hidden_units:
            parts.insert(0, self.dnn(dnn_in, dropout_rate=self.dnn_dropout,
                                     train=train, key=key))
        # the reference stacks (cross_out, deep_out) (dcn.py forward)
        stack = torch.cat(parts[::-1], dim=-1) if len(parts) > 1 \
            else parts[0]
        return self._prediction(logit + self.dnn_out(stack))

    def reg_loss(self, feed=None):
        # dnn_linear's weight is registered with l2_reg_linear upstream
        return (self._base_reg(feed)
                + _l2(self.l2_reg_cross, self.cross.kernels)
                + _l2(self.l2_reg_dnn, *(l.w for l in self.dnn.layers))
                + _l2(self.l2_reg_linear, self.dnn_out.w))


# ---------------------------------------------------------------------------
# xDeepFM (reference xdeepfm.py)
# ---------------------------------------------------------------------------

class XDeepFM(ZooBase):
    meta_flags = ("metatrans",)

    def __init__(self, layout, *, dnn_hidden_units: Sequence[int] = (256, 256),
                 cin_layer_size: Sequence[int] = (256, 128),
                 cin_split_half: bool = True, cin_activation: str = "relu",
                 dnn_dropout: float = 0.0, l2_reg_dnn: float = 0.0,
                 l2_reg_cin: float = 0.0, **kw):
        super().__init__(layout, **kw)
        gen = self._take_generator()
        self.dnn_dropout, self.l2_reg_dnn = dnn_dropout, l2_reg_dnn
        self.l2_reg_cin = l2_reg_cin
        self.dnn = self.dnn_out = self.cin = self.cin_out = None
        if dnn_hidden_units:
            self.dnn = self._mlp(gen, layout.input_dim, dnn_hidden_units)
            self.dnn_out = self._head(gen, dnn_hidden_units[-1])
        if cin_layer_size:
            self.cin = interactions.CIN(gen, layout.num_fields,
                                        cin_layer_size, cin_split_half,
                                        cin_activation)
            self.cin_out = self._head(gen, interactions.cin_output_dim(
                cin_layer_size, cin_split_half))

    def forward(self, batch, feed=None, key=None):
        train, key = self._train_key(key)
        x = self._embed(batch, feed, train=train, key=key)
        logit = self.linear(self.layout, batch)
        if self.cin is not None:
            logit = logit + self.cin_out(self.cin(x))
        if self.dnn is not None:
            h = self.dnn(self._dnn_input(x, batch),
                         dropout_rate=self.dnn_dropout, train=train, key=key)
            logit = logit + self.dnn_out(h)
        return self._prediction(logit)

    def reg_loss(self, feed=None):
        loss = self._base_reg(feed)
        if self.dnn is not None:
            loss = loss + _l2(self.l2_reg_dnn,
                              *(l.w for l in self.dnn.layers),
                              self.dnn_out.w)
        if self.cin is not None:
            loss = loss + _l2(self.l2_reg_cin,
                              *(c.w for c in self.cin.convs))
        return loss


# ---------------------------------------------------------------------------
# NFM (reference nfm.py)
# ---------------------------------------------------------------------------

class NFM(_DNNModel):
    meta_flags = ("metatrans",)

    def __init__(self, layout, *, dnn_hidden_units: Sequence[int] = (128, 128),
                 dnn_dropout: float = 0.0, bi_dropout: float = 0.0,
                 l2_reg_dnn: float = 0.0, **kw):
        super().__init__(layout, **kw)
        gen = self._take_generator()
        self.dnn_dropout, self.bi_dropout = dnn_dropout, bi_dropout
        self.dnn = self._mlp(gen, layout.dense_dim + layout.embedding_dim,
                             dnn_hidden_units)
        self.dnn_out = self._head(gen, dnn_hidden_units[-1])

    def forward(self, batch, feed=None, key=None):
        train, key = self._train_key(key)
        x = self._embed(batch, feed, train=train, key=key)
        logit = self.linear(self.layout, batch)
        bi = interactions.bi_interaction_pooling(x)           # [B, 1, d]
        if self.bi_dropout > 0 and train:
            bi = core.dropout(bi, self.bi_dropout, train, key)
        return self._prediction(
            logit + self._tower(self._dnn_input(bi, batch), train, key))


# ---------------------------------------------------------------------------
# AFM (reference afm.py)
# ---------------------------------------------------------------------------

class AFM(ZooBase):
    meta_flags = ("metatrans",)

    def __init__(self, layout, *, use_attention: bool = True,
                 attention_factor: int = 8, l2_reg_att: float = 1e-5,
                 afm_dropout: float = 0.0, **kw):
        super().__init__(layout, **kw)
        gen = self._take_generator()
        self.l2_reg_att, self.afm_dropout = l2_reg_att, afm_dropout
        self.afm = interactions.AFMLayer(gen, layout.embedding_dim,
                                         attention_factor) \
            if use_attention else None

    def forward(self, batch, feed=None, key=None):
        train, key = self._train_key(key)
        x = self._embed(batch, feed, train=train, key=key)
        logit = self.linear(self.layout, batch)
        if self.afm is not None:
            logit = logit + self.afm(x, dropout_rate=self.afm_dropout,
                                     train=train, key=key)
        else:
            logit = logit + interactions.fm(x)
        return self._prediction(logit)

    def reg_loss(self, feed=None):
        loss = self._base_reg(feed)
        if self.afm is not None:
            loss = loss + _l2(self.l2_reg_att, self.afm.att_w)
        return loss


# ---------------------------------------------------------------------------
# PNN (reference pnn.py): no linear model
# ---------------------------------------------------------------------------

class PNN(_DNNModel):
    meta_flags = ("metatrans",)

    def __init__(self, layout, *, dnn_hidden_units: Sequence[int] = (128, 128),
                 dnn_dropout: float = 0.0, use_inner: bool = True,
                 use_outter: bool = False, kernel_type: str = "mat",
                 l2_reg_dnn: float = 0.0, **kw):
        super().__init__(layout, use_linear=False, **kw)
        gen = self._take_generator()
        self.dnn_dropout = dnn_dropout
        self.use_inner = use_inner
        f = layout.num_fields
        pairs = f * (f - 1) // 2
        product_dim = pairs * (int(use_inner) + int(use_outter))
        self.outer = interactions.OuterProduct(
            gen, f, layout.embedding_dim, kernel_type) if use_outter else None
        self.dnn = self._mlp(gen, product_dim + layout.input_dim,
                             dnn_hidden_units)
        self.dnn_out = self._head(gen, dnn_hidden_units[-1])

    def forward(self, batch, feed=None, key=None):
        train, key = self._train_key(key)
        x = self._embed(batch, feed, train=train, key=key)
        parts = [x.reshape(x.shape[0], -1)]
        if self.use_inner:
            parts.append(interactions.inner_product(x))
        if self.outer is not None:
            parts.append(self.outer(x))
        product = torch.cat(parts, dim=1)
        return self._prediction(self._tower(self._dnn_input(product, batch),
                                            train, key))

    def reg_loss(self, feed=None):
        return embeddings.l2_loss(self.emb if feed is None else feed,
                                  self.l2_reg_embedding)


# ---------------------------------------------------------------------------
# AutoInt (reference autoint.py): deepctr InteractingLayer stack
# ---------------------------------------------------------------------------

class AutoInt(ZooBase):
    meta_flags = ("usemetatrans",)

    def __init__(self, layout, *, att_layer_num: int = 3,
                 att_head_num: int = 2, att_res: bool = True,
                 dnn_hidden_units: Sequence[int] = (256, 128),
                 dnn_dropout: float = 0.0, l2_reg_dnn: float = 0.0, **kw):
        # the linear model is built but not used (autoint.py:93)
        super().__init__(layout, **kw)
        gen = self._take_generator()
        d, f = layout.embedding_dim, layout.num_fields
        self.att_layer_num, self.att_head_num = att_layer_num, att_head_num
        self.dnn_dropout, self.l2_reg_dnn = dnn_dropout, l2_reg_dnn
        self.int_layers = nn.ModuleList(
            attention.InteractingLayer(gen, d, use_res=att_res)
            for _ in range(att_layer_num))
        self.dnn = self._mlp(gen, layout.input_dim, dnn_hidden_units) \
            if dnn_hidden_units else None
        if dnn_hidden_units and att_layer_num > 0:
            head_in = dnn_hidden_units[-1] + f * d
        elif dnn_hidden_units:
            head_in = dnn_hidden_units[-1]
        else:
            head_in = f * d
        self.dnn_out = self._head(gen, head_in)

    def forward(self, batch, feed=None, key=None):
        train, key = self._train_key(key)
        x = self._embed(batch, feed, train=train, key=key)
        att = x
        for layer in self.int_layers:
            att = layer(att, self.att_head_num)
        parts = []
        if self.att_layer_num > 0:
            parts.append(att.reshape(att.shape[0], -1))
        if self.dnn is not None:
            parts.append(self.dnn(self._dnn_input(x, batch),
                                  dropout_rate=self.dnn_dropout, train=train,
                                  key=key))
        stack = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
        return self._prediction(self.dnn_out(stack))

    def reg_loss(self, feed=None):
        loss = self._base_reg(feed)
        if self.dnn is not None:
            loss = loss + _l2(self.l2_reg_dnn,
                              *(l.w for l in self.dnn.layers))
        return loss


# ---------------------------------------------------------------------------
# FiBiNET (reference fibinet.py)
# ---------------------------------------------------------------------------

class FiBiNET(_DNNModel):
    meta_flags = ("metatrans",)

    def __init__(self, layout, *, bilinear_type: str = "interaction",
                 reduction_ratio: int = 3,
                 dnn_hidden_units: Sequence[int] = (128, 128),
                 dnn_dropout: float = 0.0, **kw):
        super().__init__(layout, **kw)
        gen = self._take_generator()
        f, d = layout.num_fields, layout.embedding_dim
        self.dnn_dropout = dnn_dropout
        self.senet = interactions.SENET(gen, f, reduction_ratio)
        self.bilinear = interactions.Bilinear(gen, f, d, bilinear_type)
        # two bilinear outputs of F * (F - 1) / 2 rows, then the dense
        # columns (reference fibinet.py:58-76)
        self.dnn = self._mlp(gen, f * (f - 1) * d + layout.dense_dim,
                             dnn_hidden_units)
        self.dnn_out = self._head(gen, dnn_hidden_units[-1])

    def forward(self, batch, feed=None, key=None):
        train, key = self._train_key(key)
        x = self._embed(batch, feed, train=train, key=key)
        logit = self.linear(self.layout, batch)
        both = torch.cat([self.bilinear(self.senet(x)), self.bilinear(x)],
                         dim=1)
        return self._prediction(
            logit + self._tower(self._dnn_input(both, batch), train, key))


# ---------------------------------------------------------------------------
# AdaSparse (reference adasparse.py)
# ---------------------------------------------------------------------------

class AdaSparse(ZooBase):
    # the scenario embedding is a second lookup_field on the bank (see
    # forward), so the one-embed_fields gather plan does not hold
    standard_bank_access = False
    meta_flags = ()

    def __init__(self, layout, *, dnn_hidden_units: Sequence[int] = (256, 128),
                 dnn_dropout: float = 0.0, domain_emb_dim: int | None = None,
                 beta: float = 2.0, epsilon: float = 0.25, alpha: float = 1.0,
                 att_layer_num: int = 3, **kw):
        # no meta module: AdaSparse reads the scenario's own field embedding
        num_domains = kw.pop("num_domains", None)
        super().__init__(layout, **kw)
        gen = self._take_generator()
        if "noembinit" in self.flag:
            # AdaSparse draws N(0, init_std) whatever the flag (JAX
            # satrans_tpu/models/zoo.py:540)
            self.emb = embeddings.bank_init(gen, layout,
                                            init_std=self.init_std)
        self.num_domains = num_domains
        self.use_trans = "usetrans" in self.flag
        self.dnn_dropout = dnn_dropout
        self.beta, self.epsilon, self.alpha = beta, epsilon, alpha
        d = layout.embedding_dim
        self.int_layers = nn.ModuleList(
            attention.SelfAttentionLayer(gen, d)
            for _ in range(att_layer_num)) if self.use_trans else None
        # the reference hardcodes domain_emb_dim=32 where the embedding
        # it concatenates is embedding_dim wide (adasparse.py:54, 69, 94,
        # 167): None follows embedding_dim
        dom_dim = d if domain_emb_dim is None else domain_emb_dim
        dims = [layout.input_dim] + list(dnn_hidden_units)
        self.dnn_layers = nn.ModuleList(
            core.Linear(gen, dims[i], dims[i + 1],
                        weight_init=lambda g, s: init.normal(g, s,
                                                             self.init_std))
            for i in range(len(dims) - 1))
        self.pruners = nn.ModuleList(
            core.Linear(gen, dims[i] + dom_dim, dims[i + 1])
            for i in range(len(dims) - 1))
        self.dnn_out = self._head(gen, dnn_hidden_units[-1])

    def forward(self, batch, feed=None, key=None):
        train, key = self._train_key(key)
        x = embeddings.embed_fields(self.emb, self.layout, batch)
        # the scenario embedding is the scenario field's own bank row
        # (reference adasparse.py:641-642)
        ids = batch["sparse"][:, self.layout.sparse_index(self.domain_col)]
        dom_emb = embeddings.lookup_field(self.emb, self.layout,
                                          self.domain_col, ids)
        if self.use_trans:
            for i, layer in enumerate(self.int_layers):
                x = layer(x, 4, train=train,
                          key=threefry.fold_in(key, 100 + i))
        h = self._dnn_input(x, batch)
        for i, (layer, pruner) in enumerate(zip(self.dnn_layers,
                                                self.pruners)):
            pi = self.beta * torch.sigmoid(
                self.alpha * pruner(torch.cat([h, dom_emb], dim=1)))
            pi = torch.where(pi.abs() <= self.epsilon, 0.0, pi)
            h = core.dropout(torch.relu(layer(h) * pi), self.dnn_dropout,
                             train, threefry.fold_in(key, i))
        return self._prediction(self.dnn_out(h))
