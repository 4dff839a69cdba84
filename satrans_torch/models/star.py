"""STAR (twin of ``satrans_tpu/models/star.py``; reference models/star.py).

* each domain's DNN layer has the effective weight ``domain_w[d] *
  shared_w`` and bias ``domain_b[d] + shared_b`` (star.py:156-169), its
  output head likewise (star.py:167-169);
* the partitioned BatchNorm (``MDR_BatchNorm``, submodules.py:107-175):
  each domain keeps its running statistics (``bn.<d>.mean``, ``var``,
  ``count``, buffers) and normalizes with the affine ``bn_scale[d] *
  shared_bn_scale``, ``bn_bias[d] + shared_bn_bias``; in training each
  domain's moments are taken over its own examples;
* no linear model (the reference's forward starts from logit 0);
* ``usetrans``: a stack of self-attention layers before the DNN.

The routing is the JAX package's: the domain weights are stacked ``[D,
in, out]``, every example goes through all D branches as batched GEMMs,
and the one-hot of ``id - domain_id_offset`` selects its branch.  A row
whose id lies outside the D domains (a pad row of a tail batch, id 0) has
a zero one-hot row: it enters no domain's moments, and its logit is 0.
On the card these are ``torch`` GEMMs, as the JAX package computes them
with XLA; the training step's bank kernels K2-K5 are what runs by hand.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..features import FeatureLayout
from ..nn import core, initializers as init
from ..ops import threefry
from .common import DomainBase


class StarNet(DomainBase):
    def __init__(self, layout: FeatureLayout, *, num_domains: int = 3,
                 dnn_hidden_units: Sequence[int] = (256, 128),
                 use_domain_dnn: bool = True, use_domain_bn: bool = True,
                 **kw):
        super().__init__(layout, **kw)
        gen = self._take_generator()
        self.num_domains = D = num_domains
        self.use_domain_dnn = use_domain_dnn
        self.use_domain_bn = use_domain_dnn and use_domain_bn
        dims = [self.input_dim] + list(dnn_hidden_units)
        if not use_domain_dnn:
            self.dnn = self._mlp(gen, self.input_dim, dims[1:])
            self.dnn_out = core.Linear(gen, dims[-1], 1, use_bias=False)
            return
        width = self.input_dim
        self.shared_bn_scale = nn.Parameter(init.ones(gen, (width,)))
        self.shared_bn_bias = nn.Parameter(init.zeros(gen, (width,)))
        if self.use_domain_bn:
            self.bn_scale = nn.Parameter(init.ones(gen, (D, width)))
            self.bn_bias = nn.Parameter(init.zeros(gen, (D, width)))
            self.bn = nn.ModuleList(core.BatchNorm(width, gen.device)
                                    for _ in range(D))
        # each layer's weights N(0, init_std) and biases as nn.Linear's,
        # the domains' stacked [D, in, out] and [D, out]
        layers = range(len(dims) - 1)
        self.domain_w = nn.ParameterList(
            init.normal(gen, (D, dims[i], dims[i + 1]), self.init_std)
            for i in layers)
        self.domain_b = nn.ParameterList(
            init.torch_linear_bias(gen, (D, dims[i + 1]), dims[i])
            for i in layers)
        self.shared_w = nn.ParameterList(
            init.normal(gen, (dims[i], dims[i + 1]), self.init_std)
            for i in layers)
        self.shared_b = nn.ParameterList(
            init.torch_linear_bias(gen, (dims[i + 1],), dims[i])
            for i in layers)
        self.domain_out_w = nn.Parameter(torch.stack([
            init.torch_linear_weight(gen, (dims[-1], 1)) for _ in range(D)]))
        self.domain_out_b = nn.Parameter(
            init.torch_linear_bias(gen, (D, 1), dims[-1]))
        self.shared_out_w = nn.Parameter(init.torch_linear_weight(
            gen, (dims[-1], 1)))
        self.shared_out_b = nn.Parameter(init.torch_linear_bias(
            gen, (1,), dims[-1]))

    def forward(self, batch, feed=None, key=None):
        train, key = self._train_key(key)
        h = self._dnn_input(batch, feed, train=train, key=key)
        if not self.use_domain_dnn:
            out = self.dnn(h, dropout_rate=self.dnn_dropout, train=train,
                           key=key)
            return core.prediction(self.dnn_out(out), self.task)[:, 0]

        ids = batch["sparse"][:, self.layout.sparse_index(self.domain_col)]
        onehot = core.one_hot(ids - self.domain_id_offset, self.num_domains,
                              h.dtype)                           # [B, D]
        if self.use_domain_bn:
            ys = [bn(h, self.bn_scale[d] * self.shared_bn_scale,
                     self.bn_bias[d] + self.shared_bn_bias, train=train,
                     batch_weight=onehot[:, d] if train else None)
                  for d, bn in enumerate(self.bn)]
            h = torch.einsum("dbi,bd->bi", torch.stack(ys), onehot)
        for i, (dw, db) in enumerate(zip(self.domain_w, self.domain_b)):
            w_eff = dw * self.shared_w[i][None]                  # [D, in, out]
            b_eff = db + self.shared_b[i][None]                  # [D, out]
            hd = torch.relu(torch.einsum("bi,dio->bdo", h, w_eff)
                            + b_eff[None])
            h = torch.einsum("bdo,bd->bo", hd, onehot)
            h = core.dropout(h, self.dnn_dropout, train,
                             threefry.fold_in(key, i))
        w_out = self.domain_out_w * self.shared_out_w[None]      # [D, hid, 1]
        b_out = self.domain_out_b + self.shared_out_b[None]      # [D, 1]
        logit_d = torch.einsum("bi,dio->bdo", h, w_out) + b_out[None]
        logit = torch.einsum("bdo,bd->bo", logit_d, onehot)
        return core.prediction(logit, self.task)[:, 0]
