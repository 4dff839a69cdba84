"""The legacy Star-Trans models (twin of
``satrans_tpu/models/star_trans_legacy.py``; reference models/star_trans.py),
the design path from STAR to SATrans:

* :class:`StarTrans` (star_trans.py:674-775): per-domain W_Query
  attention (:class:`MDRInteracting`) with ``merge`` in {no, sum, dot}
  against a shared W_Query, per-domain LayerNorm affines, after an
  optional plain attention stack (``att_layer_type`` 'deepctr', the
  ``SelfAttentionLayer``, or 'trans', :class:`TransformerLayer`);
* :class:`Starv2Trans` (star_trans.py:779-908): queries mixed from
  ``num_query_bases`` base projections by a softmax scenario DNN
  (:class:`MDRInteractingV2`), and the attention-regularization aux loss
  (:func:`attn_regularization_loss`) scaled by ``attn_batch_reg`` times
  the real examples of the batch;
* :class:`Starv3Trans` (star_trans.py:912-1089): meta-transformer layers
  with a MetaNet ``[d, 2d, d]`` whose weights the scenario encoder makes
  from the ``D + 1`` rows of ``domain_emb`` (flags ``layerid``,
  ``qkvid``, ``cat``, ``large``, ``norelu``);
* :class:`Starv4Trans` (star_trans.py:1092-1248): two encoders, of which
  only ``encoders[1]`` is applied, as in the JAX package; under
  ``aggmap`` each example's MetaNet comes from its scenario embedding
  and the detached mean of its field embeddings, per-example ``[B, P]``
  tables on the plain meta layer.

Per-domain routing is the JAX package's: stacked ``[D, ...]`` weights
selected by the one-hot of ``id - domain_id_offset`` (a pad row, id 0,
gets a zero row), the meta tables gathered by the raw id as JAX indexing
gathers (a negative id counts from the end, every id clamped into the
table).  Without ``domain_id_as_feature`` the scenario column is left out
of the attention fields.  Dropout is the JAX package's at rate 0.1 in
every layer: ``jax.random.bernoulli`` masks (``ops/threefry.py``) from
the key chains of its ``apply``: ``fold_in(key, i)`` a layer (StarTrans's
domain layers ``fold_in(key, 100 + i)``), split in two or three inside
the layer.  These layers are XLA computations in the JAX package, not
Pallas kernels: their plain PyTorch versions are their counterparts, with
no logit clamp.  The bank is read through one ``embed_fields`` call a
forward, so the sparse bank updates (and their kernels K2-K5) apply.

``forward(batch, feed=None, key=None, return_aux=False)`` returns the
predictions, or with ``return_aux`` ``(pred, aux)``: the aux loss the
Trainer adds to the differentiated total (Starv2's; 0 for the others).
"""

from __future__ import annotations

import torch
from torch import nn

from .. import embeddings
from ..features import FeatureLayout
from ..nn import attention, core, initializers as init, metanet
from ..ops import segment, threefry
from .common import BankModel

DROPOUT = 0.1   # every layer's rate: the JAX layers' default dropout_rate
LN_EPS = 1e-6   # the per-domain LayerNorm's eps (star_trans_legacy.py:124)


def _drop(train: bool, key):
    """A dropout site of ``_mha`` at DROPOUT, or None out of training."""
    return (lambda t: core.dropout(t, DROPOUT, True, key)) if train else None


def _normal(std: float):
    return lambda g, s: init.normal(g, s, std)


def _domain_norm(out, onehot, scale, bias):
    """LayerNorm (eps 1e-6) with each example's domain's affine, picked
    by the one-hot (``[D, d]`` -> ``[B, 1, d]``)."""
    return core.layer_norm(out, (onehot @ scale)[:, None, :],
                           (onehot @ bias)[:, None, :], eps=LN_EPS)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

class _TransformerTail(nn.Module):
    """The output linear, residual and LayerNorm, then the FFN ``d -> 2d
    -> d`` with its residual and LayerNorm (Transformer_Layer,
    star_trans.py:449-508): ``wout`` and ``ln`` N(0, 0.05), the FFN's
    linears torch's default, ``ffn_ln`` ones and zeros."""

    def _init_tail(self, gen, dim: int, std: float):
        self.wout = nn.Parameter(init.normal(gen, (dim, dim), std))
        self.ln = core.LayerNorm(gen, dim, weight_init=_normal(std),
                                 bias_init=_normal(std))
        self.ffn1 = core.Linear(gen, dim, 2 * dim)
        self.ffn2 = core.Linear(gen, 2 * dim, dim)
        self.ffn_ln = core.LayerNorm(gen, dim)

    def _tail(self, out, x, train, r2, r3):
        out = self.ln(core.dropout(out @ self.wout, DROPOUT, train, r2) + x)
        h = torch.relu(self.ffn1(out))
        h = core.dropout(self.ffn2(h), DROPOUT, train, r3)
        return self.ffn_ln(h + out)


class TransformerLayer(_TransformerTail):
    """``transformer_layer`` (star_trans_legacy.py:51-83): attention over
    the fields, then :class:`_TransformerTail`; its key split three ways
    (probabilities, output, FFN)."""

    def __init__(self, gen: torch.Generator, dim: int, std: float = 0.05):
        super().__init__()
        self.wq = nn.Parameter(init.normal(gen, (dim, dim), std))
        self.wk = nn.Parameter(init.normal(gen, (dim, dim), std))
        self.wv = nn.Parameter(init.normal(gen, (dim, dim), std))
        self._init_tail(gen, dim, std)

    def forward(self, x, head_num: int, *, train: bool = False, key=None):
        r1, r2, r3 = threefry.split(
            threefry.PRNGKey(0) if key is None else key, 3)
        out, _ = attention._mha(x @ self.wq, x @ self.wk, x @ self.wv,
                                head_num, _drop(train, r1))
        return self._tail(out, x, train, r2, r3)


class MDRInteracting(nn.Module):
    """``mdr_interacting`` (MDR_InteractingLayer, star_trans.py:146-242):
    the query projection of each example's domain (``wq_domain``, merged
    with ``wq_shared`` by ``merge``), shared K/V, the ``wres`` residual, a
    ReLU and the per-domain LayerNorm affine; its key split in two
    (probabilities, output)."""

    MERGES = ("no", "sum", "dot")

    def __init__(self, gen: torch.Generator, dim: int, num_domains: int,
                 std: float = 0.05):
        super().__init__()
        self.wq_shared = nn.Parameter(init.normal(gen, (dim, dim), std))
        self.wq_domain = nn.Parameter(init.normal(
            gen, (num_domains, dim, dim), std))
        self.wk = nn.Parameter(init.normal(gen, (dim, dim), std))
        self.wv = nn.Parameter(init.normal(gen, (dim, dim), std))
        self.wres = nn.Parameter(init.normal(gen, (dim, dim), std))
        self.ln_scale = nn.Parameter(init.normal(gen, (num_domains, dim),
                                                 std))
        self.ln_bias = nn.Parameter(init.normal(gen, (num_domains, dim),
                                                std))

    def forward(self, x, onehot, head_num: int, *, merge: str = "no",
                train: bool = False, key=None):
        r1, r2 = threefry.split(threefry.PRNGKey(0) if key is None else key)
        if merge == "sum":
            wq = self.wq_domain + self.wq_shared[None]
        elif merge == "dot":
            wq = self.wq_domain * self.wq_shared[None]
        else:
            wq = self.wq_domain
        q = torch.einsum("bfd,bde->bfe", x,
                         torch.einsum("bD,Dde->bde", onehot, wq))
        out, _ = attention._mha(q, x @ self.wk, x @ self.wv, head_num,
                                _drop(train, r1))
        out = torch.relu(core.dropout(out, DROPOUT, train, r2)
                         + x @ self.wres)
        return _domain_norm(out, onehot, self.ln_scale, self.ln_bias)


class MDRInteractingV2(_TransformerTail):
    """``mdr_interacting_v2`` (MDR_InteractingLayer_v2 and, ``with_ffn``,
    MDR_Transformer_layer; star_trans.py:245-332, 511-596): each
    example's query projection is the mixture ``query_weights [B, n]`` of
    the base projections ``wq_bases [n, d, d]``; then the ``wres``
    residual, a ReLU and the per-domain LayerNorm affine, or with
    ``with_ffn`` :class:`_TransformerTail`.  Its key splits three ways."""

    def __init__(self, gen: torch.Generator, dim: int, num_domains: int,
                 num_query_bases: int, std: float = 0.05, *,
                 with_ffn: bool = False):
        super().__init__()
        self.with_ffn = with_ffn
        self.wq_bases = nn.Parameter(init.normal(
            gen, (num_query_bases, dim, dim), std))
        self.wk = nn.Parameter(init.normal(gen, (dim, dim), std))
        self.wv = nn.Parameter(init.normal(gen, (dim, dim), std))
        self.wres = nn.Parameter(init.normal(gen, (dim, dim), std))
        if with_ffn:
            self._init_tail(gen, dim, std)
        else:
            self.ln_scale = nn.Parameter(init.normal(
                gen, (num_domains, dim), std))
            self.ln_bias = nn.Parameter(init.normal(
                gen, (num_domains, dim), std))

    def forward(self, x, onehot, query_weights, head_num: int, *,
                train: bool = False, key=None):
        r1, r2, r3 = threefry.split(
            threefry.PRNGKey(0) if key is None else key, 3)
        wq = torch.einsum("bn,nde->bde", query_weights, self.wq_bases)
        q = torch.einsum("bfd,bde->bfe", x, wq)
        out, _ = attention._mha(q, x @ self.wk, x @ self.wv, head_num,
                                _drop(train, r1))
        if self.with_ffn:
            return self._tail(out, x, train, r2, r3)
        out = torch.relu(core.dropout(out, DROPOUT, train, r2)
                         + x @ self.wres)
        return _domain_norm(out, onehot, self.ln_scale, self.ln_bias)


def attn_regularization_loss(query_weights, domain_ids, num_domains: int):
    """Starv2's aux loss (star_trans.py:849-852): each domain's mean
    mixture weights (ids 1..D; row 0 and ids past D dropped), their
    unbiased variance across domains, ``std = 1 - sqrt(var + 1e-4)``, and
    ``(std + |std|).sum() / (2 n)``."""
    per_domain = segment.segment_mean(query_weights, domain_ids,
                                      num_domains + 1)[1:]
    var = torch.var(per_domain, dim=0, correction=1)
    std = 1.0 - torch.sqrt(var + 1e-4)
    return torch.sum(std + torch.abs(std)) / (2 * query_weights.shape[-1])


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

class _LegacyBase(BankModel):
    """What the four models share (``_LegacyBase``, star_trans_legacy.py:
    214-298): the bank, the linear model, the head (one linear, or with
    ``use_domain_dnn_linear`` one a domain picked by the one-hot), the
    attention fields without the scenario column (unless
    ``domain_id_as_feature``), the bank's L2 and the ``domain_id_offset``
    (raw scenario id of domain 0, 1 until set) that the Trainer learns
    from the data.  A subclass draws its layers from the generator that
    :meth:`_take_generator` hands over."""

    has_aux = True
    num_tasks = 1

    def __init__(self, layout: FeatureLayout, *, domain_col: str = "",
                 num_domains: int = 3, domain_id_as_feature: bool = False,
                 att_layer_num: int = 2, domain_att_layer_num: int = 1,
                 att_head_num: int = 2, att_layer_type: str = "deepctr",
                 use_domain_dnn_linear: bool = False, use_linear: bool = True,
                 flag: str = "", seed: int = 1024, task: str = "binary",
                 init_std: float = 1e-4, l2_reg_embedding: float = 1e-5,
                 domain_id_offset: int = 1, device="cuda"):
        super().__init__(layout, domain_col=domain_col, flag=flag, seed=seed,
                         emb_init_std=init_std, device=device)
        gen = self._gen
        self.init_std = init_std
        self.domain_cols = [domain_col]
        self.num_domains = num_domains
        self.domain_id_as_feature = domain_id_as_feature
        self.att_layer_num = att_layer_num
        self.domain_att_layer_num = domain_att_layer_num
        self.att_head_num = att_head_num
        self.att_layer_type = att_layer_type
        self.use_domain_dnn_linear = use_domain_dnn_linear
        self.task = task
        self.l2_reg_embedding = float(l2_reg_embedding)
        self.domain_id_offset = int(domain_id_offset)
        self.active_fields = [
            i for i, name in enumerate(layout.sparse_names
                                       + layout.varlen_names)
            if domain_id_as_feature or name != domain_col]
        # the fields' places on the model's device (no state_dict entry)
        self.register_buffer("_active", torch.tensor(
            self.active_fields, dtype=torch.long, device=gen.device),
            persistent=False)
        self.head_in = (len(self.active_fields) * self.embedding_dim
                        + layout.dense_dim)
        self.linear = embeddings.LinearModel(gen, layout, init_std=init_std) \
            if use_linear else None
        if use_domain_dnn_linear:
            self.head_w = nn.Parameter(torch.stack([
                init.torch_linear_weight(gen, (self.head_in, 1))
                for _ in range(num_domains)]))
            self.head_b = nn.Parameter(init.torch_linear_bias(
                gen, (num_domains, 1), self.head_in))
        else:
            self.head = core.Linear(gen, self.head_in, 1)

    def set_domain_offset(self, offset: int) -> None:
        self.domain_id_offset = int(offset)

    def _fields(self, batch, feed=None) -> torch.Tensor:
        x = embeddings.embed_fields(self.emb if feed is None else feed,
                                    self.layout, batch)
        return x.index_select(1, self._active)

    def _domain(self, batch):
        """The raw scenario ids ``[B]`` and the one-hot of ``id - offset``
        ``[B, D]``."""
        ids = batch["sparse"][:, self.layout.sparse_index(self.domain_col)]
        onehot = core.one_hot(ids - self.domain_id_offset, self.num_domains,
                              self.emb.bank.dtype)
        return ids, onehot

    def _logit0(self, batch):
        return self.linear(self.layout, batch) if self.linear is not None \
            else 0.0

    def _output(self, logit0, x, batch, onehot, aux, return_aux):
        """The head on the attention output ``x``, the prediction, and with
        ``return_aux`` the aux loss beside it."""
        flat = x.reshape(x.shape[0], -1)
        if self.layout.dense_dim > 0 and "dense" in batch:
            flat = torch.cat([flat, batch["dense"]], dim=1)
        if self.use_domain_dnn_linear:
            logit_d = torch.einsum("bi,dio->bdo", flat, self.head_w) \
                + self.head_b[None]
            logit = torch.einsum("bdo,bd->bo", logit_d, onehot)
        else:
            logit = self.head(flat)
        pred = core.prediction(logit0 + logit, self.task)[:, 0]
        if not return_aux:
            return pred
        if aux is None:
            aux = torch.zeros((), dtype=pred.dtype, device=pred.device)
        return pred, aux


class StarTrans(_LegacyBase):
    def __init__(self, layout: FeatureLayout, *, merge: str = "no", **kw):
        super().__init__(layout, **kw)
        gen = self._take_generator()
        if merge not in MDRInteracting.MERGES:
            raise NotImplementedError("merge must be no/sum/dot")
        self.merge = merge
        d = self.embedding_dim
        if self.att_layer_type == "deepctr":
            layer = attention.SelfAttentionLayer
        elif self.att_layer_type == "trans":
            layer = TransformerLayer
        else:
            raise NotImplementedError(f"{self.att_layer_type} invalid!")
        self.int_layers = nn.ModuleList(layer(gen, d)
                                        for _ in range(self.att_layer_num))
        self.domain_int_layers = nn.ModuleList(
            MDRInteracting(gen, d, self.num_domains)
            for _ in range(self.domain_att_layer_num))

    def forward(self, batch, feed=None, key=None, return_aux=False):
        train, key = self._train_key(key)
        ids, onehot = self._domain(batch)
        x = self._fields(batch, feed)
        logit = self._logit0(batch)
        for i, layer in enumerate(self.int_layers):
            x = layer(x, self.att_head_num, train=train,
                      key=threefry.fold_in(key, i))
        for i, layer in enumerate(self.domain_int_layers):
            x = layer(x, onehot, self.att_head_num, merge=self.merge,
                      train=train, key=threefry.fold_in(key, 100 + i))
        return self._output(logit, x, batch, onehot, None, return_aux)


class Starv2Trans(_LegacyBase):
    # its aux loss reads per-domain means over the batch (the Trainer
    # refuses it under a mesh of more than one rank)
    batch_wide_aux = True

    def __init__(self, layout: FeatureLayout, *, num_query_bases: int = 3,
                 share_domain_dnn_across_layers: bool = False,
                 attn_batch_reg: float = 0.1, **kw):
        super().__init__(layout, **kw)
        gen = self._take_generator()
        d = self.embedding_dim
        self.num_query_bases = num_query_bases
        self.share_domain_dnn_across_layers = share_domain_dnn_across_layers
        self.attn_batch_reg = attn_batch_reg
        self.domain_emb = nn.Parameter(init.torch_embedding_default(
            gen, (self.num_domains + 1, d)))
        with_ffn = self.att_layer_type == "trans"
        self.domain_int_layers = nn.ModuleList(
            MDRInteractingV2(gen, d, self.num_domains, num_query_bases,
                             with_ffn=with_ffn)
            for _ in range(self.domain_att_layer_num))
        n_dnns = 1 if share_domain_dnn_across_layers \
            else self.domain_att_layer_num
        self.weight_dnns = nn.ModuleList(
            core.MLP(gen, d, [2 * d, num_query_bases],
                     init_std=self.init_std, final_activation=False)
            for _ in range(n_dnns))

    def forward(self, batch, feed=None, key=None, return_aux=False):
        train, key = self._train_key(key)
        ids, onehot = self._domain(batch)
        x = self._fields(batch, feed)
        logit = self._logit0(batch)
        dom_emb = torch.relu(self.domain_emb[core.jax_rows(
            ids, self.num_domains + 1)])
        weights = [torch.softmax(dnn(dom_emb), dim=-1)
                   for dnn in self.weight_dnns]
        # scaled by attn_batch_reg times the batch's real examples: the
        # Trainer's 0/1 pad mask (star_trans.py:874-876)
        regs = [attn_regularization_loss(w, ids, self.num_domains)
                for w in weights]
        n_real = torch.sum(batch["_weight"]) if "_weight" in batch \
            else x.shape[0]
        aux = torch.mean(torch.stack(regs)) * self.attn_batch_reg * n_real
        for i, layer in enumerate(self.domain_int_layers):
            w = weights[i] if len(weights) > 1 else weights[0]
            x = layer(x, onehot, w, self.att_head_num, train=train,
                      key=threefry.fold_in(key, i))
        return self._output(logit, x, batch, onehot, aux, return_aux)


class _MetaLegacy(_LegacyBase):
    """Starv3's and Starv4's meta-transformer stack: ``layers`` with a
    shared MetaNet ``[d, 2d, d]`` (``q_meta``), ``domain_emb`` ``[D + 1,
    d]`` and the encoder's widths (``[2d, P]`` under ``large``, else
    ``[P]``; a ReLU after the last layer unless ``norelu``)."""

    def __init__(self, layout: FeatureLayout, *, meta_mode: str = "Q", **kw):
        super().__init__(layout, **kw)
        d = self.embedding_dim
        self.meta_mode = meta_mode
        self.meta_units = [d, 2 * d, d]  # fixed 2x hidden (star_trans.py:1019)
        gen = self._gen
        self.domain_emb = nn.Parameter(init.torch_embedding_default(
            gen, (self.num_domains + 1, d)))
        self.layers = nn.ModuleList(
            attention.meta_transformer_init(gen, d, self.meta_units,
                                            share_kv_metanet=True)
            for _ in range(self.domain_att_layer_num))
        psize = metanet.param_size(self.meta_units)
        self.enc_hidden = [2 * d, psize] if "large" in self.flag else [psize]

    def _encoder(self, gen, in_dim: int) -> core.MLP:
        return core.MLP(gen, in_dim, self.enc_hidden, init_std=self.init_std,
                        final_activation="norelu" not in self.flag)

    def _layer(self, i, x, tables, key, domain_ids=None):
        """Layer ``i`` on the plain meta layer, its dropout the XLA
        layer's masks of ``fold_in(key, i)``."""
        return attention.meta_transformer_apply(
            self.layers[i], x, tables, self.meta_units, mode=self.meta_mode,
            head_num=self.att_head_num, domain_ids=domain_ids,
            drop_rate=DROPOUT if self.training else 0.0,
            drop_key=threefry.fold_in(key, i))


class Starv3Trans(_MetaLegacy):
    def __init__(self, layout: FeatureLayout, **kw):
        super().__init__(layout, **kw)
        gen = self._take_generator()
        d = self.embedding_dim
        self.use_layerid = "layerid" in self.flag
        self.use_qkvid = "qkvid" in self.flag
        self.use_cat = "cat" in self.flag
        self.enc_in = d + d * (self.use_cat and self.use_layerid) \
            + d * (self.use_cat and self.use_qkvid)
        self.encoder = self._encoder(gen, self.enc_in)
        if self.use_layerid:
            self.layerid_emb = nn.Parameter(init.torch_embedding_default(
                gen, (self.domain_att_layer_num, d)))
        if self.use_qkvid:
            self.qkvid_emb = nn.Parameter(init.torch_embedding_default(
                gen, (3, d)))

    def meta_tables(self) -> list[dict]:
        """One ``{'Q', 'K', 'V'}`` -> ``[D + 1, P]`` dict a layer: the
        encoder over ``relu(domain_emb)``, or under ``layerid`` over
        ``relu`` of the domain rows with the layer's (and under ``qkvid``
        the projection's) embedding added or, under ``cat``, beside them
        (star_trans.py:1030-1063)."""
        table = self.domain_emb
        if not self.use_layerid:
            vec = self.encoder(torch.relu(table))
            return [{"Q": vec, "K": vec, "V": vec}] * len(self.layers)
        tables = []
        for lid in range(len(self.layers)):
            per = {}
            for qkv, name in enumerate(("Q", "K", "V")):
                parts = [table, self.layerid_emb[lid].expand_as(table)]
                if self.use_qkvid:
                    parts.append(self.qkvid_emb[qkv].expand_as(table))
                e = torch.cat(parts, -1) if self.use_cat else sum(
                    parts[1:], parts[0])
                per[name] = self.encoder(torch.relu(e))
                if not self.use_qkvid:
                    per = {"Q": per["Q"], "K": per["Q"], "V": per["Q"]}
                    break
            tables.append(per)
        return tables

    def forward(self, batch, feed=None, key=None, return_aux=False):
        _, key = self._train_key(key)
        ids, onehot = self._domain(batch)
        x = self._fields(batch, feed)
        logit = self._logit0(batch)
        rows = core.jax_rows(ids, self.num_domains + 1)
        for i, tables in enumerate(self.meta_tables()):
            x = self._layer(i, x, tables, key, domain_ids=rows)
        return self._output(logit, x, batch, onehot, None, return_aux)


class Starv4Trans(_MetaLegacy):
    def __init__(self, layout: FeatureLayout, **kw):
        super().__init__(layout, **kw)
        gen = self._take_generator()
        d = self.embedding_dim
        self.use_aggmap = "aggmap" in self.flag
        self.enc_in = 2 * d if self.use_aggmap else d
        # both are trained parameters; only encoders[1] is applied
        # (star_trans_legacy.py:536, :546)
        self.encoders = nn.ModuleList(self._encoder(gen, self.enc_in)
                                      for _ in range(2))

    def forward(self, batch, feed=None, key=None, return_aux=False):
        _, key = self._train_key(key)
        ids, onehot = self._domain(batch)
        x = self._fields(batch, feed)
        logit = self._logit0(batch)
        rows = core.jax_rows(ids, self.num_domains + 1)
        encoder = self.encoders[1]
        if not self.use_aggmap:
            vec = encoder(torch.relu(self.domain_emb))
            tables = {"Q": vec, "K": vec, "V": vec}
        for i in range(len(self.layers)):
            if self.use_aggmap:
                # each example's MetaNet from its scenario embedding and
                # the detached mean of its fields (star_trans.py:1201-1205)
                e = torch.relu(torch.cat([self.domain_emb[rows],
                                          x.mean(dim=1).detach()], dim=-1))
                vec = encoder(e)
                x = self._layer(i, x, {"Q": vec, "K": vec, "V": vec}, key)
            else:
                x = self._layer(i, x, tables, key, domain_ids=rows)
        return self._output(logit, x, batch, onehot, None, return_aux)
