"""SATrans: Scenario-Adaptive Transformer for multi-domain CTR (twin of
``satrans_tpu/models/satrans.py``).

Forward:

1. field embeddings ``[B, F, d]`` from the fused bank;
2. the scenario tables ``[D+1, P]``: the scenario encoder (one linear
   ``d -> P``) evaluated once on the ``D+1`` rows ``relu(domain_emb)``, or
   under ``only_emb`` ``relu(domain_emb)`` itself (``[D+1, P]``, no
   encoder); one table for Q, K (and the bilinear maps) and every layer.
   Under ``use_pos`` (the reference's 'pos' flag) each layer l gets its
   own Q, K (and V) tables: the encoder (``2d -> P``) on ``relu([relu(
   domain_emb) | layerid_emb[l] + qkvid_emb[qkv]])``, the bilinear maps
   Q's; and each metanet layer its own ``k_meta`` LayerNorm.  P is the
   MetaNet's flat size (``variant='metanet'``), d (``'gate'``) or
   d * d / H (``'bilinear'``);
3. ``dom = clip(scenario id, 0, D)``;
4. the meta-transformer layers, each through the fused layer of its
   variant: :func:`satrans_torch.ops.meta_block.fused_meta_layer` (K1) for
   the metanet variant, :func:`satrans_torch.ops.gate_block.
   fused_simple_layer` (K6) for gate and bilinear (the CUDA kernels on the
   card, forward and, in training, backward; their plain versions on the
   CPU), or on the JAX package's XLA route (below) the plain layer
   without the logit clamp;
5. flatten, the dense columns, one linear and a sigmoid.

Several scenario columns (the reference's ``--domain_col 301-122``,
satrans.py:205-207: the encoder input is the mean of the columns'
embeddings from a second bank, ``domain_bank``) take the composite
product-domain table: the tables of step 2 come from the encoder over
all ``R = prod(D_i + 1)`` combinations at once (:meth:`_composite_base`),
and ``dom`` is the row-major combination index (:meth:`_composite_ids`).
Then the routing is the JAX package's (satrans.py:358-442):

* metanet with ``R > SATRANS_TILED_MIN_ROWS`` (default 8): the batch is
  dispatched into single-domain tiles (``ops/dispatch.py``), each layer
  runs :func:`satrans_torch.ops.tiled_meta.fused_tiled_layer` (K7) on the
  per-tile tables ``table[plan.tile_dom]``, the head runs on the padded
  slots and only the predictions return to batch order;
* metanet with ``R <= 8``: K1 on the composite table;
* gate and bilinear: K6 on the composite table, by the rule below;
* ``R > SATRANS_COMPOSITE_MAX`` (default 256): the JAX package's
  per-example parameters on its XLA path; the constructor raises (ROADMAP
  queue 1 item 'multi-column above SATRANS_COMPOSITE_MAX').

On one column or a composite table alike, the layer kernels take the
rows the JAX package's kernel route takes (satrans.py:363-380): K1 (and
its backward) while ``R`` times the MetaNet's widest hidden layer is at
most 4096 (a tiled composite at any ``R``), K6 for the gate at any ``R``
and for the bilinear map while ``R * d <= 4096``; past that the layer
takes the XLA route below, in serving and in training, as the JAX
package's does.

``route`` picks one of three routes (:data:`ROUTES`), the JAX package's
``use_fused_kernel`` / ``fused_interpret`` pair: ``'kernel'`` (True /
False) the layer kernels above; ``'plain'`` (True / True, the
interpret-mode kernels) the same routing on the kernels' plain versions,
their masks and logit clamp, on any device: what the card's kernels are
held against; ``'xla'`` (False) the JAX package's XLA route
(satrans.py:488-519): the plain layer
(``nn.attention.meta_transformer_apply``) on the whole batch, without
the clamp and without a dispatch, its dropout the XLA layer's
``jax.random.bernoulli`` masks: layer ``i`` splits ``fold_in(key, i)``
four ways (attention.py:182-184).  The other two routes take the XLA
route too for MetaNets of a depth no kernel takes, for a composite table
that no dispatch tile ``(SATRANS_BLOCK_B_COMPOSITE, 16)`` divides the
batch of, and in dropout training at a batch that no dropout tile
divides (satrans.py:324-339, :372-376).

``forward(..., return_scores=True)`` also returns each layer's attention
probabilities ``[B, H, F, F]`` (before dropout), for the showattn and
instattn probes (``train/attention_probe.py``); it is forward only.  The
routing is the JAX package's (satrans.py:381-395) but for its default: the
metanet variant on a table that is not tiled (one column, or a composite
of 8 rows or fewer) takes K1-scores
(:func:`satrans_torch.ops.meta_block.fused_meta_layer_with_scores`,
logits clamped), everything else - gate, bilinear, a tiled composite
(the JAX package has no score-returning K6 or K7), a route other than
``'kernel'``, and ``SATRANS_PROBE_FUSED=0`` - the plain layer without the clamp on the
whole batch (the JAX package's XLA route, its masks).  The JAX package
defaults to
its XLA route (``SATRANS_PROBE_FUSED`` defaults to ``"0"`` there, a
choice measured on a TPU); the port's rule is that no card path runs the
plain version, so on CUDA the metanet probes take K1-scores unless the
caller sets ``SATRANS_PROBE_FUSED=0`` (a documented deviation).

``forward``'s ``key`` (by default ``PRNGKey(0)``, the JAX package's
``apply(rng=None)``; in training the Trainer's step key) is the dropout's
threefry key (``ops/threefry.py``).  In training each layer of the
kernel route applies dropout at ``dropout_rate`` with its own int32 seed,
``randint(fold_in(key, i))`` (satrans.py:448-450), on tiles of ``block_b`` examples: the first of
``(fused_block_b, 256, 128, 64, 32, 16)`` that divides the batch
(satrans_tpu/models/satrans.py:327-339).  The masks are the JAX
package's interpret-mode kernel masks (``ops/prng.py``), on the kernels
and on their plain versions.

This slice supports one or several scenario columns, the metanet
(2-matrix MetaNets), gate and bilinear variants, each with or without
``use_pos``,
``only_emb`` (not with ``use_pos``), any ``meta_mode`` (a projection is
transformed iff its letter appears; the bilinear map always applies to
Q), ``relu_out`` and float32, in inference and in training
(:meth:`reg_loss` is the full-table embedding L2).  The rest raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import os
from typing import Sequence

import torch
from torch import nn

from .. import embeddings
from ..features import FeatureLayout
from ..nn import attention, core, initializers as init, metanet
from ..ops import dispatch, gate_block, meta_block, threefry, tiled_meta
from ..utils import make_generator, resolve_device


# the three routes of the layers (see the module's docstring)
ROUTES = ("kernel", "plain", "xla")


class SATrans(nn.Module):
    # the only large-bank read is one embed_fields call on self.emb, so the
    # sparse bank updates (train/bank_optimizer.py) apply
    standard_bank_access = True

    def __init__(self, layout: FeatureLayout, domain_cols: Sequence[str],
                 num_domains_list: Sequence[int], *,
                 domain_att_layer_num: int = 3, att_head_num: int = 4,
                 meta_mode: str = "QK",
                 meta_dnn_hidden_units: Sequence[int] = (64, 32),
                 l2_reg_embedding: float = 1e-5, init_std: float = 1e-4,
                 task: str = "binary", dropout_rate: float = 0.1,
                 seed: int = 1024, use_pos: bool = False,
                 variant: str = "metanet", only_emb: bool = False,
                 relu_out: bool = False, no_emb_init: bool = False,
                 compute_dtype: str = "float32", route: str = "kernel",
                 fused_block_b: int | None = None, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        d = layout.embedding_dim
        if only_emb and use_pos:
            raise ValueError("only_emb and use_pos are mutually exclusive "
                             "(onlyemb has no scenario encoder to consume "
                             "the position embeddings)")
        if variant not in attention.VARIANTS:
            raise ValueError(f"unknown variant {variant!r}")
        if compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype {compute_dtype!r}: bf16 is ROADMAP queue 2 "
                "item 'K1 in bf16'")
        self.meta_units = [d] + [int(u) for u in meta_dnn_hidden_units]
        if variant == "metanet" and self.meta_units[-1] != d:
            raise ValueError(
                f"meta_dnn_hidden_units must end with embedding_dim={d} for "
                f"the MetaNet residual, got {meta_dnn_hidden_units}")
        if d % att_head_num:
            raise ValueError(f"embedding_dim={d} must divide "
                             f"att_head_num={att_head_num}")
        self.layout = layout
        self.domain_cols = list(domain_cols)
        self.num_domains_list = [int(n) for n in num_domains_list]
        self.num_domains = self.num_domains_list[0]
        # several scenario columns: the composite product-domain table
        # (satrans_tpu/models/satrans.py:141-151), read per instance
        self.product_domains = 1
        for n in self.num_domains_list:
            self.product_domains *= n + 1
        self.composite_max = int(os.environ.get("SATRANS_COMPOSITE_MAX",
                                                "256"))
        multi = len(self.domain_cols) > 1
        self.use_composite = multi and \
            self.product_domains <= self.composite_max
        self.meta_rows = self.product_domains if multi \
            else self.num_domains + 1
        if multi and not self.use_composite:
            raise NotImplementedError(
                f"{self.product_domains} scenario combinations, more than "
                f"SATRANS_COMPOSITE_MAX={self.composite_max}: the JAX "
                "package's per-example meta parameters are ROADMAP queue 1 "
                "item 'multi-column above SATRANS_COMPOSITE_MAX'")
        # metanet composites past this many rows take the tiled layer (K7)
        self.tiled = multi and variant == "metanet" and self.meta_rows > int(
            os.environ.get("SATRANS_TILED_MIN_ROWS", "8"))
        self.composite_block_b = int(os.environ.get(
            "SATRANS_BLOCK_B_COMPOSITE", "32"))
        # the JAX package's route (satrans.py:349-380): 2- and 3-matrix
        # MetaNets take K1 where the meta rows times the widest hidden layer
        # are at most 4096, K7 on a tiled table; other depths take the
        # plain layer, as the JAX package takes its XLA layer.  The gate
        # takes K6 at any row count, the bilinear map while the rows times
        # d are at most 4096 (its simple_ok).
        widest = max(self.meta_units[1:-1] or self.meta_units[1:2])
        self.metanet_kernel = (
            variant == "metanet"
            and len(self.meta_units) in meta_block.KERNEL_DEPTHS
            and (self.tiled
                 or self.meta_rows * widest <= meta_block.ROUTE_WIDTH))
        self.simple_kernel = variant == "gate" or (
            variant == "bilinear"
            and self.meta_rows * d <= meta_block.ROUTE_WIDTH)
        self.att_head_num = att_head_num
        self.meta_mode = meta_mode
        self.task = task
        self.dropout_rate = dropout_rate
        self.l2_reg_embedding = float(l2_reg_embedding)
        self.relu_out = relu_out
        self.variant = variant
        self.only_emb = only_emb
        self.use_pos = use_pos
        if route not in ROUTES:
            raise ValueError(f"route {route!r} is not one of {ROUTES}")
        self.route = route
        # the dropout tile; SATRANS_BLOCK_B overrides, as in the JAX package
        self.fused_block_b = int(os.environ.get("SATRANS_BLOCK_B", "128")) \
            if fused_block_b is None else int(fused_block_b)
        self.domain_index = [layout.sparse_index(c)
                             for c in self.domain_cols]
        # the table's width (satrans_tpu/models/satrans.py:125-130)
        p = {"gate": d, "bilinear": d * d // att_head_num}.get(
            variant) or metanet.param_size(self.meta_units)
        # the JAX package's default seeds: randint(fold_in(PRNGKey(0), i))
        self.default_seeds = threefry.layer_seeds(threefry.PRNGKey(0),
                                                  domain_att_layer_num)

        gen = make_generator(seed, dev)
        self.emb = embeddings.bank_init(
            gen, layout, init_std=None if no_emb_init else init_std)
        # under only_emb the scenario table holds the params directly
        # (satrans.py:166-170); else the scenario encoder DNN_v2(d -> P),
        # or (2d -> P) under use_pos, no activation on its output
        self.domain_emb = nn.Parameter(init.torch_embedding_default(
            gen, (self.num_domains + 1, p if only_emb else d)))
        if not only_emb:
            self.encoder = core.MLP(gen, 2 * d if use_pos else d, [p],
                                    init_std=init_std,
                                    final_activation=False)
        if use_pos:
            self.layerid_emb = nn.Parameter(init.torch_embedding_default(
                gen, (domain_att_layer_num, d)))
            self.qkvid_emb = nn.Parameter(init.torch_embedding_default(
                gen, (3, d)))
        self.layers = nn.ModuleList(
            attention.meta_transformer_init(gen, d, self.meta_units,
                                            variant=variant,
                                            share_kv_metanet=not use_pos)
            for _ in range(domain_att_layer_num))
        if multi:
            # the scenario columns' own full bank (reference
            # satrans.py:186-188); not in reg_loss, and the sparse bank
            # updates leave it to the dense optimizer
            self.domain_bank = embeddings.bank_init(gen, layout,
                                                    init_std=init_std)
        self.head = core.Linear(gen, layout.num_fields * d + layout.dense_dim,
                                1)
        self.eval()

    def meta_tables(self) -> list[dict]:
        """One ``{'Q', 'K', 'V', 'bilinear'}`` -> ``[R, P]`` dict per
        layer, over the ``R = D+1`` scenario ids, or the composite
        combinations with several columns (:meth:`_composite_base`)."""
        if len(self.domain_cols) > 1:
            return self._tables_from_base(self._composite_base())
        return self._tables_from_base(torch.relu(self.domain_emb))

    def _tables_from_base(self, table) -> list[dict]:
        """The tables over an already ReLU'd base table ``[R, d]``
        (``[R, P]`` under ``only_emb``): the encoder over its rows
        (``only_emb``: the table itself), one table for all without
        ``use_pos`` (satrans.py:212-221); under ``use_pos`` the encoder
        over ``relu([table | layerid_emb[l] + qkvid_emb[qkv]])`` for each
        layer and each of Q, K, V in one product, the bilinear maps Q's
        (satrans.py:222-235)."""
        L = len(self.layers)
        if not self.use_pos:
            if not self.only_emb:
                table = self.encoder(table)
            return [{"Q": table, "K": table, "V": table,
                     "bilinear": table}] * L
        pos = self.layerid_emb[:, None, :] + self.qkvid_emb[None]  # [L, 3, d]
        rows = table.shape[0]
        enc_in = torch.cat([table.expand(L, 3, rows, -1),
                            pos[:, :, None, :].expand(-1, -1, rows, -1)],
                           dim=-1)
        out = self.encoder(torch.relu(enc_in))            # [L, 3, D+1, P]
        return [{"Q": out[i, 0], "K": out[i, 1], "V": out[i, 2],
                 "bilinear": out[i, 0]} for i in range(L)]

    def _composite_base(self) -> torch.Tensor:
        """The composite base table ``[prod(D_i + 1), d]``: row ``(i_0,
        ..., i_{S-1})`` (row-major) holds ``relu(mean_s(emb_s[i_s]))``, the
        per-example encoder input of the reference (satrans.py:205-207)
        for every combination at once (satrans_tpu satrans.py:237-251)."""
        dev = self.domain_emb.device
        tabs = [embeddings.lookup_field(self.domain_bank, self.layout, c,
                                        torch.arange(n + 1, device=dev))
                for c, n in zip(self.domain_cols, self.num_domains_list)]
        acc = tabs[0]
        for t in tabs[1:]:
            acc = (acc[:, None, :] + t[None, :, :]).reshape(-1, t.shape[-1])
        return torch.relu(acc / len(tabs))

    def _composite_ids(self, batch) -> torch.Tensor:
        """The row-major combination index of :meth:`_composite_base`, each
        column clipped to its ``[0, D_i]``."""
        cid = None
        for i, n in zip(self.domain_index, self.num_domains_list):
            ids = batch["sparse"][:, i].long().clamp(0, n)
            cid = ids if cid is None else cid * (n + 1) + ids
        return cid

    def block_b(self, batch_size: int) -> int | None:
        """The dropout tile (and K7's dispatch tile) for a batch: the first
        candidate that divides it, or ``None``.  The candidates are
        ``(fused_block_b, 256, 128, 64, 32, 16)``, and for a composite
        table of more than 8 rows ``(SATRANS_BLOCK_B_COMPOSITE, 16)``
        (satrans.py:327-339)."""
        cands = (self.fused_block_b, 256, 128, 64, 32, 16)
        if self.use_composite and self.meta_rows > 8:
            cands = (self.composite_block_b, 16)
        for cand in cands:
            if batch_size % cand == 0:
                return cand
        return None

    def forward(self, batch, feed=None, key=None,
                return_scores: bool = False):
        """``batch``: typed tensors on the model's device (``sparse``
        ``[B, S]``, optional ``dense`` and ``varlen``).  With ``feed`` (an
        ``embeddings.BankRowFeed``) the large-bank rows come from it.
        ``key``: the dropout's threefry key (``None``: ``PRNGKey(0)``,
        whose layer seeds are :attr:`default_seeds`).  Returns ``[B]``;
        with ``return_scores`` ``(pred, [scores [B, H, F, F] per
        layer])``."""
        x = embeddings.embed_fields(self.emb if feed is None else feed,
                                    self.layout, batch)
        if len(self.domain_cols) > 1:
            dom = self._composite_ids(batch)
        else:
            dom = batch["sparse"][:, self.domain_index[0]].long().clamp(
                0, self.num_domains)
        blk = self.block_b(x.shape[0])
        if key is None:
            key, seeds = threefry.PRNGKey(0), self.default_seeds
        else:
            seeds = threefry.layer_seeds(key, len(self.layers))
        if return_scores:
            return self._scores_forward(x, dom, blk, batch, seeds, key)
        dropping = self.training and self.dropout_rate > 0.0
        # the JAX package's XLA route (satrans.py:324-339, :372-380)
        if self.route == "xla" or not (self.metanet_kernel
                                       or self.simple_kernel) or (
                blk is None and (self.tiled or dropping)):
            for i, (layer, tables) in enumerate(zip(self.layers,
                                                    self.meta_tables())):
                x = self._xla_layer(layer, x, tables, dom,
                                    threefry.fold_in(key, i))
            return self._head(x, batch)
        if self.tiled:
            return self._tiled_forward(x, dom, blk, batch, seeds)
        simple = self.variant != "metanet"
        twins = self.route == "plain"
        for layer, seed, tables in zip(self.layers, seeds,
                                       self.meta_tables(), strict=True):
            kw = dict(head_num=self.att_head_num, mode=self.meta_mode,
                      relu_out=self.relu_out)
            drop = dict(train=self.training, drop_rate=self.dropout_rate,
                        seed=int(seed), block_b=blk or self.fused_block_b)
            if simple and not twins:
                x = gate_block.fused_simple_layer(x, layer, tables, dom,
                                                  **kw, **drop)
            elif simple:
                x = gate_block.simple_layer_reference(
                    x, layer, tables, dom, **kw,
                    masks=gate_block.layer_masks(
                        x, head_num=self.att_head_num, **drop))
            elif not twins:
                x = meta_block.fused_meta_layer(
                    x, layer, tables, dom, meta_units=self.meta_units, **kw,
                    **drop)
            else:
                x = meta_block.meta_layer_reference(
                    x, layer, tables, dom, meta_units=self.meta_units, **kw,
                    masks=meta_block.layer_masks(
                        x, head_num=self.att_head_num, mode=self.meta_mode,
                        **drop))
        return self._head(x, batch)

    def _xla_layer(self, layer, x, tables, dom, key, residuals=None):
        """One layer on the JAX package's XLA route: the plain layer on
        the whole batch without the clamp, its dropout the XLA layer's
        masks of ``key`` (satrans.py:495-505: one GEMM a table row and a
        one-hot select for 8 rows or fewer, a gather beyond)."""
        return attention.meta_transformer_apply(
            layer, x, tables, self.meta_units, mode=self.meta_mode,
            head_num=self.att_head_num, relu_out=self.relu_out,
            domain_ids=dom, dense_select=self.meta_rows <= 8,
            drop_rate=self.dropout_rate if self.training else 0.0,
            drop_key=key, residuals=residuals, clamp=False)

    def _head(self, x, batch) -> torch.Tensor:
        """The prediction from the last layer's output ``[B, F, d]``."""
        flat = x.reshape(x.shape[0], -1)
        if self.layout.dense_dim > 0 and "dense" in batch:
            flat = torch.cat([flat, batch["dense"]], dim=1)
        return core.prediction(self.head(flat), self.task)[:, 0]

    def _scores_forward(self, x, dom, blk, batch, seeds, key):
        """The probes' forward (satrans.py:381-395, :460-468, :484-519):
        ``(pred, [scores per layer])``.  K1-scores for the metanet variant
        on an untiled table on the kernel route unless
        ``SATRANS_PROBE_FUSED=0``; else the XLA route on the whole
        batch."""
        fused = (self.route == "kernel" and self.metanet_kernel and not self.tiled
                 and os.environ.get("SATRANS_PROBE_FUSED", "1") != "0")
        scores = []
        for i, (layer, seed, tables) in enumerate(zip(
                self.layers, seeds, self.meta_tables(), strict=True)):
            if fused:
                x, s = meta_block.fused_meta_layer_with_scores(
                    x, layer, tables, dom, meta_units=self.meta_units,
                    head_num=self.att_head_num, mode=self.meta_mode,
                    relu_out=self.relu_out, train=self.training,
                    drop_rate=self.dropout_rate, seed=int(seed),
                    block_b=blk or self.fused_block_b)
            else:
                res = {}
                x = self._xla_layer(layer, x, tables, dom,
                                    threefry.fold_in(key, i), residuals=res)
                s = res["s"]
            scores.append(s)
        return self._head(x, batch), scores

    def _tiled_forward(self, x, dom, blk, batch, seeds) -> torch.Tensor:
        """The composite metanet on dispatched tiles of ``blk`` slots
        (satrans.py:411-442): K7 (or its plain version on the ``'plain'``
        route) per layer on the per-tile tables, the head on
        the padded slots, the predictions gathered back to batch order.
        Only the occupied slots' predictions are read, so the slack slots'
        gradients are zero and K7's backward skips them (``tile_count``)."""
        plan = dispatch.plan(dom, self.meta_rows, blk)
        x = dispatch.scatter(x, plan)
        tile_dom = plan.tile_dom.long()
        for layer, seed, tables in zip(self.layers, seeds,
                                       self.meta_tables(), strict=True):
            # the gather outside the layer: autograd adds the per-tile
            # gradient blocks into the tables' rows
            tq = tables["Q"][tile_dom]
            tabs = {"Q": tq, "K": tq if tables["K"] is tables["Q"]
                    else tables["K"][tile_dom]}
            kw = dict(meta_units=self.meta_units, head_num=self.att_head_num,
                      mode=self.meta_mode, relu_out=self.relu_out)
            drop = dict(train=self.training, drop_rate=self.dropout_rate,
                        seed=int(seed), block_b=blk)
            if self.route == "kernel":
                x = tiled_meta.fused_tiled_layer(x, layer, tabs, **kw, **drop,
                                                 tile_count=plan.tile_count)
            else:
                x = tiled_meta.tiled_layer_reference(
                    x, layer, tabs, **kw, block_b=blk,
                    masks=tiled_meta.layer_masks(
                        x, head_num=self.att_head_num, mode=self.meta_mode,
                        **drop))
        flat = x.reshape(x.shape[0], -1)
        if self.layout.dense_dim > 0 and "dense" in batch:
            flat = torch.cat([flat, dispatch.scatter(batch["dense"], plan)],
                             dim=1)
        pred = core.prediction(self.head(flat), self.task)[:, 0]
        return pred[plan.back.long()]

    def reg_loss(self, feed=None) -> torch.Tensor:
        """Embedding L2 only (reference satrans.py:120-122 and
        basemodel.py:180; the JAX twin's ``reg_loss``); under a ``feed``
        without the large bank's term.  ``domain_bank`` is not in it: the
        reference registers its L2 before creating it."""
        return embeddings.l2_loss(self.emb if feed is None else feed,
                                  self.l2_reg_embedding)
