"""SATrans: Scenario-Adaptive Transformer for multi-domain CTR (twin of
``satrans_tpu/models/satrans.py``, single scenario column).

Forward:

1. field embeddings ``[B, F, d]`` from the fused bank;
2. the scenario encoder (one linear ``d -> P``) evaluated once on the
   ``D+1`` rows ``relu(domain_emb)``, giving a ``[D+1, P]`` table of flat
   MetaNet params shared by Q, K and every layer;
3. ``dom = clip(scenario id, 0, D)``;
4. the meta-transformer layers, each through
   :func:`satrans_torch.ops.meta_block.fused_meta_layer` (the CUDA kernels
   on the card, forward and, in training, backward; the plain version on
   the CPU), or through the plain
   :func:`satrans_torch.ops.meta_block.meta_layer_reference` when
   ``use_kernel=False``;
5. flatten, the dense columns, one linear and a sigmoid.

In training each layer applies dropout at ``dropout_rate`` with its own
int32 seed (``forward``'s ``seeds``, the counterpart of the JAX package's
``rng``), on tiles of ``block_b`` examples: the first of
``(fused_block_b, 256, 128, 64, 32, 16)`` that divides the batch
(satrans_tpu/models/satrans.py:327-339).  The masks are the JAX package's
interpret-mode kernel masks (``ops/prng.py``), on both paths: the unfused
path (``use_kernel=False``) draws the kernels' masks, not ``jax.random``'s
as the JAX package's XLA path does (a documented deviation).

This slice supports one scenario column, the metanet variant with shared
(non-``pos``) 2-matrix MetaNets, any ``meta_mode`` (a projection is
transformed iff its letter appears), ``relu_out`` and float32, in
inference and in training (:meth:`reg_loss` is the full-table embedding
L2).  The rest raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import os
from typing import Sequence

import torch
from torch import nn

from .. import embeddings
from ..features import FeatureLayout
from ..nn import attention, core, initializers as init, metanet
from ..ops import meta_block
from ..utils import make_generator, resolve_device

_VARIANTS = "ROADMAP queue 1 item 'remaining SATrans variants'"


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
                 compute_dtype: str = "float32", use_kernel: bool = True,
                 fused_block_b: int | None = None, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        d = layout.embedding_dim
        if len(domain_cols) != 1:
            raise NotImplementedError(
                "several scenario columns (composite tables, kernel K7) "
                f"are {_VARIANTS}")
        if use_pos:
            raise NotImplementedError(
                "'pos' is ROADMAP queue 1 item 'Alimama sota-pos slice'")
        if variant != "metanet" or only_emb:
            raise NotImplementedError(
                f"variant {variant!r} / only_emb is {_VARIANTS}")
        if compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype {compute_dtype!r}: bf16 is K1 build step 5 "
                "in ROADMAP queue 2")
        self.meta_units = [d] + [int(u) for u in meta_dnn_hidden_units]
        if self.meta_units[-1] != d:
            raise ValueError(
                f"meta_dnn_hidden_units must end with embedding_dim={d} for "
                f"the MetaNet residual, got {meta_dnn_hidden_units}")
        if len(self.meta_units) != 3:
            raise NotImplementedError(
                f"3-matrix MetaNets are {_VARIANTS}")
        if d % att_head_num:
            raise ValueError(f"embedding_dim={d} must divide "
                             f"att_head_num={att_head_num}")
        self.layout = layout
        self.domain_cols = list(domain_cols)
        self.num_domains = int(num_domains_list[0])
        self.att_head_num = att_head_num
        self.meta_mode = meta_mode
        self.task = task
        self.dropout_rate = dropout_rate
        self.l2_reg_embedding = float(l2_reg_embedding)
        self.relu_out = relu_out
        self.use_kernel = use_kernel
        # the dropout tile; SATRANS_BLOCK_B overrides, as in the JAX package
        self.fused_block_b = int(os.environ.get("SATRANS_BLOCK_B", "128")) \
            if fused_block_b is None else int(fused_block_b)
        self.domain_index = layout.sparse_index(self.domain_cols[0])
        p = metanet.param_size(self.meta_units)

        gen = make_generator(seed, dev)
        self.emb = embeddings.bank_init(
            gen, layout, init_std=None if no_emb_init else init_std)
        self.domain_emb = nn.Parameter(
            init.torch_embedding_default(gen, (self.num_domains + 1, d)))
        # scenario encoder: DNN_v2(d -> P), no activation on its output
        self.encoder = core.MLP(gen, d, [p], init_std=init_std,
                                final_activation=False)
        self.layers = nn.ModuleList(
            attention.meta_transformer_init(gen, d, self.meta_units)
            for _ in range(domain_att_layer_num))
        self.head = core.Linear(gen, layout.num_fields * d + layout.dense_dim,
                                1)
        self.eval()

    def meta_tables(self):
        """``{'Q': [D+1, P], 'K': [D+1, P]}``: the encoder over the D+1
        distinct scenario ids, one table for both (non-``pos``)."""
        table = self.encoder(torch.relu(self.domain_emb))
        return {"Q": table, "K": table}

    def block_b(self, batch_size: int) -> int | None:
        """The dropout tile for a batch: the first candidate that divides
        it, or ``None``."""
        for cand in (self.fused_block_b, 256, 128, 64, 32, 16):
            if batch_size % cand == 0:
                return cand
        return None

    def forward(self, batch, feed=None, seeds=None) -> torch.Tensor:
        """``batch``: typed tensors on the model's device (``sparse``
        ``[B, S]``, optional ``dense`` and ``varlen``).  With ``feed`` (an
        ``embeddings.BankRowFeed``) the large-bank rows come from it.
        ``seeds``: one int32 dropout seed per layer (``None``: the fixed
        seeds 0, 1, ...).  Returns ``[B]``."""
        x = embeddings.embed_fields(self.emb if feed is None else feed,
                                    self.layout, batch)
        dom = batch["sparse"][:, self.domain_index].long().clamp(
            0, self.num_domains)
        blk = self.block_b(x.shape[0])
        if self.training and self.dropout_rate > 0.0 and blk is None:
            raise NotImplementedError(
                f"dropout at batch {x.shape[0]}, which no dropout tile "
                f"(fused_block_b={self.fused_block_b}, 256, 128, 64, 32, 16) "
                "divides: the JAX package's XLA fallback there draws "
                "jax.random masks; ROADMAP queue 2 item 'dropout at a "
                "batch no tile divides'")
        if seeds is None:
            seeds = range(len(self.layers))
        tables = self.meta_tables()
        for layer, seed in zip(self.layers, seeds, strict=True):
            kw = dict(meta_units=self.meta_units, head_num=self.att_head_num,
                      mode=self.meta_mode, relu_out=self.relu_out)
            drop = dict(train=self.training, drop_rate=self.dropout_rate,
                        seed=int(seed), block_b=blk or self.fused_block_b)
            if self.use_kernel:
                x = meta_block.fused_meta_layer(x, layer, tables, dom, **kw,
                                                **drop)
            else:
                x = meta_block.meta_layer_reference(
                    x, layer, tables, dom, **kw,
                    masks=meta_block.layer_masks(
                        x, head_num=self.att_head_num, mode=self.meta_mode,
                        **drop))
        flat = x.reshape(x.shape[0], -1)
        if self.layout.dense_dim > 0 and "dense" in batch:
            flat = torch.cat([flat, batch["dense"]], dim=1)
        return core.prediction(self.head(flat), self.task)[:, 0]

    def reg_loss(self, feed=None) -> torch.Tensor:
        """Embedding L2 only (reference satrans.py:120-122 and
        basemodel.py:180; the JAX twin's ``reg_loss``); under a ``feed``
        without the large bank's term."""
        return embeddings.l2_loss(self.emb if feed is None else feed,
                                  self.l2_reg_embedding)
