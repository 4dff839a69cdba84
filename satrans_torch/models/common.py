"""Shared scaffolding of the baseline zoo (twin of
``satrans_tpu/models/common.py``).

:class:`ZooBase` builds what the reference's ``BaseModel.__init__`` builds
for every model (basemodel.py:124-189): the fused embedding bank, the
first-order linear model and, when a ``domain_col`` is configured, the
"meta module" (the scenario embedding ``domain_emb``, its encoder
``domain_map`` and the MetaNet ``meta_net``) behind the ``metatrans``
input transformation that several baselines expose (deepfm.py:91-93,
autoint.py:84-87, ...).  The ``flag`` string switches ``metatrans`` /
``usemetatrans`` (the hook; each model says which), ``metanorm`` (the
MetaNet's LayerNorm) and ``noembinit`` (N(0, 1) embeddings).
:class:`DomainBase` is what STAR and the multi-task models share;
:class:`BankModel`, the bank and its helpers, is the base of both.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .. import embeddings
from ..features import FeatureLayout
from ..nn import attention, core, initializers as init, metanet
from ..ops import threefry
from ..utils import make_generator, resolve_device


def combined_dnn_input(sparse_emb: torch.Tensor, dense, dense_dim: int
                       ) -> torch.Tensor:
    """The field embeddings flattened, then the dense values (deepctr's
    ``combined_dnn_input``)."""
    flat = sparse_emb.reshape(sparse_emb.shape[0], -1)
    if dense_dim > 0 and dense is not None:
        flat = torch.cat([flat, dense], dim=1)
    return flat


class BankModel(nn.Module):
    """What every baseline built on the bank shares: the fused embedding
    bank drawn first from the seeded generator, which
    :meth:`_take_generator` then hands to the subclass's layers, the
    step's key, MLPs at ``init_std`` and the bank's L2.  ``task``,
    ``init_std`` and ``l2_reg_embedding`` are the JAX package's defaults;
    :class:`ZooBase` takes them as arguments."""

    # the model reads the large bank through exactly one
    # embed_fields(self.emb) call a forward, so the sparse bank updates
    # apply (train/bank_optimizer.py); AdaSparse opts out
    standard_bank_access = True
    task = "binary"
    init_std = 1e-4
    l2_reg_embedding = 1e-5

    def __init__(self, layout: FeatureLayout, *, domain_col: str | None,
                 flag: str, seed: int, emb_init_std: float | None, device):
        super().__init__()
        self.layout = layout
        self.domain_col = domain_col
        self.flag = flag
        self.embedding_dim = layout.embedding_dim
        self._gen = make_generator(seed, resolve_device(device))
        self.emb = embeddings.bank_init(self._gen, layout,
                                        init_std=emb_init_std)

    def _take_generator(self) -> torch.Generator:
        """The generator the base parameters were drawn from, for the
        subclass's layers (the module keeps no reference to it)."""
        gen = self._gen
        del self._gen
        return gen

    def _mlp(self, gen: torch.Generator, in_dim: int,
             units: Sequence[int]) -> core.MLP:
        return core.MLP(gen, in_dim, list(units), init_std=self.init_std)

    def _train_key(self, key):
        """``(train, key)``: the module's mode, and the step's key or the
        JAX package's default ``PRNGKey(0)``."""
        return self.training, threefry.PRNGKey(0) if key is None else key

    def reg_loss(self, feed=None) -> torch.Tensor:
        """The bank's L2 (without the large bank's under a ``feed``)."""
        return embeddings.l2_loss(self.emb if feed is None else feed,
                                  self.l2_reg_embedding)


class ZooBase(BankModel):
    """The single-task baselines' common parameters and hooks.  A
    subclass draws its own layers from the generator that
    :meth:`_take_generator` hands over after ``super().__init__``, and
    names the flags that switch its hook in ``meta_flags``."""

    # the substrings of ``flag`` that switch the metatrans hook on
    meta_flags: tuple = ("metatrans", "usemetatrans")

    def __init__(self, layout: FeatureLayout, *, domain_col: str | None = None,
                 num_domains: int | None = None, flag: str = "",
                 seed: int = 1024, task: str = "binary",
                 init_std: float = 1e-4, l2_reg_embedding: float = 1e-5,
                 l2_reg_linear: float = 1e-5,
                 meta_dnn_hidden_units: Sequence[int] | None = None,
                 use_linear: bool = True, device="cuda"):
        super().__init__(layout, domain_col=domain_col, flag=flag, seed=seed,
                         emb_init_std=None if "noembinit" in flag
                         else init_std, device=device)
        self.num_domains = num_domains
        self.task = task
        self.init_std = init_std
        self.l2_reg_embedding = float(l2_reg_embedding)
        self.l2_reg_linear = float(l2_reg_linear)
        d = self.embedding_dim
        self.use_meta = bool(domain_col) and any(f in flag
                                                 for f in self.meta_flags)
        # None: [d, 2d, d], the reference's (32, 64, 32) at d = 32
        self.meta_units = [d, 2 * d, d] if meta_dnn_hidden_units is None \
            else [int(u) for u in meta_dnn_hidden_units]
        gen = self._gen
        self.linear = embeddings.LinearModel(gen, layout, init_std=init_std) \
            if use_linear else None
        if domain_col and num_domains:
            # the meta module (reference basemodel.py:132-148)
            self.domain_emb = nn.Parameter(init.torch_embedding_default(
                gen, (num_domains + 1, d)))
            self.domain_map = core.MLP(gen, d,
                                       [metanet.param_size(self.meta_units)],
                                       init_std=init_std,
                                       final_activation=False)
            self.meta_net = metanet.MetaNet(gen, d,
                                            use_norm="metanorm" in flag)

    def _head(self, gen: torch.Generator, in_dim: int) -> core.Linear:
        """A bias-free linear layer to one logit."""
        return core.Linear(gen, in_dim, 1, use_bias=False)

    def _embed(self, batch, feed=None, *, train=False, key=None):
        """Field embeddings ``[B, F, d]`` with the metatrans hook applied:
        the MetaNet of each example's scenario, its weights from the
        encoder over the ``D + 1`` rows ``relu(domain_emb)``, dropout 0.1
        (reference basemodel.py:191-199)."""
        x = embeddings.embed_fields(self.emb if feed is None else feed,
                                    self.layout, batch)
        if not self.use_meta:
            return x
        ids = batch["sparse"][:, self.layout.sparse_index(self.domain_col)]
        vec = self.domain_map(torch.relu(self.domain_emb))
        return metanet.apply_domainwise(self.meta_net, x, ids, vec,
                                        self.meta_units, dropout_rate=0.1,
                                        train=train, key=key)

    def _dnn_input(self, x: torch.Tensor, batch) -> torch.Tensor:
        return combined_dnn_input(x, batch.get("dense"),
                                  self.layout.dense_dim)

    def _prediction(self, logit: torch.Tensor) -> torch.Tensor:
        return core.prediction(logit, self.task)[:, 0]

    def _base_reg(self, feed=None) -> torch.Tensor:
        """The bank's L2 (without the large bank's under a ``feed``) and
        the linear model's."""
        loss = super().reg_loss(feed)
        if self.linear is not None:
            loss = loss + self.linear.l2(self.l2_reg_linear)
        return loss

    def reg_loss(self, feed=None) -> torch.Tensor:
        return self._base_reg(feed)


class DomainBase(BankModel):
    """What STAR and the multi-task models share (the JAX package's
    ``StarNet`` and ``_MTLBase``): the bank and no linear model, the
    ``usetrans`` stack of ``att_layer_num`` self-attention layers at 4
    heads, layer ``i``'s dropout from ``fold_in(key, 50 + i)``, the L2 of
    the embeddings only, and the ``domain_id_offset`` (raw scenario id of
    branch 0, 1 until set) that the Trainer learns from the data."""

    num_tasks = 1

    def __init__(self, layout: FeatureLayout, *,
                 domain_col: str | None = None, flag: str = "",
                 seed: int = 1024, dnn_dropout: float = 0.0,
                 att_layer_num: int = 3, device="cuda"):
        super().__init__(layout, domain_col=domain_col, flag=flag, seed=seed,
                         emb_init_std=self.init_std, device=device)
        self.dnn_dropout = dnn_dropout
        self.domain_id_offset = 1
        self.input_dim = layout.input_dim
        self.use_trans = "usetrans" in flag
        self.int_layers = nn.ModuleList(
            attention.SelfAttentionLayer(self._gen, self.embedding_dim)
            for _ in range(att_layer_num)) if self.use_trans else None

    def set_domain_offset(self, offset: int) -> None:
        self.domain_id_offset = int(offset)

    def _dnn_input(self, batch, feed=None, *, train=False, key=None,
                   trans: bool = True) -> torch.Tensor:
        """The field embeddings, through the ``usetrans`` stack when the
        model has it (and ``trans``), flattened with the dense values."""
        x = embeddings.embed_fields(self.emb if feed is None else feed,
                                    self.layout, batch)
        if self.use_trans and trans:
            for i, layer in enumerate(self.int_layers):
                x = layer(x, 4, train=train,
                          key=threefry.fold_in(key, 50 + i))
        return combined_dnn_input(x, batch.get("dense"),
                                  self.layout.dense_dim)
