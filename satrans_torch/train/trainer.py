"""The training engine (twin of ``satrans_tpu/train/trainer.py``): the
``Trainer`` with the dense and the sparse bank updates.

One dense step (``bank_update='dense'``, what ``'auto'`` resolves to on
one device) is autograd of the model in train mode, the pad-weighted BCE
sum (:class:`SingleTask`), the model's full-table embedding L2
(``model.reg_loss()``), the model's aux loss (Starv2's, reported as
``aux_loss``; every bank mode differentiates it) and Adam over every
parameter, the bank included.  The step's batch carries the 0/1 pad
mask as ``_weight``, as the JAX Trainer's does.  ``compile`` also takes
``'sgd'``, ``'adagrad'`` and ``'rmsprop'`` with optax's update rules
(``train/optimizers.py``), or a callable ``params -> torch.optim.Optimizer``;
those run ``dense`` only, as in the JAX package.
On the card each meta-transformer layer runs K1-stash forward and
K1-bwd-stash backward, K1-stash light and K1-bwd-stash light under
``SATRANS_BWD=stash_light``, or K1-fwd and K1-bwd under
``SATRANS_BWD=recompute`` (``ops/meta_block.py``); the gate and bilinear
variants' layers run K6 (``ops/gate_block.py``).  Each step draws its
dropout key as the JAX Trainer does: its key ``PRNGKey(seed + 1)``, set
at every ``fit``, is split each step and the model gets ``sub``
(:meth:`Trainer.step_key`, ``ops/threefry.py``), as the JAX model's
``apply`` gets its ``rng``; SATrans turns it into one seed a layer,
``randint(fold_in(sub, i))``.  AdaSparse, whose bank is read twice, takes
only ``dense``, as in the JAX package.
Adam is ``torch.optim.Adam`` with ``eps`` outside the square root, the
same update as ``optax.adam``, in its fused form: one pass over each
parameter, its gradient and its moments (the 841 MB AliCCP bank makes
the update a memory-bound pass).

``'fused'``, ``'fused_eq'`` and ``'lazy'`` keep the bank's gradient to
the step's rows (``train/bank_optimizer.py``, with the row kernels K2-K5
on the card): ``fused`` and ``fused_eq`` give the dense step's results,
``lazy`` moves only the touched rows (a documented deviation, PARITY.md).
``fused`` reports the bank's L2 in ``reg_loss``, ``lazy`` does not.

The loss and the routing of the scores are a strategy, resolved at
``fit`` and at ``predict`` (trainer.py:252-261): :class:`SingleTask`, or
for a multi-task model with a scenario column :class:`DomainRouted`
(head ``i`` for domain ``i + offset``).  ``fit`` first sets the model's
``domain_id_offset`` to the least id of the training data's scenario
column; ``predict`` re-learns it from its own data for a routed model.
A model's state (STAR's BatchNorm statistics, its buffers) moves once a
step, in the step's one train-mode forward; ``predict``, ``evaluate`` and
validation run in eval mode and leave it as it is.

As in the JAX package, the last partial batch is padded to the batch size
with zero rows of weight 0: with sum-reduced losses that is the
reference's smaller tail batch.  Step statistics stay on the device and
reach the host once per epoch (and at a verbose print).

``fit(checkpoint_path=, checkpoint_every=, resume=)`` saves a checkpoint
(``train/checkpoint.py``) every ``checkpoint_every`` steps and, with
``resume``, restores the one at ``checkpoint_path`` first if it exists
(trainer.py:587-595, :671-674).

``fit`` assembles each batch's 2-D arrays with the native batcher
(``native.gather_rows``), as the JAX ``fit`` does.  ``fit_from_iterator``
trains on the batches of an iterator (``data/loader.py``), with ``fit``'s
step keys.  ``evaluate_domains`` keeps scores, labels, weights and domain
ids on the device until the AUCs (``metrics.auc_torch``) and the loss are
scalars.  ``lazy_stale`` raises ``NotImplementedError`` naming its
ROADMAP item.

Under a mesh (``mesh=parallel.make_mesh()``, trainer.py:131-166,
:263-360, :466-539, :745-905) this process is one rank: each step runs
this rank's rows of the global batch, sums the replicated parameters'
gradients and the statistics over the ranks (``_mesh_step``) and updates
the bank with ``bank_optimizer.mesh_update`` (a row-sharded bank's rows
on their owners); ``fit`` takes the same arrays on every rank,
``fit_from_iterator`` and ``evaluate_domains`` this rank's shard, and
``predict`` gives the whole vector on every rank.

``fit(scan_steps=k)`` (the JAX package's program of k steps, trainer.py:629-658) runs each run
of k full batches as k single steps one after another, with the JAX
package's keys for such a run: the step key is split once and step ``j``
takes the key ``split(sub, k)[j]``.  The statistics of the
run are summed and reach the callbacks once, as the JAX package's do.
``scan_unroll`` (the unroll of the JAX package's ``lax.scan``) is kept and
changes no result.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Sequence

import numpy as np
import torch

from . import bank_optimizer, callbacks as cb, checkpoint as ckpt_lib, \
    losses, metrics as metrics_lib, optimizers
from .. import native
from ..ops import threefry
from ..parallel import distributed as parallel_dist, rows as parallel_rows, \
    sharding as parallel_sharding
from ..utils import resolve_device

_MODES = ("auto", "dense", "fused", "fused_eq", "lazy", "lazy_stale")

_ELEMENTWISE = {
    "binary_crossentropy": losses.bce_elementwise,
    "mse": lambda p, y: torch.square(p - y),
    "mae": lambda p, y: torch.abs(p - y),
}


class SingleTask:
    """Loss and routing for one-head models."""

    def __init__(self, loss="binary_crossentropy"):
        name = loss[0] if isinstance(loss, (list, tuple)) else loss
        self.elem = _ELEMENTWISE[name] if isinstance(name, str) else name

    def loss(self, pred, y, batch, weight):
        # weight is the 0/1 pad mask: a sum over the real samples only
        return torch.sum(weight * self.elem(pred, y))

    def route(self, pred, batch):
        return pred


class DomainRouted:
    """One head a scenario (the reference's MTL engine, main.py:262-265;
    twin of trainer.py:92-128): head ``i`` is trained on the examples of
    domain ``i + offset`` only, and each example is scored by its
    domain's head (0 where its id matches no head).  ``domain_index`` is
    the scenario column's place in the sparse batch; ``offset`` is
    learned from the data (mtl_basemodel.py:160)."""

    def __init__(self, domain_index: int, num_tasks: int, offset: int = 0):
        self.domain_index = domain_index
        self.num_tasks = num_tasks
        self.offset = offset

    def _domain_ids(self, batch):
        return batch["sparse"][:, self.domain_index]

    def loss(self, pred, y, batch, weight):
        return losses.masked_multitask_bce_sum(
            pred, y, self._domain_ids(batch), self.offset, self.num_tasks,
            weight)

    def route(self, pred, batch):
        return losses.route_by_domain(pred, self._domain_ids(batch),
                                      self.offset)


class Trainer:
    def __init__(self, model, *, mesh=None, shard_embeddings: bool = False,
                 embedding_exchange: str = "xla",
                 exchange_capacity_factor: float | None = None,
                 seed: int = 1024, scan_unroll: int = 1, device="cuda"):
        """``mesh`` (``parallel.make_mesh()``): train data-parallel, this
        process one rank.  ``shard_embeddings``: split the bank's rows
        among the ranks.  ``embedding_exchange``: how a row-sharded bank is
        read in the sparse modes, ``'alltoall'`` (the two-round exchange at
        ``exchange_capacity_factor``) or ``'xla'`` (the same exchange at
        ``capacity_factor=None``, which never drops a row)."""
        if embedding_exchange not in ("xla", "alltoall"):
            raise ValueError(f"unknown embedding_exchange "
                             f"{embedding_exchange!r}")
        if embedding_exchange == "alltoall" and (mesh is None
                                                 or not shard_embeddings):
            raise ValueError("embedding_exchange='alltoall' needs a mesh "
                             "and shard_embeddings=True")
        if shard_embeddings and mesh is None:
            raise ValueError("shard_embeddings=True needs a mesh")
        if mesh is not None and mesh.world > 1 and \
                getattr(model, "batch_wide_aux", False):
            raise NotImplementedError(
                f"{type(model).__name__} under a mesh of more than one rank "
                "is ROADMAP queue 1 item 'The legacy Star-Trans models "
                "under a mesh'")
        self.mesh = mesh
        self.shard_embeddings = bool(shard_embeddings)
        self.embedding_exchange = embedding_exchange
        self.exchange_capacity_factor = exchange_capacity_factor
        self.lazy_capacity_factor = 2.0
        self.device = mesh.device if mesh is not None else \
            resolve_device(device)
        self.model = model.to(self.device)
        if mesh is not None:
            parallel_sharding.place(self.model, mesh,
                                    shard_embeddings=shard_embeddings)
        self._replica_drift = None
        self.layout = model.layout
        self.seed = int(seed)
        self.scan_unroll = int(scan_unroll)
        self.stop_training = False
        self.history = cb.History()
        self.optimizer = None
        self._strategy = None
        self._bank_mode = "dense"
        self._eq_plan = None
        self._lazy = None
        self._step_key = threefry.PRNGKey(self.seed + 1)

    # ------------------------------------------------------------------
    def compile(self, optimizer="adam", loss="binary_crossentropy",
                metrics: Sequence[str] = ("binary_crossentropy", "auc"),
                learning_rate: float = 0.001, bank_update: str = "auto",
                lazy_capacity_factor: float | None = 2.0):
        """Keras-style compile (reference basemodel.py:540-552).
        ``optimizer``: ``'adam'``, ``'sgd'``, ``'adagrad'``, ``'rmsprop'``
        (optax's rules, trainer.py:233-247) or a callable ``params ->
        torch.optim.Optimizer``; ``bank_update``: ``auto`` (``dense``, or
        ``fused_eq`` under ``embedding_exchange='alltoall'``), ``dense``,
        or with Adam ``fused``, ``fused_eq`` or ``lazy``.
        ``lazy_capacity_factor`` bounds the routed lazy commit's exchange
        on a row-sharded bank (None: never drops)."""
        if bank_update not in _MODES:
            raise ValueError(f"unknown bank_update {bank_update!r}")
        self.lazy_capacity_factor = lazy_capacity_factor
        if bank_update == "lazy_stale" and self.mesh is not None:
            raise ValueError("bank_update='lazy_stale' is single-device "
                             "only (the sharded commit is already "
                             "owner-routed off the critical path)")
        if bank_update == "lazy_stale":
            raise NotImplementedError(
                "bank_update='lazy_stale' is ROADMAP queue 1 item "
                "'lazy_stale' (the software-pipelined lazy commit)")
        if isinstance(optimizer, str) and optimizer != "adam" and \
                optimizer not in optimizers.NAMED:
            raise ValueError(f"unknown optimizer {optimizer!r}")
        self._opt_is_adam = optimizer == "adam"
        self._resolve_bank_mode(bank_update)
        bank = self.model.emb.bank if self._bank_mode == "lazy" else None
        params = [p for p in self.model.parameters() if p is not bank]
        lr = float(learning_rate)
        if self._opt_is_adam:
            self.optimizer = torch.optim.Adam(
                params, lr=lr, betas=(bank_optimizer.ADAM_B1,
                                      bank_optimizer.ADAM_B2),
                eps=bank_optimizer.ADAM_EPS, fused=True)
        elif isinstance(optimizer, str):
            self.optimizer = optimizers.NAMED[optimizer](params, lr)
        else:
            self.optimizer = optimizer(params)
            if not isinstance(self.optimizer, torch.optim.Optimizer):
                raise TypeError("a custom optimizer is a callable params -> "
                                f"torch.optim.Optimizer, got "
                                f"{type(self.optimizer).__name__}")
        # the optimizer a checkpoint was written with
        self.optimizer_kind = optimizer if isinstance(optimizer, str) else \
            f"custom:{type(self.optimizer).__name__}"
        self._lr = lr
        self._eq_plan = (bank_optimizer.make_eq_plan(self.model)
                         if self._bank_mode in ("fused_eq", "lazy")
                         and not self.shard_embeddings else None)
        self._lazy = (bank_optimizer.lazy_init(self.model.emb)
                      if self._bank_mode == "lazy" else None)
        self.metric_fns = {m: metrics_lib.get_metric(m) for m in metrics}
        self.loss_spec = loss
        # resolved at fit or predict, once the domain offset is known
        self._strategy = None
        return self

    def _routed(self) -> bool:
        """A multi-task model with a scenario column: one head a domain."""
        return getattr(self.model, "num_tasks", 1) > 1 and \
            bool(getattr(self.model, "domain_col", None))

    def _resolve_strategy(self):
        """:class:`DomainRouted` at the model's ``domain_id_offset`` for a
        routed model, else :class:`SingleTask` (trainer.py:252-261)."""
        if self._routed():
            return DomainRouted(
                self.layout.sparse_index(self.model.domain_col),
                self.model.num_tasks, self.model.domain_id_offset)
        return SingleTask(self.loss_spec)

    @property
    def strategy(self):
        """The loss and routing strategy, resolved at the model's current
        offset where no ``fit`` or ``predict`` has resolved it yet."""
        if self._strategy is None:
            self._strategy = self._resolve_strategy()
        return self._strategy

    def _resolve_bank_mode(self, mode: str) -> None:
        """Twin of trainer.py:460-503: ``auto`` resolves to ``dense`` (the
        exact reference path, for every model and optimizer), or under
        ``embedding_exchange='alltoall'`` to ``fused_eq``; a sparse mode
        needs Adam and a ``standard_bank_access`` model; ``alltoall``
        needs ``fused``, ``fused_eq`` or ``lazy``."""
        elig = self._opt_is_adam and bank_optimizer.eligible(self.model)
        if mode == "auto":
            if self.embedding_exchange == "alltoall":
                if not elig:
                    raise ValueError(
                        "embedding_exchange='alltoall' needs a sparse "
                        "bank-update mode, which requires the stock 'adam' "
                        "optimizer and a standard_bank_access model "
                        f"({type(self.model).__name__} is not) - use a "
                        "replicated/rowshard exchange instead")
                mode = "fused_eq"
            else:
                mode = "dense"
        elif mode != "dense" and not elig:
            raise ValueError(
                f"bank_update={mode!r} needs the stock 'adam' optimizer and "
                "a standard_bank_access model "
                f"({type(self.model).__name__} is not)")
        if self.embedding_exchange == "alltoall" and mode not in (
                "fused", "fused_eq", "lazy"):
            raise ValueError("embedding_exchange='alltoall' routes the bank "
                             "read through the sparse gather plan - compile "
                             "with bank_update='fused', 'fused_eq' or 'lazy'")
        if self.shard_embeddings and not elig:
            raise NotImplementedError(
                "a row-sharded bank for a model or optimizer outside the "
                f"sparse bank modes ({type(self.model).__name__}) is ROADMAP "
                "queue 1 item 'The row-sharded bank for every model'")
        self._bank_mode = mode
        # under a mesh the dense mode of a sparse-eligible model keeps the
        # bank's gradient to the step's rows (bank_optimizer.mesh_update)
        self._mesh_sparse = self.mesh is not None and elig

    # ------------------------------------------------------------------
    def _device_batch(self, batch_np: dict) -> dict:
        """numpy arrays -> tensors on the device.  For the card they go
        through pinned memory, so that the copy is queued behind the
        previous step's kernels and the host goes on to the next batch (a
        copy from pageable memory would wait for them)."""
        out = {}
        for k, v in batch_np.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory()
            out[k] = t.to(self.device, non_blocking=True)
        return out

    @staticmethod
    def _pad(arr, target):
        n = len(arr)
        if n == target:
            return arr
        return np.pad(arr, [(0, target - n)] + [(0, 0)] * (arr.ndim - 1))

    @staticmethod
    def _take(arr, idx):
        """Row gather for batch assembly: the native batcher for a 2-D
        array (trainer.py:555-562), numpy indexing otherwise."""
        if arr.ndim == 2:
            return native.gather_rows(arr, idx)
        return arr[idx]

    def step_key(self):
        """The next single step's dropout key: the step key is split,
        ``step_key, sub = split(step_key)`` (trainer.py:616, :655), and
        ``sub`` is returned; ``fit`` passes a run of k steps its own
        (:638-639)."""
        self._step_key, sub = threefry.split(self._step_key)
        return sub

    def loss_terms(self, batch, y, weight, key=None):
        """``(total, data loss, reg loss, aux loss)`` of one batch in train
        mode with the dropout ``key``: the function one step
        differentiates, the model's aux loss in it (trainer.py:358-364).
        ``batch`` carries the pad mask as ``_weight``."""
        pred, aux = losses.forward_with_aux(self.model, batch, key=key)
        data_loss = self.strategy.loss(pred, y, batch, weight)
        reg = self.model.reg_loss()
        return data_loss + reg + aux, data_loss, reg, aux

    def train_step(self, batch, y, weight, key=None) -> dict:
        """One optimizer step with the dropout ``key`` (the next
        :meth:`step_key` if None); returns its statistics as device
        scalars."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        mode = self._bank_mode
        if key is None:
            key = self.step_key()
        # the pad mask, for a model that reads the real example count
        # (Starv2's aux loss; trainer.py:318-320, :356)
        batch = dict(batch, _weight=weight)
        if self.mesh is not None:
            return self._mesh_step(batch, y, weight, key)
        if mode == "dense":
            total, data_loss, reg, aux = self.loss_terms(batch, y, weight,
                                                         key)
            total.backward()
            self.optimizer.step()
        else:
            flat_ids, g_rows, data_loss, reg, aux = \
                bank_optimizer.sparse_bank_grads(self.model, self.strategy,
                                                 batch, y, weight, key)
            emb = self.model.emb
            l2 = float(self.model.l2_reg_embedding)
            if mode in ("fused", "fused_eq"):
                # the bank's L2 in the reported reg loss, as 'dense' has it
                flat = emb.bank.detach().view(-1)
                reg = reg + l2 * torch.dot(flat, flat)
                bank_optimizer.fused_update(
                    self.optimizer, emb, flat_ids, g_rows, lr=self._lr,
                    l2=l2, eq_plan=self._eq_plan if mode == "fused_eq"
                    else None)
            else:
                self.optimizer.step()
                bank_optimizer.lazy_update(emb, self._lazy, flat_ids, g_rows,
                                           lr=self._lr, l2=l2,
                                           eq_plan=self._eq_plan)
        return {"loss": data_loss.detach(), "reg_loss": reg.detach(),
                "aux_loss": aux.detach(), "count": torch.sum(weight)}

    # ------------------------------------------------------------------
    def _sharded_rows(self, local: int):
        """The context of a train-mode forward of this rank's ``local``
        rows of the global batch (``parallel/rows.py``)."""
        mesh = self.mesh
        return parallel_rows.batch_rows(mesh.rank * local, local,
                                        local * mesh.world, mesh)

    def _exchange_gather(self, flat_ids, stats: dict):
        """The step's physical rows of a row-sharded bank, read by the
        exchange; under ``alltoall`` its overflow goes to ``stats``."""
        from ..parallel import embedding_sharded
        emb = self.model.emb
        alltoall = self.embedding_exchange == "alltoall"
        rows, overflow = embedding_sharded.alltoall_lookup(
            emb.physical(), flat_ids, self.mesh,
            capacity_factor=self.exchange_capacity_factor if alltoall
            else None)
        if alltoall:
            stats["exchange_overflow"] = overflow.sum().to(torch.float32)
        return rows

    def _dense_ids(self, flat_ids):
        """The dense mode's reads of raw physical ids, as
        ``embeddings.lookup_rows`` reads them: a negative id wrapped once,
        then clamped; ``inside`` marks the positions whose gradient
        counts."""
        emb = self.model.emb
        shard = getattr(emb, "shard", None)
        n_phys = shard.rows // emb.rp if shard is not None else \
            emb.physical().shape[0]
        p = torch.where(flat_ids < 0, flat_ids + n_phys, flat_ids)
        inside = (p >= 0) & (p < n_phys)
        return p.clamp(0, n_phys - 1), inside

    def _all_reduce_grads(self, params) -> None:
        """Sum ``params``' gradients over the ranks with one all-reduce of
        a flat bucket; a parameter that no rank gave a gradient keeps
        none (Adam then skips it, as on one card)."""
        if not params:
            return
        # each gradient followed by a 1 (0 where the rank has none)
        bucket = self.mesh.all_reduce(torch.cat([
            torch.zeros(p.numel() + 1, device=p.device, dtype=p.dtype)
            if p.grad is None else
            torch.cat([p.grad.reshape(-1), p.grad.new_ones(1)])
            for p in params]))
        at = 0
        for p in params:
            n = p.numel()
            # a host read only where this rank had no gradient
            if p.grad is not None or bucket[at + n] > 0:
                p.grad = bucket[at:at + n].view_as(p).clone()
            at += n + 1

    def _mesh_step(self, batch, y, weight, key) -> dict:
        """One step of the global program on this rank's rows: the
        forward and backward on them, the replicated parameters' summed
        gradients, the bank update (``bank_optimizer.mesh_update``) and
        the statistics summed over the ranks.  The first rank alone holds
        the L2 of the replicated parameters in its loss, so that the sum
        holds it once."""
        mesh, mode, model = self.mesh, self._bank_mode, self.model
        lead = mesh.rank == 0
        stats: dict = {}
        bank_l2 = overflow = fingerprint = None
        sharded = mesh.world > 1 or mesh.group is not None
        ctx = self._sharded_rows(weight.shape[0]) if sharded else \
            contextlib.nullcontext()
        if self._mesh_sparse:
            emb = model.emb
            l2 = float(model.l2_reg_embedding)
            inside = None
            if mode == "dense":
                def gather_fn(flat_ids):
                    nonlocal inside
                    ids, inside = self._dense_ids(flat_ids)
                    if self.shard_embeddings:
                        return self._exchange_gather(ids, stats)
                    return bank_optimizer.gather.gather_rows(
                        (emb.physical(),), ids.contiguous())[0]
            elif self.shard_embeddings:
                def gather_fn(flat_ids):
                    return self._exchange_gather(flat_ids, stats)
            else:
                gather_fn = None
            with ctx:
                flat_ids, g_rows, data_loss, reg, aux = \
                    bank_optimizer.sparse_bank_grads(
                        model, self.strategy, batch, y, weight, key,
                        gather_fn=gather_fn, with_reg=lead)
            if inside is not None:
                flat_ids, _ = self._dense_ids(flat_ids)
                g_rows = g_rows * inside[:, None].to(g_rows.dtype)
            elif mode in ("fused", "fused_eq") and self.shard_embeddings:
                # the exact modes drop an out-of-range id's gradient
                ok = (flat_ids >= 0) & (flat_ids < emb.shard.total)
                g_rows = g_rows * ok[:, None].to(g_rows.dtype)
            bank = emb.bank
            self._all_reduce_grads([p for p in model.parameters()
                                    if p is not bank and p.requires_grad])
            if mode == "lazy":
                self.optimizer.step()
            bank_l2, overflow, fingerprint = bank_optimizer.mesh_update(
                mode, self.optimizer, emb, self._lazy, flat_ids, g_rows,
                lr=self._lr, l2=l2, mesh=mesh, eq_plan=self._eq_plan,
                lazy_capacity_factor=self.lazy_capacity_factor)
        else:
            with ctx:
                _, data_loss, reg, aux = self.loss_terms(batch, y, weight,
                                                         key)
                (data_loss + aux + (reg if lead else 0.0)).backward()
            self._all_reduce_grads([p for p in model.parameters()
                                    if p.requires_grad])
            self.optimizer.step()
        if not lead:
            reg = torch.zeros_like(reg)
        if bank_l2 is not None and (self.shard_embeddings or lead):
            reg = reg + bank_l2
        summed = mesh.all_reduce(torch.stack(
            [data_loss.detach(), reg.detach(), aux.detach(),
             torch.sum(weight)]).to(torch.float32))
        stats.update(loss=summed[0], reg_loss=summed[1], aux_loss=summed[2],
                     count=summed[3])
        if overflow is not None:
            stats["bank_overflow"] = overflow.to(torch.float32)
        if fingerprint is not None:
            fps = mesh.all_gather(fingerprint.view(1))
            drift = (fps != fps[0]).any().to(torch.int64)
            self._replica_drift = drift if self._replica_drift is None \
                else self._replica_drift + drift
        return stats

    def _check_replicas(self) -> None:
        """Raise if the replicated bank's rows differed between the ranks
        after any step since the last check."""
        if self._replica_drift is not None:
            drift, self._replica_drift = int(self._replica_drift), None
            if drift:
                raise RuntimeError(
                    f"the replicated bank's rows differ between the ranks "
                    f"after {drift} step(s)")

    def _rank_rows(self, batch_size: int) -> tuple[int, int]:
        """This rank's rows ``[lo, hi)`` of a global batch."""
        if self.mesh is None:
            return 0, batch_size
        world = self.mesh.world
        if batch_size % world:
            raise ValueError(f"batch_size {batch_size} does not split into "
                             f"{world} ranks")
        per = batch_size // world
        return self.mesh.rank * per, (self.mesh.rank + 1) * per

    # ------------------------------------------------------------------
    def fit(self, x: dict, y, *, batch_size: int = 256, epochs: int = 1,
            validation_data=None, valid_cnt_per_epoch: int = 1,
            shuffle: bool = True, verbose: int = 1, callbacks=None,
            steps_per_epoch: int | None = None, scan_steps: int = 1,
            checkpoint_path: str | None = None,
            checkpoint_every: int | None = None, resume: bool = False):
        """Train; mirrors the reference fit (meta_basemodel.py:200-385).
        ``x``: {feature name: numpy column}; ``y``: numpy labels.  With
        ``resume`` and an existing ``checkpoint_path`` the trainer is
        restored from it first; with ``checkpoint_every`` a checkpoint is
        written there every that many steps."""
        if self.optimizer is None:
            raise RuntimeError("call compile() before fit()")
        # the domain offset learned from the training data
        # (meta_basemodel.py:218, trainer.py:575-581)
        col = getattr(self.model, "domain_col", None)
        if col and hasattr(self.model, "set_domain_offset"):
            self.model.set_domain_offset(int(np.min(x[col])))
        self._strategy = self._resolve_strategy()
        if resume and checkpoint_path is not None and \
                os.path.exists(checkpoint_path):
            ckpt_lib.restore(checkpoint_path, self)
            if verbose:
                print(f"resumed from {checkpoint_path}")
        data = self.layout.batch_from_dict(x)
        labels = np.asarray(y, dtype=np.float32).reshape(-1)
        n = len(labels)
        steps = (n - 1) // batch_size + 1
        if steps_per_epoch is not None:
            steps = min(steps, steps_per_epoch)
        steps_to_valid = steps // max(valid_cnt_per_epoch, 1) + 1

        callback_list = cb.CallbackList((callbacks or []) + [self.history])
        callback_list.set_trainer(self)
        self.stop_training = False
        callback_list.on_train_begin()
        if verbose:
            n_val = len(validation_data[1]) if validation_data else 0
            print(f"Train on {n} samples, validate on {n_val} samples, "
                  f"{steps} steps per epoch")

        lo, hi = self._rank_rows(batch_size)
        rng_np = np.random.default_rng(self.seed)
        self._step_key = threefry.PRNGKey(self.seed + 1)
        for epoch in range(epochs):
            callback_list.on_epoch_begin(epoch)
            t0 = time.time()
            perm = rng_np.permutation(n) if shuffle else np.arange(n)
            acc = None
            seen = 0
            step = 0
            while step < steps:
                # a run of k full batches: one split of the step key, as
                # the JAX package's program of k steps (trainer.py:629-641)
                k = min(scan_steps, steps - step)
                if k > 1 and (step + k) * batch_size <= n:
                    self._step_key, sub = threefry.split(self._step_key)
                    subs = threefry.split(sub, k)
                else:
                    k, subs = 1, [None]
                stats = None
                for j in range(k):
                    idx = perm[(step + j) * batch_size:
                               (step + j + 1) * batch_size]
                    bsz = len(idx)
                    # this rank's rows of the padded global batch
                    idx = idx[lo:hi]
                    batch = self._device_batch(
                        {kk: self._pad(self._take(v, idx), hi - lo)
                         for kk, v in data.items()})
                    wb = np.zeros(hi - lo, np.float32)
                    wb[:len(idx)] = 1.0
                    yb, wb = self._device_batch(
                        {"y": self._pad(labels[idx], hi - lo),
                         "w": wb}).values()
                    one = self.train_step(
                        batch, yb, wb,
                        self.step_key() if subs[j] is None else subs[j])
                    seen += bsz
                    stats = one if stats is None else {
                        kk: stats[kk] + v for kk, v in one.items()}
                step += k
                acc = stats if acc is None else {
                    kk: acc[kk] + v for kk, v in stats.items()}
                if verbose and (step % 50 < scan_steps or step >= steps):
                    denom = max(float(stats["count"]), 1.0)
                    print(f"\rstep {step}/{steps} "
                          f"loss {float(stats['loss']) / denom:.6f} "
                          f"reg {float(stats['reg_loss']) / denom:.6f}",
                          end="", flush=True)
                callback_list.on_batch_end(step, {"loss": stats["loss"]})
                if checkpoint_path is not None and checkpoint_every and \
                        step % checkpoint_every < scan_steps:
                    ckpt_lib.save(checkpoint_path, self)
                if (validation_data is not None and valid_cnt_per_epoch > 1
                        and step % steps_to_valid < scan_steps):
                    r = self.evaluate(*validation_data,
                                      batch_size=batch_size * 4)
                    print(f"\nStep {step}/{steps} " + " - ".join(
                        f"val_{k}: {v:.4f}" for k, v in r.items()))
                if self.stop_training:
                    break

            a = {k: float(v) for k, v in acc.items()} if acc is not None \
                else {"loss": 0.0, "reg_loss": 0.0, "aux_loss": 0.0}
            self._check_replicas()
            total = a["loss"] + a["reg_loss"] + a["aux_loss"]
            epoch_logs = {"loss": total / max(seen, 1)}
            # the routed commit's and the exchange's overflow: a dropped
            # row or a zero read shows in History (trainer.py:689-695)
            for key in ("bank_overflow", "exchange_overflow"):
                if key in a:
                    epoch_logs[key] = a[key]
            if validation_data is not None:
                val = self.evaluate(*validation_data,
                                    batch_size=batch_size * 4)
                epoch_logs.update({f"val_{k}": v for k, v in val.items()})
            if verbose:
                dur = int(time.time() - t0)
                print(f"\nEpoch {epoch + 1}/{epochs} - {dur}s - " +
                      " - ".join(f"{k}: {v:.4f}"
                                 for k, v in epoch_logs.items()))
            callback_list.on_epoch_end(epoch, epoch_logs)
            if self.stop_training:
                break

        callback_list.on_train_end()
        return self.history

    def fit_from_iterator(self, iterator_factory, *, epochs: int = 1,
                          domain_offset: int | None = None,
                          verbose: int = 1):
        """Streaming training (trainer.py:709-743): ``iterator_factory(
        epoch)`` yields ``(batch, y, weight)`` numpy triples, the batch a
        ``layout.batch_from_dict`` dict; e.g. ``lambda e: Prefetcher(
        ShardedBatchIterator(...).epoch(e))`` (``data/loader.py``).  The
        step keys are ``fit``'s: ``PRNGKey(seed + 1)`` split once a step.
        ``domain_offset`` sets the model's, where it has one."""
        if self.optimizer is None:
            raise RuntimeError("call compile() before fit_from_iterator()")
        if domain_offset is not None and hasattr(self.model,
                                                 "set_domain_offset"):
            self.model.set_domain_offset(int(domain_offset))
        self._strategy = self._resolve_strategy()
        self._step_key = threefry.PRNGKey(self.seed + 1)
        for epoch in range(epochs):
            t0 = time.time()
            acc = None
            seen = 0
            for batch_np, yb, wb in iterator_factory(epoch):
                seen += int(np.sum(wb > 0))  # on the host, before the copy
                batch = self._device_batch(batch_np)
                yb, wb = self._device_batch(
                    {"y": np.asarray(yb, np.float32),
                     "w": np.asarray(wb, np.float32)}).values()
                stats = self.train_step(batch, yb, wb)
                acc = stats if acc is None else {
                    k: acc[k] + v for k, v in stats.items()}
            self._check_replicas()
            if verbose and acc is not None:
                print(f"Epoch {epoch + 1}/{epochs} - "
                      f"{int(time.time() - t0)}s - loss: "
                      f"{float(acc['loss']) / max(seen, 1):.4f}")
        return self.history

    # ------------------------------------------------------------------
    def predict(self, x: dict, batch_size: int = 256) -> np.ndarray:
        """Inference over a feature dict -> float64 scores ``[N]``; each
        batch is padded to ``batch_size`` (reference predict,
        meta_basemodel.py:401-517).  A multi-task model's heads are
        routed, each example scored by its domain's; the offset is
        re-learned from ``x`` and set on the model, as the reference does
        (mtl_basemodel.py:352; trainer.py:751-761)."""
        if self._routed():
            col = self.model.domain_col
            self.model.set_domain_offset(int(np.min(x[col])))
        self._strategy = self._resolve_strategy()
        data = self.layout.batch_from_dict(x)
        with torch.no_grad():
            if self.mesh is not None:
                # the same x on every rank: each scores its rows of each
                # batch, and every rank gets the whole vector
                lo, hi = self._rank_rows(batch_size)
                n = len(next(iter(data.values())))
                outs = []
                for start in range(0, n, batch_size):
                    part = {k: v[start:start + batch_size][lo:hi]
                            for k, v in data.items()}
                    _, scores, _ = next(self._eval_batches(part, hi - lo, 1))
                    outs.append(self.mesh.all_gather(scores)[
                        :min(batch_size, n - start)])
            else:
                outs = [scores[:rows] for _, scores, rows in
                        self._eval_batches(data, batch_size)]
            scores = torch.cat(outs).cpu() if outs else torch.zeros(0)
        return scores.numpy().astype("float64")

    def _eval_batches(self, data: dict, batch_size: int, steps=None):
        """Yield ``(batch, scores, real rows)`` for each batch of
        ``batch_size`` rows of the typed ``data`` (the last padded; with
        ``steps``, that many batches, empty ones padded whole): the batch
        on the device and its routed eval-mode scores.  The caller holds
        ``torch.no_grad()``."""
        strategy = self.strategy
        n = len(next(iter(data.values())))
        self.model.eval()
        if steps is None:
            steps = -(-n // batch_size)
        for i in range(steps):
            start = i * batch_size
            stop = max(min(start + batch_size, n), start)
            batch = self._device_batch(
                {k: self._pad(v[start:stop], batch_size)
                 for k, v in data.items()})
            yield batch, strategy.route(self.model(batch), batch), \
                stop - start

    def evaluate(self, x: dict, y, batch_size: int = 256) -> dict:
        """The compiled metrics of ``predict(x)``.  Under a mesh of more
        than one rank (the same ``x`` on every rank) each rank takes its
        block of the rows and the metrics come from
        :meth:`evaluate_domains`, the scores never gathered
        (trainer.py:778-790)."""
        if self.mesh is not None and self.mesh.world > 1:
            n = len(np.asarray(y).reshape(-1))
            part = np.array_split(np.arange(n), self.mesh.world)[
                self.mesh.rank]
            xs = {k: np.asarray(v)[part] for k, v in x.items()}
            return self.evaluate_domains(
                xs, np.asarray(y).reshape(-1)[part],
                batch_size=batch_size)[0]
        pred = self.predict(x, batch_size)
        yy = np.asarray(y).reshape(-1)
        return {name: fn(yy, pred) for name, fn in self.metric_fns.items()}

    def _eval_collect(self, x: dict, y, batch_size: int, domain_col=None):
        """Eval-mode scores, labels, pad weights and (with ``domain_col``)
        domain ids of ``x`` in batches of ``batch_size``, each stacked
        ``[steps, B]`` on the device (trainer.py:764-822).  Under a mesh
        ``x`` is this rank's shard, the batches are ``batch_size / n``
        rows and the step count is the ranks' largest, so that every rank
        runs the same exchanges."""
        labels = np.asarray(y, dtype=np.float32).reshape(-1)
        didx = (self.layout.sparse_index(domain_col)
                if domain_col is not None else None)
        steps = None
        if self.mesh is not None:
            batch_size = max(batch_size // self.mesh.world, 1)
            n_max = self.mesh.all_reduce(torch.tensor(
                [len(labels)], device=self.device), "max")
            steps = -(-int(n_max[0]) // batch_size)
        preds, ys, ws, doms = [], [], [], []
        with torch.no_grad():
            for i, (batch, scores, rows) in enumerate(self._eval_batches(
                    self.layout.batch_from_dict(x), batch_size, steps)):
                wb = np.zeros(batch_size, np.float32)
                wb[:rows] = 1.0
                yb, wb = self._device_batch(
                    {"y": self._pad(labels[i * batch_size:
                                           i * batch_size + rows],
                                    batch_size), "w": wb}).values()
                preds.append(scores)
                ys.append(yb)
                ws.append(wb)
                if didx is not None:
                    doms.append(batch["sparse"][:, didx])
        if not preds:
            return (None,) * 4
        return (torch.stack(preds), torch.stack(ys), torch.stack(ws),
                torch.stack(doms) if doms else None)

    def _auc(self, y, s, w) -> float:
        """The exact AUC of the scores of every rank under a mesh of more
        than one rank (``parallel/distributed.auc_sharded_exact``), else
        ``metrics.auc_torch``."""
        return float(parallel_dist.distributed_auc(
            y, s, w, mesh=self.mesh if self.mesh is not None and
            self.mesh.world > 1 else None))

    def evaluate_domains(self, x: dict, y, domain_col: str | None = None,
                         batch_size: int = 256):
        """Overall metrics and the AUC of each domain value, the reference
        protocol (main.py:356-374: overall AUC, then the AUC of each value
        min..max of the split; trainer.py:824-905): scores, labels,
        weights and domain ids stay on the device until each AUC and the
        weighted BCE are scalars.  A domain value without both classes is
        left out.  Under a mesh ``x`` and ``y`` are this rank's shard, the
        AUCs come from the distributed AUC and the loss is summed over the
        ranks; every rank returns the same values.  Returns ``(metrics,
        {domain value: auc})``, the second empty when ``domain_col`` is
        None."""
        scores, ys, ws, doms = self._eval_collect(x, y, batch_size,
                                                  domain_col)
        if scores is None:
            return {}, {}
        s, yy, w = scores.reshape(-1), ys.reshape(-1), ws.reshape(-1)
        mesh = self.mesh
        out: dict[str, float] = {}
        for name, fn in self.metric_fns.items():
            if name == "auc":
                out[name] = self._auc(yy, s, w)
            elif name == "binary_crossentropy":
                sums = torch.stack([
                    torch.sum(w * losses.bce_elementwise(s, yy)),
                    torch.sum(w)])
                if mesh is not None:
                    sums = mesh.all_reduce(sums)
                out[name] = float(sums[0] / torch.clamp(sums[1], min=1.0))
            else:  # the uncommon metrics on the host, on this rank's rows
                keep = (w > 0).cpu().numpy()
                out[name] = fn(yy.cpu().numpy()[keep],
                               s.cpu().numpy().astype("float64")[keep])
        domain_aucs: dict[int, float] = {}
        if doms is not None:
            col = np.asarray(x[domain_col])
            lo, hi = (int(np.min(col)), int(np.max(col))) if len(col) \
                else (2 ** 62, -2 ** 62)
            if mesh is not None:
                b = mesh.all_reduce(torch.tensor(
                    [-lo, hi], dtype=torch.int64, device=self.device), "max")
                lo, hi = -int(b[0]), int(b[1])
            d = doms.reshape(-1)
            for v in range(lo, hi + 1):
                a = self._auc(yy, s, w * (d == v))
                if np.isfinite(a):  # an absent domain value: 0/0
                    domain_aucs[v] = a
        return out, domain_aucs
