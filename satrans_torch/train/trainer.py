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
scalars.  What the JAX Trainer also offers raises
``NotImplementedError`` naming its ROADMAP item: a mesh and
``lazy_stale``.  ``fit(scan_steps=k)``
(the JAX package's program of k steps, trainer.py:629-658) runs each run
of k full batches as k single steps one after another, with the JAX
package's keys for such a run: the step key is split once and step ``j``
takes the key ``split(sub, k)[j]``.  The statistics of the
run are summed and reach the callbacks once, as the JAX package's do.
``scan_unroll`` (the unroll of the JAX package's ``lax.scan``) is kept and
changes no result.
"""

from __future__ import annotations

import os
import time
from typing import Sequence

import numpy as np
import torch

from . import bank_optimizer, callbacks as cb, checkpoint as ckpt_lib, \
    losses, metrics as metrics_lib, optimizers
from .. import native
from ..ops import threefry
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
    def __init__(self, model, *, mesh=None, seed: int = 1024,
                 scan_unroll: int = 1, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "a mesh is ROADMAP queue 1 item 'parallel/ → "
                "torch.distributed'")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
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
                learning_rate: float = 0.001, bank_update: str = "auto"):
        """Keras-style compile (reference basemodel.py:540-552).
        ``optimizer``: ``'adam'``, ``'sgd'``, ``'adagrad'``, ``'rmsprop'``
        (optax's rules, trainer.py:233-247) or a callable ``params ->
        torch.optim.Optimizer``; ``bank_update``: ``auto`` (``dense`` on
        one device), ``dense``, or with Adam ``fused``, ``fused_eq`` or
        ``lazy``."""
        if bank_update not in _MODES:
            raise ValueError(f"unknown bank_update {bank_update!r}")
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
                         else None)
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
        """Twin of trainer.py:460-503 on one device: ``auto`` resolves to
        ``dense`` (the exact reference path, for every model and
        optimizer); a sparse mode needs Adam and a
        ``standard_bank_access`` model."""
        if mode == "auto":
            mode = "dense"
        elif mode != "dense" and not (self._opt_is_adam and
                                      bank_optimizer.eligible(self.model)):
            raise ValueError(
                f"bank_update={mode!r} needs the stock 'adam' optimizer and "
                "a standard_bank_access model "
                f"({type(self.model).__name__} is not)")
        self._bank_mode = mode

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
                    batch = self._device_batch(
                        {kk: self._pad(self._take(v, idx), batch_size)
                         for kk, v in data.items()})
                    wb = np.zeros(batch_size, np.float32)
                    wb[:bsz] = 1.0
                    yb, wb = self._device_batch(
                        {"y": self._pad(labels[idx], batch_size),
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
            total = a["loss"] + a["reg_loss"] + a["aux_loss"]
            epoch_logs = {"loss": total / max(seen, 1)}
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
            outs = [scores[:rows] for _, scores, rows in
                    self._eval_batches(data, batch_size)]
            scores = torch.cat(outs).cpu() if outs else torch.zeros(0)
        return scores.numpy().astype("float64")

    def _eval_batches(self, data: dict, batch_size: int):
        """Yield ``(batch, scores, real rows)`` for each batch of
        ``batch_size`` rows of the typed ``data`` (the last padded): the
        batch on the device and its routed eval-mode scores.  The caller
        holds ``torch.no_grad()``."""
        strategy = self.strategy
        n = len(next(iter(data.values())))
        self.model.eval()
        for start in range(0, n, batch_size):
            stop = min(start + batch_size, n)
            batch = self._device_batch(
                {k: self._pad(v[start:stop], batch_size)
                 for k, v in data.items()})
            yield batch, strategy.route(self.model(batch), batch), \
                stop - start

    def evaluate(self, x: dict, y, batch_size: int = 256) -> dict:
        pred = self.predict(x, batch_size)
        yy = np.asarray(y).reshape(-1)
        return {name: fn(yy, pred) for name, fn in self.metric_fns.items()}

    def _eval_collect(self, x: dict, y, batch_size: int, domain_col=None):
        """Eval-mode scores, labels, pad weights and (with ``domain_col``)
        domain ids of ``x`` in batches of ``batch_size``, each stacked
        ``[steps, B]`` on the device (trainer.py:764-822 on one
        process)."""
        labels = np.asarray(y, dtype=np.float32).reshape(-1)
        didx = (self.layout.sparse_index(domain_col)
                if domain_col is not None else None)
        preds, ys, ws, doms = [], [], [], []
        with torch.no_grad():
            for i, (batch, scores, rows) in enumerate(self._eval_batches(
                    self.layout.batch_from_dict(x), batch_size)):
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
        return (torch.stack(preds), torch.stack(ys), torch.stack(ws),
                torch.stack(doms) if doms else None)

    def evaluate_domains(self, x: dict, y, domain_col: str | None = None,
                         batch_size: int = 256):
        """Overall metrics and the AUC of each domain value, the reference
        protocol (main.py:356-374: overall AUC, then the AUC of each value
        min..max of the split), on one device (trainer.py:824-905 without
        a mesh): scores, labels, weights and domain ids stay on the device
        until each AUC (:func:`metrics.auc_torch`) and the weighted BCE
        are scalars.  A domain value without both classes is left out.
        Returns ``(metrics, {domain value: auc})``, the second empty when
        ``domain_col`` is None."""
        scores, ys, ws, doms = self._eval_collect(x, y, batch_size,
                                                  domain_col)
        s, yy, w = scores.reshape(-1), ys.reshape(-1), ws.reshape(-1)
        out: dict[str, float] = {}
        for name, fn in self.metric_fns.items():
            if name == "auc":
                out[name] = float(metrics_lib.auc_torch(yy, s, w))
            elif name == "binary_crossentropy":
                out[name] = float(torch.sum(w * losses.bce_elementwise(s, yy))
                                  / torch.clamp(torch.sum(w), min=1.0))
            else:  # the uncommon metrics on the host
                keep = (w > 0).cpu().numpy()
                out[name] = fn(yy.cpu().numpy()[keep],
                               s.cpu().numpy().astype("float64")[keep])
        domain_aucs: dict[int, float] = {}
        if doms is not None and len(np.asarray(x[domain_col])):
            d = doms.reshape(-1)
            for v in range(int(np.min(x[domain_col])),
                           int(np.max(x[domain_col])) + 1):
                a = float(metrics_lib.auc_torch(yy, s, w * (d == v)))
                if np.isfinite(a):  # an absent domain value: 0/0
                    domain_aucs[v] = a
        return out, domain_aucs
