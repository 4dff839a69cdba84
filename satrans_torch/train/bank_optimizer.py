"""Sparse bank updates (twin of ``satrans_tpu/train/bank_optimizer.py``).

The dense step differentiates the full-table L2 and scatters the batch's
embedding gradient into the whole bank, so every step's bank gradient is
dense and Adam passes over the whole bank, its moments and its gradient.
The sparse modes keep the math and skip the dense gradient:

* :func:`sparse_bank_grads` reads the step's physical bank rows up front
  (K4, ``ops/gather.py``) and differentiates the loss with respect to
  those rows (``embeddings.BankRowFeed``), so the bank gradient stays
  ``[N, rp * d]``.
* ``fused`` (:func:`fused_update`): the L2's gradient ``2 * l2 * W`` is
  analytic, so ``torch.optim.Adam`` over the bank with that gradient
  handles every untouched row exactly as the dense step does; the touched
  rows are computed apart from their pre-step values and the full
  gradient, with Adam's formula, and written over the step's result in
  the bank and in torch's ``exp_avg`` / ``exp_avg_sq`` (K2,
  ``ops/scatter.py``).  ``fused_eq`` combines duplicate rows with the
  equality combine (K3, ``ops/eqgemm.py``) in place of a sort.
* ``lazy`` (:func:`lazy_update`, a documented deviation, PARITY.md): the
  bank leaves torch's Adam; only touched physical rows move, each with
  the moments' decay ``b1^k``, ``b2^k`` and the L2 as decoupled decay
  ``(1 - 2 l2 lr)^(k+1)`` for the ``k`` steps it was not touched.  Every
  logical row of a touched physical row moves, and ``last`` is kept per
  physical row.  The row tail is split (K4, the decays and Adam in
  PyTorch, K2) or, with ``SATRANS_LAZY_TAIL=fused``, one pass (K5,
  ``ops/lazy_tail.py``).

Adam on the touched rows is ``torch.optim.Adam``'s own fused update (step
size ``lr / bc1``, denominator ``sqrt(v) / sqrt(bc2) + eps``), the update
every other parameter of the port gets, and the duplicate combine sums in
the order of the dense step's embedding gradient, so ``fused`` gives the
port's ``dense`` results.

Out-of-range ids follow the JAX package per mode: the rows are read at
``clamp(id, 0, R-1)`` (``jnp.take(mode='clip')``); the sort combine drops
the gradient of an id outside ``[0, R)`` in ``fused`` and clips it onto
the edge row in ``lazy``; the equality combine redirects a position whose
id leaves its own field's rows to the first position that stays inside
(:func:`_eq_combine`).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch
from torch.optim import adam as torch_adam

from .. import embeddings
from ..ops import gather, lazy_tail, scatter

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


def _lazy_tail_impl() -> str:
    """``split`` (default) or ``fused`` (env ``SATRANS_LAZY_TAIL=fused``:
    the one-pass K5 tail), the JAX package's selector (lazy_tail.py:39-46)."""
    return "fused" if os.environ.get("SATRANS_LAZY_TAIL") == "fused" \
        else "split"


class EqPlan(NamedTuple):
    """Static shape of the equality combine: the gather plan reshapes to
    ``[B, fields]``.  ``shared``: ``((phys_row, (field, ...)), ...)``,
    the physical rows two fields share; ``ranges``: each field's inclusive
    physical-row range ``(lo, hi)``."""
    fields: int
    shared: tuple
    ranges: tuple


# The JAX package's cap on the [F, B, B] float32 equality tensor of its
# einsum.  K3 never builds that tensor, but the cap decides whether the
# equality combine (with its redirect of out-of-range ids) or the sort
# combine runs, so it is kept as it is (bank_optimizer.py:169-187).
EQGEMM_MAX_BYTES = 4 << 30


def use_eqgemm(eq_plan: EqPlan | None, n_ids: int) -> bool:
    """The equality combine where its ``[F, B, B]`` float32 tensor would
    fit ``SATRANS_EQGEMM_MAX_BYTES`` (default :data:`EQGEMM_MAX_BYTES`),
    else the sort combine."""
    if eq_plan is None or n_ids == 0:
        return False
    cap = int(os.environ.get("SATRANS_EQGEMM_MAX_BYTES", EQGEMM_MAX_BYTES))
    bsz = n_ids // eq_plan.fields
    return eq_plan.fields * bsz * bsz * 4 <= cap


def _eq_combine(flat_ids, g_rows, eq_plan: EqPlan, n_rows: int):
    """Equality combine of the raw gather plan ``flat_ids`` ``[B * F]``
    (twin of bank_optimizer.py:190-249).  Returns ``(g_pos, tgt)``: each
    position's row total and its commit target, every target in range and
    every position of one physical row carrying byte-identical values.

    A position whose id leaves its own field's physical rows (out-of-vocab
    data, negative or past the bank) would alias another field's row,
    which the per-field combine cannot see.  It is redirected to the first
    in-range position's (row, total): a redundant identical write, so its
    gradient is dropped."""
    n = flat_ids.shape[0]
    fl = eq_plan.fields
    bsz = n // fl
    w = g_rows.shape[1]
    ids_fb = flat_ids.view(bsz, fl).t().contiguous()              # [F, B]
    g_fb = g_rows.view(bsz, fl, w).transpose(0, 1).contiguous()   # [F, B, W]
    s = embeddings.eqgemm_combine(ids_fb, g_fb, eq_plan.shared)
    g_pos = s.transpose(0, 1).reshape(n, w)
    bounds = embeddings.device_constant(eq_plan.ranges, flat_ids.device,
                                        flat_ids.dtype)
    ok = ((ids_fb >= bounds[:, :1]) & (ids_fb <= bounds[:, 1:])).t()
    ok = ok.reshape(n)
    # the first in-range position, as a 1-element index: indexing with a
    # 0-d tensor would read it on the host and wait for the device
    safe_idx = torch.argmax(ok.to(torch.uint8)).view(1)
    safe_id = flat_ids[safe_idx].clamp(0, n_rows - 1)
    tgt = torch.where(ok, flat_ids, safe_id)
    g_pos = torch.where(ok[:, None], g_pos, g_pos[safe_idx])
    return g_pos, tgt


def make_eq_plan(model) -> EqPlan | None:
    """EqPlan where the gather plan is one ``[B, F]`` sparse lookup (no
    varlen fields, at least one large field, no table shared by two
    fields, few shared physical rows); None where the sort combine must
    be used (twin of bank_optimizer.py:252-289)."""
    layout = model.layout
    if layout.varlen:
        return None
    split = layout.small_split(embeddings.SMALL_TABLE_THRESHOLD)
    li = split["large_idx"]
    if not li:
        return None
    offs = [int(o) for o in split["large_offsets"]]
    if len(set(offs)) != len(offs):
        return None
    rp = embeddings.pack_factor(layout.embedding_dim)
    vocabs = [layout.sparse[i].vocab for i in li]
    ranges = [(o // rp, (o + v - 1) // rp) for o, v in zip(offs, vocabs)]
    shared: dict[int, set] = {}
    for a in range(len(ranges)):
        for c in range(a + 1, len(ranges)):
            lo = max(ranges[a][0], ranges[c][0])
            hi = min(ranges[a][1], ranges[c][1])
            for p in range(lo, hi + 1):
                shared.setdefault(p, set()).update((a, c))
    if len(shared) > 4 * len(li):
        return None
    return EqPlan(fields=len(li),
                  shared=tuple((p, tuple(sorted(fs)))
                               for p, fs in sorted(shared.items())),
                  ranges=tuple(ranges))


def eligible(model) -> bool:
    """True where the sparse modes apply: the model's only large-bank
    access is one ``embed_fields`` call on ``model.emb``."""
    return (getattr(model, "standard_bank_access", False)
            and isinstance(getattr(model, "emb", None), embeddings.Bank)
            and hasattr(model, "l2_reg_embedding"))


def adam_rows(w, m, v, g, steps, lr, b1=ADAM_B1, b2=ADAM_B2,
              eps=ADAM_EPS):
    """One Adam step on a block of rows, in place on ``w``, ``m`` and
    ``v``: ``torch.optim.Adam``'s own fused update, so that the rows get
    the arithmetic of every other parameter of the port.  ``steps`` is a
    float32 scalar tensor on the rows' device, the count of earlier steps
    (torch's ``state['step']``); it is advanced by one."""
    torch_adam.adam([w], [g], [m], [v], [], [steps], fused=True,
                    amsgrad=False, beta1=b1, beta2=b2, lr=lr,
                    weight_decay=0.0, eps=eps, maximize=False)
    return w, m, v


def sparse_bank_grads(model, strategy, batch, y, weight, key=None):
    """Forward and backward of one step with the bank's gradient kept
    sparse, the model's dropout drawn from ``key``.  Every parameter but
    the bank gets its ``.grad``; the one train-mode forward is the step's
    only update of the model's state (its buffers).  Returns
    ``(flat_ids, g_rows, data_loss, reg, aux)``: the raw gather plan
    ``[N]``, the gradient of its physical rows ``[N, rp * d]``, and the
    step's losses, where ``reg`` leaves out the bank's L2."""
    emb = model.emb
    flat_ids = embeddings.bank_gather_plan(model.layout, batch, emb.rp)
    flat_ids = flat_ids.to(emb.bank.device)
    rows = gather.gather_rows((emb.physical(),), flat_ids)[0]
    rows.requires_grad_(True)
    feed = embeddings.BankRowFeed(rows, emb)
    pred = model(batch, feed=feed, key=key)
    feed.assert_consumed()
    data_loss = strategy.loss(pred, y, batch, weight)
    reg = model.reg_loss(feed=feed)
    aux = torch.zeros((), dtype=data_loss.dtype, device=data_loss.device)
    (data_loss + reg + aux).backward()
    g_rows = rows.grad if rows.grad is not None else torch.zeros_like(rows)
    return flat_ids, g_rows, data_loss.detach(), reg.detach(), aux


def _physical(t: torch.Tensor, width: int) -> torch.Tensor:
    return t.detach().view(-1, width)


def fused_update(optimizer: torch.optim.Optimizer, emb, flat_ids, g_rows, *,
                 lr: float, l2: float, eq_plan: EqPlan | None = None):
    """The exact bank update (twin of bank_optimizer.py:375-467): one
    ``optimizer.step()`` over every parameter with the bank's gradient set
    to the analytic ``2 * l2 * W``, then the touched rows of the bank and
    of its ``exp_avg`` / ``exp_avg_sq`` overwritten with their values under
    the full gradient, computed from the rows before the step.  With an
    ``eq_plan`` duplicates are combined by the equality combine and every
    position commits its (byte-identical) row."""
    bank = emb.bank
    phys = emb.physical()
    n_rows, width = phys.shape
    if use_eqgemm(eq_plan, flat_ids.shape[0]):
        gu, tgt = _eq_combine(flat_ids, g_rows, eq_plan, n_rows)
        u_safe = tgt
    else:
        u, gu, valid = embeddings.combine_duplicate_rows(flat_ids, g_rows)
        u_safe = torch.where(valid, u, 0).clamp(0, n_rows - 1)
        tgt = torch.where(valid & (u >= 0), u, n_rows)
    state = optimizer.state[bank]
    if state:
        w_u, m_u, v_u = gather.gather_rows(
            (phys, _physical(state["exp_avg"], width),
             _physical(state["exp_avg_sq"], width)), u_safe)
        steps = state["step"].clone()
    else:  # torch creates the moments at the first step
        (w_u,) = gather.gather_rows((phys,), u_safe)
        m_u, v_u = torch.zeros_like(w_u), torch.zeros_like(w_u)
        steps = torch.zeros((), dtype=torch.float32, device=w_u.device)
    w_u2, m_u2, v_u2 = adam_rows(w_u, m_u, v_u, gu + (2.0 * l2) * w_u,
                                 steps, lr)
    bank.grad = bank.detach() * (2.0 * l2)
    optimizer.step()
    state = optimizer.state[bank]
    scatter.scatter_rows_set(
        (phys, _physical(state["exp_avg"], width),
         _physical(state["exp_avg_sq"], width)), tgt,
        (w_u2, m_u2, v_u2), drop_oob=True)


def lazy_init(emb) -> dict:
    """State of the lazy bank update: Adam moments ``mu`` and ``nu`` as
    physical rows, each physical row's last step ``last`` and the step
    count ``count``.  ``last`` is a view of a buffer with one spare slot
    past the end, where the commit's sentinel targets land."""
    phys = emb.physical()
    last = torch.zeros(phys.shape[0] + 1, dtype=torch.int64,
                       device=phys.device)
    return {"mu": torch.zeros_like(phys), "nu": torch.zeros_like(phys),
            "last": last[:-1], "_last_slots": last, "count": 0}


def lazy_update(emb, state: dict, flat_ids, g_rows, *, lr: float, l2: float,
                eq_plan: EqPlan | None = None):
    """Touched-rows-only bank update (twin of bank_optimizer.py:483-643
    with ``oob='clip'``), in place on the bank and ``state``."""
    phys = emb.physical()
    n_rows = phys.shape[0]
    mu, nu = state["mu"], state["nu"]
    count_inc = state["count"] + 1
    tail = _lazy_tail_impl()
    if use_eqgemm(eq_plan, flat_ids.shape[0]):
        gu, tgt = _eq_combine(flat_ids, g_rows, eq_plan, n_rows)
        ids_k = tgt
        if tail == "fused":
            # the one-pass tail takes each row once: sort, and send every
            # position but a row's first to the sentinel (duplicates carry
            # the same total, so the first one is the row's update)
            tgt, order = torch.sort(tgt, stable=True)
            gu = gu[order]
            first = torch.ones_like(tgt, dtype=torch.bool)
            first[1:] = tgt[1:] != tgt[:-1]
            ids_k = torch.where(first, tgt, n_rows)
        u_safe = tgt
    else:
        u, gu, valid = embeddings.combine_duplicate_rows(
            flat_ids.clamp(0, n_rows - 1), g_rows)
        u_safe = torch.where(valid, u, 0)
        tgt = ids_k = torch.where(valid, u, n_rows)
    k = (count_inc - 1 - state["last"][u_safe]).to(torch.float32)
    d1 = ADAM_B1 ** k
    d2 = ADAM_B2 ** k
    dw = (1.0 - 2.0 * l2 * lr) ** (k + 1.0)
    if tail == "fused":
        lazy_tail.lazy_adam_rows(
            phys, mu, nu, ids_k, gu, d1, d2, dw,
            1.0 / (1.0 - ADAM_B1 ** count_inc),
            1.0 / (1.0 - ADAM_B2 ** count_inc),
            lr=lr, b1=ADAM_B1, b2=ADAM_B2, eps=ADAM_EPS)
    else:
        w_u, m_u, v_u = gather.gather_rows((phys, mu, nu), u_safe)
        w_u2, m_u2, v_u2 = adam_rows(
            w_u * dw[:, None], m_u * d1[:, None], v_u * d2[:, None], gu,
            torch.full((), count_inc - 1.0, device=phys.device), lr)
        scatter.scatter_rows_set((phys, mu, nu), tgt, (w_u2, m_u2, v_u2),
                                 drop_oob=True)
    state["_last_slots"].index_put_(
        (tgt,), torch.full_like(tgt, count_inc))
    state["count"] = count_inc
