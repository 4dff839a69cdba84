"""Reads of a row-sharded bank over the mesh (twin of
``satrans_tpu/parallel/embedding_sharded.py``).

:func:`alltoall_lookup` is the two-round embedding exchange: each rank
sorts its ids, asks once for each distinct row, buckets the asks by the
owning rank (row ``r`` belongs to rank ``r // (R/n)``) into a ``[n, C]``
request table and sends it with one ``all_to_all``; each owner gathers
the rows asked of it (K4, ``ops/gather.py``, on its shard with local
ids) and sends them back with a second ``all_to_all``; the rank undoes
the bucketing and re-expands the duplicates.  ``C = capacity_factor *
ceil(N / n)`` bounds a rank's traffic; a request past its owner's
capacity reads a zero row and is counted, as in the JAX package (the same
``searchsorted`` slotting, so the overflow vector is the JAX one).
``capacity_factor=None`` is ``C = N``, which never overflows: the port's
schedule for ``embedding_exchange='xla'``, since XLA's partitioner has no
PyTorch counterpart.  Ids outside ``[0, R)`` are clipped first.

The lookup is differentiable (:class:`AlltoallLookup`): its backward sums
the gradient of each distinct row on the requesting rank, sends it back
to the owner along the same table and adds it into the owner's rows.

:func:`sharded_lookup` is the JAX package's first schedule (all-gather the
ids, every owner answers the whole global batch, sum), kept for
comparison; :func:`replicated_lookup` reads a whole bank.
"""

from __future__ import annotations

import torch

from ..ops import gather
from .sharding import Mesh


def _capacity(n_ids: int, world: int, capacity_factor) -> int:
    if capacity_factor is None:
        return n_ids
    return min(n_ids, int(capacity_factor * -(-n_ids // world)))


class _Plan:
    """The requester's side of one exchange: the sort, the duplicate runs
    and each distinct row's slot in the ``[n, C]`` table (the sentinel
    ``n * C`` for none)."""

    def __init__(self, flat: torch.Tensor, rows_per: int, world: int,
                 capacity: int):
        n, dev = world, flat.device
        self.order = torch.argsort(flat, stable=True)
        si = flat[self.order]
        first = torch.ones_like(si, dtype=torch.bool)
        first[1:] = si[1:] != si[:-1]
        self.uniq_slot = torch.cumsum(first.to(torch.int64), 0) - 1
        owner = torch.div(si, rows_per, rounding_mode="floor")
        cum = torch.cumsum(first.to(torch.int64), 0)
        first_pos = torch.searchsorted(
            owner, torch.arange(n, device=dev, dtype=owner.dtype),
            side="left")
        cum0 = torch.cat([cum.new_zeros(1), cum])
        slot = cum - 1 - cum0[first_pos][owner]
        ok = first & (slot < capacity)
        self.overflow = first.sum() - ok.sum()
        self.tgt = torch.where(ok, owner * capacity + slot, n * capacity)
        self.first_idx = torch.nonzero(first).view(-1)
        self.local = si - owner * rows_per
        self.ok = ok
        self.n, self.capacity = n, capacity

    def requests(self) -> torch.Tensor:
        """The ``[n, C]`` table of owner-local rows, -1 where empty."""
        req = torch.full((self.n * self.capacity + 1,), -1,
                         dtype=torch.int64, device=self.tgt.device)
        req[self.tgt] = self.local
        return req[:-1].view(self.n, self.capacity)

    def unbucket(self, got: torch.Tensor) -> torch.Tensor:
        """Rows in the caller's order from the answered ``[n, C, W]``
        table; an overflowed request reads zeros."""
        w = got.shape[-1]
        flat = torch.cat([got.reshape(-1, w), got.new_zeros(1, w)])
        per_sorted = flat[self.tgt]
        rows_sorted = per_sorted[self.first_idx][self.uniq_slot]
        rows = torch.empty_like(rows_sorted)
        rows[self.order] = rows_sorted
        return rows

    def bucket_grads(self, g: torch.Tensor) -> torch.Tensor:
        """Each distinct row's summed gradient at its slot: ``[n, C, W]``."""
        w = g.shape[-1]
        g_u = g.new_zeros(self.first_idx.shape[0], w).index_add_(
            0, self.uniq_slot, g[self.order])
        table = g.new_zeros(self.n * self.capacity + 1, w)
        table[self.tgt[self.first_idx]] = g_u
        return table[:-1].view(self.n, self.capacity, w)


def _answer(bank_local: torch.Tensor, asks: torch.Tensor) -> torch.Tensor:
    """The owner's answers ``[n, C, W]`` to the ``[n, C]`` asks: K4 on the
    shard with local ids, zero rows for empty slots."""
    valid = asks >= 0
    ids = torch.where(valid, asks, 0).reshape(-1).contiguous()
    (vals,) = gather.gather_rows((bank_local,), ids)
    vals = vals * valid.reshape(-1, 1).to(vals.dtype)
    return vals.view(*asks.shape, bank_local.shape[1])


class AlltoallLookup(torch.autograd.Function):
    """``bank[ids]`` of a row-sharded bank, differentiable in the local
    rows: the backward sends each distinct row's gradient to its owner."""

    @staticmethod
    def forward(ctx, bank_local, flat, mesh, capacity):
        plan = _Plan(flat, bank_local.shape[0], mesh.world, capacity)
        asks = mesh.all_to_all(plan.requests())
        got = mesh.all_to_all(_answer(bank_local.detach(), asks))
        ctx.plan, ctx.mesh, ctx.asks = plan, mesh, asks
        ctx.rows = bank_local.shape[0]
        ctx.mark_non_differentiable(plan.overflow)
        return plan.unbucket(got), plan.overflow

    @staticmethod
    def backward(ctx, g_rows, _g_overflow):
        mesh, asks = ctx.mesh, ctx.asks
        gvals = mesh.all_to_all(ctx.plan.bucket_grads(g_rows.contiguous()))
        valid = asks.reshape(-1) >= 0
        w = gvals.shape[-1]
        grad = g_rows.new_zeros(ctx.rows, w).index_add_(
            0, asks.reshape(-1)[valid], gvals.reshape(-1, w)[valid])
        return grad, None, None, None


def alltoall_lookup(bank_local: torch.Tensor, ids: torch.Tensor, mesh: Mesh,
                    capacity_factor: float | None = 2.0):
    """``bank[ids]`` where ``bank_local`` ``[R/n, W]`` is this rank's rows
    of the row-sharded ``[R, W]`` bank and ``ids`` this rank's ids (any
    shape).  Returns ``(rows [*ids.shape, W], overflow [n])``: every
    rank's count of distinct requested rows past their owner's capacity
    (those rows read zeros), in rank order."""
    rows_per, w = bank_local.shape
    total = rows_per * mesh.world
    flat = ids.reshape(-1).long().clamp(0, total - 1)
    capacity = _capacity(flat.shape[0], mesh.world, capacity_factor)
    if flat.shape[0] == 0:
        # no large field: nothing to exchange, as in the JAX package
        return (bank_local.new_zeros(*ids.shape, w),
                torch.zeros(mesh.world, dtype=torch.int64,
                            device=bank_local.device))
    rows, overflow = AlltoallLookup.apply(bank_local, flat, mesh, capacity)
    return rows.view(*ids.shape, w), mesh.all_gather(overflow.view(1))


def sharded_lookup(bank_local: torch.Tensor, ids: torch.Tensor,
                   mesh: Mesh) -> torch.Tensor:
    """``bank[ids]`` by the all-gather schedule (embedding_sharded.py:
    154-179): every rank's ids gathered, each owner answering the rows it
    owns of the whole global batch, the partial answers summed and this
    rank's block kept.  ``ids`` ``[B_local, ...]``."""
    rows_per, w = bank_local.shape
    all_ids = mesh.all_gather(ids.long())
    local = all_ids.reshape(-1) - mesh.rank * rows_per
    mine = (local >= 0) & (local < rows_per)
    (part,) = gather.gather_rows((bank_local,),
                                 torch.where(mine, local, 0).contiguous())
    part = part * mine[:, None].to(part.dtype)
    full = mesh.all_reduce(part.contiguous()).view(*all_ids.shape, w)
    b = ids.shape[0]
    return full[mesh.rank * b:(mesh.rank + 1) * b]


def replicated_lookup(bank: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return bank[ids]
