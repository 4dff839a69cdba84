"""The bank update on a row-sharded bank: each touched row is sent to its
owner and committed there (twin of ``satrans_tpu/parallel/bank_sharded.py``).

:func:`route_to_owners` combines each rank's duplicate rows (sort and
sum, ``embeddings.combine_duplicate_rows``), buckets the distinct rows by
owner with the JAX package's cumsum slotting into a ``[n, C]`` table and
sends the owner-local ids and the gradient rows with one ``all_to_all``
each.  :func:`lazy_routed_update` then combines the rows each owner got
from several senders and runs the decayed-moment lazy Adam on its shard:
the row reads run K4 (``ops/gather.py``) and the commit K2
(``ops/scatter.py``, ``drop_oob``) on the local shard with local ids, as
the JAX package runs its Pallas gather and scatter inside ``shard_map``.
A row past its owner's capacity is dropped for the step: its gradient is
lost and its ``last`` is not advanced; the count, summed over the ranks,
is returned.  ``capacity_factor=None`` never drops.
"""

from __future__ import annotations

import torch

from ..embeddings import combine_duplicate_rows
from ..ops import gather, scatter
from .sharding import Mesh


def route_to_owners(flat_ids: torch.Tensor, g_rows: torch.Tensor,
                    mesh: Mesh, rows_per: int,
                    capacity_factor: float | None = 2.0):
    """Send this rank's ``(flat_ids [N], g_rows [N, W])`` to the rows'
    owners (ids clipped into ``[0, rows_per * n)``, duplicates summed
    first).  Returns ``(ids [n C], g [n C, W], overflow)``: the
    owner-local ids this rank received, their gradient rows, and this
    rank's count of distinct rows past capacity (a device scalar).  An
    empty slot carries an id past the shard, ``rows_per`` plus its slot,
    and a zero row: distinct, so that a combine by sort meets no long run
    of one id (a run's sum is one thread's serial loop in PyTorch's
    ``index_put_``)."""
    n = mesh.world
    nl, w = g_rows.shape
    cap = nl if capacity_factor is None else min(
        nl, int(capacity_factor * -(-nl // n)))
    ids = flat_ids.long().clamp(0, rows_per * n - 1)
    u, gu, valid = combine_duplicate_rows(ids, g_rows)
    owner = torch.where(valid, torch.div(u, rows_per, rounding_mode="floor"),
                        n)
    first_pos = torch.searchsorted(
        owner, torch.arange(n, device=ids.device, dtype=owner.dtype),
        side="left")
    slot = torch.arange(nl, device=ids.device) - \
        first_pos[owner.clamp(max=n - 1)]
    ok = valid & (slot < cap)
    overflow = valid.sum() - ok.sum()
    tgt = torch.where(ok, owner * cap + slot, n * cap)
    req_ids = torch.full((n * cap + 1,), -1, dtype=torch.int64,
                         device=ids.device)
    req_ids[tgt] = u - owner * rows_per
    req_g = g_rows.new_zeros(n * cap + 1, w)
    req_g[tgt] = gu
    asks = mesh.all_to_all(req_ids[:-1].view(n, cap)).reshape(-1)
    gvals = mesh.all_to_all(req_g[:-1].view(n, cap, w)).reshape(-1, w)
    empty = rows_per + torch.arange(asks.shape[0], device=asks.device)
    return torch.where(asks >= 0, asks, empty), gvals, overflow


def lazy_routed_update(bank: torch.Tensor, mu: torch.Tensor,
                       nu: torch.Tensor, last_slots: torch.Tensor,
                       count: int, flat_ids: torch.Tensor,
                       g_rows: torch.Tensor, *, lr: float, l2: float,
                       mesh: Mesh, capacity_factor: float | None = 2.0):
    """One lazy-Adam step on a row-sharded bank (bank_sharded.py:68-169),
    in place.  ``bank``, ``mu``, ``nu``: this rank's physical rows
    ``[R/n, W]``; ``last_slots``: their last steps ``[R/n + 1]`` (the slot
    past the end takes the dropped writes); ``count``: the steps so
    far; ``flat_ids`` ``[N]`` global physical ids and ``g_rows`` ``[N, W]``
    this rank's.  Returns the overflow summed over the ranks (a device
    scalar)."""
    from ..train.bank_optimizer import ADAM_B1, ADAM_B2, adam_rows
    rows_per = bank.shape[0]
    lids, gvals, overflow = route_to_owners(flat_ids, g_rows, mesh,
                                            rows_per, capacity_factor)
    # the owner's combine across senders; the empty slots sort last
    u2, gu2, valid2 = combine_duplicate_rows(lids, gvals)
    real = valid2 & (u2 >= 0) & (u2 < rows_per)
    u2s = torch.where(real, u2, 0).contiguous()
    tgt2 = torch.where(real, u2, rows_per).contiguous()
    count_inc = count + 1
    k = (count_inc - 1 - last_slots[u2s]).to(torch.float32)
    w_u, m_u, v_u = gather.gather_rows((bank, mu, nu), u2s)
    w_u2, m_u2, v_u2 = adam_rows(
        w_u * ((1.0 - 2.0 * l2 * lr) ** (k + 1.0))[:, None],
        m_u * (ADAM_B1 ** k)[:, None], v_u * (ADAM_B2 ** k)[:, None], gu2,
        torch.full((), count_inc - 1.0, device=bank.device), lr)
    scatter.scatter_rows_set((bank, mu, nu), tgt2, (w_u2, m_u2, v_u2),
                             drop_oob=True)
    last_slots.index_put_((tgt2,), torch.full_like(tgt2, count_inc))
    return mesh.all_reduce(overflow.view(1))[0]
