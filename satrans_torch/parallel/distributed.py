"""Process-group bring-up and the distributed AUC (twin of
``satrans_tpu/parallel/distributed.py``).

:func:`initialize` starts the process group at the coordinator's address
(a TCP store) with a timeout, so that a hung collective fails the run
instead of hanging it.  ``backend=None`` takes ``nccl`` on the card and
``gloo`` on the CPU; ``gloo`` on the card is the mode in which several
ranks share one card, and is only taken when asked for, in Python or
through ``SATRANS_DIST_BACKEND=gloo`` for the CLI.  NCCL does not allow
two ranks of one communicator on one card, so more ranks than cards on
a host under ``nccl`` raises.

:func:`auc_sharded` is the exact tie-averaged rank AUC of scores spread
over the ranks, without gathering them (distributed.py:77-248): each
rank sorts its scores and folds equal values into ``(v, W, WY)`` triples
(zero-weight entries first collapse to ``+inf``); splitters come from
the all-gathered local quantiles; the triples go to the owner of their
value range with one ``all_to_all`` of a ``[n, C, 3]`` table; each owner
folds equal values again and takes tie-averaged ranks with the
all-gathered offset of the owners before it.  A bucket past its capacity
drops entries, counted; :func:`auc_sharded_exact` then runs once more with
``capacity_factor=None``.  The sums are float64, as
``metrics.auc_torch``'s.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .sharding import Mesh


def local_rank() -> int:
    """This process's rank on its host: ``LOCAL_RANK`` where a launcher
    sets it, else the global rank (one host)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def _local_world(num_processes: int) -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               *, device="cuda", timeout_s: float = 600.0) -> None:
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id``, the store at ``coordinator_address`` (``host:port``);
    a no-op for one process without a coordinator.  ``device`` is where
    the entry points run (``'cpu'`` picks ``gloo``); ``timeout_s`` bounds
    every collective."""
    if coordinator_address is None and num_processes in (None, 1):
        return
    if coordinator_address is None or num_processes is None or \
            process_id is None:
        raise ValueError("initialize needs coordinator_address, "
                         "num_processes and process_id together")
    if dist.is_initialized():
        return
    on_card = torch.device(device).type == "cuda"
    if backend is None:
        backend = "nccl" if on_card else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "nccl":
        if not on_card:
            raise ValueError("backend='nccl' needs the card")
        cards = torch.cuda.device_count()
        if _local_world(num_processes) > cards:
            raise ValueError(
                f"{_local_world(num_processes)} ranks on a host with "
                f"{cards} card(s): NCCL takes one rank a card; for ranks "
                "that share a card pass backend='gloo' "
                "(SATRANS_DIST_BACKEND=gloo for the CLI)")
    if on_card:
        os.environ.setdefault("LOCAL_RANK", str(process_id))
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def host_shard_info() -> tuple[int, int]:
    """``(rank, world)`` for the input pipeline
    (``data.loader.ShardedBatchIterator``)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _dedup_sorted_triples(v, w, wy):
    """Fold equal neighbours of sorted ``v``: ``(v_rep, W, WY, valid)``
    padded to the input length, the tail ``(+inf, 0, 0, False)``."""
    m = v.shape[0]
    first = torch.ones(m, dtype=torch.bool, device=v.device)
    first[1:] = v[1:] != v[:-1]
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    big_w = torch.zeros_like(w).index_add_(0, seg, w)
    big_wy = torch.zeros_like(wy).index_add_(0, seg, wy)
    valid = torch.arange(m, device=v.device) <= seg[-1]
    v_rep = torch.full_like(v, float("inf")).scatter_(0, seg, v)
    return v_rep, big_w, big_wy, valid


def auc_sharded(y_true, y_score, weight=None, *, mesh: Mesh,
                capacity_factor: float | None = 2.0,
                return_overflow: bool = False):
    """Exact AUC of the scores of every rank; ``y_true``, ``y_score`` and
    ``weight`` (0/1 or any non-negative weight) are this rank's, of any
    shape, raveled.  Returns a float64 scalar tensor, every rank the
    same, and with ``return_overflow`` the entries dropped past capacity
    over all ranks."""
    n = mesh.world
    s = y_score.reshape(-1)
    dev = s.device
    y = y_true.reshape(-1).to(torch.float64)
    w = torch.ones_like(y) if weight is None else \
        weight.reshape(-1).to(torch.float64)
    s = torch.where(w > 0, s, torch.full_like(s, float("inf")))
    m = s.shape[0]
    order = torch.argsort(s, stable=True)
    s_s = s[order]
    v, big_w, big_wy, valid = _dedup_sorted_triples(s_s, w[order],
                                                    (w * y)[order])
    if n > 1:
        qpos = (torch.arange(1, n, device=dev) * m) // n
        cand = torch.sort(mesh.all_gather(s_s[qpos].contiguous())).values
        splitters = cand[(torch.arange(1, n, device=dev) * cand.shape[0])
                         // n]
        bucket = torch.searchsorted(splitters, v, side="left")
    else:
        bucket = torch.zeros(m, dtype=torch.int64, device=dev)
    bucket = torch.where(valid, bucket, n)
    cap = m if capacity_factor is None else min(
        m, max(1, int(capacity_factor * -(-m // n))))
    first_pos = torch.searchsorted(
        bucket, torch.arange(n, device=dev, dtype=bucket.dtype), side="left")
    slot = torch.arange(m, device=dev) - first_pos[bucket.clamp(max=n - 1)]
    ok = valid & (slot < cap)
    overflow = valid.sum() - ok.sum()
    tgt = torch.where(ok, bucket * cap + slot, n * cap)
    table = torch.zeros(n * cap + 1, 3, dtype=torch.float64, device=dev)
    table[:, 0] = float("inf")  # an empty slot sorts last, weight 0
    table[tgt] = torch.stack([v.to(torch.float64), big_w, big_wy], dim=-1)
    got = mesh.all_to_all(table[:-1].view(n, cap, 3)).view(n * cap, 3)
    o2 = torch.argsort(got[:, 0], stable=True)
    _, w2, wy2, _ = _dedup_sorted_triples(got[o2, 0], got[o2, 1], got[o2, 2])
    cw = torch.cumsum(w2, 0)
    total = cw[-1:].contiguous()
    totals = mesh.all_gather(total)
    offset = totals[:mesh.rank].sum()
    rank = offset + cw - w2 + (w2 + 1.0) / 2.0
    sums = torch.stack([torch.sum(wy2 * rank), torch.sum(wy2), total[0],
                        overflow.to(torch.float64)])
    sums = mesh.all_reduce(sums)
    pos_rank_sum, n_pos, n_tot = sums[0], sums[1], sums[2]
    auc = (pos_rank_sum - n_pos * (n_pos + 1.0) / 2.0) / \
        (n_pos * (n_tot - n_pos))
    if return_overflow:
        return auc, sums[3].to(torch.int64)
    return auc


def auc_sharded_exact(y_true, y_score, weight=None, *, mesh: Mesh,
                      capacity_factor: float | None = 2.0):
    """:func:`auc_sharded`, run once more at ``capacity_factor=None`` when
    the bounded pass dropped an entry on any rank."""
    auc, ov = auc_sharded(y_true, y_score, weight, mesh=mesh,
                          capacity_factor=capacity_factor,
                          return_overflow=True)
    if capacity_factor is not None and int(ov) > 0:
        auc = auc_sharded(y_true, y_score, weight, mesh=mesh,
                          capacity_factor=None)
    return auc


def distributed_auc(y_true, y_score, weight=None, *, mesh: Mesh | None = None,
                    capacity_factor: float | None = 2.0):
    """The exact global AUC: :func:`auc_sharded_exact` over a mesh of more
    than one rank, else ``metrics.auc_torch`` of the local arrays."""
    if mesh is None or mesh.world == 1:
        from ..train.metrics import auc_torch
        return auc_torch(y_true, y_score, weight)
    return auc_sharded_exact(y_true, y_score, weight, mesh=mesh,
                             capacity_factor=capacity_factor)
