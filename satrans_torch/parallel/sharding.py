"""The mesh and the placement of a model on it (twin of
``satrans_tpu/parallel/sharding.py``).

In the JAX package one process drives every device of its host and one
SPMD program runs over the global batch.  The port follows PyTorch: a
rank is a process, and each rank owns one device.  :class:`Mesh` is the
process group, this rank, the world size and the rank's device, with the
four collectives the port uses (``all_reduce``, ``all_gather_into_tensor``,
``all_to_all_single`` and ``broadcast``), each on the tensors' own device.

What must match is the math of the global program: each rank's step
equals one step of the JAX mesh over the global batch, up to float32
summation order.  Rank ``r`` holds rows ``[r B/n, (r+1) B/n)`` of each
global batch (:func:`shard_array`); replicated parameters start from rank
0's (:func:`place`) and get the sum of the ranks' gradients.

With ``shard_embeddings`` the bank's physical (packed) rows are split
among the ranks: rank ``r`` owns rows ``[r R/n, (r+1) R/n)`` of the
bank padded by :func:`pad_banks`, and the bank's Adam moments, the lazy
``mu``, ``nu`` and ``last`` follow the rows.  Only the model's large bank
(``model.emb.bank``) is split; every other parameter, other banks
(a first-order bank, ``domain_bank``) and the side bank included, stays
replicated.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch
import torch.distributed as dist

from ..utils import resolve_device


@dataclasses.dataclass
class Mesh:
    """One rank's view of the data-parallel mesh.  ``group`` is None for a
    single process without a process group: every collective is then the
    identity."""
    group: object | None
    rank: int
    world: int
    device: torch.device

    # -- collectives on the tensors' own device ---------------------------
    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the ranks in place (``sum``, ``max`` or
        ``min``); returns it."""
        if self.group is not None:
            dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                                   "max": dist.ReduceOp.MAX,
                                   "min": dist.ReduceOp.MIN}[op],
                            group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along dim 0 in rank order."""
        if self.group is None:
            return t
        t = t.contiguous()
        out = torch.empty((self.world * t.shape[0], *t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        with warnings.catch_warnings():
            # newer releases prefer all_gather_single; both serve this call
            warnings.simplefilter("ignore", FutureWarning)
            dist.all_gather_into_tensor(out, t, group=self.group)
        return out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` ``[n, ...]``: block ``j`` goes to rank ``j``; returns the
        blocks received, block ``i`` from rank ``i``."""
        if self.group is None:
            return t
        t = t.contiguous()
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=self.group)
        return out

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        if self.group is not None:
            dist.broadcast(t, src, group=self.group)
        return t

    def barrier(self) -> None:
        """A barrier made of one all-reduce, on the mesh's device."""
        self.all_reduce(torch.zeros(1, device=self.device))


def make_mesh(device="cuda") -> Mesh:
    """The mesh of the current process group (``distributed.initialize``),
    or a one-rank mesh without one.  The rank takes ``cuda:(local_rank %
    device_count)`` unless the caller asks for the CPU."""
    dev = resolve_device(device)
    if not dist.is_available() or not dist.is_initialized():
        return Mesh(None, 0, 1, dev)
    rank, world = dist.get_rank(), dist.get_world_size()
    if dev.type == "cuda" and dev.index is None:
        from .distributed import local_rank
        dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
    return Mesh(dist.group.WORLD, rank, world, dev)


def padded_rows(rows: int, multiple: int) -> int:
    return -(-rows // multiple) * multiple


def pad_banks(bank: torch.Tensor, world: int, rp: int = 1) -> torch.Tensor:
    """The logical bank ``[rows, d]`` (``rows`` a multiple of ``rp``) with
    zero rows added until its physical rows (``rows / rp``) are a multiple
    of ``world`` (sharding.py:56-75).  The pad rows are never gathered and
    add nothing to the L2."""
    phys = bank.shape[0] // rp
    target = padded_rows(phys, world) * rp
    if target == bank.shape[0]:
        return bank
    return torch.cat([bank, bank.new_zeros(target - bank.shape[0],
                                           *bank.shape[1:])])


def owned_rows(total: int, mesh: Mesh) -> slice:
    """The rows of ``total`` (a multiple of the world) that this rank
    owns."""
    per = total // mesh.world
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


class BankShard:
    """What a row-sharded :class:`embeddings.Bank` carries beside its local
    rows: the mesh, the physical rows a rank owns (``rows_per``), the
    padded physical row count (``rows_per * world``) and the logical rows
    of the unpadded bank (``rows``)."""

    def __init__(self, mesh: Mesh, rows_per: int, rows: int):
        self.mesh = mesh
        self.rows_per = rows_per
        self.total = rows_per * mesh.world
        self.rows = rows


def place(model, mesh: Mesh, *, shard_embeddings: bool = False):
    """Place ``model`` on the mesh (sharding.py:89-121): every parameter
    and buffer moves to the rank's device and takes rank 0's values (one
    ``broadcast`` each); with ``shard_embeddings`` the large bank is padded
    (:func:`pad_banks`) and replaced by this rank's rows, and
    ``model.emb.shard`` describes the split.  Optimizer state is made
    after placement, so it follows the rows."""
    model.to(mesh.device)
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            mesh.broadcast(t.data)
    emb = getattr(model, "emb", None)
    if not shard_embeddings:
        return model
    if emb is None or not hasattr(emb, "bank"):
        raise ValueError(f"shard_embeddings needs a model with a fused bank "
                         f"({type(model).__name__} has none)")
    rp = emb.rp
    rows = emb.bank.shape[0]
    full = pad_banks(emb.bank.detach(), mesh.world, rp)
    rows_per = full.shape[0] // rp // mesh.world
    local = full[owned_rows(full.shape[0], mesh)].clone()
    emb.bank = torch.nn.Parameter(local)
    emb.shard = BankShard(mesh, rows_per, rows)
    return model


def gather_bank(local: torch.Tensor, shard: BankShard,
                rp: int) -> torch.Tensor:
    """The whole unpadded bank (or a tensor of its rows: a moment, the
    lazy ``last``) from every rank's rows, in rank order, on every rank;
    ``local`` holds ``rows_per * rp`` logical rows or ``rows_per``
    physical ones."""
    full = shard.mesh.all_gather(local)
    if local.shape[0] == shard.rows_per:  # physical rows
        return full[:shard.rows // rp]
    return full[:shard.rows]


def shard_of(full: torch.Tensor, shard: BankShard, rp: int) -> torch.Tensor:
    """This rank's rows of the whole bank ``full`` (or a tensor of its
    shape), padded first as :func:`pad_banks` pads the bank."""
    padded = pad_banks(full, shard.mesh.world, rp)
    return padded[owned_rows(padded.shape[0], shard.mesh)].clone()


def shard_array(arr, mesh: Mesh, *, axis: int = 0):
    """This rank's block of ``arr`` along ``axis`` (sharding.py:128-141):
    rows ``[r L/n, (r+1) L/n)`` of a global batch of length ``L``."""
    length = arr.shape[axis]
    if length % mesh.world:
        raise ValueError(f"a batch of {length} rows does not split into "
                         f"{mesh.world} ranks")
    per = length // mesh.world
    index = [slice(None)] * np.ndim(arr)
    index[axis] = slice(mesh.rank * per, (mesh.rank + 1) * per)
    return arr[tuple(index)]


def shard_batch(batch: dict, mesh: Mesh, *, axis: int = 0) -> dict:
    return {k: shard_array(v, mesh, axis=axis) for k, v in batch.items()}
