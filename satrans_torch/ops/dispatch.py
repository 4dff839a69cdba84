"""Domain-sorted tile dispatch for the per-tile weight layer (twin of
``satrans_tpu/ops/dispatch.py``).

A composite multi-column table has ``prod(D_i + 1)`` rows (56 for
AliCCP's ``301`` x ``122``).  The tiled layer (``ops/tiled_meta.py``,
K7) removes the row count from the layer's cost: the batch is sorted by
composite domain id and each domain's run is padded to a multiple of the
tile, so that every tile of ``tile`` slots holds examples of exactly one
domain and reads one MetaNet weight block.  Slack slots hold zeros and
their outputs are never gathered back, so their gradients are zero.

The plan is plain PyTorch on the ids' device (a stable argsort, counts,
cumulative sums and a sorted search), no kernel, as the JAX package's is
plain XLA.  Its shapes are static (``n_slots = B + num_domains * tile``,
the worst case), and building it does not wait for the device.  The ids
must lie in ``[0, num_domains)``.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DispatchPlan:
    """Static-shape dispatch of ``B`` examples into single-domain tiles;
    both directions are single gathers by these int32 index vectors."""
    src: torch.Tensor       # [n_slots] source example per slot (-1: slack)
    back: torch.Tensor      # [B] the slot holding example b
    tile_dom: torch.Tensor  # [n_slots // tile] the domain of each tile
    n_slots: int            # B + num_domains * tile
    tile: int
    # [n_slots // tile] the occupied slots of each tile, which are its first
    # ones: K7's backward skips the rest (ops/tiled_meta.py)
    tile_count: torch.Tensor


def plan(domain_ids: torch.Tensor, num_domains: int,
         tile: int) -> DispatchPlan:
    """The dispatch of ``domain_ids`` ``[B]`` (``B`` a multiple of
    ``tile``).  Tiles past the last occupied slot are slack and are given
    the last domain.  A domain's run fills its tiles from their first slot,
    so each tile's occupied slots (``tile_count``) come first."""
    B = domain_ids.shape[0]
    if B % tile:
        raise ValueError(f"batch {B} must divide tile {tile}")
    dev = domain_ids.device
    i64 = dict(dtype=torch.int64, device=dev)
    cid = domain_ids.to(torch.int64)
    # index_add_ rather than bincount, which reads the largest id back to
    # the host on the card
    counts = torch.zeros(num_domains, **i64).index_add_(
        0, cid, torch.ones_like(cid))
    padded = (counts + tile - 1) // tile * tile
    ends = torch.cumsum(padded, 0)
    offs = ends - padded
    starts = torch.cumsum(counts, 0) - counts
    order = torch.argsort(cid, stable=True)
    sorted_cid = cid[order]
    rank = torch.arange(B, **i64) - starts[sorted_cid]
    dest = offs[sorted_cid] + rank
    n_slots = B + num_domains * tile
    src = torch.full((n_slots,), -1, **i64)
    src[dest] = order
    back = torch.empty(B, **i64)
    back[order] = dest
    slot = torch.arange(0, n_slots, tile, **i64)
    tile_dom = torch.searchsorted(ends, slot, right=True).clamp_(
        max=num_domains - 1)
    tile_count = (src >= 0).view(-1, tile).sum(1, dtype=torch.int32)
    return DispatchPlan(src=src.to(torch.int32), back=back.to(torch.int32),
                        tile_dom=tile_dom.to(torch.int32), n_slots=n_slots,
                        tile=tile, tile_count=tile_count)


def scatter(x: torch.Tensor, p: DispatchPlan) -> torch.Tensor:
    """``[B, ...]`` -> the padded ``[n_slots, ...]`` buffer, one tile per
    domain run (one gather; slack slots read row 0 and are zeroed)."""
    valid = (p.src >= 0).view(-1, *[1] * (x.dim() - 1))
    rows = x[p.src.clamp(min=0).long()]
    return torch.where(valid, rows, torch.zeros((), dtype=x.dtype,
                                                device=x.device))


def gather_back(buf: torch.Tensor, p: DispatchPlan) -> torch.Tensor:
    """The inverse of :func:`scatter`: the padded buffer back in batch
    order (``[B, ...]``).  SATrans gathers only its scalar prediction
    back (``pred[plan.back]``)."""
    return buf[p.back.long()]
