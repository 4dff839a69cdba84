"""Fused embedding bank (twin of ``satrans_tpu/embeddings.py``: the forward
and the full-table L2).

All large tables are concatenated row-wise into one ``[R, d]`` bank, and a
whole batch embeds with one gather ``bank[ids + field_offsets]``.  Tables
whose vocab is at most ``SMALL_TABLE_THRESHOLD`` (and that no varlen field
uses) live in a compact ``[Rs, d]`` side bank.

The port stores logical ``[R, d]`` rows.  The JAX package packs
``128 // d`` logical rows into one 128-lane physical row, a TPU layout
that changes no forward result; ``bridge.from_jax_params`` unpacks it.

Out-of-range ids never fault on the card: large-bank indices are clamped
into the bank, as XLA's gather clamps them, and side-bank ids outside the
side bank read zeros, as the JAX package's one-hot read does.
"""

from __future__ import annotations

import torch
from torch import nn

from .features import FeatureLayout
from .nn import initializers as init

SMALL_TABLE_THRESHOLD = 256


class Bank(nn.Module):
    """``bank`` ``[large_rows, d]`` and, where the layout has small tables,
    ``small`` ``[small_rows, d]``."""

    def __init__(self, bank: torch.Tensor, small: torch.Tensor | None):
        super().__init__()
        self.bank = nn.Parameter(bank)
        self.small = nn.Parameter(small) if small is not None else None


def bank_init(gen: torch.Generator, layout: FeatureLayout, *,
              dim: int | None = None,
              init_std: float | None = 1e-4) -> Bank:
    """``init_std=None`` is the reference's ``noembinit``: N(0, 1)."""
    d = layout.embedding_dim if dim is None else dim
    split = layout.small_split(SMALL_TABLE_THRESHOLD)

    def draw(shape):
        if init_std is None:
            return init.torch_embedding_default(gen, shape)
        return init.normal(gen, shape, init_std)

    bank = draw((max(split["large_rows"], 1), d))
    small = draw((split["small_rows"], d)) if split["small_rows"] else None
    return Bank(bank, small)


def _offsets(values, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(values, dtype=torch.long, device=like.device)


def lookup_rows(emb: Bank, ids: torch.Tensor) -> torch.Tensor:
    """Large-bank rows ``ids -> [..., d]`` (indices clamped into the bank)."""
    return emb.bank[ids.clamp(0, emb.bank.shape[0] - 1)]


def _small_lookup(small: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Side-bank rows; an id outside the side bank reads a zero row."""
    inside = (ids >= 0) & (ids < small.shape[0])
    rows = small[ids.clamp(0, small.shape[0] - 1)]
    return rows * inside.unsqueeze(-1).to(rows.dtype)


def lookup_sparse(emb: Bank, layout: FeatureLayout,
                  sparse_ids: torch.Tensor) -> torch.Tensor:
    """``[B, S]`` ids -> ``[B, S, d]`` in field order: one gather for the
    large-table fields and one for the side-bank fields."""
    split = layout.small_split(SMALL_TABLE_THRESHOLD)
    small_idx, large_idx = split["small_idx"], split["large_idx"]
    ids = sparse_ids.long()
    parts = []
    if large_idx:
        cols = ids[:, large_idx] + _offsets(split["large_offsets"], ids)
        parts.append(lookup_rows(emb, cols))
    if small_idx:
        cols = ids[:, small_idx] + _offsets(split["small_offsets"], ids)
        parts.append(_small_lookup(emb.small, cols))
    out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    order = list(large_idx) + list(small_idx)
    if order == sorted(order):
        return out
    inv = sorted(range(len(order)), key=order.__getitem__)
    return out[:, inv]


def lookup_field(emb: Bank, layout: FeatureLayout, name: str,
                 ids: torch.Tensor) -> torch.Tensor:
    """One sparse field's embeddings for arbitrary ``ids``."""
    split = layout.small_split(SMALL_TABLE_THRESHOLD)
    i = layout.sparse_index(name)
    ids = ids.long()
    if i in split["small_idx"]:
        off = int(split["small_offsets"][split["small_idx"].index(i)])
        return _small_lookup(emb.small, ids + off)
    off = int(split["large_offsets"][split["large_idx"].index(i)])
    return lookup_rows(emb, ids + off)


def lookup_varlen(emb: Bank, layout: FeatureLayout,
                  varlen_ids: torch.Tensor) -> torch.Tensor:
    """``[B, V, maxlen]`` -> ``[B, V, d]`` with per-field pooling; id 0 is
    the pad and is masked out."""
    split = layout.small_split(SMALL_TABLE_THRESHOLD)
    ids = varlen_ids.long()
    rows = lookup_rows(
        emb, ids + _offsets(split["varlen_offsets"], ids)[None, :, None])
    mask = (ids > 0).unsqueeze(-1)                       # [B, V, L, 1]
    pooled = []
    for i, feat in enumerate(layout.varlen):
        e, m = rows[:, i], mask[:, i]
        if feat.combiner == "max":
            p = torch.where(m, e, float("-inf")).amax(dim=1)
            p = torch.where(torch.isfinite(p), p, 0.0)   # all-pad rows -> 0
        elif feat.combiner == "sum":
            p = torch.where(m, e, 0.0).sum(dim=1)
        elif feat.combiner == "mean":
            s = torch.where(m, e, 0.0).sum(dim=1)
            p = s / m.sum(dim=1).clamp(min=1).to(s.dtype)
        else:
            raise ValueError(f"unknown combiner {feat.combiner!r}")
        pooled.append(p)
    return torch.stack(pooled, dim=1)


def embed_fields(emb: Bank, layout: FeatureLayout, batch) -> torch.Tensor:
    """All field embeddings ``[B, F, d]``: sparse, then pooled varlen."""
    parts = []
    if layout.sparse:
        parts.append(lookup_sparse(emb, layout, batch["sparse"]))
    if layout.varlen:
        parts.append(lookup_varlen(emb, layout, batch["varlen"]))
    if not parts:
        raise ValueError("no sparse features")
    return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


def l2_loss(emb: Bank, l2: float):
    """Full-table L2 over the bank and the side bank, matching reference
    basemodel.py:519-535 (the JAX twin's ``l2_loss``; its packed layout
    holds the same values plus zero pad rows, so the sums agree)."""
    if l2 <= 0.0:
        return torch.zeros((), dtype=emb.bank.dtype, device=emb.bank.device)
    loss = torch.sum(torch.square(emb.bank))
    if emb.small is not None:
        loss = loss + torch.sum(torch.square(emb.small))
    return l2 * loss
