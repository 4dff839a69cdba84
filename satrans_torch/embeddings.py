"""Fused embedding bank (twin of ``satrans_tpu/embeddings.py``: the
forward, its gradient, the full-table L2 and what the sparse bank updates
of ``train/bank_optimizer.py`` need).

All large tables are concatenated row-wise into one bank, and a whole
batch embeds with one gather ``bank[ids + field_offsets]``.  Tables whose
vocab is at most ``SMALL_TABLE_THRESHOLD`` (and that no varlen field uses)
live in a compact ``[Rs, d]`` side bank.

The bank holds ``ceil(R / rp) * rp`` logical ``[d]`` rows, the JAX
package's padded size, with ``rp = pack_factor(d)`` and zero pad rows, so
``bank.view(-1, rp * d)`` is the JAX package's packed physical row at no
cost.  Out-of-range ids read as the JAX package reads them
(:func:`lookup_rows`), and the sparse bank updates touch whole physical
rows, as the JAX package's do.

Side-bank ids outside the side bank read zeros, as the JAX package's
one-hot read does.

A bank's width is its own: :func:`embed_fields` and :func:`lookup_field`
read at the dimension of the bank they are given (the JAX package's
``dim`` argument), so the first-order :class:`LinearModel` is a bank of
dimension 1 (``rp = 128`` logical rows a physical row) and its dense
weights (embeddings.py:481-504).
"""

from __future__ import annotations

import torch
from torch import nn

from .features import FeatureLayout
from .nn import initializers as init

SMALL_TABLE_THRESHOLD = 256


def pack_factor(d: int) -> int:
    """Logical rows per 128-float physical row (the JAX package's packing,
    embeddings.py:38-48)."""
    return 128 // d if d in (1, 2, 4, 8, 16, 32, 64, 128) else 1


class Bank(nn.Module):
    """``bank`` ``[rows, d]`` (``rows`` a multiple of ``pack_factor(d)``)
    and, where the layout has small tables, ``small`` ``[small_rows, d]``."""

    def __init__(self, bank: torch.Tensor, small: torch.Tensor | None):
        super().__init__()
        self.bank = nn.Parameter(bank)
        self.small = nn.Parameter(small) if small is not None else None

    @property
    def rp(self) -> int:
        return pack_factor(self.bank.shape[1])

    def physical(self) -> torch.Tensor:
        """The bank as ``[rows / rp, rp * d]`` physical rows: a view of the
        parameter's storage, outside autograd."""
        return self.bank.detach().view(-1, self.rp * self.bank.shape[1])


def bank_init(gen: torch.Generator, layout: FeatureLayout, *,
              dim: int | None = None,
              init_std: float | None = 1e-4) -> Bank:
    """``init_std=None`` is the reference's ``noembinit``: N(0, 1).  The
    pad rows past the tables are zero, so they add nothing to the L2."""
    d = layout.embedding_dim if dim is None else dim
    split = layout.small_split(SMALL_TABLE_THRESHOLD)
    rp = pack_factor(d)
    rows = -(-max(split["large_rows"], 1) // rp) * rp

    def draw(shape):
        if init_std is None:
            return init.torch_embedding_default(gen, shape)
        return init.normal(gen, shape, init_std)

    bank = draw((rows, d))
    bank[split["large_rows"]:] = 0.0
    small = draw((split["small_rows"], d)) if split["small_rows"] else None
    return Bank(bank, small)


class BankRowFeed:
    """Stand-in for the :class:`Bank` holding pre-gathered physical rows
    ``[N, rp * d]`` (twin of the JAX ``BankRowFeed``): the sparse bank
    updates differentiate the loss with respect to these rows, so the bank
    gradient stays ``[N, rp * d]``.  :func:`lookup_rows` consumes them in
    the order of :func:`bank_gather_plan`; the side bank is read as
    usual."""

    def __init__(self, rows: torch.Tensor, emb: Bank):
        self.rows = rows
        self.small = emb.small
        self.d = emb.bank.shape[1]
        self.rp = emb.rp
        self._pos = 0

    def take(self, n: int) -> torch.Tensor:
        if self._pos + n > self.rows.shape[0]:
            raise ValueError(
                "BankRowFeed exhausted: the model gathers more bank rows "
                "than bank_gather_plan planned; use bank_update='dense'")
        out = self.rows[self._pos:self._pos + n]
        self._pos += n
        return out

    def assert_consumed(self) -> None:
        if self._pos != self.rows.shape[0]:
            raise ValueError(
                f"BankRowFeed under-consumed ({self._pos} of "
                f"{self.rows.shape[0]} rows): the model's lookups do not "
                "match bank_gather_plan; use bank_update='dense'")


_CONSTANTS: dict = {}


def device_constant(values, device, dtype=torch.long) -> torch.Tensor:
    """A tensor of the static ``values`` (numbers, or nested tuples of
    them, or a host array) on ``device``, copied there once: a copy from
    the host each step would make the host wait for the device's queue to
    drain, and a CUDA graph cannot capture it.  A constant first asked for
    while a CUDA graph is being captured raises: the warmup before the
    capture must fill it.  It is made outside inference mode, so that a
    constant first made while serving can be saved for a later backward."""
    key = (values if isinstance(values, tuple) else
           tuple(v.item() for v in values), torch.device(device), dtype)
    t = _CONSTANTS.get(key)
    if t is None:
        if key[1].type == "cuda" and \
                torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"device constant {key[0]} first used inside a CUDA graph "
                "capture: warm up at the captured shapes first")
        with torch.inference_mode(False):
            t = _CONSTANTS[key] = torch.as_tensor(key[0], dtype=dtype,
                                                  device=device)
    return t


def select_columns(x: torch.Tensor, idx) -> torch.Tensor:
    """``x[:, idx]`` for a static sequence of column indices, the indices
    a device constant (a Python list as an index is copied from the host
    at every call)."""
    return x.index_select(1, device_constant(tuple(int(i) for i in idx),
                                             x.device))


def _offsets(values, like: torch.Tensor) -> torch.Tensor:
    return device_constant(values, like.device)


def physical_ids(ids: torch.Tensor, rp: int) -> torch.Tensor:
    """Physical row of each logical id: ``floor(id / rp)``."""
    return torch.div(ids, rp, rounding_mode="floor")


def lookup_rows(emb, ids: torch.Tensor) -> torch.Tensor:
    """Large-bank rows ``ids -> [..., d]`` through the packed layout, as
    the JAX package reads them (embeddings.py:330-348): physical row
    ``p = floor(id / rp)``, wrapped once if negative (``p + R_phys``, as
    JAX indexing does) and clamped into ``[0, R_phys)``, then lane
    ``id mod rp``.  The gradient of a position whose wrapped ``p`` lies
    outside ``[0, R_phys)`` is dropped, as the JAX package's scatter
    (``mode='drop'``) drops it.  From a :class:`BankRowFeed` the physical
    rows are the feed's next ones."""
    rp = emb.rp
    lane = torch.remainder(ids, rp)
    if isinstance(emb, BankRowFeed):
        n = ids.numel()
        phys = emb.take(n).reshape(n, rp, emb.d)
        rows = phys[torch.arange(n, device=ids.device), lane.reshape(n)]
        return rows.reshape(*ids.shape, emb.d)
    shard = getattr(emb, "shard", None)
    if shard is not None:
        return _sharded_lookup_rows(emb, shard, ids, lane)
    n_phys = emb.bank.shape[0] // rp
    p = physical_ids(ids, rp)
    p = torch.where(p < 0, p + n_phys, p)
    rows = emb.bank[p.clamp(0, n_phys - 1) * rp + lane]
    if torch.is_grad_enabled() and emb.bank.requires_grad:
        inside = ((p >= 0) & (p < n_phys)).unsqueeze(-1)
        rows = torch.where(inside, rows, rows.detach())
    return rows


def _sharded_lookup_rows(emb, shard, ids, lane) -> torch.Tensor:
    """:func:`lookup_rows` of a row-sharded bank (``parallel/sharding.py``):
    the physical rows come through the exact exchange
    (``parallel/embedding_sharded.alltoall_lookup`` at
    ``capacity_factor=None``), which is differentiable in this rank's
    rows."""
    from .parallel.embedding_sharded import alltoall_lookup
    rp, d = emb.rp, emb.bank.shape[1]
    n_phys = shard.rows // rp
    p = physical_ids(ids, rp)
    p = torch.where(p < 0, p + n_phys, p)
    phys = emb.bank.view(-1, rp * d)
    rows, _ = alltoall_lookup(phys, p.clamp(0, n_phys - 1), shard.mesh,
                              capacity_factor=None)
    n = ids.numel()
    rows = rows.reshape(n, rp, d)[torch.arange(n, device=ids.device),
                                  lane.reshape(n)]
    rows = rows.reshape(*ids.shape, d)
    if torch.is_grad_enabled() and emb.bank.requires_grad:
        inside = ((p >= 0) & (p < n_phys)).unsqueeze(-1)
        rows = torch.where(inside, rows, rows.detach())
    return rows


def _small_lookup(small: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Side-bank rows; an id outside the side bank reads a zero row."""
    inside = (ids >= 0) & (ids < small.shape[0])
    rows = small[ids.clamp(0, small.shape[0] - 1)]
    return rows * inside.unsqueeze(-1).to(rows.dtype)


def _large_sparse_ids(layout: FeatureLayout, sparse_ids: torch.Tensor):
    """Logical large-bank ids ``[B, F_large]`` of the large sparse fields,
    or None where every sparse field lives in the side bank."""
    split = layout.small_split(SMALL_TABLE_THRESHOLD)
    if not split["large_idx"]:
        return None
    ids = sparse_ids.long()
    return select_columns(ids, split["large_idx"]) + _offsets(
        split["large_offsets"], ids)


def _varlen_ids(layout: FeatureLayout, varlen_ids: torch.Tensor):
    """Logical large-bank ids ``[B, V, maxlen]`` of the varlen fields."""
    split = layout.small_split(SMALL_TABLE_THRESHOLD)
    ids = varlen_ids.long()
    return ids + _offsets(split["varlen_offsets"], ids)[None, :, None]


def lookup_sparse(emb, layout: FeatureLayout,
                  sparse_ids: torch.Tensor) -> torch.Tensor:
    """``[B, S]`` ids -> ``[B, S, d]`` in field order: one gather for the
    large-table fields and one for the side-bank fields."""
    split = layout.small_split(SMALL_TABLE_THRESHOLD)
    small_idx, large_idx = split["small_idx"], split["large_idx"]
    ids = sparse_ids.long()
    parts = []
    if large_idx:
        parts.append(lookup_rows(emb, _large_sparse_ids(layout, ids)))
    if small_idx:
        cols = select_columns(ids, small_idx) + _offsets(
            split["small_offsets"], ids)
        parts.append(_small_lookup(emb.small, cols))
    out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    order = list(large_idx) + list(small_idx)
    if order == sorted(order):
        return out
    inv = sorted(range(len(order)), key=order.__getitem__)
    return select_columns(out, inv)


def lookup_field(emb, layout: FeatureLayout, name: str,
                 ids: torch.Tensor) -> torch.Tensor:
    """One sparse field's embeddings for arbitrary ``ids``, from the bank
    that holds the field (AdaSparse's scenario embedding, the composite
    tables' columns)."""
    split = layout.small_split(SMALL_TABLE_THRESHOLD)
    i = layout.sparse_index(name)
    ids = ids.long()
    if i in split["small_idx"]:
        off = int(split["small_offsets"][split["small_idx"].index(i)])
        return _small_lookup(emb.small, ids + off)
    off = int(split["large_offsets"][split["large_idx"].index(i)])
    return lookup_rows(emb, ids + off)


def lookup_varlen(emb, layout: FeatureLayout,
                  varlen_ids: torch.Tensor) -> torch.Tensor:
    """``[B, V, maxlen]`` -> ``[B, V, d]`` with per-field pooling; id 0 is
    the pad and is masked out."""
    rows = lookup_rows(emb, _varlen_ids(layout, varlen_ids))
    mask = (varlen_ids > 0).unsqueeze(-1)                # [B, V, L, 1]
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


def embed_fields(emb, layout: FeatureLayout, batch) -> torch.Tensor:
    """All field embeddings ``[B, F, d]``: sparse, then pooled varlen.
    ``emb`` is the :class:`Bank` or a :class:`BankRowFeed`."""
    parts = []
    if layout.sparse:
        parts.append(lookup_sparse(emb, layout, batch["sparse"]))
    if layout.varlen:
        parts.append(lookup_varlen(emb, layout, batch["varlen"]))
    if not parts:
        raise ValueError("no sparse features")
    return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


def bank_gather_plan(layout: FeatureLayout, batch, rp: int) -> torch.Tensor:
    """Physical row ids ``[N]`` that :func:`embed_fields` gathers from the
    large bank, in its order of consumption: the large sparse fields
    ``[B, F_large]`` row-major, then the varlen fields (twin of
    embeddings.py:351-366).  Raw ids: out-of-range ones are left to the
    caller's mode."""
    parts = []
    if layout.sparse:
        ids = _large_sparse_ids(layout, batch["sparse"])
        if ids is not None:
            parts.append(ids.reshape(-1))
    if layout.varlen:
        parts.append(_varlen_ids(layout, batch["varlen"]).reshape(-1))
    if not parts:
        return torch.zeros(0, dtype=torch.long)
    return physical_ids(torch.cat(parts) if len(parts) > 1 else parts[0], rp)


def combine_duplicate_rows(ids: torch.Tensor, g: torch.Tensor):
    """Sort ids and sum the gradients of duplicate rows (twin of
    embeddings.py:94-118).  Returns ``(row_ids, summed, valid)``:
    ``row_ids[i]`` is the i-th distinct id in ascending order where
    ``valid[i]``, ``summed[i]`` the sum of the ``g`` rows carrying it, in
    their order in ``ids``; entries past the distinct count have
    ``valid=False`` and meaningless ids.  The sums run in ascending
    position, the order of the dense step's embedding gradient
    (``index_put_`` with ``accumulate``), on the card too."""
    n = ids.shape[0]
    if n == 0:
        return ids, g, torch.zeros(0, dtype=torch.bool, device=ids.device)
    order = torch.argsort(ids, stable=True)
    si = ids[order]
    first = torch.ones(n, dtype=torch.bool, device=ids.device)
    first[1:] = si[1:] != si[:-1]
    seg = torch.cumsum(first, 0) - 1
    summed = torch.zeros_like(g).index_put_((seg,), g[order],
                                            accumulate=True)
    rep = torch.zeros_like(ids).scatter_(0, seg, si)
    valid = torch.arange(n, device=ids.device) <= seg[-1]
    return rep, summed, valid


def eqgemm_combine(ids_fb: torch.Tensor, g_fb: torch.Tensor,
                   shared_rows=()) -> torch.Tensor:
    """Duplicate-summed gradient of every position (twin of
    embeddings.py:149-202): ``s[f, i] = sum_j [ids[f, i] == ids[f, j]]
    g[f, j]`` for ``ids_fb`` ``[F, B]`` and ``g_fb`` ``[F, B, W]``, through
    ``ops/eqgemm.py`` (K3 on the card).  A physical row shared by several
    fields (``shared_rows``: ``((row, (field, ...)), ...)``) gets one total
    over those fields, computed once and broadcast, so every position of
    a row carries byte-identical values."""
    from .ops import eqgemm
    s = eqgemm.eqgemm_positions(ids_fb, g_fb)
    if not shared_rows:
        return s
    rows = device_constant(tuple(r for r, _ in shared_rows), ids_fb.device,
                           ids_fb.dtype)
    member = device_constant(
        tuple(tuple(f in fields for f in range(ids_fb.shape[0]))
              for _, fields in shared_rows), ids_fb.device, torch.bool)
    hit = (ids_fb[None] == rows[:, None, None]) & member[:, :, None]
    per_field = torch.einsum("kfb,fbw->kfw", hit.to(g_fb.dtype), g_fb)
    total = per_field.sum(dim=1)                          # [K, W]
    which = hit.to(torch.uint8).argmax(dim=0)             # [F, B]
    return torch.where(hit.any(dim=0).unsqueeze(-1), total[which], s)


def l2_loss(emb, l2: float):
    """Full-table L2 over the bank and the side bank, matching reference
    basemodel.py:519-535 (the JAX twin's ``l2_loss``: the same values, the
    same zero pad rows).  Under a :class:`BankRowFeed` the bank's term is
    left out: the sparse bank updates account for it themselves."""
    tables = [] if isinstance(emb, BankRowFeed) else [emb.bank]
    if emb.small is not None:
        tables.append(emb.small)
    if l2 <= 0.0 or not tables:
        like = emb.rows if isinstance(emb, BankRowFeed) else emb.bank
        return torch.zeros((), dtype=like.dtype, device=like.device)
    return l2 * sum(torch.sum(torch.square(t)) for t in tables)


class LinearModel(nn.Module):
    """The first-order linear model (reference basemodel.py:34-92): a bank
    of dimension 1 over the layout's fields and, with dense columns, a
    weight ``dense_w`` ``[dense_dim, 1]``, both N(0, init_std)."""

    def __init__(self, gen: torch.Generator, layout: FeatureLayout, *,
                 init_std: float = 1e-4):
        super().__init__()
        self.emb = bank_init(gen, layout, dim=1, init_std=init_std)
        self.dense_w = nn.Parameter(init.normal(
            gen, (layout.dense_dim, 1), init_std)) \
            if layout.dense_dim > 0 else None

    def forward(self, layout: FeatureLayout, batch) -> torch.Tensor:
        """The first-order logit ``[B, 1]``: the sum of the fields'
        1-dim embeddings, plus the dense columns' dot with ``dense_w``."""
        logit = embed_fields(self.emb, layout, batch).sum(dim=(1, 2))[:, None]
        if self.dense_w is not None and "dense" in batch:
            logit = logit + batch["dense"] @ self.dense_w
        return logit

    def l2(self, l2: float) -> torch.Tensor:
        """The bank's full-table L2 and the dense weights'."""
        loss = l2_loss(self.emb, l2)
        if self.dense_w is not None and l2 > 0.0:
            loss = loss + l2 * torch.sum(torch.square(self.dense_w))
        return loss
