"""Typed feature specifications and batch layout (twin of
``satrans_tpu/features.py``; numpy only).

A batch is a dict of typed arrays::

    {"sparse": int32 [B, S],          # one column per sparse field
     "dense":  float32 [B, D],        # one column per dense dim
     "varlen": int32 [B, V, maxlen]}  # padded id sequences (0 = pad)

Every sparse/varlen field's embedding rows live in one fused bank (see
:mod:`satrans_torch.embeddings`); :class:`FeatureLayout` computes the
per-field row offsets into that bank.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np

BATCH_DTYPES = {"sparse": np.int32, "dense": np.float32, "varlen": np.int32}


@dataclasses.dataclass(frozen=True)
class SparseFeature:
    """A categorical field embedded into ``dim`` floats; ``vocab`` already
    includes the padding/offset rows (the reference uses ``data_max + 2``)."""

    name: str
    vocab: int
    dim: int = 32
    # Fields sharing an embedding table use the same ``embedding_name``.
    embedding_name: str | None = None

    @property
    def table_name(self) -> str:
        return self.embedding_name or self.name


@dataclasses.dataclass(frozen=True)
class DenseFeature:
    """A real-valued field of ``dimension`` floats."""

    name: str
    dimension: int = 1


@dataclasses.dataclass(frozen=True)
class VarLenSparseFeature:
    """A padded variable-length id-list field with max/mean/sum pooling.
    Id ``0`` is the pad value."""

    name: str
    vocab: int
    dim: int
    maxlen: int
    combiner: str = "max"  # 'max' | 'mean' | 'sum'
    embedding_name: str | None = None

    @property
    def table_name(self) -> str:
        return self.embedding_name or self.name


Feature = SparseFeature | DenseFeature | VarLenSparseFeature


class FeatureLayout:
    """Column bookkeeping for a fixed feature-column list: stable field
    order, per-table bank offsets, the side-bank split and typed batches."""

    def __init__(self, columns: Sequence[Feature]):
        self.sparse = [c for c in columns if isinstance(c, SparseFeature)]
        self.dense = [c for c in columns if isinstance(c, DenseFeature)]
        self.varlen = [c for c in columns
                       if isinstance(c, VarLenSparseFeature)]

        self.sparse_names = [c.name for c in self.sparse]
        self.dense_names = [c.name for c in self.dense]
        self.varlen_names = [c.name for c in self.varlen]

        dims = {c.dim for c in self.sparse} | {c.dim for c in self.varlen}
        if len(dims) > 1:
            raise ValueError(
                f"All sparse embedding dims must match for the fused bank, "
                f"got {dims}")
        self.embedding_dim = dims.pop() if dims else 0
        self.dense_dim = sum(c.dimension for c in self.dense)

        # one contiguous row range per distinct table
        self.table_offsets: dict[str, int] = {}
        self.table_vocabs: dict[str, int] = {}
        offset = 0
        for c in self.sparse + self.varlen:
            t = c.table_name
            if t not in self.table_offsets:
                self.table_offsets[t] = offset
                self.table_vocabs[t] = c.vocab
                offset += c.vocab
            elif self.table_vocabs[t] != c.vocab:
                raise ValueError(f"Conflicting vocab for shared table {t!r}")
        self.total_rows = offset
        self._sparse_index = {n: i for i, n in enumerate(self.sparse_names)}
        self._split_cache: dict[int, dict] = {}

    @property
    def num_fields(self) -> int:
        """Fields entering field-wise attention: each sparse and each pooled
        varlen feature."""
        return len(self.sparse) + len(self.varlen)

    def sparse_index(self, name: str) -> int:
        return self._sparse_index[name]

    @property
    def input_dim(self) -> int:
        """Flattened DNN input width: every field's embedding and the dense
        columns (reference basemodel.py:489-507)."""
        return self.num_fields * self.embedding_dim + self.dense_dim

    def small_split(self, threshold: int = 256):
        """Partition tables by vocab: tables with vocab <= threshold (and no
        varlen user) live in the compact side bank.

        Returns a dict with ``small_idx`` / ``large_idx`` (sparse field
        positions per class), ``small_offsets`` (first side-bank row per
        small field), ``small_rows``, ``large_offsets`` (first large-bank
        row per large sparse field), ``varlen_offsets`` and ``large_rows``.
        """
        if threshold in self._split_cache:
            return self._split_cache[threshold]
        varlen_tables = {c.table_name for c in self.varlen}
        small_tables: dict[str, int] = {}
        large_tables: dict[str, int] = {}
        small_rows = large_rows = 0
        for c in self.sparse + self.varlen:
            t = c.table_name
            if t in small_tables or t in large_tables:
                continue
            if c.vocab <= threshold and t not in varlen_tables:
                small_tables[t] = small_rows
                small_rows += c.vocab
            else:
                large_tables[t] = large_rows
                large_rows += c.vocab
        small_idx = [i for i, c in enumerate(self.sparse)
                     if c.table_name in small_tables]
        large_idx = [i for i, c in enumerate(self.sparse)
                     if c.table_name in large_tables]
        out = {
            "small_idx": small_idx,
            "large_idx": large_idx,
            "small_offsets": np.asarray(
                [small_tables[self.sparse[i].table_name] for i in small_idx],
                np.int32),
            "small_rows": small_rows,
            "large_offsets": np.asarray(
                [large_tables[self.sparse[i].table_name] for i in large_idx],
                np.int32),
            "varlen_offsets": np.asarray(
                [large_tables[c.table_name] for c in self.varlen], np.int32),
            "large_rows": large_rows,
        }
        self._split_cache[threshold] = out
        return out

    def validate_ids(self, data: dict[str, np.ndarray]) -> None:
        """Raise on out-of-vocab ids (host side, one pass per column)."""
        for c in list(self.sparse) + list(self.varlen):
            col = np.asarray(data[c.name])
            lo, hi = int(col.min()), int(col.max())
            if lo < 0 or hi >= c.vocab:
                raise ValueError(
                    f"feature {c.name!r}: ids in [{lo}, {hi}] exceed vocab "
                    f"{c.vocab}")

    def columns(self, data: dict[str, np.ndarray]
                ) -> tuple[int, dict[str, list[np.ndarray]]]:
        """The rows of a {name: column array} dict and its columns by part
        of a batch, in the layout's order but not assembled: 'sparse'
        ``[n]``, 'dense' ``[n, k]`` float32, 'varlen' ``[n, L]``; a batch
        holds each part as ``BATCH_DTYPES`` says.  Set
        ``SATRANS_VALIDATE=1`` to id-range-check every column first."""
        if os.environ.get("SATRANS_VALIDATE", "0") == "1":
            self.validate_ids(data)
        n = len(next(iter(data.values())))
        cols: dict[str, list[np.ndarray]] = {}
        if self.sparse:
            cols["sparse"] = [np.asarray(data[name]).reshape(n)
                              for name in self.sparse_names]
        if self.dense:
            cols["dense"] = [np.asarray(data[name], dtype=np.float32
                                        ).reshape(n, -1)
                             for name in self.dense_names]
        if self.varlen:
            cols["varlen"] = [np.asarray(data[name]).reshape(n, -1)
                              for name in self.varlen_names]
        return n, cols

    def batch_from_dict(self, data: dict[str, np.ndarray]
                        ) -> dict[str, np.ndarray]:
        """Assemble a typed batch from a {name: column array} dict
        (:meth:`columns`): the ids ``[n, S]``, the dense values ``[n, D]``,
        the varlen ids ``[n, V, L]``."""
        return {k: (np.concatenate if k == "dense" else np.stack)(
                    parts, axis=1).astype(BATCH_DTYPES[k], copy=False)
                for k, parts in self.columns(data)[1].items()}
