"""Which rows of the global batch this rank's train-mode forward holds.

The JAX mesh runs one program over the global batch, so its dropout masks
and its batch-wide statistics are the global batch's.  The Trainer sets
:func:`batch_rows` around each train-mode forward under a mesh;
``ops/threefry.random_bits`` then draws the bits of this rank's rows of
the global shape (threefry is partitionable: element ``i`` hashes counter
``i``), ``nn/core.batch_norm_apply`` sums its moments over the ranks, and
the SATrans kernels take the global batch's dropout tile with their tile
index offset by the rank's first tile.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple


class BatchRows(NamedTuple):
    """Rows ``[start, start + local)`` of a global batch of ``total``."""
    start: int
    local: int
    total: int
    mesh: object


_CURRENT: list = [None]


def current() -> BatchRows | None:
    return _CURRENT[0]


@contextlib.contextmanager
def batch_rows(start: int, local: int, total: int, mesh):
    prev = _CURRENT[0]
    _CURRENT[0] = BatchRows(int(start), int(local), int(total), mesh)
    try:
        yield
    finally:
        _CURRENT[0] = prev


def global_offset(shape) -> int:
    """The row-major offset of this rank's part of a draw of ``shape``
    whose leading axis is ``k`` rows an example of the local batch (``0``
    outside a sharded forward or for a shape not of that kind)."""
    cur = _CURRENT[0]
    if cur is None or cur.start == 0 or not len(shape) or shape[0] == 0 or \
            shape[0] % cur.local:
        return 0
    inner = 1
    for s in shape[1:]:
        inner *= int(s)
    return cur.start * (int(shape[0]) // cur.local) * inner


def all_reduce_sum(t):
    """``t`` summed over the ranks of the current sharded forward, with
    the gradient summed back (``torch.distributed.nn``); ``t`` itself
    outside one."""
    cur = _CURRENT[0]
    if cur is None or cur.mesh.group is None:
        return t
    from torch.distributed.nn import functional as dist_fn
    return dist_fn.all_reduce(t, group=cur.mesh.group)
