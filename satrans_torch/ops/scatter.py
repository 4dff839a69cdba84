"""Row scatter-set over several arrays, in place (K2): Python side of
``csrc/bank_rows.cu:satrans_scatter_rows``, twin of
``satrans_tpu/ops/pallas/scatter.py:scatter_rows_set``.

:func:`scatter_rows_set` writes ``arr[ids[i]] = vals[i]`` into each array:
on a CUDA tensor it launches the kernel (and adds one to ``launches``) or
raises; on a CPU tensor it runs :func:`scatter_rows_set_reference`.

Semantics of the TPU kernel (scatter.py:19-28): ids lie in ``[0, R)``, or,
with ``drop_oob``, any id outside is skipped; duplicate ids must carry
byte-identical values (the writes race); an empty ``ids`` is a no-op.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ._build import check_rows, kernel_fn, stream_of

launches = 0


def scatter_rows_set_reference(arrays: Sequence[torch.Tensor],
                               ids: torch.Tensor,
                               values: Sequence[torch.Tensor], *,
                               drop_oob: bool = False) -> tuple:
    """Plain PyTorch version (``index_put_``)."""
    if drop_oob:
        keep = (ids >= 0) & (ids < arrays[0].shape[0])
        ids = ids[keep]
        values = [v[keep] for v in values]
    for a, v in zip(arrays, values):
        a.index_put_((ids,), v)
    return tuple(arrays)


def scatter_rows_set(arrays: Sequence[torch.Tensor], ids: torch.Tensor,
                     values: Sequence[torch.Tensor], *,
                     drop_oob: bool = False) -> tuple:
    """``arrays[a][ids[i]] = values[a][i]`` in place for ``[R, W]`` arrays,
    ``[N]`` ids and ``[N, W]`` values; returns the arrays.  The kernel
    never writes outside an array: without ``drop_oob`` an id outside
    ``[0, R)`` is the caller's error and is skipped there too."""
    arrays, values = tuple(arrays), tuple(values)
    if len(arrays) != len(values):
        raise ValueError(f"{len(arrays)} arrays, {len(values)} value sets")
    if ids.device.type == "cpu":
        return scatter_rows_set_reference(arrays, ids, values,
                                          drop_oob=drop_oob)
    check_rows(arrays, ids, "scatter_rows_set")
    n, (rows, w) = ids.shape[0], arrays[0].shape
    for v in values:
        if (v.device != ids.device or v.dtype != torch.float32
                or tuple(v.shape) != (n, w) or not v.is_contiguous()):
            raise ValueError("scatter_rows_set: values must be contiguous "
                             f"float32 [{n}, {w}] on {ids.device}")
    if n == 0:
        return arrays
    ptrs = [a.data_ptr() for a in arrays] + [0] * (3 - len(arrays))
    vptrs = [v.data_ptr() for v in values] + [0] * (3 - len(arrays))
    fn = kernel_fn("bank_rows", "satrans_scatter_rows",
                   [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7)
    err = fn(ids.data_ptr(), n, rows, w, len(arrays), *ptrs, *vptrs,
             stream_of(ids))
    if err:
        raise RuntimeError(f"scatter_rows_set launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1
    return arrays
