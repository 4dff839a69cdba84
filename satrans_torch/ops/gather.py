"""Row gather over several arrays (K4): Python side of
``csrc/bank_rows.cu:satrans_gather_rows``, twin of
``satrans_tpu/ops/pallas/gather.py:gather_rows``.

:func:`gather_rows` reads ``arr[ids]`` from each array with one id set: on
a CUDA tensor it launches the kernel (and adds one to ``launches``) or
raises; on a CPU tensor it runs :func:`gather_rows_reference`.  Ids outside
``[0, R)`` are clamped, as ``jnp.take(mode='clip')`` and every caller of
the TPU kernel clamp them.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ._build import check_rows, kernel_fn, stream_of

launches = 0


def gather_rows_reference(arrays: Sequence[torch.Tensor],
                          ids: torch.Tensor) -> tuple:
    """Plain PyTorch version: ``arr[clamp(ids, 0, R-1)]`` per array."""
    idx = ids.clamp(0, arrays[0].shape[0] - 1)
    return tuple(a.index_select(0, idx) for a in arrays)


def gather_rows(arrays: Sequence[torch.Tensor], ids: torch.Tensor) -> tuple:
    """``tuple(arr[ids] for arr in arrays)`` for ``[R, W]`` arrays and
    ``[N]`` ids: ``[N, W]`` each."""
    arrays = tuple(arrays)
    if ids.device.type == "cpu":
        return gather_rows_reference(arrays, ids)
    check_rows(arrays, ids, "gather_rows")
    n, (rows, w) = ids.shape[0], arrays[0].shape
    outs = tuple(torch.empty(n, w, dtype=a.dtype, device=a.device)
                 for a in arrays)
    if n == 0:
        return outs
    ptrs = [a.data_ptr() for a in arrays] + [0] * (3 - len(arrays))
    optrs = [o.data_ptr() for o in outs] + [0] * (3 - len(arrays))
    fn = kernel_fn("bank_rows", "satrans_gather_rows",
                   [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7)
    err = fn(ids.data_ptr(), n, rows, w, len(arrays), *ptrs, *optrs,
             stream_of(ids))
    if err:
        raise RuntimeError(f"gather_rows launch failed: CUDA error {err}")
    global launches
    launches += 1
    return outs
