"""Probe: per-row bulk copies of the TMA against the library's row gather
(P2; twin of ``satrans_tpu/bench/pallas_gather_probe.py``).

    python3 -m satrans_torch.bench.gather_probe
    SATRANS_BENCH_TINY=1 python3 -m satrans_torch.bench.gather_probe

:func:`row_dma_gather` is the port of the JAX probe's ``pallas_gather``
(pallas_gather_probe.py:87, ``pallas_call`` :96, body ``_gather_kernel``
:46): ``tuple(src[ids] for src in srcs)`` for 1 to 3 float32 arrays ``[R,
W]`` and int64 ids ``[N]`` in ``[0, R)`` (duplicates allowed), by the
hand-written CUDA kernel of ``csrc/row_dma.cu`` (one block of one warp a
run of ``rb`` rows: one bulk copy a row into shared memory, then one bulk
copy of the block's ``[rb, W]`` slice out, array after array).  On a CUDA
tensor it launches the kernel (and adds one to ``launches``) or raises; on
a CPU tensor it runs :func:`row_dma_gather_reference`.  The wrapper
refuses an ``N`` that ``rb`` does not divide, as the JAX function's grid
of ``N // rb`` leaves such a tail unwritten.

``variant``: ``"bulk"``, one mbarrier expecting the block's byte total and
one wait (the JAX probe's ``bulkwait``); ``"slots"``, the rows
round-robin over 16 mbarriers and a wait on each (``unroll``).

``main()`` holds every variant and ``rb``, on one array and on three,
against the plain version exactly on the probe's shape (arrays [1,638,400,
128], N = 81,920 ids with duplicates; ``TINY``: [4096, 128], N = 1024),
times each with CUDA events over ``REPS`` calls beside the plain version,
``index_select`` (the library), K4 (``ops/gather.py``) and a null body,
and prints one JSON line with the bounds (bytes: the ids, each distinct
row read once, every output row written) and the card's name and power
limit.  Each call's outputs are kept to the end of its timing; eager
PyTorch runs every call, so nothing else needs to consume them.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import os
import sys
from typing import Sequence

import numpy as np
import torch

from ..ops import gather, profiling
from ..ops._build import check_rows, kernel_fn, stream_of
from ..utils import make_generator, resolve_device
from .scatter_probe import RBS, VARIANTS, check_aligned, check_args

TINY = os.environ.get("SATRANS_BENCH_TINY", "") == "1"
ROWS = 4096 if TINY else 1_638_400
N = 1024 if TINY else 81_920
W = 128
REPS = 2 if TINY else 16

launches = 0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def row_dma_gather_reference(srcs: Sequence[torch.Tensor],
                             ids: torch.Tensor) -> tuple:
    """Plain PyTorch version: ``src.index_select(0, ids)`` per array."""
    return tuple(s.index_select(0, ids) for s in srcs)


def row_dma_gather(srcs: Sequence[torch.Tensor], ids: torch.Tensor, *,
                   variant: str = "bulk", rb: int = 256) -> tuple:
    """``tuple(src[ids] for src in srcs)``, ``[N, W]`` each.  The kernel
    clamps an id outside ``[0, R)`` (the caller's error), so it reads no
    row outside the arrays."""
    srcs = tuple(srcs)
    n, w = ids.shape[0], srcs[0].shape[-1]
    check_args(variant, rb, n, w)
    if ids.device.type == "cpu":
        return row_dma_gather_reference(srcs, ids)
    check_rows(srcs, ids, "row_dma_gather")
    outs = tuple(torch.empty(n, w, dtype=s.dtype, device=s.device)
                 for s in srcs)
    check_aligned(*srcs, *outs)
    ptrs = [s.data_ptr() for s in srcs] + [0] * (3 - len(srcs))
    optrs = [o.data_ptr() for o in outs] + [0] * (3 - len(srcs))
    fn = kernel_fn("row_dma", "satrans_row_dma_gather",
                   [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 7)
    err = fn(ids.data_ptr(), n, srcs[0].shape[0], w, len(srcs), rb,
             variant == "slots", *ptrs, *optrs, stream_of(ids))
    if err:
        raise RuntimeError(f"row_dma_gather launch failed: CUDA error {err}")
    global launches
    launches += 1
    return outs


def bound_ms(n: int, distinct: int, w: int, arrays: int) -> float:
    """The least time of one call at the HBM rate: the ids read, each
    distinct row of each array read once, every output row written."""
    return 1e3 * (8 * n + arrays * 4 * w * (distinct + n)) \
        / profiling.H100_HBM_BYTES_PER_S


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    card = profiling.card_name(dev)
    rng = np.random.default_rng(0)
    # the production distribution: batch ids, with duplicates
    ids = torch.from_numpy(rng.integers(0, ROWS, size=N).astype(
        np.int64)).to(dev)
    gen = make_generator(0, dev)
    banks = [torch.randn(ROWS, W, generator=gen, device=dev)
             for _ in range(3)]

    # correctness first: every variant and rb on one array and on three
    errors = {}
    cases = list(itertools.product(VARIANTS, RBS, (1, 3)))
    for variant, rb, arrays in cases:
        key = f"tma_{variant}_rb{rb}_x{arrays}"
        got = row_dma_gather(banks[:arrays], ids, variant=variant, rb=rb)
        want = row_dma_gather_reference(banks[:arrays], ids)
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        log(f"[{key}] max abs err vs index_select: {err}")
        if err != 0.0:
            raise RuntimeError(f"row_dma_gather {key} differs from the "
                               f"plain version by {err}")
        errors[key] = err
    del got, want

    def timed(name, fn):
        # one untimed pass of REPS calls first: the caching allocator then
        # holds the outputs' memory, and no timed call waits for cudaMalloc
        kept = [fn(ids) for _ in range(REPS)]
        kept.clear()
        ms = 1e3 * profiling.time_fn(lambda: kept.append(fn(ids)),
                                     iters=REPS, warmup=0, device=dev)
        log(f"[{name}] {ms:.4f} ms/gather ({REPS} calls)")
        return ms

    results = {}
    for variant, rb, arrays in cases:
        results[f"tma_{variant}_rb{rb}_x{arrays}"] = timed(
            f"tma_{variant}_rb{rb}_x{arrays}",
            lambda i, variant=variant, rb=rb, a=arrays: row_dma_gather(
                banks[:a], i, variant=variant, rb=rb))
    for arrays in (1, 3):
        results[f"plain_x{arrays}"] = timed(
            f"plain_x{arrays}",
            lambda i, a=arrays: row_dma_gather_reference(banks[:a], i))
        results[f"index_select_x{arrays}"] = timed(
            f"index_select_x{arrays}",
            lambda i, a=arrays: [b.index_select(0, i) for b in banks[:a]])
        results[f"k4_gather_rows_x{arrays}"] = timed(
            f"k4_gather_rows_x{arrays}",
            lambda i, a=arrays: gather.gather_rows(banks[:a], i))
    results["null_body"] = timed("null_body", lambda i: i)
    distinct = torch.unique(ids).numel()
    out = {
        "workload": f"gather {N} rows of {W} fp32 from [{ROWS}, {W}] "
                    f"(x1 and x3 arrays, {distinct} distinct rows)",
        "method": f"{REPS} calls between two CUDA events, one synchronize"
        if dev.type == "cuda" else f"{REPS} calls, host clock (CPU)",
        "ms": results, "max_abs_err": errors,
        "bound_ms": {f"x{a}": bound_ms(N, distinct, W, a) for a in (1, 3)},
        "bound_by": "bytes", "device": str(dev), "card": card}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
