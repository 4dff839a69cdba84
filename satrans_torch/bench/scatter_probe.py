"""Probe: per-row bulk copies of the TMA against the library's row scatter
(P1; twin of ``satrans_tpu/bench/pallas_scatter_probe.py``).

    python3 -m satrans_torch.bench.scatter_probe
    SATRANS_BENCH_TINY=1 python3 -m satrans_torch.bench.scatter_probe

:func:`row_dma_scatter` is the port of the JAX probe's ``pallas_scatter``
(pallas_scatter_probe.py:109, ``pallas_call`` :118, body
``_scatter_kernel`` :42): ``bank[ids[i]] = vals[i]`` in place for a
float32 bank ``[R, W]``, sorted unique int64 ids ``[N]`` in ``[0, R)`` and
vals ``[N, W]``, by the hand-written CUDA kernel of ``csrc/row_dma.cu``
(one block of one warp a run of ``rb`` rows: one bulk copy of the block's
vals into shared memory, then one bulk copy a row out to the bank).  On a
CUDA tensor it launches the kernel (and adds one to ``launches``) or
raises; on a CPU tensor it runs :func:`row_dma_scatter_reference`.  As the
JAX function runs a grid of ``N // rb`` and never writes a tail past it,
the wrapper refuses an ``N`` that ``rb`` does not divide.

``variant`` is the drain scheme (the JAX probe's ``bulkwait``, ``loop``
and ``unroll``): ``"bulk"``, one bulk group for the block's rows and one
wait; ``"slots"``, the rows round-robin over 16 lanes, each lane's stores
one bulk group and a wait on each.

``main()`` holds every variant and ``rb`` against the plain version
exactly on the probe's shape (bank [1,638,400, 128], N = 81,920; ``TINY``:
[4096, 128], N = 1024), times each with CUDA events over ``REPS`` calls
(the vals vary by ``+ i`` from call to call, as in the JAX probe),
beside the plain version, ``index_copy_`` (the library), K2
(``ops/scatter.py``) on the one array and a null body, and prints one
JSON line with the bound (bytes) and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import os
import sys

import numpy as np
import torch

from ..ops import profiling, scatter
from ..ops._build import check_rows, kernel_fn, stream_of
from ..utils import resolve_device

TINY = os.environ.get("SATRANS_BENCH_TINY", "") == "1"
ROWS = 4096 if TINY else 1_638_400
N = 1024 if TINY else 81_920
W = 128
REPS = 2 if TINY else 16
RBS = (64, 128, 256)             # rows a block
VARIANTS = ("bulk", "slots")
MAX_SMEM = 227 * 1024            # a block's shared memory on the H100

launches = 0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def check_args(variant: str, rb: int, n: int, w: int) -> None:
    """Raise ``ValueError`` unless ``variant`` and ``rb`` are the kernel's
    and ``rb`` divides ``n``, ``w`` a multiple of 4 (16-byte rows) whose
    ``rb`` rows fit a block's shared memory."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {VARIANTS}")
    if rb not in RBS:
        raise ValueError(f"rb {rb} is not one of {RBS}")
    if n % rb:
        raise ValueError(f"N = {n} is not a multiple of rb = {rb}: the "
                         "probe's grid of N // rb blocks writes no tail")
    if w % 4 or rb * w * 4 > MAX_SMEM:
        raise ValueError(f"W = {w}: rows must be a multiple of 16 bytes "
                         f"and rb rows at most {MAX_SMEM} bytes")


def check_aligned(*tensors) -> None:
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("bulk copies need 16-byte aligned tensors")


def row_dma_scatter_reference(bank: torch.Tensor, ids: torch.Tensor,
                              vals: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``bank.index_copy_(0, ids, vals)``."""
    return bank.index_copy_(0, ids, vals)


def row_dma_scatter(bank: torch.Tensor, ids: torch.Tensor,
                    vals: torch.Tensor, *, variant: str = "bulk",
                    rb: int = 256) -> torch.Tensor:
    """``bank[ids[i]] = vals[i]`` in place; returns ``bank``.  An id
    outside ``[0, R)`` is the caller's error and the kernel skips it."""
    n, w = ids.shape[0], bank.shape[-1]
    check_args(variant, rb, n, w)
    if ids.device.type == "cpu":
        return row_dma_scatter_reference(bank, ids, vals)
    check_rows([bank], ids, "row_dma_scatter")
    if (vals.device != ids.device or vals.dtype != torch.float32
            or tuple(vals.shape) != (n, w) or not vals.is_contiguous()):
        raise ValueError("row_dma_scatter: vals must be contiguous float32 "
                         f"[{n}, {w}] on {ids.device}")
    check_aligned(bank, vals)
    fn = kernel_fn("row_dma", "satrans_row_dma_scatter",
                   [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    err = fn(ids.data_ptr(), n, bank.shape[0], w, rb, variant == "slots",
             bank.data_ptr(), vals.data_ptr(), stream_of(ids))
    if err:
        raise RuntimeError(f"row_dma_scatter launch failed: CUDA error {err}")
    global launches
    launches += 1
    return bank


def bound_ms(n: int, w: int) -> float:
    """The least time of one call at the HBM rate: the ids and the vals
    read once, ``n`` rows written (the ids are unique)."""
    return 1e3 * (8 * n + 2 * 4 * w * n) / profiling.H100_HBM_BYTES_PER_S


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    card = profiling.card_name(dev)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(np.sort(rng.choice(ROWS, size=N, replace=False))
                           .astype(np.int64)).to(dev)
    vals = torch.from_numpy(rng.standard_normal((N, W)).astype(
        np.float32)).to(dev)
    bank = torch.zeros(ROWS, W, device=dev)
    want = row_dma_scatter_reference(torch.zeros_like(bank), ids, vals)

    # correctness first: every variant and rb, exactly
    errors = {}
    for variant, rb in itertools.product(VARIANTS, RBS):
        got = row_dma_scatter(bank.zero_(), ids, vals, variant=variant,
                              rb=rb)
        err = (got - want).abs().max().item()
        log(f"[tma_{variant}_rb{rb}] max abs err vs index_copy_: {err}")
        if err != 0.0:
            raise RuntimeError(f"row_dma_scatter {variant} rb {rb} differs "
                               f"from the plain version by {err}")
        errors[f"tma_{variant}_rb{rb}"] = err
    del want

    # the vals of call i are vals + i, made before the clock starts
    reps = [vals + i for i in range(REPS)]

    def timed(name, fn):
        it = itertools.cycle(reps)
        # one untimed pass of REPS calls, so that the timed one finds
        # every lazy set-up done
        ms = 1e3 * profiling.time_fn(lambda: fn(bank, ids, next(it)),
                                     iters=REPS, warmup=REPS, device=dev)
        log(f"[{name}] {ms:.4f} ms/scatter ({REPS} calls)")
        return ms

    results = {}
    for variant, rb in itertools.product(VARIANTS, RBS):
        results[f"tma_{variant}_rb{rb}"] = timed(
            f"tma_{variant}_rb{rb}",
            lambda b, i, v, variant=variant, rb=rb: row_dma_scatter(
                b, i, v, variant=variant, rb=rb))
    results["plain"] = timed("plain", row_dma_scatter_reference)
    results["index_copy_"] = timed(
        "index_copy_", lambda b, i, v: b.index_copy_(0, i, v))
    results["k2_scatter_rows_set"] = timed(
        "k2_scatter_rows_set",
        lambda b, i, v: scatter.scatter_rows_set([b], i, [v]))
    results["null_body"] = timed("null_body", lambda b, i, v: b)
    out = {
        "workload": f"scatter {N} sorted rows of {W} fp32 into "
                    f"[{ROWS}, {W}]",
        "method": f"{REPS} calls between two CUDA events, one synchronize"
        if dev.type == "cuda" else f"{REPS} calls, host clock (CPU)",
        "ms": results, "max_abs_err": errors, "bound_ms": bound_ms(N, W),
        "bound_by": "bytes", "device": str(dev), "card": card}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
