"""Profiling and timing helpers (twin of ``satrans_tpu/ops/profiling.py``).

* :func:`trace` - a context manager around ``torch.profiler`` that writes
  a TensorBoard-loadable trace into a directory.
* :func:`time_fn` - the time of one call of ``fn``: on a CUDA device CUDA
  events around ``iters`` calls and one synchronize at the end, so that
  the host keeps queueing work while the card runs; on the CPU, only when
  asked for, the host clock.
* :func:`device_busy_ms` - the device time of one call, summed over the
  kernels and copies a ``torch.profiler`` trace of it saw.
* :func:`card_name` - the card's name and power limit, to stand beside
  every number taken on it.
* :func:`roofline` - bytes and FLOP of a measured call against the card's
  peaks (defaults: the H100 SXM data sheet, float32 outside the tensor
  cores and HBM3).
"""

from __future__ import annotations

import contextlib
import subprocess
import time

import torch

from ..utils import resolve_device

# H100 SXM data-sheet peaks at 700 W
H100_PEAK_F32_FLOPS = 67e12
# a product in 3xTF32 on the tensor cores issues three TF32 ones
H100_PEAK_TF32X3_FLOPS = 495e12 / 3
H100_HBM_BYTES_PER_S = 3.35e12


def card_name(device) -> str | None:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (a
    card below its 700 W runs slower under load); None on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block on the CPU and, where there is one, the card; the
    trace goes to ``logdir`` as ``*.pt.trace.json``."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


def time_fn(fn, *args, iters: int = 10, warmup: int = 2, device="cuda"):
    """Seconds per call of ``fn(*args)`` over ``iters`` calls after
    ``warmup`` (at least one).  On a CUDA device: CUDA events recorded on
    the current stream before the first and after the last call, one
    synchronize at the end.  On the CPU (``device="cpu"``): the host
    clock."""
    dev = resolve_device(device)
    for _ in range(max(warmup, 1)):
        fn(*args)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    with torch.cuda.device(dev):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def device_ops(prof) -> list[tuple[str, float, int]]:
    """``[(name, device ms, count)]`` of the kernels and copies a
    ``torch.profiler`` run saw on the device, largest first.  Spans of
    ``record_function`` annotations (such as ``Optimizer.step``) also
    appear on the device's timeline; they enclose kernels already counted
    and are left out."""
    from torch.autograd import DeviceType
    by_name = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.self_device_time_total / 1e3, n + 1)
    return sorted(((k, ms, n) for k, (ms, n) in by_name.items()),
                  key=lambda t: -t[1])


def device_busy_ms(fn, *args) -> float | None:
    """Device milliseconds of one call of ``fn(*args)``: the sum of the
    kernels' and copies' device time in a ``torch.profiler`` trace of it.
    None where the trace holds no device time (no card, or a profiler that
    cannot trace it): not measured."""
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        return None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    ops = device_ops(prof)
    return sum(ms for _, ms, _ in ops) if ops else None


def roofline(seconds: float, flops: float = 0.0, bytes_moved: float = 0.0,
             peak_flops: float = H100_PEAK_F32_FLOPS,
             peak_bw: float = H100_HBM_BYTES_PER_S) -> dict:
    """Fraction-of-peak report for a measured time, the JAX package's
    fields and arithmetic."""
    out = {"seconds": seconds}
    if flops:
        out["tflops"] = flops / seconds / 1e12
        out["flops_frac_of_peak"] = flops / seconds / peak_flops
    if bytes_moved:
        out["gb_per_s"] = bytes_moved / seconds / 1e9
        out["bw_frac_of_peak"] = bytes_moved / seconds / peak_bw
    bound = "compute" if flops / max(peak_flops, 1) > \
        bytes_moved / max(peak_bw, 1) else "memory"
    out["bound"] = bound
    out["speed_of_light_s"] = max(flops / peak_flops,
                                  bytes_moved / peak_bw)
    return out
