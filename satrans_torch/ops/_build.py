"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  Libraries go to ``_build/``
beside the package sources, named by a hash of the sources and the flags:
a changed source is rebuilt at its first use.  Several sources build in
parallel, one ``nvcc`` each.

Nothing here runs at import time; this machine needs ``nvcc`` only when a
kernel is first launched or :func:`build` is called.  Every wrapper in
``ops/`` reaches its kernel through :func:`kernel_fn`, and checks its
operands with the helpers below.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Sequence

import torch

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
_SM_COUNT: dict[int, int] = {}
_FNS: dict[str, ctypes._CFuncPtr] = {}
# nvcc's output (including ptxas register and spill counts) per source
build_log: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(dep.read_bytes())
    return src, BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, float]:
    """Compile the named sources (default: all) that are not built yet,
    all ``nvcc`` processes at once.  Returns seconds per source built."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(exist_ok=True)
    jobs = {}
    for name in names:
        src, out = _target(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, tmp, out, t0) in jobs.items():
        build_log[name], _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode:
            failed.append(name)
        else:
            os.replace(tmp, out)  # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(build_log[n] for n in failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        _, out = _target(name)
        if not out.exists():
            build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(out))
    return lib


def kernel_fn(source: str, name: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry ``name`` of ``csrc/<source>.cu`` (returning an int),
    built at first use."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(load(source), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, for a kernel's launch."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_rows(arrays: Sequence[torch.Tensor], ids: torch.Tensor,
               what: str) -> None:
    """Raise unless ``arrays`` are contiguous float32 ``[R, W]`` tensors of
    one shape on ``ids``' CUDA device (at most 3) and ``ids`` is a
    contiguous int64 vector: the operands of the row kernels."""
    if ids.device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {ids.device}")
    if not 1 <= len(arrays) <= 3:
        raise ValueError(f"{what} takes 1 to 3 arrays, got {len(arrays)}")
    shape = arrays[0].shape
    for a in arrays:
        if (a.device != ids.device or a.dtype != torch.float32
                or a.dim() != 2 or a.shape != shape
                or not a.is_contiguous()):
            raise ValueError(f"{what}: arrays must be contiguous float32 "
                             f"[R, W] of one shape on {ids.device}")
    if ids.dtype != torch.int64 or ids.dim() != 1 or \
            not ids.is_contiguous():
        raise ValueError(f"{what}: ids must be a contiguous int64 vector")


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the CUDA ``device``."""
    dev = device.index if device.index is not None \
        else torch.cuda.current_device()
    if dev not in _SM_COUNT:
        _SM_COUNT[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SM_COUNT[dev]


def check_operands(ops: Sequence[torch.Tensor], device,
                   ints: Sequence[torch.Tensor] = ()) -> None:
    """Raise unless every operand lies contiguous on ``device``, those in
    ``ints`` int32 and the rest float32 and 16-byte aligned (the layer
    kernels read them as float4)."""
    for t in ops:
        want = torch.int32 if any(t is i for i in ints) else torch.float32
        if t.device != device or t.dtype != want or not t.is_contiguous() \
                or (want == torch.float32 and t.data_ptr() % 16):
            raise ValueError(
                "operands must lie contiguous on one device, dom int32, "
                "the rest float32 and 16-byte aligned")


def needs_grad(x: torch.Tensor, layer: torch.nn.Module, tables) -> bool:
    """Whether a layer's call must be differentiable: grad mode is on and
    ``x``, a parameter of ``layer`` or a table requires a gradient."""
    return torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in layer.parameters())
        or any(t.requires_grad for t in tables.values()))
