"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  The layer bodies' sources
(:data:`SHAPED`: K1 and K7 in ``meta_block_{fwd,bwd}``, K6 in
``gate_block_{fwd,bwd}``) are built once a shape, the shape passed as
``-D`` defines, each shape's library at the first launch of that shape:
one library with every shape's instances would take minutes to build.
Libraries go to ``_build/`` beside the package sources, named by the
source, the shape and a hash of the sources and the flags: a changed
source is rebuilt at its first use.  Several libraries build in
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

# the sources built once a shape: the defines (SATRANS_<name>) of the shape
# tuples their wrappers pass, (d, h1, h2, heads) for K1 and K7 and (d,
# heads) for K6
SHAPED = {"meta_block_fwd": ("D", "H", "H2", "NH"),
          "meta_block_bwd": ("D", "H", "H2", "NH"),
          "gate_block_fwd": ("D", "NH"), "gate_block_bwd": ("D", "NH")}
# the shape of a call that names none: the AliCCP sota width (d = 32,
# MetaNet [32, 64, 32], 4 heads)
DEFAULT_SHAPES = {"meta_block_fwd": (32, 64, 0, 4),
                  "meta_block_bwd": (32, 64, 0, 4),
                  "gate_block_fwd": (32, 4), "gate_block_bwd": (32, 4)}

_LIBS: dict[tuple, ctypes.CDLL] = {}
_SM_COUNT: dict[int, int] = {}
_FNS: dict[tuple, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _shape(name: str, shape) -> tuple | None:
    """The shape of a library of ``name``: None for a source built once,
    else ``shape`` (default :data:`DEFAULT_SHAPES`) as a tuple of ints."""
    if name not in SHAPED:
        if shape is not None:
            raise ValueError(f"csrc/{name}.cu is not built once a shape")
        return None
    shape = tuple(int(v) for v in (shape or DEFAULT_SHAPES[name]))
    if len(shape) != len(SHAPED[name]):
        raise ValueError(f"csrc/{name}.cu takes a shape of "
                         f"{SHAPED[name]}, got {shape}")
    return shape


def _target(name: str, shape=None) -> tuple[Path, Path, list[str]]:
    """The source, the library and the ``nvcc`` flags of ``name`` at
    ``shape``."""
    src = CSRC / f"{name}.cu"
    shape = _shape(name, shape)
    flags = list(NVCC_FLAGS)
    stem = name
    if shape is not None:
        flags += [f"-DSATRANS_{k}={v}" for k, v in zip(SHAPED[name], shape)]
        stem += "_" + "_".join(map(str, shape))
    h = hashlib.sha256(" ".join(flags).encode())
    for dep in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(dep.read_bytes())
    return src, BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so", flags


def default_targets() -> list[tuple[str, tuple | None]]:
    """Every source at its default shape, and the 3-matrix MetaNet shape
    [32, 64, 64, 32] of K1 and K7: the libraries the AliCCP sota
    configurations use."""
    out = [(n, _shape(n, None)) for n in sources()]
    return out + [(n, (32, 64, 64, 4)) for n in ("meta_block_fwd",
                                                 "meta_block_bwd")]


def label(name: str, shape=None) -> str:
    """A library's name: its source, and its shape where it has one."""
    shape = _shape(name, shape)
    return name if shape is None else f"{name}{list(shape)}"


def build(targets=None) -> dict[str, float]:
    """Compile the targets (source names, or ``(name, shape)`` pairs;
    default :func:`default_targets`) that are not built yet, one ``nvcc``
    process a CPU core at a time, each library's ``nvcc`` output (the
    ptxas register, spill and shared-memory lines) kept beside it for
    :func:`log`.  Returns each library's ``nvcc`` seconds, by
    :func:`label`."""
    targets = default_targets() if targets is None else targets
    BUILD_DIR.mkdir(exist_ok=True)
    todo = {}
    for t in targets:
        name, shape = (t, None) if isinstance(t, str) else t
        src, out, flags = _target(name, shape)
        key = label(name, shape)
        if key in todo or (out.exists() and out.with_suffix(".log").exists()):
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        todo[key] = ([_nvcc(), *flags, "-o", str(tmp), str(src)], tmp, out)
    queue, running = list(todo), {}
    seconds, failed = {}, []
    while queue or running:
        while queue and len(running) < (os.cpu_count() or 1):
            key = queue.pop(0)
            cmd, tmp, _ = todo[key]
            with open(tmp.with_suffix(".log"), "w") as out_log:
                running[key] = (subprocess.Popen(
                    cmd, stdout=out_log, stderr=subprocess.STDOUT),
                    time.perf_counter())
        done = [k for k, (proc, _) in running.items()
                if proc.poll() is not None]
        if not done:
            time.sleep(0.05)
        for key in done:
            proc, t0 = running.pop(key)
            seconds[key] = time.perf_counter() - t0
            _, tmp, out = todo[key]
            if proc.returncode:
                failed.append(key)
            else:
                # atomic, the log first: concurrent builds agree, and a
                # built library has its log
                os.replace(tmp.with_suffix(".log"), out.with_suffix(".log"))
                os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(todo[k][1].with_suffix(".log")
                                        .read_text() for k in failed))
    return seconds


def log(name: str, shape=None) -> str:
    """``nvcc``'s output for the library built from ``csrc/<name>.cu`` at
    ``shape`` (ptxas register, spill and shared-memory lines), built first
    if needed."""
    log_path = _target(name, shape)[1].with_suffix(".log")
    if not log_path.exists():
        build([(name, shape)])
    return log_path.read_text()


def load(name: str, shape=None) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu`` at ``shape``, built first
    if needed.  A library first needed while a CUDA graph is being
    captured raises: the warmup before the capture must load it."""
    key = (name, _shape(name, shape))
    lib = _LIBS.get(key)
    if lib is None:
        if torch.cuda.is_available() and \
                torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"{label(*key)} first loaded inside a CUDA graph capture: "
                "warm up at the captured shapes first")
        _, out, _ = _target(*key)
        if not out.exists():
            build([key])
        lib = _LIBS[key] = ctypes.CDLL(str(out))
    return lib


def kernel_fn(source: str, name: str, argtypes,
              shape=None) -> ctypes._CFuncPtr:
    """The C entry ``name`` of ``csrc/<source>.cu`` (returning an int), at
    ``shape`` for a source of :data:`SHAPED` (default its
    :data:`DEFAULT_SHAPES`), built at first use."""
    key = (source, _shape(source, shape), name)
    fn = _FNS.get(key)
    if fn is None:
        fn = getattr(load(source, key[1]), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[key] = fn
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
