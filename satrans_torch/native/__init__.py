"""Host-side batch assembly in C++ with OpenMP, loaded with ctypes (twin of
``satrans_tpu/native``).

``batcher.cpp`` is built with ``g++ -O3 -march=native -fopenmp`` at the
first call into ``satrans_torch/_build/`` (named by a hash of the source,
the flags and the host's CPU, so a changed source or a checkout moved to
another CPU is rebuilt) and never at import time.
A failed build raises with the compiler's output: nothing falls back to
numpy.  The numpy expressions in the docstrings are what the tests hold
each function against.

* :func:`gather_rows(src, idx)` -> ``src[idx]`` for a 2-D array
* :func:`gather_columns(cols, idx)` -> ``np.stack([c[idx] for c in cols],
  axis=1)``, the packed ``[B, n_cols]`` batch of 1-D int32 or float32
  columns
* :func:`shuffle_indices(n, seed)` -> a permutation of ``arange(n)``, the
  JAX package's native one for the same seed
* :func:`available` -> True once the library is built and loaded
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "batcher.cpp"
_BUILD_DIR = _SRC.parent.parent / "_build"
_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]

_lib = None


def _cpu() -> bytes:
    """The host CPU's model and flags (``-march=native`` builds for
    them)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return platform.processor().encode()
    keys = (b"model name", b"flags", b"Features", b"CPU part")
    return b"\n".join(dict.fromkeys(
        ln for ln in lines if ln.split(b":")[0].strip() in keys))


def _build() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    h.update(_cpu())
    out = _BUILD_DIR / f"libbatcher_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
    except FileNotFoundError as err:
        raise RuntimeError("the native batcher needs g++, which is not on "
                           "this machine's PATH") from err
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {_SRC.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builds agree
    return out


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        lib.gather_rows.argtypes = [ptr, ptr, ptr, i64, i64]
        lib.gather_columns_i32.argtypes = [ptr, i64, ptr, ptr, i64]
        lib.gather_columns_f32.argtypes = [ptr, i64, ptr, ptr, i64]
        lib.shuffle_indices.argtypes = [ptr, i64, ctypes.c_uint64]
        for fn in (lib.gather_rows, lib.gather_columns_i32,
                   lib.gather_columns_f32, lib.shuffle_indices):
            fn.restype = None
        lib.omp_thread_count.argtypes = []
        lib.omp_thread_count.restype = ctypes.c_int
        _lib = lib
    return _lib


def _indices(idx, n: int) -> np.ndarray:
    """``idx`` as contiguous int64, each in ``[0, n)`` (numpy's negative
    indices are refused: the C loops read ``src + idx * row``)."""
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if idx.ndim != 1:
        raise ValueError(f"indices must be 1-D, got shape {idx.shape}")
    if len(idx) and (idx.min() < 0 or idx.max() >= n):
        raise IndexError(f"indices outside [0, {n})")
    return idx


def gather_rows(src: np.ndarray, idx) -> np.ndarray:
    """``src[idx]`` for a 2-D array of any dtype, one row a thread."""
    lib = _load()
    src = np.ascontiguousarray(src)
    if src.ndim != 2:
        raise ValueError(f"gather_rows takes a 2-D array, got {src.ndim}-D")
    idx = _indices(idx, src.shape[0])
    out = np.empty((len(idx), src.shape[1]), dtype=src.dtype)
    lib.gather_rows(src.ctypes.data, idx.ctypes.data, out.ctypes.data,
                    len(idx), src.shape[1] * src.itemsize)
    return out


def gather_columns(cols: list[np.ndarray], idx,
                   dtype=np.int32) -> np.ndarray:
    """``np.stack([c[idx] for c in cols], axis=1).astype(dtype)``: the
    packed ``[B, n_cols]`` batch of equal-length 1-D columns, for
    ``dtype`` int32 or float32 (another raises ``TypeError``)."""
    dtype = np.dtype(dtype)
    if dtype not in (np.dtype(np.int32), np.dtype(np.float32)):
        raise TypeError(f"gather_columns supports int32/float32, got {dtype}")
    lib = _load()
    arrs = [np.ascontiguousarray(c, dtype=dtype) for c in cols]
    n = len(arrs[0]) if arrs else 0
    if any(a.ndim != 1 or len(a) != n for a in arrs):
        raise ValueError("gather_columns takes 1-D columns of one length")
    idx = _indices(idx, n)
    ptrs = (ctypes.c_void_p * len(arrs))(*[a.ctypes.data for a in arrs])
    out = np.empty((len(idx), len(arrs)), dtype=dtype)
    fn = lib.gather_columns_i32 if dtype == np.int32 else \
        lib.gather_columns_f32
    fn(ptrs, len(arrs), idx.ctypes.data, out.ctypes.data, len(idx))
    return out


def shuffle_indices(n: int, seed: int) -> np.ndarray:
    """A permutation of ``arange(n)`` (int64): Fisher-Yates from a
    SplitMix64 stream seeded with ``seed`` (taken modulo 2**64)."""
    lib = _load()
    idx = np.arange(n, dtype=np.int64)
    lib.shuffle_indices(idx.ctypes.data, n,
                        ctypes.c_uint64(int(seed) % 2 ** 64))
    return idx


def thread_count() -> int:
    """The OpenMP threads a parallel region of the library runs on."""
    return int(_load().omp_thread_count())


def available() -> bool:
    """True when the library builds and loads (a failed build raises from
    the functions above; here it answers False)."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True
