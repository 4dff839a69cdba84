"""Duplicate-summed gradient of every position (K3): Python side of
``csrc/eqgemm.cu``, twin of
``satrans_tpu/ops/pallas/eqgemm.py:eqgemm_positions``.

:func:`eqgemm_positions` computes ``s[f, i] = sum_j [ids[f, i] ==
ids[f, j]] g[f, j]``: on a CUDA tensor it launches the kernel (and adds
one to ``launches``) or raises; on a CPU tensor it runs
:func:`eqgemm_positions_reference`, the equality GEMM in float32.  The
kernel groups each field's positions by id once, with no B^2 compares:
the field's share of the SMs (:func:`blocks_a_field`) each radix-sort
the ids of one hash bucket in the kernel; then warps over the card sum
each run of duplicates once in ascending position and store the total to
every member, so duplicates carry byte-identical rows and a launch is
deterministic for its grid.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import kernel_fn, sm_count, stream_of

launches = 0


def eqgemm_positions_reference(ids_fb: torch.Tensor,
                               g_fb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the ``[F, B, B]`` equality matrix times
    ``g``, as the JAX package's einsum computes it."""
    eq = (ids_fb[:, :, None] == ids_fb[:, None, :]).to(g_fb.dtype)
    return torch.bmm(eq, g_fb)


def blocks_a_field(F: int, device) -> int:
    """The grouping's blocks a field: the field's share of the SMs, at
    most ``satrans_eqgemm_max_parts()``."""
    most = kernel_fn("eqgemm", "satrans_eqgemm_max_parts", [])()
    return max(1, min(most, sm_count(device) // max(F, 1)))


def eqgemm_positions(ids_fb: torch.Tensor, g_fb: torch.Tensor) -> torch.Tensor:
    """``ids_fb`` int64 ``[F, B]`` (non-negative), ``g_fb`` float32
    ``[F, B, W]`` -> ``[F, B, W]``."""
    if ids_fb.device.type == "cpu":
        return eqgemm_positions_reference(ids_fb, g_fb)
    if ids_fb.device.type != "cuda":
        raise ValueError(f"no eqgemm kernel for device {ids_fb.device}")
    F, B = ids_fb.shape
    W = g_fb.shape[2]
    if (ids_fb.dtype != torch.int64 or not ids_fb.is_contiguous()
            or g_fb.dtype != torch.float32 or g_fb.shape[:2] != (F, B)
            or not g_fb.is_contiguous() or g_fb.device != ids_fb.device):
        raise ValueError("eqgemm_positions takes contiguous int64 ids "
                         "[F, B] and float32 g [F, B, W] on one device")
    s = torch.empty_like(g_fb)
    if F == 0 or B == 0:
        return s
    parts = blocks_a_field(F, ids_fb.device)
    nbytes = kernel_fn("eqgemm", "satrans_eqgemm_scratch_bytes",
                       [ctypes.c_int] * 4)
    nbytes.restype = ctypes.c_longlong
    scratch = torch.empty(nbytes(F, B, W, parts), dtype=torch.uint8,
                          device=ids_fb.device)
    fn = kernel_fn("eqgemm", "satrans_eqgemm_positions",
                   [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    err = fn(ids_fb.data_ptr(), g_fb.data_ptr(), s.data_ptr(),
             scratch.data_ptr(), F, B, W, parts, stream_of(ids_fb))
    if err:
        raise RuntimeError(f"eqgemm_positions launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1
    return s
