"""The meta-transformer layer's dropout masks.

Twin of the JAX package's interpret-mode in-kernel generator
(``satrans_tpu/ops/pallas/meta_block.py:94-147``): a stateless counter
hash, so a mask element is a pure function of its tile's seed, its draw's
place in the draw order and its index in the draw.  The JAX kernels seed
each grid step with ``seed + tile`` (int32, taken as uint32) and draw, in
this order, the Q MetaNet output, the K MetaNet output (each only if that
projection is transformed), the attention probabilities once per head,
and the output projection; draw ``k`` (from 0) mixes in the salt ``k``.
An element's bits are

    lowbias32(idx ^ (seed + tile) * 0x9E3779B9 + k * 0x85EBCA6B + 0xC2B2AE35)

in uint32 arithmetic, where ``idx`` is its row-major index in the draw's
shape on the JAX kernel's tile, and it is kept when the bits are at least
``int(rate * 2**32)``; a kept element is scaled by
``float32(1) / float32(1 - rate)``.  The tile is ``block_b`` examples of
``F_pad`` fields (:func:`pad_fields`); the N-shaped draws are
``[block_b * F_pad, d]`` and each head's probability draw is
``[block_b / g, g * F_pad, g * F_pad]``, ``g`` examples packed
block-diagonally (:func:`attn_group`).  Padded fields count in ``idx``.

:func:`dropout_masks` computes the masks of the real rows and fields with
torch integer ops (the plain version; the CPU path and the tests use it),
and :func:`kernel_args` gives the CUDA kernels the same contract: they
compute each element's mask inline with the same hash
(``csrc/dropout.cuh``), so they keep no mask in device memory.
"""

from __future__ import annotations

import os

import torch

_M32 = 0xFFFFFFFF


def pad_fields(F: int, mult: int | None = None) -> int:
    """F rounded up to the JAX kernel's field multiple ``mult``; ``None``
    reads ``SATRANS_PAD_F`` now (default 8), as the JAX package's
    ``fused_meta_layer_vjp`` does at trace time (meta_block.py:1417-1418).
    A multiple of 1 or less means no padding."""
    if mult is None:
        mult = int(os.environ.get("SATRANS_PAD_F", "8"))
    return F + (-F) % mult if mult > 1 else F


def attn_group(block_b: int, f_pad: int, cap: int | None = None) -> int:
    """Examples packed per block-diagonal attention draw: the largest
    divisor ``g`` of ``block_b`` with ``g * f_pad <= cap``; ``None`` reads
    ``SATRANS_ATTN_CAP`` now (default 128; twin of ``_attn_group``,
    meta_block.py:198-217)."""
    if cap is None:
        cap = int(os.environ.get("SATRANS_ATTN_CAP", "128"))
    best = 1
    for g in range(1, block_b + 1):
        if block_b % g == 0 and g * f_pad <= cap:
            best = g
    return best


def threshold(rate: float) -> int:
    """The keep threshold on the 32 random bits, computed on the host."""
    return int(rate * (2 ** 32))


def keep_scale(rate: float) -> float:
    """The value of a kept element, ``float32(1) / float32(1 - rate)``."""
    return float(torch.tensor(1.0, dtype=torch.float32)
                 / torch.tensor(1.0 - rate, dtype=torch.float32))


def salts(heads: int, apply_q: bool, apply_k: bool):
    """Draw indices ``(q, k, first head, output)``; an unapplied
    projection draws nothing, so the later salts move down."""
    k = int(apply_q)
    s = k + int(apply_k)
    return 0, k, s, s + heads


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in ``[0, 2**32)``, in 16-bit
    halves of ``c`` so that no product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _bits(idx: torch.Tensor, seed_mix: torch.Tensor, salt: int):
    """lowbias32 of the mixed counter, int64 holding uint32 values."""
    x = idx ^ seed_mix
    x = (x + ((salt * 0x85EBCA6B + 0xC2B2AE35) & _M32)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def dropout_masks(seed: int, B: int, F: int, d: int, heads: int,
                  block_b: int, rate: float, apply_q: bool, apply_k: bool,
                  device="cpu", pad_mult: int | None = None):
    """``(m_yq, m_yk, m_s, m_z)``: float32 masks (0 or the keep scale) of
    the real rows, ``[B, F, d]`` for the MetaNet outputs and the output
    projection and ``[B, H, F, F]`` for the probabilities; an unapplied
    projection's mask is ``None``.  Example ``b`` lies in tile
    ``b // block_b``; the tile's fields are padded to ``pad_mult``
    (:func:`pad_fields`)."""
    f_pad = pad_fields(F, pad_mult)
    g = attn_group(block_b, f_pad)
    n = g * f_pad
    thr, scale = threshold(rate), keep_scale(rate)
    i64 = dict(dtype=torch.int64, device=device)
    b = torch.arange(B, **i64)
    loc = b % block_b
    seed_mix = _mul32((int(seed) + b // block_b) & _M32, 0x9E3779B9)
    f = torch.arange(F, **i64)
    # N-shaped draws: element (b, f, c) at ((b % block_b) F_pad + f) d + c
    idx_n = ((loc[:, None, None] * f_pad + f[None, :, None]) * d
             + torch.arange(d, **i64)[None, None, :])
    # attention draws: (b, i, j) at row grp n + slot F_pad + i, column
    # slot F_pad + j of the example's group
    col0 = (loc % g) * f_pad
    row0 = (loc // g) * n + col0
    idx_s = ((row0[:, None, None] + f[None, :, None]) * n
             + col0[:, None, None] + f[None, None, :])

    def mask(idx, salt):
        keep = _bits(idx, seed_mix.view(-1, *[1] * (idx.dim() - 1)),
                     salt) >= thr
        return keep.to(torch.float32) * scale

    sq, sk, ss, sz = salts(heads, apply_q, apply_k)
    m_yq = mask(idx_n, sq) if apply_q else None
    m_yk = mask(idx_n, sk) if apply_k else None
    m_s = torch.stack([mask(idx_s, ss + h) for h in range(heads)], dim=1)
    return m_yq, m_yk, m_s, mask(idx_n, sz)


def kernel_args(train: bool, rate: float, seed: int, block_b: int, F: int,
                pad_mult: int | None = None):
    """The kernels' dropout operands ``(on, seed, threshold, scale,
    block_b, F_pad, g)``, for the layout of :func:`dropout_masks`; ``on``
    is 0 outside training or at rate 0."""
    if not (train and rate > 0.0):
        return (0, 0, 0, 1.0, 1, 1, 1)
    f_pad = pad_fields(F, pad_mult)
    return (1, int(seed) & _M32, threshold(rate), keep_scale(rate), block_b,
            f_pad, attn_group(block_b, f_pad))
