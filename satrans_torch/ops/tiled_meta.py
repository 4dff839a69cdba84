"""The meta-transformer layer with per-tile MetaNet weights: Python side
of K7, the ``TILED`` forward tile body of ``csrc/meta_stash_fwd.cuh``
(K7-fwd, which writes the output alone; K7-stash, which also writes the
backward's residuals; both launched by ``csrc/meta_block_fwd.cu``) and
the ``TILED`` backward tile body of ``csrc/meta_stash_bwd.cuh``, launched
by ``csrc/meta_block_bwd.cu`` (K7-bwd, which recomputes the forward;
K7-bwd-stash, which reads the residuals), twins of
``satrans_tpu/ops/pallas/tiled_meta.py``.

The layer runs on a batch that :mod:`satrans_torch.ops.dispatch` has
sorted into single-domain tiles of ``block_b`` slots: tile ``t`` applies
the MetaNets of ``tile_tables['Q'][t]`` and ``tile_tables['K'][t]``
(``[n_tiles, P]``, gathered by the caller as ``table[plan.tile_dom]``
outside this module, so that autograd of that gather carries the
per-tile gradient blocks back to the ``[R, P]`` tables, as the JAX
package's gather outside its custom VJP does).  Given the plan's
``tile_count`` (each tile's occupied slots, its first ones), every K7
kernel skips the slack slots, whose output the caller reads only
through a zero gradient: K7-fwd and K7-stash write zeros for their output
(and residuals), the backwards give them ``dx = 0`` and add nothing to
any gradient.

* :func:`fused_tiled_layer` - the wrapper.  On a CUDA tensor it launches
  the kernels or raises: with a gradient needed, ``bwd='stash'`` (the
  default; ``SATRANS_TILED_BWD`` overrides, as in the JAX package) runs
  :class:`_TiledStashFn` (K7-stash forward, K7-bwd-stash backward) and
  ``bwd='recompute'`` :class:`_TiledFn` (K7-fwd, K7-bwd); without, K7-fwd,
  which never stashes.  On a CPU tensor it runs
  :func:`tiled_layer_reference` with the same dropout masks, and autograd
  differentiates that.
* :func:`tiled_layer_reference` - the plain PyTorch version: K1's plain
  layer with each slot's MetaNet taken from its tile; its autograd
  backward is the plain version of both backward kernels, and its
  ``residuals`` the plain version of K7-stash's.
* :func:`layer_masks` - the dropout masks the kernels compute inline: the
  JAX package's interpret-mode masks over the dispatched slots, tile
  ``t`` seeded with ``seed + t`` on tiles of ``block_b`` (the dispatch
  tile), in K1's draw order (yq if Q is applied, yk if K is, one
  attention mask per head, the output; tiled_meta.py:26-27, :194-201).
* :func:`launch_fwd` / :func:`launch_bwd` - the kernel launches on packed
  operands; ``launches`` / ``stash_launches`` / ``bwd_launches`` /
  ``stash_bwd_launches`` count them.

The JAX tiled layer has no light stash, and neither has this one.
"""

from __future__ import annotations

import ctypes
import os
from typing import Sequence

import torch

from ..nn.attention import MetaTransformerLayer
from . import meta_block, prng
from ._build import (check_operands, kernel_fn, needs_grad, sm_count,
                     stream_of)

# (d, h1, h2, heads) and the most fields: K1's shapes (the same sources)
KERNEL_SHAPES = meta_block.KERNEL_SHAPES
# the dispatch tiles K7 takes: an even number of slots (16 and 32 on the
# model's path)
TILE_MULTIPLE = 2

BWD_MODES = ("stash", "recompute")
STASH_RESIDUALS = meta_block.STASH_RESIDUALS["full"]

launches = 0            # K7-fwd
stash_launches = 0      # K7-stash
bwd_launches = 0        # K7-bwd
stash_bwd_launches = 0  # K7-bwd-stash


def tile_rows(n_slots: int, block_b: int, device) -> torch.Tensor:
    """Each slot's row of the per-tile tables: ``slot // block_b``."""
    return torch.arange(n_slots, device=device) // block_b


def tiled_layer_reference(x, layer: MetaTransformerLayer, tile_tables, *,
                          meta_units: Sequence[int], head_num: int,
                          block_b: int, mode: str = "QK",
                          relu_out: bool = False, masks=None,
                          residuals: dict | None = None,
                          clamp: bool = True):
    """Plain PyTorch version of the kernels.  ``x`` ``[n_slots, F, d]``
    on tiles of ``block_b`` slots; ``tile_tables`` ``{'Q': [n_tiles, P],
    'K': [n_tiles, P]}``; ``masks`` from :func:`layer_masks`;
    ``residuals`` receives K7-stash's.  The logits are clamped to
    [-60, 60] as in the kernels; ``clamp=False`` is the JAX package's XLA
    layer."""
    return meta_block.meta_layer_reference(
        x, layer, tile_tables, tile_rows(x.shape[0], block_b, x.device),
        meta_units=meta_units, head_num=head_num, mode=mode,
        relu_out=relu_out, masks=masks, residuals=residuals, clamp=clamp)


# K1's masks on the dispatched slots, block_b the dispatch tile
layer_masks = meta_block.layer_masks


def bwd_mode(bwd: str | None = None) -> str:
    """The backward kernel pair: ``bwd``, else ``SATRANS_TILED_BWD``, else
    'stash' (tiled_meta.py:754-757): 'stash' or 'recompute'."""
    if bwd is None:
        bwd = os.environ.get("SATRANS_TILED_BWD", "stash")
    if bwd not in BWD_MODES:
        raise ValueError(f"unknown bwd mode {bwd!r}")
    return bwd


def _check(x, meta_units, head_num: int, tile_tables,
           block_b: int) -> None:
    """Raise for what the kernels do not take: K1's shapes and type (not
    its row cap: K7 keeps no per-row sums), on whole even tiles."""
    meta_block._check(x, meta_units, head_num, tile_tables, train=False)
    n_slots = x.shape[0]
    if block_b % TILE_MULTIPLE or n_slots % block_b:
        raise ValueError(f"{n_slots} slots on tiles of {block_b}: the tile "
                         f"must be a multiple of {TILE_MULTIPLE} that "
                         "divides the slots")


def _check_tile_count(tile_count, T: int) -> None:
    if tile_count is not None and tuple(tile_count.shape) != (T,):
        raise ValueError(f"tile_count of shape {tuple(tile_count.shape)}, "
                         f"want ({T},)")


def launch_fwd(x, wqkv, w1q, wmq, w2q, lnq, w1k, wmk, w2k, lnk, wout, lno,
               cfg, drop, block_b: int, stash: bool = False,
               tile_count=None, blocks: int | None = None):
    """K7-fwd: the layer's output for packed operands on tiles of
    ``block_b`` slots (``w1q`` etc. ``[n_tiles, ...]``; ``wmq``/``wmk``
    None for 2-matrix MetaNets); with ``stash`` K7-stash: ``(y, qkv, uq,
    uk, s, o)``.  ``drop`` is ``prng.kernel_args(...)`` with the dispatch
    tile.  With ``tile_count`` (int32 ``[n_tiles]``,
    ``DispatchPlan.tile_count``) both compute the occupied slots alone
    and write zeros for ``y`` (and every residual) of the slack slots;
    without it every slot is computed.  ``blocks`` bounds the grid
    (default: one block an SM)."""
    h, h2, heads, apply_q, apply_k, relu_out = cfg
    n_slots, F, d = x.shape
    T = w1q.shape[0]
    if T * block_b != n_slots:
        raise ValueError(f"{T} tiles of {block_b} slots for {n_slots} slots")
    _check_tile_count(tile_count, T)
    ops = (x, wqkv, w1q, wmq, w2q, lnq, w1k, wmk, w2k, lnk, wout, lno)
    check_operands(meta_block.present(ops + (tile_count,)), x.device,
                   ints=meta_block.present((tile_count,)))
    y = torch.empty_like(x)
    res = tuple(x.new_empty(shape) for shape in meta_block._residual_shapes(
        n_slots, F, d, heads, "full")) if stash else ()
    if blocks is None:
        blocks = sm_count(x.device)
    if blocks < 1:
        raise ValueError(f"a grid of {blocks} blocks")
    fn = kernel_fn("meta_block_fwd", "satrans_tiled_meta_fwd",
                   [ctypes.c_void_p] * 19 + [ctypes.c_int] * 14
                   + [ctypes.c_uint, ctypes.c_uint, ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p],
                   shape=(d, h, h2, heads))
    mode = "full" if stash else None
    err = fn(*meta_block.ptrs(ops + (tile_count, y)),
             *meta_block._residual_ptrs(res, mode),
             meta_block._STASH_MODE[mode], n_slots, F, d, h, h2, heads, T,
             block_b, apply_q, apply_k, relu_out, blocks, *drop,
             stream_of(x))
    if err:
        raise RuntimeError(f"tiled_meta_fwd launch failed: CUDA error {err}")
    global launches, stash_launches
    if not stash:
        launches += 1
        return y
    stash_launches += 1
    return (y,) + res


def launch_bwd(g, x, wqkv, w1q, wmq, w2q, lnq, w1k, wmk, w2k, lnk, wout,
               lno, cfg, drop, block_b: int, res=None, tile_count=None,
               blocks: int | None = None, tails: bool = False):
    """K7-bwd; with K7-stash's residuals ``res = (qkv, uq, uk, s, o)``
    K7-bwd-stash: ``(dx, dwqkv, dw1q, dwmq, dw2q, dlnq, dw1k, dwmk, dw2k,
    dlnk, dwout, dlno)``, the per-tile blocks ``[n_tiles, ...]``
    (``dwmq``/``dwmk`` None for 2-matrix MetaNets), for the upstream
    gradient ``g`` of the layer's output.  ``tile_count`` (int32
    ``[n_tiles]``, ``DispatchPlan.tile_count``) gives each tile's occupied
    slots: the rest must have a zero ``g``, and get ``dx = 0``; without it
    every slot is computed.  ``blocks`` sets the grid (default: one block
    an SM); the result is deterministic for a grid.  With ``tails`` it
    returns ``(result, split)``: the kernel's split, int32 ``[blocks]``,
    the dispatch tile that block ``b`` shares with block ``b + 1`` (-1:
    none)."""
    h, h2, heads, apply_q, apply_k, relu_out = cfg
    n_slots, F, d = x.shape
    T = w1q.shape[0]
    if T * block_b != n_slots:
        raise ValueError(f"{T} tiles of {block_b} slots for {n_slots} slots")
    g = g.contiguous()
    if g.dtype != torch.float32 or g.shape != x.shape:
        raise ValueError(f"gradient of type {g.dtype} and shape "
                         f"{tuple(g.shape)}, want float32 {tuple(x.shape)}")
    if res is not None:
        want = meta_block._residual_shapes(n_slots, F, d, heads, "full")
        if [tuple(r.shape) for r in res] != want:
            raise ValueError(f"residuals of shapes "
                             f"{[tuple(r.shape) for r in res]}, want {want}")
        check_operands(res, x.device)
    _check_tile_count(tile_count, T)
    if blocks is None:
        blocks = sm_count(x.device)
    if blocks < 1:
        raise ValueError(f"a grid of {blocks} blocks")
    dx = torch.empty_like(x)
    shape = (d, h, h2, heads)
    scratch = torch.empty(kernel_fn(
        "meta_block_bwd", "satrans_tiled_meta_bwd_scratch_floats",
        [ctypes.c_int] * 5, shape=shape)(d, h, h2, heads, blocks),
        dtype=torch.float32, device=x.device)
    grads = torch.empty(meta_block.grad_floats(d, h, h2, heads, T),
                        dtype=torch.float32, device=x.device)
    ops = (x, g, wqkv, w1q, wmq, w2q, lnq, w1k, wmk, w2k, lnk, wout, lno,
           tile_count, dx, scratch, grads)
    check_operands(meta_block.present(ops), x.device,
                   ints=meta_block.present((tile_count,)))
    fn = kernel_fn("meta_block_bwd", "satrans_tiled_meta_bwd",
                   [ctypes.c_void_p] * 22 + [ctypes.c_int] * 14
                   + [ctypes.c_uint, ctypes.c_uint, ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p], shape=shape)
    mode = None if res is None else "full"
    err = fn(*meta_block.ptrs(ops), *meta_block._residual_ptrs(res, mode),
             meta_block._STASH_MODE[mode], n_slots, F, d, h, h2, heads,
             T, block_b, apply_q, apply_k, relu_out, blocks, *drop,
             stream_of(x))
    if err:
        raise RuntimeError(f"tiled_meta_bwd launch failed: CUDA error {err}")
    global bwd_launches, stash_bwd_launches
    if res is None:
        bwd_launches += 1
    else:
        stash_bwd_launches += 1
    out = (dx, *meta_block.split_grads(grads, d, h, h2, T))
    if not tails:
        return out
    # the kernel's bnd_tile: the scratch's last word a block
    return out, scratch[-blocks:].view(torch.int32)


def _input_grads(grads, cfg):
    """The kernel's gradients as the autograd functions' input gradients
    (None for an unapplied projection's operands, cfg, drop, block_b and
    tile_count)."""
    dx, *rest = grads
    return (dx, *meta_block.input_grads(rest, cfg), None, None, None, None)


class _TiledFn(torch.autograd.Function):
    """The layer with K7-fwd as its forward and K7-bwd as its backward
    (the JAX ``_tiled_layer`` custom VJP with ``bwd='recompute'``): the
    forward saves only its inputs.  With ``tile_count`` both skip the
    slack slots: the forward writes zeros there, which the head reads,
    and the backward gives them ``dx = 0``."""

    @staticmethod
    def forward(ctx, *args):
        *ops, cfg, drop, block_b, tile_count = args
        ctx.cfg, ctx.drop, ctx.block_b = cfg, drop, block_b
        ctx.tile_count = tile_count
        ctx.save_for_backward(*ops)
        return launch_fwd(*ops, cfg, drop, block_b, tile_count=tile_count)

    @staticmethod
    def backward(ctx, g):
        return _input_grads(launch_bwd(
            g, *ctx.saved_tensors, ctx.cfg, ctx.drop, ctx.block_b,
            tile_count=ctx.tile_count), ctx.cfg)


class _TiledStashFn(torch.autograd.Function):
    """The layer with K7-stash as its forward and K7-bwd-stash as its
    backward (``bwd='stash'``): the forward saves its inputs and the five
    residuals, 203.4 MB a layer at the AliCCP multicol shape (9984 slots,
    F=19, d=32).  With ``tile_count`` both skip the slack slots: the
    forward writes zeros there, which the head reads, and the backward
    gives them ``dx = 0``."""

    @staticmethod
    def forward(ctx, *args):
        *ops, cfg, drop, block_b, tile_count = args
        ctx.cfg, ctx.drop, ctx.block_b = cfg, drop, block_b
        ctx.tile_count = tile_count
        y, *res = launch_fwd(*ops, cfg, drop, block_b, stash=True,
                             tile_count=tile_count)
        ctx.save_for_backward(*ops, *res)
        return y

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        n = meta_block.N_OPERANDS - 1  # no dom
        return _input_grads(launch_bwd(
            g, *saved[:n], ctx.cfg, ctx.drop, ctx.block_b, res=saved[n:],
            tile_count=ctx.tile_count), ctx.cfg)


_LAYER_FNS = {"stash": _TiledStashFn, "recompute": _TiledFn}


def fused_tiled_layer(x, layer: MetaTransformerLayer, tile_tables, *,
                      meta_units: Sequence[int], head_num: int,
                      mode: str = "QK", relu_out: bool = False,
                      train: bool = False, drop_rate: float = 0.0,
                      seed: int = 0, block_b: int = 32,
                      bwd: str | None = None, tile_count=None):
    """One meta-transformer layer on a dispatched batch ``x`` ``[n_slots,
    F, d]`` of tiles of ``block_b`` slots, each with its row of
    ``tile_tables``; the JAX ``fused_tiled_layer_vjp``'s arguments.
    Differentiable: with a gradient needed on the card, ``bwd`` ('stash'
    or 'recompute', see :func:`bwd_mode`) picks the kernel pair; without,
    K7-fwd runs and nothing is stashed (tiled_meta.py:658-663).
    ``tile_count`` (the plan's) lets every K7 kernel skip the slack
    slots, whose output the caller reads only through a zero gradient
    (see :func:`launch_fwd` and :func:`launch_bwd`); the CPU path ignores
    it."""
    bwd = bwd_mode(bwd)
    if x.device.type == "cpu":
        masks = layer_masks(x, head_num=head_num, mode=mode, train=train,
                            drop_rate=drop_rate, seed=seed, block_b=block_b)
        return tiled_layer_reference(x, layer, tile_tables,
                                     meta_units=meta_units,
                                     head_num=head_num, block_b=block_b,
                                     mode=mode, relu_out=relu_out,
                                     masks=masks)
    if x.device.type != "cuda":
        raise ValueError(f"no tiled_meta kernel for device {x.device}")
    _check(x, meta_units, head_num, tile_tables, block_b)
    weights, cfg = meta_block.pack_weights(layer, tile_tables,
                                           meta_units=meta_units,
                                           head_num=head_num, mode=mode,
                                           relu_out=relu_out)
    drop = prng.kernel_args(train, drop_rate, seed, block_b, x.shape[1])
    ops = (x.contiguous(), *weights)
    if not needs_grad(x, layer, tile_tables):
        return launch_fwd(*ops, cfg, drop, block_b, tile_count=tile_count)
    return _LAYER_FNS[bwd].apply(*ops, cfg, drop, block_b, tile_count)
