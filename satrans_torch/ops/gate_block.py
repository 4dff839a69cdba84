"""The fused layer of SATrans's gate and bilinear variants: Python side of
the Hopper kernels ``csrc/gate_block_fwd.cu`` (K6-fwd) and
``csrc/gate_block_bwd.cu`` (K6-bwd, which recomputes the forward), twins
of ``satrans_tpu/ops/pallas/gate_block.py``.

* :func:`fused_simple_layer` - the wrapper.  On a CUDA tensor it launches
  the kernels or raises: with a gradient needed, :class:`_SimpleLayerFn`
  (K6-fwd forward, K6-bwd backward; the JAX package's variant has no
  stash); without, K6-fwd.  On a CPU tensor it runs
  :func:`simple_layer_reference` with the same dropout masks, and
  autograd differentiates that.
* :func:`simple_layer_reference` - the plain PyTorch version on the same
  operands (``nn.attention.meta_transformer_apply`` of the layer's
  variant, with the kernels' logit clamp); its autograd backward is the
  plain version of K6-bwd.
* :func:`layer_masks` - the dropout masks the kernels compute inline: the
  attention's per head, then the output's (``ops/prng.py`` with no
  transformed-projection draws), on the JAX kernel's tile with F padded
  to 8 (``gate_block.py:382``'s fixed ``pad_mult``; ``SATRANS_PAD_F`` does
  not reach this kernel, ``SATRANS_ATTN_CAP`` does).
* :func:`launch_fwd` / :func:`launch_bwd` - the kernel launches on packed
  operands (:func:`pack_operands`), on a grid of the card's SMs
  (``sm_count``); ``launches`` / ``bwd_launches`` count them.

The tables are the model's ``[D, P]`` scenario tables: the gate rows
``[D, d]`` ('Q', 'K') or the flat per-(domain, head) bilinear maps
``[D, H * dh * dh]`` ('bilinear').  The kernels read them as they are
(the TPU's block-diagonal ``[d, D*d]`` packing is a TPU layout), and
autograd carries their gradients back to the tables through the slicing
in :func:`pack_operands`.
"""

from __future__ import annotations

import ctypes

import torch

from ..nn import attention
from ..nn.attention import MetaTransformerLayer
from . import meta_block, prng
from ._build import (check_operands, kernel_fn, needs_grad, sm_count,
                     stream_of)

# the shapes (d, heads) csrc/gate_block_{fwd,bwd}.cu are built for, each
# its own library at its first launch (ops/_build.py): K1's widths and head
# counts; and the most fields an example may have
KERNEL_SHAPES = frozenset((d, heads) for d in meta_block.KERNEL_WIDTHS
                          for heads in meta_block.KERNEL_HEADS)
KERNEL_SET = "d in (8, 16, 32, 64), heads in (1, 2, 4, 8)"
KERNEL_MAX_FIELDS = 20
# the field multiple of the JAX kernel's dropout tile (gate_block.py:382)
PAD_FIELDS = 8

launches = 0      # K6-fwd
bwd_launches = 0  # K6-bwd


def applied(variant: str, mode: str) -> tuple[bool, bool]:
    """Which of Q and K the variant transforms: the gate per ``mode``, the
    bilinear map Q always and K never (gate_block.py:399-409)."""
    if variant == "gate":
        return "Q" in mode, "K" in mode
    if variant == "bilinear":
        return True, False
    raise ValueError(f"no gate_block kernel for variant {variant!r}")


def simple_layer_reference(x, layer: MetaTransformerLayer, tables, dom, *,
                           head_num: int, mode: str = "QK",
                           relu_out: bool = False, masks=None,
                           clamp: bool = True):
    """Plain PyTorch version of the kernels.  ``x`` ``[B, F, d]``;
    ``tables`` ``{'Q', 'K', 'bilinear'}`` -> per-domain ``[D, P]``; ``dom``
    ``[B]`` rows of the tables, in ``[0, D)``; ``masks`` from
    :func:`layer_masks`.  ``clamp=False`` is the JAX package's XLA layer,
    which does not clamp the logits."""
    return attention.meta_transformer_apply(
        layer, x, tables, (), mode=mode, head_num=head_num,
        relu_out=relu_out, domain_ids=dom.long(), masks=masks, clamp=clamp)


def layer_masks(x, *, head_num: int, train: bool, drop_rate: float,
                seed: int, block_b: int):
    """The dropout masks of one layer on ``x`` ``[B, F, d]``, or ``None``
    outside training or at rate 0."""
    if not (train and drop_rate > 0.0):
        return None
    B, F, d = x.shape
    return prng.dropout_masks(seed, B, F, d, head_num, block_b, drop_rate,
                              False, False, x.device, pad_mult=PAD_FIELDS)


def _check(x, head_num: int) -> None:
    """Raise for what the kernels do not take."""
    B, F, d = x.shape
    if (d, head_num) not in KERNEL_SHAPES or F > KERNEL_MAX_FIELDS:
        raise NotImplementedError(
            f"gate_block kernel is built for (d, heads) with {KERNEL_SET}: "
            f"{sorted(KERNEL_SHAPES)}, and F <= {KERNEL_MAX_FIELDS}; got "
            f"({d}, {head_num}) and F={F}")
    if x.dtype != torch.float32:
        raise NotImplementedError(f"gate_block kernel takes float32, got "
                                  f"{x.dtype}")


def pack_operands(x, layer: MetaTransformerLayer, tables, dom, *,
                  head_num: int, mode: str = "QK", relu_out: bool = False):
    """The kernels' operands ``(x, dom, wqkv, tq, tk, wout, lno)`` and their
    ``cfg = (bilinear, heads, apply_q, apply_k, relu_out)``, packed with
    differentiable PyTorch ops from the layer's parameters and the tables:
    ``tq``/``tk`` the gate rows ``[D, d]`` (``tk`` is ``tq`` where K is
    not gated), or ``tq`` the bilinear maps ``[D, H * dh * dh]``."""
    d = x.shape[-1]
    apply_q, apply_k = applied(layer.variant, mode)
    x = x.contiguous()
    dom = dom.to(device=x.device, dtype=torch.int32).contiguous()
    wqkv = torch.cat([layer.wq, layer.wk, layer.wv], dim=1).contiguous()
    if layer.variant == "gate":
        tq = tables["Q"][:, :d].contiguous()
        tk = tables["K"][:, :d].contiguous() if apply_k else tq
    else:
        tq = tables["bilinear"][:, :d * (d // head_num)].contiguous()
        tk = tq
    lno = torch.stack([layer.ln.scale, layer.ln.bias]).contiguous()
    cfg = (int(layer.variant == "bilinear"), head_num, int(apply_q),
           int(apply_k), int(relu_out))
    return (x, dom, wqkv, tq, tk, layer.wout.contiguous(), lno), cfg


def launch_fwd(x, dom, wqkv, tq, tk, wout, lno, cfg, drop):
    """K6-fwd: the layer's output for packed operands.  ``drop`` is
    ``prng.kernel_args(...)`` with ``pad_mult=PAD_FIELDS``.  At most two
    blocks an SM, whole tiles of the batch each; the output does not
    depend on the grid."""
    bilinear, heads, apply_q, apply_k, relu_out = cfg
    B, F, d = x.shape
    ops = (x, dom, wqkv, tq, tk, wout, lno)
    check_operands(ops, x.device, ints=(dom,))
    y = torch.empty_like(x)
    fn = kernel_fn("gate_block_fwd", "satrans_gate_block_fwd",
                   [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
                   + [ctypes.c_uint, ctypes.c_uint, ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p],
                   shape=(d, heads))
    err = fn(*(t.data_ptr() for t in ops + (y,)), B, F, d, heads,
             tq.shape[0], bilinear, apply_q, apply_k, relu_out,
             sm_count(x.device), *drop, stream_of(x))
    if err:
        raise RuntimeError(f"gate_block_fwd launch failed: CUDA error {err}")
    global launches
    launches += 1
    return y


def launch_bwd(g, x, dom, wqkv, tq, tk, wout, lno, cfg, drop):
    """K6-bwd: ``(dx, dwqkv, dtq, dtk, dwout, dlno)`` for the upstream
    gradient ``g`` of the layer's output at any number of table rows
    (``dtq``/``dtk`` zero for an unapplied gate; ``dtk`` None for the
    bilinear map, which transforms Q alone).  One block an SM (at most one
    a tile of the body), each with its slice of every row's table sums;
    the result is deterministic for a grid."""
    bilinear, heads, apply_q, apply_k, relu_out = cfg
    B, F, d = x.shape
    D, width = tq.shape
    g = g.contiguous()
    if g.dtype != torch.float32 or g.shape != x.shape:
        raise ValueError(f"gradient of type {g.dtype} and shape "
                         f"{tuple(g.shape)}, want float32 {tuple(x.shape)}")
    shape = (d, heads)
    blocks = kernel_fn("gate_block_bwd", "satrans_gate_block_bwd_blocks",
                       [ctypes.c_int] * 3, shape=shape)(
        B, F, sm_count(x.device))
    total = kernel_fn("gate_block_bwd", "satrans_gate_block_bwd_grad_floats",
                      [ctypes.c_int] * 4, shape=shape)(d, heads, D, bilinear)
    dx = torch.empty_like(x)
    partial = torch.empty(blocks * total, dtype=torch.float32,
                          device=x.device)
    grads = torch.empty(total, dtype=torch.float32, device=x.device)
    ops = (x, dom, g, wqkv, tq, tk, wout, lno, dx, partial, grads)
    check_operands(ops, x.device, ints=(dom,))
    fn = kernel_fn("gate_block_bwd", "satrans_gate_block_bwd",
                   [ctypes.c_void_p] * 11 + [ctypes.c_int] * 11
                   + [ctypes.c_uint, ctypes.c_uint, ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p], shape=shape)
    err = fn(*(t.data_ptr() for t in ops), B, F, d, heads, D, bilinear,
             apply_q, apply_k, relu_out, blocks, *drop, stream_of(x))
    if err:
        raise RuntimeError(f"gate_block_bwd launch failed: CUDA error {err}")
    global bwd_launches
    bwd_launches += 1
    dwqkv, dwout, dlno, dtq, *dtk = torch.split(
        grads, [3 * d * d, d * d, 2 * d] + [D * width] * (2 - bilinear))
    return (dx, dwqkv.view(d, 3 * d), dtq.view(D, width),
            dtk[0].view(D, width) if dtk else None, dwout.view(d, d),
            dlno.view(2, d))


class _SimpleLayerFn(torch.autograd.Function):
    """The layer with K6-fwd as its forward and K6-bwd as its backward
    (the JAX ``_simple_layer`` custom VJP): the forward saves only its
    inputs."""

    @staticmethod
    def forward(ctx, x, dom, wqkv, tq, tk, wout, lno, cfg, drop):
        ctx.cfg, ctx.drop = cfg, drop
        ctx.save_for_backward(x, dom, wqkv, tq, tk, wout, lno)
        return launch_fwd(x, dom, wqkv, tq, tk, wout, lno, cfg, drop)

    @staticmethod
    def backward(ctx, g):
        _, _, apply_q, apply_k, _ = ctx.cfg
        dx, dwqkv, dtq, dtk, dwout, dlno = launch_bwd(
            g, *ctx.saved_tensors, ctx.cfg, ctx.drop)
        return (dx, None, dwqkv, dtq if apply_q else None,
                dtk if apply_k else None, dwout, dlno, None, None)


def fused_simple_layer(x, layer: MetaTransformerLayer, tables, dom, *,
                       head_num: int, mode: str = "QK",
                       relu_out: bool = False, train: bool = False,
                       drop_rate: float = 0.0, seed: int = 0,
                       block_b: int = 128):
    """One gate or bilinear layer (``layer.variant``); same operands as
    :func:`simple_layer_reference`.  ``train`` with ``drop_rate > 0``
    applies the dropout of ``seed`` on tiles of ``block_b`` examples (the
    JAX ``fused_simple_layer_vjp``'s arguments).  Differentiable."""
    applied(layer.variant, mode)
    if x.device.type == "cpu":
        masks = layer_masks(x, head_num=head_num, train=train,
                            drop_rate=drop_rate, seed=seed, block_b=block_b)
        return simple_layer_reference(x, layer, tables, dom,
                                      head_num=head_num, mode=mode,
                                      relu_out=relu_out, masks=masks)
    if x.device.type != "cuda":
        raise ValueError(f"no gate_block kernel for device {x.device}")
    grad = needs_grad(x, layer, tables)
    ops, cfg = pack_operands(x, layer, tables, dom, head_num=head_num,
                             mode=mode, relu_out=relu_out)
    _check(x, head_num)
    drop = prng.kernel_args(train, drop_rate, seed, block_b, x.shape[1],
                            pad_mult=PAD_FIELDS)
    if not grad:
        return launch_fwd(*ops, cfg, drop)
    return _SimpleLayerFn.apply(*ops, cfg, drop)
