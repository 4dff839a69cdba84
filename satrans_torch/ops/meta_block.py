"""The fused meta-transformer layer: Python side of the Hopper kernels
``csrc/meta_block_fwd.cu`` (through its C entry the forward tile body
``csrc/meta_stash_fwd.cuh`` in all four modes: K1-fwd, which writes the
output alone; K1-stash, which also writes the backward's residuals;
K1-stash light, which writes all of them but the attention probabilities;
K1-scores, which writes the output and the attention probabilities alone,
for the probes) and ``csrc/meta_block_bwd.cu``
(through its C entry the backward tile body ``csrc/meta_stash_bwd.cuh``
in all three modes: K1-bwd, which recomputes the forward; K1-bwd-stash,
which reads the residuals; K1-bwd-stash light, which reads the light
ones and recomputes the probabilities), twins of
``satrans_tpu/ops/pallas/meta_block.py``.  The
tile bodies sort each block's range of the batch by domain themselves, so
the wrappers pass the batch in its own order and get every output back in
it.

* :func:`fused_meta_layer` - the wrapper.  On a CUDA tensor it launches
  the kernels or raises: with a gradient needed, ``bwd='stash'`` (the
  default; ``SATRANS_BWD`` overrides, as in the JAX package) runs
  :class:`_StashLayerFn` (K1-stash forward, K1-bwd-stash backward),
  ``bwd='stash_light'`` :class:`_StashLightLayerFn` (K1-stash light,
  K1-bwd-stash light) and ``bwd='recompute'`` :class:`_MetaLayerFn`
  (K1-fwd forward, K1-bwd backward); without, K1-fwd, which never
  stashes.  On a CPU tensor it runs :func:`meta_layer_reference` with the
  same dropout masks, and autograd differentiates that.
* :func:`fused_meta_layer_with_scores` - the layer's output and its
  attention probabilities ``[B, H, F, F]``, forward only (the showattn and
  instattn probes, ``train/attention_probe.py``): K1-scores on a CUDA
  tensor, the plain version's clamped probabilities on a CPU tensor.
* :func:`meta_layer_reference` - the plain PyTorch version on the same
  operands (each example's own MetaNet weights, gathered by domain); its
  autograd backward is the plain version of the three backward kernels,
  and its ``residuals`` the plain version of both stashes (the light one
  without ``s``).
* :func:`layer_masks` - the dropout masks the kernels compute inline
  (``ops/prng.py``): in training at ``drop_rate > 0``, the JAX package's
  interpret-mode masks for the layer's ``seed`` and tile ``block_b``.
* :func:`launch_fwd` / :func:`launch_bwd` - the kernel launches on packed
  operands (:func:`pack_operands`); ``launches`` / ``stash_launches`` /
  ``stash_light_launches`` / ``scores_launches`` / ``bwd_launches`` /
  ``stash_bwd_launches`` / ``stash_light_bwd_launches`` count them.

The packing of the operands (``wqkv``, the per-domain MetaNet weights
sliced out of the ``[D, P]`` tables: ``W1 [D, d, h1]``, for a 3-matrix
MetaNet ``[d, h1, h2, d]`` the middle ``Wm [D, h1, h2]`` (``None`` for a
2-matrix one), ``W2 [D, h_last, d]``; the LayerNorm rows) is plain
PyTorch outside the autograd function, so autograd carries the kernel's
gradients back to the layer's parameters and to the tables, the middle
matrix's into the tables' ``[h1 * h2]`` block.  MetaNets of other depths
have no kernel: the model sends them to the plain layer, as the JAX
package sends them to its XLA layer.  The 'pos' model gives each layer
distinct Q and K tables and a ``k_meta`` LayerNorm; in the shared case
(one table, the ``q_meta`` LayerNorm for both) the two paths are summed
there, as the JAX package's custom VJP leaves them to JAX
(meta_block.py:1381-1384).
"""

from __future__ import annotations

import ctypes
import os
from typing import Sequence

import torch

from ..nn import attention, metanet
from ..nn.attention import MetaTransformerLayer
from . import prng
from ._build import (check_operands, kernel_fn, needs_grad, sm_count,
                     stream_of)

# (d, h1, h2, heads) instantiated in csrc/meta_block_{fwd,bwd}.cu (with_shape,
# csrc/layer_common.cuh; h2 = 0: a 2-matrix MetaNet [d, h1, d], else
# [d, h1, h2, d]), and the most fields an example may have
KERNEL_SHAPES = frozenset({(32, 64, 0, 4), (32, 64, 64, 4)})
# MetaNets of 2 and 3 matrices have a kernel (satrans_tpu/models/
# satrans.py:372, len(meta_units) in (3, 4))
KERNEL_DEPTHS = (3, 4)
KERNEL_MAX_FIELDS = 20

BWD_MODES = ("stash", "stash_light", "recompute")
# the residuals of each stash ('scores': K1-scores' probabilities), in the
# kernels' argument order, and the C entries' stash argument (enum
# StashMode, csrc/layer_common.cuh)
STASH_RESIDUALS = {"full": ("qkv", "uq", "uk", "s", "o"),
                   "light": ("qkv", "uq", "uk", "o"), "scores": ("s",)}
_STASH_MODE = {None: 0, "full": 1, "light": 2, "scores": 3}
# the packed operands (x, dom, wqkv, w1q, wmq, w2q, lnq, w1k, wmk, w2k, lnk,
# wout, lno): pack_operands
N_OPERANDS = 13

launches = 0                  # K1-fwd
stash_launches = 0            # K1-stash
stash_light_launches = 0      # K1-stash light
scores_launches = 0           # K1-scores
bwd_launches = 0              # K1-bwd
stash_bwd_launches = 0        # K1-bwd-stash
stash_light_bwd_launches = 0  # K1-bwd-stash light


def meta_layer_reference(x, layer: MetaTransformerLayer, tables, dom, *,
                         meta_units: Sequence[int], head_num: int,
                         mode: str = "QK", relu_out: bool = False,
                         masks=None, residuals: dict | None = None,
                         clamp: bool = True):
    """Plain PyTorch version of the kernels.  ``x`` ``[B, F, d]``;
    ``tables`` ``{'Q': [D, P], 'K': [D, P]}`` per-domain flat MetaNet
    params (one tensor for both, or distinct ones); ``dom`` ``[B]`` rows of
    the tables, in ``[0, D)``; ``masks`` from :func:`layer_masks`;
    ``residuals`` receives K1-stash's (``nn.attention.
    meta_transformer_apply``; K1-stash light's are all of them but
    ``s``).  The attention logits are clamped to [-60, 60] as in the
    kernels; ``clamp=False`` is the JAX package's XLA layer, which does not
    clamp."""
    return attention.meta_transformer_apply(
        layer, x, tables, meta_units, mode=mode, head_num=head_num,
        relu_out=relu_out, domain_ids=dom.long(), dense_select=False,
        masks=masks, residuals=residuals, clamp=clamp)


def layer_masks(x, *, head_num: int, mode: str, train: bool,
                drop_rate: float, seed: int, block_b: int):
    """The dropout masks of one layer on ``x`` ``[B, F, d]``
    (``prng.dropout_masks``), or ``None`` outside training or at rate 0."""
    if not (train and drop_rate > 0.0):
        return None
    B, F, d = x.shape
    return prng.dropout_masks(seed, B, F, d, head_num, block_b, drop_rate,
                              "Q" in mode, "K" in mode, x.device)


def bwd_mode(bwd: str | None = None) -> str:
    """The backward kernel pair: ``bwd``, else ``SATRANS_BWD``, else
    'stash' (the JAX package's rule, meta_block.py:1420-1424): 'stash',
    'stash_light' (the probabilities recomputed from the stashed pre-LN
    sums) or 'recompute'."""
    if bwd is None:
        bwd = os.environ.get("SATRANS_BWD", "stash")
    if bwd not in BWD_MODES:
        raise ValueError(f"unknown bwd mode {bwd!r}")
    return bwd


def check_stash_dtype() -> None:
    """The JAX package's ``SATRANS_STASH`` rule (meta_block.py:1432-1435):
    'f32' (the default) is the port's stash; 'bf16' is not ported."""
    dtype = os.environ.get("SATRANS_STASH", "f32")
    if dtype == "bf16":
        raise NotImplementedError(
            "SATRANS_STASH=bf16 (the bf16 residual stash) is ROADMAP queue 2 "
            "item 'K1 in bf16'")
    if dtype != "f32":
        raise ValueError(f"unknown stash dtype {dtype!r}")


def _meta_operands(tables, key: str, meta_units):
    """``[D, P]`` -> W1 ``[D, d, h1]``, Wm ``[D, h1, h2]`` (``None`` for a
    2-matrix MetaNet) and W2 ``[D, h_last, d]``, contiguous."""
    ws = [w.contiguous()
          for w in metanet.slice_weights(tables[key], meta_units)]
    return ws[0], (ws[1] if len(ws) == 3 else None), ws[-1]


def hidden_widths(meta_units) -> tuple[int, int]:
    """``(h1, h2)`` of a kernel MetaNet, ``h2 = 0`` for 2 matrices."""
    h2 = int(meta_units[2]) if len(meta_units) == 4 else 0
    return int(meta_units[1]), h2


def _ln(ln) -> torch.Tensor:
    return torch.stack([ln.scale, ln.bias]).contiguous()


def _check(x, meta_units, head_num: int, tables, train: bool) -> None:
    """Raise for what the kernels do not take."""
    B, F, d = x.shape
    if len(meta_units) not in KERNEL_DEPTHS or meta_units[0] != d \
            or meta_units[-1] != d:
        raise NotImplementedError(
            f"meta units {list(meta_units)}: the kernel takes 2- and "
            f"3-matrix MetaNets [d, h1, d] and [d, h1, h2, d] with d={d}; "
            "other depths take the plain layer")
    h, h2 = hidden_widths(meta_units)
    if (d, h, h2, head_num) not in KERNEL_SHAPES or F > KERNEL_MAX_FIELDS:
        raise NotImplementedError(
            f"meta_block kernel is built for (d, h1, h2, heads) in "
            f"{sorted(KERNEL_SHAPES)} and F <= {KERNEL_MAX_FIELDS}, got "
            f"({d}, {h}, {h2}, {head_num}) and F={F}")
    if x.dtype != torch.float32:
        raise NotImplementedError(f"meta_block kernel takes float32, got "
                                  f"{x.dtype}")
    if train:
        D = tables["Q"].shape[0]
        most = kernel_fn("meta_block_bwd",
                         "satrans_meta_block_bwd_max_domains", [])()
        if D > most:
            raise NotImplementedError(
                f"meta_block_bwd keeps every meta row's gradient sums per "
                f"block and takes at most {most} rows, got {D}: more meta "
                "rows are ROADMAP queue 2 item 'K1-bwd for many meta rows'")


def _residual_shapes(B: int, F: int, d: int, heads: int, stash: str):
    """The shapes of a stash's residuals (:data:`STASH_RESIDUALS`)."""
    shapes = {"qkv": (B, F, 3 * d), "uq": (B, F, d), "uk": (B, F, d),
              "s": (B, heads, F, F), "o": (B, F, d)}
    return [shapes[n] for n in STASH_RESIDUALS[stash]]


def _residual_ptrs(res, stash):
    """The C entries' five residual pointers, None where the stash has no
    such residual (all of them without a stash)."""
    if stash is None:
        return [None] * len(STASH_RESIDUALS["full"])
    ptrs = dict(zip(STASH_RESIDUALS[stash], (r.data_ptr() for r in res)))
    return [ptrs.get(n) for n in STASH_RESIDUALS["full"]]


def ptrs(ops):
    """The operands' device pointers, None (a null pointer) for a missing
    one (a 2-matrix MetaNet's middle matrices)."""
    return [None if t is None else t.data_ptr() for t in ops]


def present(ops):
    """The operands that are there (see :func:`ptrs`)."""
    return tuple(t for t in ops if t is not None)


def launch_fwd(x, dom, wqkv, w1q, wmq, w2q, lnq, w1k, wmk, w2k, lnk, wout,
               lno, cfg, drop, stash: str | None = None):
    """K1-fwd: the layer's output for packed operands (``wmq``/``wmk`` the
    middle matrices, ``None`` for 2-matrix MetaNets); with
    ``stash='full'`` K1-stash: ``(y, qkv, uq, uk, s, o)``; with
    ``stash='light'`` K1-stash light: ``(y, qkv, uq, uk, o)``; with
    ``stash='scores'`` K1-scores: ``(y, s)``.  ``drop`` is
    ``prng.kernel_args(...)``.  All four modes run on the forward tile
    body, one block an SM, whose y is the same in each."""
    h, h2, heads, apply_q, apply_k, relu_out = cfg
    B, F, d = x.shape
    ops = (x, dom, wqkv, w1q, wmq, w2q, lnq, w1k, wmk, w2k, lnk, wout, lno)
    check_operands(present(ops), x.device, ints=(dom,))
    y = torch.empty_like(x)
    res = () if stash is None else tuple(
        x.new_empty(shape)
        for shape in _residual_shapes(B, F, d, heads, stash))
    fn = kernel_fn("meta_block_fwd", "satrans_meta_block_fwd",
                   [ctypes.c_void_p] * 19 + [ctypes.c_int] * 13
                   + [ctypes.c_uint, ctypes.c_uint, ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    err = fn(*ptrs(ops + (y,)), *_residual_ptrs(res, stash),
             _STASH_MODE[stash], B, F, d, h, h2, heads, w1q.shape[0],
             apply_q, apply_k, relu_out, sm_count(x.device), *drop,
             stream_of(x))
    if err:
        raise RuntimeError(f"meta_block_fwd launch failed: CUDA error {err}")
    global launches, stash_launches, stash_light_launches, scores_launches
    if stash is None:
        launches += 1
        return y
    if stash == "full":
        stash_launches += 1
    elif stash == "light":
        stash_light_launches += 1
    else:
        scores_launches += 1
    return (y,) + res


def launch_bwd(g, x, dom, wqkv, w1q, wmq, w2q, lnq, w1k, wmk, w2k, lnk,
               wout, lno, cfg, drop, res=None):
    """K1-bwd; with K1-stash's residuals ``res = (qkv, uq, uk, s, o)``
    K1-bwd-stash; with K1-stash light's ``res = (qkv, uq, uk, o)``
    K1-bwd-stash light: ``(dx, dwqkv, dw1q, dwmq, dw2q, dlnq, dw1k, dwmk,
    dw2k, dlnk, dwout, dlno)`` (``dwmq``/``dwmk`` None for 2-matrix
    MetaNets) for the upstream gradient ``g`` of the layer's output.  All
    three run on the backward tile body, one block an SM (at most one a
    tile), and the result is deterministic for a grid."""
    h, h2, heads, apply_q, apply_k, relu_out = cfg
    B, F, d = x.shape
    D = w1q.shape[0]
    g = g.contiguous()
    if g.dtype != torch.float32 or g.shape != x.shape:
        raise ValueError(f"gradient of type {g.dtype} and shape "
                         f"{tuple(g.shape)}, want float32 {tuple(x.shape)}")
    stash = None
    if res is not None:
        stash = "full" if len(res) == len(STASH_RESIDUALS["full"]) \
            else "light"
        want = _residual_shapes(B, F, d, heads, stash)
        if [tuple(r.shape) for r in res] != want:
            raise ValueError(f"residuals of shapes "
                             f"{[tuple(r.shape) for r in res]}, want {want}")
        check_operands(res, x.device)
    blocks = kernel_fn("meta_block_bwd",
                       "satrans_meta_block_bwd_stash_blocks",
                       [ctypes.c_int] * 3)(B, F, sm_count(x.device))
    total = grad_floats(d, h, h2, heads, D)
    dx = torch.empty_like(x)
    partial = torch.empty(blocks * total, dtype=torch.float32,
                          device=x.device)
    grads = torch.empty(total, dtype=torch.float32, device=x.device)
    ops = (x, dom, g, wqkv, w1q, wmq, w2q, lnq, w1k, wmk, w2k, lnk, wout,
           lno, dx, partial, grads)
    check_operands(present(ops), x.device, ints=(dom,))
    fn = kernel_fn("meta_block_bwd", "satrans_meta_block_bwd",
                   [ctypes.c_void_p] * 22 + [ctypes.c_int] * 13
                   + [ctypes.c_uint, ctypes.c_uint, ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    err = fn(*ptrs(ops), *_residual_ptrs(res, stash), _STASH_MODE[stash],
             B, F, d, h, h2, heads, D, apply_q, apply_k, relu_out, blocks,
             *drop, stream_of(x))
    if err:
        raise RuntimeError(f"meta_block_bwd launch failed: CUDA error {err}")
    global bwd_launches, stash_bwd_launches, stash_light_bwd_launches
    if stash is None:
        bwd_launches += 1
    elif stash == "full":
        stash_bwd_launches += 1
    else:
        stash_light_bwd_launches += 1
    return (dx, *split_grads(grads, d, h, h2, D))


def grad_floats(d: int, h: int, h2: int, heads: int, rows: int) -> int:
    """Floats of the backward kernels' gradient buffer for ``rows`` MetaNet
    rows (K1's domains, K7's tiles; 0: a block's dense and LayerNorm sums
    alone)."""
    return kernel_fn("meta_block_bwd", "satrans_meta_block_bwd_grad_floats",
                     [ctypes.c_int] * 5)(d, h, h2, heads, rows)


def split_grads(grads, d: int, h: int, h2: int, D: int):
    """The backward kernels' gradient buffer (``dWqkv | dWout | LN_q, LN_k,
    LN_o | dW1q | dWmq | dW2q | dW1k | dWmk | dW2k``, ``D`` rows of each
    MetaNet block, no ``dWm`` blocks for ``h2 = 0``) as ``(dwqkv, dw1q,
    dwmq, dw2q, dlnq, dw1k, dwmk, dw2k, dlnk, dwout, dlno)``, ``dwmq`` and
    ``dwmk`` None for ``h2 = 0``."""
    hl = h2 or h
    meta = [(d, h), (h, h2), (hl, d)]
    sizes = [3 * d * d, d * d, 2 * d, 2 * d, 2 * d] + [
        D * a * b for a, b in meta] * 2
    parts = torch.split(grads, sizes)
    dwqkv, dwout, dlnq, dlnk, dlno = parts[:5]
    q, k = ([None if h2 == 0 and i == 1 else p.view(D, *meta[i])
             for i, p in enumerate(parts[j:j + 3])] for j in (5, 8))
    return (dwqkv.view(d, 3 * d), *q, dlnq.view(2, d), *k, dlnk.view(2, d),
            dwout.view(d, d), dlno.view(2, d))


def input_grads(grads, cfg):
    """The kernels' gradients but dx (:func:`split_grads`) as the autograd
    functions' input gradients of the weight operands (None for an
    unapplied projection's MetaNet and LayerNorm)."""
    _, _, _, apply_q, apply_k, _ = cfg
    (dwqkv, dw1q, dwmq, dw2q, dlnq, dw1k, dwmk, dw2k, dlnk, dwout,
     dlno) = grads
    q = (dw1q, dwmq, dw2q, dlnq) if apply_q else (None,) * 4
    k = (dw1k, dwmk, dw2k, dlnk) if apply_k else (None,) * 4
    return (dwqkv, *q, *k, dwout, dlno)


def _input_grads(grads, cfg):
    """The kernel's gradients as the autograd functions' input gradients
    (None for dom, for an unapplied projection's operands, cfg and
    drop)."""
    dx, *rest = grads
    return (dx, None, *input_grads(rest, cfg), None, None)


class _MetaLayerFn(torch.autograd.Function):
    """The layer with K1-fwd as its forward and K1-bwd as its backward
    (the JAX ``_fused_layer`` custom VJP with ``bwd='recompute'``): the
    forward saves only its inputs."""

    @staticmethod
    def forward(ctx, *args):
        *ops, cfg, drop = args
        ctx.cfg, ctx.drop = cfg, drop
        ctx.save_for_backward(*ops)
        return launch_fwd(*ops, cfg, drop)

    @staticmethod
    def backward(ctx, g):
        return _input_grads(
            launch_bwd(g, *ctx.saved_tensors, ctx.cfg, ctx.drop), ctx.cfg)


def _stash_forward(ctx, stash, args):
    """The forward of the stash autograd functions: the ``stash`` body on
    ``args = (*ops, cfg, drop)``, saving its inputs and residuals."""
    *ops, cfg, drop = args
    ctx.cfg, ctx.drop = cfg, drop
    y, *res = launch_fwd(*ops, cfg, drop, stash=stash)
    ctx.save_for_backward(*ops, *res)
    return y


def _stash_backward(ctx, g):
    """The backward of the stash autograd functions: the backward body
    that reads the saved residuals (their count tells the stash)."""
    saved = ctx.saved_tensors
    return _input_grads(launch_bwd(g, *saved[:N_OPERANDS], ctx.cfg,
                                   ctx.drop, res=saved[N_OPERANDS:]),
                        ctx.cfg)


class _StashLayerFn(torch.autograd.Function):
    """The layer with K1-stash as its forward and K1-bwd-stash as its
    backward (the JAX ``_fused_layer`` custom VJP with ``bwd='stash'``):
    the forward saves its inputs and the five residuals, 166.9 MB a layer
    at the AliCCP sota shape (B=8192, F=19, d=32)."""

    @staticmethod
    def forward(ctx, *args):
        return _stash_forward(ctx, "full", args)

    backward = staticmethod(_stash_backward)


class _StashLightLayerFn(torch.autograd.Function):
    """The layer with K1-stash light as its forward and K1-bwd-stash light
    as its backward (``bwd='stash_light'``): the residuals but the
    ``[B, H, F, F]`` probabilities, which the backward recomputes from the
    pre-LN sums (119.5 MB a layer at the AliCCP sota shape, 94.4 MB at
    Alimama's F=15, against 166.9 and 123.9 MB)."""

    @staticmethod
    def forward(ctx, *args):
        return _stash_forward(ctx, "light", args)

    backward = staticmethod(_stash_backward)


_LAYER_FNS = {"stash": _StashLayerFn, "stash_light": _StashLightLayerFn,
              "recompute": _MetaLayerFn}


def pack_weights(layer: MetaTransformerLayer, tables, *,
                 meta_units: Sequence[int], head_num: int,
                 mode: str = "QK", relu_out: bool = False):
    """The weight operands ``(wqkv, w1q, wmq, w2q, lnq, w1k, wmk, w2k, lnk,
    wout, lno)`` (``wmq``/``wmk`` None for 2-matrix MetaNets) and the
    ``cfg`` ``(h1, h2, heads, apply_q, apply_k, relu_out)`` of K1 and K7,
    packed with differentiable PyTorch ops from the layer's parameters and
    the ``[rows, P]`` tables (K1's domains, K7's tiles)."""
    wqkv = torch.cat([layer.wq, layer.wk, layer.wv], dim=1).contiguous()
    meta_q = _meta_operands(tables, "Q", meta_units)
    meta_k = meta_q if tables["K"] is tables["Q"] \
        else _meta_operands(tables, "K", meta_units)
    lnq = _ln(layer.q_meta.ln)
    # the 'pos' layer's own K LayerNorm; else Q's, one tensor for both
    k_meta = getattr(layer, "k_meta", None)
    lnk = lnq if k_meta is None else _ln(k_meta.ln)
    cfg = (*hidden_widths(meta_units), head_num, int("Q" in mode),
           int("K" in mode), int(relu_out))
    return (wqkv, *meta_q, lnq, *meta_k, lnk, layer.wout.contiguous(),
            _ln(layer.ln)), cfg


def pack_operands(x, layer: MetaTransformerLayer, tables, dom, *,
                  meta_units: Sequence[int], head_num: int,
                  mode: str = "QK", relu_out: bool = False):
    """The kernels' operands ``(x, dom, wqkv, w1q, wmq, w2q, lnq, w1k, wmk,
    w2k, lnk, wout, lno)`` and their ``cfg``, packed with differentiable
    PyTorch ops from the layer's parameters and the ``[D, P]`` tables."""
    weights, cfg = pack_weights(layer, tables, meta_units=meta_units,
                                head_num=head_num, mode=mode,
                                relu_out=relu_out)
    dom = dom.to(device=x.device, dtype=torch.int32).contiguous()
    return (x.contiguous(), dom, *weights), cfg


def fused_meta_layer(x, layer: MetaTransformerLayer, tables, dom, *,
                     meta_units: Sequence[int], head_num: int,
                     mode: str = "QK", relu_out: bool = False,
                     train: bool = False, drop_rate: float = 0.0,
                     seed: int = 0, block_b: int = 128,
                     bwd: str | None = None):
    """One meta-transformer layer; same operands as
    :func:`meta_layer_reference`.  ``train`` with ``drop_rate > 0``
    applies the dropout of ``seed`` on tiles of ``block_b`` examples (the
    JAX ``fused_meta_layer_vjp``'s arguments).  Differentiable: with a
    gradient needed on the card, ``bwd`` ('stash', 'stash_light' or
    'recompute', see :func:`bwd_mode`) picks the kernel pair."""
    bwd = bwd_mode(bwd)
    check_stash_dtype()
    if x.device.type == "cpu":
        masks = layer_masks(x, head_num=head_num, mode=mode, train=train,
                            drop_rate=drop_rate, seed=seed, block_b=block_b)
        return meta_layer_reference(x, layer, tables, dom,
                                    meta_units=meta_units,
                                    head_num=head_num, mode=mode,
                                    relu_out=relu_out, masks=masks)
    if x.device.type != "cuda":
        raise ValueError(f"no meta_block kernel for device {x.device}")
    grad = needs_grad(x, layer, tables)
    _check(x, meta_units, head_num, tables, grad)
    ops, cfg = pack_operands(x, layer, tables, dom, meta_units=meta_units,
                             head_num=head_num, mode=mode, relu_out=relu_out)
    drop = prng.kernel_args(train, drop_rate, seed, block_b, x.shape[1])
    if not grad:  # eval, serving: never stash (meta_block.py:1314-1319)
        return launch_fwd(*ops, cfg, drop)
    return _LAYER_FNS[bwd].apply(*ops, cfg, drop)


def fused_meta_layer_with_scores(x, layer: MetaTransformerLayer, tables, dom,
                                 *, meta_units: Sequence[int], head_num: int,
                                 mode: str = "QK", relu_out: bool = False,
                                 train: bool = False, drop_rate: float = 0.0,
                                 seed: int = 0, block_b: int = 128):
    """The layer's output and its attention probabilities: ``(y, scores)``,
    ``scores`` ``[B, H, F, F]`` float32 before dropout, the logits clamped
    to [-60, 60] (the JAX ``fused_meta_layer_with_scores``, meta_block.py:
    502, which returns the stash forward's probabilities per example and
    cut to the real F).  Operands as :func:`fused_meta_layer`'s.  On a CUDA
    tensor K1-scores (one launch); on a CPU tensor
    :func:`meta_layer_reference`'s ``s`` residual.  Forward only, as the
    JAX function: it raises where autograd would need a gradient through
    it (call it under ``torch.no_grad()``)."""
    if needs_grad(x, layer, tables):
        raise RuntimeError(
            "fused_meta_layer_with_scores is forward only (the probes' "
            "path, as the JAX package's): call it under torch.no_grad()")
    check_stash_dtype()
    if x.device.type == "cpu":
        masks = layer_masks(x, head_num=head_num, mode=mode, train=train,
                            drop_rate=drop_rate, seed=seed, block_b=block_b)
        res = {}
        y = meta_layer_reference(x, layer, tables, dom,
                                 meta_units=meta_units, head_num=head_num,
                                 mode=mode, relu_out=relu_out, masks=masks,
                                 residuals=res)
        return y, res["s"]
    if x.device.type != "cuda":
        raise ValueError(f"no meta_block kernel for device {x.device}")
    _check(x, meta_units, head_num, tables, False)
    ops, cfg = pack_operands(x, layer, tables, dom, meta_units=meta_units,
                             head_num=head_num, mode=mode, relu_out=relu_out)
    drop = prng.kernel_args(train, drop_rate, seed, block_b, x.shape[1])
    return launch_fwd(*ops, cfg, drop, stash="scores")
