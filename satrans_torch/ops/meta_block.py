"""The fused meta-transformer layer: Python side of the Hopper kernels
``csrc/meta_block_fwd.cu`` (K1-fwd) and ``csrc/meta_block_bwd.cu``
(K1-bwd, the recompute backward), twins of
``satrans_tpu/ops/pallas/meta_block.py``.

* :func:`fused_meta_layer` - the wrapper.  On a CUDA tensor it launches the
  forward kernel (through :class:`_MetaLayerFn` when a gradient is needed,
  whose backward launches K1-bwd) or raises; on a CPU tensor it runs
  :func:`meta_layer_reference`, and autograd differentiates that.
* :func:`meta_layer_reference` - the plain PyTorch version on the same
  operands (each example's own MetaNet weights, gathered by domain); its
  autograd backward is the plain version of K1-bwd.
* :func:`launch_fwd` / :func:`launch_bwd` - the kernel launches on packed
  operands (:func:`pack_operands`); ``launches`` / ``bwd_launches`` count
  them.

The packing of the operands (``wqkv``, the per-domain ``[D, d, h]`` and
``[D, h, d]`` MetaNet weights sliced out of the ``[D, P]`` tables, the
LayerNorm rows) is plain PyTorch outside the autograd function, so autograd
carries the kernel's gradients back to the layer's parameters and to the
tables; in the shared Q/K case the two paths are summed there, as the JAX
package's custom VJP leaves them to JAX (meta_block.py:1381-1384).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..nn import attention, metanet
from ..nn.attention import MetaTransformerLayer
from ._build import kernel_fn, stream_of

# (d, h, heads) instantiated in csrc/meta_block_{fwd,bwd}.cu, and the most
# fields an example may have
KERNEL_SHAPES = frozenset({(32, 64, 4)})
KERNEL_MAX_FIELDS = 20
# K1-bwd runs two blocks of 256 threads per SM (csrc/meta_block_bwd.cu)
BWD_BLOCKS_PER_SM = 2

launches = 0
bwd_launches = 0
_sm_count: dict[int, int] = {}


def meta_layer_reference(x, layer: MetaTransformerLayer, tables, dom, *,
                         meta_units: Sequence[int], head_num: int,
                         mode: str = "QK", relu_out: bool = False):
    """Plain PyTorch version of the kernels.  ``x`` ``[B, F, d]``;
    ``tables`` ``{'Q': [D, P], 'K': [D, P]}`` per-domain flat MetaNet
    params; ``dom`` ``[B]`` rows of the tables, in ``[0, D)``."""
    return attention.meta_transformer_apply(
        layer, x, tables, meta_units, mode=mode, head_num=head_num,
        relu_out=relu_out, domain_ids=dom.long(), dense_select=False)


def _needs_grad(x, layer, tables) -> bool:
    return torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in layer.parameters())
        or any(t.requires_grad for t in tables.values()))


def _meta_operands(tables, key: str, meta_units):
    """``[D, P]`` -> W1 ``[D, d, h]`` and W2 ``[D, h, d]``, contiguous."""
    w1, w2 = metanet.slice_weights(tables[key], meta_units)
    return w1.contiguous(), w2.contiguous()


def _ln(ln) -> torch.Tensor:
    return torch.stack([ln.scale, ln.bias]).contiguous()


def _check(x, meta_units, head_num: int, tables, train: bool) -> None:
    """Raise for what the kernels do not take."""
    B, F, d = x.shape
    if len(meta_units) != 3 or meta_units[0] != d or meta_units[2] != d:
        raise NotImplementedError(
            f"meta units {list(meta_units)}: the kernel takes 2-matrix "
            f"MetaNets [d, h, d] with d={d}")
    h = meta_units[1]
    if (d, h, head_num) not in KERNEL_SHAPES or F > KERNEL_MAX_FIELDS:
        raise NotImplementedError(
            f"meta_block kernel is built for (d, h, heads) in "
            f"{sorted(KERNEL_SHAPES)} and F <= {KERNEL_MAX_FIELDS}, got "
            f"({d}, {h}, {head_num}) and F={F}")
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


def launch_fwd(x, dom, wqkv, w1q, w2q, lnq, w1k, w2k, lnk, wout, lno,
               cfg) -> torch.Tensor:
    """K1-fwd: the layer's output for packed operands."""
    h, heads, apply_q, apply_k, relu_out = cfg
    B, F, d = x.shape
    ops = (x, dom, wqkv, w1q, w2q, lnq, w1k, w2k, lnk, wout, lno)
    for t in ops:
        if t.device != x.device:
            raise ValueError(f"operand on {t.device}, x on {x.device}")
        if t is dom:
            if dom.dtype != torch.int32 or not dom.is_contiguous():
                raise ValueError("dom must be contiguous int32")
            continue
        if t.dtype != torch.float32:
            raise ValueError(f"operand of type {t.dtype}, want float32")
        if t.data_ptr() % 16 or not t.is_contiguous():  # read as float4
            raise ValueError("float32 operand not contiguous and 16-byte "
                             "aligned")
    y = torch.empty_like(x)
    fn = kernel_fn("meta_block_fwd", "satrans_meta_block_fwd",
                   [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    err = fn(*(t.data_ptr() for t in ops), y.data_ptr(), B, F, d, h, heads,
             w1q.shape[0], apply_q, apply_k, relu_out, stream_of(x))
    if err:
        raise RuntimeError(f"meta_block_fwd launch failed: CUDA error {err}")
    global launches
    launches += 1
    return y


def launch_bwd(g, x, dom, wqkv, w1q, w2q, lnq, w1k, w2k, lnk, wout, lno,
               cfg):
    """K1-bwd: ``(dx, dwqkv, dw1q, dw2q, dlnq, dw1k, dw2k, dlnk, dwout,
    dlno)`` for the upstream gradient ``g`` of the layer's output."""
    h, heads, apply_q, apply_k, relu_out = cfg
    B, F, d = x.shape
    D = w1q.shape[0]
    g = g.contiguous()
    if g.dtype != torch.float32 or g.shape != x.shape:
        raise ValueError(f"gradient of type {g.dtype} and shape "
                         f"{tuple(g.shape)}, want float32 {tuple(x.shape)}")
    # every GEMM of the kernel reads its weights row-major [K, N]: the
    # backward's transposed products get transposed copies (a few kB)
    wqkv_t = wqkv.t().contiguous()
    wout_t = wout.t().contiguous()
    w1q_t, w2q_t = (w.transpose(1, 2).contiguous() for w in (w1q, w2q))
    w1k_t, w2k_t = ((w1q_t, w2q_t) if w1k is w1q and w2k is w2q else
                    (w.transpose(1, 2).contiguous() for w in (w1k, w2k)))
    dev = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    if dev not in _sm_count:
        _sm_count[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    # tiles of two examples
    blocks = min(BWD_BLOCKS_PER_SM * _sm_count[dev], (B + 1) // 2)
    total = kernel_fn("meta_block_bwd", "satrans_meta_block_bwd_grad_floats",
                      [ctypes.c_int] * 3)(d, h, D)
    dx = torch.empty_like(x)
    partial = torch.empty(blocks * total, dtype=torch.float32,
                          device=x.device)
    grads = torch.empty(total, dtype=torch.float32, device=x.device)
    ops = (x, dom, g, wqkv, wqkv_t, w1q, w2q, w1q_t, w2q_t, lnq, w1k, w2k,
           w1k_t, w2k_t, lnk, wout, wout_t, lno, dx, partial, grads)
    for t in ops:
        want = torch.int32 if t is dom else torch.float32
        if t.device != x.device or not t.is_contiguous() or \
                t.dtype != want or (t is not dom and t.data_ptr() % 16):
            raise ValueError("operands must lie on one device, contiguous, "
                             "dom int32, the rest float32 and 16-byte "
                             "aligned")
    fn = kernel_fn("meta_block_bwd", "satrans_meta_block_bwd",
                   [ctypes.c_void_p] * 21 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    err = fn(*(t.data_ptr() for t in ops), B, F, d, h, heads, D, apply_q,
             apply_k, relu_out, blocks, stream_of(x))
    if err:
        raise RuntimeError(f"meta_block_bwd launch failed: CUDA error {err}")
    global bwd_launches
    bwd_launches += 1
    sizes = [3 * d * d, d * d, 2 * d, 2 * d, 2 * d] + [D * d * h] * 4
    (dwqkv, dwout, dlnq, dlnk, dlno, dw1q, dw2q, dw1k,
     dw2k) = torch.split(grads, sizes)
    return (dx, dwqkv.view(d, 3 * d), dw1q.view(D, d, h), dw2q.view(D, h, d),
            dlnq.view(2, d), dw1k.view(D, d, h), dw2k.view(D, h, d),
            dlnk.view(2, d), dwout.view(d, d), dlno.view(2, d))


class _MetaLayerFn(torch.autograd.Function):
    """The layer with K1-fwd as its forward and K1-bwd as its backward
    (the JAX ``_fused_layer`` custom VJP with ``bwd='recompute'``): the
    forward saves only its inputs."""

    @staticmethod
    def forward(ctx, x, dom, wqkv, w1q, w2q, lnq, w1k, w2k, lnk, wout, lno,
                cfg):
        ctx.cfg = cfg
        ctx.save_for_backward(x, dom, wqkv, w1q, w2q, lnq, w1k, w2k, lnk,
                              wout, lno)
        return launch_fwd(x, dom, wqkv, w1q, w2q, lnq, w1k, w2k, lnk, wout,
                           lno, cfg)

    @staticmethod
    def backward(ctx, g):
        _, _, apply_q, apply_k, _ = ctx.cfg
        (dx, dwqkv, dw1q, dw2q, dlnq, dw1k, dw2k, dlnk, dwout,
         dlno) = launch_bwd(g, *ctx.saved_tensors, ctx.cfg)
        q = (dw1q, dw2q, dlnq) if apply_q else (None, None, None)
        k = (dw1k, dw2k, dlnk) if apply_k else (None, None, None)
        return (dx, None, dwqkv, *q, *k, dwout, dlno, None)


def pack_operands(x, layer: MetaTransformerLayer, tables, dom, *,
                  meta_units: Sequence[int], head_num: int,
                  mode: str = "QK", relu_out: bool = False):
    """The kernels' operands ``(x, dom, wqkv, w1q, w2q, lnq, w1k, w2k, lnk,
    wout, lno)`` and their ``cfg``, packed with differentiable PyTorch ops
    from the layer's parameters and the ``[D, P]`` tables."""
    x = x.contiguous()
    dom = dom.to(device=x.device, dtype=torch.int32).contiguous()
    wqkv = torch.cat([layer.wq, layer.wk, layer.wv], dim=1).contiguous()
    w1q, w2q = _meta_operands(tables, "Q", meta_units)
    w1k, w2k = (w1q, w2q) if tables["K"] is tables["Q"] \
        else _meta_operands(tables, "K", meta_units)
    lnm, lno = _ln(layer.q_meta.ln), _ln(layer.ln)
    cfg = (meta_units[1], head_num, int("Q" in mode), int("K" in mode),
           int(relu_out))
    return (x, dom, wqkv, w1q, w2q, lnm, w1k, w2k, lnm,
            layer.wout.contiguous(), lno), cfg


def fused_meta_layer(x, layer: MetaTransformerLayer, tables, dom, *,
                     meta_units: Sequence[int], head_num: int,
                     mode: str = "QK", relu_out: bool = False):
    """One meta-transformer layer; same operands as
    :func:`meta_layer_reference`.  Differentiable: with a gradient needed
    on the card, its backward is K1-bwd."""
    if x.device.type == "cpu":
        return meta_layer_reference(x, layer, tables, dom,
                                    meta_units=meta_units,
                                    head_num=head_num, mode=mode,
                                    relu_out=relu_out)
    if x.device.type != "cuda":
        raise ValueError(f"no meta_block kernel for device {x.device}")
    train = _needs_grad(x, layer, tables)
    _check(x, meta_units, head_num, tables, train)
    ops, cfg = pack_operands(x, layer, tables, dom, meta_units=meta_units,
                             head_num=head_num, mode=mode, relu_out=relu_out)
    if train:
        return _MetaLayerFn.apply(*ops, cfg)
    return launch_fwd(*ops, cfg)
