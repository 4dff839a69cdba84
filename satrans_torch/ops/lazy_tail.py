"""The lazy bank update's row tail in one pass (K5): Python side of
``csrc/bank_rows.cu:satrans_lazy_adam_rows``, twin of
``satrans_tpu/ops/pallas/lazy_tail.py:lazy_adam_rows``.

:func:`lazy_adam_rows` reads each touched row of bank, mu and nu, applies
the decayed Adam step and writes it back in place: on a CUDA tensor it
launches the kernel (and adds one to ``launches``) or raises; on a CPU
tensor it runs :func:`lazy_adam_rows_reference`.  An id outside ``[0, R)``
(the sentinel ``R``, or a negative one) is skipped; every other id must
appear at most once, because the tail reads and writes the same rows.
The arithmetic is lazy_tail.py:103-113, in that order.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import check_rows, kernel_fn, stream_of

launches = 0


def _adam(w, m, v, g, d1, d2, dw, c1inv, c2inv, lr, b1, b2, eps):
    m2 = (1.0 - b1) * g + b1 * (m * d1)
    v2 = (1.0 - b2) * (g * g) + b2 * (v * d2)
    w2 = w * dw - lr * ((m2 * c1inv) / (torch.sqrt(v2 * c2inv) + eps))
    return w2, m2, v2


def lazy_adam_rows_reference(bank, mu, nu, ids, g, d1, d2, dw, c1inv,
                             c2inv, *, lr, b1, b2, eps):
    """Plain PyTorch version, in place; returns ``(bank, mu, nu)``."""
    keep = (ids >= 0) & (ids < bank.shape[0])
    idx = ids[keep]
    dec = [t[keep][:, None] for t in (d1, d2, dw)]
    w2, m2, v2 = _adam(bank[idx], mu[idx], nu[idx], g[keep], *dec,
                       c1inv, c2inv, lr, b1, b2, eps)
    for arr, val in ((bank, w2), (mu, m2), (nu, v2)):
        arr.index_put_((idx,), val)
    return bank, mu, nu


def lazy_adam_rows(bank, mu, nu, ids, g, d1, d2, dw, c1inv: float,
                   c2inv: float, *, lr: float, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-8):
    """``bank``, ``mu``, ``nu`` ``[R, W]`` float32, updated in place;
    ``ids`` ``[N]`` int64, unique apart from ids outside ``[0, R)``; ``g``
    ``[N, W]`` the rows' gradients; ``d1``, ``d2``, ``dw`` ``[N]`` the
    decays ``b1^k``, ``b2^k``, ``(1 - 2 l2 lr)^(k+1)``; ``c1inv``,
    ``c2inv`` the step's bias-correction reciprocals.  Returns
    ``(bank, mu, nu)``."""
    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps)
    if ids.device.type == "cpu":
        return lazy_adam_rows_reference(bank, mu, nu, ids, g, d1, d2, dw,
                                        c1inv, c2inv, **kw)
    check_rows((bank, mu, nu), ids, "lazy_adam_rows")
    n, (rows, w) = ids.shape[0], bank.shape
    if g.dtype != torch.float32 or tuple(g.shape) != (n, w) or \
            not g.is_contiguous() or g.device != ids.device:
        raise ValueError(f"lazy_adam_rows: g must be contiguous float32 "
                         f"[{n}, {w}] on {ids.device}")
    if n == 0:
        return bank, mu, nu
    dec = torch.stack([d1, d2, dw], dim=1).to(torch.float32).contiguous()
    fn = kernel_fn("bank_rows", "satrans_lazy_adam_rows",
                   [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                    ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_float] * 8 + [ctypes.c_void_p])
    err = fn(ids.data_ptr(), n, rows, w, bank.data_ptr(), mu.data_ptr(),
             nu.data_ptr(), g.data_ptr(), dec.data_ptr(), c1inv, c2inv, lr,
             b1, b2, 1.0 - b1, 1.0 - b2, eps, stream_of(ids))
    if err:
        raise RuntimeError(f"lazy_adam_rows launch failed: CUDA error {err}")
    global launches
    launches += 1
    return bank, mu, nu
