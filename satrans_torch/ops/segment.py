"""Segment reductions (twin of ``satrans_tpu/ops/segment.py``).

The reference takes ``scatter_mean`` from the ``torch_scatter`` extension
(star_trans.py:14, 850); the JAX package uses ``jax.ops.segment_sum``
and a count.  Here they are ``index_add`` over the leading axis, with
``jax.ops.segment_sum``'s treatment of ids outside ``[0,
num_segments)``: their rows are dropped (``index_add`` would raise on
them, or add a negative id into a row counted from the end), and their
gradient is zero.
"""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``[N, ...] -> [num_segments, ...]``: the sum of the rows of each
    segment id; rows whose id lies outside ``[0, num_segments)`` are
    dropped."""
    ids = segment_ids.long()
    inside = (ids >= 0) & (ids < num_segments)
    rows = torch.where(inside.view(-1, *[1] * (data.ndim - 1)), data, 0.0)
    out = data.new_zeros((num_segments, *data.shape[1:]))
    return out.index_add(0, ids.clamp(0, num_segments - 1), rows)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """The mean of the rows of each segment of ``[N, k]`` data; an empty
    segment's mean is 0 (its count is clamped at 1, as ``scatter_mean``
    gives)."""
    total = segment_sum(data, segment_ids, num_segments)
    count = segment_sum(torch.ones(data.shape[:1], dtype=data.dtype,
                                   device=data.device),
                        segment_ids, num_segments)
    return total / torch.clamp(count, min=1.0)[:, None]
