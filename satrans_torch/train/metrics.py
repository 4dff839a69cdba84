"""Evaluation metrics (twin of ``satrans_tpu/train/metrics.py``).

* :func:`auc` - exact ROC-AUC from tie-averaged ranks (equals
  ``sklearn.metrics.roc_auc_score``) in O(n log n).
* :func:`auc_torch` - the same rank-sum AUC on the tensors' device (the
  twin of ``auc_jax``), over a 0/1-weighted subset, so that
  ``Trainer.evaluate_domains`` keeps its scores on the card.
* :func:`log_loss` - sklearn-compatible mean BCE with its eps clip (the
  reference's train metric 'binary_crossentropy', basemodel.py:601-605).
* :func:`per_domain_auc` - AUC per scenario value min..max of the split
  (reference main.py:368-374).
"""

from __future__ import annotations

import numpy as np
import torch


def _tie_average_ranks(scores: np.ndarray) -> np.ndarray:
    """1-based ranks with ties sharing their average rank."""
    order = np.argsort(scores, kind="mergesort")
    s = scores[order]
    n = len(s)
    ranks = np.empty(n, dtype=np.float64)
    boundary = np.concatenate(([True], s[1:] != s[:-1]))
    group_ids = np.cumsum(boundary) - 1
    n_groups = group_ids[-1] + 1 if n else 0
    counts = np.bincount(group_ids, minlength=n_groups).astype(np.float64)
    # rank of the last element of each group, averaged over the tie run
    last = np.cumsum(counts)
    avg = last - (counts - 1) / 2.0
    ranks[order] = avg[group_ids]
    return ranks


def auc(y_true, y_score) -> float:
    """Mann-Whitney rank AUC with tie correction."""
    y = np.asarray(y_true).ravel().astype(np.float64)
    s = np.asarray(y_score).ravel().astype(np.float64)
    n_pos = float(y.sum())
    n_neg = float(len(y) - n_pos)
    if n_pos == 0 or n_neg == 0:
        raise ValueError("AUC undefined with a single class")
    ranks = _tie_average_ranks(s)
    return float((ranks[y == 1].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def auc_torch(y_true: torch.Tensor, y_score: torch.Tensor,
              weight: torch.Tensor | None = None) -> torch.Tensor:
    """On-device rank AUC with tie-averaged weighted ranks (twin of
    ``auc_jax``, metrics.py:53-85), as a float64 scalar tensor.

    ``weight`` (0/1) restricts it to a subset with static shapes; a
    subset of one class gives NaN.  The ranks come from a stable argsort
    (``jnp.argsort`` is stable) and segment sums over the tie groups; the
    sums are float64, ``auc_jax``'s precision under ``jax_enable_x64``.
    """
    y = y_true.reshape(-1).to(torch.float64)
    s = y_score.reshape(-1)
    w = torch.ones_like(y) if weight is None else \
        weight.reshape(-1).to(torch.float64)
    n = s.shape[0]
    order = torch.argsort(s, stable=True)
    s_sorted, w_sorted = s[order], w[order]
    cw = torch.cumsum(w_sorted, 0)
    same_as_prev = torch.cat([torch.zeros(1, dtype=torch.bool,
                                          device=s.device),
                              s_sorted[1:] == s_sorted[:-1]])
    group = torch.cumsum((~same_as_prev).to(torch.int64), 0) - 1
    grp_w = torch.zeros(n, dtype=torch.float64, device=s.device) \
        .index_add_(0, group, w_sorted)
    grp_cw_end = torch.zeros(n, dtype=torch.float64, device=s.device) \
        .scatter_reduce_(0, group, cw, "amax", include_self=False)
    # weighted count strictly below, plus the tie group's average
    rank_sorted = grp_cw_end[group] - grp_w[group] \
        + (grp_w[group] + 1.0) / 2.0
    ranks = torch.empty_like(rank_sorted)
    ranks[order] = rank_sorted
    n_pos = torch.sum(w * y)
    n_neg = torch.sum(w) - n_pos
    return (torch.sum(w * y * ranks) - n_pos * (n_pos + 1.0) / 2.0) \
        / (n_pos * n_neg)


def log_loss(y_true, y_pred, eps: float = 1e-15) -> float:
    """Mean BCE with sklearn's probability clipping."""
    y = np.asarray(y_true).ravel().astype(np.float64)
    p = np.clip(np.asarray(y_pred).ravel().astype(np.float64), eps, 1 - eps)
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))


def accuracy(y_true, y_pred) -> float:
    y = np.asarray(y_true).ravel()
    return float(np.mean((np.asarray(y_pred).ravel() > 0.5) == (y > 0.5)))


def mse(y_true, y_pred) -> float:
    return float(np.mean(np.square(np.asarray(y_true).ravel()
                                   - np.asarray(y_pred).ravel())))


def per_domain_auc(y_true, y_score, domain_values) -> dict[int, float]:
    """AUC per scenario value, min..max like reference main.py:368."""
    d = np.asarray(domain_values).ravel()
    out = {}
    for v in range(int(d.min()), int(d.max()) + 1):
        m = d == v
        out[v] = auc(np.asarray(y_true).ravel()[m],
                     np.asarray(y_score).ravel()[m])
    return out


METRICS = {
    "auc": auc,
    "binary_crossentropy": log_loss,
    "logloss": log_loss,
    "mse": mse,
    "accuracy": accuracy,
    "acc": accuracy,
}


def get_metric(name):
    if callable(name):
        return name
    try:
        return METRICS[name]
    except KeyError:
        raise NotImplementedError(f"metric {name!r}") from None
