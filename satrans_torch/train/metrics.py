"""Evaluation metrics (twin of the numpy part of
``satrans_tpu/train/metrics.py``).

* :func:`auc` - exact ROC-AUC from tie-averaged ranks (equals
  ``sklearn.metrics.roc_auc_score``) in O(n log n).
* :func:`log_loss` - sklearn-compatible mean BCE with its eps clip (the
  reference's train metric 'binary_crossentropy', basemodel.py:601-605).
* :func:`per_domain_auc` - AUC per scenario value min..max of the split
  (reference main.py:368-374).

The on-device rank AUC (``auc_jax``) comes with the distributed paths.
"""

from __future__ import annotations

import numpy as np


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
