"""Small helpers shared by the port's entry points, and the twins of
``satrans_tpu/utils.py`` (the reference's utils.py grab-bag): composite
domain ids, seeds, the BPR loss and bipartite negative sampling (unused by
the CLI but part of the public surface, utils.py:144-235), memory info and
the per-column CTR spread.  IO helpers live in :mod:`data.io`.  The JAX
package's ``enable_compilation_cache`` has no twin: it acts on a TPU only,
and the port's kernel libraries are kept by ``ops/_build.py``.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from .ops import threefry


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  The default is the card; a
    machine without CUDA raises unless the caller asks for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' to "
            "run the plain PyTorch path on the CPU")
    return dev


def make_generator(seed: int, device) -> torch.Generator:
    """A seeded generator on ``device``: parameters are drawn where they
    live (the same seed gives different numbers on the CPU and the card)."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    return gen


def get_domain_feat(data: dict, domain_col: str, dids_map: dict | None = None):
    """Composite scenario ids: 'colA|colB' -> dense ids over observed tuples
    (reference utils.py:32-47)."""
    if domain_col in data:
        return [domain_col], dids_map
    cols = domain_col.split("|")
    stacked = np.stack([np.asarray(data[c]).reshape(-1) for c in cols], axis=1)
    tuples = [tuple(row) for row in stacked]
    if dids_map is None:
        uniq = sorted(set(tuples))
        dids_map = {t: i for i, t in enumerate(uniq)}
    data[domain_col] = np.asarray([dids_map[t] for t in tuples])
    return cols, dids_map


def set_random_seeds(seed: int = 0):
    """Seed numpy and ``random`` (reference utils.py:118-124) and return
    the key ``PRNGKey(seed)`` of ``ops.threefry``, as the JAX package
    returns ``jax.random.PRNGKey(seed)``."""
    np.random.seed(seed)
    random.seed(seed)
    return threefry.PRNGKey(seed)


def bpr_loss(positives: torch.Tensor, negatives: torch.Tensor,
             regularization=None, lambda_reg: float = 0.0) -> torch.Tensor:
    """Bayesian Personalized Ranking loss (reference utils.py:144-183)."""
    n_pairs = positives.shape[0]
    log_prob = torch.mean(torch.nn.functional.logsigmoid(
        positives - negatives))
    reg = lambda_reg * regularization if lambda_reg != 0 and \
        regularization is not None else 0.0
    return -log_prob + reg / n_pairs


def structured_negative_sampling_bipartite(key, edge_index, num_nodes: int,
                                           num_users: int):
    """For each (user, item) edge sample a negative item not in the edge set
    (reference utils.py:194-235), on the host with numpy.  The numpy seed
    is ``threefry.randint(key, 0, 2**31 - 1)``, the JAX package's draw from
    the same key, so the negatives are the JAX function's."""
    row, col = np.asarray(edge_index[0]), np.asarray(edge_index[1])
    pos = set(row * num_nodes + col)
    rng = np.random.default_rng(int(threefry.randint(key, 0, 2 ** 31 - 1)))
    neg = rng.integers(num_users, num_nodes, size=len(row))
    bad = np.asarray([r * num_nodes + n in pos for r, n in zip(row, neg)])
    while bad.any():
        neg[bad] = rng.integers(num_users, num_nodes, size=int(bad.sum()))
        bad = np.asarray([r * num_nodes + n in pos
                          for r, n in zip(row, neg)])
    return row, col, neg


def get_memory_info():
    try:
        import psutil
    except ImportError:
        return {}
    info = psutil.virtual_memory()
    return {"total_gb": info.total / 2**30, "used_gb": info.used / 2**30,
            "percent": info.percent}


def cal_ctr(data: dict, label_col: str = "click", max_unique: int = 20):
    """Per-column CTR spread: std of mean(label) over the column's values
    for low-cardinality columns (reference utils.py:13-19 ``cal_ctr``).
    Returns {column: std}."""
    import pandas as pd

    df = pd.DataFrame(data)
    out = {}
    for col in df.columns:
        if col != label_col and df[col].nunique() < max_unique:
            out[col] = float(df.groupby(col)[label_col].mean().std())
    return out


def df2dict(df):
    """DataFrame -> {column: values} (reference utils.py:49-53)."""
    return {col: df[col].values for col in df.columns}
