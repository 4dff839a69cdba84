"""Alimama (Taobao display ads) fields, loader and temporal split (twin of
the constants, ``load`` and ``split_by_time`` of
``satrans_tpu/data/alimama.py``; the pandas preprocessing of the raw CSVs
is not ported yet, ROADMAP queue 1 item 'data/ and native/').  ``load``
needs ``h5py`` (imported when it is called).

``DATA_MAX`` holds the public dataset's vocab sizes that the JAX package's
``bench.py`` pins for its Alimama sota-pos arm (26 M impressions, 1.14 M
users, 846 k ads), so that the configuration runs without the download.
Embedding vocab of a field = ``DATA_MAX[field] + 2``.
"""

from __future__ import annotations

import time

import numpy as np

from . import io

SPARSE_FEATURES = ["user_id", "adgroup_id", "pid", "cms_segid",
                   "cms_group_id", "final_gender_code", "age_level",
                   "pvalue_level", "shopping_level", "occupation",
                   "new_user_class_level", "cate_id", "campaign_id",
                   "customer", "brand"]

DENSE_FEATURES = ["price"]
SPLIT_TIMESTAMP = "2017-05-12 00:00:00"

DATA_MAX = {
    "user_id": 1_141_729, "adgroup_id": 846_811, "pid": 1, "cms_segid": 97,
    "cms_group_id": 13, "final_gender_code": 2, "age_level": 7,
    "pvalue_level": 3, "shopping_level": 3, "occupation": 2,
    "new_user_class_level": 4, "cate_id": 12_960, "campaign_id": 423_436,
    "customer": 255_875, "brand": 461_497,
}

# the sota-pos configuration's scenario column and its domains
DOMAIN_COL, NUM_DOMAINS = "shopping_level", 3


def load(h5_path: str) -> dict[str, np.ndarray]:
    return io.load_h5_dict(h5_path)


def split_by_time(data: dict[str, np.ndarray]):
    """Temporal train/test split (reference main.py:162-165)."""
    ts = time.mktime(time.strptime(SPLIT_TIMESTAMP, "%Y-%m-%d %H:%M:%S"))
    mask = data["time_stamp"] < ts
    train = {k: v[mask] for k, v in data.items()}
    test = {k: v[~mask] for k, v in data.items()}
    return train, test


def sota_columns(dim: int = 32):
    """The 15 sparse fields and the dense ``price`` column of the Alimama
    sota-pos configuration; the scenario column is ``DOMAIN_COL`` with
    ``NUM_DOMAINS`` domains."""
    from ..features import DenseFeature, SparseFeature
    return ([SparseFeature(name, DATA_MAX[name] + 2, dim)
             for name in SPARSE_FEATURES]
            + [DenseFeature(name, 1) for name in DENSE_FEATURES])
