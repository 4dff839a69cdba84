"""Alimama (Taobao display ads) dataset: preprocessing, loader and temporal
split (twin of ``satrans_tpu/data/alimama.py``).

:func:`preprocess` reimplements reference alimama_preprocessing.py: join
raw_sample + user_profile + ad_feature, +1-shift selected columns, map
pid -> {430548_1007: 0, 430539_1007: 1}, fill NA with 0, write
``alimama.h5`` (price kept float, everything else int).  It needs
``pandas``, imported where it is called; the h5 file goes through
``data/io.py``.  The train/test split is temporal at 2017-05-12 00:00:00
(reference main.py:162-165).

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
LABEL = "clk"

PID_MAP = {"430548_1007": 0, "430539_1007": 1}
SHIFT_COLS = ["cms_segid", "cms_group_id", "age_level", "occupation"]
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


def preprocess(raw_sample_csv: str, user_profile_csv: str,
               ad_feature_csv: str, h5_path: str):
    """Join the three raw CSVs into the flat ``alimama.h5`` schema and
    return the joined DataFrame (alimama_preprocessing.py:1-52)."""
    import pandas as pd
    logs = pd.read_csv(raw_sample_csv)
    logs.columns = ["user_id", "time_stamp", "adgroup_id", "pid", "nonclk",
                    "clk"]
    user_df = pd.read_csv(user_profile_csv)
    user_df.columns = ["userid", "cms_segid", "cms_group_id",
                       "final_gender_code", "age_level", "pvalue_level",
                       "shopping_level", "occupation", "new_user_class_level"]
    item_df = pd.read_csv(ad_feature_csv)

    data = logs.merge(user_df, left_on="user_id", right_on="userid",
                      how="left")
    data = data.merge(item_df, on="adgroup_id", how="left")
    data[SHIFT_COLS] = data[SHIFT_COLS] + 1
    data = data.fillna(value=0)
    data["pid"] = data["pid"].map(PID_MAP)

    cols = {}
    for col in data.columns:
        if col == "userid":
            continue
        if col == "price":
            cols[col] = data[col].values.astype("float")
        else:
            cols[col] = data[col].values.astype("int")
    io.save_dict_h5(h5_path, cols)
    return data


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
