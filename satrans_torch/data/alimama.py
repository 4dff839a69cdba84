"""Alimama (Taobao display ads) field constants (twin of the constants in
``satrans_tpu/data/alimama.py``; the pandas preprocessing is not ported
yet).

``DATA_MAX`` holds the public dataset's vocab sizes that the JAX package's
``bench.py`` pins for its Alimama sota-pos arm (26 M impressions, 1.14 M
users, 846 k ads), so that the configuration runs without the download.
Embedding vocab of a field = ``DATA_MAX[field] + 2``.
"""

SPARSE_FEATURES = ["user_id", "adgroup_id", "pid", "cms_segid",
                   "cms_group_id", "final_gender_code", "age_level",
                   "pvalue_level", "shopping_level", "occupation",
                   "new_user_class_level", "cate_id", "campaign_id",
                   "customer", "brand"]

DENSE_FEATURES = ["price"]

DATA_MAX = {
    "user_id": 1_141_729, "adgroup_id": 846_811, "pid": 1, "cms_segid": 97,
    "cms_group_id": 13, "final_gender_code": 2, "age_level": 7,
    "pvalue_level": 3, "shopping_level": 3, "occupation": 2,
    "new_user_class_level": 4, "cate_id": 12_960, "campaign_id": 423_436,
    "customer": 255_875, "brand": 461_497,
}

# the sota-pos configuration's scenario column and its domains
DOMAIN_COL, NUM_DOMAINS = "shopping_level", 3


def sota_columns(dim: int = 32):
    """The 15 sparse fields and the dense ``price`` column of the Alimama
    sota-pos configuration; the scenario column is ``DOMAIN_COL`` with
    ``NUM_DOMAINS`` domains."""
    from ..features import DenseFeature, SparseFeature
    return ([SparseFeature(name, DATA_MAX[name] + 2, dim)
             for name in SPARSE_FEATURES]
            + [DenseFeature(name, 1) for name in DENSE_FEATURES])
