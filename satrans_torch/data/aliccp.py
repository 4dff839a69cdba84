"""AliCCP dataset: the raw preprocessing and the reader (twin of
``satrans_tpu/data/aliccp.py``).

Reimplements the reference's offline pipeline (aliccp_dataset_processing.py)
and reader (utils.py:266-278 ``get_aliccp_ctr_df``):

* raw feature ids are global; each field is remapped to 1-based per-field
  ids by subtracting ``MIN_V[field] - 1`` and clamping negatives to 0
  (aliccp_dataset_processing.py:158-169)
* per-field vocab sizes are pinned by ``DATA_MAX``
  (aliccp_dataset_processing.py:179 == reference main.py:124-128);
  embedding vocab of a field = ``DATA_MAX[field] + 2``
* user behavior-history fields ('109_14' etc.) become top-k id lists per
  user, 0-padded (aliccp_dataset_processing.py:96-111, 211-243)
* output schema: ``alicpp.h5`` with per-column int arrays under
  ``ctr_train/`` and ``ctr_test/``; history columns are stored as
  ``[N, k]`` arrays named ``{col}_{k}`` (the reader's contract,
  utils.py:273-276)

The skeleton CSVs (``sample_skeleton_{train,test}.csv``) have one row per
impression with columns click, purchase, and the 19 feature fields.  The
preprocessing needs ``pandas``, imported where it is called; the h5 files
go through ``data/io.py``.
"""

from __future__ import annotations

import re
from typing import TYPE_CHECKING

import numpy as np

from . import io

if TYPE_CHECKING:
    import pandas as pd

LABELS = ["click", "purchase"]

SPARSE_FEATURES = ["101", "121", "122", "124", "125", "126", "127", "128",
                   "129", "205", "206", "207", "210", "216", "508", "509",
                   "702", "853", "301"]

HISTORY_COLUMNS = ["109_14", "110_14", "150_14", "127_14"]

# Global-id offset per field (aliccp_dataset_processing.py:158).
MIN_V = {"click": 1, "purchase": 1, "101": 1, "121": 3438658, "122": 3438755,
         "124": 3438768, "125": 3438770, "126": 3438777, "127": 3438780,
         "128": 3864885, "129": 3864887, "205": 3964447, "206": 8313062,
         "207": 8322055, "210": 9017179, "216": 9116785, "508": 9351668,
         "509": 9359853, "702": 9832207, "853": 10000020, "301": 9351665}

# Per-field max remapped id (aliccp_dataset_processing.py:179,
# main.py:124-128); embedding vocab = DATA_MAX + 2.
DATA_MAX = {"101": 444861, "121": 97, "122": 13, "124": 2, "125": 7,
            "126": 3, "127": 3, "128": 2, "129": 4, "205": 4348615,
            "206": 8993, "207": 695124, "210": 99606, "216": 234880,
            "508": 8185, "509": 472354, "702": 167813, "853": 91358,
            "301": 3, "10914": 12523, "11014": 2981271, "15014": 99555,
            "12714": 426101}


def normalize_ids(df: pd.DataFrame) -> pd.DataFrame:
    """Remap global ids to 1-based per-field ids; negatives -> 0
    (aliccp_dataset_processing.py:161-169)."""
    import pandas as pd
    min_v = pd.Series({c: MIN_V[c] for c in df.columns})
    out = (df - (min_v - 1)).astype(np.int32)
    out[out < 0] = 0
    return out


def topk_edges(uids, fids, scores, k: int) -> pd.DataFrame:
    """Per-user top-k behavior ids by score, ties broken by input order
    (aliccp_dataset_processing.py:96-111)."""
    import pandas as pd
    edges = pd.DataFrame({"uid": uids, "fid": fids, "score": scores})
    edges = edges.drop_duplicates()
    edges = edges.sort_values(by=["uid", "score"], ascending=(True, False))
    return edges.groupby("uid").head(k)


def history_feature_frame(edges: pd.DataFrame, k: int,
                          col: str) -> pd.DataFrame:
    """uid -> 0-padded tuple of its top-k ids
    (aliccp_dataset_processing.py:220-222)."""
    df = edges[["uid", "fid"]].copy()
    agg = df.groupby("uid")["fid"].aggregate(
        lambda x: tuple(list(x)[:k] + [0] * max(0, k - len(x))))
    return agg.rename(col).reset_index().rename(columns={"uid": "101"})


def build_split_h5(df: pd.DataFrame, split: str, h5_path: str,
                   history: dict[str, pd.DataFrame] | None = None,
                   k: int = 3):
    """Write one split of the ``alicpp.h5`` schema (per-column arrays under
    ``ctr_{split}/``, aliccp_dataset_processing.py:237-242)."""
    cols: dict[str, np.ndarray] = {}
    for col in df.columns:
        cols[col] = df[col].values
    if history:
        for hcol, hist_df in history.items():
            merged = df[["101"]].merge(hist_df, on="101", how="left")
            vals = merged[hcol].apply(
                lambda x: tuple([0] * k) if not isinstance(x, tuple) else x)
            # '109_14' -> '10914' as the reference writes it
            # (aliccp_dataset_processing.py:217), the reader's `{col}_{k}`
            key = hcol.replace("_", "")
            cols[f"{key}_{k}"] = np.array(list(vals), dtype=np.int32)
    io.save_dict_h5(h5_path, cols, group=f"ctr_{split}")


def build_h5(train_df: pd.DataFrame, test_df: pd.DataFrame, h5_path: str,
             history: dict[str, pd.DataFrame] | None = None, k: int = 3):
    """Write both splits of the ``alicpp.h5`` schema with a shared history
    table (the pre-parsed-input path; :func:`preprocess_raw` writes
    per-split histories through :func:`build_split_h5`)."""
    for name, df in (("train", train_df), ("test", test_df)):
        build_split_h5(df, name, h5_path, history=history, k=k)


def _read_skeleton(path: str) -> pd.DataFrame:
    import pandas as pd
    return normalize_ids(pd.read_csv(path, dtype=np.int32))


def preprocess(train_csv: str, test_csv: str, h5_path: str):
    """The offline pipeline from skeleton CSVs of global ids, without the
    history columns."""
    train_df = _read_skeleton(train_csv)
    test_df = _read_skeleton(test_csv)
    build_h5(train_df, test_df, h5_path)
    return train_df, test_df


# --------------------------------------------------------------------------
# The raw inputs of the reference (the AliCCP release's common_features
# CSVs and the skeleton CSVs) through the edge-dump intermediates to the
# final ctr_train/ctr_test schema (aliccp_dataset_processing.py:49-143,
# 187-243, 254-295).
# --------------------------------------------------------------------------

def parse_common_features(path: str,
                          columns: list[str] | None = None
                          ) -> dict[str, tuple[list, list, list]]:
    """Parse a ``common_features_{split}.csv`` file into per-history-column
    (uid, fid, score) triples (aliccp_dataset_processing.py:254-295
    ``process_history``).

    Each line is ``feat_line_id,count,kvs`` where ``kvs`` packs
    (field, value, score) triples separated by ``\\x01``/``\\x02``/
    ``\\x03``.  Rows without a '101' (uid) entry are skipped, as upstream
    does.
    """
    columns = HISTORY_COLUMNS if columns is None else columns
    acc: dict[str, tuple[list, list, list]] = {
        c: ([], [], []) for c in columns}
    with open(path) as fr:
        for line in fr:
            parts = line.strip().split(",")
            if len(parts) < 3:
                continue
            kv = re.split("\x01|\x02|\x03", parts[2])
            keys = kv[0::3]
            values = kv[1::3]
            scores = kv[2::3]
            feat = dict(zip(keys, values))
            if "101" not in feat:
                continue
            uid = int(feat["101"])
            for key, val, sc in zip(keys, values, scores):
                if key in acc:
                    u, f, s = acc[key]
                    u.append(uid)
                    f.append(int(val))
                    s.append(float(sc))
    return acc


def map_history_ids(train_acc: dict, test_acc: dict, h5_path: str,
                    min_uid: int = 1) -> None:
    """Remap raw history edges to 1-based local ids and dump the
    ``101_{col}/train|test`` [3, N] intermediates
    (aliccp_dataset_processing.py:49-93 ``map_history_data``).  The fid
    offset of each column is the least fid over train and test together,
    as upstream computes it."""
    for col in train_acc:
        tr_u, tr_f, tr_s = train_acc[col]
        te_u, te_f, te_s = test_acc.get(col, ([], [], []))
        fids = list(tr_f) + list(te_f)
        if not fids:
            continue
        min_fid = min(fids)
        key = col.replace("_", "")
        for name, (u, f, s) in (("train", (tr_u, tr_f, tr_s)),
                                ("test", (te_u, te_f, te_s))):
            uids = np.asarray(u, dtype=np.float64) - min_uid + 1
            lf = np.asarray(f, dtype=np.float64) - min_fid + 1
            data = np.array([uids, lf, np.asarray(s, dtype=np.float64)])
            io.save_h5(h5_path, f"101_{key}/{name}", data)


def get_topk_edges(data: np.ndarray, ks=(5, 10, 20)) -> dict[int, np.ndarray]:
    """Per-user top-k edges by score from a [3, N] (uid, fid, score) dump
    (aliccp_dataset_processing.py:96-111), through :func:`topk_edges`."""
    return {k: topk_edges(data[0], data[1], data[2], k)
            [["uid", "fid", "score"]].values for k in ks}


def merge_train_test_history_edges(train_edges: np.ndarray,
                                   test_edges: np.ndarray) -> np.ndarray:
    """Concatenate train edges with the test edges of UNSEEN users only
    (aliccp_dataset_processing.py:113-122)."""
    train_uids = set(train_edges.T[0].tolist())
    keep = np.array([u not in train_uids for u in test_edges.T[0].tolist()],
                    dtype=bool)
    return np.concatenate([train_edges, test_edges[keep]], axis=0)


def save_topk_edges(h5_path: str, columns: list[str] | None = None,
                    ks=(5, 10, 20)) -> None:
    """Persist per-split top-k edge lists and the train+filtered-test merge
    under ``101_{col}/top{k}_{train|test|merged}``
    (aliccp_dataset_processing.py:124-143 ``save_topk_edges``)."""
    columns = HISTORY_COLUMNS if columns is None else columns
    for col in columns:
        key = col.replace("_", "")
        try:
            splits = {name: io.load_h5(h5_path, f"101_{key}/{name}")
                      for name in ("train", "test")}
        except KeyError:
            continue  # column absent from the raw dump
        for name, data in splits.items():
            for k, edges in get_topk_edges(data, ks).items():
                io.save_h5(h5_path, f"101_{key}/top{k}_{name}", edges)
        for k in ks:
            tr = io.load_h5(h5_path, f"101_{key}/top{k}_train")
            te = io.load_h5(h5_path, f"101_{key}/top{k}_test")
            io.save_h5(h5_path, f"101_{key}/top{k}_merged",
                       merge_train_test_history_edges(tr, te))


def save_feature_edges(train_df: pd.DataFrame, test_df: pd.DataFrame,
                       h5_path: str) -> None:
    """Dump the user- and item-attribute edge lists built from the
    normalized frames (aliccp_dataset_processing.py:187-206): distinct
    (101, user_col) pairs and distinct nonzero (205, item_col) pairs,
    each as a [2, E] array under ``{anchor}_{col}/merged``."""
    import pandas as pd
    user_cols = ["121", "122", "124", "125", "126", "127", "128", "129"]
    item_cols = ["206", "207", "210", "216"]
    for col in user_cols:
        feat = pd.concat([train_df[["101", col]], test_df[["101", col]]],
                         axis=0)
        io.save_h5(h5_path, f"101_{col}/merged",
                   feat.drop_duplicates().values.T)
    for col in item_cols:
        feat = pd.concat([train_df[["205", col]], test_df[["205", col]]],
                         axis=0)
        feat = feat[(feat["205"] != 0) & (feat[col] != 0)]
        io.save_h5(h5_path, f"205_{col}/merged",
                   feat.drop_duplicates().values.T)


def history_frames_from_h5(h5_path: str, split: str, k: int,
                           columns: list[str] | None = None
                           ) -> dict[str, pd.DataFrame]:
    """Read the persisted top-k edge dumps back into per-column uid ->
    padded-tuple frames for the final join
    (aliccp_dataset_processing.py:211-233)."""
    import pandas as pd
    columns = HISTORY_COLUMNS if columns is None else columns
    frames = {}
    for col in columns:
        key = col.replace("_", "")
        try:
            edges = io.load_h5(h5_path, f"101_{key}/top{k}_{split}")
        except KeyError:
            continue  # column absent from the raw dump
        df = pd.DataFrame(
            {"uid": edges[:, 0].astype(np.int64),
             "fid": edges[:, 1].astype(np.int64)})
        frames[col] = history_feature_frame(df, k, col)
    return frames


def preprocess_raw(skeleton_train_csv: str, skeleton_test_csv: str,
                   common_train_csv: str, common_test_csv: str,
                   h5_path: str, k: int = 5):
    """The whole pipeline from the reference's raw inputs: parse the
    common-features history edges, remap and top-k them, normalize the
    skeleton frames, dump the attribute edge lists, and join everything
    into the final ``ctr_train``/``ctr_test`` schema
    (aliccp_dataset_processing.py __main__ order :302-309)."""
    train_acc = parse_common_features(common_train_csv)
    test_acc = parse_common_features(common_test_csv)
    map_history_ids(train_acc, test_acc, h5_path)
    save_topk_edges(h5_path, ks=(5, 10, 20) if k in (5, 10, 20)
                    else (k, 5, 10, 20))
    train_df = _read_skeleton(skeleton_train_csv)
    test_df = _read_skeleton(skeleton_test_csv)
    save_feature_edges(train_df, test_df, h5_path)
    for name, df in (("train", train_df), ("test", test_df)):
        build_split_h5(df, name, h5_path,
                       history=history_frames_from_h5(h5_path, name, k), k=k)
    return train_df, test_df


def load_split(h5_path: str, split: str, cols: list[str], k: int = 3
               ) -> dict[str, np.ndarray]:
    """Reader matching ``get_aliccp_ctr_df`` (utils.py:266-278): history
    columns resolve to their ``{col}_{k}`` dataset."""
    hist_keys = {c.replace("_", "") for c in HISTORY_COLUMNS}
    resolved = [f"{c.replace('_', '')}_{k}"
                if c.replace("_", "") in hist_keys else c for c in cols]
    data = io.load_h5_dict(h5_path, group=split, cols=resolved)
    return {orig: data[res] for orig, res in zip(cols, resolved)}


def sota_columns(dim: int = 32):
    """The 19 sparse fields of the AliCCP sota configuration; the scenario
    column is ``"301"`` with 3 domains."""
    from ..features import SparseFeature
    return [SparseFeature(name, DATA_MAX[name] + 2, dim)
            for name in SPARSE_FEATURES]
