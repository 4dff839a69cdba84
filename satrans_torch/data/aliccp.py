"""AliCCP fields and reader (twin of the constants and ``load_split`` of
``satrans_tpu/data/aliccp.py``; the pandas preprocessing of the raw CSVs
is not ported yet, ROADMAP queue 1 item 'data/ and native/').

Embedding vocab of a field = ``DATA_MAX[field] + 2``.  The reader needs
``h5py`` (imported when it is called).
"""

from __future__ import annotations

import numpy as np

from . import io

LABELS = ["click", "purchase"]

SPARSE_FEATURES = ["101", "121", "122", "124", "125", "126", "127", "128",
                   "129", "205", "206", "207", "210", "216", "508", "509",
                   "702", "853", "301"]

# Per-field max remapped id (the reference's preprocessing pins them).
DATA_MAX = {"101": 444861, "121": 97, "122": 13, "124": 2, "125": 7,
            "126": 3, "127": 3, "128": 2, "129": 4, "205": 4348615,
            "206": 8993, "207": 695124, "210": 99606, "216": 234880,
            "508": 8185, "509": 472354, "702": 167813, "853": 91358,
            "301": 3, "10914": 12523, "11014": 2981271, "15014": 99555,
            "12714": 426101}

HISTORY_COLUMNS = ["109_14", "110_14", "150_14", "127_14"]


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
