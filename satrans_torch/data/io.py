"""HDF5, pickle and numpy IO helpers (twin of ``satrans_tpu/data/io.py``).

The h5 *schema* is the compatibility contract with the reference: per-column
arrays under ``ctr_train/`` and ``ctr_test/`` groups for AliCCP (reference
aliccp_dataset_processing.py:237-242), flat per-column arrays for Alimama
(alimama_preprocessing.py:41-52).  Functions mirror reference
utils.py:22-142.  The h5 helpers import ``h5py`` when they are called, so
that the module imports without it.
"""

from __future__ import annotations

import pickle

import numpy as np


def _h5py():
    try:
        import h5py
    except ImportError as err:
        raise ImportError("the h5 files of the alicpp and alimama data need "
                          "the package 'h5py', which is not installed") \
            from err
    return h5py


def save_h5(file_path, key, data):
    """Create/overwrite ``key`` in an h5 file (reference utils.py:82-88)."""
    with _h5py().File(file_path, "a") as f:
        if key in f:
            del f[key]
        f[key] = data


def load_h5(file_path, key):
    with _h5py().File(file_path, "r") as f:
        if key not in f:
            raise KeyError(f"no key {key!r} in {file_path}")
        return f[key][:]


def load_h5_dict(file_path, group: str | None = None,
                 cols: list[str] | None = None) -> dict[str, np.ndarray]:
    """Load {column: array} from an h5 file or one of its groups
    (reference utils.py:22-30 ``loadh52df`` / :266-278
    ``get_aliccp_ctr_df``)."""
    with _h5py().File(file_path, "r") as f:
        g = f[group] if group else f
        names = cols if cols is not None else list(g.keys())
        return {name: g[name][:] for name in names}


def save_dict_h5(file_path, data: dict[str, np.ndarray], group: str = ""):
    with _h5py().File(file_path, "a") as f:
        for k, v in data.items():
            key = f"{group}/{k}" if group else k
            if key in f:
                del f[key]
            f[key] = v


def list_h5(path):
    """List 'group/dataset' keys with shapes (reference utils.py:55-66)."""
    names = []
    with _h5py().File(path, "r") as f:
        def visit(name, obj):
            if hasattr(obj, "shape"):
                names.append((name, obj.shape))
        f.visititems(visit)
    return names


def dump_pkl(obj, path):
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_pkl(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def dump_npy(obj, path):
    assert path.endswith(".npy")
    np.save(path, obj)


def load_npy(path):
    return np.load(path, allow_pickle=True)
