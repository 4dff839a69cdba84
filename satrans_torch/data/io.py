"""HDF5, pickle and numpy IO helpers (twin of ``satrans_tpu/data/io.py``).

The h5 *schema* is the compatibility contract with the reference: per-column
arrays under ``ctr_train/`` and ``ctr_test/`` groups for AliCCP (reference
aliccp_dataset_processing.py:237-242), flat per-column arrays for Alimama
(alimama_preprocessing.py:41-52).  Functions mirror reference
utils.py:22-142.  The h5 helpers use ``h5py`` where it is installed and
the port's own HDF5 subset (``data/h5lite.py``) where it is not, so that
the module imports, and the preprocessing and the loaders run, without
it; ``pandas`` is imported by :func:`loadh52df` alone.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from . import h5lite


def _h5py():
    """The ``h5py`` module, or None where it is not installed."""
    try:
        import h5py
    except ImportError:
        return None
    return h5py


def _walk(tree: dict, key: str, path, create: bool = False):
    """The node at the '/'-separated ``key`` of an h5lite tree."""
    node = tree
    for part in key.strip("/").split("/") if key.strip("/") else []:
        if not isinstance(node, dict) or (part not in node and not create):
            raise KeyError(f"no key {key!r} in {path}")
        node = node.setdefault(part, {})
    return node


def _lite_update(file_path, data: dict[str, np.ndarray]) -> None:
    """Set each '/'-separated key of ``data`` in an h5lite file (created
    if absent), replacing what was there."""
    tree = h5lite.read(file_path) if os.path.exists(file_path) else {}
    for key, value in data.items():
        *groups, name = key.strip("/").split("/")
        _walk(tree, "/".join(groups), file_path, create=True)[name] = \
            np.asarray(value)
    h5lite.write(file_path, tree)


def save_h5(file_path, key, data):
    """Create/overwrite ``key`` in an h5 file (reference utils.py:82-88)."""
    save_dict_h5(file_path, {key: data})


def load_h5(file_path, key):
    h5py = _h5py()
    if h5py is None:
        leaf = _walk(h5lite.index(file_path), key, file_path)
        if isinstance(leaf, dict):
            raise KeyError(f"{key!r} in {file_path} is a group")
        return h5lite.read(file_path, {"x": leaf})["x"]
    with h5py.File(file_path, "r") as f:
        if key not in f:
            raise KeyError(f"no key {key!r} in {file_path}")
        return f[key][:]


def load_h5_dict(file_path, group: str | None = None,
                 cols: list[str] | None = None) -> dict[str, np.ndarray]:
    """Load {column: array} from an h5 file or one of its groups
    (reference utils.py:22-30 ``loadh52df`` / :266-278
    ``get_aliccp_ctr_df``)."""
    h5py = _h5py()
    if h5py is None:
        g = _walk(h5lite.index(file_path), group or "", file_path)
        # in name order, as h5py lists a group
        names = cols if cols is not None else sorted(g)
        return h5lite.read(file_path, {n: _walk(g, n, file_path)
                                       for n in names})
    with h5py.File(file_path, "r") as f:
        g = f[group] if group else f
        names = cols if cols is not None else list(g.keys())
        return {name: g[name][:] for name in names}


def save_dict_h5(file_path, data: dict[str, np.ndarray], group: str = ""):
    data = {f"{group}/{k}" if group else k: v for k, v in data.items()}
    h5py = _h5py()
    if h5py is None:
        _lite_update(file_path, data)
        return
    with h5py.File(file_path, "a") as f:
        for key, v in data.items():
            if key in f:
                del f[key]
            f[key] = v


def loadh52df(path):
    """Flat h5 file -> pandas DataFrame (reference utils.py:22-30)."""
    import pandas as pd
    return pd.DataFrame(load_h5_dict(path))


def list_h5(path):
    """List 'group/dataset' keys with shapes (reference utils.py:55-66)."""
    names = []
    h5py = _h5py()
    if h5py is None:
        def walk(node, prefix):
            for name in sorted(node):
                child = node[name]
                if isinstance(child, dict):
                    walk(child, f"{prefix}{name}/")
                else:
                    names.append((prefix + name, child.shape))
        walk(h5lite.index(path), "")
        return names
    with h5py.File(path, "r") as f:
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
