"""The port's data path against the JAX package's, on the CPU.

* ``native``: ``gather_rows`` (int32, float32) and ``gather_columns``
  equal the JAX package's native batcher and numpy; wider dtypes raise
  ``TypeError`` on both; ``shuffle_indices`` gives the JAX package's
  permutation bit for bit for two seeds; an index outside the rows raises.
* ``data.loader``: ``ShardedBatchIterator`` gives the JAX one's batches,
  labels and weights, shuffled and not, for 1 and 2 hosts, with a padded
  tail; ``Prefetcher`` keeps order, applies its transform and relays a
  producer's error.
* The raw AliCCP pipeline on small raw CSVs from the port's generator
  (``bench/raw_e2e.generate_raw``, 1,600 + 400 rows): every dataset of
  ``preprocess_raw``'s h5 file equals the JAX pipeline's bit for bit
  (dtype, shape, values), with ``h5py`` and with the port's own HDF5
  writer (``data/h5lite.py``, what runs where ``h5py`` is not
  installed), whose file ``h5py`` reads; ``preprocess``,
  ``parse_common_features``, Alimama ``preprocess`` with
  ``split_by_time`` and ``loadh52df`` likewise.
* ``utils``: ``get_domain_feat``, ``cal_ctr``, ``df2dict`` exactly,
  ``bpr_loss`` within 1e-6, ``structured_negative_sampling_bipartite`` bit
  for bit from the same key, ``set_random_seeds``' key equal to
  ``jax.random.PRNGKey``.
"""

import time

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from satrans_torch import native as tnative
from satrans_torch import utils as tutils
from satrans_torch.bench import raw_e2e
from satrans_torch.data import aliccp as taliccp
from satrans_torch.data import alimama as talimama
from satrans_torch.data import h5lite
from satrans_torch.data import io as tio
from satrans_torch.data import loader as tloader
from satrans_tpu import native as jnative
from satrans_tpu import utils as jutils
from satrans_tpu.data import aliccp as jaliccp
from satrans_tpu.data import alimama as jalimama
from satrans_tpu.data import io as jio
from satrans_tpu.data import loader as jloader

RAW_TRAIN, RAW_TEST = 1_600, 400


# ------------------------------------------------------------------ native

@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_native_gathers_match_jax(dtype):
    rng = np.random.default_rng(0)
    src = (rng.random((1000, 19)) * 1000).astype(dtype)
    idx = rng.integers(0, 1000, 333)  # duplicates included
    got = tnative.gather_rows(src, idx)
    assert got.dtype == src.dtype
    np.testing.assert_array_equal(got, jnative.gather_rows(src, idx))
    np.testing.assert_array_equal(got, src[idx])
    cols = [src[:, i] for i in range(src.shape[1])]
    packed = tnative.gather_columns(cols, idx, dtype=dtype)
    assert packed.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(
        packed, jnative.gather_columns(cols, idx, dtype=dtype))
    np.testing.assert_array_equal(packed, src[idx])


@pytest.mark.parametrize("dtype", [np.int64, np.float64])
def test_native_refuses_wide_dtypes(dtype):
    cols, idx = [np.arange(5)], np.arange(3)
    for mod in (tnative, jnative):
        with pytest.raises(TypeError, match="int32/float32"):
            mod.gather_columns(cols, idx, dtype=dtype)


@pytest.mark.parametrize("seed", [7, 2 ** 40 + 3])
def test_native_shuffle_matches_jax(seed):
    got = tnative.shuffle_indices(5000, seed)
    np.testing.assert_array_equal(got, jnative.shuffle_indices(5000, seed))
    np.testing.assert_array_equal(np.sort(got), np.arange(5000))
    assert tnative.available() and tnative.thread_count() >= 1


def test_native_refuses_indices_outside_the_rows():
    src = np.zeros((4, 2), np.int32)
    for idx in ([0, 4], [-1]):
        with pytest.raises(IndexError):
            tnative.gather_rows(src, np.asarray(idx))
        with pytest.raises(IndexError):
            tnative.gather_columns([src[:, 0]], np.asarray(idx))


# ------------------------------------------------------------------ loader

@pytest.mark.parametrize("hosts", [1, 2])
@pytest.mark.parametrize("shuffle", [True, False])
def test_sharded_iterator_matches_jax(shuffle, hosts):
    n, bs = 103, 16
    data = {"sparse": np.arange(n * 3).reshape(n, 3).astype(np.int32),
            "dense": np.arange(n, dtype=np.float32).reshape(n, 1)}
    labels = np.arange(n).astype(np.float32)
    seen = []
    for host in range(hosts):
        kw = dict(shuffle=shuffle, seed=3, host_id=host, num_hosts=hosts)
        ours = tloader.ShardedBatchIterator(data, labels, bs, **kw)
        theirs = jloader.ShardedBatchIterator(data, labels, bs, **kw)
        for epoch in (0, 1):
            got, want = list(ours.epoch(epoch)), list(theirs.epoch(epoch))
            assert len(got) == len(want) == 7
            for (b, y, w), (jb, jy, jw) in zip(got, want):
                assert b.keys() == jb.keys()
                for k in b:
                    np.testing.assert_array_equal(b[k], jb[k])
                np.testing.assert_array_equal(y, jy)
                np.testing.assert_array_equal(w, jw)
                if epoch == 0:
                    seen.extend(y[w > 0].tolist())
        assert got[-1][2].sum() < bs // hosts  # the padded tail
    assert sorted(seen) == list(range(n))


def test_prefetcher_order_transform_and_errors():
    items = list(range(10))
    pf = tloader.Prefetcher(iter(items), depth=2, transform=lambda x: x * 2)
    assert list(pf) == [x * 2 for x in items]
    pf.thread.join(timeout=10)
    assert not pf.thread.is_alive()

    def boom():
        yield 1
        raise RuntimeError("producer died")

    it = iter(tloader.Prefetcher(boom()))
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="producer died"):
        next(it)


# ------------------------------------------------------- the raw pipeline

def _h5_datasets(path):
    """{name: array} of every dataset, read with h5py."""
    return {name: jio.load_h5(path, name) for name, _ in jio.list_h5(path)}


def _assert_same_files(got_path, want_path):
    got, want = _h5_datasets(got_path), _h5_datasets(want_path)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].dtype == w.dtype, name
        np.testing.assert_array_equal(got[name], w, err_msg=name)
    return want


@pytest.fixture(scope="module")
def raw_files(tmp_path_factory):
    """The port generator's small raw CSVs and the JAX pipeline's h5."""
    d = tmp_path_factory.mktemp("raw")
    raw = raw_e2e.generate_raw(str(d), RAW_TRAIN, RAW_TEST)
    want = str(d / "jax.h5")
    jaliccp.preprocess_raw(raw["skeleton_train"], raw["skeleton_test"],
                           raw["common_train"], raw["common_test"], want,
                           k=3)
    return raw, want


@pytest.mark.parametrize("backend", ["h5py", "h5lite"])
def test_preprocess_raw_matches_jax(backend, raw_files, tmp_path,
                                    monkeypatch):
    raw, want = raw_files
    if backend == "h5lite":
        monkeypatch.setattr(tio, "_h5py", lambda: None)
    got = str(tmp_path / "alicpp.h5")
    frames = taliccp.preprocess_raw(
        raw["skeleton_train"], raw["skeleton_test"], raw["common_train"],
        raw["common_test"], got, k=3)
    assert [len(f) for f in frames] == [RAW_TRAIN, RAW_TEST]
    datasets = _assert_same_files(got, want)
    assert datasets["ctr_train/10914_3"].shape == (RAW_TRAIN, 3)
    assert "101_11014/top20_merged" in datasets
    # the reader on this backend gives the JAX reader's columns
    cols = ["click", "301", "109_14"]
    ours = taliccp.load_split(got, "ctr_test", cols, k=3)
    theirs = jaliccp.load_split(want, "ctr_test", cols, k=3)
    for c in cols:
        np.testing.assert_array_equal(ours[c], theirs[c])
    if backend == "h5lite":
        assert tio.list_h5(got) == jio.list_h5(want)
        with open(got, "rb") as f:
            assert f.read(9)[8] == 2  # the port's own superblock


def test_preprocess_and_common_features_match_jax(raw_files, tmp_path):
    raw, _ = raw_files
    got, want = str(tmp_path / "t.h5"), str(tmp_path / "j.h5")
    frames = taliccp.preprocess(raw["skeleton_train"], raw["skeleton_test"],
                                got)
    jframes = jaliccp.preprocess(raw["skeleton_train"], raw["skeleton_test"],
                                 want)
    for f, jf in zip(frames, jframes):
        pd.testing.assert_frame_equal(f, jf)
    _assert_same_files(got, want)
    acc = taliccp.parse_common_features(raw["common_test"])
    assert acc == jaliccp.parse_common_features(raw["common_test"])
    assert sum(len(u) for u, _, _ in acc.values()) > 0


def _alimama_csvs(d, n=40):
    """The raw Alimama CSVs of tests/test_data_and_cli.py's case."""
    rng = np.random.default_rng(1)
    split_ts = time.mktime(time.strptime(talimama.SPLIT_TIMESTAMP,
                                         "%Y-%m-%d %H:%M:%S"))
    raw = pd.DataFrame({
        "user": rng.integers(1, 10, n),
        "time_stamp": np.where(np.arange(n) < 30, split_ts - 1000,
                               split_ts + 1000),
        "adgroup_id": rng.integers(1, 5, n),
        "pid": rng.choice(["430548_1007", "430539_1007"], n),
        "nonclk": 0, "clk": rng.integers(0, 2, n)})
    users = pd.DataFrame({
        "userid": np.arange(1, 9),  # user 9 has no profile: NA -> 0
        **{c: rng.integers(0, 5, 8) for c in (
            "cms_segid", "cms_group_id", "final_gender_code", "age_level",
            "pvalue_level", "shopping_level", "occupation",
            "new_user_class_level")}})
    items = pd.DataFrame({
        "adgroup_id": np.arange(1, 5),
        **{c: rng.integers(1, 10, 4) for c in (
            "cate_id", "campaign_id", "customer", "brand")},
        "price": rng.random(4) * 100})
    paths = [str(d / f) for f in ("raw_sample.csv", "user_profile.csv",
                                  "ad_feature.csv")]
    for frame, path in zip((raw, users, items), paths):
        frame.to_csv(path, index=False)
    return paths


@pytest.mark.parametrize("backend", ["h5py", "h5lite"])
def test_alimama_preprocess_matches_jax(backend, tmp_path, monkeypatch):
    csvs = _alimama_csvs(tmp_path)
    want = str(tmp_path / "j.h5")
    jframe = jalimama.preprocess(*csvs, want)
    if backend == "h5lite":
        monkeypatch.setattr(tio, "_h5py", lambda: None)
    got = str(tmp_path / "alimama.h5")
    pd.testing.assert_frame_equal(talimama.preprocess(*csvs, got), jframe)
    data, jdata = talimama.load(got), jalimama.load(want)
    assert sorted(data) == sorted(jdata) and data["price"].dtype.kind == "f"
    for k in jdata:
        assert data[k].dtype == jdata[k].dtype, k
        np.testing.assert_array_equal(data[k], jdata[k], err_msg=k)
    (train, test), (jtrain, jtest) = (talimama.split_by_time(data),
                                      jalimama.split_by_time(jdata))
    assert len(train["clk"]) == 30 and len(test["clk"]) == 10
    for k in jdata:
        np.testing.assert_array_equal(train[k], jtrain[k])
        np.testing.assert_array_equal(test[k], jtest[k])
    pd.testing.assert_frame_equal(tio.loadh52df(got), jio.loadh52df(want))


def test_h5lite_files_read_by_h5py(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"g": {"a": rng.integers(-5, 5, (7, 3)).astype(np.int8),
                  "b": rng.random(11).astype(np.float32),
                  "inner": {"c": np.arange(4, dtype=np.uint64)}},
            "empty": np.zeros((0, 3)), "d": rng.random((2, 2, 2))}
    path = str(tmp_path / "t.h5")
    h5lite.write(path, tree)
    flat = {"g/a": tree["g"]["a"], "g/b": tree["g"]["b"],
            "g/inner/c": tree["g"]["inner"]["c"], "empty": tree["empty"],
            "d": tree["d"]}
    back = h5lite.read(path)
    for name, want in flat.items():
        node = back
        for part in name.split("/"):
            node = node[part]
        for got in (jio.load_h5(path, name), node):
            assert got.dtype == want.dtype and got.shape == want.shape, name
            np.testing.assert_array_equal(got, want, err_msg=name)
    with pytest.raises(TypeError, match="h5lite"):
        h5lite.write(path, {"s": np.array(["x"])})
    jio.save_h5(str(tmp_path / "lib.h5"), "x", np.arange(3))
    with pytest.raises(ValueError, match="needs h5py"):
        h5lite.index(str(tmp_path / "lib.h5"))


# ------------------------------------------------------------------- utils

def test_utils_match_jax():
    rng = np.random.default_rng(2)
    data = {"a": rng.integers(0, 3, 50), "b": rng.integers(5, 7, 50),
            "click": rng.integers(0, 2, 50)}
    t_data, j_data = dict(data), dict(data)
    t_cols, t_map = tutils.get_domain_feat(t_data, "a|b")
    j_cols, j_map = jutils.get_domain_feat(j_data, "a|b")
    assert t_cols == j_cols and t_map == j_map
    np.testing.assert_array_equal(t_data["a|b"], j_data["a|b"])
    assert tutils.get_domain_feat(dict(data), "a") == (["a"], None)
    assert tutils.cal_ctr(data) == jutils.cal_ctr(data)
    df = pd.DataFrame(data)
    t_d, j_d = tutils.df2dict(df), jutils.df2dict(df)
    assert t_d.keys() == j_d.keys()
    for k in t_d:
        np.testing.assert_array_equal(t_d[k], j_d[k])

    pos = rng.normal(size=64).astype(np.float32)
    neg = rng.normal(size=64).astype(np.float32)
    for reg, lam in ((None, 0.0), (3.5, 0.1)):
        got = tutils.bpr_loss(torch.from_numpy(pos), torch.from_numpy(neg),
                              reg, lam)
        want = jutils.bpr_loss(jnp.asarray(pos), jnp.asarray(neg), reg, lam)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)

    assert tuple(tutils.set_random_seeds(11)) == tuple(
        int(v) for v in np.asarray(jutils.set_random_seeds(11)))
    assert np.random.rand() == (np.random.seed(11), np.random.rand())[1]


@pytest.mark.parametrize("seed", [0, 5])
def test_negative_sampling_matches_jax(seed):
    rng = np.random.default_rng(seed)
    num_users, num_nodes = 20, 50
    edges = np.stack([rng.integers(0, num_users, 200),
                      rng.integers(num_users, num_nodes, 200)])
    got = tutils.structured_negative_sampling_bipartite(
        tutils.set_random_seeds(seed), edges, num_nodes, num_users)
    want = jutils.structured_negative_sampling_bipartite(
        jax.random.PRNGKey(seed), edges, num_nodes, num_users)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    row, _, neg = got
    pos = set((edges[0] * num_nodes + edges[1]).tolist())
    assert not pos & set((row * num_nodes + neg).tolist())
