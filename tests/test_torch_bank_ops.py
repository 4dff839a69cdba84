"""The plain versions of the port's row kernels (K2, K3, K4, K5) and the
host logic of the sparse bank updates against the JAX package, on numpy
inputs drawn from a seed.

* ``scatter_rows_set`` (K2), ``gather_rows`` (K4) and ``lazy_adam_rows``
  (K5) against their Pallas kernels in interpret mode, at one or a few
  row blocks of 8 rows: K2 and K4 move bytes and must agree exactly; K5's
  arithmetic is the Pallas kernel's in the same order, within 2 float32
  ulp (rtol 2.4e-7).
* ``eqgemm_positions`` (K3) against the interpret-mode Pallas kernel with
  ``g`` drawn bf16-representable (the TPU kernel casts ``g`` to bf16, so
  the cast is then exact; its sums stay float32): rtol 1e-6 for float32
  sums taken in another order.  ``eqgemm_combine`` with shared rows and
  ``_eq_combine``'s redirect of out-of-range ids against the JAX XLA path.
* ``combine_duplicate_rows``, ``make_eq_plan`` and ``bank_gather_plan``
  against the JAX package's.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import satrans_torch
import satrans_tpu
import torch_parity as tp
from satrans_torch import embeddings as temb
from satrans_torch.data import aliccp as taliccp
from satrans_torch.ops import eqgemm as teq
from satrans_torch.ops import gather as tgather
from satrans_torch.ops import lazy_tail as tlazy
from satrans_torch.ops import scatter as tscatter
from satrans_torch.train import bank_optimizer as tbo
from satrans_tpu import embeddings as jemb
from satrans_tpu.ops.pallas import eqgemm as jeq
from satrans_tpu.ops.pallas import gather as jgather
from satrans_tpu.ops.pallas import lazy_tail as jlazy
from satrans_tpu.ops.pallas import scatter as jscatter
from satrans_tpu.train import bank_optimizer as jbo

RB = 8  # small Pallas row blocks: interpret mode unrolls every row's DMA


def _arrays(rows=40, w=16, count=3, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(rows, w)).astype(np.float32)
            for _ in range(count)]


@pytest.mark.parametrize("case", ["in_range", "drop_oob", "empty"])
def test_scatter_rows_set_matches_pallas(case):
    rng = np.random.default_rng(1)
    arrays = _arrays(count=2)
    n = 0 if case == "empty" else 13          # not a multiple of RB
    ids = rng.permutation(40)[:n].astype(np.int64)
    vals = [rng.normal(size=(n, 16)).astype(np.float32) for _ in arrays]
    if n:
        ids[5] = ids[4]                       # a duplicate with...
        for v in vals:
            v[5] = v[4]                       # ...an identical value
    if case == "drop_oob":
        ids[[1, 7, 12]] = [-1, 40, -40]       # negative and past the end
    drop = case == "drop_oob"
    want = jscatter.scatter_rows_set(
        [jnp.asarray(a) for a in arrays], jnp.asarray(ids, jnp.int32),
        [jnp.asarray(v) for v in vals], rb=RB, interpret=True,
        drop_oob=drop)
    got = tscatter.scatter_rows_set(
        [torch.from_numpy(a.copy()) for a in arrays], torch.from_numpy(ids),
        [torch.from_numpy(v) for v in vals], drop_oob=drop)
    for g, w, a in zip(got, want, arrays):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert case == "empty" or not np.array_equal(g.numpy(), a)


def test_gather_rows_matches_pallas():
    rng = np.random.default_rng(2)
    arrays = _arrays(count=3)
    ids = rng.integers(0, 40, 21).astype(np.int64)   # duplicates, ragged
    want = jgather.gather_rows([jnp.asarray(a) for a in arrays],
                               jnp.asarray(ids, jnp.int32), rb=RB,
                               interpret=True)
    got = tgather.gather_rows([torch.from_numpy(a) for a in arrays],
                              torch.from_numpy(ids))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # out-of-range ids are clamped, as jnp.take(mode='clip') reads them
    edge = torch.tensor([-3, 40, 99])
    np.testing.assert_array_equal(
        tgather.gather_rows([torch.from_numpy(arrays[0])], edge)[0].numpy(),
        arrays[0][[0, 39, 39]])


def test_lazy_adam_rows_matches_pallas():
    rng = np.random.default_rng(3)
    bank, mu, nu = _arrays(count=3, seed=3)
    mu *= 0.1
    nu = np.abs(nu) * 0.01
    n = 13
    ids = rng.permutation(40)[:n].astype(np.int64)
    ids[[3, 9]] = [40, -2]                    # the sentinel and a negative
    g = (rng.normal(size=(n, 16)) * 0.05).astype(np.float32)
    k = rng.integers(0, 9, n).astype(np.float32)
    lr, l2, cnt = 0.01, 1e-3, 5
    d1, d2 = (0.9 ** k).astype(np.float32), (0.999 ** k).astype(np.float32)
    dw = ((1 - 2 * l2 * lr) ** (k + 1)).astype(np.float32)
    c1inv, c2inv = 1 / (1 - 0.9 ** cnt), 1 / (1 - 0.999 ** cnt)
    want = jlazy.lazy_adam_rows(
        *(jnp.asarray(a) for a in (bank, mu, nu)),
        jnp.asarray(ids, jnp.int32), jnp.asarray(g), jnp.asarray(d1),
        jnp.asarray(d2), jnp.asarray(dw), c1inv, c2inv, lr=lr, rb=RB,
        interpret=True)
    got = tlazy.lazy_adam_rows(
        *(torch.from_numpy(a.copy()) for a in (bank, mu, nu)),
        torch.from_numpy(ids), torch.from_numpy(g), torch.from_numpy(d1),
        torch.from_numpy(d2), torch.from_numpy(dw), c1inv, c2inv, lr=lr)
    for gt, w, before in zip(got, want, (bank, mu, nu)):
        np.testing.assert_allclose(gt.numpy(), np.asarray(w), rtol=2.4e-7,
                                   atol=0)
        # the sentinel's and the negative id's rows are left as they were
        untouched = np.setdiff1d(np.arange(40), ids)
        np.testing.assert_array_equal(gt.numpy()[untouched],
                                      before[untouched])


def test_eqgemm_positions_matches_pallas():
    rng = np.random.default_rng(4)
    F, B, W = 2, 24, 16
    ids = rng.integers(0, 6, (F, B)).astype(np.int64)   # many duplicates
    g = rng.normal(size=(F, B, W)).astype(np.float32)
    g = np.array(jnp.asarray(g).astype(jnp.bfloat16).astype(jnp.float32))
    want = jeq.eqgemm_positions(jnp.asarray(ids, jnp.int32), jnp.asarray(g),
                                tile=RB, interpret=True)
    got = teq.eqgemm_positions(torch.from_numpy(ids), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def _combine_inputs(seed=6):
    rng = np.random.default_rng(seed)
    F, B, W = 3, 40, 16
    ids = np.stack([rng.integers(0, 11, B), rng.integers(10, 21, B),
                    rng.integers(20, 30, B)]).astype(np.int64)
    g = rng.normal(size=(F, B, W)).astype(np.float32)
    shared = ((10, (0, 1)), (20, (1, 2)))
    return ids, g, shared


def test_eqgemm_combine_matches_jax_with_shared_rows():
    ids, g, shared = _combine_inputs()
    want = jemb.eqgemm_combine(jnp.asarray(ids, jnp.int32), jnp.asarray(g),
                               shared, impl="xla")
    got = temb.eqgemm_combine(torch.from_numpy(ids), torch.from_numpy(g),
                              shared).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    flat, flat_ids = got.reshape(-1, g.shape[2]), ids.reshape(-1)
    for row in np.unique(flat_ids):            # byte-identical duplicates
        rows = flat[flat_ids == row]
        np.testing.assert_array_equal(rows, np.broadcast_to(rows[0],
                                                            rows.shape))


def test_eq_combine_redirect_matches_jax():
    """Positions whose id leaves its own field's rows (a negative id, an
    id past the bank, an id in the neighbour field's rows) are redirected
    to the first in-range position, as the JAX package does."""
    ids, g, shared = _combine_inputs(seed=7)
    ids[0, [0, 5]] = [-4, 15]                 # field 0 holds rows 0..10
    ids[2, 9] = 1000
    plan = tbo.EqPlan(fields=3, shared=shared,
                      ranges=((0, 10), (10, 20), (20, 29)))
    F, B, W = g.shape
    flat_ids = ids.T.reshape(-1)              # [B, F] row-major
    g_rows = g.transpose(1, 0, 2).reshape(-1, W)
    want_g, want_t = jbo._eq_combine(
        jnp.asarray(flat_ids, jnp.int32), jnp.asarray(g_rows),
        jbo.EqPlan(*plan), 30, force_xla=True)
    got_g, got_t = tbo._eq_combine(torch.from_numpy(flat_ids),
                                   torch.from_numpy(g_rows), plan, 30)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-6)
    assert got_t.numpy()[0] == got_t.numpy()[1] == ids[1, 0]


def test_combine_duplicate_rows_matches_jax():
    rng = np.random.default_rng(8)
    ids = rng.integers(-2, 12, 30).astype(np.int64)
    g = rng.normal(size=(30, 16)).astype(np.float32)
    rep, summed, valid = (np.asarray(a) for a in jemb.combine_duplicate_rows(
        jnp.asarray(ids, jnp.int32), jnp.asarray(g)))
    t_rep, t_summed, t_valid = (a.numpy() for a in temb.combine_duplicate_rows(
        torch.from_numpy(ids), torch.from_numpy(g)))
    np.testing.assert_array_equal(t_valid, valid)
    np.testing.assert_array_equal(t_rep[valid], rep[valid])
    np.testing.assert_allclose(t_summed[valid], summed[valid], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("layout", ["varlen", "no_varlen", "aliccp"])
def test_make_eq_plan_matches_jax(layout):
    def model(pkg):
        if layout == "aliccp":  # the AliCCP sota fields at d=32, rp=4
            cols = [pkg.features.SparseFeature(n, taliccp.DATA_MAX[n] + 2, 32)
                    for n in taliccp.SPARSE_FEATURES]
        else:
            cols = (tp.columns if layout == "varlen"
                    else tp.columns_no_varlen)(pkg)
        return types.SimpleNamespace(layout=pkg.FeatureLayout(cols))

    want = jbo.make_eq_plan(model(satrans_tpu))
    got = tbo.make_eq_plan(model(satrans_torch))
    assert (got is None) == (want is None) == (layout == "varlen")
    if got is not None:
        assert (got.fields, got.shared, got.ranges) == (
            want.fields, want.shared, want.ranges)
        assert got.shared                      # rows two fields share


@pytest.mark.parametrize("layout", ["varlen", "no_varlen"])
def test_bank_gather_plan_matches_jax(layout):
    cols = tp.columns if layout == "varlen" else tp.columns_no_varlen
    jm, params, tm = tp.jax_and_port(cols=cols)
    x = tp.request(12, seed=9)
    x["f0"][2] = -1
    batch = jm.layout.batch_from_dict(x)
    want = jax.jit(lambda emb, b: jemb.bank_gather_plan(emb, jm.layout, b))(
        jax.tree.map(jnp.asarray, params["emb"]),
        {k: jnp.asarray(v) for k, v in batch.items()})
    got = temb.bank_gather_plan(tm.layout, {k: torch.from_numpy(v)
                                            for k, v in batch.items()},
                                tm.emb.rp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
