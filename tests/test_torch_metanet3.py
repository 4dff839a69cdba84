"""3-matrix MetaNets in the port against the JAX package, and MetaNets of
other depths on the plain layer.

The units are ``[32, 64, 64, 32]`` (``meta_dnn_hidden_units=(64, 64,
32)``): the middle matrix rides every K1 and K7 body on the card; on the
CPU the wrappers run their plain version, which these tests hold against
the JAX package's interpret-mode Pallas kernels (layer level) and its
jitted fused path (model level).  d = 32, 4 heads, F = 5, batches of 32
on dropout tiles of 16.

* The layer: the CPU ``fused_meta_layer`` against
  ``meta_block.fused_meta_layer_vjp(interpret=True)`` under ``bwd``
  stash, stash_light and recompute at dropout 0 and 0.1, with shared
  tables (QK; Query with ``relu_out``) and distinct 'pos' tables with a
  ``k_meta`` LayerNorm: forward at rtol 2e-4 / atol 2e-5, every gradient
  (x, the layer's parameters, the tables, whose middle block must move)
  at rtol 2e-3 / atol 2e-4.
* The probes' layer: ``fused_meta_layer_with_scores`` against the JAX
  one, ``y`` and ``s``.
* The tiled layer (K7's plain version) against
  ``tiled_meta.fused_tiled_layer_vjp(interpret=True)`` on 4 tiles of 16,
  stash and recompute at dropout 0.1.
* The model: single column, ``use_pos`` and a 12-row composite (K7)
  against the JAX fused path (predictions and train-mode gradients with
  each side's default seeds, the entry points counted on both sides);
  two ``lazy`` ``fit`` steps at dropout 0.1 against the JAX ``Trainer``.
* 1- and 4-matrix MetaNets: the port's plain layer against the JAX XLA
  path, with no K1 entry on the port's kernel route.
* ``bridge``: JAX 3-matrix trees (shared, pos, multicol) into
  ``serving.Predictor``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parity as tp
from satrans_torch import bridge
from satrans_torch.nn import attention as tattn
from satrans_torch.ops import meta_block as tmb
from satrans_torch.ops import tiled_meta as ttm
from satrans_torch.serving import Predictor
from satrans_torch.utils import make_generator
from satrans_tpu.nn import attention as jattn
from satrans_tpu.nn import metanet as jmetanet
from satrans_tpu.ops.pallas import meta_block as jmb
from satrans_tpu.ops.pallas import tiled_meta as jtm
from satrans_tpu.train import losses as jlosses
from test_torch_bank_train import _jax_fit
from test_torch_multicol import _spy

FWD_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
D, HEADS = 32, 4
HIDDEN = (64, 64, D)
UNITS = [D, *HIDDEN]
B, F, BLOCK, ROWS = 32, 5, 16, 4
RATE, SEED = 0.1, 2 ** 31 - 7  # seed + tile wraps past int32
# the tables' middle block: W1 [d, h1] comes first
MID = slice(D * UNITS[1], D * UNITS[1] + UNITS[1] * UNITS[2])


def _layer_setup(pos, n=B, rows=ROWS, seed=0):
    """numpy inputs and upstream gradient, JAX layer params moved off their
    init, ``rows``-row tables (Q only, or distinct Q and K under ``pos``),
    domain rows, and the port's layer holding the params."""
    rng = np.random.default_rng(seed)
    lp = jattn.meta_transformer_init(jax.random.PRNGKey(seed), D, UNITS,
                                     share_kv_metanet=not pos)
    lp = jax.tree.map(lambda a: np.asarray(a) + (
        rng.normal(size=a.shape) * 0.1).astype(np.float32), lp)
    x = rng.normal(size=(n, F, D)).astype(np.float32)
    g = rng.normal(size=(n, F, D)).astype(np.float32)
    p = jmetanet.param_size(UNITS)
    tables = {k: (rng.normal(size=(rows, p)) * 0.1).astype(np.float32)
              for k in ("QK" if pos else "Q")}
    dom = rng.integers(0, rows, size=n)
    layer = tattn.MetaTransformerLayer(make_generator(0, "cpu"), D,
                                       share_kv_metanet=not pos)
    layer.load_state_dict(bridge.from_jax_params(lp, layer))
    return x, g, lp, tables, dom, layer


def _both(tables):
    """Q and K tables: distinct, or one for both."""
    return tables if "K" in tables else {"Q": tables["Q"],
                                         "K": tables["Q"]}


def _check_grads(layer, xt, tt, glp, gx, gt):
    """The port's gradients against JAX's: the layer's parameters (an
    unapplied MetaNet's LayerNorm and v_meta have none in the port, zeros
    in JAX), x and the tables; the tables' middle block moves."""
    want = dict(bridge._flatten(jax.tree.map(np.asarray, glp)))
    want.update(x=np.asarray(gx))
    want.update({f"table.{k}": np.asarray(v) for k, v in gt.items()})
    got = {n: np.zeros_like(want[n]) if p.grad is None else p.grad.numpy()
           for n, p in layer.named_parameters()}
    got.update(x=xt.grad.numpy())
    got.update({f"table.{k}": t.grad.numpy() for k, t in tt.items()})
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   **GRAD_TOL)
    assert np.abs(got["table.Q"][:, MID]).max() > 0


# each backward, each dropout rate and each table layout at least once
LAYER_CASES = {
    "QK-stash-0": ("QK", False, False, "stash", 0.0),
    "Query-relu_out-stash_light-0.1": ("Query", True, False, "stash_light",
                                       RATE),
    "pos-recompute-0.1": ("QK", False, True, "recompute", RATE),
}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_layer_matches_jax_interpret_kernel(case):
    mode, relu_out, pos, bwd, rate = LAYER_CASES[case]
    x, g, lp, tables, dom, layer = _layer_setup(pos)
    onehot = jax.nn.one_hot(jnp.asarray(dom), ROWS)
    drop = dict(train=True, drop_rate=rate, seed=SEED, block_b=BLOCK)

    def fn(x, lp, tables):
        return jmb.fused_meta_layer_vjp(
            x, lp, _both(tables), onehot, meta_units=UNITS, head_num=HEADS,
            interpret=True, bwd=bwd, stash_dtype="f32", mode=mode,
            relu_out=relu_out, **drop)

    y_jax, pullback = jax.vjp(fn, jnp.asarray(x),
                              jax.tree.map(jnp.asarray, lp),
                              jax.tree.map(jnp.asarray, tables))
    gx, glp, gt = pullback(jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_(True)
    tt = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in tables.items()}
    y = tmb.fused_meta_layer(xt, layer, _both(tt), torch.from_numpy(dom),
                             meta_units=UNITS, head_num=HEADS, mode=mode,
                             relu_out=relu_out, bwd=bwd, **drop)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_jax),
                               **FWD_TOL)
    _check_grads(layer, xt, tt, glp, gx, gt)
    if pos:
        assert not np.allclose(tt["Q"].grad.numpy(), tt["K"].grad.numpy())


def test_scores_layer_matches_jax_interpret_kernel():
    """K1-scores' plain version: ``y`` and the probabilities ``s``
    (distinct tables, dropout 0.1 in training)."""
    x, _, lp, tables, dom, layer = _layer_setup(True, seed=1)
    drop = dict(train=True, drop_rate=RATE, seed=SEED, block_b=BLOCK)
    y_j, s_j = jmb.fused_meta_layer_with_scores(
        jnp.asarray(x), jax.tree.map(jnp.asarray, lp),
        {k: jnp.asarray(v) for k, v in tables.items()},
        jax.nn.one_hot(jnp.asarray(dom), ROWS), meta_units=UNITS,
        head_num=HEADS, interpret=True, **drop)
    with torch.no_grad():
        y, s = tmb.fused_meta_layer_with_scores(
            torch.from_numpy(x), layer,
            {k: torch.from_numpy(v) for k, v in tables.items()},
            torch.from_numpy(dom), meta_units=UNITS, head_num=HEADS, **drop)
    assert s.shape == (B, HEADS, F, F) == s_j.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **FWD_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), **FWD_TOL)


N_TILES, TILE = 4, 16


@pytest.mark.parametrize("pos,bwd", [(False, "stash"), (True, "recompute")],
                         ids=["QK-stash", "pos-recompute"])
def test_tiled_layer_matches_jax_interpret_kernel(pos, bwd):
    """K7's plain version on 4 tiles of 16 slots (the last tile's slots
    zero, as dispatch slack) at dropout 0.1."""
    x, g, lp, tables, _, layer = _layer_setup(pos, n=N_TILES * TILE,
                                              rows=N_TILES, seed=2)
    x[-TILE + 3:] = 0.0
    drop = dict(train=True, drop_rate=RATE, seed=SEED, block_b=TILE)

    def fn(x, lp, tables):
        return jtm.fused_tiled_layer_vjp(
            x, lp, _both(tables), meta_units=UNITS, head_num=HEADS,
            interpret=True, bwd=bwd, **drop)

    y_jax, pullback = jax.vjp(fn, jnp.asarray(x),
                              jax.tree.map(jnp.asarray, lp),
                              jax.tree.map(jnp.asarray, tables))
    gx, glp, gt = pullback(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    tt = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in tables.items()}
    y = ttm.fused_tiled_layer(xt, layer, _both(tt), meta_units=UNITS,
                              head_num=HEADS, bwd=bwd, **drop)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_jax),
                               **FWD_TOL)
    _check_grads(layer, xt, tt, glp, gx, gt)


# ------------------------------------------------------------------- model

# one layer: the JAX references compile the interpret-mode kernels once a
# layer
MODEL_B, MODEL_LAYERS = 32, 1


def _cols(pkg, combiner="max"):
    """``torch_parity.columns`` at d = 32, and a second scenario column."""
    f = pkg.features
    return [f.SparseFeature("f0", 300, D), f.SparseFeature("f1", 500, D),
            f.SparseFeature("domain", 5, D),
            f.VarLenSparseFeature("hist", 300, D, 3, combiner),
            f.SparseFeature("dom2", 6, D)]


def _request(n, seed):
    x = tp.request(n, seed=seed)
    x["dom2"] = np.random.default_rng(seed + 100).integers(0, 5, n)
    return x


MODEL_CASES = {
    "single": dict(),
    "pos": dict(use_pos=True),
    "multicol-K7": dict(domain_cols=["domain", "dom2"],
                        num_domains_list=[3, 2]),
}


def _models(hidden=HIDDEN, rate=RATE, layers=MODEL_LAYERS, **kw):
    """(JAX model on its fused interpret-mode path, numpy params, the port's
    model holding them)."""
    jm, params, tm = tp.jax_and_port(
        cols=_cols, att_head_num=HEADS, meta_dnn_hidden_units=hidden,
        dropout_rate=rate, domain_att_layer_num=layers, **kw)
    return (dataclasses.replace(jm, use_fused_kernel=True,
                                fused_interpret=True), params, tm)


def _batches(jm, x):
    batch = jm.layout.batch_from_dict(x)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _assert_train_step_matches(jm, params, tm, x, y):
    """Train-mode predictions (each side's default seeds) at atol 1e-5 and
    the BCE-sum gradients at the layer's tolerance; the JAX side jitted
    once (one compile of the interpret-mode kernels, not op by op)."""
    jbatch, tbatch = _batches(jm, x)

    def loss(p):  # rng=None: the JAX package's default seeds
        pred = jm.apply(p, {}, jbatch, train=True)[0]
        return jlosses.bce_sum(pred, jnp.asarray(y)), pred

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    assert np.asarray(want).std() > 1e-2  # the parameters move it
    jgrads = bridge.from_jax_params(jax.tree.map(np.asarray, jgrads), tm)
    tm.train()
    pred = tm(tbatch)
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    torch.nn.functional.binary_cross_entropy(
        pred, torch.from_numpy(y), reduction="sum").backward()
    for name, p in tm.named_parameters():
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(grad.numpy(), jgrads[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_model_matches_jax_fused_interpret_path(case, monkeypatch):
    jm, params, tm = _models(**MODEL_CASES[case])
    route = "tiled" if case == "multicol-K7" else "metanet"
    assert tm.metanet_kernel and tm.tiled == (route == "tiled")
    x = _request(MODEL_B, seed=1)
    y = np.random.default_rng(1).integers(0, 2, MODEL_B).astype(np.float32)
    calls = _spy(monkeypatch)
    _assert_train_step_matches(jm, params, tm, x, y)
    assert calls[route] == calls[f"jax {route}"] == MODEL_LAYERS
    assert sum(calls.values()) == 2 * MODEL_LAYERS


def test_lazy_fit_at_dropout_matches_jax_trainer():
    """24 examples at batch 16 (a full batch and a padded tail), the
    parity tests' two layers."""
    jm, params, tm = _models(layers=tp.LAYERS)
    x = _request(24, seed=5)
    y = np.random.default_rng(5).integers(0, 2, 24).astype(np.float32)
    j_steps, j_params, _ = _jax_fit(jm, params, x, y, "lazy")
    steps = tp.port_fit(tm, x, y, "lazy")
    assert len(steps) == 2
    tp.assert_fit_matches(j_steps, j_params, steps, tm)


@pytest.mark.parametrize("hidden", [(D,), (64, 64, 64, D)],
                         ids=["1-matrix", "4-matrix"])
def test_other_depths_take_the_plain_layer_as_jax_takes_xla(hidden,
                                                           monkeypatch):
    """No kernel takes these MetaNets: the JAX package's forced fused path
    falls back to its XLA layer (tests/test_pallas_meta_block.py:490-510)
    and the port's kernel route to the plain layer, without a K1 entry.
    Predictions, and train-mode gradients at dropout 0 (the XLA layer
    draws ``jax.random`` masks, which the port does not)."""
    jm, params, tm = _models(hidden, rate=0.0)
    assert tm.use_kernel and not tm.metanet_kernel
    x = _request(MODEL_B, seed=3)
    y = np.random.default_rng(3).integers(0, 2, MODEL_B).astype(np.float32)
    calls = _spy(monkeypatch)
    _assert_train_step_matches(jm, params, tm, x, y)
    assert sum(calls.values()) == 0, calls


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_bridge_moves_a_3matrix_tree_into_serving(case):
    """The JAX tree's flat ``[h1 * h2]`` middle block needs no layout
    change: the ``Predictor`` (40 examples at batch 16, a padded tail)
    gives the JAX model's predictions."""
    jm, params, tm = _models(rate=0.0, **MODEL_CASES[case])
    x = _request(40, seed=4)
    jbatch, _ = _batches(jm, x)
    want = np.asarray(jax.jit(lambda p: jm.apply(p, {}, jbatch)[0])(
        jax.tree.map(jnp.asarray, params)))
    got = Predictor(tm, batch_size=16, device="cpu")(x)
    np.testing.assert_allclose(got, want, atol=1e-5)
