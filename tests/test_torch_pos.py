"""The port's Alimama sota-pos path against the JAX package.

'pos' (``SATrans(use_pos=True)``) gives every layer its own Q and K
MetaNet tables, from the encoder over ``[relu(domain_emb) | layerid_emb[l]
+ qkvid_emb[qkv]]``, and every metanet layer its own ``k_meta``
LayerNorm (and a ``v_meta`` that is never applied).  Small widths, as in
``torch_parity``: d = 8, 2 heads, MetaNet 8 -> 16 -> 8, 2 layers, batches
of 32 on dropout tiles of 16.

* The constants of ``satrans_torch/data/alimama.py`` against
  ``satrans_tpu/data/alimama.py`` and ``bench.py``'s vocab sizes.
* The layer: the port's CPU ``fused_meta_layer`` (the plain version of the
  K1 bodies) with distinct Q and K tables and a changed ``k_meta``
  LayerNorm against ``fused_meta_layer_vjp(interpret=True)``: forward at
  rtol 2e-4 / atol 2e-5, every gradient for ``bwd`` in stash and
  stash_light at dropout 0 and 0.1 at rtol 2e-3 / atol 2e-4 (the JAX
  package's own pos test, tests/test_pallas_meta_block.py:716-760); the
  dQ and dK tables differ.
* The model: ``SATrans(use_pos=True)`` metanet, gate and bilinear with a
  dense ``price`` column against the JAX fused path in interpret mode:
  predictions at atol 1e-5 and, in training at dropout 0.1 with each
  side's default seeds, every gradient at the layer's tolerance.
* Two ``fit`` steps (``lazy``, the bench arm, and ``dense``) at dropout
  0.1 and lr 0.001 with ``price`` against the JAX ``Trainer``, each
  drawing its own seeds (the tolerances of ``tests/test_torch_faults.py``),
  ``v_meta`` unchanged on both sides; ``predict``, ``evaluate`` and the
  ``Predictor`` read ``price``; the backward rule takes ``stash_light``.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parity as tp
from satrans_torch import bridge
from satrans_torch.data import alimama as talimama
from satrans_torch.nn import attention as tattn
from satrans_torch.ops import meta_block as tmb
from satrans_torch.serving import Predictor
from satrans_torch.utils import make_generator
from satrans_tpu.data import alimama as jalimama
from satrans_tpu.nn import attention as jattn
from satrans_tpu.nn import metanet as jmetanet
from satrans_tpu.ops.pallas import meta_block as jmb
from satrans_tpu.train import losses as jlosses
from test_torch_bank_train import _jax_fit

FWD_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
B, F, HEADS, BLOCK, ROWS = 32, 5, 2, 16, 4
UNITS = [tp.D_EMB, 16, tp.D_EMB]
RATE, SEED = 0.1, 2 ** 31 - 5  # seed + tile wraps past int32
LR = 0.001                     # the Alimama sota-pos arm's (bench.py:127)


def test_alimama_constants_match_jax_and_bench():
    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("bench", root / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    assert talimama.SPARSE_FEATURES == jalimama.SPARSE_FEATURES
    assert talimama.DENSE_FEATURES == jalimama.DENSE_FEATURES
    assert talimama.DATA_MAX == bench.ALIMAMA_DATA_MAX
    assert list(talimama.DATA_MAX) == talimama.SPARSE_FEATURES
    cols = talimama.sota_columns(32)
    assert [(c.name, c.vocab) for c in cols[:-1]] == [
        (n, v + 2) for n, v in bench.ALIMAMA_DATA_MAX.items()]
    assert (cols[-1].name, cols[-1].dimension) == ("price", 1)
    assert talimama.DOMAIN_COL in talimama.SPARSE_FEATURES


def _layer_setup(seed=0):
    """numpy inputs, upstream gradient, JAX 'pos' layer params (each leaf
    moved off its init, so the k_meta LayerNorm differs from q_meta's),
    distinct Q and K tables, and the port's layer holding the params."""
    rng = np.random.default_rng(seed)
    d = tp.D_EMB
    lp = jattn.meta_transformer_init(jax.random.PRNGKey(seed), d, UNITS,
                                     share_kv_metanet=False)
    lp = jax.tree.map(lambda a: np.asarray(a) + (
        rng.normal(size=a.shape) * 0.1).astype(np.float32), lp)
    x = rng.normal(size=(B, F, d)).astype(np.float32)
    g = rng.normal(size=(B, F, d)).astype(np.float32)
    p = jmetanet.param_size(UNITS)
    tables = {k: (rng.normal(size=(ROWS, p)) * 0.1).astype(np.float32)
              for k in "QK"}
    dom = rng.integers(0, ROWS, size=B)
    layer = tattn.MetaTransformerLayer(make_generator(0, "cpu"), d,
                                       share_kv_metanet=False)
    layer.load_state_dict(bridge.from_jax_params(lp, layer))
    return x, g, lp, tables, dom, layer


@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("bwd", ["stash", "stash_light"])
def test_layer_with_separate_tables_matches_jax_interpret_kernels(bwd, rate):
    x, g, lp, tables, dom, layer = _layer_setup()
    assert not np.allclose(lp["k_meta"]["ln"]["scale"],
                           lp["q_meta"]["ln"]["scale"])
    onehot = jax.nn.one_hot(jnp.asarray(dom), ROWS)
    drop = dict(train=True, drop_rate=rate, seed=SEED, block_b=BLOCK)

    def fn(x, lp, tables):
        return jmb.fused_meta_layer_vjp(
            x, lp, tables, onehot, meta_units=UNITS, head_num=HEADS,
            interpret=True, bwd=bwd, stash_dtype="f32", mode="QK", **drop)

    y_jax, pullback = jax.vjp(fn, jnp.asarray(x),
                              jax.tree.map(jnp.asarray, lp),
                              jax.tree.map(jnp.asarray, tables))
    gx, glp, gt = pullback(jnp.asarray(g))
    want = dict(bridge._flatten(jax.tree.map(np.asarray, glp)))
    want.update(x=np.asarray(gx))
    want.update({f"table.{k}": np.asarray(v) for k, v in gt.items()})

    xt = torch.from_numpy(x).requires_grad_(True)
    tt = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in tables.items()}
    y = tmb.fused_meta_layer(xt, layer, tt, torch.from_numpy(dom),
                             meta_units=UNITS, head_num=HEADS, mode="QK",
                             bwd=bwd, **drop)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_jax),
                               **FWD_TOL)
    # v_meta is never applied: no gradient in the port, zeros in JAX
    got = {n: np.zeros_like(want[n]) if p.grad is None else p.grad.numpy()
           for n, p in layer.named_parameters()}
    assert all(layer.get_parameter(n).grad is None
               for n in got if n.startswith("v_meta"))
    got.update(x=xt.grad.numpy())
    got.update({f"table.{k}": t.grad.numpy() for k, t in tt.items()})
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   **GRAD_TOL)
    assert not np.allclose(got["table.Q"], got["table.K"])


def _cols(pkg, combiner="max"):
    """``torch_parity.columns`` and a dense ``price`` column."""
    return tp.columns(pkg, combiner) + [pkg.features.DenseFeature("price",
                                                                  1)]


def _request(n, seed):
    x = tp.request(n, seed=seed)
    x["price"] = np.random.default_rng(seed + 100).normal(size=n).astype(
        np.float32)
    return x


def _models(**kw):
    jm, params, tm = tp.jax_and_port(
        cols=_cols, use_pos=True, dropout_rate=RATE, fused_block_b=BLOCK,
        **kw)
    return (dataclasses.replace(jm, use_fused_kernel=True,
                                fused_interpret=True), params, tm)


@pytest.mark.parametrize("variant", ["metanet", "gate", "bilinear"])
def test_pos_model_matches_jax_fused_interpret_path(variant):
    jm, params, tm = _models(variant=variant)
    assert tm.meta_tables()[0]["K"] is not tm.meta_tables()[0]["Q"]
    x = _request(B, seed=1)
    y = np.random.default_rng(1).integers(0, 2, B).astype(np.float32)
    batch = jm.layout.batch_from_dict(x)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jparams = jax.tree.map(jnp.asarray, params)

    want = np.asarray(jm.apply(jparams, {}, jbatch)[0])
    assert want.std() > 1e-2  # the parameters move the prediction
    with torch.no_grad():
        np.testing.assert_allclose(tm(tbatch).numpy(), want, atol=1e-5)

    def loss(p):  # rng=None: the JAX package's default seeds
        pred = jm.apply(p, {}, jbatch, train=True)[0]
        return jlosses.bce_sum(pred, jnp.asarray(y))

    jgrads = bridge.from_jax_params(
        jax.tree.map(np.asarray, jax.grad(loss)(jparams)), tm)
    tm.train()
    pred = tm(tbatch)
    torch.nn.functional.binary_cross_entropy(
        pred, torch.from_numpy(y), reduction="sum").backward()
    for name, p in tm.named_parameters():
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(grad.numpy(), jgrads[name].numpy(),
                                   err_msg=name, **GRAD_TOL)
    assert tm.layerid_emb.grad.abs().max() > 0
    assert tm.qkvid_emb.grad[:2].abs().max() > 0


@pytest.mark.parametrize("mode", ["lazy", "dense"])
def test_pos_fit_at_dropout_with_price_matches_jax_trainer(mode):
    """24 examples at batch 16: a full batch and a padded tail; the
    price column reaches the head in both steps.  ``lazy`` is the bench
    arm, ``dense`` the reference's exact update.

    ``k_meta.ln.bias`` adds ``q . b`` to every logit of a query row, which
    the softmax cancels: its gradient is zero in exact arithmetic (1.8e-17
    in float64 here), so each package's float32 round-off is all Adam
    sees, and Adam's sign-like steps move it by up to ``lr`` a step in
    either direction.  It is held to that bound on both sides instead of
    to the other's value."""
    jm, params, tm = _models()
    x = _request(24, seed=5)
    y = np.random.default_rng(5).integers(0, 2, 24).astype(np.float32)
    j_steps, j_params, _ = _jax_fit(jm, params, x, y, mode, lr=LR)

    steps = tp.port_fit(tm, x, y, mode, lr=LR)
    assert len(steps) == 2
    noise = [f"layers.{i}.k_meta.ln.bias" for i in range(len(tm.layers))]
    tp.assert_fit_matches(j_steps, j_params, steps, tm, exclude=noise)
    got = tm.state_dict()
    for i in range(len(tm.layers)):
        start, after = params["layers"][i], j_params["layers"][i]
        # two Adam steps move an entry by at most 2.0014 lr (b1 0.9, b2
        # 0.999: lr, then lr times 1.0014 by Cauchy-Schwarz)
        for moved in (after["k_meta"]["ln"]["bias"],
                      got[noise[i]].numpy()):
            assert np.abs(moved - start["k_meta"]["ln"]["bias"]).max() \
                <= 2.0014 * LR * (1 + 1e-4)
        for k in ("scale", "bias"):
            v = start["v_meta"]["ln"][k]
            np.testing.assert_array_equal(after["v_meta"]["ln"][k], v)
            np.testing.assert_array_equal(
                got[f"layers.{i}.v_meta.ln.{k}"].numpy(), v)


def test_predict_evaluate_and_serving_read_price():
    """``Trainer.predict``, ``Trainer.evaluate`` and the ``Predictor`` (20
    examples at batch 16: a padded tail) give the model's scores on the
    same batch, and the scores move with the price column."""
    from satrans_torch.train import Trainer
    _, _, tm = _models()
    x = _request(20, seed=3)
    y = np.random.default_rng(3).integers(0, 2, 20).astype(np.float32)
    batch = tm.layout.batch_from_dict(x)
    with torch.no_grad():
        want = tm({k: torch.from_numpy(v) for k, v in batch.items()})
    tr = Trainer(tm, device="cpu").compile(metrics=("auc",))
    for scores in (Predictor(tm, batch_size=16, device="cpu")(x),
                   tr.predict(x, batch_size=16)):
        np.testing.assert_allclose(scores, want.numpy(), atol=1e-6)
    assert np.isfinite(tr.evaluate(x, y, batch_size=16)["auc"])
    moved = Predictor(tm, batch_size=16, device="cpu")(
        dict(x, price=x["price"] + 1.0))
    assert np.abs(moved - want.numpy()).min() > 0


def test_bwd_rule_takes_stash_light(monkeypatch):
    assert tmb.bwd_mode("stash_light") == "stash_light"
    monkeypatch.setenv("SATRANS_BWD", "stash_light")
    assert tmb.bwd_mode() == "stash_light"
    assert tmb.bwd_mode("recompute") == "recompute"
    monkeypatch.setenv("SATRANS_BWD", "light")
    with pytest.raises(ValueError, match="unknown bwd mode"):
        tmb.bwd_mode()
