"""The port's gate and bilinear variants of SATrans against the JAX
package's fused path (``satrans_tpu/ops/pallas/gate_block.py`` in
interpret mode), at the sizes of the JAX package's own gate test
(tests/test_pallas_meta_block.py:337-397): B = 32 on tiles of 16 examples,
4 sparse fields and the scenario column (F = 5, padded to 8 in the JAX
kernel), d = 32, 4 heads, 2 layers, 4 meta rows.

* The layer: the port's ``fused_simple_layer`` on the CPU (the plain
  version of K6-fwd and K6-bwd, with the kernels' dropout masks and logit
  clamp) against ``fused_simple_layer_vjp(interpret=True)``, forward and
  every gradient (x, the layer's parameters, the gate or bilinear
  tables), at dropout 0 and 0.1, rtol 2e-4 / atol 2e-5 (float32 sums in
  another order).
* The model: ``SATrans`` gate, bilinear and bilinear with ``only_emb``
  against the JAX ``SATrans(use_fused_kernel=True, fused_interpret=True)``:
  predictions at atol 1e-5 and, in training at dropout 0.1 with each
  side's default seeds, every gradient of the BCE-sum loss at the layer
  tolerance.
* Two ``Trainer.fit`` steps of gate at dropout 0.1 in ``lazy`` against the
  JAX ``Trainer``, each drawing its own seeds: losses at rtol 1e-5, every
  parameter at atol 5e-5 / rtol 1e-3 (tests/test_torch_train.py's
  tolerances).
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
from satrans_torch.ops import gate_block as tgb
from satrans_torch.utils import make_generator
from satrans_tpu.nn import attention as jattn
from satrans_tpu.ops.pallas import gate_block as jgb
from satrans_tpu.train import losses as jlosses
from test_torch_bank_train import _jax_fit

TOL = dict(rtol=2e-4, atol=2e-5)
B, F, D_EMB, HEADS, BLOCK, ROWS = 32, 5, 32, 4, 16, 4
RATE, SEED = 0.1, 2 ** 31 - 2  # seed + tile wraps past int32


def _layer_setup(variant, seed=0):
    """numpy inputs, upstream gradient, JAX layer params and tables, and
    the port's layer holding the same params.  The gate has distinct Q
    and K tables, so that both gradients are held."""
    rng = np.random.default_rng(seed)
    lp = jattn.meta_transformer_init(jax.random.PRNGKey(seed), D_EMB,
                                     [D_EMB, 64, D_EMB], variant=variant)
    lp = jax.tree.map(lambda a: np.asarray(a) + (
        rng.normal(size=a.shape) * 0.1).astype(np.float32), lp)

    def normal(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    x, g = normal(B, F, D_EMB), normal(B, F, D_EMB)
    if variant == "gate":
        tables = {"Q": normal(ROWS, D_EMB), "K": normal(ROWS, D_EMB)}
    else:
        tables = {"bilinear": normal(ROWS, D_EMB * D_EMB // HEADS,
                                     scale=0.5)}
    dom = rng.integers(0, ROWS, size=B)
    layer = tattn.MetaTransformerLayer(make_generator(0, "cpu"), D_EMB,
                                       variant=variant)
    layer.load_state_dict(bridge.from_jax_params(lp, layer))
    return x, g, lp, tables, dom, layer


@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("variant,mode,relu_out", [
    ("gate", "QK", False), ("gate", "Query", False), ("gate", "QK", True),
    ("bilinear", "QK", False)])
def test_layer_matches_jax_interpret_kernels(variant, mode, relu_out, rate):
    x, g, lp, tables, dom, layer = _layer_setup(variant)
    onehot = jax.nn.one_hot(jnp.asarray(dom), ROWS)
    drop = dict(train=True, drop_rate=rate, seed=SEED, block_b=BLOCK)

    def fn(x, lp, tables):
        return jgb.fused_simple_layer_vjp(
            x, lp, tables, onehot, variant=variant, mode=mode,
            head_num=HEADS, interpret=True, relu_out=relu_out, **drop)

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
    y = tgb.fused_simple_layer(xt, layer, tt, torch.from_numpy(dom),
                               head_num=HEADS, mode=mode, relu_out=relu_out,
                               **drop)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_jax), **TOL)
    got = {n: p.grad.numpy() for n, p in layer.named_parameters()}
    got.update(x=xt.grad.numpy())
    # an unread table (K under 'Query') has a zero gradient in JAX
    got.update({f"table.{k}": np.zeros_like(tables[k]) if t.grad is None
                else t.grad.numpy() for k, t in tt.items()})
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   **TOL)


def _cols(pkg, combiner="max"):
    """Four sparse fields (two in the large bank) and the scenario
    column, at d = 32."""
    f = pkg.features
    return [f.SparseFeature("f0", 300, D_EMB),
            f.SparseFeature("f1", 500, D_EMB),
            f.SparseFeature("f2", 40, D_EMB),
            f.SparseFeature("f3", 60, D_EMB),
            f.SparseFeature("domain", 5, D_EMB)]


def _request(n, seed):
    rng = np.random.default_rng(seed)
    return {"f0": rng.integers(1, 300, n), "f1": rng.integers(1, 500, n),
            "f2": rng.integers(1, 40, n), "f3": rng.integers(1, 60, n),
            "domain": rng.integers(1, 4, n)}


def _models(**kw):
    jm, params, tm = tp.jax_and_port(
        cols=_cols, att_head_num=HEADS, meta_dnn_hidden_units=(64, 32),
        dropout_rate=RATE, fused_block_b=BLOCK, **kw)
    return (dataclasses.replace(jm, use_fused_kernel=True,
                                fused_interpret=True), params, tm)


@pytest.mark.parametrize("kw", [dict(variant="gate"),
                                dict(variant="bilinear"),
                                dict(variant="bilinear", only_emb=True)],
                         ids=["gate", "bilinear", "bilinear-onlyemb"])
def test_model_matches_jax_fused_interpret_path(kw):
    jm, params, tm = _models(**kw)
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
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name].numpy(),
                                   err_msg=name, **TOL)


def test_gate_fit_lazy_at_dropout_matches_jax_trainer():
    """24 examples at batch 16: a full batch and a padded tail."""
    jm, params, tm = _models(variant="gate")
    x = _request(24, seed=5)
    y = np.random.default_rng(5).integers(0, 2, 24).astype(np.float32)
    j_steps, j_params, _ = _jax_fit(jm, params, x, y, "lazy")

    steps = tp.port_fit(tm, x, y, "lazy")
    assert len(steps) == 2
    tp.assert_fit_matches(j_steps, j_params, steps, tm)
