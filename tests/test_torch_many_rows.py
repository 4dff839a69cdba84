"""SATrans on many meta rows: the port against the JAX package's fused path.

The JAX package's kernel route takes a single-column metanet while its
meta rows times the widest MetaNet hidden layer are at most 4096, the
gate at any row count and the bilinear map while the rows times d are at
most 4096 (satrans_tpu/models/satrans.py:363-380); past that its model
takes the XLA layer.  The port routes the same way: K1 (whose backward
walks the batch sorted by domain row past the rows a block's slice holds)
and K6 on the card, their plain versions here.  Small sizes: d = 8 with 2
heads (d = 16 for the metanet at the cap), one layer, B = 64, F = 5.

* The model (predictions at atol 1e-5; train-mode gradients at dropout
  0.1 at rtol 2e-3 / atol 2e-4, each side's default seeds, so every mask
  has to be the JAX interpret-mode kernel's bit for bit) against the JAX
  fused path in interpret mode, jitted, with each side's layer entry
  points counted: a gate and a bilinear composite of 56 rows (``domain``
  x a 13-value column, the reference CLI's ``--domain_col 301-122``
  size), a single-column gate of 98 rows (``--domain_col 121``) and a
  single-column metanet at the JAX cap (128 rows at d = 16).
* One ``lazy`` ``fit`` step of the 56-row gate at dropout 0.1 against the
  JAX ``Trainer``.
* Past the caps both sides take the XLA layer (a bilinear map of 300 rows
  at d = 16, a metanet of 300 rows at d = 8), while the gate on the same
  300 rows stays on the kernel route on both.
* The port's CLI builds and trains the reference CLI's many-row runs
  (``--domain_col 301-122 --flag gate`` and ``bilinear``, ``--domain_col
  121 --flag gate``, ``--embedding_dim 64 --att_head_num 8 --domain_col
  122``) on the kernel route, on a small AliCCP-shaped dataset.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parity as tp
from satrans_torch import bridge
from satrans_torch.ops import threefry
from satrans_tpu.train import losses as jlosses
from test_torch_bank_train import _jax_fit
from test_torch_multicol import _spy

GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
RATE = 0.1
B = 64
FAST = {"xla_backend_optimization_level": 0}


def _cols(d, domains):
    """Two large fields, the scenario column (``domains`` ids), a second
    scenario column of 16 ids and a varlen field: F = 5 at width ``d``."""
    def cols(pkg, combiner="max"):
        f = pkg.features
        return [f.SparseFeature("f0", 300, d), f.SparseFeature("f1", 500, d),
                f.SparseFeature("domain", domains, d),
                f.SparseFeature("dom2", 16, d),
                f.VarLenSparseFeature("hist", 300, d, 3, combiner)]
    return cols


def _request(n, seed, domains):
    """Ids of every column; the scenario ids past their ranges too."""
    rng = np.random.default_rng(seed)
    return {"f0": rng.integers(1, 300, n), "f1": rng.integers(1, 500, n),
            "domain": rng.integers(0, domains + 2, n),
            "dom2": rng.integers(0, 16, n),
            "hist": rng.integers(0, 300, (n, 3))}


# name: (d, the model's keywords, the scenario column's ids, the route of
# both sides: the layer entry points counted, or 'xla')
CASES = {
    "gate-56-composite": (8, dict(variant="gate", domain_cols=[
        "domain", "dom2"], num_domains_list=[3, 13]), 4, "simple"),
    "bilinear-56-composite": (8, dict(variant="bilinear", domain_cols=[
        "domain", "dom2"], num_domains_list=[3, 13]), 4, "simple"),
    "gate-98-single": (8, dict(variant="gate", num_domains_list=[97]), 98,
                       "simple"),
    "metanet-128-single-at-cap": (16, dict(
        variant="metanet", num_domains_list=[127], att_head_num=2,
        meta_dnn_hidden_units=(32, 16)), 128, "metanet"),
    "bilinear-300-past-cap": (16, dict(
        variant="bilinear", num_domains_list=[299], att_head_num=2), 300,
        "xla"),
    "gate-300-kernel": (16, dict(variant="gate", num_domains_list=[299],
                                 att_head_num=2), 300, "simple"),
    "metanet-300-past-cap": (8, dict(variant="metanet",
                                     num_domains_list=[299]), 300, "xla"),
}


def _models(name):
    d, kw, domains, _ = CASES[name]
    jm, params, tm = tp.jax_and_port(
        cols=_cols(d, domains), domain_att_layer_num=1, dropout_rate=RATE,
        **kw)
    return (dataclasses.replace(jm, use_fused_kernel=True,
                                fused_interpret=True), params, tm)


def _batches(jm, n, seed, name):
    batch = jm.layout.batch_from_dict(_request(n, seed, CASES[name][2]))
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("name", ["gate-56-composite",
                                  "bilinear-56-composite", "gate-98-single",
                                  "metanet-128-single-at-cap"])
def test_many_rows_model_matches_jax_fused_interpret_path(name,
                                                          monkeypatch):
    route = CASES[name][3]
    jm, params, tm = _models(name)
    rows = 56 if "56" in name else int(name.split("-")[1])
    assert tm.meta_rows == jm.meta_rows == rows
    assert not tm.tiled
    jbatch, tbatch = _batches(jm, B, 1, name)
    y = np.random.default_rng(1).integers(0, 2, B).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, params)
    calls = _spy(monkeypatch)

    def run(p):  # rng=None in training: the JAX package's default seeds
        pred = jm.apply(p, {}, jbatch)[0]
        return pred, jax.grad(lambda q: jlosses.bce_sum(
            jm.apply(q, {}, jbatch, train=True)[0], jnp.asarray(y)))(p)

    want, jgrads = jax.jit(run).lower(jparams).compile(
        compiler_options=FAST)(jparams)
    want = np.asarray(want)
    jgrads = bridge.from_jax_params(jax.tree.map(np.asarray, jgrads), tm)
    assert want.std() > 1e-2  # the parameters move the prediction
    with torch.no_grad():
        np.testing.assert_allclose(tm(tbatch).numpy(), want, atol=1e-5)
    tm.train()
    pred = tm(tbatch)
    torch.nn.functional.binary_cross_entropy(
        pred, torch.from_numpy(y), reduction="sum").backward()
    # each side's kernel entry point, once a layer a forward (the JAX
    # side's two traced in one program)
    assert calls[route] == calls[f"jax {route}"] == 2
    assert sum(calls.values()) == 4
    for n, p in tm.named_parameters():
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(grad.numpy(), jgrads[n].numpy(),
                                   err_msg=n, **GRAD_TOL)
    tables = tm.domain_bank.small if "composite" in name else tm.domain_emb
    assert tables.grad.abs().max() > 0


def test_many_rows_gate_lazy_fit_matches_jax_trainer():
    """One ``lazy`` step of the 56-row gate composite at dropout 0.1: 16
    examples at batch 16 (the composite dispatch tile 16)."""
    jm, params, tm = _models("gate-56-composite")
    x = _request(16, 5, 4)
    y = np.random.default_rng(5).integers(0, 2, 16).astype(np.float32)
    j_steps, j_params, _ = _jax_fit(jm, params, x, y, "lazy")
    steps = tp.port_fit(tm, x, y, "lazy")
    assert len(steps) == 1
    tp.assert_fit_matches(j_steps, j_params, steps, tm)


@pytest.mark.parametrize("name", ["bilinear-300-past-cap",
                                  "gate-300-kernel",
                                  "metanet-300-past-cap"])
def test_route_past_the_cap_matches_jax(name, monkeypatch):
    """Past the JAX cap (a bilinear map with rows x d > 4096, a metanet
    with rows x its widest hidden layer > 4096) both sides take the XLA
    layer, in inference and in training at dropout 0.1 with one key (its
    ``jax.random.bernoulli`` masks); the gate on the same rows takes the
    kernel route on both."""
    route = CASES[name][3]
    jm, params, tm = _models(name)
    assert tm.metanet_kernel == (route == "metanet")
    assert tm.simple_kernel == (route == "simple")
    jbatch, tbatch = _batches(jm, B, 2, name)
    calls = _spy(monkeypatch)
    fn = jax.jit(lambda p, k: (jm.apply(p, {}, jbatch)[0], jm.apply(
        p, {}, jbatch, train=True, rng=k)[0]))
    jparams = jax.tree.map(jnp.asarray, params)
    key = jax.random.PRNGKey(6)
    want, want_train = (np.asarray(a) for a in fn.lower(jparams, key)
                        .compile(compiler_options=FAST)(jparams, key))
    with torch.no_grad():
        got = tm(tbatch)
        tm.train()
        got_train = tm(tbatch, key=threefry.PRNGKey(6))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got_train.numpy(), want_train, atol=1e-5)
    assert np.abs(want_train - want).max() > 1e-3
    if route == "xla":
        assert sum(calls.values()) == 0, calls
    else:
        assert calls[route] == calls[f"jax {route}"] == 2


@pytest.mark.parametrize("argv,route", [
    (["--domain_col", "301-122", "--flag", "gate"], "simple"),
    (["--domain_col", "301-122", "--flag", "bilinear"], "simple"),
    (["--domain_col", "121", "--flag", "gate"], "simple"),
    (["--embedding_dim", "64", "--att_head_num", "8", "--domain_col",
      "122"], "metanet")], ids=["301-122-gate", "301-122-bilinear",
                                "121-gate", "d64h8-122-metanet"])
def test_cli_trains_many_row_configurations(argv, route, tmp_path,
                                            monkeypatch):
    """``cli.main`` builds and trains the reference CLI's many-row
    configurations on the layers' kernel route (their plain versions on
    the CPU), no new flag: AliCCP's 19 fields with their real scenario
    columns (301: 4 ids, 121: 98, 122: 14) and small vocabularies for the
    rest, 64 training rows at batch 16, one layer; the scenario ids drawn
    from 1 to 3, so that each domain's test AUC is defined."""
    from satrans_torch.cli import main as tcli
    from satrans_torch.data import aliccp
    scenario = ("121", "122", "301")
    data_max = {f: aliccp.DATA_MAX[f] if f in scenario else 40
                for f in aliccp.SPARSE_FEATURES}

    def load(args, flag, domain_col):
        rng = np.random.default_rng(0)

        def split(n):
            cols = {f: rng.integers(1, 4 if f in scenario else m + 1, n)
                    for f, m in data_max.items()}
            cols["click"] = rng.integers(0, 2, n)
            return cols
        return (split(64), split(48), "click", list(aliccp.SPARSE_FEATURES),
                [], [], dict(data_max), 3, {})

    monkeypatch.setattr(tcli, "load_dataset", load)
    calls = _spy(monkeypatch)
    auc = tcli.main(["--data_name", "alicpp", "--batch_size", "16",
                     "--domain_att_layer_num", "1", "--results_dir",
                     str(tmp_path), *argv], device="cpu")
    assert 0.0 <= auc <= 1.0
    # 4 training steps and the evaluation's forwards, the kernel route's
    # entry point alone
    assert calls[route] >= 4 and sum(calls.values()) == calls[route], calls
