"""The port's baseline zoo and its dropout against the JAX package.

* ``ops/threefry.bernoulli`` equals ``jax.random.bernoulli`` bit for bit
  (several keys, p in {0.1, 0.5, 0.9}, shapes ``()``, ``[7]``, ``[3, 5,
  8]`` and one of more than 2**16 elements).
* Each layer of ``nn/interactions.py`` (and ``attention``'s interacting
  and self-attention layers) against its JAX twin on the same numpy
  parameters, at rtol 1e-5 / atol 1e-5 (their outputs reach 5).
* Each of the ten zoo models (and the ``metatrans``, ``metanorm``,
  ``usemetatrans`` and AdaSparse ``usetrans`` variants), on the JAX
  model's parameters redrawn N(0, 0.3) with numpy and moved over with
  ``bridge.from_jax_params``: eval predictions against the jitted JAX
  ``apply``, and train-mode predictions at dropout 0.1 with one threefry
  key on both sides (the same masks), at rtol 1e-5 / atol 1e-6; the
  ``reg_loss`` at rtol 1e-5.
* Three ``fit`` steps (batch 16 over 40 examples, the last a padded
  tail, dropout 0.1) against the JAX ``Trainer``: DeepFM in ``dense`` and
  ``lazy``, AutoInt in ``lazy``, AdaSparse in ``dense``; the losses at
  rtol 1e-5 and every parameter at atol 5e-5 / rtol 1e-3
  (tests/test_torch_train.py's tolerances), the lazy state's ``last`` and
  ``count`` exactly; then ``predict``, ``evaluate`` and the ``Predictor``
  on the trained model.
* ``cli.main --model_name DeepFM`` on the synthetic rows against the JAX
  CLI from the same initial parameters: the AUCs within 1e-4.
* AdaSparse in a sparse bank mode raises the JAX package's ValueError.

The layout: two large fields (the bank), the scenario column and a
varlen field at d = 8 (``torch_parity.columns``) and one dense column.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import satrans_torch
import satrans_tpu
import torch_parity as tp
from satrans_torch import bridge
from satrans_torch.models import MODEL_REGISTRY as TORCH_MODELS
from satrans_torch.nn import attention as tattn
from satrans_torch.nn import interactions as tint
from satrans_torch.ops import threefry
from satrans_torch.serving import Predictor
from satrans_torch.train import Trainer as TorchTrainer
from satrans_torch.train import metrics
from satrans_tpu.models import MODEL_REGISTRY as JAX_MODELS
from satrans_tpu.nn import attention as jattn
from satrans_tpu.nn import interactions as jint
from satrans_tpu.train import Trainer as JaxTrainer
from satrans_tpu.train import bank_optimizer as jbo

TOL = dict(rtol=1e-5, atol=1e-6)
# the layers' outputs reach 5 in magnitude (predictions stay in [0, 1])
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(atol=5e-5, rtol=1e-3)
RATE = 0.1
BATCH, N = 16, 40
SMALL = dict(dnn_hidden_units=(16, 8))
META = dict(domain_col="domain", num_domains=3)

# (case, model name, keywords): the ten models at small widths, and the
# flag variants
CASES = [
    ("WDL", "WDL", SMALL),
    ("WDL-metatrans", "WDL", dict(SMALL, flag="metatrans", **META)),
    ("DeepFM", "DeepFM", SMALL),
    ("DeepFM-metatrans-metanorm", "DeepFM",
     dict(SMALL, flag="metatrans_metanorm", **META)),
    ("DCN", "DCN", SMALL),
    ("xDeepFM", "xDeepFM", dict(SMALL, cin_layer_size=(8, 4))),
    ("NFM", "NFM", SMALL),
    ("AFM", "AFM", {}),
    ("PNN", "PNN", dict(SMALL, use_outter=True)),
    ("AutoInt", "AutoInt", dict(SMALL, att_layer_num=2)),
    ("AutoInt-usemetatrans", "AutoInt",
     dict(SMALL, att_layer_num=2, flag="usemetatrans", **META)),
    ("FiBiNET", "FiBiNET", SMALL),
    ("AdaSparse", "AdaSparse", dict(SMALL, **META)),
    ("AdaSparse-usetrans", "AdaSparse", dict(SMALL, flag="usetrans",
                                             **META)),
]
CASE_IDS = [c[0] for c in CASES]
CASE = {c[0]: c[1:] for c in CASES}
# the dropout each model has, set to RATE in train mode
DROPOUTS = {"AFM": ("afm_dropout",), "NFM": ("dnn_dropout", "bi_dropout")}


def _cols(pkg):
    return tp.columns(pkg) + [pkg.features.DenseFeature("price", 1)]


def _request(n, seed=0):
    x = tp.request(n, seed=seed)
    x["price"] = np.random.default_rng(seed + 1).random(n).astype(
        np.float32)
    return x


def _models(case, dropout=0.0):
    """(jax model, numpy params, port model on the CPU with them)."""
    name, kw = CASE[case]
    kw = dict(kw, **{a: dropout for a in DROPOUTS.get(name,
                                                      ("dnn_dropout",))})
    jm = JAX_MODELS[name](layout=satrans_tpu.FeatureLayout(_cols(
        satrans_tpu)), **kw)
    # the shapes of the JAX parameters, each redrawn with numpy
    params = tp.random_params(
        jax.eval_shape(jm.init, jax.random.PRNGKey(3))[0], seed=1)
    tm = TORCH_MODELS[name](satrans_torch.FeatureLayout(_cols(
        satrans_torch)), device="cpu", **kw)
    tm.load_state_dict(bridge.from_jax_params(params, tm))
    return jm, params, tm


# ------------------------------------------------------------- bernoulli

_jax_bernoulli = jax.jit(jax.random.bernoulli, static_argnums=2)


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_bernoulli_matches_jax_bit_for_bit(p):
    for seed in (0, 7, 2 ** 31 - 1, -5):
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
        tk = threefry.fold_in(threefry.PRNGKey(seed), 3)
        assert np.asarray(jk).tolist() == list(tk)
        for shape in ((), (7,), (3, 5, 8), (257, 300)):
            want = np.asarray(_jax_bernoulli(jk, np.float32(p), shape))
            got = threefry.bernoulli(tk, p, shape)
            assert got.dtype == torch.bool and got.shape == want.shape
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=str((seed, shape)))
            if shape == (3, 5, 8):
                np.testing.assert_array_equal(
                    threefry.uniform(tk, shape).numpy(),
                    np.asarray(jax.random.uniform(jk, shape)))


# ---------------------------------------------------------- interactions

B, F, D = 32, 5, 8
JK, TK = jax.random.PRNGKey(4), threefry.PRNGKey(4)
DROP = dict(dropout_rate=RATE, train=True)


def _kind(name):
    return name.split("-")[1]


# name -> (JAX init(key), JAX apply(params, x), port layer(gen), port
# call(layer, x)); a layer without parameters has no init; ``x`` is
# [B, F, D], flattened for the cross network
LAYERS = {
    "fm": (None, lambda p, x: jint.fm(x), None, lambda m, x: tint.fm(x)),
    "bi_interaction_pooling": (
        None, lambda p, x: jint.bi_interaction_pooling(x), None,
        lambda m, x: tint.bi_interaction_pooling(x)),
    "inner_product": (None, lambda p, x: jint.inner_product(x), None,
                      lambda m, x: tint.inner_product(x)),
    **{f"crossnet-{k}": (
        lambda key, k=k: jint.crossnet_init(key, F * D, 3, k),
        lambda p, x, k=k: jint.crossnet_apply(p, x.reshape(B, -1), k),
        lambda g, k=k: tint.CrossNet(g, F * D, 3, k),
        lambda m, x: m(x.reshape(B, -1))) for k in ("vector", "matrix")},
    **{name: (
        lambda key, s=sizes, h=split: jint.cin_init(key, F, s, h),
        lambda p, x, s=sizes, h=split: jint.cin_apply(p, x, s, h),
        lambda g, s=sizes, h=split: tint.CIN(g, F, s, h),
        lambda m, x: m(x))
        for name, sizes, split in (("cin", (6, 4), True),
                                   ("cin-nosplit", (5, 3), False))},
    "senet": (lambda key: jint.senet_init(key, F), jint.senet_apply,
              lambda g: tint.SENET(g, F), lambda m, x: m(x)),
    **{f"bilinear-{k}": (
        lambda key, k=k: jint.bilinear_init(key, F, D, k),
        lambda p, x, k=k: jint.bilinear_apply(p, x, k),
        lambda g, k=k: tint.Bilinear(g, F, D, k), lambda m, x: m(x))
        for k in ("all", "each", "interaction")},
    "afm": (lambda key: jint.afm_init(key, D), jint.afm_apply,
            lambda g: tint.AFMLayer(g, D), lambda m, x: m(x)),
    "afm-dropout": (
        lambda key: jint.afm_init(key, D),
        lambda p, x: jint.afm_apply(p, x, rng=JK, **DROP),
        lambda g: tint.AFMLayer(g, D), lambda m, x: m(x, key=TK, **DROP)),
    **{f"outer-{k}": (
        lambda key, k=k: jint.outer_product_init(key, F, D, k),
        lambda p, x, k=k: jint.outer_product_apply(p, x, k),
        lambda g, k=k: tint.OuterProduct(g, F, D, k), lambda m, x: m(x))
        for k in ("mat", "vec", "num")},
    "interacting": (
        lambda key: jattn.interacting_init(key, D),
        lambda p, x: jattn.interacting_apply(p, x, 2),
        lambda g: tattn.InteractingLayer(g, D), lambda m, x: m(x, 2)),
    "self_attention": (
        lambda key: jattn.self_attention_init(key, D),
        lambda p, x: jattn.self_attention_apply(p, x, 4, train=True, rng=JK),
        lambda g: tattn.SelfAttentionLayer(g, D),
        lambda m, x: m(x, 4, train=True, key=TK)),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_interaction_layer_matches_jax(name):
    """The port's layer holding the JAX layer's parameters (their shapes
    redrawn N(0, 0.3)) against the jitted JAX layer."""
    init_j, apply_j, make_t, call_t = LAYERS[name]
    x = (np.random.default_rng(3).normal(size=(B, F, D)) * 0.5).astype(
        np.float32)
    params, layer = {}, None
    if init_j is not None:
        params = tp.random_params(jax.eval_shape(init_j,
                                                 jax.random.PRNGKey(0)),
                                  seed=2)
        layer = make_t(torch.Generator().manual_seed(0))
        layer.load_state_dict(bridge.from_jax_params(params, layer))
    want = np.asarray(jax.jit(apply_j)(params, x))
    with torch.no_grad():
        got = call_t(layer, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **LAYER_TOL)
    if name.startswith("cin"):
        sizes, split = ((6, 4), True) if name == "cin" else ((5, 3), False)
        assert got.shape[1] == tint.cin_output_dim(sizes, split) == \
            jint.cin_output_dim(sizes, split)


# ---------------------------------------------------------------- models

@functools.lru_cache(maxsize=None)
def _jax_predictions(case):
    """The JAX model's eval and train-mode (dropout 0.1, ``PRNGKey(11)``)
    predictions on the 64 rows of ``_request(64, seed=4)``, in one jitted
    call."""
    jm, params, _ = _models(case, dropout=RATE)
    jb = {k: jnp.asarray(v) for k, v in
          jm.layout.batch_from_dict(_request(64, seed=4)).items()}
    fn = tp.compile_fast(jax.jit(lambda p, b, k: (
        jm.apply(p, {}, b)[0], jm.apply(p, {}, b, train=True, rng=k)[0])))
    return tuple(np.asarray(a) for a in fn(params, jb,
                                           jax.random.PRNGKey(11)))


def _port_batch(tm):
    return {k: torch.from_numpy(v) for k, v in
            tm.layout.batch_from_dict(_request(64, seed=4)).items()}


@pytest.mark.parametrize("case", CASE_IDS)
def test_model_eval_matches_jax(case):
    jm, params, tm = _models(case)
    want = _jax_predictions(case)[0]
    with torch.no_grad():
        got = tm.eval()(_port_batch(tm)).numpy()
    assert got.shape == (64,) and 0.01 < want.std()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(float(tm.reg_loss().detach()),
                               float(jm.reg_loss(params)), rtol=1e-5)


@pytest.mark.parametrize("case", CASE_IDS)
def test_model_train_mode_matches_jax(case):
    """Dropout 0.1 (the DNN's, NFM's pooling's, AFM's attention's; the
    metatrans hook's and AdaSparse's attention layers' at their fixed
    0.1) with one key on both sides."""
    _, _, tm = _models(case, dropout=RATE)
    want = _jax_predictions(case)[1]
    batch = _port_batch(tm)
    with torch.no_grad():
        got = tm.train()(batch, key=threefry.PRNGKey(11)).numpy()
        plain = tm.eval()(batch).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(got - plain).max() > 1e-3  # the dropout moved it


def _jax_fit(jm, params, x, y, mode):
    """Three steps of the JAX Trainer in ``mode`` from ``params``:
    (per-step stats, final params, final optimizer state)."""
    tr = JaxTrainer(jm, seed=7)
    tr.compile(learning_rate=0.01, bank_update=mode)
    tr.params = jax.tree.map(lambda a: jnp.array(np.asarray(a)), params)
    tr.state = {}
    tr._bank_mode = mode
    tr.opt_state = (jbo.lazy_init(tr.optimizer, tr.params) if mode == "lazy"
                    else tr.optimizer.init(tr.params))
    recorded, build = [], tr._build_steps

    def build_and_record():
        build()
        tp.fast_steps(tr)  # compiled without XLA's backend optimizations
        step = tr._train_step

        def record(*args):
            out = step(*args)
            recorded.append({k: float(v) for k, v in
                             jax.device_get(out[3]).items()})
            return out

        tr._train_step = record

    tr._build_steps = build_and_record
    tr.fit(x, y, batch_size=BATCH, epochs=1, verbose=0)
    return (recorded, jax.tree.map(np.asarray, tr.params),
            jax.tree.map(np.asarray, tr.opt_state))


@pytest.mark.parametrize("case,mode", [("DeepFM", "dense"),
                                       ("DeepFM", "lazy"),
                                       ("AutoInt", "lazy"),
                                       ("AdaSparse", "dense")])
def test_fit_matches_jax_trainer(case, mode):
    jm, params, tm = _models(case, dropout=RATE)
    x = _request(N, seed=5)
    y = np.random.default_rng(5).integers(0, 2, N).astype(np.float32)
    j_steps, j_params, j_opt = _jax_fit(jm, params, x, y, mode)
    tr = TorchTrainer(tm, seed=7, device="cpu")
    tr.compile(learning_rate=0.01, bank_update=mode)
    assert tr._bank_mode == mode
    steps, step = [], tr.train_step

    def record(*args):
        stats = step(*args)
        steps.append({k: float(v) for k, v in stats.items()})
        return stats

    tr.train_step = record
    tr.fit(x, y, batch_size=BATCH, epochs=1, verbose=0)
    assert len(steps) == len(j_steps) == 3
    for js, ts in zip(j_steps, steps):
        assert js["count"] == ts["count"]
        for k in ("loss", "reg_loss"):
            np.testing.assert_allclose(ts[k], js[k], rtol=1e-5, err_msg=k)
    got = tm.state_dict()
    for name, w in bridge.from_jax_params(j_params, tm).items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                   **PARAM_TOL, err_msg=name)
    if mode == "lazy":
        want, state = j_opt[1], tr._lazy
        assert state["count"] == int(want["count"]) == 3
        np.testing.assert_array_equal(state["last"].numpy(), want["last"])
    # serving and evaluation take any zoo model
    pred = tr.predict(x, batch_size=BATCH)
    np.testing.assert_array_equal(
        Predictor(tm, batch_size=BATCH, device="cpu")(x), pred)
    assert tr.evaluate(x, y, batch_size=BATCH)["auc"] == \
        metrics.auc(y, pred)


def test_adasparse_in_a_sparse_mode_raises():
    jm, params, tm = _models("AdaSparse")
    jt = JaxTrainer(jm)
    jt.compile(bank_update="lazy")
    jt.params = params
    with pytest.raises(ValueError, match="standard_bank_access") as want:
        jt._resolve_bank_mode()  # what the first fit runs after init
    for mode in ("lazy", "fused", "fused_eq"):
        with pytest.raises(ValueError) as got:
            TorchTrainer(tm, device="cpu").compile(bank_update=mode)
        assert str(got.value) == str(want.value).replace("'lazy'",
                                                         repr(mode))


def test_cli_deepfm_matches_jax(tmp_path, monkeypatch):
    """One CLI run per side, ``--model_name DeepFM`` on 640 synthetic
    rows at batch 128, the port from the JAX run's initial parameters."""
    from satrans_torch.cli import main as tcli
    from satrans_tpu.cli import main as jcli
    jbuild, tbuild = jcli.build_model, tcli.build_model

    def port_build(args, layout, cols, nums, flag, device):
        tm = tbuild(args, layout, cols, nums, flag, device=device)
        jm = jbuild(args, satrans_tpu.FeatureLayout(
            [satrans_tpu.features.SparseFeature(c.name, c.vocab, c.dim)
             for c in layout.sparse]), cols, nums, flag)
        # one compiled init, not its small ops one by one
        params, _ = jax.jit(jm.init)(jax.random.PRNGKey(args.seed))
        tm.load_state_dict(bridge.from_jax_params(
            jax.tree.map(np.asarray, params), tm))
        return tm

    monkeypatch.setattr(tcli, "build_model", port_build)
    tp.fast_trainer_steps(monkeypatch)
    preds = {}
    for side, cli in (("jax", jcli), ("port", tcli)):
        write = cli._write_results

        def record(*args, side=side, write=write):
            preds[side] = args[-1]  # the test predictions
            return write(*args)

        monkeypatch.setattr(cli, "_write_results", record)
    argv = ["--data_name", "synthetic", "--synthetic_rows", "640",
            "--batch_size", "128", "--model_name", "DeepFM"]
    for side, cli in (("jax", jcli), ("port", tcli)):
        kw = {"device": "cpu"} if side == "port" else {}
        cli.main(argv + ["--results_dir", str(tmp_path / side)], **kw)
    test = tcli.load_dataset(tcli.parse_args(argv), "", "domain")[1]
    aucs = {side: [metrics.auc(test["click"], p)] + list(
        metrics.per_domain_auc(test["click"], p, test["domain"]).values())
        for side, p in preds.items()}
    assert preds["port"].shape == preds["jax"].shape == (128,)
    np.testing.assert_allclose(aucs["port"], aucs["jax"], atol=1e-4)
    np.testing.assert_allclose(preds["port"], preds["jax"], atol=1e-4)
