"""The rest of the single-card Trainer against the JAX package, on the CPU.

* Optimizers: three ``fit`` steps (batch 16 over 40 examples, the third a
  padded tail) with ``'sgd'``, ``'adagrad'`` and ``'rmsprop'`` against the
  JAX ``Trainer`` with the same optimizer from the same parameters: each
  step's data and reg loss at rtol 1e-5, every parameter at rtol 2e-4 /
  atol 2e-5.  A custom optimizer factory gives the named one's parameters
  bit for bit; the sparse bank modes with a non-Adam optimizer raise
  ``ValueError``; ``auto`` resolves to ``dense``.
* ``fit_from_iterator``: one epoch through ``Prefetcher(
  ShardedBatchIterator(...).epoch(e))`` with ``seed=trainer.seed`` equals
  one epoch of the port's ``fit`` bit for bit (``dense`` and ``lazy``: the
  parameters and the lazy bank state), and the JAX ``fit_from_iterator``
  on the JAX iterator within the tolerances of
  ``tests/test_torch_bank_train.py`` (atol 5e-5 / rtol 1e-3).
* ``evaluate_domains`` and ``metrics.auc_torch``: against the JAX
  ``evaluate_domains`` and ``auc_jax`` within 1e-6, with ties, a weighted
  subset, a subset of one class (NaN on both) and a domain value absent
  from the data (left out on both).
* ``callbacks.ModelCheckpoint``: the checkpoint written at an epoch's end
  restores into a new trainer bit for bit (parameters, optimizer state,
  predictions) for Adam and for rmsprop; a restore into a trainer compiled
  with another optimizer raises; a ``monitor`` that does not improve
  writes nothing.
* The raw workflow, short: ``bench.raw_e2e`` on 1,600 + 400 raw rows,
  preprocessed by the port, through both packages' CLIs at the golden's
  flags (2 steps of 1024; the JAX model on its interpret-mode kernels so
  that its dropout masks are the port's, the port from the JAX run's
  initial parameters): the test predictions within 1e-4 (the tolerance of
  ``tests/test_torch_cli.py``), the reported AUCs within 1e-4.
"""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import satrans_tpu
import torch_parity as tp
from satrans_torch import bridge
from satrans_torch.bench import raw_e2e
from satrans_torch.cli import main as tcli
from satrans_torch.data import loader as tloader
from satrans_torch.train import Trainer as TorchTrainer
from satrans_torch.train import callbacks as tcallbacks
from satrans_torch.train import checkpoint as tckpt
from satrans_torch.train import metrics as tmetrics
from satrans_torch.train import optimizers as toptim
from satrans_tpu.cli import main as jcli
from satrans_tpu.data import loader as jloader
from satrans_tpu.train import Trainer as JaxTrainer
from satrans_tpu.train import bank_optimizer as jbo
from satrans_tpu.train import metrics as jmetrics

LR = 0.01
BATCH, N = 16, 40
OPT_TOL = dict(atol=2e-5, rtol=2e-4)
TOL = dict(atol=5e-5, rtol=1e-3)


def _models(seed=0):
    """``torch_parity.jax_and_port()``'s models and parameters, the JAX
    parameters drawn at ``jax.eval_shape``'s shapes (the same numbers:
    ``jax_and_port`` redraws every leaf of the JAX init, which is slow
    eager)."""
    import satrans_torch
    from satrans_torch.models import SATrans as TorchSATrans
    from satrans_tpu.models import SATrans

    kw = tp.model_kwargs()
    jm = SATrans(layout=satrans_tpu.FeatureLayout(tp.columns(satrans_tpu)),
                 **kw)
    shapes, _ = jax.eval_shape(jm.init, jax.random.PRNGKey(3))
    params = tp.random_params(shapes, seed)
    tm = TorchSATrans(satrans_torch.FeatureLayout(tp.columns(satrans_torch)),
                      **kw, device="cpu")
    tm.load_state_dict(bridge.from_jax_params(params, tm))
    return jm, params, tm


def _data(n=N, seed=5):
    x = tp.request(n, seed=seed)
    y = np.random.default_rng(seed).integers(0, 2, n).astype(np.float32)
    return x, y


def _jax_trainer(jm, params, mode="dense", optimizer="adam",
                 metrics=("binary_crossentropy", "auc")):
    """The JAX Trainer from ``params`` in ``mode``, its steps compiled
    without XLA's backend optimizations, each step's statistics recorded
    in ``trainer.recorded``."""
    tr = JaxTrainer(jm, seed=7)
    tr.compile(optimizer=optimizer, learning_rate=LR, bank_update=mode,
               metrics=list(metrics))
    tr.params = jax.tree.map(lambda a: jnp.array(np.asarray(a)), params)
    tr.state = {}
    tr._bank_mode = mode
    tr.opt_state = (jbo.lazy_init(tr.optimizer, tr.params) if mode == "lazy"
                    else tr.optimizer.init(tr.params))
    tr.recorded = []
    build = tr._build_steps

    def build_and_record():
        build()
        tp.fast_steps(tr)
        step = tr._train_step

        def record(*args):
            out = step(*args)
            tr.recorded.append({k: float(v) for k, v in
                                jax.device_get(out[3]).items()})
            return out

        tr._train_step = record

    tr._build_steps = build_and_record
    return tr


def _port_trainer(tm, mode="dense", optimizer="adam",
                  metrics=("binary_crossentropy", "auc")):
    tr = TorchTrainer(tm, seed=7, device="cpu")
    tr.compile(optimizer=optimizer, learning_rate=LR, bank_update=mode,
               metrics=list(metrics))
    tr.recorded = []
    step = tr.train_step

    def record(*args):
        out = step(*args)
        tr.recorded.append({k: float(v) for k, v in out.items()})
        return out

    tr.train_step = record
    return tr


# -------------------------------------------------------------- optimizers

@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "rmsprop"])
def test_optimizer_fit_matches_jax_trainer(optimizer):
    jm, params, tm = _models()
    x, y = _data()
    jt = _jax_trainer(jm, params, optimizer=optimizer)
    jt.fit(x, y, batch_size=BATCH, epochs=1, verbose=0)
    tr = _port_trainer(tm, optimizer=optimizer)
    tr.fit(x, y, batch_size=BATCH, epochs=1, verbose=0)
    assert tr._bank_mode == "dense" and len(tr.recorded) == 3
    for js, ts in zip(jt.recorded, tr.recorded):
        assert js["count"] == ts["count"]
        for k in ("loss", "reg_loss"):
            np.testing.assert_allclose(ts[k], js[k], rtol=1e-5, err_msg=k)
    want = bridge.from_jax_params(jax.tree.map(np.asarray, jt.params), tm)
    got = tm.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), **OPT_TOL,
                                   err_msg=name)
    # the optimizer moved the parameters
    assert not np.allclose(got["emb.bank"].numpy(), bridge.from_jax_params(
        params, tm)["emb.bank"].numpy())


def test_custom_optimizer_and_refusals():
    x, y = _data()
    states = []
    for opt in ("rmsprop", lambda ps: toptim.RMSprop(ps, LR)):
        tm = _models()[2]
        tr = TorchTrainer(tm, seed=7, device="cpu").compile(
            optimizer=opt, learning_rate=LR)
        tr.fit(x, y, batch_size=BATCH, verbose=0)
        states.append(tm.state_dict())
    assert tr.optimizer_kind == "custom:RMSprop"
    for name, w in states[0].items():
        assert torch.equal(states[1][name], w), name
    tm = _models()[2]
    for mode in ("fused", "fused_eq", "lazy"):
        with pytest.raises(ValueError, match="adam"):
            TorchTrainer(tm, device="cpu").compile(optimizer="sgd",
                                                   bank_update=mode)
    assert TorchTrainer(tm, device="cpu").compile(
        optimizer="adagrad")._bank_mode == "dense"
    with pytest.raises(ValueError, match="unknown optimizer"):
        TorchTrainer(tm, device="cpu").compile(optimizer="lamb")
    with pytest.raises(TypeError, match="torch.optim.Optimizer"):
        TorchTrainer(tm, device="cpu").compile(optimizer=lambda ps: None)


# ------------------------------------------------------- fit_from_iterator

@pytest.mark.parametrize("mode", ["dense", "lazy"])
def test_fit_from_iterator_matches_fit_and_jax(mode):
    jm, params, tm = _models()
    x, y = _data()
    fitted = _models()[2]
    ref = _port_trainer(fitted, mode)
    ref.fit(x, y, batch_size=BATCH, epochs=1, verbose=0)

    tr = _port_trainer(tm, mode)
    data = tr.layout.batch_from_dict(x)
    it = tloader.ShardedBatchIterator(data, y, BATCH, seed=tr.seed)
    tr.fit_from_iterator(lambda e: tloader.Prefetcher(it.epoch(e)),
                         epochs=1, verbose=0)
    assert [s["count"] for s in tr.recorded] == [16, 16, 8]
    assert tr.recorded == ref.recorded
    for (name, a), b in zip(tm.state_dict().items(),
                            fitted.state_dict().values()):
        assert torch.equal(a, b), name
    if mode == "lazy":
        for k in ("mu", "nu", "last"):
            assert torch.equal(tr._lazy[k], ref._lazy[k]), k
        assert tr._lazy["count"] == ref._lazy["count"] == 3

    jt = _jax_trainer(jm, params, mode)
    jit = jloader.ShardedBatchIterator(jt.layout.batch_from_dict(x), y,
                                       BATCH, seed=jt.seed)
    jt.fit_from_iterator(lambda e: jloader.Prefetcher(jit.epoch(e)),
                         epochs=1, verbose=0)
    tp.assert_fit_matches(jt.recorded, jax.tree.map(np.asarray, jt.params),
                          tr.recorded, tm)


# ------------------------------------------------ evaluate_domains and AUC

def test_auc_torch_matches_auc_jax():
    rng = np.random.default_rng(3)
    y = rng.integers(0, 2, 300).astype(np.float32)
    s = np.round(rng.random(300), 2).astype(np.float32)  # many ties
    w = (rng.random(300) < 0.6).astype(np.float32)
    auc_jax = jax.jit(jmetrics.auc_jax)
    for weight in (None, w, w * y):  # w * y: one class only
        got = float(tmetrics.auc_torch(
            torch.from_numpy(y), torch.from_numpy(s),
            None if weight is None else torch.from_numpy(weight)))
        want = float(auc_jax(jnp.asarray(y), jnp.asarray(s),
                             None if weight is None else jnp.asarray(weight)))
        if weight is not None and weight is not w:
            assert np.isnan(got) and np.isnan(want)
        else:
            np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(
        float(tmetrics.auc_torch(torch.from_numpy(y), torch.from_numpy(s),
                                 torch.from_numpy(w))),
        tmetrics.auc(y[w > 0], s[w > 0]), atol=1e-12)


def test_evaluate_domains_matches_jax():
    jm, params, tm = _models()
    x, y = _data(n=90, seed=8)
    x["domain"][x["domain"] == 2] = 3  # domain value 2 absent
    metrics = ("binary_crossentropy", "auc", "acc")
    jt = _jax_trainer(jm, params, metrics=metrics)
    jt._strategy = jt._resolve_strategy(x)
    jt._build_steps()
    want, want_dom = jt.evaluate_domains(x, y, "domain", batch_size=32)
    tr = _port_trainer(tm, metrics=metrics)
    got, got_dom = tr.evaluate_domains(x, y, "domain", batch_size=32)
    assert sorted(got) == sorted(want) == sorted(metrics)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    assert sorted(got_dom) == sorted(want_dom) == [1, 3]
    for v in want_dom:
        np.testing.assert_allclose(got_dom[v], want_dom[v], atol=1e-6)
    # against the host metrics on predict()'s scores
    pred = tr.predict(x, batch_size=32)
    np.testing.assert_allclose(got["auc"], tmetrics.auc(y, pred), atol=1e-6)
    for v in (1, 3):
        m = x["domain"] == v
        np.testing.assert_allclose(got_dom[v], tmetrics.auc(y[m], pred[m]),
                                   atol=1e-6)
    assert tr.evaluate_domains(x, y, batch_size=32)[1] == {}


# ---------------------------------------------------------- ModelCheckpoint

@pytest.mark.parametrize("optimizer", ["adam", "rmsprop"])
def test_model_checkpoint_round_trip(optimizer, tmp_path):
    x, y = _data()
    tm = _models()[2]
    tr = TorchTrainer(tm, seed=7, device="cpu").compile(
        optimizer=optimizer, learning_rate=LR)
    path = str(tmp_path / "ck" / "best")
    tr.fit(x, y, batch_size=BATCH, verbose=0,
           callbacks=[tcallbacks.ModelCheckpoint(path, monitor="loss",
                                                 mode="min")])
    payload = torch.load(path, weights_only=True)
    assert payload["opt_state"]["optimizer"] == optimizer
    before = tr.predict(x, batch_size=BATCH)

    fresh = _models(seed=9)[2]
    tr2 = TorchTrainer(fresh, seed=7, device="cpu").compile(
        optimizer=optimizer, learning_rate=LR)
    tckpt.restore(path, tr2)
    np.testing.assert_array_equal(tr2.predict(x, batch_size=BATCH), before)
    for (name, a), b in zip(tm.state_dict().items(),
                            fresh.state_dict().values()):
        assert torch.equal(a, b), name
    names = dict(tm.named_parameters())
    names2 = dict(fresh.named_parameters())
    assert len(tr.optimizer.state) == len(names)
    for name, p in names.items():
        st, st2 = tr.optimizer.state[p], tr2.optimizer.state[names2[name]]
        assert st.keys() == st2.keys()
        for k in st:
            assert torch.equal(st[k], st2[k]), (name, k)

    other = TorchTrainer(_models()[2], device="cpu").compile(
        optimizer="sgd" if optimizer == "adam" else "adam")
    with pytest.raises(ValueError, match="optimizer"):
        tckpt.restore(path, other)
    never = str(tmp_path / "never")
    tr2.fit(x, y, batch_size=BATCH, verbose=0, callbacks=[
        tcallbacks.ModelCheckpoint(never, monitor="val_auc")])
    assert not os.path.exists(never)


# ---------------------------------------------------- the raw workflow

def test_raw_workflow_cli_matches_jax(tmp_path, monkeypatch):
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    raw_e2e.preprocess(str(data_dir), n_train=1_600, n_test=400)
    jbuild, tbuild = jcli.build_model, tcli.build_model
    initial = {}

    def jax_build(*a, **k):
        """The JAX model on its interpret-mode kernels, its parameters
        drawn with numpy at ``jax.eval_shape``'s shapes (its eager init
        draws the 6.6 M-row bank for seconds) and kept for the port."""
        jm = dataclasses.replace(jbuild(*a, **k), use_fused_kernel=True,
                                 fused_interpret=True)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))

        def init(key):
            rng = np.random.default_rng(1)
            initial["params"] = jax.tree.map(
                lambda a: rng.standard_normal(a.shape, np.float32) * 0.1,
                shapes[0])
            return (jax.tree.map(jnp.asarray, initial["params"]),
                    jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype),
                                 shapes[1]))

        object.__setattr__(jm, "init", init)
        return jm

    def port_build(args, layout, cols, nums, flag, device):
        """The port's model with the JAX run's initial parameters."""
        tm = tbuild(args, layout, cols, nums, flag, device=device)
        tm.load_state_dict(bridge.from_jax_params(initial["params"], tm))
        return tm

    monkeypatch.setattr(jcli, "build_model", jax_build)
    monkeypatch.setattr(tcli, "build_model", port_build)
    tp.fast_trainer_steps(monkeypatch)
    out = {}
    for side, cli in (("jax", jcli), ("port", tcli)):
        res, ck = tmp_path / f"{side}_res", tmp_path / f"{side}_ck"
        argv = raw_e2e.cli_argv(str(data_dir), str(res))
        argv[argv.index("--flag") + 1] = "sota_dump"
        kw = {"device": "cpu"} if side == "port" else {}
        cli.main(argv + ["--checkpoint_dir", str(ck)], **kw)
        (name,) = [p for p in os.listdir(ck) if p.endswith("_testpred.pkl")]
        with open(ck / name, "rb") as fh:
            pred = pickle.load(fh)
        (line,) = open(res / "alicpp_results.csv").read().splitlines()
        out[side] = pred, [float(v) for v in line.split(",")[1:]]
    (pred_j, row_j), (pred, row) = out["jax"], out["port"]
    assert pred.shape == pred_j.shape == (400,)
    np.testing.assert_allclose(pred, pred_j, atol=1e-4)
    assert len(row) == len(row_j) == 5  # AUC, 3 domains, loss
    np.testing.assert_allclose(row, row_j, atol=1e-4)
