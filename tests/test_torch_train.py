"""The port's dense training step, predict, evaluate and metrics against the
JAX package.

Three ``Trainer.fit`` steps of each package (batch 16 over 40 examples, so
the third batch is a padded tail) start from the same parameters; the
per-step data loss and reg loss must agree at rtol 1e-5, and every
parameter after the steps at atol 5e-5 / rtol 1e-3, the tolerance
tests/test_e2e_oracle.py states for Adam's sign-like first step (an
update of about lr * g / |g| amplifies float32 round-off in small
gradients).  The JAX side runs once on its XLA layers and once through its
Pallas layer kernels in interpret mode with the recompute backward.
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
from satrans_torch.train import Trainer as TorchTrainer
from satrans_torch.train import callbacks as tcallbacks
from satrans_torch.train import losses as tlosses
from satrans_torch.train import metrics as tmetrics
from satrans_tpu.ops.pallas import meta_block as jmb
from satrans_tpu.train import Trainer as JaxTrainer
from satrans_tpu.train import callbacks as jcallbacks
from satrans_tpu.train import losses as jlosses
from satrans_tpu.train import metrics as jmetrics

LR = 0.01
BATCH, N = 16, 40


def _models(mode="QK"):
    """JAX model, numpy params and the port's model holding them (the
    bank's pad rows included)."""
    return tp.jax_and_port(mode)


def _data(n=N, seed=5):
    x = tp.request(n, seed=seed)
    y = np.random.default_rng(seed).integers(0, 2, n).astype(np.float32)
    return x, y


def _jax_fit(jm, params, x, y):
    """Three steps of the JAX Trainer (bank_update='dense') from
    ``params``; returns (per-step stats, final params, history)."""
    tr = JaxTrainer(jm, seed=7)
    tr.compile(learning_rate=LR, bank_update="dense")
    tr.params = jax.tree.map(lambda a: jnp.array(np.asarray(a)), params)
    tr.state = {}
    tr.opt_state = tr.optimizer.init(tr.params)
    tr._bank_mode = "dense"
    recorded = []
    build = tr._build_steps

    def build_and_record():
        build()
        step = tr._train_step

        def record(*args):
            out = step(*args)
            recorded.append({k: float(v) for k, v in
                             jax.device_get(out[3]).items()})
            return out

        tr._train_step = record

    tr._build_steps = build_and_record
    hist = tr.fit(x, y, batch_size=BATCH, epochs=1, verbose=0)
    return recorded, jax.tree.map(np.asarray, tr.params), hist.history


def _port_fit(tm, x, y):
    tr = TorchTrainer(tm, seed=7, device="cpu")
    tr.compile(learning_rate=LR, bank_update="dense")
    recorded = []
    step = tr.train_step

    def record(*args):
        out = step(*args)
        recorded.append({k: float(v) for k, v in out.items()})
        return out

    tr.train_step = record
    hist = tr.fit(x, y, batch_size=BATCH, epochs=1, verbose=0)
    return recorded, hist.history


def _compare(jax_run, port_run, tm):
    (j_steps, j_params, j_hist), (t_steps, t_hist) = jax_run, port_run
    assert len(j_steps) == len(t_steps) == 3
    for js, ts in zip(j_steps, t_steps):
        assert js["count"] == ts["count"]
        np.testing.assert_allclose(ts["loss"], js["loss"], rtol=1e-5)
        np.testing.assert_allclose(ts["reg_loss"], js["reg_loss"], rtol=1e-5)
    assert [s["count"] for s in t_steps] == [16, 16, 8]
    np.testing.assert_allclose(t_hist["loss"], j_hist["loss"], rtol=1e-5)
    want = bridge.from_jax_params(j_params, tm)
    got = tm.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=5e-5,
                                   rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("mode", ["QK", "Query"])
def test_fit_matches_jax_trainer_xla(mode):
    jm, params, tm = _models(mode)
    x, y = _data()
    start = {k: v.clone() for k, v in tm.state_dict().items()}
    _compare(_jax_fit(jm, params, x, y), _port_fit(tm, x, y), tm)
    # the steps moved every parameter that gets a gradient
    moved = [k for k, v in tm.state_dict().items()
             if not torch.equal(v, start[k])]
    assert "emb.bank" in moved and "layers.1.wq" in moved


def test_fit_matches_jax_trainer_pallas_recompute(monkeypatch):
    monkeypatch.setenv("SATRANS_BWD", "recompute")
    calls = []
    vjp = jmb.fused_meta_layer_vjp
    monkeypatch.setattr(jmb, "fused_meta_layer_vjp",
                        lambda *a, **k: calls.append(1) or vjp(*a, **k))
    jm, params, tm = _models("QK")
    jm = dataclasses.replace(jm, use_fused_kernel=True, fused_interpret=True)
    x, y = _data()
    _compare(_jax_fit(jm, params, x, y), _port_fit(tm, x, y), tm)
    assert calls  # the JAX steps went through the Pallas layer


def test_scan_steps_runs_the_same_single_steps():
    """``scan_steps > 1`` (one XLA program of several steps in the JAX
    package) runs the same single steps in sequence."""
    x, y = _data()
    states = []
    for scan in (1, 3):
        _, _, tm = _models("QK")
        tr = TorchTrainer(tm, seed=7, device="cpu")
        tr.compile(learning_rate=LR)
        hist = tr.fit(x, y, batch_size=BATCH, verbose=0, scan_steps=scan)
        states.append((hist.history["loss"], tm.state_dict()))
    # the same tolerances as against the JAX Trainer: the CPU's parallel
    # embedding-gradient sums need not repeat their order from run to run
    np.testing.assert_allclose(states[1][0], states[0][0], rtol=1e-5)
    for name, v in states[0][1].items():
        np.testing.assert_allclose(states[1][1][name].numpy(), v.numpy(),
                                   atol=5e-5, rtol=1e-3, err_msg=name)


def _jax_scan_seeds(seed, steps, k, layers):
    """The per-layer seeds of each step of the JAX ``fit(scan_steps=k)``
    over ``steps`` full batches and one tail, along
    satrans_tpu/train/trainer.py:629-658: each run of k full batches splits
    the step key once and gives step j ``split(sub, k)[j]``; the rest are
    single steps."""
    def layer_seeds(key):
        return [int(jax.random.randint(jax.random.fold_in(key, i), (), 0,
                                       2 ** 31 - 1, jnp.int32))
                for i in range(layers)]

    key, out, step = jax.random.PRNGKey(seed + 1), [], 0
    while step < steps + 1:
        run = min(k, steps + 1 - step)
        key, sub = jax.random.split(key)
        if run > 1 and step + run <= steps:
            out += [layer_seeds(s) for s in jax.random.split(sub, run)]
            step += run
        else:
            out.append(layer_seeds(sub))
            step += 1
    return out


def test_scan_steps_draws_the_jax_trainers_seeds():
    """``fit(scan_steps=3)`` over 3 full batches and a tail: the first three
    steps take their seeds from one split of the step key, the tail from
    the next, as the JAX Trainer's program of 3 steps and its single step
    do; ``scan_steps=1`` keeps one split a step."""
    _, _, tm = _models("QK")
    x, y = _data(3 * BATCH + 8)
    for scan in (3, 1):
        tr = TorchTrainer(tm, seed=7, device="cpu")
        tr.compile(learning_rate=LR)
        seeds, step = [], tr.train_step

        def record(batch, yb, wb, key=None):
            seeds.append(threefry.layer_seeds(key, len(tm.layers)))
            return step(batch, yb, wb, key)

        tr.train_step = record
        tr.fit(x, y, batch_size=BATCH, verbose=0, scan_steps=scan)
        assert seeds == _jax_scan_seeds(7, 3, scan, len(tm.layers)), scan
    assert _jax_scan_seeds(7, 3, 3, 2) != _jax_scan_seeds(7, 3, 1, 2)


def test_scan_steps_at_dropout_matches_jax_trainer():
    """``fit(scan_steps=3)`` at dropout 0.1 over 3 full batches and a tail
    against the JAX Trainer on its fused interpret-mode path (one program
    of 3 steps, then a single step), each side drawing its own seeds: the
    epoch loss at rtol 1e-5 and every parameter at atol 5e-5 / rtol 1e-3,
    the tolerances of the tests above."""
    jm, params, tm = tp.jax_and_port(dropout_rate=0.1)
    jm = dataclasses.replace(jm, use_fused_kernel=True, fused_interpret=True)
    x, y = _data(3 * BATCH + 8)
    jt = JaxTrainer(jm, seed=7)
    jt.compile(learning_rate=LR, bank_update="dense")
    jt.params = jax.tree.map(lambda a: jnp.array(np.asarray(a)), params)
    jt.state = {}
    jt.opt_state = jt.optimizer.init(jt.params)
    j_hist = jt.fit(x, y, batch_size=BATCH, verbose=0, scan_steps=3)
    tt = TorchTrainer(tm, seed=7, device="cpu")
    tt.compile(learning_rate=LR, bank_update="dense")
    t_hist = tt.fit(x, y, batch_size=BATCH, verbose=0, scan_steps=3)
    np.testing.assert_allclose(t_hist.history["loss"],
                               j_hist.history["loss"], rtol=1e-5)
    tp.assert_fit_matches([], jax.tree.map(np.asarray, jt.params), [], tm)


def test_predict_and_evaluate_match_jax_trainer():
    jm, params, tm = _models("QK")
    x, y = _data(37, seed=9)  # 37 = two batches of 16 and a padded tail
    jt = JaxTrainer(jm, seed=0)
    jt.compile(metrics=("binary_crossentropy", "auc"))
    jt.params = jax.tree.map(jnp.asarray, params)
    jt.state = {}
    tt = TorchTrainer(tm, device="cpu")
    tt.compile(metrics=("binary_crossentropy", "auc"))
    want, got = jt.predict(x, batch_size=16), tt.predict(x, batch_size=16)
    assert got.dtype == np.float64 and got.shape == (37,)
    np.testing.assert_allclose(got, want, atol=1e-5)
    ev_j, ev_t = jt.evaluate(x, y, batch_size=16), tt.evaluate(x, y,
                                                               batch_size=16)
    assert set(ev_t) == set(ev_j)
    for k in ev_j:
        np.testing.assert_allclose(ev_t[k], ev_j[k], rtol=1e-4, err_msg=k)


def test_metrics_match_jax_package():
    rng = np.random.default_rng(3)
    y = rng.integers(0, 2, 500).astype(np.float32)
    s = np.round(rng.random(500), 2)  # ties exercise the tie averaging
    dom = rng.integers(1, 4, 500)
    for name in ("auc", "binary_crossentropy", "mse", "accuracy"):
        assert tmetrics.get_metric(name)(y, s) == pytest.approx(
            jmetrics.get_metric(name)(y, s), rel=1e-12)
    assert tmetrics.per_domain_auc(y, s, dom) == pytest.approx(
        jmetrics.per_domain_auc(y, s, dom), rel=1e-12)


@pytest.mark.parametrize("name", ["binary_crossentropy", "mse", "mae"])
def test_losses_match_jax_package(name):
    rng = np.random.default_rng(4)
    # probabilities down to 1e-50 exercise the -100 clamp of the log terms
    p = np.concatenate([rng.random(200), [1e-50, 1.0 - 1e-8, 0.0]]
                       ).astype(np.float32)
    y = rng.integers(0, 2, p.size).astype(np.float32)
    got = tlosses.get_loss(name)(torch.from_numpy(p), torch.from_numpy(y))
    want = jlosses.get_loss(name)(jnp.asarray(p), jnp.asarray(y))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_early_stopping_and_history_match_jax_package():
    """The same epoch logs through both packages' callbacks stop training
    at the same epoch and leave the same History."""
    logs = [{"val_auc": v, "loss": 1.0 / (i + 1)}
            for i, v in enumerate([0.60, 0.62, 0.61, 0.615, 0.63, 0.60])]
    stops = []
    for cbs in (tcallbacks, jcallbacks):
        trainer = type("T", (), {"stop_training": False})()
        hist, stop = cbs.History(), cbs.EarlyStopping(patience=1)
        callbacks = cbs.CallbackList([stop, hist])
        callbacks.set_trainer(trainer)
        for epoch, lg in enumerate(logs):
            callbacks.on_epoch_end(epoch, lg)
            if trainer.stop_training:
                break
        stops.append((epoch, hist.history, hist.epoch))
    assert stops[0] == stops[1] and stops[0][0] == 3


@pytest.mark.parametrize("what", ["bank_update"])
def test_unported_options_raise(what):
    jm, params, tm = _models("QK")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tr = TorchTrainer(tm, device="cpu")
        if what == "bank_update":
            tr.compile(bank_update="lazy_stale")
