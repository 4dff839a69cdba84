"""The port's sparse bank updates (``bank_update='fused'``, ``'fused_eq'``
and ``'lazy'``) against the JAX ``Trainer`` in the same mode.

Three ``Trainer.fit`` steps of each package (batch 16 over 40 examples,
the third batch a padded tail whose zero ids are real touches) start from
the same parameters, in two layouts: ``torch_parity.columns`` (a varlen
field, so the sort combine) and ``torch_parity.columns_no_varlen`` (the
equality combine, with physical row 18 shared by ``f0`` and ``f1``).  The
data hold out-of-range ids (-1 in ``f0``, past the bank in ``f1``), which
each mode drops, clips or redirects as the JAX package does.  Per step the
data loss and reg loss agree at rtol 1e-5, and after the steps every
parameter at atol 5e-5 / rtol 1e-3 (the tolerance of
tests/test_torch_train.py: Adam's sign-like first step amplifies float32
round-off in small gradients); in lazy mode the bank state's ``last`` and
``count`` exactly and ``mu`` / ``nu`` at the parameter tolerance.  The
port's ``fused`` also matches its own ``dense`` at that tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parity as tp
from satrans_torch import bridge
from satrans_torch.train import Trainer as TorchTrainer
from satrans_tpu.train import Trainer as JaxTrainer
from satrans_tpu.train import bank_optimizer as jbo

LR, L2 = 0.01, 0.01
BATCH, N = 16, 40
TOL = dict(atol=5e-5, rtol=1e-3)
LAYOUTS = {"varlen": tp.columns, "no_varlen": tp.columns_no_varlen}


def _data(out_of_range=True, seed=5):
    x = tp.request(N, seed=seed)
    if out_of_range:
        x["f0"][[2, 30]] = -1
        x["f1"][11] = 100_000
    y = np.random.default_rng(seed).integers(0, 2, N).astype(np.float32)
    return x, y


def _models(layout):
    return tp.jax_and_port(cols=LAYOUTS[layout], l2_reg_embedding=L2)


def _jax_fit(jm, params, x, y, mode, lr=LR):
    """One epoch of the JAX Trainer in ``mode`` at learning rate ``lr``
    from ``params``; returns (per-step stats, final params, final optimizer
    state)."""
    tr = JaxTrainer(jm, seed=7)
    tr.compile(learning_rate=lr, bank_update=mode)
    tr.params = jax.tree.map(lambda a: jnp.array(np.asarray(a)), params)
    tr.state = {}
    tr._bank_mode = mode
    tr.opt_state = (jbo.lazy_init(tr.optimizer, tr.params) if mode == "lazy"
                    else tr.optimizer.init(tr.params))
    recorded = []
    build = tr._build_steps

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


def _port_fit(tm, x, y, mode):
    tr = TorchTrainer(tm, seed=7, device="cpu")
    tr.compile(learning_rate=LR, bank_update=mode)
    recorded = []
    step = tr.train_step

    def record(*args):
        out = step(*args)
        recorded.append({k: float(v) for k, v in out.items()})
        return out

    tr.train_step = record
    tr.fit(x, y, batch_size=BATCH, epochs=1, verbose=0)
    return recorded, tr


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("mode", ["fused", "fused_eq", "lazy"])
def test_sparse_mode_matches_jax_trainer(mode, layout):
    jm, params, tm = _models(layout)
    x, y = _data()
    j_steps, j_params, j_opt = _jax_fit(jm, params, x, y, mode)
    t_steps, tr = _port_fit(tm, x, y, mode)
    assert tr._bank_mode == mode
    assert (tr._eq_plan is not None) == (layout == "no_varlen"
                                         and mode != "fused")
    assert len(j_steps) == len(t_steps) == 3
    for js, ts in zip(j_steps, t_steps):
        assert js["count"] == ts["count"]
        np.testing.assert_allclose(ts["loss"], js["loss"], rtol=1e-5)
        np.testing.assert_allclose(ts["reg_loss"], js["reg_loss"],
                                   rtol=1e-5)
    got = tm.state_dict()
    for name, w in bridge.from_jax_params(j_params, tm).items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), **TOL,
                                   err_msg=name)
    if mode == "lazy":
        want, state = j_opt[1], tr._lazy
        assert state["count"] == int(want["count"]) == 3
        np.testing.assert_array_equal(state["last"].numpy(), want["last"])
        assert set(np.unique(want["last"])) == {0, 1, 2, 3}
        for key in ("mu", "nu"):
            np.testing.assert_allclose(state[key].numpy(), want[key], **TOL,
                                       err_msg=key)


def test_lazy_fused_tail_matches_jax_trainer(monkeypatch):
    """``SATRANS_LAZY_TAIL=fused`` (the one-pass tail, K5's plain version
    here) on the equality combine, against the JAX package's split tail:
    the same update up to float32 rounding."""
    jm, params, tm = _models("no_varlen")
    x, y = _data()
    _, j_params, j_opt = _jax_fit(jm, params, x, y, "lazy")
    # set after the JAX steps were traced: the selector is the port's here
    monkeypatch.setenv("SATRANS_LAZY_TAIL", "fused")
    _, tr = _port_fit(tm, x, y, "lazy")
    got = tm.state_dict()
    for name, w in bridge.from_jax_params(j_params, tm).items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), **TOL,
                                   err_msg=name)
    np.testing.assert_array_equal(tr._lazy["last"].numpy(), j_opt[1]["last"])


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_fused_matches_port_dense(layout):
    """In-range ids: ``fused`` and ``fused_eq`` give ``dense``'s steps."""
    x, y = _data(out_of_range=False)
    runs = {}
    for mode in ("dense", "fused", "fused_eq"):
        _, _, tm = _models(layout)
        steps, _ = _port_fit(tm, x, y, mode)
        runs[mode] = (steps, tm.state_dict())
    for mode in ("fused", "fused_eq"):
        for ds, fs in zip(runs["dense"][0], runs[mode][0]):
            for k in ("loss", "reg_loss"):
                np.testing.assert_allclose(fs[k], ds[k], rtol=1e-5)
        for name, w in runs["dense"][1].items():
            np.testing.assert_allclose(runs[mode][1][name].numpy(),
                                       w.numpy(), **TOL, err_msg=name)
    assert not torch.equal(runs["fused"][1]["emb.bank"],
                           _models(layout)[2].state_dict()["emb.bank"])


def test_auto_resolves_to_dense():
    _, _, tm = _models("varlen")
    tr = TorchTrainer(tm, device="cpu").compile(bank_update="auto")
    assert tr._bank_mode == "dense"
