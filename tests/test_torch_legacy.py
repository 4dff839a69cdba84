"""The port's legacy Star-Trans models (Star_Trans, Starv2/v3/v4_Trans)
against the JAX package.

* ``ops/segment.segment_mean`` against numpy, ids outside the segments
  dropped (and their gradient zero), an empty segment's mean 0.
* The twelve configurations of ``tests/test_legacy_models.py::LEGACY``
  (its ``_setup``: 5 sparse fields of 40 ids, d = 8, 2 heads, batch 64
  with 4 zero pad rows, one attention layer and two domain layers), on
  the JAX model's parameters redrawn N(0, 0.3) with numpy and moved over
  with ``bridge.from_jax_params``: in train mode at dropout 0.1 with one
  threefry key on both sides (the same masks) the predictions and the
  aux loss within 1e-5, and the gradient
  of ``sum(c * pred) + aux`` (``c`` drawn from a seed) for every
  parameter within 1e-4 of its largest entry plus 1e-5; the JAX side in
  one jitted call.  Starv2's aux loss counts the real rows of the pad
  mask ``_weight``.
* Three ``fit`` steps of Starv2 (batch 16 over 40 examples, the last a
  padded tail, dropout 0.1) in ``dense`` and ``lazy`` against the JAX
  ``Trainer``: each step's loss, reg loss and aux loss, and the final
  parameters, within 1e-4; then (in ``lazy``) ``predict``, ``Predictor``
  and the ``Predictor`` of ``serving.load`` on its checkpoint agree, and
  match the JAX Trainer's ``predict``.
* ``cli.build_model`` builds the four names with the JAX CLI's parameter
  shapes; one ``cli.main --model_name Starv2_Trans`` run on each side
  (the port from the JAX run's initial parameters): ``_testpred.pkl``
  within 1e-4, the CSV rows' configs equal and their numbers within 1e-4.
"""

import functools
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import satrans_torch
import satrans_tpu
import torch_parity as tp
from satrans_torch import bridge, serving
from satrans_torch import models as tmodels
from satrans_torch.cli import main as tcli
from satrans_torch.data.synthetic import synthetic_columns
from satrans_torch.ops import segment as tsegment
from satrans_torch.ops import threefry
from satrans_torch.train import Trainer as TorchTrainer
from satrans_tpu.cli import main as jcli
from satrans_tpu.models import Starv2Trans as JaxStarv2
from satrans_tpu.train import Trainer as JaxTrainer
from satrans_tpu.train import bank_optimizer as jbo
from test_legacy_models import LEGACY, _setup

TOL = dict(rtol=1e-5, atol=1e-5)
FIT_TOL = dict(rtol=1e-4, atol=1e-4)
PADS = 4
BATCH, N = 16, 40
LEGACY_IDS = [c[0] for c in LEGACY]
CASE = {c[0]: c[1:] for c in LEGACY}
MODEL_KW = dict(domain_col="domain", num_domains=3, att_layer_num=1,
                domain_att_layer_num=2)


def test_segment_mean_matches_numpy():
    """Ids 1..3 and, dropped, -1 and 5, over 4 segments (segment 0
    empty); the dropped rows get no gradient."""
    rng = np.random.default_rng(3)
    data = rng.normal(size=(9, 3)).astype(np.float32)
    ids = np.array([1, 2, 1, 3, -1, 2, 5, 1, 3])
    t = torch.from_numpy(data).requires_grad_(True)
    got = tsegment.segment_mean(t, torch.from_numpy(ids), 4)
    for s in range(4):
        rows = data[ids == s]
        want = rows.mean(0) if len(rows) else np.zeros(3, np.float32)
        np.testing.assert_allclose(got[s].detach().numpy(), want, rtol=1e-6)
    got.sum().backward()
    dropped = (ids < 0) | (ids >= 4)
    assert not t.grad[torch.from_numpy(dropped)].any()
    assert t.grad[torch.from_numpy(~dropped)].all()


def _port_layout():
    return satrans_torch.FeatureLayout(synthetic_columns(
        num_sparse=5, vocab=40, dim=8, num_domains=3))


@functools.lru_cache(maxsize=None)
def _case(case):
    """(jax model, numpy params, x with PADS zero rows, the pad mask,
    the loss weights ``c``, the JAX outputs): at ``PRNGKey(11)`` the train
    predictions, aux and the gradient of ``sum(c * pred) + aux``, in one
    jitted call."""
    cls, kw = CASE[case]
    layout, _, x, _ = _setup()
    jm = cls(layout=layout, **MODEL_KW, **kw)
    p_shape, _ = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    params = tp.random_params(p_shape, seed=1)
    x = {k: v.copy() for k, v in x.items()}
    for v in x.values():
        v[-PADS:] = 0
    weight = (np.arange(64) < 64 - PADS).astype(np.float32)
    c = np.random.default_rng(2).uniform(0.5, 1.5, 64).astype(np.float32)
    batch = {k: jnp.asarray(v) for k, v in layout.batch_from_dict(x).items()}

    def loss(p, b, key):
        pred, _, aux = jm.apply(p, {}, b, train=True, rng=key)
        return jnp.sum(pred * c) + aux, (pred, aux)

    def run(p, b, key):
        (_, (pred, aux)), grads = jax.value_and_grad(loss, has_aux=True)(
            p, dict(b, _weight=weight), key)
        return pred, aux, grads

    args = (params, batch, jax.random.PRNGKey(11))
    fn = jax.jit(run).lower(*args).compile(compiler_options=tp.FAST)
    return jm, params, x, weight, c, jax.tree.map(np.asarray, fn(*args))


def _port_model(case, params):
    cls, kw = CASE[case]
    tm = getattr(tmodels, cls.__name__)(_port_layout(), device="cpu",
                                        **MODEL_KW, **kw)
    tm.load_state_dict(bridge.from_jax_params(params, tm))
    return tm


@pytest.mark.parametrize("case", LEGACY_IDS)
def test_legacy_model_matches_jax(case):
    """Train predictions, aux and every gradient at dropout 0.1 with one
    key."""
    jm, params, x, weight, c, (want_pred, want_aux, want_grads) = \
        _case(case)
    tm = _port_model(case, params)
    assert tm.active_fields == jm.active_fields
    assert tm.head_in == jm.head_in
    batch = {k: torch.from_numpy(v) for k, v in
             tm.layout.batch_from_dict(x).items()}
    tm.train()
    pred, aux = tm(dict(batch, _weight=torch.from_numpy(weight)),
                   key=threefry.PRNGKey(11), return_aux=True)
    np.testing.assert_allclose(pred.detach().numpy(), want_pred, **TOL)
    np.testing.assert_allclose(float(aux.detach()), float(want_aux), **TOL)
    assert want_pred[:-PADS].std() > 1e-3
    assert (float(want_aux) > 0) == (case.startswith("Starv2"))
    (torch.sum(pred * torch.from_numpy(c)) + aux).backward()
    grads = {n: p.grad for n, p in tm.named_parameters()}
    for name, want in bridge.from_jax_params(want_grads, tm).items():
        got = grads[name]
        got = torch.zeros_like(want) if got is None else got
        bound = 1e-4 * float(want.abs().max()) + 1e-5
        err = float((got - want).abs().max())
        assert err <= bound, f"{case} {name}: {err} > {bound}"
    assert float(tm.reg_loss().detach()) == pytest.approx(
        float(jm.reg_loss(params)), rel=1e-5)


# ----------------------------------------------------------------- fit

FIT_KW = dict(MODEL_KW, domain_att_layer_num=1)


def _fit_models():
    """Starv2 at dropout 0.1, one domain layer, on ``torch_parity.columns``
    (two large fields, so that ``lazy`` moves bank rows): (jax model,
    numpy params, port model)."""
    jm = JaxStarv2(layout=satrans_tpu.FeatureLayout(
        tp.columns(satrans_tpu)), **FIT_KW)
    p_shape, _ = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    params = tp.random_params(p_shape, seed=4)
    tm = tmodels.Starv2Trans(satrans_torch.FeatureLayout(
        tp.columns(satrans_torch)), device="cpu", **FIT_KW)
    tm.load_state_dict(bridge.from_jax_params(params, tm))
    return jm, params, tm


def _jax_fit(jm, params, x, y, mode):
    """Three steps of the JAX Trainer in ``mode``: (trainer, per-step
    stats)."""
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
        tp.fast_steps(tr)
        step = tr._train_step

        def record(*args):
            out = step(*args)
            recorded.append({k: float(v) for k, v in
                             jax.device_get(out[3]).items()})
            return out

        tr._train_step = record

    tr._build_steps = build_and_record
    tr.fit(x, y, batch_size=BATCH, epochs=1, verbose=0)
    return tr, recorded


@pytest.mark.parametrize("mode", ["dense", "lazy"])
def test_starv2_fit_matches_jax_trainer(mode, tmp_path):
    """Three steps, the last on a tail of 8 real rows: the aux loss
    enters the step and counts the real rows; then (in ``lazy``)
    serving."""
    jm, params, tm = _fit_models()
    x = tp.request(N, seed=5)
    y = np.random.default_rng(5).integers(0, 2, N).astype(np.float32)
    jt, j_steps = _jax_fit(jm, params, x, y, mode)
    steps = tp.port_fit(tm, x, y, mode, batch_size=BATCH)
    assert len(steps) == len(j_steps) == 3
    assert [s["count"] for s in steps] == [16, 16, 8]
    for js, ts in zip(j_steps, steps):
        assert ts["aux_loss"] > 0
        for k in ("loss", "reg_loss", "aux_loss"):
            np.testing.assert_allclose(ts[k], js[k], **FIT_TOL, err_msg=k)
    got = tm.state_dict()
    for name, w in bridge.from_jax_params(
            jax.tree.map(np.asarray, jt.params), tm).items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), **FIT_TOL,
                                   err_msg=name)
    assert tm.domain_id_offset == jm.domain_id_offset == 1
    if mode != "lazy":
        return
    tr = TorchTrainer(tm, device="cpu")
    tr.compile(bank_update=mode)
    pred = tr.predict(x, batch_size=BATCH)
    np.testing.assert_allclose(pred, jt.predict(x, batch_size=BATCH),
                               atol=1e-5)
    np.testing.assert_array_equal(
        serving.Predictor(tm, batch_size=BATCH, device="cpu")(x), pred)
    path = str(tmp_path / "starv2")
    serving.save(path, tr)
    fresh = tmodels.Starv2Trans(satrans_torch.FeatureLayout(
        tp.columns(satrans_torch)), device="cpu", **FIT_KW)
    fresh.set_domain_offset(3)
    loaded = serving.load(path, fresh, batch_size=BATCH, device="cpu")
    assert fresh.domain_id_offset == 1
    np.testing.assert_array_equal(loaded(x), pred)


# ----------------------------------------------------------------- cli

@pytest.mark.parametrize("name", tcli.LEGACY_MODELS)
def test_build_model_matches_jax_cli(name):
    """The CLI's model of each name (``--merge sum``, 2 query bases,
    ``--meta_mode QK``, one attention layer of type 'trans'): the JAX
    CLI's parameter shapes and configuration."""
    argv = ["--model_name", name, "--embedding_dim", "8", "--merge", "sum",
            "--num_query_bases", "2", "--meta_mode", "QK",
            "--att_layer_num", "1", "--att_layer_type", "trans",
            "--att_head_num", "2", "--domain_att_layer_num", "2"]
    args = tcli.parse_args(argv)
    cols = tp.columns(satrans_tpu)[:3]
    jm = jcli.build_model(args, satrans_tpu.FeatureLayout(cols), ["domain"],
                          [3], "None")
    tm = tcli.build_model(args, satrans_torch.FeatureLayout(
        tp.columns(satrans_torch)[:3]), ["domain"], [3], "None",
        device="cpu")
    for attr in ("domain_col", "num_domains", "att_layer_num",
                 "domain_att_layer_num", "att_head_num", "att_layer_type",
                 "flag", "active_fields", "head_in"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    for attr in ("merge", "num_query_bases", "attn_batch_reg",
                 "share_domain_dnn_across_layers", "meta_mode"):
        assert getattr(tm, attr, None) == getattr(jm, attr, None), attr
    p, _ = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tm.load_state_dict(bridge.from_jax_params(tp.random_params(p), tm))


def test_cli_starv2_matches_jax(tmp_path, monkeypatch):
    """One CLI run a side, ``--model_name Starv2_Trans --flag dump`` on
    640 synthetic rows at batch 128, d = 8, 2 heads, one domain layer;
    both from one set of initial parameters: the JAX model's ``init``
    (op by op it takes seconds) gives its parameter shapes redrawn with
    numpy (``torch_parity.random_params``).  The JAX run's orbax
    checkpoint is not written: the test predictions are compared."""
    from satrans_tpu.train import checkpoint as jckpt
    jbuild, tbuild = jcli.build_model, tcli.build_model
    drawn = []

    def jax_build(*args, **kw):
        jm = jbuild(*args, **kw)
        p_shape, _ = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        drawn.append(tp.random_params(p_shape, seed=6, scale=0.1))
        jm.init = lambda key: (jax.tree.map(jnp.asarray, drawn[0]), {})
        return jm

    def port_build(args, layout, cols, nums, flag, device):
        tm = tbuild(args, layout, cols, nums, flag, device=device)
        tm.load_state_dict(bridge.from_jax_params(drawn[0], tm))
        return tm

    tp.fast_trainer_steps(monkeypatch)
    monkeypatch.setattr(jcli, "build_model", jax_build)
    monkeypatch.setattr(tcli, "build_model", port_build)
    monkeypatch.setattr(jckpt, "save", lambda path, trainer: None)
    argv = ["--data_name", "synthetic", "--synthetic_rows", "640",
            "--batch_size", "128", "--model_name", "Starv2_Trans",
            "--embedding_dim", "8", "--att_head_num", "2",
            "--domain_att_layer_num", "1", "--flag", "dump"]
    rows, preds = {}, {}
    config = "Starv2_Trans_8_0.001_1024_domain_dump"
    for side, cli in (("jax", jcli), ("port", tcli)):
        res, ck = tmp_path / f"{side}_res", tmp_path / f"{side}_ck"
        kw = {"device": "cpu"} if side == "port" else {}
        ck.mkdir()
        cli.main(argv + ["--results_dir", str(res), "--checkpoint_dir",
                         str(ck)], **kw)
        preds[side] = pickle.load(open(ck / f"{config}_testpred.pkl", "rb"))
        (line,) = open(res / "synthetic_results.csv").read().splitlines()
        head, *fields = line.split(",")
        assert head[len("mm-dd-HH-MM-"):] == config
        rows[side] = [float(v) for v in fields]
    assert preds["port"].shape == preds["jax"].shape == (128,)
    np.testing.assert_allclose(preds["port"], preds["jax"], atol=1e-4)
    assert len(rows["port"]) == len(rows["jax"]) == 5  # AUC, 3 domains, loss
    np.testing.assert_allclose(rows["port"], rows["jax"], atol=1e-4)
