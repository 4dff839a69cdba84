"""The port's STAR and multi-task models, their engine (model state,
domain routing, the learned offset) against the JAX package.

* ``nn/core.batch_norm_apply`` against ``core.batch_norm_apply`` (train,
  train with a 0/1 weight that leaves out a pad row, train with a weight
  of no row, eval) at rtol 1e-5 / atol 1e-6, the new state too.
* STAR (plain, ``usetrans``, without domain BatchNorm, without domain
  DNN), SharedBottom (plain, ``usetrans``), MMOE, PLE and ESMM on the
  JAX model's parameters (and STAR's BatchNorm state) redrawn with
  numpy: eval and train-mode predictions at dropout 0.1 with one
  threefry key on both sides against the jitted JAX ``apply``, on a batch
  with pad rows, at rtol 1e-5 / atol 1e-6; the state after the train-mode
  forward at the same tolerance; an eval forward leaves it as it is.
  STAR's absent domain keeps its statistics (its ``count`` still rises).
* ``DomainRouted.loss`` / ``route`` and ``losses.masked_multitask_bce_sum``
  against the JAX ones.
* Three ``fit`` steps (batch 16 over 40 examples, the last a padded tail,
  dropout 0.1) against the JAX ``Trainer``: STAR in ``dense`` and
  ``lazy``, MMOE in ``lazy``; the losses at rtol 1e-5, every parameter
  and BatchNorm statistic at atol 5e-5 / rtol 1e-3
  (tests/test_torch_train.py's tolerances), ``count`` exactly.  Then:
  STAR's ``lazy`` checkpoint restores and resumes bit for bit, and its
  statistics move once a step under ``scan_steps`` with validation inside
  the epoch and never in ``evaluate``; MMOE's
  offset is learned at ``fit`` (ids 2..4) and re-learned at ``predict``
  (ids 1..3) as the JAX Trainer's, its routed ``predict``, ``evaluate``,
  ``Predictor`` and the ``Predictor`` of ``serving.load`` on its
  checkpoint agree, and the JAX ``Predictor``'s routed scores match.
* ``cli.build_model`` builds the five models with the JAX CLI's shapes,
  ESMM at 3 domains raises the JAX CLI's ValueError, and ``cli.main
  --model_name Star_Net`` and ``MMOE`` run on synthetic rows.

The layout: ``torch_parity.columns`` at d = 8 (two large fields, the
scenario column ``domain`` of 3 domains, a varlen field).
"""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import satrans_torch
import satrans_tpu
import torch_parity as tp
from satrans_torch import bridge, serving
from satrans_torch.cli import main as tcli
from satrans_torch.models import MODEL_REGISTRY as TORCH_MODELS
from satrans_torch.nn import core as tcore
from satrans_torch.ops import threefry
from satrans_torch.train import DomainRouted, Trainer as TorchTrainer
from satrans_torch.train import checkpoint, losses as tlosses, metrics
from satrans_tpu.cli import main as jcli
from satrans_tpu.models import MODEL_REGISTRY as JAX_MODELS
from satrans_tpu.nn import core as jcore
from satrans_tpu.serving import Predictor as JaxPredictor
from satrans_tpu.train import Trainer as JaxTrainer
from satrans_tpu.train import bank_optimizer as jbo
from satrans_tpu.train import losses as jlosses
from satrans_tpu.train import trainer as jtrainer

TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(atol=5e-5, rtol=1e-3)
RATE = 0.1
BATCH, N = 16, 40
DOM = dict(domain_col="domain")
STAR = dict(DOM, num_domains=3, dnn_hidden_units=(16, 8))
MTL = dict(DOM, num_tasks=3)
EXPERTS = dict(MTL, expert_dnn_hidden_units=(16, 8),
               gate_dnn_hidden_units=(4,), tower_dnn_hidden_units=(4,))
BOTTOM = dict(MTL, bottom_dnn_hidden_units=(16, 8),
              tower_dnn_hidden_units=(4,))

# (case, model name, keywords)
CASES = [
    ("STAR", "Star_Net", STAR),
    ("STAR-usetrans", "Star_Net", dict(STAR, flag="usetrans",
                                       att_layer_num=2)),
    ("STAR-nodomainbn", "Star_Net", dict(STAR, use_domain_bn=False)),
    ("STAR-nodomaindnn", "Star_Net", dict(STAR, use_domain_dnn=False)),
    ("SharedBottom", "SharedBottom", BOTTOM),
    ("SharedBottom-usetrans", "SharedBottom", dict(BOTTOM, flag="usetrans",
                                                   att_layer_num=2)),
    ("MMOE", "MMOE", EXPERTS),
    ("PLE", "PLE", EXPERTS),
    ("ESMM", "ESMM", dict(DOM, num_tasks=2,
                          tower_dnn_hidden_units=(16, 8))),
]
CASE_IDS = [c[0] for c in CASES]
CASE = {c[0]: c[1:] for c in CASES}
PADS = 6  # the pad rows at the end of the model tests' batch


def _layout(pkg):
    return pkg.FeatureLayout(tp.columns(pkg))


def _random_state(state, seed=2):
    """The JAX state's BatchNorm statistics redrawn: mean N(0, 0.3), var
    in [0.5, 1.5), count 2."""
    rng = np.random.default_rng(seed)
    return {"bn": [{"mean": (rng.normal(size=s["mean"].shape) * 0.3
                             ).astype(np.float32),
                    "var": (0.5 + rng.random(s["var"].shape)
                            ).astype(np.float32),
                    "count": np.int32(2)} for s in state["bn"]]} \
        if state else {}


@functools.lru_cache(maxsize=None)
def _jax_model(case, dropout):
    """(jax model, numpy params, numpy state)."""
    name, kw = CASE[case]
    jm = JAX_MODELS[name](layout=_layout(satrans_tpu), dnn_dropout=dropout,
                          **kw)
    p_shape, s_shape = jax.eval_shape(jm.init, jax.random.PRNGKey(3))
    return jm, tp.random_params(p_shape, seed=1), _random_state(s_shape)


def _models(case, dropout=0.0):
    """(a copy of the jax model, numpy params, numpy state, a new port
    model on the CPU with them); the JAX Trainer sets the copy's
    offset."""
    name, kw = CASE[case]
    jm, params, state = _jax_model(case, dropout)
    jm = copy.copy(jm)
    tm = TORCH_MODELS[name](_layout(satrans_torch), device="cpu",
                            dnn_dropout=dropout, **kw)
    tm.load_state_dict(bridge.from_jax_params(params, tm, state))
    return jm, params, state, tm


def _request(n, seed=0, pads=0):
    """``torch_parity.request`` rows, the last ``pads`` of them zero in
    every column, as the Trainer pads a tail batch."""
    x = tp.request(n, seed=seed)
    if pads:
        for v in x.values():
            v[n - pads:] = 0
    return x


def _buffers(tm):
    return {n: b.clone() for n, b in tm.named_buffers()}


def _state_np(tm):
    """The port's buffers as the JAX state pytree."""
    bn = getattr(tm, "bn", None)
    return {"bn": [{k: getattr(m, k).numpy() for k in ("mean", "var",
                                                        "count")}
                   for m in bn]} if bn is not None else {}


def _assert_state(got, want, tol=TOL):
    assert jax.tree.structure(jax.tree.map(np.asarray, got)) == \
        jax.tree.structure(jax.tree.map(np.asarray, want))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w)
        if w.dtype == np.int32:
            assert np.asarray(g).dtype == np.int32
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, **tol)


# ------------------------------------------------------------ batch norm

BN_CASES = {
    "train": dict(train=True),
    "train-weighted": dict(train=True, weight=[1, 0, 1, 1, 0, 1, 1, 0]),
    "train-no-row": dict(train=True, weight=[0] * 8),
    "eval": dict(train=False),
}


@pytest.mark.parametrize("case", list(BN_CASES))
def test_batch_norm_matches_jax(case):
    """The masked BatchNorm against the JAX one, with the affine of MDR-BN
    passed as ``scale`` / ``bias``; a weight of no row keeps ``mean`` and
    ``var`` and still counts the call."""
    kw = BN_CASES[case]
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(8, 5)) * 2 + 1).astype(np.float32)
    scale, bias = (rng.normal(size=(2, 5))).astype(np.float32)
    st = {"mean": rng.normal(size=5).astype(np.float32),
          "var": (0.5 + rng.random(5)).astype(np.float32),
          "count": np.int32(3)}
    w = None if "weight" not in kw else np.asarray(kw["weight"], np.float32)
    want_y, want_st = jax.jit(lambda x, st, w: jcore.batch_norm_apply(
        {"scale": scale, "bias": bias}, st, x, train=kw["train"],
        scale=scale, bias=bias, batch_weight=w))(x, st, w)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in st.items()}
    y, new = tcore.batch_norm_apply(
        torch.from_numpy(x), t, train=kw["train"],
        scale=torch.from_numpy(scale), bias=torch.from_numpy(bias),
        batch_weight=None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(y.numpy(), want_y, **TOL)
    _assert_state({k: v.numpy() for k, v in new.items()}, want_st)
    if case == "train-no-row":
        assert np.array_equal(new["mean"].numpy(), st["mean"])
        assert np.array_equal(new["var"].numpy(), st["var"])
        assert int(new["count"]) == 4
    # the module: a train-mode call moves its buffers once, eval not
    bn = tcore.BatchNorm(5)
    for k, v in t.items():
        getattr(bn, k).copy_(v)
    with torch.no_grad():
        bn(torch.from_numpy(x), torch.from_numpy(scale),
           torch.from_numpy(bias), train=kw["train"],
           batch_weight=None if w is None else torch.from_numpy(w))
    _assert_state({k: getattr(bn, k).numpy() for k in st}, want_st)


def test_one_hot_gives_zero_rows_outside_the_range():
    ids = np.array([-1, 0, 2, 3, 1, 7])
    np.testing.assert_array_equal(
        tcore.one_hot(torch.from_numpy(ids), 3).numpy(),
        np.asarray(jax.nn.one_hot(ids, 3)))


# ---------------------------------------------------------------- models

@functools.lru_cache(maxsize=None)
def _jax_predictions(case):
    """The JAX model's eval predictions, and its train-mode (dropout 0.1,
    ``PRNGKey(11)``) predictions and new state, on ``_request(64, 4,
    PADS)`` in one jitted call."""
    jm, params, state, _ = _models(case, dropout=RATE)
    jb = {k: jnp.asarray(v) for k, v in
          jm.layout.batch_from_dict(_request(64, 4, PADS)).items()}
    args = (params, state, jb, jax.random.PRNGKey(11))
    # compiled without XLA's backend optimizations: a third of the
    # compile time of the dropout's threefry rounds, the same program
    fn = jax.jit(lambda p, s, b, k: (
        jm.apply(p, s, b)[0], *jm.apply(p, s, b, train=True, rng=k)[:2])
    ).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return jax.tree.map(np.asarray, fn(*args))


def _port_batch(tm, x):
    return {k: torch.from_numpy(v) for k, v in
            tm.layout.batch_from_dict(x).items()}


@pytest.mark.parametrize("case", CASE_IDS)
def test_model_matches_jax(case):
    """Eval, then train mode at dropout 0.1 with one key on both sides:
    the predictions, and the state the train-mode forward leaves."""
    jm, params, state, tm = _models(case, dropout=RATE)
    want_eval, want_train, want_state = _jax_predictions(case)
    batch = _port_batch(tm, _request(64, 4, PADS))
    before = _buffers(tm)
    with torch.no_grad():
        got_eval = tm.eval()(batch).numpy()
        for n, b in tm.named_buffers():  # eval reads the state only
            assert torch.equal(b, before[n]), n
        got_train = tm.train()(batch, key=threefry.PRNGKey(11)).numpy()
    tasks = getattr(jm, "num_tasks", 1)
    assert got_eval.shape == want_eval.shape == \
        ((64,) if case.startswith("STAR") else (64, tasks))
    assert 0.01 < want_eval[:-PADS].std()
    np.testing.assert_allclose(got_eval, want_eval, **TOL)
    np.testing.assert_allclose(got_train, want_train, **TOL)
    assert np.abs(got_train - got_eval).max() > 1e-3  # the dropout moved it
    _assert_state(_state_np(tm), want_state)
    np.testing.assert_allclose(float(tm.reg_loss().detach()),
                               float(jm.reg_loss(params)), rtol=1e-5)
    if case in ("STAR", "STAR-nodomainbn"):
        # a pad row enters no domain: its logit is 0
        np.testing.assert_array_equal(got_eval[-PADS:], 0.5)


def test_star_absent_domain_keeps_its_statistics():
    """A train-mode forward with no domain-3 example: domain 3's mean and
    var stay bit for bit, its count rises; the others move."""
    _, _, _, tm = _models("STAR")
    x = _request(32, 6, 4)
    x["domain"][:-4] = np.where(x["domain"][:-4] == 3, 1, x["domain"][:-4])
    before = _buffers(tm)
    with torch.no_grad():
        tm.train()(_port_batch(tm, x))
    for d in range(3):
        for k in ("mean", "var"):
            same = torch.equal(getattr(tm.bn[d], k), before[f"bn.{d}.{k}"])
            assert same == (d == 2), (d, k)
        assert int(tm.bn[d].count) == 3


# ----------------------------------------------------------- the routing

@pytest.mark.parametrize("offset", [1, 2])
def test_domain_routed_matches_jax(offset):
    rng = np.random.default_rng(offset)
    pred = rng.uniform(0.01, 0.99, (24, 3)).astype(np.float32)
    y = rng.integers(0, 2, 24).astype(np.float32)
    dom = rng.integers(0, 5, 24)
    sparse = np.stack([rng.integers(1, 9, 24), dom], 1).astype(np.int32)
    weight = (np.arange(24) < 20).astype(np.float32)
    jr = jtrainer.DomainRouted(1, 3, offset)
    tr = DomainRouted(1, 3, offset)
    jb, tb = {"sparse": jnp.asarray(sparse)}, {"sparse": torch.from_numpy(
        sparse)}
    tpred = torch.from_numpy(pred)
    np.testing.assert_allclose(
        float(tr.loss(tpred, torch.from_numpy(y), tb,
                      torch.from_numpy(weight))),
        float(jr.loss(pred, y, jb, weight)), rtol=1e-6)
    np.testing.assert_array_equal(tr.route(tpred, tb).numpy(),
                                  np.asarray(jr.route(pred, jb)))
    np.testing.assert_allclose(
        float(tlosses.masked_multitask_bce_sum(
            tpred, torch.from_numpy(y), torch.from_numpy(dom), offset, 3)),
        float(jlosses.masked_multitask_bce_sum(pred, y, dom, offset, 3)),
        rtol=1e-6)


# ----------------------------------------------------------------- train

def _jax_fit(jm, params, state, x, y, mode):
    """Three steps of the JAX Trainer in ``mode`` from ``params`` and
    ``state``: (its trainer, per-step stats)."""
    tr = JaxTrainer(jm, seed=7)
    tr.compile(learning_rate=0.01, bank_update=mode)
    tr.params = jax.tree.map(lambda a: jnp.array(np.asarray(a)), params)
    tr.state = jax.tree.map(lambda a: jnp.array(np.asarray(a)), state)
    tr._bank_mode = mode
    tr.opt_state = (jbo.lazy_init(tr.optimizer, tr.params) if mode == "lazy"
                    else tr.optimizer.init(tr.params))
    recorded, build = [], tr._build_steps

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
    tr.fit(x, y, batch_size=BATCH, epochs=1, verbose=0)
    return tr, recorded


def _port_fit(tm, x, y, mode):
    tr = TorchTrainer(tm, seed=7, device="cpu")
    tr.compile(learning_rate=0.01, bank_update=mode)
    steps, step = [], tr.train_step

    def record(*args):
        stats = step(*args)
        steps.append({k: float(v) for k, v in stats.items()})
        return stats

    tr.train_step = record
    tr.fit(x, y, batch_size=BATCH, epochs=1, verbose=0)
    tr.train_step = step
    return tr, steps


def _fit_data(shift=0):
    x = tp.request(N, seed=5)
    x["domain"] = x["domain"] + shift
    return x, np.random.default_rng(5).integers(0, 2, N).astype(np.float32)


# STAR's scenario field: its embedding is constant over each domain's
# examples, so the domain BatchNorm's normalized value on its columns is
# zero and the exact data gradient of the BatchNorm scales there, and of
# the field's own embedding rows (the side bank ``emb.small``, which holds
# only this field's table), is zero.  What each side computes is float32
# round-off of either sign (beside the embeddings' small L2 term), which
# Adam's first steps turn into steps of up to lr.  These entries are held
# to Adam's step bound over the three steps, on both sides.
LR = 0.01
STEP_BOUND = 3 * LR * 1.001


def _star_roundoff(tm):
    """{name: (mask of the entries held to the step bound)}."""
    d = tm.embedding_dim
    i = tm.layout.sparse_index("domain")
    cols = torch.zeros(tm.input_dim, dtype=torch.bool)
    cols[i * d:(i + 1) * d] = True
    return {"bn_scale": cols, "shared_bn_scale": cols,
            "emb.small": torch.ones(d, dtype=torch.bool)}


def _assert_fit(jt, j_steps, tm, steps, start=None, roundoff=None):
    """The port's steps, parameters and buffers against the JAX
    Trainer's; the entries of ``roundoff`` are held to Adam's step bound
    from ``start``, the state dict both started from."""
    assert len(steps) == len(j_steps) == 3
    for js, ts in zip(j_steps, steps):
        assert js["count"] == ts["count"]
        for k in ("loss", "reg_loss"):
            np.testing.assert_allclose(ts[k], js[k], rtol=1e-5, err_msg=k)
    got = tm.state_dict()
    want = bridge.from_jax_params(jax.tree.map(np.asarray, jt.params), tm,
                                  jax.tree.map(np.asarray, jt.state))
    for name, w in want.items():
        g = got[name]
        if w.dtype == torch.int32:
            assert torch.equal(g, w), name
            continue
        mask = (roundoff or {}).get(name)
        if mask is not None:
            for side in (g, w):
                moved = (side[..., mask] - start[name][..., mask]).abs()
                assert float(moved.max()) <= STEP_BOUND, name
            g, w = g[..., ~mask], w[..., ~mask]
        np.testing.assert_allclose(g.numpy(), w.numpy(), **PARAM_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("mode", ["dense", "lazy"])
def test_star_fit_matches_jax_trainer(mode, tmp_path):
    """STAR's three steps; the BatchNorm statistics move once a step
    (count 2 + 3); then in ``lazy`` a checkpoint restores the parameters,
    the statistics, the offset and the lazy state, and resumes bit for
    bit."""
    jm, params, state, tm = _models("STAR", dropout=RATE)
    start = {k: v.clone() for k, v in tm.state_dict().items()}
    x, y = _fit_data()
    jt, j_steps = _jax_fit(jm, params, state, x, y, mode)
    tr, steps = _port_fit(tm, x, y, mode)
    _assert_fit(jt, j_steps, tm, steps, start, _star_roundoff(tm))
    assert [int(b.count) for b in tm.bn] == [5, 5, 5]
    assert tm.domain_id_offset == jm.domain_id_offset == 1
    assert type(tr.strategy).__name__ == type(jt._strategy).__name__ == \
        "SingleTask"
    pred = tr.predict(x, batch_size=BATCH)
    assert tr.evaluate(x, y, batch_size=BATCH)["auc"] == metrics.auc(y, pred)
    if mode != "lazy":
        return
    path = str(tmp_path / "star")
    checkpoint.save(path, tr)
    tm2 = TORCH_MODELS["Star_Net"](_layout(satrans_torch), device="cpu",
                                   dnn_dropout=RATE, **STAR)
    tm2.set_domain_offset(4)
    tr2 = TorchTrainer(tm2, seed=7, device="cpu")
    tr2.compile(learning_rate=0.01, bank_update="lazy")
    checkpoint.restore(path, tr2)
    assert tm2.domain_id_offset == 1
    for k, v in tm.state_dict().items():
        assert torch.equal(tm2.state_dict()[k], v), k
    for t in (tr, tr2):
        t.fit(x, y, batch_size=BATCH, epochs=1, verbose=0)
    assert [int(b.count) for b in tm2.bn] == [8, 8, 8]
    for k, v in tm.state_dict().items():
        assert torch.equal(tm2.state_dict()[k], v), k


def test_star_state_moves_once_a_step_only(tmp_path):
    """Under ``scan_steps`` with validation inside the epoch, each
    domain's count is the number of steps: the validation forwards and
    ``evaluate`` leave the statistics as they are."""
    _, _, _, tm = _models("STAR", dropout=RATE)
    x, y = _fit_data()
    tr = TorchTrainer(tm, seed=7, device="cpu")
    tr.compile(learning_rate=0.01, bank_update="lazy")
    tr.fit(x, y, batch_size=8, epochs=1, verbose=0, scan_steps=2,
           validation_data=(x, y), valid_cnt_per_epoch=3)
    assert [int(b.count) for b in tm.bn] == [2 + 5] * 3
    before = _buffers(tm)
    tr.evaluate(x, y, batch_size=BATCH)
    for n, b in tm.named_buffers():
        assert torch.equal(b, before[n]), n


def test_mmoe_fit_offset_and_serving_match_jax(tmp_path):
    """MMOE in ``lazy`` on ids 2..4: the offset 2 learned at ``fit``;
    ``predict`` routes each example to its domain's head; a checkpoint's
    ``serving.load`` Predictor (its model built with offset 1) serves
    the same scores as ``predict`` and ``Predictor`` and the JAX
    Predictor's; ``predict`` on ids 1..3 re-learns offset 1 on both
    sides."""
    jm, params, state, tm = _models("MMOE", dropout=RATE)
    x, y = _fit_data(shift=1)
    jt, j_steps = _jax_fit(jm, params, state, x, y, "lazy")
    tr, steps = _port_fit(tm, x, y, "lazy")
    _assert_fit(jt, j_steps, tm, steps)
    assert tm.domain_id_offset == jm.domain_id_offset == \
        tr.strategy.offset == 2
    pred = tr.predict(x, batch_size=BATCH)
    want = JaxPredictor.from_trainer(jt, batch_size=BATCH)(x)
    np.testing.assert_allclose(pred, want, atol=1e-5)
    with torch.no_grad():
        heads = tm.eval()(_port_batch(tm, x)).numpy()
    np.testing.assert_array_equal(
        pred, heads[np.arange(N), x["domain"] - 2].astype("float64"))
    assert tr.evaluate(x, y, batch_size=BATCH)["auc"] == metrics.auc(y, pred)
    path = str(tmp_path / "mmoe")
    serving.save(path, tr)
    fresh = TORCH_MODELS["MMOE"](_layout(satrans_torch), device="cpu",
                                 **EXPERTS)
    loaded = serving.load(path, fresh, batch_size=BATCH, device="cpu")
    assert fresh.domain_id_offset == 2
    np.testing.assert_array_equal(loaded(x), pred)
    np.testing.assert_array_equal(
        serving.Predictor.from_trainer(tr, batch_size=BATCH)(x), pred)
    x0, _ = _fit_data()
    np.testing.assert_allclose(tr.predict(x0, batch_size=BATCH),
                               jt.predict(x0, batch_size=BATCH), atol=1e-5)
    assert tm.domain_id_offset == jm.domain_id_offset == \
        tr.strategy.offset == 1


# ------------------------------------------------------------------- cli

@pytest.mark.parametrize("name", ["Star_Net", "SharedBottom", "MMOE", "PLE",
                                  "ESMM"])
def test_build_model_matches_jax_cli(name):
    """The CLI's model of each name at 3 domains: the JAX CLI's
    parameter and state shapes; ESMM raises the JAX CLI's ValueError."""
    args = tcli.parse_args(["--model_name", name, "--embedding_dim", "8"])
    build = (lambda: jcli.build_model(args, _layout(satrans_tpu), ["domain"],
                                      [3], "None"),
             lambda: tcli.build_model(args, _layout(satrans_torch),
                                      ["domain"], [3], "None",
                                      device="cpu"))
    if name == "ESMM":
        with pytest.raises(ValueError) as want:
            build[0]()
        with pytest.raises(ValueError) as got:
            build[1]()
        assert str(got.value) == str(want.value)
        return
    jm, tm = build[0](), build[1]()
    assert getattr(tm, "num_tasks", 1) == getattr(jm, "num_tasks", 1)
    p, s = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    sd = bridge.from_jax_params(tp.random_params(p), tm,
                                _random_state(s))
    tm.load_state_dict(sd)


@pytest.mark.parametrize("name", ["Star_Net", "MMOE"])
def test_cli_runs(name, tmp_path):
    auc = tcli.main(["--data_name", "synthetic", "--synthetic_rows", "640",
                     "--batch_size", "128", "--model_name", name,
                     "--results_dir", str(tmp_path)], device="cpu")
    assert 0.0 <= auc <= 1.0
    assert len(open(tmp_path / "synthetic_results.csv").readlines()) == 1
