"""The port's attention probes against the JAX package.

* The layer: the CPU ``fused_meta_layer_with_scores`` (the plain version
  of K1-scores) against the JAX ``meta_block.fused_meta_layer_with_scores
  (interpret=True)`` at B = 32 on tiles of 16, d = 32, h = 64, 4 heads,
  F = 5 and F = 9 (the JAX function pads F = 9 to 16 and unpacks its
  block-diagonal probabilities): QK, Query with ``relu_out``, distinct
  'pos' Q and K tables, and QK at dropout 0.1 in training (the same
  masks).  ``y`` and ``scores`` at rtol 2e-4 / atol 2e-5, the tolerance of
  ``tests/test_pallas_meta_block.py``.  It is forward only.
* The model: ``SATrans.forward(return_scores=True)`` against the JAX
  ``apply(..., return_scores=True)`` on both JAX routes (its XLA route,
  and ``SATRANS_PROBE_FUSED=1`` with the interpret-mode kernel), for the
  metanet, the gate and a two-column composite on K7, with each side's
  score entry points counted: predictions at atol 1e-5, scores at the
  layer's tolerance.
* The probes on the same parameters and data: ``predict_with_attention``
  (predictions and every (layer, domain, class) mean at atol 1e-5),
  ``collect_visual_instances``, ``dump_instance_attention`` and
  ``dump_instance_attention_reference``: the files hold the same lines or
  records; a line or record on one side only is allowed where its score
  lies within 1e-5 of the threshold, and a printed score may differ by one
  unit of its last digit (two float32 sums that straddle a rounding
  boundary); every such difference is named.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import satrans_torch
import satrans_tpu
import torch_parity as tp
from satrans_torch import bridge
from satrans_torch.models import SATrans as TorchSATrans
from satrans_torch.nn import attention as tattn
from satrans_torch.ops import meta_block as tmb
from satrans_torch.train import Trainer as TorchTrainer
from satrans_torch.train import attention_probe as tprobe
from satrans_torch.utils import make_generator
from satrans_tpu.models import SATrans as JaxSATrans
from satrans_tpu.nn import attention as jattn
from satrans_tpu.nn import metanet as jmetanet
from satrans_tpu.ops.pallas import meta_block as jmb
from satrans_tpu.train import Trainer as JaxTrainer
from satrans_tpu.train import attention_probe as jprobe

TOL = dict(rtol=2e-4, atol=2e-5)
THRESHOLD_TOL = 1e-5

# ------------------------------------------------------------------- layer

LAYER_B, LAYER_BLOCK, D, H, HEADS = 32, 16, 32, 64, 4
UNITS = [D, H, D]


def _layer_setup(F, pos, seed=0):
    """numpy x, JAX layer params moved off their init, per-domain tables
    (distinct Q and K under ``pos``), domain rows, and the port's layer
    holding the params."""
    rng = np.random.default_rng(seed)
    lp = jattn.meta_transformer_init(jax.random.PRNGKey(seed), D, UNITS,
                                     share_kv_metanet=not pos)
    lp = jax.tree.map(lambda a: np.asarray(a) + (
        rng.normal(size=a.shape) * 0.1).astype(np.float32), lp)
    x = rng.normal(size=(LAYER_B, F, D)).astype(np.float32)
    p = jmetanet.param_size(UNITS)
    q = (rng.normal(size=(4, p)) * 0.1).astype(np.float32)
    tables = {"Q": q, "K": (rng.normal(size=(4, p)) * 0.1).astype(
        np.float32) if pos else q}
    dom = rng.integers(0, 4, size=LAYER_B)
    layer = tattn.MetaTransformerLayer(make_generator(0, "cpu"), D,
                                       share_kv_metanet=not pos)
    layer.load_state_dict(bridge.from_jax_params(lp, layer))
    return x, lp, tables, dom, layer


LAYER_CASES = {"QK": ("QK", False, False, 0.0),
               "Query-relu": ("Query", True, False, 0.0),
               "pos": ("QK", False, True, 0.0),
               "QK-dropout": ("QK", False, False, 0.1)}


@pytest.mark.parametrize("case", list(LAYER_CASES))
@pytest.mark.parametrize("F", [5, 9])
def test_scores_layer_matches_jax_interpret_kernel(F, case):
    mode, relu_out, pos, rate = LAYER_CASES[case]
    x, lp, tables, dom, layer = _layer_setup(F, pos)
    drop = dict(train=rate > 0, drop_rate=rate, seed=2 ** 31 - 3,
                block_b=LAYER_BLOCK)
    y_j, s_j = jmb.fused_meta_layer_with_scores(
        jnp.asarray(x), jax.tree.map(jnp.asarray, lp),
        {k: jnp.asarray(v) for k, v in tables.items()},
        jax.nn.one_hot(jnp.asarray(dom), 4), meta_units=UNITS,
        head_num=HEADS, interpret=True, relu_out=relu_out, mode=mode,
        **drop)
    ttabs = {k: torch.from_numpy(v) for k, v in tables.items()}
    if not pos:
        ttabs["K"] = ttabs["Q"]
    with torch.no_grad():
        y, s = tmb.fused_meta_layer_with_scores(
            torch.from_numpy(x), layer, ttabs, torch.from_numpy(dom),
            meta_units=UNITS, head_num=HEADS, mode=mode, relu_out=relu_out,
            **drop)
    assert s.shape == (LAYER_B, HEADS, F, F) == s_j.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), **TOL)
    np.testing.assert_allclose(s.sum(-1).numpy(), 1.0, atol=1e-5)


def test_scores_layer_is_forward_only():
    x, lp, tables, dom, layer = _layer_setup(5, False)
    t = torch.from_numpy(tables["Q"])
    with pytest.raises(RuntimeError, match="forward only"):
        tmb.fused_meta_layer_with_scores(
            torch.from_numpy(x), layer, {"Q": t, "K": t},
            torch.from_numpy(dom), meta_units=UNITS, head_num=HEADS)


# ------------------------------------------------------------------- model

MODEL_B = 64


def _multicol_cols(pkg, combiner="max"):
    return tp.columns(pkg, combiner) + [
        pkg.features.SparseFeature("dom2", 6, tp.D_EMB)]


MODELS = {
    "metanet": dict(),
    "gate": dict(variant="gate"),
    "multicol-K7": dict(cols=_multicol_cols, domain_cols=["domain", "dom2"],
                        num_domains_list=[3, 2]),
}


def _spy(monkeypatch):
    """Count the score entry points of both packages."""
    calls = {"jax": 0, "port": 0}
    for name, mod in (("jax", jmb), ("port", tmb)):
        def wrap(*a, _f=mod.fused_meta_layer_with_scores, _n=name, **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(mod, "fused_meta_layer_with_scores", wrap)
    return calls


@pytest.mark.parametrize("jax_route", ["xla", "fused"])
@pytest.mark.parametrize("model", list(MODELS))
def test_return_scores_matches_jax_routes(model, jax_route, monkeypatch):
    """The JAX XLA route against the port's plain unclamped route
    (``SATRANS_PROBE_FUSED=0``); the JAX ``SATRANS_PROBE_FUSED=1`` route
    against the port's default, K1-scores' plain version for the metanet
    and the plain unclamped layer for gate and K7 (the JAX package has no
    score-returning K6 or K7 and takes its XLA route there too)."""
    jm, params, tm = tp.jax_and_port(**MODELS[model])
    jm = dataclasses.replace(jm, use_fused_kernel=jax_route == "fused",
                             fused_interpret=True)
    monkeypatch.setenv("SATRANS_PROBE_FUSED",
                       "1" if jax_route == "fused" else "0")
    x = tp.request(MODEL_B, seed=2)
    if model == "multicol-K7":
        x["dom2"] = np.random.default_rng(3).integers(0, 5, MODEL_B)
        assert tm.tiled
    batch = jm.layout.batch_from_dict(x)
    calls = _spy(monkeypatch)
    pred_j, _, _, scores_j = jax.jit(lambda p: jm.apply(
        p, {}, {k: jnp.asarray(v) for k, v in batch.items()},
        return_scores=True))(jax.tree.map(jnp.asarray, params))
    with torch.no_grad():
        pred, scores = tm({k: torch.from_numpy(v) for k, v in batch.items()},
                          return_scores=True)
    kernel_route = jax_route == "fused" and model == "metanet"
    assert calls == {"jax": tp.LAYERS * kernel_route,
                     "port": tp.LAYERS * kernel_route}
    assert np.asarray(pred_j).std() > 1e-2
    np.testing.assert_allclose(pred.numpy(), np.asarray(pred_j), atol=1e-5)
    assert len(scores) == len(scores_j) == tp.LAYERS
    for s, s_j in zip(scores, scores_j):
        np.testing.assert_allclose(s.numpy(), np.asarray(s_j), **TOL)


# ------------------------------------------------------------------ probes

PROBE_N, PROBE_BATCH = 40, 16  # two full batches and a padded tail


def _trainers(jm, params, tm):
    jt = JaxTrainer(jm, seed=7)
    jt.params = jax.tree.map(jnp.asarray, params)
    jt.state = {}
    return jt, TorchTrainer(tm, seed=7, device="cpu")


def _probe_data(bias):
    x = tp.request(PROBE_N, seed=4)
    x["domain"] = np.random.default_rng(5).integers(bias, 4, PROBE_N)
    y = np.random.default_rng(6).integers(0, 2, PROBE_N).astype(np.float32)
    return x, y


@pytest.mark.parametrize("bias", [0, 1])
def test_predict_with_attention_matches_jax(bias):
    """bias 0: the pad rows' domain is pushed out of range."""
    jt, tt = _trainers(*tp.jax_and_port())
    x, y = _probe_data(bias)
    pred_j, stats_j = jprobe.predict_with_attention(
        jt, x, y, batch_size=PROBE_BATCH)
    pred, stats = tprobe.predict_with_attention(tt, x, y,
                                                batch_size=PROBE_BATCH)
    assert pred.dtype == np.float64 and pred.shape == (PROBE_N,)
    np.testing.assert_allclose(pred, pred_j, atol=1e-5)
    assert len(stats) == len(stats_j) == tp.LAYERS
    for layer, layer_j in zip(stats, stats_j):
        assert len(layer) == len(layer_j) == 3
        for dom, dom_j in zip(layer, layer_j):
            assert set(dom) == set(dom_j) == {"pos", "neg", "all"}
            for name in dom:
                assert np.abs(dom_j[name]).max() > 0.1, (dom, name)
                np.testing.assert_allclose(dom[name], dom_j[name], atol=1e-5,
                                           err_msg=name)


def test_collect_visual_instances_matches_jax():
    jt, tt = _trainers(*tp.jax_and_port())
    x, _ = _probe_data(1)
    ids = [0, 7, 16, 33, 39, 10_000]
    want = jprobe.collect_visual_instances(jt, x, ids=ids,
                                           batch_size=PROBE_BATCH)
    got = tprobe.collect_visual_instances(tt, x, ids=ids,
                                          batch_size=PROBE_BATCH)
    assert sorted(got) == sorted(want) == [0, 7, 16, 33, 39]
    for i in want:
        np.testing.assert_allclose(got[i], want[i], **TOL)


def _near_threshold(score, threshold):
    return abs(score - threshold) <= THRESHOLD_TOL


def instance_dumps_differ(port_prefix, jax_prefix, domains, threshold):
    """The lines in which the ``dump_instance_attention`` files of the two
    sides differ, each allowed only at a rounding boundary of its printed
    score or where the score lies within 1e-5 of ``threshold`` (its
    printed value within 1e-4 + 1e-5); and the count of the JAX lines."""
    differ, total = [], 0
    for d in domains:
        def lines(prefix):
            text = open(f"{prefix}_{d}.txt").read()
            return {tuple(ln.split("\t")[:4]): float(ln.split("\t")[4])
                    for ln in text.splitlines()}
        got, want = lines(port_prefix), lines(jax_prefix)
        total += len(want)
        for key in set(got) | set(want):
            if got.get(key) == want.get(key):
                continue
            differ.append((d, key, got.get(key), want.get(key)))
            if key in got and key in want:  # a rounding boundary
                assert abs(got[key] - want[key]) <= 1.0001e-4, differ[-1]
            else:
                score = got.get(key, want.get(key))
                assert abs(score - threshold) <= 1e-4 + THRESHOLD_TOL, \
                    differ[-1]
    return differ, total


def test_dump_instance_attention_matches_jax(tmp_path):
    jt, tt = _trainers(*tp.jax_and_port())
    x, _ = _probe_data(1)
    threshold = 0.2
    doms_j = jprobe.dump_instance_attention(
        jt, x, batch_size=PROBE_BATCH, threshold=threshold,
        out_prefix=str(tmp_path / "jax"), max_instances=36)
    doms = tprobe.dump_instance_attention(
        tt, x, batch_size=PROBE_BATCH, threshold=threshold,
        out_prefix=str(tmp_path / "port"), max_instances=36)
    assert doms == doms_j == [1, 2, 3]
    differ, total = instance_dumps_differ(tmp_path / "port", tmp_path / "jax",
                                          doms, threshold)
    assert total > 50
    assert len(differ) <= 2, differ


# the Alimama sparseprice layout of dump_instance_attention_reference: 15
# sparse fields and the label-encoded price, pvalue at 7, gender at 5,
# shopping at 8, price at 15
ALIMAMA = ["user_id", "adgroup_id", "pid", "cms_segid", "cms_group_id",
           "final_gender_code", "age_level", "pvalue_level",
           "shopping_level", "occupation", "new_user_class_level", "cate_id",
           "campaign_id", "customer", "brand", "price"]
PRICE_VOCAB = 20_000


def _alimama_models():
    def cols(pkg):
        return [pkg.features.SparseFeature(
            n, PRICE_VOCAB + 2 if n == "price" else 40, tp.D_EMB)
            for n in ALIMAMA]
    kw = tp.model_kwargs(domain_cols=["pvalue_level"])
    jm = JaxSATrans(layout=satrans_tpu.FeatureLayout(cols(satrans_tpu)), **kw)
    params = tp.random_params(jm.init(jax.random.PRNGKey(3))[0], seed=1,
                              scale=1.0)
    tm = TorchSATrans(satrans_torch.FeatureLayout(cols(satrans_torch)), **kw,
                      device="cpu")
    tm.load_state_dict(bridge.from_jax_params(params, tm))
    return jm, params, tm


def _records(path):
    """[(header fields, scores, feature line)] of a reference dump."""
    lines = path.read_text().splitlines()
    out = []
    for head, scores, feats in zip(lines[0::3], lines[1::3], lines[2::3]):
        fields = dict(f.split(" ", 1) for f in head.split(","))
        out.append((fields, np.array(scores.split(",")[:-1], float), feats))
    return out


def _gates(a, pv=7, g=5, sh=8, pr=15):
    f = int(np.sqrt(len(a)))
    a = a.reshape(f, f)
    return [a[pv][g], a[pv][pr], a[pr][pv], a[pr][g], a[pr][sh]]


def test_dump_instance_attention_reference_matches_jax(tmp_path):
    jm, params, tm = _alimama_models()
    jt, tt = _trainers(jm, params, tm)
    rng = np.random.default_rng(8)
    n = 96
    x = {name: rng.integers(1, 39, n) for name in ALIMAMA}
    x["pvalue_level"] = rng.integers(2, 4, n)
    x["price"] = rng.integers(9_000, PRICE_VOCAB, n)
    y = (rng.random(n) < 0.7).astype(np.float32)
    classes = np.arange(PRICE_VOCAB) * 0.5
    kw = dict(flag="sparseprice_instattn", classes_=classes,
              batch_size=PROBE_BATCH * 2, threshold=0.06)
    os.makedirs(tmp_path / "jax")
    os.makedirs(tmp_path / "port")
    pj = jprobe.dump_instance_attention_reference(
        jt, x, y, out_dir=str(tmp_path / "jax"), **kw)
    pt = tprobe.dump_instance_attention_reference(
        tt, x, y, out_dir=str(tmp_path / "port"), **kw)
    assert os.path.basename(pj) == os.path.basename(pt)
    want, got = _records(tmp_path / "jax" / os.path.basename(pj)), \
        _records(tmp_path / "port" / os.path.basename(pt))
    assert len(want) > 10

    def key(r):
        return (r[2], tuple(v for k, v in r[0].items() if k != "score"))

    differ = []
    got_by, want_by = {}, {}
    for r in got:
        got_by.setdefault(key(r), []).append(r)
    for r in want:
        want_by.setdefault(key(r), []).append(r)
    for k in set(got_by) | set(want_by):
        a, b = got_by.get(k, []), want_by.get(k, [])
        for ra, rb in zip(a, b):
            assert abs(float(ra[0]["score"]) - float(rb[0]["score"])) <= 1e-5
            np.testing.assert_allclose(ra[1], rb[1], atol=1e-5)
        for r in a[len(b):] + b[len(a):]:
            differ.append((k, r[0]))
            assert any(_near_threshold(v, kw["threshold"])
                       for v in _gates(r[1])), differ[-1]
    assert len(differ) <= 2, differ
