"""The port's multi-column SATrans (composite product-domain tables, the
dispatch and the tiled layer K7) against the JAX package.

Small widths, as in ``torch_parity``: d = 8, 2 heads, MetaNet 8 -> 16 ->
8, 2 layers, and a second scenario column ``dom2`` (vocab 6, in the side
bank) beside ``domain``: ``[3, 2]`` gives a composite table of 4 x 3 = 12
rows (past ``SATRANS_TILED_MIN_ROWS`` = 8: the tiled layer), ``[3, 1]``
one of 8 (K1 on the composite table).

* ``ops/dispatch.plan`` / ``scatter`` / ``gather_back`` equal the JAX
  package's (``src``, ``back``, ``tile_dom``, ``n_slots``), with empty
  domains, runs that fill their tiles exactly, one domain only; the
  port's own ``tile_count`` is each tile's count of the JAX plan's
  occupied slots, which come first in the tile.
* The layer: the CPU ``fused_tiled_layer`` (the plain version of the K7
  bodies) against ``tiled_meta.fused_tiled_layer_vjp(interpret=True)`` on
  4 tiles of 16 slots (F = 5 padded to 8 in the JAX kernel): forward at
  rtol 2e-4 / atol 2e-5 and every gradient (x, the layer's parameters and
  the per-tile tables) at rtol 2e-3 / atol 2e-4 (the tolerances of
  ``tests/test_torch_pos.py``), under ``bwd`` stash and recompute, at
  dropout 0 and 0.1, QK, Query with ``relu_out``, and distinct Q and K
  tables with a ``k_meta`` LayerNorm; the masks equal the JAX
  interpret-mode masks over the dispatched slots bit for bit.
* The model against the JAX fused path in interpret mode at B = 64:
  predictions at atol 1e-5 and train-mode gradients at dropout 0.1 with
  each side's default seeds, on the K7 route (the dispatch tile 32), on
  K1 (8 rows) and with the gate variant on K6 (12 rows); the entry points
  of each side are counted.  A batch that no dispatch tile divides takes
  the plain composite layer, as the JAX package takes its XLA path, in
  training too, with the XLA layer's masks.
* Two ``lazy`` ``fit`` steps at dropout 0.1 against the JAX ``Trainer``
  (``torch_parity``'s tolerances); ``domain_emb`` and the large part of
  ``domain_bank`` stay bit-identical on both sides.
* ``predict``, ``evaluate`` and the ``Predictor``; ``bridge`` with
  ``domain_bank``.
* Past ``SATRANS_COMPOSITE_MAX`` (``domain`` x ``f0``: 4 x 300
  combinations; and 12 under ``SATRANS_COMPOSITE_MAX=8``) the JAX
  package's per-example meta parameters on its XLA route, no layer
  kernel on either side: the metanet, gate, bilinear and pos models'
  eval and train predictions (dropout 0.1, one key) and every gradient
  (within 1e-4 of its largest entry plus 1e-5) in one jitted JAX call,
  the probes' attention probabilities, two ``lazy`` ``fit`` steps
  against the JAX ``Trainer`` with ``predict``, the ``Predictor`` and
  ``serving.load``, and ``cli.main --domain_col domain-f0``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import satrans_torch
import torch_parity as tp
from satrans_torch import bridge
from satrans_torch.models import SATrans as TorchSATrans
from satrans_torch.nn import attention as tattn
from satrans_torch.ops import dispatch as tdsp
from satrans_torch.ops import threefry
from satrans_torch.ops import tiled_meta as ttm
from satrans_torch.serving import Predictor
from satrans_torch.utils import make_generator
from satrans_tpu.nn import attention as jattn
from satrans_tpu.nn import metanet as jmetanet
from satrans_tpu.ops import dispatch as jdsp
from satrans_tpu.ops.pallas import tiled_meta as jtm
from satrans_tpu.train import losses as jlosses
from test_torch_bank_train import _jax_fit
from test_torch_dropout import _jax_masks

FWD_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
HEADS = tp.HEADS
UNITS = [tp.D_EMB, 16, tp.D_EMB]
RATE, SEED = 0.1, 2 ** 31 - 3  # seed + tile wraps past int32
COLS = ["domain", "dom2"]


# ---------------------------------------------------------------- dispatch

DISPATCH_CASES = [
    ("random", 12, 16),
    ([0, 0, 3, 3, 3, 3, 7, 7], 9, 2),        # empty domains, exact fills
    ([5] * 32, 6, 16),                       # one domain only
    ([11] * 16 + [0] * 16, 12, 8),           # the last domain, exact fills
]


@pytest.mark.parametrize("ids,num_domains,tile", DISPATCH_CASES)
def test_dispatch_plan_equals_jax(ids, num_domains, tile):
    if ids == "random":
        ids = np.random.default_rng(0).integers(0, num_domains, 64)
    ids = np.asarray(ids, np.int32)
    want = jdsp.plan(jnp.asarray(ids), num_domains, tile)
    got = tdsp.plan(torch.from_numpy(ids), num_domains, tile)
    assert got.n_slots == want.n_slots and got.tile == tile
    for name in ("src", "back", "tile_dom"):
        t = getattr(got, name)
        assert t.dtype == torch.int32, name
        np.testing.assert_array_equal(t.numpy(), np.asarray(
            getattr(want, name)), err_msg=name)
    x = np.random.default_rng(1).normal(size=(len(ids), 3, 2)).astype(
        np.float32)
    buf = tdsp.scatter(torch.from_numpy(x), got)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(
        jdsp.scatter(jnp.asarray(x), want)))
    np.testing.assert_array_equal(tdsp.gather_back(buf, got).numpy(), x)


@pytest.mark.parametrize("ids,num_domains,tile", DISPATCH_CASES)
def test_dispatch_tile_count_is_each_tiles_occupied_prefix(ids, num_domains,
                                                           tile):
    """``DispatchPlan.tile_count`` (the port's own; K7's backward skips the
    rest of each tile) is the per-tile count of ``src >= 0`` of the JAX
    package's plan, and each tile's occupied slots come first."""
    if ids == "random":
        ids = np.random.default_rng(0).integers(0, num_domains, 64)
    ids = np.asarray(ids, np.int32)
    want = np.asarray(jdsp.plan(jnp.asarray(ids), num_domains, tile).src)
    got = tdsp.plan(torch.from_numpy(ids), num_domains, tile).tile_count
    occupied = (want >= 0).reshape(-1, tile)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), occupied.sum(1))
    np.testing.assert_array_equal(
        occupied, np.arange(tile)[None, :] < got.numpy()[:, None])


def test_dispatch_rejects_a_batch_the_tile_does_not_divide():
    with pytest.raises(ValueError, match="must divide"):
        tdsp.plan(torch.zeros(10, dtype=torch.int64), 3, 4)


# ------------------------------------------------------------------- layer

N_TILES, TILE, F = 4, 16, 5


def _layer_setup(pos, seed=0):
    """numpy inputs on 4 tiles of 16 slots (the last tile's slots zero, as
    dispatch slack), upstream gradient, JAX layer params moved off their
    init, per-tile Q and K tables (one table without ``pos``) and the
    port's layer holding the params."""
    rng = np.random.default_rng(seed)
    d = tp.D_EMB
    lp = jattn.meta_transformer_init(jax.random.PRNGKey(seed), d, UNITS,
                                     share_kv_metanet=not pos)
    lp = jax.tree.map(lambda a: np.asarray(a) + (
        rng.normal(size=a.shape) * 0.1).astype(np.float32), lp)
    n = N_TILES * TILE
    x = rng.normal(size=(n, F, d)).astype(np.float32)
    x[-TILE + 3:] = 0.0
    g = rng.normal(size=(n, F, d)).astype(np.float32)
    p = jmetanet.param_size(UNITS)
    tables = {k: (rng.normal(size=(N_TILES, p)) * 0.3).astype(np.float32)
              for k in ("QK" if pos else "Q")}
    layer = tattn.MetaTransformerLayer(make_generator(0, "cpu"), d,
                                       share_kv_metanet=not pos)
    layer.load_state_dict(bridge.from_jax_params(lp, layer))
    return x, g, lp, tables, layer


@pytest.mark.parametrize("mode,relu_out,pos,bwd,rate", [
    ("QK", False, False, "stash", 0.0),
    ("QK", False, False, "stash", RATE),
    ("QK", False, False, "recompute", 0.0),
    ("QK", False, False, "recompute", RATE),
    ("Query", True, False, "stash", RATE),
    ("Query", True, False, "recompute", RATE),
    ("QK", False, True, "stash", RATE),
    ("QK", False, True, "recompute", 0.0),
], ids=["QK-stash-0", "QK-stash-0.1", "QK-recompute-0", "QK-recompute-0.1",
        "Query-relu_out-stash-0.1", "Query-relu_out-recompute-0.1",
        "pos-stash-0.1", "pos-recompute-0"])
def test_tiled_layer_matches_jax_interpret_kernel(mode, relu_out, pos, bwd,
                                                  rate):
    x, g, lp, tables, layer = _layer_setup(pos)
    drop = dict(train=True, drop_rate=rate, seed=SEED, block_b=TILE)

    def fn(x, lp, tables):
        tabs = tables if pos else {"Q": tables["Q"], "K": tables["Q"]}
        return jtm.fused_tiled_layer_vjp(
            x, lp, tabs, meta_units=UNITS, head_num=HEADS, interpret=True,
            bwd=bwd, relu_out=relu_out, mode=mode, **drop)

    y_jax, (gx, glp, gt) = tp.fast_vjp(
        fn, (jnp.asarray(x), jax.tree.map(jnp.asarray, lp),
             jax.tree.map(jnp.asarray, tables)), jnp.asarray(g))
    want = dict(bridge._flatten(jax.tree.map(np.asarray, glp)))
    want.update(x=np.asarray(gx))
    want.update({f"table.{k}": np.asarray(v) for k, v in gt.items()})

    xt = torch.from_numpy(x).requires_grad_(True)
    tt = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in tables.items()}
    tabs = tt if pos else {"Q": tt["Q"], "K": tt["Q"]}
    y = ttm.fused_tiled_layer(xt, layer, tabs, meta_units=UNITS,
                              head_num=HEADS, mode=mode, relu_out=relu_out,
                              bwd=bwd, **drop)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_jax),
                               **FWD_TOL)
    # v_meta (pos) is never applied, and Query leaves K's MetaNet out: no
    # gradient in the port, zeros in JAX
    got = {n: np.zeros_like(want[n]) if p.grad is None else p.grad.numpy()
           for n, p in layer.named_parameters()}
    got.update(x=xt.grad.numpy())
    got.update({f"table.{k}": t.grad.numpy() for k, t in tt.items()})
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   **GRAD_TOL)
    assert np.abs(got["table.Q"]).max() > 0
    if pos:
        assert not np.allclose(got["table.Q"], got["table.K"])


@pytest.mark.parametrize("mode", ["QK", "Query"])
def test_tiled_masks_equal_jax_interpret_masks(mode):
    """The masks over the dispatched slots: tile ``t`` of ``block_b = 32``
    slots seeded with ``seed + t``; F = 19 padded to 24, 4 examples a
    block-diagonal attention draw (the AliCCP multicol tile)."""
    apply_q, apply_k = "Q" in mode, "K" in mode
    x = torch.zeros(96, 19, tp.D_EMB)
    got = ttm.layer_masks(x, head_num=HEADS, mode=mode, train=True,
                          drop_rate=RATE, seed=SEED, block_b=32)
    want = _jax_masks(SEED, 96, 19, tp.D_EMB, HEADS, 32, apply_q, apply_k)
    for key, m in zip("qksz", got):
        if want[key] is None:
            assert m is None, key
        else:
            np.testing.assert_array_equal(m.numpy(), want[key], err_msg=key)


def test_tiled_bwd_rule(monkeypatch):
    assert ttm.bwd_mode() == "stash"
    monkeypatch.setenv("SATRANS_TILED_BWD", "recompute")
    assert ttm.bwd_mode() == "recompute"
    assert ttm.bwd_mode("stash") == "stash"
    for bad in ("stash_light", "light"):
        monkeypatch.setenv("SATRANS_TILED_BWD", bad)
        with pytest.raises(ValueError, match="unknown bwd mode"):
            ttm.bwd_mode()


# ------------------------------------------------------------------- model

B = 64


def _cols(pkg, combiner="max"):
    """``torch_parity.columns`` and a second scenario column."""
    return tp.columns(pkg, combiner) + [
        pkg.features.SparseFeature("dom2", 6, tp.D_EMB)]


def _request(n, seed):
    """Ids of both scenario columns past their ranges too (clipped)."""
    x = tp.request(n, seed=seed)
    x["dom2"] = np.random.default_rng(seed + 100).integers(0, 5, n)
    return x


def _models(num_domains=(3, 2), **kw):
    jm, params, tm = tp.jax_and_port(
        cols=_cols, domain_cols=COLS, num_domains_list=list(num_domains),
        dropout_rate=RATE, **kw)
    return (dataclasses.replace(jm, use_fused_kernel=True,
                                fused_interpret=True), params, tm)


def _spy(monkeypatch):
    """Count the layer entry points of both packages."""
    import satrans_tpu.ops.pallas.gate_block as jgb
    import satrans_tpu.ops.pallas.meta_block as jmb
    from satrans_torch.ops import gate_block as tgb
    from satrans_torch.ops import meta_block as tmb
    calls = {}
    for name, mod, attr in (
            ("jax tiled", jtm, "fused_tiled_layer_vjp"),
            ("jax metanet", jmb, "fused_meta_layer_vjp"),
            ("jax simple", jgb, "fused_simple_layer_vjp"),
            ("tiled", ttm, "fused_tiled_layer"),
            ("metanet", tmb, "fused_meta_layer"),
            ("simple", tgb, "fused_simple_layer")):
        calls[name] = 0

        def wrap(*a, _f=getattr(mod, attr), _n=name, **k):
            calls[_n] += 1
            return _f(*a, **k)

        monkeypatch.setattr(mod, attr, wrap)
    return calls


@pytest.mark.parametrize("num_domains,variant,route", [
    ((3, 2), "metanet", "tiled"), ((3, 1), "metanet", "metanet"),
    ((3, 2), "gate", "simple")], ids=["K7", "K1-8-rows", "gate-K6"])
def test_multicol_model_matches_jax_fused_interpret_path(
        num_domains, variant, route, monkeypatch):
    jm, params, tm = _models(num_domains, variant=variant)
    rows = (num_domains[0] + 1) * (num_domains[1] + 1)
    assert tm.use_composite and tm.meta_rows == jm.meta_rows == rows
    assert tm.tiled == (route == "tiled")
    x = _request(B, seed=1)
    y = np.random.default_rng(1).integers(0, 2, B).astype(np.float32)
    batch = jm.layout.batch_from_dict(x)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jparams = jax.tree.map(jnp.asarray, params)
    calls = _spy(monkeypatch)

    # jitted without XLA's backend optimizations: one compile of the
    # interpret-mode kernels, not op by op
    want = np.asarray(tp.compile_fast(jax.jit(
        lambda p: jm.apply(p, {}, jbatch)[0]))(jparams))
    assert want.std() > 1e-2  # the parameters move the prediction
    with torch.no_grad():
        np.testing.assert_allclose(tm(tbatch).numpy(), want, atol=1e-5)
    assert calls[route] == calls[f"jax {route}"] == tp.LAYERS
    assert sum(calls.values()) == 2 * tp.LAYERS

    def loss(p):  # rng=None: the JAX package's default seeds
        pred = jm.apply(p, {}, jbatch, train=True)[0]
        return jlosses.bce_sum(pred, jnp.asarray(y))

    jgrads = bridge.from_jax_params(
        jax.tree.map(np.asarray, tp.compile_fast(jax.jit(jax.grad(loss)))(
            jparams)), tm)
    tm.train()
    pred = tm(tbatch)
    torch.nn.functional.binary_cross_entropy(
        pred, torch.from_numpy(y), reduction="sum").backward()
    for name, p in tm.named_parameters():
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(grad.numpy(), jgrads[name].numpy(),
                                   err_msg=name, **GRAD_TOL)
    # the composite path reads the second bank's side rows, never
    # domain_emb nor the second bank's large part
    assert tm.domain_bank.small.grad.abs().max() > 0
    assert tm.domain_emb.grad is None and tm.domain_bank.bank.grad is None


def test_batch_no_dispatch_tile_divides_takes_the_plain_layer():
    """B = 24: neither 32 nor 16 divides it; the JAX package runs its XLA
    path and so does the port (the plain composite layer on the whole
    batch), in inference and in training at dropout 0.1 with one key on
    both sides (the XLA layer's ``jax.random.bernoulli`` masks)."""
    jm, params, tm = _models()
    batch = jm.layout.batch_from_dict(_request(24, seed=2))
    fn = tp.compile_fast(jax.jit(lambda p, b, k: (
        jm.apply(p, {}, b)[0], jm.apply(p, {}, b, train=True, rng=k)[0])))
    want, want_train = (np.asarray(a) for a in fn(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(6)))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got = tm(tb)
        tm.train()
        got_train = tm(tb, key=threefry.PRNGKey(6))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got_train.numpy(), want_train, atol=1e-5)
    assert np.abs(want_train - want).max() > 1e-3


def test_multicol_lazy_fit_at_dropout_matches_jax_trainer():
    """24 examples at batch 16 (a full batch and a padded tail), dispatch
    tile 16: 13 tiles of which the slack ones carry zeros."""
    jm, params, tm = _models()
    x = _request(24, seed=5)
    y = np.random.default_rng(5).integers(0, 2, 24).astype(np.float32)
    j_steps, j_params, _ = _jax_fit(jm, params, x, y, "lazy")
    steps = tp.port_fit(tm, x, y, "lazy")
    assert len(steps) == 2
    tp.assert_fit_matches(j_steps, j_params, steps, tm)
    got = tm.state_dict()
    start = bridge.from_jax_params(params, tm)
    for name in ("domain_emb", "domain_bank.bank"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      start[name].numpy(), err_msg=name)
        np.testing.assert_array_equal(
            bridge.from_jax_params(j_params, tm)[name].numpy(),
            start[name].numpy(), err_msg=name)
    assert not torch.equal(got["domain_bank.small"],
                           start["domain_bank.small"])


def test_multicol_predict_evaluate_and_serving():
    """``Trainer.predict``, ``Trainer.evaluate`` and the ``Predictor`` (20
    examples at batch 16, dispatched: a padded tail) give the model's
    scores on the 20 at once (no dispatch tile divides 20: the plain
    composite layer)."""
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


def test_bridge_moves_a_multicol_tree():
    """Both packed banks are reshaped to logical rows, the rest as it is."""
    jm, params, tm = _models()
    state = bridge.from_jax_params(params, tm)
    assert set(state) == set(tm.state_dict())
    for name in ("emb", "domain_bank"):
        packed = params[name]["bank"]
        assert packed.shape[1] == 128
        np.testing.assert_array_equal(
            state[f"{name}.bank"].numpy(), packed.reshape(-1, tp.D_EMB))
        np.testing.assert_array_equal(state[f"{name}.small"].numpy(),
                                      params[name]["small"])
    np.testing.assert_array_equal(state["domain_emb"].numpy(),
                                  params["domain_emb"])


# ------------------------------------------------ past the composite cap

PE_COLS = ["domain", "f0"]   # 4 x 300 combinations: per-example tables


def _pe_request(n, seed):
    """``torch_parity.request`` rows with ids the per-example lookup
    reads as the JAX lookup does: a pad 0 and one past ``f0``'s vocab,
    and a scenario id past the 3 domains."""
    x = tp.request(n, seed=seed)
    x["f0"][:2] = [0, 310]
    x["domain"][2] = 4
    return x


def _pe_models(variant="metanet", use_pos=False, cols=tp.columns,
               domain_cols=PE_COLS, num_domains=(3, 299)):
    """(jax model on its XLA route, numpy params drawn from its
    ``eval_shape`` shapes, port model)."""
    import satrans_tpu
    from satrans_tpu.models import SATrans as JaxSATrans
    kw = tp.model_kwargs(domain_cols=list(domain_cols),
                         num_domains_list=list(num_domains),
                         dropout_rate=RATE, variant=variant, use_pos=use_pos)
    jm = JaxSATrans(layout=satrans_tpu.FeatureLayout(cols(satrans_tpu)), **kw)
    p_shape, _ = jax.eval_shape(jm.init, jax.random.PRNGKey(3))
    params = tp.random_params(p_shape, seed=8)
    tm = TorchSATrans(satrans_torch.FeatureLayout(cols(satrans_torch)), **kw,
                      device="cpu")
    tm.load_state_dict(bridge.from_jax_params(params, tm))
    assert tm.per_example and not jm.use_composite
    assert not (tm.metanet_kernel or tm.simple_kernel or tm.tiled)
    return jm, params, tm


@pytest.mark.parametrize("variant,use_pos", [
    ("metanet", False), ("gate", False), ("bilinear", False),
    ("metanet", True)], ids=["metanet", "gate", "bilinear", "pos"])
def test_per_example_model_matches_jax(variant, use_pos, monkeypatch):
    """Past ``SATRANS_COMPOSITE_MAX`` (``domain`` x ``f0``, 1,200
    combinations): eval predictions, and at dropout 0.1 with one key the
    train predictions and the gradient of ``sum(c * pred)`` of every
    parameter (within 1e-4 of its largest entry plus 1e-5), against the
    JAX package's per-example path in one jitted call; neither side
    enters a layer kernel."""
    jm, params, tm = _pe_models(variant, use_pos)
    x = _pe_request(B, seed=4)
    batch = jm.layout.batch_from_dict(x)
    c = np.random.default_rng(4).uniform(0.5, 1.5, B).astype(np.float32)
    calls = _spy(monkeypatch)

    def run(p, b, key):
        def loss(p):
            pred = jm.apply(p, {}, b, train=True, rng=key)[0]
            return jnp.sum(pred * c), pred
        (_, pred), grads = jax.value_and_grad(loss, has_aux=True)(p)
        return jm.apply(p, {}, b)[0], pred, grads

    args = (jax.tree.map(jnp.asarray, params),
            {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(11))
    want_eval, want, jgrads = jax.tree.map(np.asarray, jax.jit(run).lower(
        *args).compile(compiler_options=tp.FAST)(*args))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        np.testing.assert_allclose(tm(tb).numpy(), want_eval, atol=1e-5)
    assert want_eval.std() > 1e-2
    tm.train()
    pred = tm(tb, key=threefry.PRNGKey(11))
    np.testing.assert_allclose(pred.detach().numpy(), want, atol=1e-5)
    assert np.abs(want - want_eval).max() > 1e-3  # the dropout moved it
    torch.sum(pred * torch.from_numpy(c)).backward()
    for name, w in bridge.from_jax_params(jgrads, tm).items():
        p = dict(tm.named_parameters())[name]
        g = torch.zeros_like(p) if p.grad is None else p.grad
        bound = 1e-4 * float(w.abs().max()) + 1e-5
        assert float((g - w).abs().max()) <= bound, name
    assert sum(calls.values()) == 0
    # each example reads its columns' rows of domain_bank: f0's lie in
    # its large part, domain's in its side bank; domain_emb is not read
    assert tm.domain_bank.bank.grad.abs().max() > 0
    assert tm.domain_bank.small.grad.abs().max() > 0
    assert tm.domain_emb.grad is None


@pytest.mark.parametrize("num_domains,variant,env", [
    ((3, 299), "metanet", None),     # 4 x 300 > SATRANS_COMPOSITE_MAX
    ((3, 2), "metanet", "8"),        # 12 > SATRANS_COMPOSITE_MAX=8
], ids=["above-composite-max", "composite-max-env"])
def test_unported_multicol_cases_raise(num_domains, variant, env,
                                       monkeypatch):
    """The two cases past the composite cap that the port refused until
    it had the per-example path: now each builds the per-example model,
    and its eval predictions with each layer's attention probabilities
    (the probes' ``return_scores``, on the plain layer) and its train
    predictions at dropout 0.1 with one key match the JAX package's (the
    cap read from ``SATRANS_COMPOSITE_MAX`` by both)."""
    if env is not None:
        monkeypatch.setenv("SATRANS_COMPOSITE_MAX", env)
    wide = num_domains[1] > 5  # a scenario column with that many ids
    jm, params, tm = _pe_models(
        variant, cols=tp.columns if wide else _cols,
        domain_cols=["domain", "f0" if wide else "dom2"],
        num_domains=num_domains)
    x = _pe_request(B, seed=6) if wide else _request(B, seed=6)
    batch = jm.layout.batch_from_dict(x)
    fn = tp.compile_fast(jax.jit(lambda p, b, k: (
        jm.apply(p, {}, b, return_scores=True),
        jm.apply(p, {}, b, train=True, rng=k)[0])))
    (want, _, _, want_scores), want_train = jax.tree.map(np.asarray, fn(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(6)))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got, scores = tm(tb, return_scores=True)
        tm.train()
        got_train = tm(tb, key=threefry.PRNGKey(6))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert len(scores) == len(want_scores) == tp.LAYERS
    for s, w in zip(scores, want_scores):
        np.testing.assert_allclose(s.numpy(), w, atol=1e-5)
    np.testing.assert_allclose(got_train.numpy(), want_train, atol=1e-5)


def test_per_example_lazy_fit_matches_jax_trainer(tmp_path, monkeypatch):
    """Two ``lazy`` ``fit`` steps at dropout 0.1 past the cap (24
    examples at batch 16: a padded tail) against the JAX ``Trainer``
    (``torch_parity``'s tolerances); ``domain_emb`` unread and unchanged
    on both sides; then ``predict`` against the JAX model's on the
    trained parameters, and the ``Predictor`` and the ``Predictor`` of
    ``serving.load`` on the port's checkpoint equal to ``predict``."""
    from satrans_torch import serving
    from satrans_torch.train import Trainer
    jm, params, tm = _pe_models()
    x = _pe_request(24, seed=5)
    y = np.random.default_rng(5).integers(0, 2, 24).astype(np.float32)
    tp.fast_trainer_steps(monkeypatch)
    j_steps, j_params, _ = _jax_fit(jm, params, x, y, "lazy")
    steps = tp.port_fit(tm, x, y, "lazy")
    assert len(steps) == 2
    tp.assert_fit_matches(j_steps, j_params, steps, tm)
    start = bridge.from_jax_params(params, tm)["domain_emb"]
    assert torch.equal(tm.domain_emb.detach(), start)
    tr = Trainer(tm, device="cpu").compile(bank_update="lazy")
    pred = tr.predict(x, batch_size=16)
    want = np.asarray(tp.compile_fast(jax.jit(
        lambda p, b: jm.apply(p, {}, b)[0]))(
        jax.tree.map(jnp.asarray, j_params),
        {k: jnp.asarray(v) for k, v in jm.layout.batch_from_dict(x).items()}))
    np.testing.assert_allclose(pred, want, atol=1e-5)
    np.testing.assert_array_equal(
        Predictor(tm, batch_size=16, device="cpu")(x), pred)
    path = str(tmp_path / "per_example")
    serving.save(path, tr)
    fresh = _pe_models()[2]
    np.testing.assert_array_equal(
        serving.load(path, fresh, batch_size=16, device="cpu")(x), pred)


def test_cli_domain_col_past_the_cap_trains(tmp_path, monkeypatch):
    """``cli.main --domain_col domain-f0`` (4 x 1,000 combinations) on
    640 synthetic rows: the per-example SATrans trains, predicts and
    writes its one report row."""
    from satrans_torch.cli import main as tcli
    build, built = tcli.build_model, []

    def record(*args, **kw):
        built.append(build(*args, **kw))
        return built[-1]

    monkeypatch.setattr(tcli, "build_model", record)
    auc = tcli.main(["--data_name", "synthetic", "--synthetic_rows", "640",
                     "--batch_size", "128", "--embedding_dim", "8",
                     "--att_head_num", "2", "--domain_att_layer_num", "1",
                     "--domain_col", "domain-f0", "--results_dir",
                     str(tmp_path)], device="cpu")
    (model,) = built
    assert model.per_example and model.product_domains > 256
    assert 0.0 <= auc <= 1.0
    assert len(open(tmp_path / "synthetic_results.csv").readlines()) == 1
