"""The port's SATrans forward against ``satrans_tpu``'s ``SATrans.apply``.

Same layout (two large fields, a side-bank scenario column, a varlen
field), same parameters through ``satrans_torch.bridge``, same numpy
batch.  atol 1e-5 on the sigmoid output: float32 with other summation
orders through two layers.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import satrans_torch
import satrans_tpu
import torch_parity as tp
from satrans_torch import bridge
from satrans_torch import embeddings as temb
from satrans_torch.models import SATrans as TorchSATrans
from satrans_tpu import embeddings as jemb
from satrans_tpu.models import SATrans as JaxSATrans


def _jax_pred(jm, params, x):
    batch = {k: jnp.asarray(v)
             for k, v in jm.layout.batch_from_dict(x).items()}
    pred, _, _ = jm.apply(jax.tree.map(jnp.asarray, params), {}, batch,
                          train=False)
    return np.asarray(pred)


def _port_pred(tm, x):
    batch = {k: torch.from_numpy(v)
             for k, v in tm.layout.batch_from_dict(x).items()}
    with torch.no_grad():
        return tm(batch).numpy()


@pytest.mark.parametrize("mode,relu_out", [("QK", False), ("Query", True)])
def test_model_matches_jax_xla_path(mode, relu_out):
    jm, params, tm = tp.jax_and_port(mode, relu_out)
    x = tp.request(64, seed=1)
    want = _jax_pred(jm, params, x)
    assert want.std() > 1e-2  # the parameters move the prediction
    np.testing.assert_allclose(_port_pred(tm, x), want, atol=1e-5)


def test_model_matches_jax_fused_interpret_path():
    """B=16 gives the JAX model a kernel block (satrans.py picks the
    largest candidate dividing B), so its layers run the Pallas kernel."""
    jm, params, tm = tp.jax_and_port("QK", False)
    jm = dataclasses.replace(jm, use_fused_kernel=True, fused_interpret=True)
    x = tp.request(16, seed=2)
    np.testing.assert_allclose(_port_pred(tm, x), _jax_pred(jm, params, x),
                               atol=1e-5)


@pytest.mark.parametrize("combiner", ["max", "mean", "sum"])
def test_embed_fields_matches_jax(combiner):
    jm, params, tm = tp.jax_and_port(combiner=combiner)
    x = tp.request(32, seed=3)
    x["hist"][0] = 0                       # an all-pad history
    x["domain"][1] = 7                     # outside the side bank: zeros
    batch = jm.layout.batch_from_dict(x)
    want = jemb.embed_fields(jax.tree.map(jnp.asarray, params["emb"]),
                             jm.layout,
                             {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = temb.embed_fields(
            tm.emb, tm.layout, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_array_equal(got[1, 2].numpy(), 0.0)
    ids = np.arange(5)
    for name in ("f1", "domain"):      # a large-bank and a side-bank field
        want = jemb.lookup_field(jax.tree.map(jnp.asarray, params["emb"]),
                                 jm.layout, name, jnp.asarray(ids))
        with torch.no_grad():
            got = temb.lookup_field(tm.emb, tm.layout, name,
                                    torch.from_numpy(ids))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_synthetic_data_is_the_same():
    from satrans_torch.data import synthetic as tsyn
    from satrans_tpu.data import synthetic as jsyn
    kw = dict(n=50, num_sparse=3, vocab=20, num_dense=1, num_varlen=1)
    (xt, yt), (xj, yj) = tsyn.synthetic_data(**kw), jsyn.synthetic_data(**kw)
    np.testing.assert_array_equal(yt, yj)
    for k in xj:
        np.testing.assert_array_equal(xt[k], xj[k])
    cols = [[(type(c).__name__, dataclasses.astuple(c))
             for c in mod.synthetic_columns(num_dense=1, num_varlen=1)]
            for mod in (tsyn, jsyn)]
    assert cols[0] == cols[1]


@pytest.mark.parametrize("kw", [
    dict(compute_dtype="bfloat16"),
    # several columns past SATRANS_COMPOSITE_MAX: 4 x 300 combinations
    dict(domain_cols=["domain", "f0"], num_domains_list=[3, 299]),
], ids=["bf16", "multi-column"])
def test_unported_variants_raise(kw):
    """bf16 raises naming its ROADMAP item.  Several scenario columns past
    ``SATRANS_COMPOSITE_MAX``, refused until the port had the JAX
    package's per-example meta parameters, now build that model: its
    predictions match the JAX package's."""
    layout = satrans_torch.FeatureLayout(tp.columns(satrans_torch))
    args = tp.model_kwargs()
    args.update(kw)
    if "domain_cols" not in kw:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TorchSATrans(layout, **args, device="cpu")
        return
    jm = JaxSATrans(layout=satrans_tpu.FeatureLayout(
        tp.columns(satrans_tpu)), **args)
    p_shape, _ = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    params = tp.random_params(p_shape, seed=2)
    tm = TorchSATrans(layout, **args, device="cpu")
    tm.load_state_dict(bridge.from_jax_params(params, tm))
    assert tm.per_example and not jm.use_composite
    x = tp.request(32, seed=3)
    batch = {k: jnp.asarray(v)
             for k, v in jm.layout.batch_from_dict(x).items()}
    want = np.asarray(jax.jit(lambda p, b: jm.apply(p, {}, b)[0])(
        jax.tree.map(jnp.asarray, params), batch))
    assert want.std() > 1e-2
    np.testing.assert_allclose(_port_pred(tm, x), want, atol=1e-5)


def test_bridge_rejects_unported_params():
    """A 'pos' tree (separate K/V MetaNets, the position tables) has no
    place in a shared model of the port: the configurations differ."""
    kw = tp.model_kwargs()
    jm = JaxSATrans(
        layout=satrans_tpu.FeatureLayout(tp.columns(satrans_tpu)),
        use_pos=True, **kw)
    params, _ = jm.init(jax.random.PRNGKey(0))
    tm = TorchSATrans(satrans_torch.FeatureLayout(tp.columns(satrans_torch)),
                      **kw, device="cpu")
    with pytest.raises(KeyError):
        bridge.from_jax_params(
            jax.tree.map(np.asarray, params), tm)


def test_out_of_range_ids_read_and_differentiate_as_jax():
    """Large-bank ids outside the tables read through the packed layout as
    the JAX package reads them, and their gradient lands where the JAX
    package's lands (or is dropped).  The layout has R = 1100 logical rows
    in R_phys = 69 physical rows of rp = 16 (four zero pad rows): ids -1
    (a wrapped negative), R (a pad lane), R_phys * rp + 5 (past the bank,
    clamped) and 1102 (another pad lane), as f0, f1 and varlen ids."""
    jm, params, tm = tp.jax_and_port()
    rp, n_phys = 16, 69
    assert tm.emb.bank.shape == (n_phys * rp, tp.D_EMB)
    x = tp.request(6, seed=4)
    x["f0"][:3] = [-1, n_phys * rp + 5, 7]          # offset 0
    x["f1"][:3] = [1100 - 300, 1102 - 300, 9]       # offset 300
    x["hist"][0] = [1100 - 800, n_phys * rp + 5 - 800, 3]  # offset 800
    batch = jm.layout.batch_from_dict(x)
    w = np.random.default_rng(5).normal(size=(6, 4, tp.D_EMB)).astype(
        np.float32)

    def jax_loss(bank):
        emb = dict(jax.tree.map(jnp.asarray, params["emb"]), bank=bank)
        out = jemb.embed_fields(emb, jm.layout, {
            k: jnp.asarray(v) for k, v in batch.items()})
        return jnp.sum(out * w), out

    (_, want), want_grad = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(params["emb"]["bank"]))
    out = temb.embed_fields(tm.emb, tm.layout, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-6)
    np.testing.assert_allclose(
        tm.emb.bank.grad.numpy(),
        np.asarray(want_grad).reshape(-1, tp.D_EMB), atol=1e-6)
