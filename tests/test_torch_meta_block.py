"""The port's meta-transformer layer against the JAX package.

``satrans_torch.ops.meta_block.meta_layer_reference`` (the plain version of
the CUDA kernel) is held against the JAX XLA layer and against the JAX
Pallas kernel run in interpret mode, on the same numpy inputs, at the
tolerance the JAX package uses for its own kernel-vs-XLA comparison
(rtol 2e-4, atol 2e-5: float32 sums in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from satrans_torch import bridge
from satrans_torch.nn import attention as tattn
from satrans_torch.ops import meta_block as tmb
from satrans_torch.utils import make_generator
from satrans_tpu.nn import attention as jattn
from satrans_tpu.nn import metanet as jmetanet
from satrans_tpu.ops.pallas import meta_block as jmb

TOL = dict(rtol=2e-4, atol=2e-5)
MODES = [("QK", False), ("QK", True), ("Query", False), ("Query", True)]


def _setup(B=16, F=5, d=16, h=32, D=4, seed=0):
    """numpy inputs, the JAX layer params, and the port's layer holding
    the same params."""
    rng = np.random.default_rng(seed)
    units = [d, h, d]
    lp = jattn.meta_transformer_init(jax.random.PRNGKey(seed), d, units,
                                     share_kv_metanet=True)
    lp = jax.tree.map(lambda a: np.asarray(a)
                      + (rng.normal(size=a.shape) * 0.1).astype(np.float32),
                      lp)
    x = rng.normal(size=(B, F, d)).astype(np.float32)
    table = (rng.normal(size=(D, jmetanet.param_size(units))) * 0.1
             ).astype(np.float32)
    dom = rng.integers(0, D, size=B)
    layer = tattn.MetaTransformerLayer(make_generator(0, "cpu"), d)
    layer.load_state_dict(bridge.from_jax_params(lp, layer))
    return x, lp, table, dom, units, layer


def _port(x, layer, table, dom, units, heads, mode, relu_out, fn):
    t = torch.from_numpy(table)
    with torch.no_grad():
        y = fn(torch.from_numpy(x), layer, {"Q": t, "K": t},
               torch.from_numpy(dom), meta_units=units, head_num=heads,
               mode=mode, relu_out=relu_out)
    return y.numpy()


@pytest.mark.parametrize("mode,relu_out", MODES)
def test_reference_matches_jax_xla_layer(mode, relu_out):
    x, lp, table, dom, units, layer = _setup()
    t = jnp.asarray(table)
    want = jattn.meta_transformer_apply(
        jax.tree.map(jnp.asarray, lp), jnp.asarray(x), {"Q": t, "K": t},
        units, mode=mode, head_num=2, relu_out=relu_out, train=False,
        domain_ids=jnp.asarray(dom), dense_select=True)
    got = _port(x, layer, table, dom, units, 2, mode, relu_out,
                tmb.meta_layer_reference)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("mode,relu_out", [("QK", False), ("Query", True)])
def test_reference_matches_jax_pallas_interpret(mode, relu_out):
    x, lp, table, dom, units, layer = _setup()
    t = jnp.asarray(table)
    want = jmb.fused_meta_layer(
        jnp.asarray(x), jax.tree.map(jnp.asarray, lp), {"Q": t, "K": t},
        jax.nn.one_hot(jnp.asarray(dom), table.shape[0]), meta_units=units,
        head_num=2, train=False, block_b=16, interpret=True,
        relu_out=relu_out, mode=mode)
    got = _port(x, layer, table, dom, units, 2, mode, relu_out,
                tmb.meta_layer_reference)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_per_example_params_match_jax():
    """meta params given per example ``[B, P]`` (MetaNet ``flat_sum``)."""
    x, lp, table, dom, units, layer = _setup()
    per_ex = table[dom]
    t = jnp.asarray(per_ex)
    want = jattn.meta_transformer_apply(
        jax.tree.map(jnp.asarray, lp), jnp.asarray(x), {"Q": t, "K": t},
        units, mode="QK", head_num=2, train=False)
    pt = torch.from_numpy(per_ex)
    with torch.no_grad():
        got = tattn.meta_transformer_apply(layer, torch.from_numpy(x),
                                           {"Q": pt, "K": pt}, units,
                                           mode="QK", head_num=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dense_select_matches_gather():
    """The two MetaNet branches of domainwise_sum agree."""
    x, lp, table, dom, units, layer = _setup()
    t = torch.from_numpy(table)
    kw = dict(mode="QK", head_num=2, domain_ids=torch.from_numpy(dom))
    with torch.no_grad():
        a = tattn.meta_transformer_apply(layer, torch.from_numpy(x),
                                         {"Q": t, "K": t}, units,
                                         dense_select=True, **kw)
        b = tattn.meta_transformer_apply(layer, torch.from_numpy(x),
                                         {"Q": t, "K": t}, units,
                                         dense_select=False, **kw)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_wrapper_on_cpu_runs_the_plain_version():
    x, lp, table, dom, units, layer = _setup()
    before = tmb.launches
    got = _port(x, layer, table, dom, units, 2, "QK", False,
                tmb.fused_meta_layer)
    want = _port(x, layer, table, dom, units, 2, "QK", False,
                 tmb.meta_layer_reference)
    np.testing.assert_array_equal(got, want)
    assert tmb.launches == before
