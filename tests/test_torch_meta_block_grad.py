"""Gradients of the port's meta-transformer layer against the JAX package.

Autograd through ``satrans_torch.ops.meta_block.meta_layer_reference`` (the
plain version of the K1-bwd kernel) is held against ``jax.grad`` of the JAX
XLA layer and of the JAX Pallas layer with its recompute backward
(``bwd='recompute'``, the kernel that K1-bwd replaces) run in interpret
mode, on the same numpy inputs and the same upstream gradient, for every
gradient: x, wq/wk/wv, wout, both LayerNorms and the per-domain table.
rtol 2e-4 / atol 2e-5: float32 sums in another order.
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
HEADS = 2


def _setup(B=16, F=5, d=16, h=32, D=4, seed=0):
    """numpy inputs, upstream gradient and JAX layer params, and the port's
    layer holding the same params.  The LayerNorm params are moved off
    their (1, 0) init so that every gradient term is exercised."""
    rng = np.random.default_rng(seed)
    units = [d, h, d]
    lp = jattn.meta_transformer_init(jax.random.PRNGKey(seed), d, units,
                                     share_kv_metanet=True)
    lp = jax.tree.map(lambda a: np.asarray(a)
                      + (rng.normal(size=a.shape) * 0.1).astype(np.float32),
                      lp)
    x = rng.normal(size=(B, F, d)).astype(np.float32)
    g = rng.normal(size=(B, F, d)).astype(np.float32)
    table = (rng.normal(size=(D, jmetanet.param_size(units))) * 0.1
             ).astype(np.float32)
    dom = rng.integers(0, D, size=B)
    layer = tattn.MetaTransformerLayer(make_generator(0, "cpu"), d)
    layer.load_state_dict(bridge.from_jax_params(lp, layer))
    return x, g, lp, table, dom, units, layer


def _jax_grads(fn, x, g, lp, table):
    """``{name: grad}`` of sum(fn(x, lp, table) * g), keyed like the
    port's parameters ('x', 'table', 'wq', 'ln.scale', ...)."""
    def loss(x, lp, table):
        return jnp.sum(fn(x, lp, table) * g)

    gx, glp, gt = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jax.tree.map(jnp.asarray, lp), jnp.asarray(table))
    out = dict(bridge._flatten(jax.tree.map(np.asarray, glp)))
    out.update(x=np.asarray(gx), table=np.asarray(gt))
    return out


def _port_grads(x, g, layer, table, dom, units, mode, relu_out, fn):
    xt = torch.from_numpy(x).requires_grad_(True)
    tt = torch.from_numpy(table).requires_grad_(True)
    layer.zero_grad(set_to_none=True)
    y = fn(xt, layer, {"Q": tt, "K": tt}, torch.from_numpy(dom),
           meta_units=units, head_num=HEADS, mode=mode, relu_out=relu_out)
    (y * torch.from_numpy(g)).sum().backward()
    out = {name: p.grad.numpy() for name, p in layer.named_parameters()
           if p.grad is not None}
    out.update(x=xt.grad.numpy(), table=tt.grad.numpy())
    return out


def _assert_same(got, want):
    # an unapplied K MetaNet leaves the meta LayerNorm's K share at zero;
    # both sides must agree on which gradients exist
    assert set(got) == set(want), (sorted(got), sorted(want))
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **TOL)


@pytest.mark.parametrize("mode,relu_out", MODES)
def test_grads_match_jax_xla_layer(mode, relu_out):
    x, g, lp, table, dom, units, layer = _setup()

    def fn(x, lp, table):
        return jattn.meta_transformer_apply(
            lp, x, {"Q": table, "K": table}, units, mode=mode,
            head_num=HEADS, relu_out=relu_out, train=False,
            domain_ids=jnp.asarray(dom), dense_select=True)

    want = _jax_grads(fn, x, g, lp, table)
    got = _port_grads(x, g, layer, table, dom, units, mode, relu_out,
                      tmb.meta_layer_reference)
    _assert_same(got, want)


@pytest.mark.parametrize("mode,relu_out", MODES)
def test_grads_match_jax_pallas_recompute_interpret(mode, relu_out):
    x, g, lp, table, dom, units, layer = _setup()
    onehot = jax.nn.one_hot(jnp.asarray(dom), table.shape[0])

    def fn(x, lp, table):
        return jmb.fused_meta_layer_vjp(
            x, lp, {"Q": table, "K": table}, onehot, meta_units=units,
            head_num=HEADS, train=True, drop_rate=0.0, bwd="recompute",
            block_b=16, interpret=True, relu_out=relu_out, mode=mode)

    want = _jax_grads(fn, x, g, lp, table)
    got = _port_grads(x, g, layer, table, dom, units, mode, relu_out,
                      tmb.meta_layer_reference)
    _assert_same(got, want)


def test_autograd_wrapper_on_cpu_runs_the_plain_version():
    """With a gradient needed on a CPU tensor, the wrapper differentiates
    the plain version and launches neither kernel."""
    x, g, lp, table, dom, units, layer = _setup()
    before = (tmb.launches, tmb.bwd_launches)
    got = _port_grads(x, g, layer, table, dom, units, "QK", False,
                      tmb.fused_meta_layer)
    want = _port_grads(x, g, layer, table, dom, units, "QK", False,
                       tmb.meta_layer_reference)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert (tmb.launches, tmb.bwd_launches) == before
