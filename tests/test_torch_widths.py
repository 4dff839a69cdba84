"""The port's layers at the reference CLI's other widths and head counts
against the JAX package's interpret-mode kernels, on the CPU.

The card runs K1, K6 and K7 at every ``(d, heads)`` with d in (8, 16, 32,
64) and 1, 2, 4 or 8 heads (``tests/test_torch_widths_card.py``); here
their plain versions (the CPU paths of ``fused_meta_layer``,
``fused_simple_layer`` and ``fused_tiled_layer``) are held against the
Pallas kernels they replace, run in interpret mode, at a few of those
shapes: B = 32, F = 5 (padded to 8 in the JAX kernels), one layer, on
one dropout tile of 32 (K7: its 2 dispatch tiles of 16), at dropout 0.1
at (8, 8) and (16, 8) and in K7 and at 0 at the others, the output at
rtol 2e-4 / atol 2e-5 and every gradient at rtol 2e-3 / atol 2e-4
(``tests/test_torch_multicol.py``'s
tolerances: float32 sums in another order through a MetaNet or a map of
up to 64 x 64).

* K1 at (8, 8) with MetaNet [8, 16, 8] (head width 1), (16, 4) with
  [16, 32, 32, 16] and (64, 8) with [64, 128, 64], ``bwd='stash'``;
* K6 gate and bilinear at (64, 1) (a 64 x 64 bilinear map a row) and
  (16, 8) (head width 2);
* K7 at (16, 2) on 2 tiles of 16 slots;
* the dropout masks at (16, 8) and (64, 1) against the JAX interpret-mode
  masks bit for bit;
* the kernels' shape rule, pure Python: every shape of the set passes the
  wrappers' checks, a shape outside raises ``NotImplementedError`` naming
  the set.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from satrans_torch import bridge
from satrans_torch.nn import attention as tattn
from satrans_torch.ops import gate_block as tgb
from satrans_torch.ops import meta_block as tmb
from satrans_torch.ops import prng
from satrans_torch.ops import tiled_meta as ttm
from satrans_torch.utils import make_generator
from satrans_tpu.nn import attention as jattn
from satrans_tpu.nn import metanet as jmetanet
from satrans_tpu.ops.pallas import gate_block as jgb
from satrans_tpu.ops.pallas import meta_block as jmb
from satrans_tpu.ops.pallas import tiled_meta as jtm
from test_torch_dropout import _jax_masks

FWD_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
B, F, BLOCK, ROWS = 32, 5, 32, 4
RATE, SEED = 0.1, 2 ** 31 - 2  # seed + tile wraps past int32
DROP = dict(train=True, drop_rate=RATE, seed=SEED, block_b=BLOCK)


def _setup(d, units, variant="metanet", seed=0):
    """numpy inputs and upstream gradient, the JAX layer params moved off
    their init and the port's layer holding them."""
    rng = np.random.default_rng(seed)
    lp = jattn.meta_transformer_init(jax.random.PRNGKey(seed), d, units,
                                     variant=variant)
    lp = jax.tree.map(lambda a: np.asarray(a) + (
        rng.normal(size=a.shape) * 0.1).astype(np.float32), lp)
    x = rng.normal(size=(B, F, d)).astype(np.float32)
    g = rng.normal(size=(B, F, d)).astype(np.float32)
    layer = tattn.MetaTransformerLayer(make_generator(0, "cpu"), d,
                                       variant=variant)
    layer.load_state_dict(bridge.from_jax_params(lp, layer))
    return rng, x, g, lp, layer


def _compare(fn_jax, port, x, g, lp, tables, layer):
    """The JAX function's output and pullback of ``g`` (in one jitted
    call without XLA's backend optimizations: the interpret-mode kernels
    are slow op by op, and they compile in a third of the time) against
    the port's
    output and autograd, every gradient (x, the layer's parameters, the
    tables by name; a table the port does not read is zero in JAX)."""
    def run(x, lp, tables, g):
        y, pullback = jax.vjp(fn_jax, x, lp, tables)
        return y, pullback(g)

    args = (jnp.asarray(x), jax.tree.map(jnp.asarray, lp),
            jax.tree.map(jnp.asarray, tables), jnp.asarray(g))
    y_jax, (gx, glp, gt) = jax.jit(run).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)
    want = dict(bridge._flatten(jax.tree.map(np.asarray, glp)))
    want.update(x=np.asarray(gx))
    want.update({f"table.{k}": np.asarray(v) for k, v in gt.items()})
    xt = torch.from_numpy(x).requires_grad_(True)
    tt = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in tables.items()}
    y = port(xt, layer, tt)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_jax),
                               **FWD_TOL)
    got = {n: np.zeros_like(want[n]) if p.grad is None else p.grad.numpy()
           for n, p in layer.named_parameters()}
    got.update(x=xt.grad.numpy())
    got.update({f"table.{k}": np.zeros_like(tables[k]) if t.grad is None
                else t.grad.numpy() for k, t in tt.items()})
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("d,heads,units,rate", [
    (8, 8, [8, 16, 8], RATE), (16, 4, [16, 32, 32, 16], 0.0),
    (64, 8, [64, 128, 64], 0.0)], ids=["d8h8", "d16h4-3mat", "d64h8"])
def test_k1_plain_layer_matches_jax_interpret_kernel(d, heads, units, rate):
    rng, x, g, lp, layer = _setup(d, units)
    table = (rng.normal(size=(ROWS, jmetanet.param_size(units))) * 0.1
             ).astype(np.float32)
    dom = rng.integers(0, ROWS, size=B)
    onehot = jax.nn.one_hot(jnp.asarray(dom), ROWS)
    kw = dict(meta_units=units, head_num=heads, mode="QK", relu_out=False,
              **dict(DROP, drop_rate=rate))

    def fn(x, lp, tables):
        return jmb.fused_meta_layer_vjp(
            x, lp, {"Q": tables["Q"], "K": tables["Q"]}, onehot,
            interpret=True, bwd="stash", stash_dtype="f32", **kw)

    def port(x, layer, tables):
        return tmb.fused_meta_layer(x, layer, {"Q": tables["Q"],
                                               "K": tables["Q"]},
                                    torch.from_numpy(dom), **kw)

    _compare(fn, port, x, g, lp, {"Q": table}, layer)


@pytest.mark.parametrize("variant", ["gate", "bilinear"])
@pytest.mark.parametrize("d,heads,rate", [(64, 1, 0.0), (16, 8, RATE)],
                         ids=["d64h1", "d16h8"])
def test_k6_plain_layer_matches_jax_interpret_kernel(d, heads, rate,
                                                     variant):
    rng, x, g, lp, layer = _setup(d, [d, 2 * d, d], variant)

    def normal(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    tables = ({"Q": normal(ROWS, d), "K": normal(ROWS, d)}
              if variant == "gate" else
              {"bilinear": normal(ROWS, d * d // heads, scale=0.5)})
    dom = rng.integers(0, ROWS, size=B)
    onehot = jax.nn.one_hot(jnp.asarray(dom), ROWS)
    kw = dict(head_num=heads, mode="QK", relu_out=False,
              **dict(DROP, drop_rate=rate))

    def fn(x, lp, tables):
        return jgb.fused_simple_layer_vjp(x, lp, tables, onehot,
                                          variant=variant, interpret=True,
                                          **kw)

    def port(x, layer, tables):
        return tgb.fused_simple_layer(x, layer, tables,
                                      torch.from_numpy(dom), **kw)

    _compare(fn, port, x, g, lp, tables, layer)


def test_k7_plain_layer_matches_jax_interpret_kernel():
    """2 tiles of 16 slots, the second tile's last 13 slots zero (dispatch
    slack), at (16, 2) with MetaNet [16, 32, 16]."""
    d, heads, units, tile = 16, 2, [16, 32, 16], 16
    rng, x, g, lp, layer = _setup(d, units)
    x[-13:] = 0.0
    table = (rng.normal(size=(B // tile, jmetanet.param_size(units)))
             * 0.3).astype(np.float32)
    kw = dict(meta_units=units, head_num=heads, mode="QK", relu_out=False,
              **dict(DROP, block_b=tile))

    def fn(x, lp, tables):
        return jtm.fused_tiled_layer_vjp(
            x, lp, {"Q": tables["Q"], "K": tables["Q"]}, interpret=True,
            bwd="stash", **kw)

    def port(x, layer, tables):
        return ttm.fused_tiled_layer(x, layer, {"Q": tables["Q"],
                                                "K": tables["Q"]},
                                     bwd="stash", **kw)

    _compare(fn, port, x, g, lp, {"Q": table}, layer)


@pytest.mark.parametrize("d,heads,mode", [(16, 8, "QK"), (64, 1, "Query")])
def test_masks_equal_jax_interpret_masks(d, heads, mode):
    """Two tiles of 32 at F = 5 padded to 8 (two attention groups of 16
    examples a tile)."""
    apply_q, apply_k = "Q" in mode, "K" in mode
    want = _jax_masks(SEED, 64, F, d, heads, 32, apply_q, apply_k)
    got = prng.dropout_masks(SEED, 64, F, d, heads, 32, RATE, apply_q,
                             apply_k)
    for key, m in zip("qksz", got):
        if want[key] is None:
            assert m is None, key
        else:
            np.testing.assert_array_equal(m.numpy(), want[key], err_msg=key)


def test_kernel_shape_rule():
    """Every (d, heads) of the set, with the CLI's MetaNet [d, 2d, d] and
    the 3-matrix [d, 2d, 2d, d], passes the K1, K7 and K6 wrappers'
    checks; a width, a head count or a hidden width outside raises
    NotImplementedError naming the set, before any kernel is built."""
    tables = {"Q": None, "K": None}
    for d in tmb.KERNEL_WIDTHS:
        for heads in tmb.KERNEL_HEADS:
            x = torch.zeros(2, 19, d)
            for units in ([d, 2 * d, d], [d, 2 * d, 2 * d, d]):
                assert (d, *tmb.hidden_widths(units), heads) in \
                    tmb.KERNEL_SHAPES
                tmb._check(x, units, heads, tables, train=False)
                ttm._check(torch.zeros(32, 19, d), units, heads, tables, 16)
            tgb._check(x, heads)
    assert len(tmb.KERNEL_SHAPES) == 32 and len(tgb.KERNEL_SHAPES) == 16
    for d, units, heads in ((24, [24, 48, 24], 4), (32, [32, 32, 32], 4),
                            (32, [32, 64, 32], 16), (128, [128, 256, 128], 4)):
        with pytest.raises(NotImplementedError, match="heads in") as e:
            tmb._check(torch.zeros(2, 19, d), units, heads, tables,
                       train=False)
        assert str(sorted(tmb.KERNEL_SHAPES)) in str(e.value)
    for d, heads in ((24, 4), (32, 16), (128, 8)):
        with pytest.raises(NotImplementedError, match="heads in") as e:
            tgb._check(torch.zeros(2, 19, d), heads)
        assert str(sorted(tgb.KERNEL_SHAPES)) in str(e.value)
    with pytest.raises(NotImplementedError, match="F <= 20"):
        tmb._check(torch.zeros(2, 21, 16), [16, 32, 16], 2, tables,
                   train=False)
