"""The port's dropout against the JAX package's interpret-mode kernels.

The JAX package's CPU dropout is a counter hash (its
``ops/pallas/meta_block.py:94-147``), so the port's masks
(``satrans_torch/ops/prng.py``) can equal its masks bit for bit, and the
layer and two ``Trainer.fit`` steps at ``dropout_rate=0.1`` can be held
against it:

* the masks of every site equal the ones drawn per tile with the JAX
  package's generator, in QK and Query modes, over several tiles, a
  padded F, a seed whose ``seed + tile`` wraps past int32;
* the port's layer (its CPU path: the plain version with those masks)
  against ``fused_meta_layer_vjp(interpret=True, train=True,
  drop_rate=0.1, bwd='stash')``, forward and every gradient, at rtol 2e-4
  / atol 2e-5 (float32 sums in another order, and the Pallas kernel's
  softmax without the max pass against the port's max subtraction);
* two ``fit`` steps (the second a padded tail) in ``dense`` and ``lazy``
  against the JAX ``Trainer`` on its interpret-mode kernels, with the JAX
  Trainer's per-layer seeds fed to the port's: losses at rtol 1e-5, every
  parameter at atol 5e-5 / rtol 1e-3 (tests/test_torch_train.py's
  tolerances);
* the keep share of each site within 0.005 of 0.9 at the AliCCP shape;
* the unported cases raise.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parity as tp
from satrans_torch import bridge
from satrans_torch.ops import meta_block as tmb
from satrans_torch.ops import prng
from satrans_torch.train import Trainer as TorchTrainer
from satrans_tpu.ops.pallas import meta_block as jmb
from test_torch_bank_train import _jax_fit
from test_torch_meta_block_grad import (HEADS, TOL, _assert_same,
                                        _port_grads, _setup)

RATE = 0.1


def _jax_masks(seed, B, F, d, heads, block_b, apply_q, apply_k,
               pad_mult=None):
    """The masks the interpret-mode kernels draw, tile by tile, cut to the
    real rows and fields: ``{site: [B, F, d] or [B, H, F, F]}``.  The
    tile's fields are padded to ``pad_mult``, by default as the JAX
    ``fused_meta_layer_vjp`` reads ``SATRANS_PAD_F`` (meta_block.py:
    1417-1418); the attention group follows ``SATRANS_ATTN_CAP`` inside
    ``_attn_group``."""
    if pad_mult is None:
        pad_mult = int(os.environ.get("SATRANS_PAD_F", "8"))
    fp = F + ((-F) % pad_mult if pad_mult > 1 else 0)
    g = jmb._attn_group(block_b, fp)
    n, rows = g * fp, block_b * fp
    out = {"q": [], "k": [], "s": [], "z": []}
    for tile in range(B // block_b):
        with jmb._interp_prng_scope(True):
            jmb._prng_seed(jnp.int32(seed) + jnp.int32(tile))
            drawn = {"q": jmb._dropout_mask((rows, d), RATE)
                     if apply_q else None,
                     "k": jmb._dropout_mask((rows, d), RATE)
                     if apply_k else None,
                     "s": [jmb._dropout_mask((block_b // g, n, n), RATE)
                           for _ in range(heads)],
                     "z": jmb._dropout_mask((rows, d), RATE)}
        for key in "qkz":
            if drawn[key] is not None:
                m = np.asarray(drawn[key]).reshape(block_b, fp, d)
                out[key].append(m[:, :F])
        # [H, G, g fp, g fp] block-diagonal -> each example's [H, fp, fp]
        s = np.stack([np.asarray(m) for m in drawn["s"]]).reshape(
            heads, block_b // g, g, fp, g, fp)
        diag = np.stack([s[:, :, e, :, e, :] for e in range(g)], axis=2)
        out["s"].append(diag.reshape(heads, block_b, fp, fp)
                        .transpose(1, 0, 2, 3)[:, :, :F, :F])
    return {k: np.concatenate(v) if v else None for k, v in out.items()}


@pytest.mark.parametrize("seed,B,F,d,heads,block_b,mode", [
    (2 ** 31 - 2, 96, 4, 8, 2, 32, "QK"),   # seed + tile wraps past int32
    (123, 96, 4, 8, 2, 32, "Query"),        # K draws nothing: salts move
    (7, 128, 19, 32, 4, 128, "QK"),         # the AliCCP tile: F_pad 24, g 4
])
def test_masks_equal_jax_interpret_masks(seed, B, F, d, heads, block_b,
                                         mode):
    apply_q, apply_k = "Q" in mode, "K" in mode
    want = _jax_masks(seed, B, F, d, heads, block_b, apply_q, apply_k)
    got = prng.dropout_masks(seed, B, F, d, heads, block_b, RATE, apply_q,
                             apply_k)
    for key, m in zip("qksz", got):
        if want[key] is None:
            assert m is None, key
        else:
            assert m.dtype == torch.float32
            np.testing.assert_array_equal(m.numpy(), want[key], err_msg=key)


@pytest.mark.parametrize("mode,relu_out", [("QK", True), ("Query", True)])
def test_layer_matches_jax_stash_kernels_at_dropout(mode, relu_out):
    """B=96 on tiles of 32 (three tiles, two attention groups each), F=4
    padded to 8 in the JAX kernel."""
    x, g, lp, table, dom, units, layer = _setup(B=96, F=4, d=8, h=16)
    seed = 1234
    onehot = jax.nn.one_hot(jnp.asarray(dom), table.shape[0])

    def fn(x, lp, table):
        return jmb.fused_meta_layer_vjp(
            x, lp, {"Q": table, "K": table}, onehot, meta_units=units,
            head_num=HEADS, train=True, drop_rate=RATE, seed=seed,
            block_b=32, interpret=True, bwd="stash", stash_dtype="f32",
            relu_out=relu_out, mode=mode)

    port = functools.partial(tmb.fused_meta_layer, train=True,
                             drop_rate=RATE, seed=seed, block_b=32)
    kw = dict(meta_units=units, head_num=HEADS, mode=mode, relu_out=relu_out)
    args = (torch.from_numpy(x), layer, {"Q": torch.from_numpy(table),
                                         "K": torch.from_numpy(table)},
            torch.from_numpy(dom))
    # the JAX output and its pullback of g in one trace
    y_jax, pullback = jax.vjp(fn, jnp.asarray(x),
                              jax.tree.map(jnp.asarray, lp),
                              jnp.asarray(table))
    gx, glp, gt = pullback(jnp.asarray(g))
    want = dict(bridge._flatten(jax.tree.map(np.asarray, glp)))
    want.update(x=np.asarray(gx), table=np.asarray(gt))
    with torch.no_grad():
        y = port(*args, **kw)
        y0 = tmb.fused_meta_layer(*args, **kw)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), **TOL)
    assert (y - y0).abs().max() > 1e-2  # the dropout moved the output
    _assert_same(_port_grads(x, g, layer, table, dom, units, mode, relu_out,
                             port), want)


def _jax_step_seeds(seed, steps, layers):
    """The per-layer seeds the JAX Trainer's steps draw (trainer.py:616,
    :655; models/satrans.py:448-450)."""
    key = jax.random.PRNGKey(seed + 1)
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append([int(jax.random.randint(jax.random.fold_in(sub, i), (),
                                           0, 2 ** 31 - 1, dtype=jnp.int32))
                    for i in range(layers)])
    return out


@pytest.mark.parametrize("mode", ["dense", "lazy"])
def test_fit_at_dropout_matches_jax_trainer(mode):
    """24 examples at batch 16: a full batch and a padded tail; two
    layers, so each draws its own seed."""
    jm, params, tm = tp.jax_and_port(dropout_rate=RATE)
    jm = dataclasses.replace(jm, use_fused_kernel=True, fused_interpret=True)
    x = tp.request(24, seed=5)
    y = np.random.default_rng(5).integers(0, 2, 24).astype(np.float32)
    j_steps, j_params, _ = _jax_fit(jm, params, x, y, mode)

    seeds = iter(_jax_step_seeds(7, 2, len(tm.layers)))  # _jax_fit's seed
    steps = tp.port_fit(tm, x, y, mode, step_seeds=lambda: next(seeds))
    assert len(steps) == 2
    tp.assert_fit_matches(j_steps, j_params, steps, tm)


def test_keep_share_at_the_aliccp_shape():
    """B=8192, F=19, d=32, 4 heads on tiles of 128: every site keeps
    0.9 of its elements within 0.005."""
    masks = prng.dropout_masks(2024, 8192, 19, 32, 4, 128, RATE, True, True)
    for name, m in zip(("yq", "yk", "s", "z"), masks):
        share = (m > 0).double().mean().item()
        assert abs(share - 0.9) <= 0.005, (name, share)
        assert set(torch.unique(m).tolist()) == {0.0, prng.keep_scale(RATE)}


@pytest.mark.parametrize("case", ["untiled_batch", "stash_light"])
def test_unported_dropout_cases_raise(case, monkeypatch):
    """A batch no dropout tile divides; the light stash in bf16 (the light
    stash itself runs, tests/test_torch_pos.py)."""
    jm, params, tm = tp.jax_and_port(dropout_rate=RATE)
    tr = TorchTrainer(tm, device="cpu").compile()
    x = tp.request(24, seed=5)
    y = np.zeros(24, np.float32)
    if case == "stash_light":
        monkeypatch.setenv("SATRANS_BWD", "stash_light")
        monkeypatch.setenv("SATRANS_STASH", "bf16")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tr.fit(x, y, batch_size=12 if case == "untiled_batch" else 16,
               verbose=0)
