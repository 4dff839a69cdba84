"""Three behaviours of the port held against the JAX package where they
once differed from it.

* Layout switches: the dropout masks follow ``SATRANS_PAD_F`` and
  ``SATRANS_ATTN_CAP`` as the JAX kernels read them at trace time (the
  meta-transformer kernel's F padding and attention group; the gate and
  bilinear kernel's fixed padding of 8), bit for bit against the masks
  the JAX package's interpret-mode generator draws; ``SATRANS_STASH``
  raises where the port cannot follow.
* Seeds: ``ops/threefry.py`` equals ``jax.random`` (threefry2x32 in its
  partitionable mode) on keys, splits, fold-ins and ``randint``; the
  model's default per-layer seeds and the Trainer's per-step seeds are
  the JAX package's, so two ``fit`` steps at dropout 0.1 match the JAX
  ``Trainer`` with no seed handed over (losses at rtol 1e-5, every
  parameter at atol 5e-5 / rtol 1e-3, the tolerance of
  tests/test_torch_train.py).
* The logit clamp: with a meta LayerNorm scaled until attention logits
  pass 60, the port's kernel path (its CPU branch, the plain version of
  the kernels) matches the interpret-mode Pallas layer, which clamps to
  [-60, 60], and its unfused path matches the JAX XLA layer, which does
  not, forward and every gradient at rtol 2e-4 / atol 2e-5 (float32 sums
  in another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parity as tp
from satrans_torch import bridge
from satrans_torch.nn import attention as tattn
from satrans_torch.ops import gate_block as tgb
from satrans_torch.ops import meta_block as tmb
from satrans_torch.ops import prng, threefry
from satrans_torch.train import Trainer as TorchTrainer
from satrans_tpu.nn import attention as jattn
from satrans_tpu.ops.pallas import meta_block as jmb
from test_torch_bank_train import _jax_fit
from test_torch_dropout import RATE, _jax_masks
from test_torch_meta_block_grad import (HEADS, TOL, _assert_same,
                                        _jax_grads, _port_grads, _setup)

# the AliCCP tile: F = 19, d = 32, 4 heads, 128 examples
MASK_SHAPE = dict(seed=7, B=128, F=19, d=32, heads=4, block_b=128)


def _check_masks(got, want):
    for key, m in zip("qksz", got):
        if want[key] is None:
            assert m is None, key
        else:
            np.testing.assert_array_equal(m.numpy(), want[key], err_msg=key)


@pytest.mark.parametrize("name,value", [
    ("SATRANS_ATTN_CAP", "64"), ("SATRANS_ATTN_CAP", "128"),
    ("SATRANS_PAD_F", "1"), ("SATRANS_PAD_F", "8"), ("SATRANS_PAD_F", "16"),
])
def test_masks_follow_layout_switches(name, value, monkeypatch):
    monkeypatch.setenv(name, value)
    s = MASK_SHAPE
    want = _jax_masks(s["seed"], s["B"], s["F"], s["d"], s["heads"],
                      s["block_b"], True, True)
    _check_masks(prng.dropout_masks(s["seed"], s["B"], s["F"], s["d"],
                                    s["heads"], s["block_b"], RATE, True,
                                    True), want)


@pytest.mark.parametrize("name,value", [("SATRANS_ATTN_CAP", "64"),
                                        ("SATRANS_PAD_F", "16")])
def test_gate_block_masks_pad_fields_to_eight(name, value, monkeypatch):
    """The gate/bilinear kernel pads F to 8 whatever SATRANS_PAD_F says
    (gate_block.py:382, models/satrans.py:452), and follows the cap."""
    monkeypatch.setenv(name, value)
    s = MASK_SHAPE
    want = _jax_masks(s["seed"], s["B"], s["F"], s["d"], s["heads"],
                      s["block_b"], False, False, pad_mult=8)
    x = torch.zeros(s["B"], s["F"], s["d"])
    _check_masks(tgb.layer_masks(x, head_num=s["heads"], train=True,
                                 drop_rate=RATE, seed=s["seed"],
                                 block_b=s["block_b"]), want)


@pytest.mark.parametrize("value,error,match", [
    ("bf16", NotImplementedError, "ROADMAP"),
    ("f16", ValueError, "unknown stash dtype")])
def test_stash_dtype_switch(value, error, match, monkeypatch):
    x, g, lp, table, dom, units, layer = _setup()
    monkeypatch.setenv("SATRANS_STASH", value)
    t = torch.from_numpy(table)
    with pytest.raises(error, match=match):
        tmb.fused_meta_layer(torch.from_numpy(x), layer, {"Q": t, "K": t},
                             torch.from_numpy(dom), meta_units=units,
                             head_num=HEADS)


# --- seeds ------------------------------------------------------------------

def test_threefry_equals_jax_random():
    """20 keys (seeds over the int32 range), their splits, fold-ins and
    randints, as Python ints and as tensors of all 20 keys at once."""
    assert jax.config.jax_threefry_partitionable  # the twin's mode
    rng = np.random.default_rng(0)
    seeds = [0, 1, -1, 2 ** 31 - 1, -2 ** 31] + rng.integers(
        -2 ** 31, 2 ** 31, 15).tolist()
    bounds = [(0, 2 ** 31 - 1), (0, 10), (-100, 100), (5, 70_000),
              (-2 ** 31, 2 ** 31 - 1)]
    words = []
    for seed in seeds:
        jk, tk = jax.random.PRNGKey(seed), threefry.PRNGKey(seed)
        assert np.asarray(jk).tolist() == list(tk)
        assert np.asarray(jax.random.split(jk, 3)).tolist() == [
            list(k) for k in threefry.split(tk, 3)]
        for data in (0, 5, 2 ** 31 - 1, 2 ** 32 - 1):
            assert np.asarray(jax.random.fold_in(jk, data)).tolist() == list(
                threefry.fold_in(tk, data))
        for lo, hi in bounds:
            assert int(jax.random.randint(jk, (), lo, hi, dtype=jnp.int32)
                       ) == threefry.randint(tk, lo, hi), (seed, lo, hi)
        words.append(tk)
    keys = tuple(torch.tensor(w) for w in zip(*words))
    got = threefry.randint(threefry.fold_in(keys, 3)).tolist()
    assert got == [int(jax.random.randint(
        jax.random.fold_in(jax.random.PRNGKey(s), 3), (), 0, 2 ** 31 - 1,
        dtype=jnp.int32)) for s in seeds]


def test_default_seeds_are_jax_seeds():
    """SATrans's default layer seeds are JAX's ``apply(rng=None)`` ones,
    and the Trainer's first step at seed 1024 draws the JAX Trainer's."""
    _, _, tm = tp.jax_and_port(domain_att_layer_num=3)
    assert tm.default_seeds == [447923887, 390137614, 1055218036]
    tr = TorchTrainer(tm, seed=1024, device="cpu")
    assert tr.step_seeds() == [1221738042, 1791484013, 1856913579]
    key, seeds = jax.random.PRNGKey(1025), []
    for _ in range(3):
        key, sub = jax.random.split(key)
        seeds.append([int(jax.random.randint(jax.random.fold_in(sub, i), (),
                                             0, 2 ** 31 - 1, jnp.int32))
                      for i in range(3)])
    tr = TorchTrainer(tm, seed=1024, device="cpu")
    assert [tr.step_seeds() for _ in range(3)] == seeds


def test_fit_at_dropout_matches_jax_trainer_unaided():
    """Two dense ``fit`` steps at dropout 0.1 (a full batch of 16 and a
    padded tail), each side drawing its own seeds."""
    jm, params, tm = tp.jax_and_port(dropout_rate=RATE)
    jm = dataclasses.replace(jm, use_fused_kernel=True, fused_interpret=True)
    x = tp.request(24, seed=5)
    y = np.random.default_rng(5).integers(0, 2, 24).astype(np.float32)
    j_steps, j_params, _ = _jax_fit(jm, params, x, y, "dense")

    steps = tp.port_fit(tm, x, y, "dense")
    assert len(steps) == 2
    tp.assert_fit_matches(j_steps, j_params, steps, tm)


# --- the logit clamp ------------------------------------------------------

def _hot_setup(factor=6.0):
    """The layer of test_torch_meta_block_grad with its meta LayerNorm
    scaled ``factor`` times, and the share of its attention logits past
    60 in magnitude."""
    x, g, lp, table, dom, units, layer = _setup()
    ln = lp["q_meta"]["ln"]
    lp = dict(lp, q_meta=dict(lp["q_meta"], ln=dict(
        ln, scale=ln["scale"] * np.float32(factor))))
    layer.load_state_dict(bridge.from_jax_params(lp, layer))
    t = torch.from_numpy(table)
    res = {}
    with torch.no_grad():
        tmb.meta_layer_reference(torch.from_numpy(x), layer,
                                 {"Q": t, "K": t}, torch.from_numpy(dom),
                                 meta_units=units, head_num=HEADS,
                                 residuals=res)
        q, k = (tattn._split_heads(layer.q_meta.ln(res[u]), HEADS)
                for u in ("uq", "uk"))
        logits = q @ k.transpose(-1, -2) / np.sqrt(q.shape[-1])
    share = (logits.abs() > 60).double().mean().item()
    return x, g, lp, table, dom, units, layer, share


def test_logits_past_sixty_match_both_jax_paths():
    x, g, lp, table, dom, units, layer, share = _hot_setup()
    assert 0.05 < share < 0.6, share
    onehot = jax.nn.one_hot(jnp.asarray(dom), table.shape[0])

    def pallas(x, lp, table):
        return jmb.fused_meta_layer_vjp(
            x, lp, {"Q": table, "K": table}, onehot, meta_units=units,
            head_num=HEADS, train=True, drop_rate=0.0, bwd="recompute",
            block_b=16, interpret=True)

    def xla(x, lp, table):
        return jattn.meta_transformer_apply(
            lp, x, {"Q": table, "K": table}, units, head_num=HEADS,
            train=False, domain_ids=jnp.asarray(dom), dense_select=True)

    def unfused(*args, **kw):
        return tmb.meta_layer_reference(*args, **kw, clamp=False)

    t = torch.from_numpy(table)
    args = (torch.from_numpy(x), layer, {"Q": t, "K": t},
            torch.from_numpy(dom))
    kw = dict(meta_units=units, head_num=HEADS)
    jargs = (jnp.asarray(x), jax.tree.map(jnp.asarray, lp),
             jnp.asarray(table))
    with torch.no_grad():
        y_kernel = tmb.fused_meta_layer(*args, **kw).numpy()
        np.testing.assert_allclose(y_kernel, np.asarray(pallas(*jargs)),
                                   **TOL)
        y_unfused = unfused(*args, **kw).numpy()
    np.testing.assert_allclose(y_unfused, np.asarray(xla(*jargs)), **TOL)
    assert np.abs(y_kernel - y_unfused).max() > 1e-2  # the clamp acts
    _assert_same(_port_grads(x, g, layer, table, dom, units, "QK", False,
                             tmb.fused_meta_layer),
                 _jax_grads(pallas, x, g, lp, table))
    _assert_same(_port_grads(x, g, layer, table, dom, units, "QK", False,
                             unfused),
                 _jax_grads(xla, x, g, lp, table))
