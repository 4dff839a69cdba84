"""The port's CUDA kernels against their plain PyTorch versions on the card:
the layer forward (K1-fwd) and both stash forwards (K1-stash and K1-stash
light, with their residuals) against ``meta_layer_reference``, all four
forward modes of the tile body on forced grids of 1, 3 and 7 blocks;
K1-scores
(the probes' forward) against it in float64 and bit for bit against
K1-stash's probabilities; the three
layer backwards (K1-bwd, K1-bwd-stash and K1-bwd-stash light) against
autograd of it, each without and with dropout (the same masks on both
sides), with logits past the clamp and, as the 'pos' model has them, with
distinct Q and K tables and a ``k_meta`` LayerNorm; K1-bwd-stash light
against K1-bwd-stash on the same residuals; the gate
and bilinear layer (K6-fwd, K6-bwd) against ``simple_layer_reference``
and its autograd, K6-bwd's tile body also on domain mixes (one row, rows
alternating example by example, 16 rows) and forced grids of 1, 3 and 7
blocks, K6-fwd's tile body on forced grids (bit for bit the card's
grid's y) and at the edges of its tiles (B from 0 to 512, F = 1, 15 and
20, 1, 4 and 64 table rows); the tiled layer on a slack-heavy dispatch
(K7-fwd and K7-stash with its residuals, K7-bwd and K7-bwd-stash with
the per-tile gradient blocks) against ``tiled_layer_reference`` and its
autograd, and K7-bwd-stash against K7-bwd on the same masks; K7-fwd's
and K7-stash's tile body with the plan's ``tile_count`` against every
slot (bit for bit on the occupied slots, zeros on the slack ones),
K7-fwd's y against K7-stash's bit for bit, both on forced grids, and
K7-stash's residuals fed to K7-bwd-stash against K7-bwd; the K7
backwards' tile body with the plan's ``tile_count`` (slack slots skipped) at F = 15, on
dispatch tiles of 16, with every occupied tile full and with one domain,
on forced grids of 1, 3 and 7 blocks (dispatch tiles split between
blocks; a second launch bit for bit), and against every slot computed
(dx zero on the slack slots); the tile bodies of
K1-stash and K1-bwd-stash on domain mixes (all in one row, one example a
row, skewed, out-of-range ids) and batches from 1 to 8192, with their
light twins, K1-scores and K1-fwd (each y bit for bit K1-stash's), K1-bwd
(the recompute mode of the same body) and a second launch bit for bit;
K1-bwd against K1-bwd-stash on the same masks, and on forced grids of 1, 3
and 7 blocks; each K1 and K7 case with
2-matrix MetaNets [32, 64, 32] and with 3-matrix ones [32, 64, 64, 32]
(the middle matrix in every body, its gradient in the tables' middle
block); the row kernels of the sparse bank updates (K2 scatter, K3
equality combine, K4 gather, K5 lazy Adam tail) against theirs, K3 also at
the bench's shape (a tail's run of zero ids, a field of one id, one
without duplicates, W = 200) on one grouping block a field and the
card's share, and past a block's shared memory; and the
row-DMA probes' bulk-copy kernels (P1 scatter, P2 gather) against
``index_copy_`` and ``index_select``.

Every test here needs an NVIDIA GPU and skips itself elsewhere.  The file
imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels.py
"""

import copy

import pytest
import torch

from satrans_torch.nn import attention, initializers as init, metanet
from satrans_torch.ops import (dispatch, gate_block, meta_block, prng,
                                tiled_meta)
from satrans_torch.utils import make_generator

MODES = [("QK", False), ("QK", True), ("Query", False), ("Query", True)]
# dropout on tiles of 16 examples: several tiles and a ragged last one
DROP = dict(seed=2 ** 31 - 3, block_b=16)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


COUNTS = ("launches", "stash_launches", "stash_light_launches",
          "bwd_launches", "stash_bwd_launches", "stash_light_bwd_launches")
# the launches of each backward's pair: (K1-fwd, K1-stash, K1-stash light,
# K1-bwd, K1-bwd-stash, K1-bwd-stash light)
PAIR = {"recompute": [1, 0, 0, 1, 0, 0], "stash": [0, 1, 0, 0, 1, 0],
        "stash_light": [0, 0, 1, 0, 0, 1]}


def _counts():
    return [getattr(meta_block, c) for c in COUNTS]


# the MetaNet units of the kernel shapes: 2 matrices, and 3 matrices (the
# middle one 64 x 64)
UNITS2, UNITS3 = [32, 64, 32], [32, 64, 64, 32]


def _layer(card, seed, units=UNITS2):
    """A layer with its meta LayerNorm moved off its (1, 0) init, and a
    4-row table of MetaNets of ``units``."""
    gen = make_generator(seed, card)
    d = 32
    layer = attention.MetaTransformerLayer(gen, d)
    with torch.no_grad():
        layer.q_meta.ln.scale.add_(init.normal(gen, (d,), 0.1))
        layer.q_meta.ln.bias.add_(init.normal(gen, (d,), 0.1))
    return gen, layer, init.normal(gen, (4, metanet.param_size(units)), 0.1)


def _pos_layer(card, seed, units=UNITS2):
    """A 'pos' layer (its q_meta and k_meta LayerNorms moved off their
    init, each its own way) and distinct 4-row Q and K tables of MetaNets
    of ``units``."""
    gen = make_generator(seed, card)
    d = 32
    layer = attention.MetaTransformerLayer(gen, d, share_kv_metanet=False)
    with torch.no_grad():
        for meta in (layer.q_meta, layer.k_meta):
            meta.ln.scale.add_(init.normal(gen, (d,), 0.1))
            meta.ln.bias.add_(init.normal(gen, (d,), 0.1))
    p = metanet.param_size(units)
    return gen, layer, {"Q": init.normal(gen, (4, p), 0.1),
                        "K": init.normal(gen, (4, p), 0.1)}


@pytest.mark.cuda
@pytest.mark.parametrize("units", [UNITS2, UNITS3],
                         ids=["2-matrix", "3-matrix"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("mode,relu_out", MODES)
@pytest.mark.parametrize("F", [19, 7])
def test_meta_block_kernel_matches_plain_version(card, units,
                                                 mode, relu_out, F,
                                                 rate):
    """A ragged batch (33 examples end in a part of a tile of the forward
    tile body at either F); at rate 0.1 in training without a gradient,
    K1-fwd with its dropout.  atol 1e-4 / rtol 1e-4: float32 with other
    summation orders, and expf/rsqrtf against torch's exp/rsqrt, on
    LayerNormed outputs of order 1."""
    gen, layer, table = _layer(card, 0, units)
    x = init.normal(gen, (33, F, 32), 1.0)
    dom = torch.randint(0, 4, (33,), generator=gen, device=card)
    kw = dict(meta_units=units, head_num=4, mode=mode,
              relu_out=relu_out)
    drop = dict(train=True, drop_rate=rate, **DROP)
    before = (meta_block.launches, meta_block.stash_launches)
    with torch.no_grad():
        got = meta_block.fused_meta_layer(x, layer, {"Q": table, "K": table},
                                          dom, **kw, **drop)
        want = meta_block.meta_layer_reference(
            x, layer, {"Q": table, "K": table}, dom, **kw,
            masks=meta_block.layer_masks(x, head_num=4, mode=mode, **drop))
    torch.cuda.synchronize()
    # without a gradient the layer never stashes
    assert (meta_block.launches, meta_block.stash_launches) == (
        before[0] + 1, before[1])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("units", [UNITS2, UNITS3],
                         ids=["2-matrix", "3-matrix"])
@pytest.mark.parametrize("stash", ["full", "light"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("mode,relu_out", MODES)
def test_stash_kernel_residuals_match_plain_version(card, units,
                                                    mode, relu_out,
                                                    rate, stash):
    """K1-stash's output and each residual (qkv, the pre-LN sums, the
    probabilities before dropout, the attention output), or K1-stash
    light's (all but the probabilities), against the plain version's, at
    the tolerance of the forward test."""
    gen, layer, table = _layer(card, 2, units)
    x = init.normal(gen, (33, 19, 32), 1.0)
    dom = torch.randint(0, 4, (33,), generator=gen, device=card)
    kw = dict(meta_units=units, head_num=4, mode=mode,
              relu_out=relu_out)
    drop = dict(train=True, drop_rate=rate, **DROP)
    tables = {"Q": table, "K": table}
    ops, cfg = meta_block.pack_operands(x, layer, tables, dom, **kw)
    before = _counts()
    with torch.no_grad():
        got = meta_block.launch_fwd(*ops, cfg, prng.kernel_args(
            True, rate, DROP["seed"], DROP["block_b"], 19), stash=stash)
        res = {}
        y = meta_block.meta_layer_reference(
            x, layer, tables, dom, **kw, residuals=res,
            masks=meta_block.layer_masks(x, head_num=4, mode=mode, **drop))
    torch.cuda.synchronize()
    pair = PAIR["stash" if stash == "full" else "stash_light"]
    assert [a - b for a, b in zip(_counts(), before)] == pair[:3] + [0] * 3
    names = meta_block.STASH_RESIDUALS[stash]
    assert len(got) == 1 + len(names)
    for name, g, w in zip(("y", *names), got,
                          (y, *(res[k] for k in names))):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("units", [UNITS2, UNITS3],
                         ids=["2-matrix", "3-matrix"])
@pytest.mark.parametrize("B", [8192, 32768])
@pytest.mark.parametrize("F", [15, 19])
@pytest.mark.parametrize("pos", [False, True])
@pytest.mark.parametrize("mode,relu_out", MODES)
def test_scores_kernel_matches_float64_plain_version(card, units,
                                                     mode, relu_out,
                                                     pos, F, B):
    """K1-scores at the probes' batches (the CLI's test batch is 32,768)
    and the AliCCP and Alimama fields, shared or distinct ('pos') Q and K
    tables: the output within the forward tolerance of the float64 plain
    layer, the probabilities within 1e-6 of its clamped ones and each row
    summing to 1 within 1e-5, one K1-scores launch and no other; the
    probabilities equal K1-stash's ``s`` bit for bit."""
    if pos:
        gen, layer, tables = _pos_layer(card, 7, units)
    else:
        gen, layer, table = _layer(card, 8, units)
        tables = {"Q": table, "K": table}
    x = init.normal(gen, (B, F, 32), 1.0)
    dom = torch.randint(0, 4, (B,), generator=gen, device=card)
    kw = dict(meta_units=units, head_num=4, mode=mode,
              relu_out=relu_out)
    before = _counts() + [meta_block.scores_launches]
    with torch.no_grad():
        y, s = meta_block.fused_meta_layer_with_scores(x, layer, tables, dom,
                                                       **kw)
        torch.cuda.synchronize()
        assert [a - b for a, b in zip(
            _counts() + [meta_block.scores_launches], before)] == \
            [0] * 6 + [1]
        ops, cfg = meta_block.pack_operands(x, layer, tables, dom, **kw)
        stash = meta_block.launch_fwd(*ops, cfg, prng.kernel_args(
            False, 0.0, 0, 128, F), stash="full")
        res = {}
        want = meta_block.meta_layer_reference(
            x.double(), copy.deepcopy(layer).double(), {
                k: t.double() for k, t in tables.items()}, dom, **kw,
            residuals=res)
    torch.cuda.synchronize()
    assert s.shape == (B, 4, F, F) and s.dtype == torch.float32
    torch.testing.assert_close(y.double(), want, rtol=1e-4, atol=1e-4)
    err = (s.double() - res["s"]).abs().max().item()
    assert err <= 1e-6, err
    torch.testing.assert_close(s.sum(-1), torch.ones_like(s[..., 0]),
                               rtol=0, atol=1e-5)
    assert torch.equal(s, stash[4])


@pytest.mark.cuda
@pytest.mark.parametrize("units", [UNITS2, UNITS3],
                         ids=["2-matrix", "3-matrix"])
def test_scores_kernel_equals_stash_at_dropout(card, units):
    """In training at dropout 0.1 with the same seed, K1-scores' ``s`` is
    K1-stash's ``s`` (the probabilities before the attention dropout, after
    the MetaNets' dropout) bit for bit."""
    gen, layer, table = _layer(card, 9, units)
    tables = {"Q": table, "K": table}
    x = init.normal(gen, (8192, 19, 32), 1.0)
    dom = torch.randint(0, 4, (8192,), generator=gen, device=card)
    kw = dict(meta_units=units, head_num=4, mode="QK")
    drop = dict(train=True, drop_rate=0.1, seed=DROP["seed"], block_b=128)
    with torch.no_grad():
        y, s = meta_block.fused_meta_layer_with_scores(x, layer, tables, dom,
                                                       **kw, **drop)
        ops, cfg = meta_block.pack_operands(x, layer, tables, dom, **kw)
        stash = meta_block.launch_fwd(*ops, cfg, prng.kernel_args(
            True, 0.1, DROP["seed"], 128, 19), stash="full")
    torch.cuda.synchronize()
    assert torch.equal(s, stash[4]) and torch.equal(y, stash[0])


def _hidden_inputs(res, tables, dom, kw):
    """The relu inputs of the applied MetaNets' hidden layers (every
    hidden layer of a 3-matrix MetaNet), from the plain layer's
    residuals."""
    d = res["o"].shape[-1]
    pre = []
    for i, p in enumerate("QK"):
        if p not in kw["mode"]:
            continue
        h = res["qkv"][..., i * d:(i + 1) * d]
        for w in metanet.slice_weights(tables[p], kw["meta_units"])[:-1]:
            h = torch.einsum("bfi,bio->bfo", h, w[dom.long()])
            pre.append(h)
            h = torch.relu(h)
    return pre


def _kink_free(g, x, layer, tables, dom, masks, **kw):
    """``g`` with zero rows for the examples whose relu inputs (the
    MetaNet hidden layers, and the output projection under relu_out) lie
    within 1e-6 of 0 in the float64 plain layer: float32 rounding may put
    such an input on either side of the kink, where the gradient jumps,
    and the kernel and the plain version would then differ by the jump."""
    res = {}
    with torch.no_grad():
        meta_block.meta_layer_reference(x, layer, tables, dom, **kw,
                                        masks=masks, residuals=res)
        pre = _hidden_inputs(res, tables, dom, kw)
        if kw["relu_out"]:
            pre.append(res["o"] @ layer.wout)
        near = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
        for t in pre:
            near |= (t.abs() < 1e-6).flatten(1).any(1)
    return g.masked_fill(near[:, None, None], 0.0)


def _grads(fn, x, layer, table, dom, g, **kw):
    """Gradients of sum(fn(...) * g) w.r.t. x, the layer's parameters and
    the table."""
    x = x.detach().requires_grad_(True)
    table = table.detach().requires_grad_(True)
    params = dict(layer.named_parameters())
    y = fn(x, layer, {"Q": table, "K": table}, dom, **kw)
    got = torch.autograd.grad((y * g).sum(),
                              [x, table, *params.values()],
                              allow_unused=True)
    names = ["x", "table", *params]
    return {n: gr for n, gr in zip(names, got) if gr is not None}


@pytest.mark.cuda
@pytest.mark.parametrize("units", [UNITS2, UNITS3],
                         ids=["2-matrix", "3-matrix"])
@pytest.mark.parametrize("bwd", ["stash", "stash_light", "recompute"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("mode,relu_out", MODES)
@pytest.mark.parametrize("B,F", [(33, 7), (33, 19), (8192, 19)])
def test_meta_block_bwd_kernel_matches_plain_backward(card, units,
                                                      mode, relu_out,
                                                      B, F, rate, bwd):
    """K1-bwd-stash (with K1-stash), K1-bwd-stash light (with K1-stash
    light) and K1-bwd (with K1-fwd), through the autograd wrapper, against
    autograd of the plain layer with the same
    masks, at a small ragged batch and at the full AliCCP sota shape.  The
    plain layer runs in float64, and examples with a relu input at its
    kink get no upstream gradient (:func:`_kink_free`), so that the
    comparison holds the kernel's float32 sums alone.  Each gradient
    within 1e-4 of the plain one relative to the largest entry of that
    gradient (plus 1e-5): the parameter gradients are sums over up to
    B * F = 155,648 rows taken in another order."""
    gen, layer, table = _layer(card, 1, units)
    x = init.normal(gen, (B, F, 32), 1.0)
    g = init.normal(gen, (B, F, 32), 1.0)
    dom = torch.randint(0, 4, (B,), generator=gen, device=card)
    kw = dict(meta_units=units, head_num=4, mode=mode,
              relu_out=relu_out)
    drop = dict(train=True, drop_rate=rate, **DROP)
    masks = meta_block.layer_masks(x, head_num=4, mode=mode, **drop)
    masks64 = masks and tuple(None if m is None else m.double()
                              for m in masks)
    layer64 = copy.deepcopy(layer).double()
    g = _kink_free(g.double(), x.double(), layer64,
                   {"Q": table.double(), "K": table.double()}, dom, masks64,
                   **kw)
    before = _counts()
    got = _grads(meta_block.fused_meta_layer, x, layer, table, dom,
                 g.float(), **kw, **drop, bwd=bwd)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_counts(), before)] == PAIR[bwd]
    want = _grads(meta_block.meta_layer_reference, x.double(), layer64,
                  table.double(), dom, g, **kw, masks=masks64)
    assert set(got) == set(want)
    for name, w in want.items():
        err = (got[name].double() - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item() + 1e-5, (name, err)
    if len(units) == 4:  # the middle matrices' block of the table
        n1 = units[0] * units[1]
        assert got["table"][:, n1:n1 + units[1] * units[2]].abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("units", [UNITS2, UNITS3],
                         ids=["2-matrix", "3-matrix"])
@pytest.mark.parametrize("bwd", ["stash", "stash_light", "recompute"])
def test_meta_block_kernels_clamp_logits(card, units, bwd):
    """With the meta LayerNorm scaled 6 times, a share of the attention
    logits passes 60: both K1 forwards and both backwards against the
    clamped plain layer in float64 (the clamp's gradient passes straight
    through), at the tolerances above; the unclamped plain layer differs."""
    gen, layer, table = _layer(card, 3, units)
    with torch.no_grad():
        layer.q_meta.ln.scale.mul_(6.0)
    B, F = 257, 19
    x = init.normal(gen, (B, F, 32), 1.0)
    g = init.normal(gen, (B, F, 32), 1.0)
    dom = torch.randint(0, 4, (B,), generator=gen, device=card)
    kw = dict(meta_units=units, head_num=4, mode="QK",
              relu_out=False)
    layer64 = copy.deepcopy(layer).double()
    g = _kink_free(g.double(), x.double(), layer64,
                   {"Q": table.double(), "K": table.double()}, dom, None,
                   **kw)
    with torch.no_grad():
        y = meta_block.fused_meta_layer(x, layer, {"Q": table, "K": table},
                                        dom, **kw)
        args = (x.double(), layer64, {"Q": table.double(),
                                      "K": table.double()}, dom)
        want = meta_block.meta_layer_reference(*args, **kw)
        free = meta_block.meta_layer_reference(*args, **kw, clamp=False)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.double(), want, rtol=1e-4, atol=1e-4)
    assert (want - free).abs().max().item() > 1e-2
    got = _grads(meta_block.fused_meta_layer, x, layer, table, dom,
                 g.float(), **kw, train=True, bwd=bwd)
    want = _grads(meta_block.meta_layer_reference, x.double(), layer64,
                  table.double(), dom, g, **kw)
    for name, w in want.items():
        err = (got[name].double() - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item() + 1e-5, (name, err)


def _pos_grads(fn, x, layer, tables, dom, g, **kw):
    """Gradients of sum(fn(...) * g) by name: x, both tables, the layer's
    parameters (v_meta, never applied, has none)."""
    x = x.detach().requires_grad_(True)
    tables = {k: t.detach().requires_grad_(True) for k, t in tables.items()}
    params = dict(layer.named_parameters())
    y = fn(x, layer, tables, dom, **kw)
    names = ["x", "table.Q", "table.K", *params]
    got = torch.autograd.grad((y * g).sum(),
                              [x, tables["Q"], tables["K"], *params.values()],
                              allow_unused=True)
    return {n: gr for n, gr in zip(names, got) if gr is not None}


@pytest.mark.cuda
@pytest.mark.parametrize("units", [UNITS2, UNITS3],
                         ids=["2-matrix", "3-matrix"])
@pytest.mark.parametrize("bwd", ["stash", "stash_light", "recompute"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B", [33, 8190])
def test_pos_layer_kernels_match_plain_version(card, units, B, rate, bwd):
    """The 'pos' layer at Alimama's F = 15: distinct Q and K tables and a
    k_meta LayerNorm of its own.  K1-fwd without a gradient, then each
    kernel pair through the autograd wrapper, against the plain layer in
    float64 with the same masks, at the tolerances above; the dQ and dK
    tables differ and v_meta gets no gradient."""
    gen, layer, tables = _pos_layer(card, 6, units)
    F = 15
    x = init.normal(gen, (B, F, 32), 1.0)
    g = init.normal(gen, (B, F, 32), 1.0)
    dom = torch.randint(0, 4, (B,), generator=gen, device=card)
    kw = dict(meta_units=units, head_num=4, mode="QK",
              relu_out=False)
    drop = dict(train=True, drop_rate=rate, **DROP)
    masks = meta_block.layer_masks(x, head_num=4, mode="QK", **drop)
    masks64 = masks and tuple(None if m is None else m.double()
                              for m in masks)
    layer64 = copy.deepcopy(layer).double()
    tables64 = {k: t.double() for k, t in tables.items()}
    g = _kink_free(g.double(), x.double(), layer64, tables64, dom, masks64,
                   **kw)
    before = _counts()
    with torch.no_grad():
        y = meta_block.fused_meta_layer(x, layer, tables, dom, **kw, **drop)
        want = meta_block.meta_layer_reference(x.double(), layer64,
                                               tables64, dom, **kw,
                                               masks=masks64)
    torch.testing.assert_close(y.double(), want, rtol=1e-4, atol=1e-4)
    got = _pos_grads(meta_block.fused_meta_layer, x, layer, tables, dom,
                     g.float(), **kw, **drop, bwd=bwd)
    torch.cuda.synchronize()
    pair = PAIR[bwd]
    assert [a - b for a, b in zip(_counts(), before)] == [
        pair[0] + 1] + pair[1:]
    want = _pos_grads(meta_block.meta_layer_reference, x.double(), layer64,
                      tables64, dom, g, **kw, masks=masks64)
    assert set(got) == set(want)
    assert not any(n.startswith("v_meta") for n in got)
    for name, w in want.items():
        err = (got[name].double() - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item() + 1e-5, (name, err)
    assert not torch.allclose(got["table.Q"], got["table.K"])


@pytest.mark.cuda
@pytest.mark.parametrize("units", [UNITS2, UNITS3],
                         ids=["2-matrix", "3-matrix"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_stash_light_backward_equals_stash_backward(card, units, rate):
    """K1-bwd-stash light on K1-stash's residuals less the probabilities
    against K1-bwd-stash on all of them: the light body recomputes the
    probabilities with the forward's device code, so every gradient is
    expected bit for bit; each within 1e-6 of its largest entry."""
    gen, layer, tables = _pos_layer(card, 7, units)
    B, F = 8190, 15
    x = init.normal(gen, (B, F, 32), 1.0)
    g = init.normal(gen, (B, F, 32), 1.0)
    dom = torch.randint(0, 4, (B,), generator=gen, device=card)
    ops, cfg = meta_block.pack_operands(x, layer, tables, dom,
                                        meta_units=units, head_num=4)
    ops = [t if t is None else t.detach() for t in ops]
    kargs = prng.kernel_args(True, rate, DROP["seed"], DROP["block_b"], F)
    with torch.no_grad():
        y, qkv, uq, uk, s, o = meta_block.launch_fwd(*ops, cfg, kargs,
                                                     stash="full")
        y_light, *light = meta_block.launch_fwd(*ops, cfg, kargs,
                                                stash="light")
        full = meta_block.launch_bwd(g, *ops, cfg, kargs,
                                     res=(qkv, uq, uk, s, o))
        part = meta_block.launch_bwd(g, *ops, cfg, kargs,
                                     res=(qkv, uq, uk, o))
    torch.cuda.synchronize()
    assert torch.equal(y, y_light)
    for a, b in zip((qkv, uq, uk, o), light):
        assert torch.equal(a, b)
    for i, (a, b) in enumerate(zip(part, full)):
        if b is None:  # no middle matrix
            assert a is None
            continue
        err = (a - b).abs().max().item()
        assert err <= 1e-6 * b.abs().max().item(), (i, err)


# --- the tile bodies of K1-stash and K1-bwd-stash -------------------------

# domain mixes of a batch: every example's row drawn from 4; all in one
# row; 16 rows with one example each (B = 16); 90 / 5 / 5 % over rows 0-2;
# ids from -3 to 7 over 4 rows (the kernels clamp them)
MIXES = {"random": 4, "one": 4, "each": 16, "skewed": 4, "outside": 4}


def _mix(kind, B, gen, card):
    if kind == "random":
        return torch.randint(0, 4, (B,), generator=gen, device=card)
    if kind == "one":
        return torch.full((B,), 2, dtype=torch.long, device=card)
    if kind == "each":
        return torch.randperm(B, generator=gen, device=card)
    if kind == "skewed":
        u = torch.rand(B, generator=gen, device=card)
        return (u >= 0.9).long() + (u >= 0.95).long()
    return torch.randint(-3, 8, (B,), generator=gen, device=card)


def _tile_layer(card, seed, units, distinct, rows):
    """A layer with its meta LayerNorms moved off their init and ``rows``
    rows of MetaNets: one table for Q and K, or distinct ones and a k_meta
    LayerNorm (the 'pos' layer)."""
    gen = make_generator(seed, card)
    layer = attention.MetaTransformerLayer(gen, 32,
                                           share_kv_metanet=not distinct)
    with torch.no_grad():
        for meta in (layer.q_meta, layer.k_meta) if distinct else \
                (layer.q_meta,):
            meta.ln.scale.add_(init.normal(gen, (32,), 0.1))
            meta.ln.bias.add_(init.normal(gen, (32,), 0.1))
    p = metanet.param_size(units)
    if distinct:
        return gen, layer, {k: init.normal(gen, (rows, p), 0.1)
                            for k in "QK"}
    table = init.normal(gen, (rows, p), 0.1)
    return gen, layer, {"Q": table, "K": table}


def _named_grads(fn, x, layer, tables, dom, g, **kw):
    """Gradients of sum(fn(...) * g) by name: x, the tables ('table' where
    Q and K share one, else 'table.Q' and 'table.K') and the layer's
    parameters."""
    x = x.detach().requires_grad_(True)
    if tables["K"] is tables["Q"]:
        named = {"table": tables["Q"].detach().requires_grad_(True)}
        tabs = {"Q": named["table"], "K": named["table"]}
    else:
        named = {f"table.{k}": tables[k].detach().requires_grad_(True)
                 for k in "QK"}
        tabs = {k: named[f"table.{k}"] for k in "QK"}
    params = dict(layer.named_parameters())
    y = fn(x, layer, tabs, dom, **kw)
    got = torch.autograd.grad((y * g).sum(),
                              [x, *named.values(), *params.values()],
                              allow_unused=True)
    return {n: gr for n, gr in zip(["x", *named, *params], got)
            if gr is not None}


@pytest.mark.cuda
@pytest.mark.parametrize("units", [UNITS2, UNITS3],
                         ids=["2-matrix", "3-matrix"])
@pytest.mark.parametrize("F", [19, 15])
@pytest.mark.parametrize("mode,relu_out,distinct",
                         [("QK", False, False), ("Query", True, True)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,mix", [(1, "random"), (3, "outside"),
                                   (16, "each"), (5000, "skewed"),
                                   (8192, "random"), (8192, "one")])
def test_tile_bodies_match_plain_version(card, units, F, mode, relu_out,
                                         distinct, rate, B, mix):
    """The tile bodies (csrc/meta_stash_fwd.cuh, csrc/meta_stash_bwd.cuh)
    against the float64 plain layer on the domain mixes above: K1-stash's
    output and residuals within 1e-4 (chip_smoke's KERNEL_TOL), K1-stash
    light's equal to them, K1-scores' y and s and K1-fwd's y equal to
    K1-stash's bit for bit; the gradients of K1-bwd-stash, K1-bwd-stash
    light and K1-bwd (the recompute mode of the same body) through the
    autograd wrapper within 1e-4 of each gradient's largest entry plus
    1e-5 (GRAD_RTOL, GRAD_ATOL); the light backward within 1e-6 of the
    full one on the same residuals (STASH_LIGHT_RTOL); a second launch of
    each body on the same inputs gives the same bits."""
    gen, layer, tables = _tile_layer(card, 11, units, distinct, MIXES[mix])
    x = init.normal(gen, (B, F, 32), 1.0)
    g = init.normal(gen, (B, F, 32), 1.0)
    dom = _mix(mix, B, gen, card)
    ref_dom = dom.clamp(0, MIXES[mix] - 1)
    kw = dict(meta_units=units, head_num=4, mode=mode, relu_out=relu_out)
    drop = dict(train=True, drop_rate=rate, **DROP)
    masks = meta_block.layer_masks(x, head_num=4, mode=mode, **drop)
    masks64 = masks and tuple(None if m is None else m.double()
                              for m in masks)
    layer64 = copy.deepcopy(layer).double()
    tables64 = {k: t.double() for k, t in tables.items()}
    if not distinct:
        tables64["K"] = tables64["Q"]
    res64 = {}
    with torch.no_grad():
        want = meta_block.meta_layer_reference(
            x.double(), layer64, tables64, ref_dom, **kw, masks=masks64,
            residuals=res64)
    ops, cfg = meta_block.pack_operands(x, layer, tables, dom, **kw)
    ops = [t if t is None else t.detach() for t in ops]
    kargs = prng.kernel_args(True, rate, DROP["seed"], DROP["block_b"], F)
    with torch.no_grad():
        full = meta_block.launch_fwd(*ops, cfg, kargs, stash="full")
        again = meta_block.launch_fwd(*ops, cfg, kargs, stash="full")
        light = meta_block.launch_fwd(*ops, cfg, kargs, stash="light")
        scores = meta_block.launch_fwd(*ops, cfg, kargs, stash="scores")
        fwd = meta_block.launch_fwd(*ops, cfg, kargs)
        fwd_again = meta_block.launch_fwd(*ops, cfg, kargs)
    torch.cuda.synchronize()
    names = ("y", "qkv", "uq", "uk", "s", "o")
    for name, got, a in zip(names, full, again):
        w = want if name == "y" else res64[name]
        torch.testing.assert_close(got.double(), w, rtol=1e-4, atol=1e-4,
                                   msg=name)
        assert torch.equal(got, a), name
    for got, i in zip(light, (0, 1, 2, 3, 5)):
        assert torch.equal(got, full[i]), names[i]
    assert torch.equal(scores[0], full[0]) and torch.equal(scores[1], full[4])
    # K1-fwd, the no-stash mode of the same body: K1-stash's y bit for bit
    assert torch.equal(fwd, full[0]) and torch.equal(fwd, fwd_again)

    g = _kink_free(g.double(), x.double(), layer64, tables64, ref_dom,
                   masks64, **kw).float()
    with torch.no_grad():
        bwd_full = meta_block.launch_bwd(g, *ops, cfg, kargs,
                                         res=tuple(full[1:]))
        bwd_again = meta_block.launch_bwd(g, *ops, cfg, kargs,
                                          res=tuple(full[1:]))
        bwd_light = meta_block.launch_bwd(
            g, *ops, cfg, kargs, res=tuple(full[i] for i in (1, 2, 3, 5)))
        bwd_rec = meta_block.launch_bwd(g, *ops, cfg, kargs)
        bwd_rec_again = meta_block.launch_bwd(g, *ops, cfg, kargs)
    torch.cuda.synchronize()
    for a, b, c, r, r2 in zip(bwd_full, bwd_again, bwd_light, bwd_rec,
                              bwd_rec_again):
        if a is None:  # no middle matrix
            assert r is None
            continue
        assert torch.equal(a, b) and torch.equal(r, r2)
        assert (c - a).abs().max().item() <= 1e-6 * a.abs().max().item()
    want_g = _named_grads(meta_block.meta_layer_reference, x.double(),
                          layer64, tables64, ref_dom, g.double(), **kw,
                          masks=masks64)
    for bwd in ("stash", "stash_light", "recompute"):
        got = _named_grads(meta_block.fused_meta_layer, x, layer, tables,
                           dom, g, **kw, **drop, bwd=bwd)
        torch.cuda.synchronize()
        assert set(got) == set(want_g)
        for name, w in want_g.items():
            err = (got[name].double() - w).abs().max().item()
            assert err <= 1e-4 * w.abs().max().item() + 1e-5, (bwd, name,
                                                               err)


# --- K6, the gate and bilinear layer ------------------------------------

GATE_CASES = [("gate", "QK", False), ("gate", "Query", True),
              ("bilinear", "QK", False), ("bilinear", "QK", True)]


def _gate_layer(card, variant, seed):
    """A gate or bilinear layer and its 4-row tables (distinct Q and K
    gates)."""
    gen = make_generator(seed, card)
    layer = attention.MetaTransformerLayer(gen, 32, variant=variant)
    names = ("Q", "K") if variant == "gate" else ("bilinear",)
    width = 32 if variant == "gate" else 32 * 8
    return gen, layer, {n: init.normal(gen, (4, width), 0.5)
                        for n in names}


def _gate_grads(fn, x, layer, tables, dom, g, **kw):
    """Gradients of sum(fn(...) * g) by name: x, the tables, the layer's
    parameters (an unread table has none)."""
    x = x.detach().requires_grad_(True)
    tables = {k: t.detach().requires_grad_(True) for k, t in tables.items()}
    params = dict(layer.named_parameters())
    y = fn(x, layer, tables, dom, **kw)
    names = ["x", *(f"table.{k}" for k in tables), *params]
    got = torch.autograd.grad((y * g).sum(),
                              [x, *tables.values(), *params.values()],
                              allow_unused=True)
    return {n: gr for n, gr in zip(names, got) if gr is not None}


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("variant,mode,relu_out", GATE_CASES)
@pytest.mark.parametrize("B,F", [(33, 7), (301, 19), (8190, 19)])
def test_gate_block_kernels_match_plain_version(card, variant, mode,
                                                relu_out, B, F, rate):
    """K6-fwd (without a gradient) and K6-fwd + K6-bwd (through the
    autograd wrapper) against the plain layer in float64 with the same
    masks, at a small, an odd and a ragged full-width batch: the output
    within 1e-4, each gradient within 1e-4 of its largest entry plus 1e-5
    (sums over up to B * F rows in another order).  Examples whose output
    projection lies within 1e-6 of the relu kink get no upstream
    gradient."""
    gen, layer, tables = _gate_layer(card, variant, 5)
    x = init.normal(gen, (B, F, 32), 1.0)
    g = init.normal(gen, (B, F, 32), 1.0)
    dom = torch.randint(0, 4, (B,), generator=gen, device=card)
    kw = dict(head_num=4, mode=mode, relu_out=relu_out)
    drop = dict(train=True, drop_rate=rate, **DROP)
    masks = gate_block.layer_masks(x, head_num=4, **drop)
    masks64 = masks and tuple(None if m is None else m.double()
                              for m in masks)
    layer64 = copy.deepcopy(layer).double()
    tables64 = {k: t.double() for k, t in tables.items()}
    if relu_out:
        res = {}
        with torch.no_grad():
            attention.meta_transformer_apply(
                layer64, x.double(), tables64, (), mode=mode, head_num=4,
                relu_out=True, domain_ids=dom, masks=masks64, clamp=True,
                residuals=res)
            near = ((res["o"] @ layer64.wout).abs() < 1e-6).flatten(1).any(1)
        g = g.masked_fill(near[:, None, None], 0.0)
    before = (gate_block.launches, gate_block.bwd_launches)
    with torch.no_grad():
        y = gate_block.fused_simple_layer(x, layer, tables, dom, **kw,
                                          **drop)
        want = gate_block.simple_layer_reference(
            x.double(), layer64, tables64, dom, **kw, masks=masks64)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.double(), want, rtol=1e-4, atol=1e-4)
    got = _gate_grads(gate_block.fused_simple_layer, x, layer, tables, dom,
                      g, **kw, **drop)
    torch.cuda.synchronize()
    assert (gate_block.launches, gate_block.bwd_launches) == (
        before[0] + 2, before[1] + 1)
    want = _gate_grads(gate_block.simple_layer_reference, x.double(),
                       layer64, tables64, dom, g.double(), **kw,
                       masks=masks64)
    assert set(got) == set(want)
    for name, w in want.items():
        err = (got[name].double() - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item() + 1e-5, (name, err)


def _gate_case(card, variant, mode, relu_out, rate, B, rows=4, mix=None,
               seed=6):
    """A gate or bilinear layer, ``rows``-row tables and a batch of ``B``
    examples (F = 19) whose domain rows are uniform, or with ``mix`` 'one'
    all row 2, 'alternate' rows 0 and 1 example by example; the upstream
    gradient kink-free (see :func:`_gate_reference`).  Returns (layer,
    tables, x, g, dom, the keyword and dropout arguments)."""
    gen = make_generator(seed, card)
    layer = attention.MetaTransformerLayer(gen, 32, variant=variant)
    names = ("Q", "K") if variant == "gate" else ("bilinear",)
    width = 32 if variant == "gate" else 32 * 8
    tables = {n: init.normal(gen, (rows, width), 0.5) for n in names}
    x = init.normal(gen, (B, 19, 32), 1.0)
    g = init.normal(gen, (B, 19, 32), 1.0)
    if mix == "one":
        dom = torch.full((B,), 2, device=card)
    elif mix == "alternate":
        dom = torch.arange(B, device=card) % 2
    else:
        dom = torch.randint(0, rows, (B,), generator=gen, device=card)
    kw = dict(head_num=4, mode=mode, relu_out=relu_out)
    drop = dict(train=True, drop_rate=rate, **DROP)
    return layer, tables, x, g, dom, kw, drop


def _gate_reference(layer, tables, x, g, dom, kw, drop):
    """The float64 plain layer's gradients (:func:`_gate_grads`) with the
    same masks, and the upstream gradient with the examples whose output
    projection lies within 1e-6 of the relu kink given none."""
    masks = gate_block.layer_masks(x, head_num=4, **drop)
    masks64 = masks and tuple(None if m is None else m.double()
                              for m in masks)
    layer64 = copy.deepcopy(layer).double()
    tables64 = {k: t.double() for k, t in tables.items()}
    if kw["relu_out"]:
        res = {}
        with torch.no_grad():
            attention.meta_transformer_apply(
                layer64, x.double(), tables64, (), **kw, domain_ids=dom,
                masks=masks64, clamp=True, residuals=res)
            near = ((res["o"] @ layer64.wout).abs() < 1e-6).flatten(1).any(1)
        g = g.masked_fill(near[:, None, None], 0.0)
    want = _gate_grads(gate_block.simple_layer_reference, x.double(),
                       layer64, tables64, dom, g.double(), **kw,
                       masks=masks64)
    return want, g


def _check_gate_grads(got, want):
    """Each gradient within 1e-4 of its largest entry plus 1e-5 (float32
    sums over up to B * F rows of 3xTF32 products, in another order)."""
    assert set(got) == set(want)
    for name, w in want.items():
        err = (got[name].double() - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item() + 1e-5, (name, err)


# K6-bwd's tile body on domain mixes: one row, rows alternating example by
# example (a segment an example), and 16 rows
GATE_MIXES = {"one": dict(mix="one"), "alternate": dict(mix="alternate"),
              "rows16": dict(rows=16)}


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("variant,mode,relu_out", GATE_CASES[:3])
@pytest.mark.parametrize("case", sorted(GATE_MIXES))
def test_gate_bwd_on_domain_mixes(card, case, variant, mode, relu_out,
                                  rate):
    """K6-bwd (through the autograd wrapper, after K6-fwd) at B = 2000 on
    the mixes of ``GATE_MIXES``, gate QK and Query and bilinear, against
    the float64 plain layer's gradients (:func:`_check_gate_grads`)."""
    layer, tables, x, g, dom, kw, drop = _gate_case(
        card, variant, mode, relu_out, rate, 2000, **GATE_MIXES[case])
    want, g = _gate_reference(layer, tables, x, g, dom, kw, drop)
    before = gate_block.bwd_launches
    got = _gate_grads(gate_block.fused_simple_layer, x, layer, tables, dom,
                      g, **kw, **drop)
    torch.cuda.synchronize()
    assert gate_block.bwd_launches == before + 1
    _check_gate_grads(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("variant,mode", [("gate", "QK"), ("gate", "Query"),
                                          ("bilinear", "QK")])
@pytest.mark.parametrize("blocks", [1, 3, 7])
def test_gate_bwd_forced_grids(card, monkeypatch, blocks, variant, mode):
    """K6-bwd on forced grids of 1, 3 and 7 blocks at B = 2000, dropout
    0.1 (each block a longer range of the batch, sorted by domain in the
    kernel; on one block every sum runs over all 38,000 rows): through
    the autograd wrapper against the float64 plain layer's gradients
    (:func:`_check_gate_grads`), and a second launch on the same grid bit
    for bit."""
    layer, tables, x, g, dom, kw, drop = _gate_case(
        card, variant, mode, False, 0.1, 2000, seed=7)
    want, g = _gate_reference(layer, tables, x, g, dom, kw, drop)
    monkeypatch.setattr(gate_block, "sm_count", lambda device: blocks)
    got = _gate_grads(gate_block.fused_simple_layer, x, layer, tables, dom,
                      g, **kw, **drop)
    _check_gate_grads(got, want)
    ops, cfg = gate_block.pack_operands(x, layer, tables, dom, **kw)
    ops = [t.detach() for t in ops]
    kargs = prng.kernel_args(True, 0.1, DROP["seed"], DROP["block_b"], 19,
                             pad_mult=gate_block.PAD_FIELDS)
    with torch.no_grad():
        one = gate_block.launch_bwd(g, *ops, cfg, kargs)
        two = gate_block.launch_bwd(g, *ops, cfg, kargs)
    torch.cuda.synchronize()
    for a, b in zip(one, two):
        assert torch.equal(a, b)


# --- K6-fwd's tile body: grids and edges --------------------------------


def _gate_fwd_case(card, variant, B, F, rows, seed):
    """A gate or bilinear layer, ``rows``-row tables and a batch of ``B``
    examples of ``F`` fields with uniform domain rows."""
    gen = make_generator(seed, card)
    layer = attention.MetaTransformerLayer(gen, 32, variant=variant)
    names = ("Q", "K") if variant == "gate" else ("bilinear",)
    width = 32 if variant == "gate" else 32 * 8
    tables = {n: init.normal(gen, (rows, width), 0.5) for n in names}
    x = init.normal(gen, (B, F, 32), 1.0)
    dom = torch.randint(0, rows, (B,), generator=gen, device=card)
    return layer, tables, x, dom


def _gate_fwd_reference(layer, tables, x, dom, kw, drop):
    """The float64 plain layer's output with the kernels' masks."""
    masks = gate_block.layer_masks(x, head_num=4, **drop)
    masks64 = masks and tuple(None if m is None else m.double()
                              for m in masks)
    with torch.no_grad():
        return gate_block.simple_layer_reference(
            x.double(), copy.deepcopy(layer).double(),
            {k: t.double() for k, t in tables.items()}, dom, **kw,
            masks=masks64)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("variant,mode", [("gate", "QK"), ("gate", "Query"),
                                          ("bilinear", "QK")])
@pytest.mark.parametrize("blocks", [1, 3, 7])
def test_gate_fwd_forced_grids(card, monkeypatch, blocks, variant, mode,
                               rate):
    """K6-fwd at B = 2000 on forced grids (``gate_block.sm_count`` patched
    to 1, 3 and 7: a block walks up to all 2000 examples): y within 1e-4
    of the float64 plain layer, and bit for bit the wrapper's y on the
    card's grid."""
    layer, tables, x, dom = _gate_fwd_case(card, variant, 2000, 19, 4, 8)
    kw = dict(head_num=4, mode=mode, relu_out=False)
    drop = dict(train=True, drop_rate=rate, **DROP)
    want = _gate_fwd_reference(layer, tables, x, dom, kw, drop)
    with torch.no_grad():
        base = gate_block.fused_simple_layer(x, layer, tables, dom, **kw,
                                             **drop)
        monkeypatch.setattr(gate_block, "sm_count", lambda device: blocks)
        y = gate_block.fused_simple_layer(x, layer, tables, dom, **kw,
                                          **drop)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.double(), want, rtol=1e-4, atol=1e-4)
    assert torch.equal(y, base)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 4, 64])
@pytest.mark.parametrize("F", [1, 15, 20])
@pytest.mark.parametrize("B", [0, 1, 5, 63, 64, 65, 95, 96, 97, 512])
@pytest.mark.parametrize("variant", ["gate", "bilinear"])
def test_gate_fwd_edges(card, variant, B, F, D):
    """K6-fwd at dropout 0.1 against the float64 plain layer (within 1e-4)
    at the edges of its tiles: batches of none, one, a few and about one
    and one and a half tiles of examples (64 rows at F = 1) and a small
    request, one field
    and the most, and tables of one row, four, and 64 (the bilinear maps
    past the staged budget, read from device memory)."""
    layer, tables, x, dom = _gate_fwd_case(card, variant, B, F, D, 9)
    kw = dict(head_num=4, mode="QK", relu_out=False)
    drop = dict(train=True, drop_rate=0.1, **DROP)
    before = gate_block.launches
    with torch.no_grad():
        y = gate_block.fused_simple_layer(x, layer, tables, dom, **kw,
                                          **drop)
    torch.cuda.synchronize()
    assert gate_block.launches == before + 1 and y.shape == x.shape
    if B:
        want = _gate_fwd_reference(layer, tables, x, dom, kw, drop)
        torch.testing.assert_close(y.double(), want, rtol=1e-4, atol=1e-4)


# --- K7, the tiled layer on dispatched single-domain tiles --------------

TILED_COUNTS = ("launches", "stash_launches", "bwd_launches",
                "stash_bwd_launches")
# the launches of each backward's pair: (K7-fwd, K7-stash, K7-bwd,
# K7-bwd-stash)
TILED_PAIR = {"recompute": [1, 0, 1, 0], "stash": [0, 1, 0, 1]}
TILE, ROWS, OCCUPIED = 32, 56, 39


def _tiled_counts():
    return [getattr(tiled_meta, c) for c in TILED_COUNTS]


def _tiled_case(card, seed, pos, B=512, units=UNITS2, F=19, tile=TILE,
                mix="random"):
    """A layer (``pos``: with a k_meta LayerNorm and distinct tables),
    ``[56, P]`` tables of MetaNets of ``units`` and a batch of ``B``
    examples of ``F`` fields dispatched on tiles of ``tile``: with ``mix``
    'random' in 39 of the 56 composite domains (the AliCCP 301 x 122
    occupancy; most tiles slack), 'exact' in 16 domains of B / 16 examples
    (every occupied tile full), 'one' in one domain.  ``B + 56 * tile``
    slots.  Returns (layer, tile tables, x and g on the slots (zero on
    slack slots), the slots' table rows, the plan)."""
    gen, layer, tables = _pos_layer(card, seed) if pos else _layer(card,
                                                                   seed)
    p = metanet.param_size(units)
    tables = {k: init.normal(gen, (ROWS, p), 0.1)
              for k in ("QK" if pos else "Q")}
    used = torch.randperm(ROWS, generator=gen, device=card)[:OCCUPIED]
    if mix == "random":
        dom = used[torch.randint(0, OCCUPIED, (B,), generator=gen,
                                 device=card)]
    elif mix == "exact":
        dom = used[:16].repeat_interleave(B // 16)
    else:
        dom = used[:1].expand(B)
    plan = dispatch.plan(dom, ROWS, tile)
    tile_dom = plan.tile_dom.long()
    tabs = {k: t[tile_dom] for k, t in tables.items()}
    if not pos:
        tabs["K"] = tabs["Q"]
    x = dispatch.scatter(init.normal(gen, (B, F, 32), 1.0), plan)
    g = dispatch.scatter(init.normal(gen, (B, F, 32), 1.0), plan)
    if mix == "random" and B == 512:
        assert (plan.src < 0).sum().item() > B  # slack-heavy
    return (layer, tabs, x, g, tiled_meta.tile_rows(plan.n_slots, tile, card),
            plan)


@pytest.mark.cuda
@pytest.mark.parametrize("units", [UNITS2, UNITS3],
                         ids=["2-matrix", "3-matrix"])
@pytest.mark.parametrize("pos", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("mode,relu_out", MODES)
def test_tiled_forward_kernels_match_plain_version(card, units, mode, relu_out,
                                                   rate, pos):
    """K7-fwd (through the wrapper, without a gradient: no stash) and
    K7-stash's output and each residual on every slot against the plain
    tiled layer, at K1's tolerance; K7-fwd's y equal to K7-stash's bit for
    bit, and with the plan's ``tile_count`` (the model's path) equal to it
    on the occupied slots and zero on the slack ones."""
    layer, tabs, x, _, _, plan = _tiled_case(card, 8, pos, units=units)
    kw = dict(meta_units=units, head_num=4, mode=mode,
              relu_out=relu_out)
    drop = dict(train=True, drop_rate=rate, seed=DROP["seed"],
                block_b=TILE)
    kargs = prng.kernel_args(True, rate, DROP["seed"], TILE, 19)
    before = _tiled_counts()
    with torch.no_grad():
        y = tiled_meta.fused_tiled_layer(x, layer, tabs, **kw, **drop)
        skipped = tiled_meta.fused_tiled_layer(x, layer, tabs, **kw, **drop,
                                               tile_count=plan.tile_count)
        weights, cfg = meta_block.pack_weights(layer, tabs, **kw)
        got = tiled_meta.launch_fwd(x, *weights, cfg, kargs, TILE,
                                    stash=True)
        res = {}
        want = tiled_meta.tiled_layer_reference(
            x, layer, tabs, **kw, block_b=TILE, residuals=res,
            masks=tiled_meta.layer_masks(x, head_num=4, mode=mode, **drop))
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_tiled_counts(), before)] == [2, 1, 0, 0]
    torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-4)
    assert len(got) == 1 + len(tiled_meta.STASH_RESIDUALS)
    for name, a in zip(("y",) + tiled_meta.STASH_RESIDUALS, got):
        torch.testing.assert_close(a, want if name == "y" else res[name],
                                   rtol=1e-4, atol=1e-4, msg=name)
    # K7-fwd, the no-stash mode of K7-stash's body: its y bit for bit; with
    # the plan's tile_count the occupied slots as on every slot, zeros on
    # the slack ones
    occ = plan.src >= 0
    assert torch.equal(y, got[0])
    assert torch.equal(skipped[occ], y[occ])
    assert not bool(skipped[~occ].any())


def _check_tiled_bwd(layer, tabs, x, g, rows, kw, drop, pos, bwd,
                     tile_count=None):
    """K7-bwd-stash (with K7-stash) or K7-bwd (with K7-fwd) through the
    autograd wrapper against autograd of the plain tiled layer in float64
    with the same masks: dx, the layer's parameters and the per-tile
    table blocks (each tile's own), at K1's tolerance; examples at a relu
    kink get no upstream gradient."""
    masks = tiled_meta.layer_masks(x, head_num=4, mode=kw["mode"], **drop)
    masks64 = masks and tuple(None if m is None else m.double()
                              for m in masks)
    layer64 = copy.deepcopy(layer).double()
    tabs64 = {k: t.double() for k, t in tabs.items()}
    g = _kink_free(g.double(), x.double(), layer64, tabs64, rows, masks64,
                   **kw)
    names = ("table.Q", "table.K") if pos else ("table",)

    def grads(fn, x, layer, tabs, g, **extra):
        x = x.detach().requires_grad_(True)
        leaves = {n: tabs[n[-1] if pos else "Q"].detach().requires_grad_(
            True) for n in names}
        t = {k: leaves[f"table.{k}" if pos else "table"] for k in "QK"}
        params = dict(layer.named_parameters())
        y = fn(x, layer, t, **kw, **extra)
        got = torch.autograd.grad((y * g).sum(), [x, *leaves.values(),
                                                  *params.values()],
                                  allow_unused=True)
        return {n: a for n, a in zip(["x", *names, *params], got)
                if a is not None}

    before = _tiled_counts()
    got = grads(tiled_meta.fused_tiled_layer, x, layer, tabs, g.float(),
                **drop, bwd=bwd, tile_count=tile_count)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_tiled_counts(), before)] == \
        TILED_PAIR[bwd]
    want = grads(tiled_meta.tiled_layer_reference, x.double(), layer64,
                 tabs64, g, block_b=drop["block_b"], masks=masks64)
    assert set(got) == set(want)
    for name, w in want.items():
        err = (got[name].double() - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item() + 1e-5, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("units", [UNITS2, UNITS3],
                         ids=["2-matrix", "3-matrix"])
@pytest.mark.parametrize("bwd", ["stash", "recompute"])
@pytest.mark.parametrize("pos", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("mode,relu_out", MODES)
def test_tiled_bwd_kernels_match_plain_backward(card, units,
                                                mode, relu_out, rate,
                                                pos, bwd):
    """K7-bwd-stash (with K7-stash) and K7-bwd (with K7-fwd) with the
    plan's ``tile_count`` (the model's path: the slack slots skipped)
    against autograd of the plain tiled layer in float64
    (:func:`_check_tiled_bwd`)."""
    layer, tabs, x, g, rows, plan = _tiled_case(card, 9, pos, units=units)
    kw = dict(meta_units=units, head_num=4, mode=mode,
              relu_out=relu_out)
    drop = dict(train=True, drop_rate=rate, seed=DROP["seed"],
                block_b=TILE)
    _check_tiled_bwd(layer, tabs, x, g, rows, kw, drop, pos, bwd,
                     tile_count=plan.tile_count)


# the K7 backward cases of the tile body: its tiles of 5 slots straddling
# dispatch tiles of 32 (F = 15), dispatch tiles of 16, every occupied
# dispatch tile full, one domain
TILED_BWD_CASES = {"F15": dict(F=15), "tile16": dict(tile=16),
                   "exact_fills": dict(mix="exact"),
                   "one_domain": dict(mix="one")}


@pytest.mark.cuda
@pytest.mark.parametrize("units", [UNITS2, UNITS3],
                         ids=["2-matrix", "3-matrix"])
@pytest.mark.parametrize("bwd", ["stash", "recompute"])
@pytest.mark.parametrize("case", sorted(TILED_BWD_CASES))
def test_tiled_bwd_kernels_on_dispatch_cases(card, units, bwd, case):
    """The K7 backwards with the plan's ``tile_count`` (the model's path:
    the slack slots skipped) on the cases of ``TILED_BWD_CASES``, QK with
    distinct tables at dropout 0.1, against autograd of the plain tiled
    layer in float64 (:func:`_check_tiled_bwd`)."""
    layer, tabs, x, g, rows, plan = _tiled_case(
        card, 11, True, units=units, **TILED_BWD_CASES[case])
    kw = dict(meta_units=units, head_num=4, mode="QK", relu_out=False)
    drop = dict(train=True, drop_rate=0.1, seed=DROP["seed"],
                block_b=plan.tile)
    _check_tiled_bwd(layer, tabs, x, g, rows, kw, drop, True, bwd,
                     tile_count=plan.tile_count)


def _tiled_launch_case(card, seed, units, bwd):
    """A slack-heavy case (:func:`_tiled_case`, distinct tables, dropout
    0.1) packed for :func:`tiled_meta.launch_bwd`: returns (a function of
    its keyword arguments that launches the case's backward, the plan,
    x)."""
    layer, tabs, x, g, _, plan = _tiled_case(card, seed, True, units=units)
    weights, cfg = meta_block.pack_weights(layer, tabs, meta_units=units,
                                           head_num=4)
    weights = [t if t is None else t.detach() for t in weights]
    kargs = prng.kernel_args(True, 0.1, DROP["seed"], TILE, 19)
    res = None
    if bwd == "stash":
        with torch.no_grad():
            _, *res = tiled_meta.launch_fwd(x, *weights, cfg, kargs, TILE,
                                            stash=True)

    def run(x=x, **extra):
        with torch.no_grad():
            return tiled_meta.launch_bwd(g, x, *weights, cfg, kargs, TILE,
                                         res=res, **extra)
    return run, plan, x


def _close_to(got, want, rtol):
    """Every gradient of ``got`` within ``rtol`` of the largest entry of
    its twin in ``want`` (None twins for 2-matrix MetaNets)."""
    for i, (a, b) in enumerate(zip(got, want)):
        if b is None:
            assert a is None
            continue
        err = (a - b).abs().max().item()
        assert err <= rtol * b.abs().max().item(), (i, err)


@pytest.mark.cuda
@pytest.mark.parametrize("units", [UNITS2, UNITS3],
                         ids=["2-matrix", "3-matrix"])
@pytest.mark.parametrize("bwd", ["stash", "recompute"])
@pytest.mark.parametrize("blocks", [1, 3, 7])
def test_tiled_bwd_forced_grids(card, monkeypatch, units, bwd, blocks):
    """``launch_bwd`` with the plan's ``tile_count`` on forced grids of 1,
    3 and 7 blocks.  The kernel's own split: no dispatch tile shared on
    one block, some on 3 and 7 (added by the boundary pass), each shared
    once, in slot order, and holding two occupied slots or more.  Every
    gradient within 1e-4 of its largest entry on the card's grid, K1's
    tolerance (float32 sums over some 10^4 rows of 3xTF32 products, in
    another order), and through the autograd wrapper against autograd of
    the plain tiled layer in float64 (:func:`_check_tiled_bwd`); a second
    launch on the same grid bit for bit."""
    run, plan, _ = _tiled_launch_case(card, 12, units, bwd)
    base = run(tile_count=plan.tile_count)
    got, tails = run(tile_count=plan.tile_count, blocks=blocks, tails=True)
    again = run(tile_count=plan.tile_count, blocks=blocks)
    torch.cuda.synchronize()
    assert tails.shape == (blocks,)
    split = tails[tails >= 0].long()
    assert bool(split.numel()) == (blocks > 1)
    assert bool((split.diff() > 0).all())
    assert bool((plan.tile_count[split] > 1).all())
    _close_to(got, base, 1e-5)
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)
    monkeypatch.setattr(tiled_meta, "sm_count", lambda device: blocks)
    layer, tabs, x, g, rows, _ = _tiled_case(card, 12, True, units=units)
    kw = dict(meta_units=units, head_num=4, mode="QK", relu_out=False)
    drop = dict(train=True, drop_rate=0.1, seed=DROP["seed"], block_b=TILE)
    _check_tiled_bwd(layer, tabs, x, g, rows, kw, drop, True, bwd,
                     tile_count=plan.tile_count)


@pytest.mark.cuda
@pytest.mark.parametrize("units", [UNITS2, UNITS3],
                         ids=["2-matrix", "3-matrix"])
@pytest.mark.parametrize("bwd", ["stash", "recompute"])
def test_tiled_bwd_tile_count_equals_every_slot(card, units, bwd):
    """``launch_bwd`` with the plan's ``tile_count`` (the slack slots
    skipped) against without it (every slot computed), with x nonzero on
    the slack slots as a later layer's input is (g is zero there): every
    gradient within 1e-4 of its largest entry (the grids split the slots
    at other places), dx exactly 0 on the slack slots in both."""
    run, plan, x = _tiled_launch_case(card, 13, units, bwd)
    slack = plan.src < 0
    x = torch.where(slack[:, None, None], torch.randn_like(x), x)
    every = run(x=x)
    skipped = run(x=x, tile_count=plan.tile_count)
    torch.cuda.synchronize()
    _close_to(skipped, every, 1e-4)
    for dx in (every[0], skipped[0]):
        assert torch.equal(dx[slack], torch.zeros_like(dx[slack]))


@pytest.mark.cuda
@pytest.mark.parametrize("units", [UNITS2, UNITS3],
                         ids=["2-matrix", "3-matrix"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_tiled_stash_backward_equals_recompute_backward(card, units, rate):
    """K7-bwd-stash on K7-stash's residuals against K7-bwd recomputing
    them, on the same masks: every gradient within 1e-5 of its largest
    entry (the two forwards sum the attention output in another order)."""
    layer, tabs, x, g, _, _ = _tiled_case(card, 10, True, units=units)
    kw = dict(meta_units=units, head_num=4)
    weights, cfg = meta_block.pack_weights(layer, tabs, **kw)
    weights = [t if t is None else t.detach() for t in weights]
    kargs = prng.kernel_args(True, rate, DROP["seed"], TILE, 19)
    with torch.no_grad():
        _, *res = tiled_meta.launch_fwd(x, *weights, cfg, kargs, TILE,
                                        stash=True)
        stash = tiled_meta.launch_bwd(g, x, *weights, cfg, kargs, TILE,
                                      res=res)
        again = tiled_meta.launch_bwd(g, x, *weights, cfg, kargs, TILE)
    torch.cuda.synchronize()
    _close_to(stash, again, 1e-5)


# the dispatches of the K7-stash tests: the slack-heavy one and the
# backward cases
TILED_STASH_CASES = {"random": {}, **TILED_BWD_CASES}


def _tiled_stash_case(card, seed, units, case):
    """A case of ``TILED_STASH_CASES`` (distinct tables) packed for
    :func:`tiled_meta.launch_fwd` at dropout 0.1: returns (a function of
    its keyword arguments that launches K7-stash, the case as
    :func:`_tiled_case` returns it, the packed weights, cfg and dropout
    arguments)."""
    case = _tiled_case(card, seed, True, units=units,
                       **TILED_STASH_CASES[case])
    layer, tabs, x, _, _, plan = case
    weights, cfg = meta_block.pack_weights(layer, tabs, meta_units=units,
                                           head_num=4)
    weights = [t if t is None else t.detach() for t in weights]
    kargs = prng.kernel_args(True, 0.1, DROP["seed"], plan.tile, x.shape[1])

    def run(**extra):
        with torch.no_grad():
            return tiled_meta.launch_fwd(x, *weights, cfg, kargs, plan.tile,
                                         stash=True, **extra)
    return run, case, weights, cfg, kargs


@pytest.mark.cuda
@pytest.mark.parametrize("units", [UNITS2, UNITS3],
                         ids=["2-matrix", "3-matrix"])
@pytest.mark.parametrize("case", sorted(TILED_STASH_CASES))
def test_tiled_stash_tile_count_equals_every_slot(card, units, case):
    """K7-stash with the plan's ``tile_count`` (the occupied slots alone,
    the model's path) against every slot computed, QK with distinct tables
    at dropout 0.1: y and every residual bit for bit on the occupied slots
    (each slot's rows are computed alone), zeros on the slack slots; the
    every-slot result against the plain tiled layer at K1's tolerance;
    K7-fwd with ``tile_count`` equal to K7-stash's y bit for bit."""
    run, (layer, tabs, x, _, _, plan), weights, cfg, kargs = \
        _tiled_stash_case(card, 16, units, case)
    every = run()
    skipped = run(tile_count=plan.tile_count)
    with torch.no_grad():
        fwd = tiled_meta.launch_fwd(x, *weights, cfg, kargs, plan.tile,
                                    tile_count=plan.tile_count)
    res = {}
    with torch.no_grad():
        want = tiled_meta.tiled_layer_reference(
            x, layer, tabs, meta_units=units, head_num=4,
            block_b=plan.tile, residuals=res,
            masks=tiled_meta.layer_masks(
                x, head_num=4, mode="QK", train=True, drop_rate=0.1,
                seed=DROP["seed"], block_b=plan.tile))
    torch.cuda.synchronize()
    occ = plan.src >= 0
    for name, a, b in zip(("y",) + tiled_meta.STASH_RESIDUALS, every,
                          skipped):
        assert torch.equal(a[occ], b[occ]), name
        assert not bool(b[~occ].any()), name
        torch.testing.assert_close(a, want if name == "y" else res[name],
                                   rtol=1e-4, atol=1e-4, msg=name)
    assert torch.equal(fwd, skipped[0])


@pytest.mark.cuda
@pytest.mark.parametrize("units", [UNITS2, UNITS3],
                         ids=["2-matrix", "3-matrix"])
@pytest.mark.parametrize("blocks", [1, 3, 7])
def test_tiled_stash_forced_grids(card, units, blocks):
    """K7-stash and K7-fwd with the plan's ``tile_count`` on forced grids
    of 1, 3 and 7 blocks (each block a longer range of the occupied slots,
    and the slack's zeros split otherwise): y and every residual bit for
    bit against the card's grid, K7-fwd's y equal to K7-stash's on the
    card's grid and on the forced one, twice."""
    run, (_, _, x, _, _, plan), weights, cfg, kargs = _tiled_stash_case(
        card, 17, units, "random")
    base = run(tile_count=plan.tile_count)
    got = run(tile_count=plan.tile_count, blocks=blocks)
    with torch.no_grad():
        fwd = [tiled_meta.launch_fwd(x, *weights, cfg, kargs, plan.tile,
                                     tile_count=plan.tile_count, blocks=k)
               for k in (None, blocks, blocks)]
    torch.cuda.synchronize()
    for name, a, b in zip(("y",) + tiled_meta.STASH_RESIDUALS, base, got):
        assert torch.equal(a, b), name
    assert all(torch.equal(y, base[0]) for y in fwd)


@pytest.mark.cuda
@pytest.mark.parametrize("units", [UNITS2, UNITS3],
                         ids=["2-matrix", "3-matrix"])
@pytest.mark.parametrize("case", sorted(TILED_STASH_CASES))
def test_tiled_stash_skip_feeds_backward(card, units, case):
    """K7-bwd-stash on the residuals of K7-stash with the plan's
    ``tile_count`` against K7-bwd recomputing them, both with it (the
    model's path), on the same masks at dropout 0.1: every gradient within
    1e-5 of its largest entry, as
    :func:`test_tiled_stash_backward_equals_recompute_backward`."""
    run, (_, _, x, g, _, plan), weights, cfg, kargs = _tiled_stash_case(
        card, 18, units, case)
    _, *res = run(tile_count=plan.tile_count)
    with torch.no_grad():
        stash = tiled_meta.launch_bwd(g, x, *weights, cfg, kargs, plan.tile,
                                      res=res, tile_count=plan.tile_count)
        again = tiled_meta.launch_bwd(g, x, *weights, cfg, kargs, plan.tile,
                                      tile_count=plan.tile_count)
    torch.cuda.synchronize()
    _close_to(stash, again, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("units", [UNITS2, UNITS3],
                         ids=["2-matrix", "3-matrix"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("F,distinct", [(19, False), (15, True)],
                         ids=["F19", "F15-distinct"])
def test_stash_backward_equals_recompute_backward(card, units, rate, F,
                                                  distinct):
    """K1-bwd-stash on K1-stash's residuals against K1-bwd recomputing
    them on the tile body, on the same masks, at the full batch: every
    gradient within 1e-5 of its largest entry (the two forwards sum in
    another order), as K7's twin."""
    gen, layer, tables = _tile_layer(card, 14, units, distinct, 4)
    B = 8192
    x = init.normal(gen, (B, F, 32), 1.0)
    g = init.normal(gen, (B, F, 32), 1.0)
    dom = torch.randint(0, 4, (B,), generator=gen, device=card)
    ops, cfg = meta_block.pack_operands(x, layer, tables, dom,
                                        meta_units=units, head_num=4)
    ops = [t if t is None else t.detach() for t in ops]
    kargs = prng.kernel_args(True, rate, DROP["seed"], DROP["block_b"], F)
    with torch.no_grad():
        _, *res = meta_block.launch_fwd(*ops, cfg, kargs, stash="full")
        stash = meta_block.launch_bwd(g, *ops, cfg, kargs, res=tuple(res))
        again = meta_block.launch_bwd(g, *ops, cfg, kargs)
    torch.cuda.synchronize()
    _close_to(again, stash, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("units", [UNITS2, UNITS3],
                         ids=["2-matrix", "3-matrix"])
@pytest.mark.parametrize("blocks", [1, 3, 7])
def test_recompute_bwd_forced_grids(card, monkeypatch, units, blocks):
    """K1-bwd on forced grids of 1, 3 and 7 blocks (each block a longer
    range of the batch, sorted by domain in the kernel): through the
    autograd wrapper against autograd of the plain layer in float64, each
    gradient within 1e-4 of its largest entry plus 1e-5 (float32 sums
    over up to B * F rows in another order); a second launch on the same
    grid bit for bit.  On one block the weight-gradient sums run over all
    B * F = 38,000 rows."""
    gen, layer, tables = _tile_layer(card, 15, units, False, 4)
    B, F = 2000, 19
    x = init.normal(gen, (B, F, 32), 1.0)
    g = init.normal(gen, (B, F, 32), 1.0)
    dom = torch.randint(0, 4, (B,), generator=gen, device=card)
    kw = dict(meta_units=units, head_num=4, mode="QK", relu_out=False)
    drop = dict(train=True, drop_rate=0.1, **DROP)
    masks = meta_block.layer_masks(x, head_num=4, mode="QK", **drop)
    masks64 = tuple(None if m is None else m.double() for m in masks)
    layer64 = copy.deepcopy(layer).double()
    tables64 = {k: t.double() for k, t in tables.items()}
    tables64["K"] = tables64["Q"]
    g = _kink_free(g.double(), x.double(), layer64, tables64, dom, masks64,
                   **kw).float()
    ops, cfg = meta_block.pack_operands(x, layer, tables, dom, **kw)
    ops = [t if t is None else t.detach() for t in ops]
    kargs = prng.kernel_args(True, 0.1, DROP["seed"], DROP["block_b"], F)
    monkeypatch.setattr(meta_block, "sm_count", lambda device: blocks)
    with torch.no_grad():
        one = meta_block.launch_bwd(g, *ops, cfg, kargs)
        two = meta_block.launch_bwd(g, *ops, cfg, kargs)
    torch.cuda.synchronize()
    for a, b in zip(one, two):
        assert (a is None and b is None) or torch.equal(a, b)
    before = meta_block.bwd_launches
    got = _named_grads(meta_block.fused_meta_layer, x, layer, tables, dom,
                       g, **kw, **drop, bwd="recompute")
    torch.cuda.synchronize()
    assert meta_block.bwd_launches == before + 1
    want = _named_grads(meta_block.meta_layer_reference, x.double(),
                        layer64, tables64, dom, g.double(), **kw,
                        masks=masks64)
    assert set(got) == set(want)
    for name, w in want.items():
        err = (got[name].double() - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item() + 1e-5, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("units", [UNITS2, UNITS3],
                         ids=["2-matrix", "3-matrix"])
@pytest.mark.parametrize("F,distinct", [(19, False), (15, True)],
                         ids=["F19", "F15-distinct"])
@pytest.mark.parametrize("blocks", [1, 3, 7])
def test_fwd_forced_grids(card, monkeypatch, units, F, distinct, blocks):
    """K1-fwd and K1-stash on forced grids of 1, 3 and 7 blocks (each block
    a longer range of the batch, sorted by domain in the kernel) at dropout
    0.1: y and every residual bit for bit against the card's grid (each
    row is computed alone, its masks keyed on its example), K1-fwd's y
    equal to K1-stash's, a second launch on the same grid bit for bit."""
    gen, layer, tables = _tile_layer(card, 19, units, distinct, 4)
    B = 2000
    x = init.normal(gen, (B, F, 32), 1.0)
    dom = torch.randint(0, 4, (B,), generator=gen, device=card)
    ops, cfg = meta_block.pack_operands(x, layer, tables, dom,
                                        meta_units=units, head_num=4)
    ops = [t if t is None else t.detach() for t in ops]
    kargs = prng.kernel_args(True, 0.1, DROP["seed"], DROP["block_b"], F)
    with torch.no_grad():
        base = meta_block.launch_fwd(*ops, cfg, kargs)
        base_st = meta_block.launch_fwd(*ops, cfg, kargs, stash="full")
        monkeypatch.setattr(meta_block, "sm_count", lambda device: blocks)
        got = meta_block.launch_fwd(*ops, cfg, kargs)
        again = meta_block.launch_fwd(*ops, cfg, kargs)
        got_st = meta_block.launch_fwd(*ops, cfg, kargs, stash="full")
    torch.cuda.synchronize()
    assert torch.equal(got, base) and torch.equal(got, again)
    assert torch.equal(base, base_st[0])
    for name, a, b in zip(("y", "qkv", "uq", "uk", "s", "o"), got_st,
                          base_st):
        assert torch.equal(a, b), name


# --- the row kernels of the sparse bank updates (K2, K3, K4, K5) ---------

def _bank(card, rows, w, seed):
    gen = make_generator(seed, card)
    return [init.normal(gen, (rows, w), 1.0) for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("w", [128, 10])  # 16-byte and 4-byte accesses
@pytest.mark.parametrize("n", [0, 1, 77])
def test_gather_rows_kernel_matches_plain_version(card, n, w):
    from satrans_torch.ops import gather
    arrays = _bank(card, 50, w, 2)
    ids = torch.randint(-3, 53, (n,), device=card)  # clamped at both ends
    before = gather.launches
    got = gather.gather_rows(arrays, ids)
    torch.cuda.synchronize()
    assert gather.launches == before + (n > 0)
    for g, want in zip(got, gather.gather_rows_reference(arrays, ids)):
        assert torch.equal(g, want)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [128, 10])
@pytest.mark.parametrize("drop_oob", [False, True])
def test_scatter_rows_kernel_matches_plain_version(card, drop_oob, w):
    """Duplicate ids carry identical values; with drop_oob the negative and
    past-the-end ids are skipped."""
    from satrans_torch.ops import scatter
    arrays = _bank(card, 50, w, 3)
    ids = torch.randint(0, 50, (40,), device=card)
    if drop_oob:
        ids[:6] = torch.tensor([-1, 50, 77, -50, 50, 3], device=card)
    cols = torch.arange(w, device=card, dtype=torch.float32)
    vals = [torch.sin(ids[:, None].float() * (a + 1) + cols)
            for a in range(3)]
    got = [a.clone() for a in arrays]
    want = [a.clone() for a in arrays]
    before = scatter.launches
    scatter.scatter_rows_set(got, ids, vals, drop_oob=drop_oob)
    scatter.scatter_rows_set_reference(want, ids, vals, drop_oob=drop_oob)
    torch.cuda.synchronize()
    assert scatter.launches == before + 1
    for g, wa in zip(got, want):
        assert torch.equal(g, wa)


def _check_eqgemm(ids, g):
    """K3 against its plain version: within 1e-5 of the largest total,
    every group of duplicate positions byte-identical, a second launch bit
    for bit and one launch counted each."""
    from satrans_torch.ops import eqgemm
    before = eqgemm.launches
    got = eqgemm.eqgemm_positions(ids, g)
    again = eqgemm.eqgemm_positions(ids, g)
    torch.cuda.synchronize()
    assert eqgemm.launches == before + 2
    assert torch.equal(got, again)
    want = eqgemm.eqgemm_positions_reference(ids, g)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    for f in range(ids.shape[0]):
        order = torch.argsort(ids[f], stable=True)
        s, i = got[f][order], ids[f][order]
        same = i[1:] == i[:-1]
        assert torch.equal(s[1:][same], s[:-1][same])


def _grouping_blocks(monkeypatch, F, parts):
    """Force K3's grouping onto ``parts`` blocks a field (None: the card's
    share)."""
    from satrans_torch.ops import eqgemm
    if parts is not None:
        monkeypatch.setattr(eqgemm, "sm_count", lambda device: F * parts)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [128, 200])
@pytest.mark.parametrize("parts", [1, 3, None])
def test_eqgemm_kernel_matches_plain_version(card, monkeypatch, W, parts):
    """Heavy duplicates (a tail batch's zero ids among them) at a small
    batch, on 1, 3 and the card's share of grouping blocks a field: within
    1e-5 of the largest total, and every group of duplicate positions
    byte-identical."""
    F, B = 3, 300
    ids = torch.randint(0, 40, (F, B), device=card)
    ids[:, 200:] = 7
    g = init.normal(make_generator(4, card), (F, B, W), 1.0)
    _grouping_blocks(monkeypatch, F, parts)
    _check_eqgemm(ids, g)


def _bench_ids(card, B, seed):
    """ids [10, B] as a training batch gives them: fields of 21-bit rows,
    of a few hundred and of a handful of values, a field past 2^40, the
    padded tail's zero ids from position 5000 of field 0, field 1 one id
    throughout, field 2 with no duplicate."""
    gen = make_generator(seed, card)
    hi = [2 ** 21, 1, 1, 2 ** 21, 7, 300, 2 ** 42, 3, 2 ** 21, 100_000]
    ids = torch.stack([torch.randint(0, h, (B,), generator=gen, device=card)
                       for h in hi])
    ids[0, 5000:] = 0
    ids[1] = 123_456
    ids[2] = torch.randperm(B, generator=gen, device=card) * 5 + 11
    return ids


@pytest.mark.cuda
@pytest.mark.parametrize("W", [128, 200])
@pytest.mark.parametrize("parts", [1, None])
def test_eqgemm_kernel_at_bench_shape(card, monkeypatch, W, parts):
    """K3 at F = 10, B = 8192 (and B = 8190, past whole chunks of 32):
    with the tail's run of 3192 zero ids, a field of one run, one with
    every id distinct, a few long runs; the 16-byte path at W = 128 and the
    scalar one at W = 200; one grouping block a field (all of a field's
    ids in one bucket) and the card's share."""
    ids = _bench_ids(card, 8192, 21)
    g = init.normal(make_generator(22, card), (10, 8192, W), 1.0)
    _grouping_blocks(monkeypatch, 10, parts)
    _check_eqgemm(ids, g)
    _check_eqgemm(ids[:, :8190].contiguous(), g[:, :8190].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("W", [128, 200])
@pytest.mark.parametrize("B", [301, 8191])
def test_eqgemm_kernel_at_odd_batches(card, monkeypatch, B, W):
    """An odd B puts the sort's arrays past an odd count of ids and
    positions: they start on aligned boundaries all the same, in shared
    memory, on 1 grouping block a field and on the card's share."""
    ids = _bench_ids(card, B, 25)
    g = init.normal(make_generator(26, card), (10, B, W), 1.0)
    _check_eqgemm(ids, g)
    _grouping_blocks(monkeypatch, 10, 1)
    _check_eqgemm(ids, g)


@pytest.mark.cuda
def test_eqgemm_kernel_sorts_past_shared_memory(card):
    """B = 20,000 and 10,002 (not a multiple of 8) positions do not fit a
    block's shared memory: the grouping sorts in a global scratch
    instead, each block's slice on an aligned boundary."""
    for B, seed in ((20_000, 23), (10_002, 27)):
        ids = _bench_ids(card, B, seed)[[0, 5, 9]].contiguous()
        g = init.normal(make_generator(seed + 1, card), (3, B, 8), 1.0)
        _check_eqgemm(ids, g)


@pytest.mark.cuda
def test_lazy_adam_rows_kernel_matches_plain_version(card):
    """Unique ids with the sentinel and a negative id; the kernel's
    operations round one by one as the plain version's do, so they agree
    within 2 float32 ulp."""
    from satrans_torch.ops import lazy_tail
    rows, w, n = 60, 128, 40
    bank, mu, nu = _bank(card, rows, w, 5)
    mu.mul_(0.1)
    nu.abs_().mul_(0.01)
    ids = torch.randperm(rows, device=card)[:n]
    ids[[3, 9]] = torch.tensor([rows, -2], device=card)
    gen = make_generator(6, card)
    g = init.normal(gen, (n, w), 0.05)
    k = torch.randint(0, 9, (n,), device=card).float()
    d1, d2, dw = 0.9 ** k, 0.999 ** k, (1 - 2e-5) ** (k + 1)
    kw = dict(lr=0.005, b1=0.9, b2=0.999, eps=1e-8)
    c = (1 / (1 - 0.9 ** 5), 1 / (1 - 0.999 ** 5))
    got = [t.clone() for t in (bank, mu, nu)]
    want = [t.clone() for t in (bank, mu, nu)]
    before = lazy_tail.launches
    lazy_tail.lazy_adam_rows(*got, ids, g, d1, d2, dw, *c, **kw)
    lazy_tail.lazy_adam_rows_reference(*want, ids, g, d1, d2, dw, *c, **kw)
    torch.cuda.synchronize()
    assert lazy_tail.launches == before + 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=2.4e-7, atol=1e-12)


# --- the row-DMA probes' kernels (P1 scatter, P2 gather) ------------------

@pytest.mark.cuda
@pytest.mark.parametrize("rb", [64, 128, 256])
@pytest.mark.parametrize("variant", ["bulk", "slots"])
@pytest.mark.parametrize("w", [128, 36])  # 512-byte and 144-byte rows
def test_row_dma_scatter_kernel_matches_plain_version(card, w, variant, rb):
    """Sorted unique ids over a small bank, N a few blocks of rb rows:
    bit for bit; an N that rb does not divide raises."""
    from satrans_torch.bench import scatter_probe
    rows, n = 3000, 3 * rb
    gen = make_generator(7, card)
    bank = init.normal(gen, (rows, w), 1.0)
    ids = torch.sort(torch.randperm(rows, device=card)[:n]).values
    vals = init.normal(gen, (n, w), 1.0)
    want = scatter_probe.row_dma_scatter_reference(bank.clone(), ids, vals)
    before = scatter_probe.launches
    got = scatter_probe.row_dma_scatter(bank, ids, vals, variant=variant,
                                        rb=rb)
    torch.cuda.synchronize()
    assert got is bank and scatter_probe.launches == before + 1
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        scatter_probe.row_dma_scatter(bank, ids[:-4], vals[:-4],
                                      variant=variant, rb=rb)


@pytest.mark.cuda
@pytest.mark.parametrize("arrays", [1, 3])
@pytest.mark.parametrize("rb", [64, 128, 256])
@pytest.mark.parametrize("variant", ["bulk", "slots"])
@pytest.mark.parametrize("w", [128, 36])
def test_row_dma_gather_kernel_matches_plain_version(card, w, variant, rb,
                                                     arrays):
    """Ids with duplicates, N a few blocks of rb rows: bit for bit on each
    array; an N that rb does not divide raises."""
    from satrans_torch.bench import gather_probe
    rows, n = 3000, 2 * rb
    srcs = _bank(card, rows, w, 8)[:arrays]
    ids = torch.randint(0, rows, (n,), device=card)
    ids[1::7] = ids[0]
    before = gather_probe.launches
    got = gather_probe.row_dma_gather(srcs, ids, variant=variant, rb=rb)
    torch.cuda.synchronize()
    assert gather_probe.launches == before + 1 and len(got) == arrays
    for g, want in zip(got, gather_probe.row_dma_gather_reference(srcs,
                                                                  ids)):
        assert torch.equal(g, want)
    with pytest.raises(ValueError):
        gather_probe.row_dma_gather(srcs, ids[:-1], variant=variant, rb=rb)
