"""The layer kernels at every width and head count the reference CLI takes,
on the card: d in (8, 16, 32, 64) with 1, 2, 4 or 8 heads (head widths 1
to 64), the CLI's MetaNet (2d, d) and the 3-matrix (2d, 2d, d).  Each
shape's kernels are built at its first launch (``ops/_build.py``).

* K1: K1-fwd, K1-stash and K1-stash light (the output and every
  residual), K1-scores, then K1-bwd, K1-bwd-stash and K1-bwd-stash light
  through the autograd wrapper, against the plain layer in float64 with
  the same masks; distinct Q and K tables (the 'pos' model) on the light
  pair.
* K7: K7-fwd and K7-stash with the plan's ``tile_count``, K7-bwd and
  K7-bwd-stash, against the plain tiled layer.
* K6: K6-fwd and K6-bwd, gate and bilinear, with 4 table rows and with 16
  (past the shared memory's tables at d = 64, read from device memory).
* The CLI (``satrans_torch.cli.main``) at each width with ``--bank_update
  lazy`` and ``dense``: every layer on its kernels, the plain layer never.

The tolerances are the d = 32 card tests' (``tests/test_torch_kernels.py``):
outputs and residuals within 1e-4, each gradient within 1e-4 of its
largest entry plus 1e-5.  Every test needs an NVIDIA GPU and skips itself
elsewhere; the file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_widths_card.py
"""

import copy
import functools
import tempfile

import pytest
import torch

from satrans_torch.nn import attention, initializers as init, metanet
from satrans_torch.ops import (dispatch, gate_block, meta_block, prng,
                                tiled_meta)
from satrans_torch.utils import make_generator

# (d, heads): every pair of the kernels' widths and head counts
SHAPES = [(d, h) for d in meta_block.KERNEL_WIDTHS
          for h in meta_block.KERNEL_HEADS]
SHAPE_IDS = [f"d{d}h{h}" for d, h in SHAPES]
# dropout on tiles of 16 examples: several tiles and a ragged last one
DROP = dict(seed=2 ** 31 - 3, block_b=16)
B, F = 301, 19
COUNTS = ("launches", "stash_launches", "stash_light_launches",
          "bwd_launches", "stash_bwd_launches", "stash_light_bwd_launches")
PAIR = {"recompute": [1, 0, 0, 1, 0, 0], "stash": [0, 1, 0, 0, 1, 0],
        "stash_light": [0, 0, 1, 0, 0, 1]}


@pytest.fixture(scope="session", autouse=True)
def _built(request):
    """The libraries of every shape the selected tests launch, built at
    once (one ``nvcc`` a core) before the first test: each built at its
    shape's first launch, one after another, they would take minutes."""
    if not torch.cuda.is_available():
        return
    from satrans_torch.ops import _build
    targets = set()
    for item in request.session.items:
        params = getattr(getattr(item, "callspec", None), "params", {})
        if "d" in params:
            d, heads = params["d"], params["heads"]
            targets |= {(n, (d, heads)) for n in ("gate_block_fwd",
                                                  "gate_block_bwd")}
            targets |= {(n, (d, 2 * d, h2, heads))
                        for n in ("meta_block_fwd", "meta_block_bwd")
                        for h2 in (0, 2 * d)}
    _build.build(sorted(targets))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _counts():
    return [getattr(meta_block, c) for c in COUNTS]


def _units(d, h2):
    return [d, 2 * d, d] if h2 == 0 else [d, 2 * d, 2 * d, d]


def _layer(card, d, seed, units, pos=False, rows=4):
    """A layer with its meta LayerNorms moved off their init, and
    ``rows``-row tables of MetaNets of ``units`` (distinct Q and K tables
    for ``pos``)."""
    gen = make_generator(seed, card)
    layer = attention.MetaTransformerLayer(gen, d, share_kv_metanet=not pos)
    with torch.no_grad():
        for meta in ((layer.q_meta, layer.k_meta) if pos
                     else (layer.q_meta,)):
            meta.ln.scale.add_(init.normal(gen, (d,), 0.1))
            meta.ln.bias.add_(init.normal(gen, (d,), 0.1))
    p = metanet.param_size(units)
    q = init.normal(gen, (rows, p), 0.1)
    return gen, layer, {"Q": q, "K": init.normal(gen, (rows, p), 0.1)
                        if pos else q}


def _double(masks):
    return masks and tuple(None if m is None else m.double() for m in masks)


def _kink_free(g, x, layer, tables, dom, masks, kw):
    """``g`` with zero rows for the examples whose relu inputs (the
    MetaNets' hidden layers, the output projection under relu_out) lie
    within 1e-6 of 0 in the float64 plain layer, where float32 rounding
    may put them on either side of the kink."""
    res = {}
    with torch.no_grad():
        meta_block.meta_layer_reference(x, layer, tables, dom, **kw,
                                        masks=masks, residuals=res)
        near = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
        d = x.shape[-1]
        for i, p in enumerate("QK"):
            if p not in kw["mode"]:
                continue
            h = res["qkv"][..., i * d:(i + 1) * d]
            for w in metanet.slice_weights(tables[p],
                                           kw["meta_units"])[:-1]:
                h = torch.einsum("bfi,bio->bfo", h, w[dom.long()])
                near |= (h.abs() < 1e-6).flatten(1).any(1)
                h = torch.relu(h)
        if kw["relu_out"]:
            near |= ((res["o"] @ layer.wout).abs() < 1e-6).flatten(1).any(1)
    return g.masked_fill(near[:, None, None], 0.0)


def _grads(fn, x, layer, tables, dom, g, **kw):
    """Gradients of sum(fn(...) * g) by name: x, the tables (one leaf
    where Q and K share it), the layer's parameters."""
    x = x.detach().requires_grad_(True)
    shared = tables["K"] is tables["Q"]
    leaves = {k: t.detach().requires_grad_(True) for k, t in tables.items()
              if not (shared and k == "K")}
    t = dict(leaves, K=leaves["Q"]) if shared else leaves
    params = dict(layer.named_parameters())
    y = fn(x, layer, t, dom, **kw)
    names = ["x", *(f"table.{k}" for k in leaves), *params]
    got = torch.autograd.grad((y * g).sum(), [x, *leaves.values(),
                                               *params.values()],
                              allow_unused=True)
    return {n: a for n, a in zip(names, got) if a is not None}


def _check_grads(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        err = (got[name].double() - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item() + 1e-5, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("h2", [0, 1], ids=["2-matrix", "3-matrix"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("d,heads", SHAPES, ids=SHAPE_IDS)
def test_k1_forward_bodies_match_plain_version(card, d, heads, h2, rate):
    """K1-fwd (the wrapper without a gradient), K1-stash and K1-stash
    light (the output and every residual) and K1-scores against the
    float64 plain layer with the same masks, QK at 0 and Query with
    relu_out at 0.1; the four modes' y equal bit for bit, K1-scores'
    probabilities K1-stash's."""
    units = _units(d, h2 * 2 * d)
    gen, layer, tables = _layer(card, d, 1, units)
    x = init.normal(gen, (B, F, d), 1.0)
    dom = torch.randint(0, 4, (B,), generator=gen, device=card)
    mode, relu_out = ("QK", False) if rate == 0 else ("Query", True)
    kw = dict(meta_units=units, head_num=heads, mode=mode, relu_out=relu_out)
    drop = dict(train=True, drop_rate=rate, **DROP)
    masks = meta_block.layer_masks(x, head_num=heads, mode=mode, **drop)
    kargs = prng.kernel_args(True, rate, DROP["seed"], DROP["block_b"], F)
    before = _counts() + [meta_block.scores_launches]
    with torch.no_grad():
        y = meta_block.fused_meta_layer(x, layer, tables, dom, **kw, **drop)
        ops, cfg = meta_block.pack_operands(x, layer, tables, dom, **kw)
        full = meta_block.launch_fwd(*ops, cfg, kargs, stash="full")
        light = meta_block.launch_fwd(*ops, cfg, kargs, stash="light")
        scores = meta_block.launch_fwd(*ops, cfg, kargs, stash="scores")
        res = {}
        want = meta_block.meta_layer_reference(
            x.double(), copy.deepcopy(layer).double(),
            {k: t.double() for k, t in tables.items()}, dom, **kw,
            masks=_double(masks), residuals=res)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(
        _counts() + [meta_block.scores_launches], before)] == [1, 1, 1, 0,
                                                              0, 0, 1]
    torch.testing.assert_close(y.double(), want, rtol=1e-4, atol=1e-4)
    for stash, got in (("full", full), ("light", light)):
        names = meta_block.STASH_RESIDUALS[stash]
        for name, a in zip(names, got[1:]):
            torch.testing.assert_close(a.double(), res[name], rtol=1e-4,
                                       atol=1e-4, msg=f"{stash} {name}")
    assert all(torch.equal(y, o[0]) for o in (full, light, scores))
    assert torch.equal(scores[1], full[4])


@pytest.mark.cuda
@pytest.mark.parametrize("h2", [0, 1], ids=["2-matrix", "3-matrix"])
@pytest.mark.parametrize("bwd", ["stash", "stash_light", "recompute"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("d,heads", SHAPES, ids=SHAPE_IDS)
def test_k1_backward_bodies_match_plain_backward(card, d, heads, h2, rate,
                                                 bwd):
    """K1-bwd-stash (with K1-stash), K1-bwd-stash light (with K1-stash
    light, distinct Q and K tables) and K1-bwd (with K1-fwd) through the
    autograd wrapper against autograd of the float64 plain layer with the
    same masks: every gradient, the tables' included."""
    units = _units(d, h2 * 2 * d)
    gen, layer, tables = _layer(card, d, 2, units, pos=bwd == "stash_light")
    x = init.normal(gen, (B, F, d), 1.0)
    g = init.normal(gen, (B, F, d), 1.0)
    dom = torch.randint(0, 4, (B,), generator=gen, device=card)
    mode, relu_out = ("QK", False) if rate == 0 else ("Query", True)
    kw = dict(meta_units=units, head_num=heads, mode=mode, relu_out=relu_out)
    drop = dict(train=True, drop_rate=rate, **DROP)
    masks64 = _double(meta_block.layer_masks(x, head_num=heads, mode=mode,
                                             **drop))
    layer64 = copy.deepcopy(layer).double()
    tables64 = {k: t.double() for k, t in tables.items()}
    if tables["K"] is tables["Q"]:
        tables64["K"] = tables64["Q"]
    g = _kink_free(g.double(), x.double(), layer64, tables64, dom, masks64,
                   kw)
    before = _counts()
    got = _grads(meta_block.fused_meta_layer, x, layer, tables, dom,
                 g.float(), **kw, **drop, bwd=bwd)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_counts(), before)] == PAIR[bwd]
    want = _grads(meta_block.meta_layer_reference, x.double(), layer64,
                  tables64, dom, g, **kw, masks=masks64)
    _check_grads(got, want)


# K7: a composite of 24 rows, dispatch tiles of 16, 256 examples in 15
# occupied rows (most tiles slack)
K7_ROWS, K7_TILE, K7_USED, K7_B = 24, 16, 15, 256


@pytest.mark.cuda
@pytest.mark.parametrize("h2", [0, 1], ids=["2-matrix", "3-matrix"])
@pytest.mark.parametrize("bwd", ["stash", "recompute"])
@pytest.mark.parametrize("d,heads", SHAPES, ids=SHAPE_IDS)
def test_k7_bodies_match_plain_tiled_layer(card, d, heads, h2, bwd):
    """K7-fwd or K7-stash (the output with the plan's tile_count) and
    K7-bwd or K7-bwd-stash (every gradient, the per-tile table blocks'
    included) through the autograd wrapper at dropout 0.1 against the
    float64 plain tiled layer with the same masks."""
    units = _units(d, h2 * 2 * d)
    gen, layer, _ = _layer(card, d, 3, units)
    table = init.normal(gen, (K7_ROWS, metanet.param_size(units)), 0.1)
    used = torch.randperm(K7_ROWS, generator=gen, device=card)[:K7_USED]
    dom = used[torch.randint(0, K7_USED, (K7_B,), generator=gen,
                             device=card)]
    plan = dispatch.plan(dom, K7_ROWS, K7_TILE)
    tq = table[plan.tile_dom.long()]
    x = dispatch.scatter(init.normal(gen, (K7_B, F, d), 1.0), plan)
    g = dispatch.scatter(init.normal(gen, (K7_B, F, d), 1.0), plan)
    rows = tiled_meta.tile_rows(plan.n_slots, K7_TILE, card)
    kw = dict(meta_units=units, head_num=heads, mode="QK", relu_out=False)
    drop = dict(train=True, drop_rate=0.1, seed=DROP["seed"],
                block_b=K7_TILE)
    masks64 = _double(tiled_meta.layer_masks(x, head_num=heads, mode="QK",
                                             **drop))
    layer64 = copy.deepcopy(layer).double()
    t64 = tq.double()
    g = _kink_free(g.double(), x.double(), layer64, {"Q": t64, "K": t64},
                   rows, masks64, kw)
    before = [getattr(tiled_meta, c) for c in (
        "launches", "stash_launches", "bwd_launches", "stash_bwd_launches")]

    def tiled(x, layer, tabs, dom, **extra):
        return tiled_meta.fused_tiled_layer(x, layer, tabs, **extra,
                                            tile_count=plan.tile_count)

    def plain(x, layer, tabs, dom, **extra):
        return tiled_meta.tiled_layer_reference(x, layer, tabs, **extra)

    got = _grads(tiled, x, layer, {"Q": tq, "K": tq}, None, g.float(), **kw,
                 **drop, bwd=bwd)
    torch.cuda.synchronize()
    after = [getattr(tiled_meta, c) for c in (
        "launches", "stash_launches", "bwd_launches", "stash_bwd_launches")]
    assert [a - b for a, b in zip(after, before)] == (
        [0, 1, 0, 1] if bwd == "stash" else [1, 0, 1, 0])
    want = _grads(plain, x.double(), layer64, {"Q": t64, "K": t64}, None, g,
                  **kw, block_b=K7_TILE, masks=masks64)
    _check_grads(got, want)
    with torch.no_grad():
        y = tiled_meta.fused_tiled_layer(x, layer, {"Q": tq, "K": tq}, **kw,
                                         **drop, tile_count=plan.tile_count)
        ref = tiled_meta.tiled_layer_reference(
            x.double(), layer64, {"Q": t64, "K": t64}, **kw,
            block_b=K7_TILE, masks=masks64)
    occ = plan.src >= 0
    torch.testing.assert_close(y[occ].double(), ref[occ], rtol=1e-4,
                               atol=1e-4)
    assert not bool(y[~occ].any())


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [4, 16])
@pytest.mark.parametrize("variant", ["gate", "bilinear"])
@pytest.mark.parametrize("d,heads", SHAPES, ids=SHAPE_IDS)
def test_k6_bodies_match_plain_version(card, d, heads, variant, rows):
    """K6-fwd (without a gradient) and K6-fwd + K6-bwd (through the
    autograd wrapper) at dropout 0.1, gate in QK mode and bilinear, on
    ``rows`` table rows, against the float64 plain layer with the same
    masks."""
    gen = make_generator(4, card)
    layer = attention.MetaTransformerLayer(gen, d, variant=variant)
    names = ("Q", "K") if variant == "gate" else ("bilinear",)
    width = d if variant == "gate" else d * (d // heads)
    tables = {n: init.normal(gen, (rows, width), 0.5) for n in names}
    x = init.normal(gen, (B, F, d), 1.0)
    g = init.normal(gen, (B, F, d), 1.0)
    dom = torch.randint(0, rows, (B,), generator=gen, device=card)
    kw = dict(head_num=heads, mode="QK", relu_out=False)
    drop = dict(train=True, drop_rate=0.1, **DROP)
    masks64 = _double(gate_block.layer_masks(x, head_num=heads, **drop))
    layer64 = copy.deepcopy(layer).double()
    tables64 = {k: t.double() for k, t in tables.items()}
    before = (gate_block.launches, gate_block.bwd_launches)
    with torch.no_grad():
        y = gate_block.fused_simple_layer(x, layer, tables, dom, **kw,
                                          **drop)
        want = gate_block.simple_layer_reference(
            x.double(), layer64, tables64, dom, **kw, masks=masks64)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.double(), want, rtol=1e-4, atol=1e-4)

    def grads(fn, x, layer, tables, g, **extra):
        x = x.detach().requires_grad_(True)
        leaves = {k: t.detach().requires_grad_(True)
                  for k, t in tables.items()}
        params = dict(layer.named_parameters())
        out = fn(x, layer, leaves, dom, **kw, **extra)
        got = torch.autograd.grad((out * g).sum(), [x, *leaves.values(),
                                                     *params.values()],
                                  allow_unused=True)
        return {n: a for n, a in zip(["x", *leaves, *params], got)
                if a is not None}

    got = grads(gate_block.fused_simple_layer, x, layer, tables, g, **drop)
    torch.cuda.synchronize()
    assert (gate_block.launches, gate_block.bwd_launches) == (
        before[0] + 2, before[1] + 1)
    _check_grads(got, grads(gate_block.simple_layer_reference, x.double(),
                            layer64, tables64, g.double(), masks=masks64))


def _plain_calls(monkeypatch):
    """Count the plain layer's calls (``attention.meta_transformer_apply``,
    which every plain route runs) in the returned one-element list."""
    calls, plain = [0], attention.meta_transformer_apply

    def counted(*args, **kw):
        calls[0] += 1
        return plain(*args, **kw)

    monkeypatch.setattr(attention, "meta_transformer_apply", counted)
    return calls


# the CLI's runs: a width and its heads (the JAX package's CLI test's
# --embedding_dim 8 --att_head_num 2, and 1, 4, 8 heads at the others)
CLI_SHAPES = [(8, 2), (16, 1), (32, 4), (64, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("bank", ["lazy", "dense"])
@pytest.mark.parametrize("d,heads", CLI_SHAPES,
                         ids=[f"d{d}h{h}" for d, h in CLI_SHAPES])
def test_cli_runs_on_the_kernels(card, monkeypatch, d, heads, bank):
    """``cli.main`` with ``--embedding_dim d --att_head_num heads`` on
    1,280 synthetic rows (4 training steps of 256, predict and the
    per-domain AUCs): 3 K1-stash and 3 K1-bwd-stash launches a step, K1-fwd
    on the evaluation, no plain layer; the test AUC in [0, 1]."""
    from satrans_torch.cli import main as cli
    calls = _plain_calls(monkeypatch)
    before = _counts()
    with tempfile.TemporaryDirectory() as tmp:
        auc = cli.main(["--data_name", "synthetic", "--synthetic_rows",
                        "1280", "--batch_size", "256", "--embedding_dim",
                        str(d), "--att_head_num", str(heads),
                        "--bank_update", bank, "--results_dir", tmp],
                       device=card)
    torch.cuda.synchronize()
    launched = [a - b for a, b in zip(_counts(), before)]
    assert 0.0 <= auc <= 1.0
    assert calls[0] == 0, f"the plain layer ran {calls[0]} times"
    steps = 4 * 3  # 4 steps of 3 layers
    assert launched[1] == steps and launched[4] == steps, launched
    assert launched[0] > 0 and launched[2:4] == [0, 0], launched


@pytest.mark.cuda
def test_outside_the_set_and_past_the_row_cap_raise(card, monkeypatch):
    """On the card a shape outside the kernels' set raises
    NotImplementedError naming the set; the plain layer never runs in its
    place.  K1 takes the meta rows the JAX package's kernel route takes
    (rows x the widest hidden layer <= 4096: 32 at d = 64 with MetaNet
    (128, 64) and (128, 128, 64)): at the cap its backward runs, one row
    past it the wrapper raises in training, and the model there takes the
    plain layer, as the JAX package takes its XLA layer."""
    calls = _plain_calls(monkeypatch)
    gen = make_generator(5, card)
    for d, heads, units in ((24, 4, [24, 48, 24]), (32, 16, [32, 64, 32]),
                            (32, 4, [32, 32, 32])):
        layer = attention.MetaTransformerLayer(gen, d)
        t = init.normal(gen, (4, metanet.param_size(units)), 0.1)
        x = init.normal(gen, (16, F, d), 1.0)
        dom = torch.zeros(16, dtype=torch.int64, device=card)
        with pytest.raises(NotImplementedError, match="heads in") as e:
            with torch.no_grad():
                meta_block.fused_meta_layer(x, layer, {"Q": t, "K": t}, dom,
                                            meta_units=units, head_num=heads)
        assert str(sorted(meta_block.KERNEL_SHAPES)) in str(e.value)
    for units in ([64, 128, 64], [64, 128, 128, 64]):
        shape = (64, *meta_block.hidden_widths(units), 8)
        assert meta_block.slice_rows(shape) < 32
        for rows in (32, 33):
            _, layer, tables = _layer(card, 64, 6, units, rows=rows)
            x = init.normal(gen, (16, F, 64), 1.0).requires_grad_(True)
            dom = torch.arange(16, device=card) * (rows - 1) // 15
            run = functools.partial(
                meta_block.fused_meta_layer, x, layer, tables, dom,
                meta_units=units, head_num=8, train=True)
            if rows == 33:
                with pytest.raises(NotImplementedError,
                                   match="at most 32 meta rows"):
                    run()
                continue
            before = _counts()
            run().sum().backward()
            torch.cuda.synchronize()
            assert [a - b for a, b in zip(_counts(), before)] == \
                PAIR["stash"]
            assert bool(torch.isfinite(x.grad).all())
    layer = attention.MetaTransformerLayer(gen, 16, variant="gate")
    tabs = {k: init.normal(gen, (4, 16), 0.5) for k in "QK"}
    with pytest.raises(NotImplementedError, match="heads in"):
        with torch.no_grad():
            gate_block.fused_simple_layer(
                init.normal(gen, (16, F, 16), 1.0), layer, tabs,
                torch.zeros(16, dtype=torch.int64, device=card),
                head_num=16)
    assert calls[0] == 0
    from satrans_torch.features import FeatureLayout, SparseFeature
    from satrans_torch.models import SATrans
    layout = FeatureLayout([SparseFeature("f0", 100, 64),
                            SparseFeature("domain", 40, 64)])
    ids = torch.arange(32, device=card)
    batch = {"sparse": torch.stack([ids + 1, ids], 1).int()}
    for domains, layers in ((31, 0), (32, 3)):
        model = SATrans(layout, ["domain"], [domains], att_head_num=8,
                        meta_dnn_hidden_units=(128, 64), device=card)
        assert model.metanet_kernel == (layers == 0)
        model.train()
        calls[0] = 0
        before = _counts()
        model(batch).sum().backward()
        torch.cuda.synchronize()
        assert calls[0] == layers
        assert [a - b for a, b in zip(_counts(), before)] == (
            [3 * c for c in PAIR["stash"]] if layers == 0 else [0] * 6)
