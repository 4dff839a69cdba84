"""K1's and K6's backwards at many meta rows, on the card.

K1's backward keeps every meta row's MetaNet sums in each block's slice up
to ``meta_block.slice_rows`` rows (16; 8 at d = 64 with a 2-matrix MetaNet,
4 with a 3-matrix one); past it the C call sorts the batch by domain row
and the backward tile body walks it in that order, a run of one row split
between blocks summed from their boundary slots (csrc/meta_stash_bwd.cuh,
kSorted), up to the JAX package's cap of meta rows x the widest hidden
layer <= 4096.  K6-bwd keeps every row's table sums in each block's slice
at any row count.

* K1-bwd-stash, K1-bwd-stash light and K1-bwd (through the autograd
  wrapper, after their forwards) at d = 8 / 2 heads on 256 rows, d = 32 /
  4 heads on 17 and 64 rows (2- and 3-matrix MetaNets), d = 64 / 8 heads
  on 9 and 32 rows (2-matrix) and 5 and 32 (3-matrix), half of the batch
  in the last row (its run crosses many blocks) and the rest spread
  (some rows empty), at dropout 0.1, against autograd of the float64
  plain layer with the same masks; K1-bwd-stash at 64 rows on forced
  grids of 1, 3 and 7 blocks, and twice on the card's grid bit for bit.
* K6-bwd, gate at 17, 56, 98 (tables staged in shared memory), 256 and
  1372 rows (read from device memory; 1372 is ``--domain_col 121-122``),
  bilinear at 56 and 128 rows (d = 32, 4
  heads) and 64 (d = 64, 1 head), the same way.

The tolerances are ``tests/test_torch_widths_card.py``'s: outputs within
1e-4, each gradient within 1e-4 of its largest entry plus 1e-5.  Every
test needs an NVIDIA GPU and skips itself elsewhere; the file imports
neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_many_rows_card.py
"""

import copy

import pytest
import torch

from satrans_torch.nn import attention, initializers as init
from satrans_torch.ops import gate_block, meta_block, prng
from satrans_torch.utils import make_generator
from test_torch_widths_card import (DROP, PAIR, _check_grads, _counts,
                                    _double, _grads, _kink_free, _layer,
                                    _units)

B, F = 301, 19
# (d, heads, h2 / 2d, rows): past each shape's slice rows, and at the JAX
# cap (256 at d = 8, 64 at d = 32, 32 at d = 64)
K1_CASES = [(8, 2, 0, 256), (32, 4, 0, 17), (32, 4, 0, 64), (32, 4, 1, 17),
            (32, 4, 1, 64), (64, 8, 0, 9), (64, 8, 0, 32), (64, 8, 1, 5),
            (64, 8, 1, 32)]
K1_IDS = [f"d{d}h{h}-{'3' if m else '2'}mat-{r}rows"
          for d, h, m, r in K1_CASES]
# (variant, d, heads, rows); 1372 is the composite of AliCCP's 121 and 122
# (98 x 14 rows)
K6_CASES = [("gate", 32, 4, 17), ("gate", 32, 4, 56), ("gate", 32, 4, 98),
            ("gate", 32, 4, 256), ("gate", 32, 4, 1372),
            ("bilinear", 32, 4, 56),
            ("bilinear", 32, 4, 128), ("bilinear", 64, 1, 64)]
K6_IDS = [f"{v}-d{d}h{h}-{r}rows" for v, d, h, r in K6_CASES]


@pytest.fixture(scope="session", autouse=True)
def _built():
    """The libraries of every shape here, built at once (one ``nvcc`` a
    core) before the first test."""
    if not torch.cuda.is_available():
        return
    from satrans_torch.ops import _build
    targets = {("meta_block_" + s, (d, 2 * d, m * 2 * d, h))
               for d, h, m, _ in K1_CASES for s in ("fwd", "bwd")}
    targets |= {("gate_block_" + s, (d, h)) for _, d, h, _ in K6_CASES
                for s in ("fwd", "bwd")}
    _build.build(sorted(targets))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _dom(gen, rows, card):
    """Rows uniform over [0, rows), then every second example in the last
    row: a run of half the batch."""
    dom = torch.randint(0, rows, (B,), generator=gen, device=card)
    dom[::2] = rows - 1
    return dom


def _k1_case(card, d, heads, h2, rows, bwd, seed=2):
    units = _units(d, h2 * 2 * d)
    gen, layer, tables = _layer(card, d, seed, units,
                                pos=bwd == "stash_light", rows=rows)
    x = init.normal(gen, (B, F, d), 1.0)
    g = init.normal(gen, (B, F, d), 1.0)
    dom = _dom(gen, rows, card)
    kw = dict(meta_units=units, head_num=heads, mode="QK", relu_out=False)
    drop = dict(train=True, drop_rate=0.1, **DROP)
    masks64 = _double(meta_block.layer_masks(x, head_num=heads, mode="QK",
                                             **drop))
    layer64 = copy.deepcopy(layer).double()
    tables64 = {k: t.double() for k, t in tables.items()}
    if tables["K"] is tables["Q"]:
        tables64["K"] = tables64["Q"]
    g = _kink_free(g.double(), x.double(), layer64, tables64, dom, masks64,
                   kw)
    want = _grads(meta_block.meta_layer_reference, x.double(), layer64,
                  tables64, dom, g, **kw, masks=masks64)
    return layer, tables, x, g.float(), dom, kw, drop, want


@pytest.mark.cuda
@pytest.mark.parametrize("bwd", ["stash", "stash_light", "recompute"])
@pytest.mark.parametrize("d,heads,h2,rows", K1_CASES, ids=K1_IDS)
def test_k1_backward_many_rows_matches_plain_backward(card, d, heads, h2,
                                                      rows, bwd):
    shape = (d, 2 * d, h2 * 2 * d, heads)
    assert meta_block.slice_rows(shape) < rows
    layer, tables, x, g, dom, kw, drop, want = _k1_case(
        card, d, heads, h2, rows, bwd)
    before = _counts()
    got = _grads(meta_block.fused_meta_layer, x, layer, tables, dom, g,
                 **kw, **drop, bwd=bwd)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_counts(), before)] == PAIR[bwd]
    _check_grads(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [1, 3, 7, None])
def test_k1_backward_many_rows_on_grids(card, monkeypatch, blocks):
    """K1-bwd-stash at d = 32 on 64 rows on forced grids (one block: every
    row's run in one block; 3 and 7: runs through whole blocks) and on the
    card's grid, twice there bit for bit."""
    layer, tables, x, g, dom, kw, drop, want = _k1_case(
        card, 32, 4, 0, 64, "stash", seed=3)
    if blocks:
        monkeypatch.setattr(meta_block, "sm_count", lambda device: blocks)
    got = _grads(meta_block.fused_meta_layer, x, layer, tables, dom, g,
                 **kw, **drop, bwd="stash")
    _check_grads(got, want)
    if blocks is None:
        again = _grads(meta_block.fused_meta_layer, x, layer, tables, dom,
                       g, **kw, **drop, bwd="stash")
        torch.cuda.synchronize()
        for name, v in got.items():
            assert torch.equal(v, again[name]), name


@pytest.mark.cuda
@pytest.mark.parametrize("variant,d,heads,rows", K6_CASES, ids=K6_IDS)
def test_k6_backward_many_rows_matches_plain_backward(card, variant, d,
                                                      heads, rows):
    gen = make_generator(4, card)
    layer = attention.MetaTransformerLayer(gen, d, variant=variant)
    names = ("Q", "K") if variant == "gate" else ("bilinear",)
    width = d if variant == "gate" else d * (d // heads)
    tables = {n: init.normal(gen, (rows, width), 0.5) for n in names}
    x = init.normal(gen, (B, F, d), 1.0)
    g = init.normal(gen, (B, F, d), 1.0)
    dom = _dom(gen, rows, card)
    kw = dict(head_num=heads, mode="QK", relu_out=False)
    drop = dict(train=True, drop_rate=0.1, **DROP)
    masks64 = _double(gate_block.layer_masks(x, head_num=heads, **drop))
    layer64 = copy.deepcopy(layer).double()
    tables64 = {k: t.double() for k, t in tables.items()}
    with torch.no_grad():
        y = gate_block.fused_simple_layer(x, layer, tables, dom, **kw,
                                          **drop)
        ref = gate_block.simple_layer_reference(
            x.double(), layer64, tables64, dom, **kw, masks=masks64)
    torch.testing.assert_close(y.double(), ref, rtol=1e-4, atol=1e-4)

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

    before = gate_block.bwd_launches
    got = grads(gate_block.fused_simple_layer, x, layer, tables, g, **drop)
    torch.cuda.synchronize()
    assert gate_block.bwd_launches == before + 1
    _check_grads(got, grads(gate_block.simple_layer_reference, x.double(),
                            layer64, tables64, g.double(), masks=masks64))
    ops, cfg = gate_block.pack_operands(x, layer, tables, dom, **kw)
    kargs = prng.kernel_args(True, 0.1, DROP["seed"], DROP["block_b"], F,
                             pad_mult=gate_block.PAD_FIELDS)
    with torch.no_grad():
        one = gate_block.launch_bwd(g, *[t.detach() for t in ops], cfg,
                                    kargs)
        two = gate_block.launch_bwd(g, *[t.detach() for t in ops], cfg,
                                    kargs)
    torch.cuda.synchronize()
    assert (one[3] is None) == (variant == "bilinear")
    for a, b in zip(one, two):
        assert (a is None and b is None) or torch.equal(a, b)
