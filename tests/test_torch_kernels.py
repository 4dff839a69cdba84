"""The port's CUDA kernels against their plain PyTorch versions on the card:
the layer forward (K1-fwd) against ``meta_layer_reference`` and the layer
backward (K1-bwd) against autograd of it.

Every test here needs an NVIDIA GPU and skips itself elsewhere.  The file
imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels.py
"""

import pytest
import torch

from satrans_torch.nn import attention, initializers as init, metanet
from satrans_torch.ops import meta_block
from satrans_torch.utils import make_generator

MODES = [("QK", False), ("QK", True), ("Query", False), ("Query", True)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,relu_out", MODES)
@pytest.mark.parametrize("F", [19, 7])
def test_meta_block_kernel_matches_plain_version(card, mode, relu_out, F):
    """A ragged batch (33 is not a multiple of the kernel's 8-example
    tile).  atol 1e-4 / rtol 1e-4: float32 with other summation orders, and
    expf/rsqrtf against torch's exp/rsqrt, on LayerNormed outputs of order
    1."""
    gen = make_generator(0, card)
    d, h, heads = 32, 64, 4
    units = [d, h, d]
    layer = attention.MetaTransformerLayer(gen, d)
    with torch.no_grad():
        layer.q_meta.ln.scale.add_(init.normal(gen, (d,), 0.1))
        layer.q_meta.ln.bias.add_(init.normal(gen, (d,), 0.1))
    table = init.normal(gen, (4, metanet.param_size(units)), 0.1)
    x = init.normal(gen, (33, F, d), 1.0)
    dom = torch.randint(0, 4, (33,), generator=gen, device=card)
    kw = dict(meta_units=units, head_num=heads, mode=mode, relu_out=relu_out)
    before = meta_block.launches
    with torch.no_grad():
        got = meta_block.fused_meta_layer(x, layer, {"Q": table, "K": table},
                                          dom, **kw)
        want = meta_block.meta_layer_reference(
            x, layer, {"Q": table, "K": table}, dom, **kw)
    torch.cuda.synchronize()
    assert meta_block.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


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
@pytest.mark.parametrize("mode,relu_out", MODES)
@pytest.mark.parametrize("B,F", [(33, 7), (33, 19), (8192, 19)])
def test_meta_block_bwd_kernel_matches_plain_backward(card, mode, relu_out,
                                                      B, F):
    """K1-bwd (through the autograd wrapper) against autograd of the plain
    layer, at a small ragged batch and at the full AliCCP sota shape.
    Each gradient within 1e-4 of the plain one relative to the largest
    entry of that gradient (plus 1e-5): the parameter gradients are sums
    over up to B * F = 155,648 rows taken in another order."""
    gen = make_generator(1, card)
    d, h, heads = 32, 64, 4
    units = [d, h, d]
    layer = attention.MetaTransformerLayer(gen, d)
    with torch.no_grad():
        layer.q_meta.ln.scale.add_(init.normal(gen, (d,), 0.1))
        layer.q_meta.ln.bias.add_(init.normal(gen, (d,), 0.1))
    table = init.normal(gen, (4, metanet.param_size(units)), 0.1)
    x = init.normal(gen, (B, F, d), 1.0)
    g = init.normal(gen, (B, F, d), 1.0)
    dom = torch.randint(0, 4, (B,), generator=gen, device=card)
    kw = dict(meta_units=units, head_num=heads, mode=mode, relu_out=relu_out)
    before = (meta_block.launches, meta_block.bwd_launches)
    got = _grads(meta_block.fused_meta_layer, x, layer, table, dom, g, **kw)
    torch.cuda.synchronize()
    assert (meta_block.launches, meta_block.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    want = _grads(meta_block.meta_layer_reference, x, layer, table, dom, g,
                  **kw)
    assert set(got) == set(want)
    for name, w in want.items():
        err = (got[name] - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item() + 1e-5, (name, err)
