"""The legacy Star-Trans models and SATrans past SATRANS_COMPOSITE_MAX on
the card, at a small size: the checks of ``chip_smoke.py`` phase 20.
Each test skips without a CUDA device (the JAX package is not imported:
the card's machine has none).

* Each legacy configuration of the CPU tests (``merge`` no / sum / dot,
  ``trans``, per-domain heads, Starv2 with and without the FFN, Starv3
  plain, ``layerid-qkvid-cat`` and ``large-norelu``, Starv4 with and
  without ``aggmap``) and the per-example SATrans (``domain`` x ``f0``,
  1,200 combinations: metanet, gate, bilinear and pos): the eval forward
  on the card against a CPU copy (parameters N(0, 0.1)) within 1e-5, and
  the train-mode forward at dropout 0.1 with one key (the same masks on
  both devices) with its aux loss.
* ``lazy`` steps launch K4 twice, K2 once and K3 once a step with the
  split tail, K4, K3 and K5 once with ``SATRANS_LAZY_TAIL=fused``, and no
  layer kernel; Starv2's aux loss is finite and above 0 at every step.
"""

import copy

import numpy as np
import pytest
import torch

import satrans_torch
from satrans_torch.features import SparseFeature
from satrans_torch.models import (SATrans, StarTrans, Starv2Trans,
                                  Starv3Trans, Starv4Trans)
from satrans_torch.ops import (eqgemm, gate_block, gather, lazy_tail,
                               meta_block, scatter, threefry, tiled_meta)
from satrans_torch.train import Trainer

D_EMB, BATCH, N = 8, 64, 200
LEGACY = {
    "StarTrans-no": (StarTrans, {"merge": "no"}),
    "StarTrans-sum": (StarTrans, {"merge": "sum"}),
    "StarTrans-dot": (StarTrans, {"merge": "dot"}),
    "StarTrans-trans": (StarTrans, {"att_layer_type": "trans"}),
    "StarTrans-domhead": (StarTrans, {"use_domain_dnn_linear": True}),
    "Starv2": (Starv2Trans, {}),
    "Starv2-ffn": (Starv2Trans, {"att_layer_type": "trans"}),
    "Starv3": (Starv3Trans, {}),
    "Starv3-pos": (Starv3Trans, {"flag": "layerid-qkvid-cat"}),
    "Starv3-large": (Starv3Trans, {"flag": "large-norelu"}),
    "Starv4": (Starv4Trans, {}),
    "Starv4-aggmap": (Starv4Trans, {"flag": "aggmap"}),
}
PER_EXAMPLE = {"SATrans-metanet": {}, "SATrans-gate": {"variant": "gate"},
               "SATrans-bilinear": {"variant": "bilinear"},
               "SATrans-pos": {"use_pos": True}}
CASES = list(LEGACY) + list(PER_EXAMPLE)
ROWS = (gather, scatter, eqgemm, lazy_tail)
# every layer kernel's launch count, by module
LAYER_COUNTS = {
    meta_block: ("launches", "stash_launches", "stash_light_launches",
                 "scores_launches", "bwd_launches", "stash_bwd_launches",
                 "stash_light_bwd_launches"),
    tiled_meta: ("launches", "stash_launches", "bwd_launches",
                 "stash_bwd_launches"),
    gate_block: ("launches", "bwd_launches"),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _layout():
    """Two large fields and the scenario column."""
    return satrans_torch.FeatureLayout(
        [SparseFeature("f0", 300, D_EMB), SparseFeature("f1", 500, D_EMB),
         SparseFeature("domain", 5, D_EMB)])


def _model(case, dev):
    if case in LEGACY:
        cls, kw = LEGACY[case]
        return cls(_layout(), domain_col="domain", num_domains=3,
                   att_layer_num=1, domain_att_layer_num=2, device=dev, **kw)
    model = SATrans(_layout(), ["domain", "f0"], [3, 299],
                    domain_att_layer_num=2, att_head_num=2,
                    meta_dnn_hidden_units=(16, D_EMB), device=dev,
                    **PER_EXAMPLE[case])
    assert model.per_example
    return model


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = {"f0": rng.integers(1, 300, N), "f1": rng.integers(1, 500, N),
         "domain": rng.integers(1, 4, N)}
    return x, rng.integers(0, 2, N).astype(np.float32)


def _layer_launches():
    return [getattr(m, n) for m, names in LAYER_COUNTS.items()
            for n in names]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_forward_on_card_matches_cpu(card, case):
    model = _model(case, card)
    x, _ = _data()
    gen = torch.Generator(device=card).manual_seed(3)
    data = model.layout.batch_from_dict(x)
    key = threefry.PRNGKey(5)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.1, generator=gen)
        host = copy.deepcopy(model).cpu()
        batch = {k: torch.from_numpy(v) for k, v in data.items()}
        on_card = {k: v.to(card) for k, v in batch.items()}
        got = model.eval()(on_card).cpu()
        want = host.eval()(batch)
        assert got.std() > 1e-3
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        got = model.train()(on_card, key=key)
        want = host.train()(batch, key=key)
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)
        if case in LEGACY:
            _, aux = model(on_card, key=key, return_aux=True)
            _, want_aux = host(batch, key=key, return_aux=True)
            torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("tail", ["split", "fused"])
@pytest.mark.parametrize("case", CASES)
def test_lazy_steps_launch_the_row_kernels(card, monkeypatch, case, tail):
    if tail == "fused":
        monkeypatch.setenv("SATRANS_LAZY_TAIL", "fused")
    x, y = _data()
    for m in ROWS:
        monkeypatch.setattr(m, "launches", 0)
    for m, names in LAYER_COUNTS.items():
        for n in names:
            monkeypatch.setattr(m, n, 0)
    tr = Trainer(_model(case, card), seed=5, device=card)
    tr.compile(learning_rate=0.01, bank_update="lazy")
    stats, step = [], tr.train_step
    tr.train_step = lambda *a: stats.append(step(*a)) or stats[-1]
    tr.fit({k: v[:3 * BATCH] for k, v in x.items()}, y[:3 * BATCH],
           batch_size=BATCH, verbose=0)
    torch.cuda.synchronize()
    want = (2, 1, 1, 0) if tail == "split" else (1, 0, 1, 1)
    assert tuple(m.launches for m in ROWS) == tuple(3 * n for n in want)
    assert not any(_layer_launches())
    aux = np.array([float(s["aux_loss"]) for s in stats])
    assert len(aux) == 3 and np.isfinite(aux).all()
    assert (aux > 0).all() if case.startswith("Starv2") else not aux.any()
