"""STAR and the multi-task models on the card, at a small size: the
checks of ``chip_smoke.py`` phase 17.  Each test skips without a CUDA
device (the JAX package is not imported: the card's machine has none).

* Each model's eval forward on the card against a CPU copy (parameters
  N(0, 0.1), STAR's BatchNorm statistics moved by train-mode forwards),
  within 1e-5.
* ``lazy`` steps launch K4 twice, K2 once and K3 once a step with the
  split tail, K4, K3 and K5 once with ``SATRANS_LAZY_TAIL=fused``.
* STAR ``fused`` equals ``dense`` bit for bit after 3 steps, every
  parameter and BatchNorm buffer; each domain's count is 3; a batch with
  no domain-3 example keeps domain 3's mean and var.
* MMOE's routed ``predict`` equals its ``Predictor`` and the
  ``Predictor`` of ``serving.load`` bit for bit, each score its
  domain's head.
"""

import copy

import numpy as np
import pytest
import torch

import satrans_torch
from satrans_torch import serving
from satrans_torch.features import SparseFeature
from satrans_torch.models import MODEL_REGISTRY
from satrans_torch.ops import eqgemm, gather, lazy_tail, scatter
from satrans_torch.train import Trainer

D_EMB, BATCH, N = 8, 64, 200
SMALL = {
    "Star_Net": dict(num_domains=3, dnn_hidden_units=(16, 8)),
    "SharedBottom": dict(num_tasks=3, bottom_dnn_hidden_units=(16, 8)),
    "MMOE": dict(num_tasks=3, expert_dnn_hidden_units=(16, 8)),
    "PLE": dict(num_tasks=3, expert_dnn_hidden_units=(16, 8)),
    "ESMM": dict(num_tasks=2, tower_dnn_hidden_units=(16, 8)),
}
ROWS = (gather, scatter, eqgemm, lazy_tail)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _layout():
    """Two large fields and the scenario column (the equality combine's
    one-lookup gather plan)."""
    return satrans_torch.FeatureLayout(
        [SparseFeature("f0", 300, D_EMB), SparseFeature("f1", 500, D_EMB),
         SparseFeature("domain", 5, D_EMB)])


def _model(name, dev, **kw):
    return MODEL_REGISTRY[name](_layout(), domain_col="domain", device=dev,
                                **SMALL[name], **kw)


def _data(name, seed=0):
    rng = np.random.default_rng(seed)
    x = {"f0": rng.integers(1, 300, N), "f1": rng.integers(1, 500, N),
         "domain": rng.integers(1, 3 if name == "ESMM" else 4, N)}
    return x, rng.integers(0, 2, N).astype(np.float32)


def _fit(model, dev, mode, x, y, steps=3):
    tr = Trainer(model, seed=5, device=dev)
    tr.compile(learning_rate=0.01, bank_update=mode)
    n = steps * BATCH
    tr.fit({k: v[:n] for k, v in x.items()}, y[:n], batch_size=BATCH,
           verbose=0)
    torch.cuda.synchronize()
    return tr


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SMALL))
def test_forward_on_card_matches_cpu(card, name):
    model = _model(name, card)
    x, y = _data(name)
    if name == "Star_Net":
        _fit(model, card, "dense", x, y)  # the statistics move
        assert [int(b.count) for b in model.bn] == [3, 3, 3]
    gen = torch.Generator(device=card).manual_seed(3)
    batch = model.layout.batch_from_dict(x)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.1, generator=gen)
        model.eval()
        got = model({k: torch.from_numpy(v).to(card)
                     for k, v in batch.items()}).cpu()
        want = copy.deepcopy(model).cpu()(
            {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.std() > 1e-3
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("tail", ["split", "fused"])
@pytest.mark.parametrize("name", list(SMALL))
def test_lazy_steps_launch_the_row_kernels(card, monkeypatch, name, tail):
    if tail == "fused":
        monkeypatch.setenv("SATRANS_LAZY_TAIL", "fused")
    x, y = _data(name)
    for m in ROWS:
        monkeypatch.setattr(m, "launches", 0)
    _fit(_model(name, card), card, "lazy", x, y)
    want = (2, 1, 1, 0) if tail == "split" else (1, 0, 1, 1)
    assert tuple(m.launches for m in ROWS) == tuple(3 * n for n in want)


@pytest.mark.cuda
def test_star_fused_equals_dense(card):
    x, y = _data("Star_Net")
    models = {}
    for mode in ("dense", "fused"):
        models[mode] = _model("Star_Net", card)
        tr = _fit(models[mode], card, mode, x, y)
    dense, fused = (m.state_dict() for m in (models["dense"],
                                              models["fused"]))
    for k, v in dense.items():
        assert torch.equal(fused[k], v), k
    model = models["fused"]
    assert [int(b.count) for b in model.bn] == [3, 3, 3]
    before = {k: v.clone() for k, v in model.named_buffers()}
    x2 = {k: v[:BATCH] for k, v in x.items()}
    x2["domain"] = np.where(x2["domain"] == 3, 1, x2["domain"])
    tr.fit(x2, y[:BATCH], batch_size=BATCH, verbose=0)
    for d in range(3):
        for k in ("mean", "var"):
            same = torch.equal(getattr(model.bn[d], k), before[f"bn.{d}.{k}"])
            assert same == (d == 2), (d, k)
    assert [int(b.count) for b in model.bn] == [4, 4, 4]


@pytest.mark.cuda
def test_mmoe_predict_predictor_and_loaded_predictor(card, tmp_path):
    x, y = _data("MMOE")
    model = _model("MMOE", card)
    tr = _fit(model, card, "lazy", x, y)
    pred = tr.predict(x, batch_size=BATCH)
    assert np.array_equal(
        serving.Predictor.from_trainer(tr, batch_size=BATCH)(x), pred)
    path = str(tmp_path / "mmoe")
    serving.save(path, tr)
    fresh = _model("MMOE", card)
    fresh.set_domain_offset(7)
    assert np.array_equal(serving.load(path, fresh, batch_size=BATCH,
                                       device=card)(x), pred)
    assert fresh.domain_id_offset == 1
    data = model.layout.batch_from_dict(x)
    with torch.no_grad():
        heads = torch.cat([model.eval()({
            k: torch.from_numpy(Trainer._pad(v[s:s + BATCH], BATCH)).to(card)
            for k, v in data.items()}) for s in range(0, N, BATCH)]).cpu()
    assert np.array_equal(pred, heads.numpy()[np.arange(N), x["domain"] - 1]
                          .astype("float64"))
