"""The Predictor's CUDA graph (``aot_compile``) and its pinned staging
(``pipeline_depth``) on the card, at a small size (d = 32, 4 heads: the
layer kernels' default shapes).  Each test skips without a CUDA device
(the JAX package is not imported: the card's machine has none).

* For every family the Predictor serves (SATrans metanet, 3-matrix,
  Query with relu_out, gate, bilinear, bilinear with only_emb, pos with
  the metanet and the gate, multicol on K7 and on K6, per-example tables,
  the baseline zoo, STAR and the multi-task models, the legacy Star-Trans
  models): the capture's launches by kernel, and the graph's scores at
  depths 1 to 4 (the call's keyword and the constructor's) equal to the
  eager Predictor's bit for bit, with no counter moving under replay.
* A capture that meets a host synchronisation raises naming the model;
  a kernel library or a device constant first needed inside a capture
  raises.
* A parameter updated in place is served as it now is; one replaced by
  another tensor, a ``load_state_dict``, ``checkpoint.load_model`` and a
  new ``domain_id_offset`` are never served from a stale graph.
* A Predictor of a trainer's model scores in eval mode after the
  trainer's steps left the model in training.
"""

import numpy as np
import pytest
import torch
from torch import nn

import satrans_torch
from satrans_torch import embeddings
from satrans_torch.features import DenseFeature, SparseFeature, \
    VarLenSparseFeature
from satrans_torch.models import MODEL_REGISTRY
from satrans_torch.ops import _build, launch_counts
from satrans_torch.serving import Predictor
from satrans_torch.train import checkpoint

D, HEADS, LAYERS, BATCH, N = 32, 4, 2, 64, 200
DEPTHS = (1, 2, 3, 4)
K1, K6, K7 = ({"meta_block_fwd": LAYERS}, {"gate_block_fwd": LAYERS},
              {"tiled_meta_fwd": LAYERS})
# SATrans families: (keywords, scenario columns, their domains, the
# launches of one captured batch)
SATRANS = {
    "metanet": ({}, ["domain"], [3], K1),
    "metanet-Query-relu_out": (dict(meta_mode="Query", relu_out=True),
                               ["domain"], [3], K1),
    "metanet3": (dict(meta_dnn_hidden_units=(64, 64, 32)), ["domain"], [3],
                 K1),
    "gate": (dict(variant="gate"), ["domain"], [3], K6),
    "bilinear": (dict(variant="bilinear"), ["domain"], [3], K6),
    "bilinear-only_emb": (dict(variant="bilinear", only_emb=True),
                          ["domain"], [3], K6),
    "pos": (dict(use_pos=True), ["domain"], [3], K1),
    "pos-gate": (dict(use_pos=True, variant="gate"), ["domain"], [3], K6),
    "multicol": ({}, ["domain", "dom2"], [3, 13], K7),
    "multicol-gate": (dict(variant="gate"), ["domain", "dom2"], [3, 13],
                      K6),
    "per_example": ({}, ["domain", "f0"], [3, 299], {}),
}
SMALL = dict(dnn_hidden_units=(16, 8))
DOM = dict(domain_col="domain")
# the other models: (name, keywords), none with a layer kernel
OTHERS = {
    "WDL": ("WDL", SMALL), "DeepFM": ("DeepFM", SMALL),
    "DCN": ("DCN", SMALL), "xDeepFM": ("xDeepFM", dict(
        SMALL, cin_layer_size=(8, 4))), "NFM": ("NFM", SMALL),
    "AFM": ("AFM", {}), "PNN": ("PNN", dict(SMALL, use_outter=True)),
    "AutoInt": ("AutoInt", dict(SMALL, att_layer_num=2)),
    "FiBiNET": ("FiBiNET", SMALL),
    "AdaSparse": ("AdaSparse", dict(SMALL, num_domains=3, **DOM)),
    "Star_Net": ("Star_Net", dict(DOM, num_domains=3,
                                  dnn_hidden_units=(16, 8))),
    "SharedBottom": ("SharedBottom", dict(
        DOM, num_tasks=3, bottom_dnn_hidden_units=(16, 8))),
    "MMOE": ("MMOE", dict(DOM, num_tasks=3,
                          expert_dnn_hidden_units=(16, 8))),
    "PLE": ("PLE", dict(DOM, num_tasks=3, expert_dnn_hidden_units=(16, 8))),
    "ESMM": ("ESMM", dict(DOM, num_tasks=2)),
    "Star_Trans": ("Star_Trans", dict(DOM, num_domains=3, att_layer_num=1,
                                      domain_att_layer_num=LAYERS)),
    "Starv2_Trans": ("Starv2_Trans", dict(
        DOM, num_domains=3, att_layer_num=1, domain_att_layer_num=LAYERS)),
    "Starv3_Trans": ("Starv3_Trans", dict(
        DOM, num_domains=3, att_layer_num=1, domain_att_layer_num=LAYERS)),
    "Starv4_Trans": ("Starv4_Trans", dict(
        DOM, num_domains=3, att_layer_num=1, domain_att_layer_num=LAYERS)),
}
LEGACY = {"Star_Trans", "Starv2_Trans", "Starv3_Trans", "Starv4_Trans"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _layout(legacy=False):
    """Two large fields, the scenario columns, and (but for the legacy
    models) a varlen field and a dense one."""
    cols = [SparseFeature("f0", 300, D), SparseFeature("f1", 500, D),
            SparseFeature("domain", 5, D)]
    if not legacy:
        cols += [SparseFeature("dom2", 15, D),
                 VarLenSparseFeature("hist", 300, D, 3, "mean"),
                 DenseFeature("price", 1)]
    return satrans_torch.FeatureLayout(cols)


def _request(n=N, seed=0, legacy=False):
    rng = np.random.default_rng(seed)
    x = {"f0": rng.integers(1, 300, n), "f1": rng.integers(1, 500, n),
         "domain": rng.integers(1, 4, n)}
    if not legacy:
        x.update(dom2=rng.integers(0, 14, n),
                 hist=rng.integers(0, 300, (n, 3)),
                 price=rng.random(n).astype(np.float32))
    return x


def _satrans(family, dev, **over):
    kw, cols, domains, _ = SATRANS[family]
    kw = dict(dict(domain_att_layer_num=LAYERS, att_head_num=HEADS,
                   meta_dnn_hidden_units=(64, 32), no_emb_init=True,
                   seed=3), **kw, **over)
    return MODEL_REGISTRY["SATrans"](_layout(), cols, domains, device=dev,
                                     **kw)


def _model(family, dev):
    if family in SATRANS:
        return _satrans(family, dev)
    name, kw = OTHERS[family]
    model = MODEL_REGISTRY[name](_layout(family in LEGACY), device=dev,
                                 **kw)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    with torch.no_grad():  # parameters that move the scores
        for p in model.parameters():
            p.normal_(0.0, 0.1, generator=gen)
    return model


@pytest.mark.cuda
@pytest.mark.parametrize("family", list(SATRANS) + list(OTHERS))
def test_graph_equals_eager_at_every_depth(card, family):
    model = _model(family, card)
    x = _request(legacy=family in LEGACY)
    pred = Predictor(model, batch_size=BATCH, device=card)
    assert pred.aot_compile() is pred and pred.graph is not None
    want = SATRANS[family][3] if family in SATRANS else {}
    assert pred.captured_launches == want
    eager = Predictor(model, batch_size=BATCH, device=card)(x)
    assert eager.dtype == np.float64 and eager.shape == (N,)
    assert np.isfinite(eager).all() and eager.std() > 1e-4
    before = launch_counts()
    pred.graph.replays = 0
    for depth in DEPTHS:
        np.testing.assert_array_equal(pred(x, pipeline_depth=depth), eager)
    assert launch_counts() == before  # a replay moves no counter
    batches = -(-N // BATCH)
    assert pred.graph.replays == len(DEPTHS) * batches
    assert pred.launches() == {k: n * len(DEPTHS) * batches
                               for k, n in want.items()}
    for depth in (0, 2, 4):
        deep = Predictor(model, batch_size=BATCH, pipeline_depth=depth,
                         device=card).aot_compile()
        assert deep.pipeline_depth == max(1, depth)
        np.testing.assert_array_equal(deep(x), eager)


class Syncing(nn.Module):
    """A model whose forward reads a value back to the host."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner
        self.layout = inner.layout

    def forward(self, batch):
        pred = self.inner(batch)
        if float(pred.sum()) > -1.0:  # a host synchronisation
            return pred
        return -pred


@pytest.mark.cuda
def test_capture_meeting_a_host_sync_raises(card):
    model = _satrans("metanet", card)
    with pytest.raises(RuntimeError, match="capturing the score of Syncing"):
        Predictor(Syncing(model), batch_size=BATCH,
                  device=card).aot_compile()
    torch.cuda.synchronize()
    # the card serves on
    x = _request()
    pred = Predictor(model, batch_size=BATCH, device=card).aot_compile()
    np.testing.assert_array_equal(
        pred(x), Predictor(model, batch_size=BATCH, device=card)(x))


@pytest.mark.cuda
def test_first_use_inside_a_capture_raises(card):
    key = ("bank_rows", None)
    _build.load(*key)
    lib = _build._LIBS.pop(key)
    try:
        graph = torch.cuda.CUDAGraph()
        with pytest.raises(RuntimeError, match="inside a CUDA graph"):
            with torch.cuda.graph(graph):
                _build.load(*key)
    finally:
        _build._LIBS[key] = lib
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="inside a CUDA graph"):
        with torch.cuda.graph(graph):
            embeddings.device_constant((2, 7, 1, 8, 2, 8), card)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_replaced_parameters_are_never_served_stale(card):
    x = _request()
    model = _satrans("metanet", card)
    pred = Predictor(model, batch_size=BATCH, device=card).aot_compile()

    def fresh():
        return Predictor(model, batch_size=BATCH, device=card)(x)

    first, graph = pred(x), pred.graph
    np.testing.assert_array_equal(first, fresh())
    # in place: the same graph reads the new values
    with torch.no_grad():
        model.head.w.mul_(2.0)
    got = pred(x)
    assert pred.graph is graph and not np.array_equal(got, first)
    np.testing.assert_array_equal(got, fresh())
    # load_state_dict and checkpoint.load_model copy in place too
    other = _satrans("metanet", card, seed=11)
    model.load_state_dict(other.state_dict())
    got = pred(x)
    assert pred.graph is graph
    np.testing.assert_array_equal(got, fresh())
    model.head.w.data.normal_()  # restore a different head in place
    checkpoint.load_model({"params": other.state_dict(), "meta": {
        "domain_id_offset": checkpoint._NO_OFFSET}}, model)
    np.testing.assert_array_equal(pred(x), fresh())
    # a parameter replaced by another tensor: captured anew
    model.head.w = nn.Parameter(model.head.w.detach() * 3.0)
    got = pred(x)
    assert pred.graph is not graph
    np.testing.assert_array_equal(got, fresh())
    # a new domain_id_offset of a multi-task model: captured anew
    mmoe = _model("MMOE", card)
    routed = Predictor(mmoe, batch_size=BATCH, device=card).aot_compile()
    graph = routed.graph
    np.testing.assert_array_equal(
        routed(x), Predictor(mmoe, batch_size=BATCH, device=card)(x))
    mmoe.set_domain_offset(2)
    got = routed(x)
    assert routed.graph is not graph
    np.testing.assert_array_equal(
        got, Predictor(mmoe, batch_size=BATCH, device=card)(x))


@pytest.mark.cuda
def test_scores_in_eval_mode_after_training_steps(card):
    from satrans_torch.train import Trainer
    x = _request()
    y = np.random.default_rng(1).integers(0, 2, N).astype(np.float32)
    tr = Trainer(_satrans("metanet", card), seed=7, device=card).compile(
        learning_rate=0.01)
    pred = Predictor.from_trainer(tr, batch_size=BATCH).aot_compile()
    before = pred(x)
    tr.fit(x, y, batch_size=BATCH, verbose=0)
    tr.model.train()  # as a step leaves it (dropout 0.1)
    got = pred(x)
    assert not tr.model.training and not np.array_equal(got, before)
    np.testing.assert_array_equal(
        got, Predictor(tr.model, batch_size=BATCH, device=card)(x))
    np.testing.assert_array_equal(got, pred(x, pipeline_depth=2))
