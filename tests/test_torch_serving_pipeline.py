"""The port's ``Predictor.aot_compile`` and ``pipeline_depth`` against
the JAX package's, and the three serving instruments on the CPU.

* ``Predictor(..., device="cpu").aot_compile()`` (the warmup: the CPU has
  no graph) against the JAX ``Predictor.from_trainer(...).aot_compile()``
  on the same weights, a request of 100 at batch 32 (a padded tail),
  ``atol=1e-5``.
* Depths 1 to 4, as the constructor's argument and the call's keyword,
  bit for bit; the depth stored as the JAX package stores it (0 -> 1).
* MMOE routed at depth 2 against the JAX ``Predictor`` at depth 2.
* ``bench/kernels.py``'s work counts against their formulas, and each
  instrument's ``--device cpu --tiny`` run printing one JSON line with
  its JAX twin's keys.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import satrans_torch
import satrans_tpu
import torch_parity as tp
from satrans_torch import bridge
from satrans_torch import serving as tserving
from satrans_torch.bench import kernels, probe_throughput, \
    serving_throughput
from satrans_torch.models import MMOE as TorchMMOE
from satrans_tpu import serving as jserving
from satrans_tpu.models import MMOE as JaxMMOE
from satrans_tpu.train import Trainer as JaxTrainer

DEPTHS = (1, 2, 3, 4)


def test_aot_compiled_predictor_matches_jax_with_padded_tail():
    jm, params, tm = tp.jax_and_port("QK", False)
    x = tp.request(100, seed=4)               # 3 batches of 32 + a tail of 4
    jt = JaxTrainer(jm, seed=0)
    jt.compile()
    jt.params, jt.state = jax.tree.map(jnp.asarray, params), {}
    jp = jserving.Predictor.from_trainer(jt, batch_size=32)
    assert jp.aot_compile() is jp
    want = jp(x)
    port = tserving.Predictor(tm, batch_size=32, device="cpu")
    assert port.aot_compile() is port and port.graph is None  # no graph
    got = port(x)
    assert got.dtype == np.float64 and got.shape == (100,)
    np.testing.assert_allclose(got, want, atol=1e-5)
    for depth in DEPTHS:
        np.testing.assert_array_equal(port(x, pipeline_depth=depth), got)
        deep = tserving.Predictor(tm, batch_size=32, pipeline_depth=depth,
                                  device="cpu")
        assert deep.pipeline_depth == depth
        np.testing.assert_array_equal(deep(x), got)
    for depth in (0, -3):  # stored as the JAX package stores it
        assert tserving.Predictor(tm, pipeline_depth=depth,
                                  device="cpu").pipeline_depth == \
            jserving.Predictor(jm, params, pipeline_depth=depth
                               ).pipeline_depth == 1


def test_routed_mmoe_at_depth_2_matches_jax():
    kw = dict(domain_col="domain", num_tasks=3,
              expert_dnn_hidden_units=(16, 8), gate_dnn_hidden_units=(4,),
              tower_dnn_hidden_units=(4,))
    jm = JaxMMOE(layout=satrans_tpu.FeatureLayout(tp.columns(satrans_tpu)),
                 **kw)
    params = tp.random_params(jax.eval_shape(jm.init,
                                             jax.random.PRNGKey(3))[0],
                              seed=1)
    tm = TorchMMOE(satrans_torch.FeatureLayout(tp.columns(satrans_torch)),
                   device="cpu", **kw)
    tm.load_state_dict(bridge.from_jax_params(params, tm))
    x = tp.request(40, seed=2)                # 2 batches of 16 + a tail of 8
    want = jserving.Predictor(jm, jax.tree.map(jnp.asarray, params),
                              batch_size=16)(x, pipeline_depth=2)
    pred = tserving.Predictor(tm, batch_size=16, pipeline_depth=2,
                              device="cpu").aot_compile()
    got = pred(x)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(pred(x, pipeline_depth=1), got)


def test_kernels_work_counts_are_their_formulas():
    B, F, d, h = 8192, 19, 32, 4
    P = d * 2 * d + 2 * d * d                  # MetaNet [d, 2d, d]
    counts = kernels.work_counts(B, F, d, h)
    assert counts == {
        "embedding_gather": {"flops": 0, "bytes": B * F * d * 4},
        "meta_param_generation": {"flops": 2 * 4 * d * P, "bytes": 0},
        "interaction_attention": {"flops": 2 * B * F * (
            3 * d * d + 2 * (d * 2 * d + 2 * d * d) + 2 * F * d + d * d),
            "bytes": 0},
        "scoring": {"flops": 2 * B * F * d, "bytes": B * F * d * 4}}
    assert counts["embedding_gather"]["bytes"] == 19_922_944
    assert counts["interaction_attention"]["flops"] == 4_203_741_184
    # K1-fwd's bound: q k^T and p v on the CUDA cores, the rest in 3xTF32
    attn = 2 * B * F * 2 * F * d
    sol = max(attn / 67e12, (4_203_741_184 - attn) / (495e12 / 3))
    assert 4_203_741_184 / kernels.fused_peak_flops(B, F, d) == \
        pytest.approx(sol, rel=1e-12)


ROOFLINE = {"seconds", "bound", "speed_of_light_s"}


@pytest.mark.parametrize("name", ["serving_throughput", "probe_throughput",
                                  "kernels"])
def test_instrument_prints_the_jax_twins_keys(name, capsys):
    tiny = ["--device", "cpu", "--tiny", "--reps", "1"]
    if name == "serving_throughput":
        serving_throughput.main(tiny + ["--batches", "2", "--passes", "1"])
    elif name == "probe_throughput":
        probe_throughput.main(tiny)
    else:
        kernels.main(tiny)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    doc = json.loads(lines[0])
    assert doc["device"] == "cpu" and doc["card"] is None
    if name == "serving_throughput":
        keys = {"workload", "device_path_ms", "device_examples_per_sec",
                "e2e_examples_per_sec", "e2e_overlapped_examples_per_sec"}
        assert keys <= set(doc) and keys - {"workload"} <= set(doc["eager"])
        assert set(doc["e2e_overlapped_examples_per_sec"]) == {
            "depth1", "depth2", "depth4"}
        assert doc["launches"] is None  # no graph on the CPU
    elif name == "probe_throughput":
        assert {"workload", "unit", "results"} <= set(doc)
        assert set(doc["results"]) == {"fused_scores", "xla_scores"}
        for arm in doc["results"].values():
            assert {"examples_per_s", "ms_per_batch", "compile_s"} <= set(arm)
            assert arm["examples_per_s"] > 0
            assert arm["graph_equals_eager"] is None  # no graph on the CPU
        fused = doc["results"]["fused_scores"]
        assert fused["pred_max_abs_diff"] == fused["stats_max_abs_diff"] == 0
    else:
        names = {"embedding_gather", "meta_param_generation",
                 "interaction_attention_xla", "scoring"}
        assert set(doc) == names | {"card", "device"}
        for n in names:
            assert ROOFLINE <= set(doc[n]) and doc[n]["seconds"] > 0


def test_staging_writes_the_typed_padded_batch():
    """The staging (each span's rows written from
    ``FeatureLayout.columns`` into a slot, the ids field-major) gives
    ``batch_from_dict``'s batch bit for bit, the tail's rows zero."""
    layout = satrans_torch.FeatureLayout(
        tp.columns(satrans_torch) + [satrans_torch.features.DenseFeature(
            "price", 2)])
    x = tp.request(70, seed=5)
    x["price"] = np.random.default_rng(5).normal(size=(70, 2))
    pred = tserving.Predictor(TorchMMOE(layout, domain_col="domain",
                                        num_tasks=3, device="cpu"),
                              batch_size=32, device="cpu")
    data = layout.batch_from_dict(x)
    n, cols = layout.columns(x)
    slot = pred._slot(cols)
    for s, e in pred._spans(n):
        for t in slot.values():
            t.fill_(7)
        pred._fill(slot, cols, s, e)
        got = pred._batch(slot)
        assert set(got) == set(data) == {"sparse", "dense", "varlen"}
        for k, v in data.items():
            want = np.zeros((32, *v.shape[1:]), v.dtype)
            want[:e - s] = v[s:e]
            assert got[k].numpy().dtype == want.dtype
            np.testing.assert_array_equal(got[k].numpy(), want)


def test_constants_made_while_serving_serve_a_backward():
    """A device constant first made under the Predictor's inference mode
    (the field-order index of a layout whose side-bank field comes first)
    is an ordinary tensor: a training step on the same layout saves it for
    its backward."""
    from satrans_torch import embeddings
    from satrans_torch.models import SATrans as TorchSATrans
    f = satrans_torch.features
    layout = satrans_torch.FeatureLayout(
        [f.SparseFeature("domain", 5, tp.D_EMB),
         f.SparseFeature("f0", 300, tp.D_EMB),
         f.SparseFeature("f1", 500, tp.D_EMB)])
    model = TorchSATrans(layout, **tp.model_kwargs(), device="cpu")
    x = {k: v for k, v in tp.request(40, seed=3).items() if k != "hist"}
    embeddings._CONSTANTS.clear()
    tserving.Predictor(model, batch_size=16, device="cpu")(x)
    batch = {k: torch.from_numpy(v)
             for k, v in layout.batch_from_dict(x).items()}
    model.train()
    model(batch).sum().backward()
    assert model.emb.bank.grad.abs().max() > 0
