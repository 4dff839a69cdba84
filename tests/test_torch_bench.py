"""The port's bench against the JAX package's: the P1/P2 probes' plain
versions, ``ops/profiling`` and the training-throughput bench.

* ``row_dma_scatter`` and ``row_dma_gather`` on the CPU (their plain
  versions, ``index_copy_`` and ``index_select``) against the JAX probes'
  ``pallas_scatter`` and ``pallas_gather`` in interpret mode, bit for bit,
  and the wrappers' refusals (a ragged N, an unknown variant or rb).  The
  JAX ``bulkwait`` scatter does not run in interpret mode; the contract is
  the function, so the JAX side runs ``loop``.
* ``profiling.roofline`` against the JAX one at the same peaks, exactly.
* ``bench/train_throughput.py --device cpu --tiny``: one JSON line an arm
  with its keys, then ``bench.py``'s summary keys; its staged batches are
  ``bench.py``'s numpy recipe at the full shapes.
* ``Trainer(scan_unroll=2)`` trains as ``scan_unroll=1`` does.
"""

import copy
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import satrans_torch
import torch_parity as tp
from satrans_torch.bench import gather_probe, scatter_probe
from satrans_torch.bench import train_throughput as tt
from satrans_torch.models import SATrans as TorchSATrans
from satrans_torch.ops import profiling
from satrans_torch.train import Trainer as TorchTrainer
from satrans_tpu.bench import pallas_gather_probe as jgather
from satrans_tpu.bench import pallas_scatter_probe as jscatter
from satrans_tpu.ops import profiling as jprofiling

ROOT = Path(__file__).resolve().parent.parent
ROWS, W = 4096, 128


def _bench():
    spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench


def test_row_dma_scatter_matches_pallas_scatter():
    rng = np.random.default_rng(0)
    ids = np.sort(rng.choice(ROWS, size=256, replace=False))
    vals = rng.standard_normal((256, W)).astype(np.float32)
    bank = rng.standard_normal((ROWS, W)).astype(np.float32)
    want = np.asarray(jscatter.pallas_scatter(
        jnp.asarray(bank), jnp.asarray(ids.astype(np.int32)),
        jnp.asarray(vals), interpret=True, variant="loop", rb=64))
    for fn in (scatter_probe.row_dma_scatter_reference,
               scatter_probe.row_dma_scatter):
        tb = torch.from_numpy(bank.copy())
        got = fn(tb, torch.from_numpy(ids), torch.from_numpy(vals))
        assert got is tb  # in place, as input_output_aliases={2: 0}
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arrays,n,jax_rb", [(1, 256, 64), (2, 128, 16)])
def test_row_dma_gather_matches_pallas_gather(arrays, n, jax_rb):
    """The interpret-mode probe unrolls rb copies an array, so its two-array
    case runs blocks of 16 rows (its rb is its tiling, not the function's);
    arrays of 1024 rows."""
    rng = np.random.default_rng(1)
    rows = 1024
    ids = rng.integers(0, rows, size=n)          # duplicates, as the probe
    srcs = [rng.standard_normal((rows, W)).astype(np.float32)
            for _ in range(arrays)]
    want = jgather.pallas_gather([jnp.asarray(s) for s in srcs],
                                 jnp.asarray(ids.astype(np.int32)),
                                 interpret=True, rb=jax_rb)
    t_ids, t_srcs = torch.from_numpy(ids), [torch.from_numpy(s) for s in srcs]
    for got in (gather_probe.row_dma_gather_reference(t_srcs, t_ids),
                gather_probe.row_dma_gather(t_srcs, t_ids, rb=64)):
        assert len(got) == arrays
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", ["ragged", "variant", "rb", "width"])
def test_row_dma_wrappers_refuse(case):
    n, w = (200, W) if case == "ragged" else (256, 126 if case == "width"
                                              else W)
    kw = dict(variant="unroll" if case == "variant" else "bulk",
              rb=96 if case == "rb" else 64)
    ids = torch.arange(n)
    with pytest.raises(ValueError):
        scatter_probe.row_dma_scatter(torch.zeros(ROWS, w), ids,
                                      torch.zeros(n, w), **kw)
    with pytest.raises(ValueError):
        gather_probe.row_dma_gather([torch.zeros(ROWS, w)], ids, **kw)


def test_roofline_and_time_fn_match_jax_package():
    peaks = dict(peak_flops=profiling.H100_PEAK_F32_FLOPS,
                 peak_bw=profiling.H100_HBM_BYTES_PER_S)
    for args in ((2.5e-5, 0.0, 84_541_440.0), (1e-3, 4.1e9, 2e6),
                 (3e-4, 1e9, 0.0), (1e-4, 0.0, 0.0)):
        assert profiling.roofline(*args) == jprofiling.roofline(
            *args, **peaks), args
    calls = []
    sec = profiling.time_fn(calls.append, 1, iters=3, warmup=2,
                            device="cpu")
    assert calls == [1] * 5 and sec >= 0.0
    assert profiling.device_busy_ms(lambda: None) is None  # no card here
    assert profiling.card_name("cpu") is None


def test_staged_batches_are_bench_py_recipe():
    """The staged batches of both configurations at the full shapes are
    bench.py's numpy recipe (bench.py:77-85), and its vocab sizes."""
    bench = _bench()
    assert tt.ALICCP_DATA_MAX == bench.ALICCP_DATA_MAX
    assert tt.ALIMAMA_DATA_MAX == bench.ALIMAMA_DATA_MAX
    assert (tt.BATCH, tt.SCAN, tt.CHUNKS) == (bench.BATCH, bench.SCAN,
                                              bench.CHUNKS)
    for cfg, data_max, dense_cols in (
            (tt.ALICCP, bench.ALICCP_DATA_MAX, 0),
            (tt.ALIMAMA_POS, bench.ALIMAMA_DATA_MAX, 1)):
        rng = np.random.default_rng(0)
        sparse = np.stack(
            [rng.integers(1, v + 1, size=(bench.SCAN, bench.BATCH))
             for v in data_max.values()], axis=2).astype(np.int32)
        dense = rng.normal(size=(bench.SCAN, bench.BATCH, dense_cols)
                           ).astype(np.float32) if dense_cols else None
        y = rng.integers(0, 2, (bench.SCAN, bench.BATCH)).astype(np.float32)
        got = tt.staged_arrays(cfg, bench.SCAN)
        np.testing.assert_array_equal(got[0], sparse)
        if dense_cols:
            np.testing.assert_array_equal(got[1], dense)
        else:
            assert got[1] is None
        np.testing.assert_array_equal(got[2], y)
        np.testing.assert_array_equal(got[3], np.ones_like(y))


ARM_KEYS = {"arm", "examples_per_s", "ms_per_step", "build_s",
            "device_busy_ms", "fit_examples_per_s", "loss",
            "launches_per_step", "card", "device"}
SUMMARY_KEYS = {"metric", "value", "unit", "vs_baseline",
                "exact_parity_mode", "alimama_sota_pos"}


def test_train_throughput_tiny_on_cpu(capsys):
    recs = tt.main(["--device", "cpu", "--tiny", "--steps", "2",
                    "--chunks", "1"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines == recs
    arms, summary = lines[:-1], lines[-1]
    assert [a["arm"] for a in arms] == ["dense", "lazy", "lazy_fusedtail",
                                        "alimama_pos_lazy"]
    for a in arms:
        assert ARM_KEYS <= set(a), a
        assert a["examples_per_s"] > 0 and a["fit_examples_per_s"] > 0
        assert np.isfinite(a["loss"]) and a["device"] == "cpu"
        assert a["device_busy_ms"] is None and a["card"] is None
    assert [a["lazy_tail"] for a in arms] == [None, "split", "fused",
                                              "split"]
    assert SUMMARY_KEYS <= set(summary)
    assert summary["metric"] == "satrans_train_throughput"
    assert summary["value"] == round(arms[1]["examples_per_s"], 1)
    assert summary["exact_parity_mode"]["value"] == round(
        arms[0]["examples_per_s"], 1)
    assert summary["vs_baseline"] is None  # a CPU number is no card's
    with pytest.raises(SystemExit):
        tt.parse_args(["--device", "cpu"])  # the CPU only with --tiny


def test_scan_unroll_is_accepted_and_changes_nothing():
    x = tp.request(32, seed=5)
    y = np.random.default_rng(5).integers(0, 2, 32).astype(np.float32)
    tm = TorchSATrans(satrans_torch.FeatureLayout(tp.columns(satrans_torch)),
                      **tp.model_kwargs(), device="cpu")
    start = copy.deepcopy(tm.state_dict())
    states = []
    for unroll in (1, 2):
        tm.load_state_dict(start)
        tr = TorchTrainer(tm, seed=7, scan_unroll=unroll, device="cpu")
        assert tr.scan_unroll == unroll
        tr.compile(learning_rate=0.01)
        hist = tr.fit(x, y, batch_size=16, verbose=0, scan_steps=2)
        states.append((hist.history["loss"],
                       copy.deepcopy(tm.state_dict())))
    assert states[0][0] == states[1][0]
    for name, v in states[0][1].items():
        torch.testing.assert_close(states[1][1][name], v, rtol=0, atol=0)
