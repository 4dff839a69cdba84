"""The port's experiment entry point, data readers and checkpoints against the
JAX package.

* ``parse_args`` and ``config_str`` equal the JAX package's on the default
  argv and on a full one.
* ``load_dataset`` reads tiny ``alicpp.h5`` and ``alimama.h5`` files,
  written with the JAX package's ``data/io.save_dict_h5``, into the same
  dicts as the JAX package's (``sparseprice`` with its ``price_classes``,
  and the dense ``price``).
* Checkpoints round-trip in ``dense`` and ``lazy``: a restored trainer
  predicts bit for bit as the saved one, and one more epoch on each gives
  bit-identical parameters (Adam's and the lazy bank's state are
  restored); another bank mode raises.
* A resumed ``fit`` (a checkpoint every 2 steps, then ``resume=True``)
  against the JAX Trainer's resumed ``fit`` from the same parameters at
  dropout 0: every parameter at atol 5e-5 / rtol 1e-3
  (``tests/test_torch_train.py``'s tolerance).
* One whole CLI run on each side (``--data_name synthetic --flag
  showattn_instattn_dump``, one layer, batch 128): the JAX package on its
  interpret-mode kernels, so that its dropout masks are the port's, and
  the port from the JAX run's initial parameters.  ``_testpred.pkl``
  within 1e-4, the CSV rows equal but for the date (the AUCs compared
  unrounded within 1e-4, the loss within 1e-4), ``attn_stats.npy`` within
  1e-5, the ``inst_attn_*.txt`` files as in ``tests/test_torch_probe.py``;
  then a ``--finetune True`` run restores the port's checkpoint.  Other
  model names and a mesh raise; the ``test`` flag aborts after 5 steps.
"""

import dataclasses
import pathlib
import pickle
import re
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import satrans_tpu
import torch_parity as tp
from satrans_torch import bridge, serving
from satrans_torch.cli import main as tcli
from satrans_torch.train import Trainer as TorchTrainer
from satrans_torch.train import checkpoint as tckpt
from satrans_torch.train import metrics as tmetrics
from satrans_tpu.cli import main as jcli
from satrans_tpu.data import io as jio
from satrans_tpu.train import Trainer as JaxTrainer
from test_torch_probe import instance_dumps_differ

FULL_ARGV = [
    "--data_name", "alimama", "--data_path", "/data", "--model_name",
    "SATrans", "--seed", "7", "--merge", "yes", "--num_query_bases", "5",
    "--share_domain_dnn_across_layers", "True", "--domain_col",
    "301-122", "--embedding_dim", "16", "--att_layer_num", "2",
    "--domain_att_layer_num", "2", "--att_layer_type", "other",
    "--att_head_num", "2", "--flag", "pos_relu", "--filter_feats", "True",
    "--learning_rate", "0.005", "--prompt", "False", "--finetune", "True",
    "--attn_batch_reg", "0.2", "--meta_mode", "QK", "--epochs", "2",
    "--scan_steps", "4", "--batch_size", "64", "--synthetic_rows", "99",
    "--results_dir", "r", "--checkpoint_dir", "c", "--mesh", "2",
    "--shard_embeddings", "True", "--bank_update", "lazy",
    "--embedding_exchange", "alltoall", "--exchange_capacity_factor", "2.0",
    "--lazy_capacity_factor", "3.0", "--coordinator_address", "h:1",
    "--num_processes", "2", "--process_id", "1"]


@pytest.mark.parametrize("argv", [[], FULL_ARGV], ids=["default", "full"])
def test_parse_args_and_config_str_equal_jax(argv):
    got, want = tcli.parse_args(argv), jcli.parse_args(argv)
    assert vars(got) == vars(want)
    for name in ("SATrans", "Star_Trans", "AutoInt", "MMOE", "Star_Net",
                 "PLE"):
        got.model_name = want.model_name = name
        assert tcli.config_str(got, "301", "x") == \
            jcli.config_str(want, "301", "x")
    with pytest.raises(SystemExit):  # not a boolean string
        tcli.parse_args(["--prompt", "yes"])


# -------------------------------------------------------------------- data

def _write_alicpp(path, rng):
    from satrans_tpu.data import aliccp
    for split, n in (("ctr_train", 30), ("ctr_test", 12)):
        cols = {"click": rng.integers(0, 2, n)}
        for f in aliccp.SPARSE_FEATURES:
            cols[f] = rng.integers(0, 5, n)
        jio.save_dict_h5(str(path), cols, group=split)


def _write_alimama(path, rng):
    from satrans_tpu.data import alimama
    n = 40
    split = time.mktime(time.strptime(alimama.SPLIT_TIMESTAMP,
                                      "%Y-%m-%d %H:%M:%S"))
    cols = {f: rng.integers(0, 6, n) for f in alimama.SPARSE_FEATURES}
    cols["pid"] = rng.integers(0, 2, n)
    cols["clk"] = rng.integers(0, 2, n)
    cols["price"] = rng.choice([9.9, 120.0, 35.5, 7.0], n)
    cols["time_stamp"] = (split + rng.integers(-500, 500, n)).astype(np.int64)
    jio.save_dict_h5(str(path), cols)


def _assert_same(got, want, where=""):
    assert type(got) is type(want) or isinstance(got, np.ndarray), where
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, where


@pytest.mark.parametrize("data_name,flag", [
    ("alicpp", "None"), ("alimama", "sparseprice"), ("alimama", "None")])
def test_load_dataset_equals_jax(data_name, flag, tmp_path, capsys):
    rng = np.random.default_rng(0)
    if data_name == "alicpp":
        _write_alicpp(tmp_path / "alicpp.h5", rng)
        domain_col = "301"
    else:
        _write_alimama(tmp_path / "alimama.h5", rng)
        domain_col = "pid"
    argv = ["--data_name", data_name, "--data_path", str(tmp_path)]
    got = tcli.load_dataset(tcli.parse_args(argv), flag, domain_col)
    printed = capsys.readouterr().out
    want = jcli.load_dataset(jcli.parse_args(argv), flag, domain_col)
    assert len(got) == len(want) == 9
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_same(g, w, f"[{i}]")
    if flag == "sparseprice":
        assert "price_classes" in got[8] and got[3][-1] == "price"
    # the scenario counts of the diagnostics, most frequent first
    train = got[0][domain_col] if data_name == "alicpp" else np.concatenate(
        [got[0][domain_col], got[1][domain_col]])
    vals, counts = np.unique(train, return_counts=True)
    top = vals[np.argmax(counts)]
    assert f"{top}    {counts.max()}" in printed


# ------------------------------------------------------------- checkpoints

def _fit_data(n=48, seed=5):
    x = tp.request(n, seed=seed)
    y = np.random.default_rng(seed).integers(0, 2, n).astype(np.float32)
    return x, y


@pytest.mark.parametrize("mode", ["dense", "lazy"])
def test_checkpoint_round_trip(mode, tmp_path):
    _, _, tm = tp.jax_and_port()
    x, y = _fit_data()
    tr = TorchTrainer(tm, seed=7, device="cpu").compile(
        learning_rate=0.01, bank_update=mode)
    tr.fit(x, y, batch_size=16, verbose=0)
    path = str(tmp_path / "ck" / "run")
    tckpt.save(path, tr)
    payload = torch.load(path, weights_only=True)
    assert payload["meta"]["domain_id_offset"] == -(2 ** 31)
    assert ("lazy" in payload["opt_state"]) == (mode == "lazy")
    before = tr.predict(x, batch_size=16)

    _, _, fresh = tp.jax_and_port(seed=9)
    tr2 = TorchTrainer(fresh, seed=7, device="cpu").compile(
        learning_rate=0.01, bank_update=mode)
    assert not np.array_equal(tr2.predict(x, batch_size=16), before)
    tckpt.restore(path, tr2)
    np.testing.assert_array_equal(tr2.predict(x, batch_size=16), before)
    served = serving.load(path, tp.jax_and_port(seed=11)[2], batch_size=16,
                          device="cpu")
    np.testing.assert_array_equal(served(x), before)
    np.testing.assert_array_equal(
        serving.Predictor.from_trainer(tr2, batch_size=16)(x), before)

    tr.fit(x, y, batch_size=16, verbose=0)
    tr2.fit(x, y, batch_size=16, verbose=0)
    for (name, a), b in zip(tm.state_dict().items(),
                            fresh.state_dict().values()):
        assert torch.equal(a, b), name
    if mode == "lazy":
        for k in ("mu", "nu", "last"):
            assert torch.equal(tr._lazy[k], tr2._lazy[k]), k
        assert tr._lazy["count"] == tr2._lazy["count"] == 6

    other = TorchTrainer(tp.jax_and_port()[2], device="cpu").compile(
        bank_update="fused" if mode == "dense" else "dense")
    with pytest.raises(ValueError, match="bank_update"):
        tckpt.restore(path, other)


def test_resumed_fit_matches_jax_trainer(tmp_path):
    """Three steps with a checkpoint after the second, then a new trainer
    resumes from it and trains an epoch, on both sides."""
    jm, params, tm = tp.jax_and_port()
    x, y = _fit_data()
    jparams = jax.tree.map(jnp.asarray, params)

    def jax_trainer():
        tr = JaxTrainer(jm, seed=7)
        tr.compile(learning_rate=0.01, bank_update="dense")
        tr.params = jparams
        tr.state = {}
        tr.opt_state = tr.optimizer.init(tr.params)
        return tr

    jpath = str(tmp_path / "jax_ck")
    jax_trainer().fit(x, y, batch_size=16, verbose=0, checkpoint_path=jpath,
                      checkpoint_every=2)
    jt = jax_trainer()
    jt.fit(x, y, batch_size=16, verbose=0, checkpoint_path=jpath,
           resume=True)

    tpath = str(tmp_path / "port_ck")
    init = {k: v.clone() for k, v in tm.state_dict().items()}
    TorchTrainer(tm, seed=7, device="cpu").compile(learning_rate=0.01).fit(
        x, y, batch_size=16, verbose=0, checkpoint_path=tpath,
        checkpoint_every=2)
    tm.load_state_dict(init)
    tt = TorchTrainer(tm, seed=7, device="cpu").compile(learning_rate=0.01)
    tt.fit(x, y, batch_size=16, verbose=0, checkpoint_path=tpath,
           resume=True)
    assert int(next(iter(tt.optimizer.state.values()))["step"]) == 5
    got = tm.state_dict()
    for name, w in bridge.from_jax_params(
            jax.tree.map(np.asarray, jt.params), tm).items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=5e-5,
                                   rtol=1e-3, err_msg=name)


# --------------------------------------------------------------------- CLI

CLI_ARGV = ["--data_name", "synthetic", "--synthetic_rows", "640",
            "--batch_size", "128", "--domain_att_layer_num", "1",
            "--flag", "showattn_instattn_dump"]


def _port_layout_to_jax(layout):
    f = satrans_tpu.features
    return satrans_tpu.FeatureLayout(
        [f.SparseFeature(c.name, c.vocab, c.dim) for c in layout.sparse])


def test_cli_run_matches_jax(tmp_path, monkeypatch, capsys):
    _cli_run_matches_jax(tmp_path, monkeypatch, capsys, [], 32, 4)


def test_cli_run_matches_jax_at_width_8(tmp_path, monkeypatch, capsys):
    """The JAX package's own CLI test's width and heads (its
    tests/test_cli_aliccp.py runs SATrans at ``--embedding_dim 8
    --att_head_num 2``), which the port's kernels take on the card."""
    _cli_run_matches_jax(tmp_path, monkeypatch, capsys,
                         ["--embedding_dim", "8", "--att_head_num", "2"], 8,
                         2)


def _cli_run_matches_jax(tmp_path, monkeypatch, capsys, extra, d, heads):
    """One whole CLI run per side with ``CLI_ARGV + extra`` (width ``d``,
    ``heads`` heads): the test predictions, the report's AUCs and loss,
    the attention statistics and the instance dumps; then the port's
    checkpoint restored for finetuning."""
    jbuild, tbuild = jcli.build_model, tcli.build_model

    def jax_build(*a, **k):
        return dataclasses.replace(jbuild(*a, **k), use_fused_kernel=True,
                                   fused_interpret=True)

    def port_build(args, layout, cols, nums, flag, device):
        """The port's model with the JAX run's initial parameters (the
        JAX Trainer's model.init(PRNGKey(seed)))."""
        tm = tbuild(args, layout, cols, nums, flag, device=device)
        jm = jbuild(args, _port_layout_to_jax(layout), cols, nums, flag)
        params, _ = jm.init(jax.random.PRNGKey(args.seed))
        tm.load_state_dict(bridge.from_jax_params(
            jax.tree.map(np.asarray, params), tm))
        return tm

    monkeypatch.setattr(jcli, "build_model", jax_build)
    monkeypatch.setattr(tcli, "build_model", port_build)
    runs = {}
    for side, cli in (("jax", jcli), ("port", tcli)):
        res, ck = tmp_path / f"{side}_res", tmp_path / f"{side}_ck"
        argv = CLI_ARGV + extra + ["--results_dir", str(res),
                                   "--checkpoint_dir", str(ck)]
        kw = {"device": "cpu"} if side == "port" else {}
        runs[side] = (cli.main(argv, **kw), res, ck)

    config = (f"SATrans_{d}_0.001_1_{heads}_Query_1024_domain_"
              "showattn_instattn_dump")
    (_, jres, jck), (_, tres, tck) = runs["jax"], runs["port"]
    pred_j = pickle.load(open(jck / f"{config}_testpred.pkl", "rb"))
    pred = pickle.load(open(tck / f"{config}_testpred.pkl", "rb"))
    assert pred.dtype == np.float64 and pred.shape == pred_j.shape == (128,)
    np.testing.assert_allclose(pred, pred_j, atol=1e-4)

    # the CSV rows: the config equal, the AUCs unrounded within 1e-4
    test = tcli.load_dataset(tcli.parse_args(CLI_ARGV + extra), "",
                             "domain")[1]
    y, dom = test["click"], test["domain"]
    rows = {}
    for side, res in (("jax", jres), ("port", tres)):
        (line,) = open(res / "synthetic_results.csv").read().splitlines()
        head, *fields = line.split(",")
        assert head[len("mm-dd-HH-MM-"):] == config
        rows[side] = [float(v) for v in fields]
    assert len(rows["port"]) == len(rows["jax"]) == 5  # AUC, 3 domains, loss
    np.testing.assert_allclose(rows["port"][-1], rows["jax"][-1], atol=1e-4)
    aucs = {side: [tmetrics.auc(y, p)] + list(tmetrics.per_domain_auc(
        y, p, dom).values()) for side, p in (("jax", pred_j), ("port", pred))}
    np.testing.assert_allclose(aucs["port"], aucs["jax"], atol=1e-4)
    for side in aucs:
        np.testing.assert_allclose(rows[side][:-1], aucs[side], atol=5e-5)

    stats = np.load(tres / "attn_stats.npy", allow_pickle=True)
    stats_j = np.load(jres / "attn_stats.npy", allow_pickle=True)
    assert stats.shape == stats_j.shape == (1, 3)
    for got, want in zip(stats.ravel(), stats_j.ravel()):
        for name in ("pos", "neg", "all"):
            np.testing.assert_allclose(got[name], want[name], atol=1e-5)
    differ, _ = instance_dumps_differ(tres / "inst_attn", jres / "inst_attn",
                                      [1, 2, 3], 0.2)
    assert len(differ) <= 2, differ

    # the port's checkpoint restores for finetuning
    argv = CLI_ARGV + extra + ["--results_dir", str(tres),
                               "--checkpoint_dir", str(tck), "--finetune",
                               "True"]
    capsys.readouterr()
    tcli.main(argv, device="cpu")
    assert "restored checkpoint for finetuning" in capsys.readouterr().out
    assert len(open(tres / "synthetic_results.csv").readlines()) == 2


@pytest.mark.parametrize("extra,match", [
    (["--model_name", "Star_Trans"], "item 'Other models'"),
    (["--mesh", "2"], "item 'parallel/ → torch.distributed'"),
    (["--bank_update", "lazy_stale"], "item 'lazy_stale'")])
def test_cli_unported_options_raise(extra, match, tmp_path):
    argv = CLI_ARGV + ["--synthetic_rows", "64", "--results_dir",
                       str(tmp_path)] + extra
    with pytest.raises(NotImplementedError, match=match):
        tcli.main(argv, device="cpu")


def test_cli_test_flag_aborts_after_five_steps(tmp_path, capsys):
    """The ``test`` flag: 5 of the 10 steps, the loss printed, then the
    abort."""
    argv = CLI_ARGV[:-1] + ["test", "--synthetic_rows", "200",
                            "--batch_size", "16", "--results_dir",
                            str(tmp_path)]
    with pytest.raises(AssertionError, match="test probe abort"):
        tcli.main(argv, device="cpu")
    assert "test out: " in capsys.readouterr().out


def test_no_message_names_a_roadmap_item_by_number():
    """The ROADMAP's queues are renumbered as their items land, so the
    port's messages and docstrings quote an item's title, never its
    number (the Python sources and the CUDA ones)."""
    package = pathlib.Path(tcli.__file__).resolve().parents[1]
    named = [f"{p.relative_to(package)}:{i}"
             for pattern in ("*.py", "csrc/*.cu", "csrc/*.cuh")
             for p in sorted(package.rglob(pattern))
             for i, line in enumerate(p.read_text().splitlines(), 1)
             if re.search(r"item \d+", line)]
    assert not named, named
