"""The port's Predictor against ``satrans_tpu``'s, and the port's
boundaries: no JAX inside it, and the card unless the caller asks for the
CPU."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import satrans_torch
import torch_parity as tp
from satrans_torch import serving as tserving
from satrans_torch.models import SATrans as TorchSATrans
from satrans_tpu import serving as jserving

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_predictor_matches_jax_predictor_with_padded_tail():
    jm, params, tm = tp.jax_and_port("QK", False)
    x = tp.request(100, seed=4)               # 3 batches of 32 + a tail of 4
    want = jserving.Predictor(jm, jax.tree.map(jnp.asarray, params),
                              batch_size=32)(x)
    got = tserving.Predictor(tm, batch_size=32, device="cpu")(x)
    assert got.dtype == np.float64 and got.shape == (100,)
    np.testing.assert_allclose(got, want, atol=1e-5)
    # the padded rows change nothing: one batch holding everything agrees
    whole = tserving.Predictor(tm, batch_size=128, device="cpu")(x)
    np.testing.assert_allclose(got, whole, atol=1e-6)


def test_port_imports_no_jax():
    code = ("import sys, satrans_torch, satrans_torch.bridge, "
            "satrans_torch.serving, satrans_torch.models, "
            "satrans_torch.ops.meta_block, satrans_torch.ops._build, "
            "satrans_torch.ops.dispatch, satrans_torch.ops.tiled_meta, "
            "satrans_torch.data.aliccp, satrans_torch.data.alimama, "
            "satrans_torch.data.synthetic, satrans_torch.data.io, "
            "satrans_torch.cli.main, satrans_torch.train.checkpoint, "
            "satrans_torch.train.attention_probe, "
            "satrans_torch.ops.profiling, "
            "satrans_torch.bench.train_throughput, "
            "satrans_torch.bench.scatter_probe, "
            "satrans_torch.bench.gather_probe, "
            "satrans_torch.bench.raw_e2e, satrans_torch.native, "
            "satrans_torch.data.loader, satrans_torch.data.h5lite, "
            "satrans_torch.train.optimizers, satrans_torch.utils, "
            "satrans_torch.parallel.distributed, "
            "satrans_torch.parallel.embedding_sharded, "
            "satrans_torch.parallel.bank_sharded; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'satrans_tpu')]; "
            "assert not bad, bad; "
            # the card's machine has neither: the CLI imports them lazily
            "late = [m for m in sys.modules "
            "if m.split('.')[0] in ('h5py', 'pandas')]; "
            "assert not late, late")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|satrans_tpu)\b",
                         re.MULTILINE)
    files = sorted((REPO / "satrans_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for path in files:
        assert not pattern.search(path.read_text()), path


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    layout = satrans_torch.FeatureLayout(tp.columns(satrans_torch))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchSATrans(layout, **tp.model_kwargs())
    model = TorchSATrans(layout, **tp.model_kwargs(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserving.Predictor(model)
    scores = tserving.Predictor(model, batch_size=8, device="cpu")(
        tp.request(10))
    assert scores.shape == (10,) and np.all((scores > 0) & (scores < 1))
