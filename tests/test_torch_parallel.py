"""The port's ``parallel/`` and the Trainer under a mesh, on the CPU, one
process a rank over gloo, against the JAX package on the conftest's
8-device CPU mesh (``make_mesh(jax.devices()[:n])``).

Two groups of rank processes run (``tests/torch_parallel_worker.py``):
four ranks for the lookups, the routed commit, the distributed AUC, the
Trainer cases and the checkpoints, and two ranks for
``fit_from_iterator``, the dropout masks, STAR's BatchNorm and the CLI.
They start together, while this process computes the JAX references;
each test then reads their results.

Tolerances: the lookups, their gradient and the routed commit within
1e-6 (the commit's overflow exactly); the AUC within 1e-9 of the JAX
package's, run there with ``jax.enable_x64`` (its float32 sums would
round the AUC itself), and of ``metrics.auc_torch`` on the gathered
arrays; the Trainer's two steps at dropout 0 against the JAX mesh Trainer
in the same mode, the step statistics at rtol 1e-5 and the parameters,
moments and predictions at rtol 2e-4 / atol 2e-5 (tests/test_torch_train.py);
a mesh against the port's own single process (dropout masks, STAR) bit
for bit for the masks and at rtol 2e-4 / atol 2e-5 for the rest (the
summation order of the ranks' gradients).
"""

import concurrent.futures
import os
import pickle
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import satrans_tpu
import torch_parallel_worker as wk
import torch_parity as tp
from satrans_torch import bridge
from satrans_torch.train import metrics as tmetrics
from satrans_tpu.data.loader import ShardedBatchIterator
from satrans_tpu.models import MODEL_REGISTRY as JAX_MODELS
from satrans_tpu.parallel import bank_sharded as jbs
from satrans_tpu.parallel import distributed as jdist
from satrans_tpu.parallel import embedding_sharded as jes
from satrans_tpu.parallel import make_mesh
from satrans_tpu.parallel import sharding as jsh
from satrans_tpu.train import Trainer as JaxTrainer
from satrans_tpu.train import bank_optimizer as jbo
from satrans_tpu.train.metrics import auc_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=2e-5)
EXACT = dict(rtol=0, atol=1e-6)


def _free_ports(k: int) -> list[int]:
    """``k`` distinct free ports (each socket held until all are bound)."""
    socks = [socket.socket() for _ in range(k)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _jax_model(name, **extra):
    layout = satrans_tpu.FeatureLayout(wk.columns(satrans_tpu))
    if name == "SATrans":
        return JAX_MODELS[name](layout=layout, **wk.satrans_kwargs(**extra))
    return JAX_MODELS[name](layout=layout, **wk.DEEPFM, **extra)


def _params(name):
    return tp.random_params(jax.eval_shape(
        _jax_model(name).init, jax.random.PRNGKey(3))[0], seed=1)


def _put(a, mesh, spec):
    return jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))


# ------------------------------------------------------------ JAX side

def _jax_lookups(world):
    mesh = make_mesh(jax.devices()[:world])
    bank, ids, w = wk.lookup_inputs(world)
    b = _put(bank, mesh, P("data", None))
    out = {}
    lookup = {capf: jax.jit(lambda bb, ii, capf=capf: jes.alltoall_lookup(
        bb, ii, mesh, capacity_factor=capf)) for capf in (None, 2.0)}
    for case, g_ids in ids.items():
        i = _put(g_ids, mesh, P("data"))
        for capf in (None, 2.0):
            rows, ov = lookup[capf](b, i)
            out[f"alltoall/{case}/{capf}"] = (np.asarray(rows),
                                              np.asarray(ov))
    i = _put(ids["random"], mesh, P("data"))
    wt = _put(w, mesh, P("data"))
    out["grad"] = np.asarray(jax.jit(jax.grad(lambda bb: jnp.sum(
        jes.alltoall_lookup(bb, i, mesh, capacity_factor=None)[0] * wt)))(b))
    ids2 = np.random.default_rng(3).integers(
        0, wk.R_LOOKUP, (world * 8, 4)).astype(np.int32)
    rows, ov = lookup[2.0](b, _put(ids2, mesh, P("data", None)))
    out["alltoall/2d"] = (np.asarray(rows), np.asarray(ov))
    return out


def _jax_routed(world):
    mesh = make_mesh(jax.devices()[:world])
    bank, mu, nu, last, count, steps = wk.routed_inputs(world)
    out = {}
    update = {capf: jax.jit(lambda *a, capf=capf: jbs.lazy_routed_update(
        *a, lr=wk.LR, l2=wk.L2, mesh=mesh, capacity_factor=capf))
        for capf in (2.0, None)}
    for case, (g_ids, g) in steps.items():
        for capf in (2.0, None):
            res = update[capf](
                _put(bank, mesh, P("data", None)),
                _put(mu, mesh, P("data", None)),
                _put(nu, mesh, P("data", None)), _put(last, mesh, P("data")),
                jnp.int32(count), _put(g_ids, mesh, P("data")),
                _put(g, mesh, P("data")))
            out[f"{case}/{capf}"] = tuple(np.asarray(a) for a in res[:4]) + \
                (int(res[5]),)
    return out


def _jax_aucs(world):
    mesh = make_mesh(jax.devices()[:world])
    out = {}
    with jax.enable_x64(True):
        for case, (y, s, w) in wk.auc_inputs(world).items():
            yj = _put(y.astype(np.float64), mesh, P("data"))
            sj = _put(s.astype(np.float64), mesh, P("data"))
            wj = None if w is None else _put(w.astype(np.float64), mesh,
                                             P("data"))
            auc, ov = jdist.auc_sharded(yj, sj, wj, mesh=mesh,
                                        return_overflow=True)
            out[case] = (float(auc), int(ov), float(jdist.auc_sharded_exact(
                yj, sj, wj, mesh=mesh)), float(auc_jax(
                    jnp.asarray(y, jnp.float64), jnp.asarray(s, jnp.float64),
                    None if w is None else jnp.asarray(w, jnp.float64))))
    return out


def _compile_fast_by_shape(jitted):
    """``tp.compile_fast`` with one executable a batch shape."""
    compiled = {}

    def call(params, state, batch):
        key = tuple(v.shape for v in batch.values())
        if key not in compiled:
            compiled[key] = tp.compile_fast(jitted)
        return compiled[key](params, state, batch)

    return call


def _jax_trainer(name, params, mode, shard, exch, capf, mesh, **extra):
    """The JAX mesh Trainer holding ``params``, placed as
    ``_ensure_initialized`` places them; its train steps record their
    statistics."""
    jm = _jax_model(name, **extra)
    tr = JaxTrainer(jm, mesh=mesh, shard_embeddings=shard,
                    embedding_exchange=exch, exchange_capacity_factor=capf,
                    seed=7)
    tr.compile(learning_rate=wk.LR, bank_update=mode)
    p = jax.tree.map(lambda a: jnp.array(np.asarray(a)), params)
    if shard:
        p = jsh.pad_banks(p, mesh.devices.size)
    tr.params, tr.state = p, {}
    tr._resolve_bank_mode()
    tr.opt_state = (jbo.lazy_init(tr.optimizer, tr.params)
                    if tr._bank_mode == "lazy" else
                    tr.optimizer.init(tr.params))
    tr.params, tr.opt_state, tr.state = jsh.place(
        jm, tr.params, tr.opt_state, tr.state, mesh, shard_embeddings=shard)
    steps = []
    build = tr._build_steps

    def build_and_record():
        build()
        for attr in ("_train_step", "_train_scan"):
            fn = tp.compile_fast(getattr(tr, attr))

            def record(*args, fn=fn):
                res = fn(*args)
                steps.append({k: float(v) for k, v in
                              jax.device_get(res[3]).items()})
                return res

            setattr(tr, attr, record)
        tr._eval_step = _compile_fast_by_shape(tr._eval_step)

    tr._build_steps = build_and_record
    return tr, steps


def _jax_train(case, params):
    """One Trainer case of the JAX mesh of 4 devices."""
    mesh = make_mesh(jax.devices()[:4])
    x, y = wk.train_data()
    tr, steps = _jax_trainer(case[1], params[case[1]], *case[2:6], mesh)
    tr.fit(x, y, batch_size=wk.BATCH, epochs=1, verbose=0, shuffle=True,
           scan_steps=case[6])
    res = {"steps": steps, "params": jax.tree.map(np.asarray, tr.params),
           "opt": jax.tree.map(np.asarray, tr.opt_state),
           "pred": tr.predict(x, batch_size=wk.BATCH),
           "history": dict(tr.history.history)}
    if case[0] == "satrans_dense":
        res["eval"] = tr.evaluate_domains(x, y, domain_col="domain",
                                          batch_size=wk.BATCH * 4)
    return res


def _jax_iterator(params):
    """The single-process JAX mesh of 2 devices over the global batches
    that the two ranks' host shards make."""
    mesh = make_mesh(jax.devices()[:2])
    x, y = wk.train_data()
    tr, steps = _jax_trainer("SATrans", params, "lazy", True, "alltoall",
                             None, mesh)
    layout = satrans_tpu.FeatureLayout(wk.columns(satrans_tpu))
    its = [ShardedBatchIterator(layout.batch_from_dict(x), y, wk.BATCH,
                                seed=3, host_id=h, num_hosts=2)
           for h in range(2)]

    def factory(e):
        for parts in zip(*(it.epoch(e) for it in its)):
            yield ({k: np.concatenate([p[0][k] for p in parts])
                    for k in parts[0][0]},
                   np.concatenate([p[1] for p in parts]),
                   np.concatenate([p[2] for p in parts]))

    tr.fit_from_iterator(factory, epochs=1, domain_offset=1, verbose=0)
    return {"steps": steps, "params": jax.tree.map(np.asarray, tr.params),
            "opt": jax.tree.map(np.asarray, tr.opt_state)}


# ------------------------------------------------------------ the run

@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Start both rank groups, compute the JAX references meanwhile, and
    return ``(port results by world and rank, JAX references)``."""
    root = tmp_path_factory.mktemp("parallel")
    params = {name: _params(name) for name in ("DeepFM", "SATrans")}
    for name, p in params.items():
        with open(root / f"{name}.pkl", "wb") as f:
            pickle.dump(p, f)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    procs = {}
    t0 = time.time()
    ports = iter(_free_ports(4))
    for world in (4, 2):
        out = root / f"world{world}"
        out.mkdir()
        port, cli_port = next(ports), next(ports)
        procs[world] = [subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests",
                                          "torch_parallel_worker.py"),
             str(r), str(world), str(port), str(cli_port), str(root),
             str(out)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
    # the references compile in threads (XLA's compiler leaves the GIL)
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        jobs = {"lookup": pool.submit(_jax_lookups, 4),
                "routed": pool.submit(_jax_routed, 4),
                "auc": pool.submit(_jax_aucs, 4),
                "iterator": pool.submit(_jax_iterator, params["SATrans"])}
        trains = {c[0]: pool.submit(_jax_train, c, params)
                  for c in wk.TRAIN_CASES}
        ref = {k: j.result() for k, j in jobs.items()}
        ref["train"] = {k: j.result() for k, j in trains.items()}
    got = {}
    for world, ps in procs.items():
        logs = []
        for p in ps:
            try:
                logs.append(p.communicate(timeout=max(
                    30.0, 240.0 - (time.time() - t0)))[0])
            except subprocess.TimeoutExpired:
                for q in ps:
                    q.kill()
                raise
        for r, (p, log) in enumerate(zip(ps, logs)):
            assert p.returncode == 0, f"rank {r} of {world} failed:\n{log}"
        got[world] = []
        for r in range(world):
            with open(root / f"world{world}" / f"rank{r}.pkl", "rb") as f:
                got[world].append(pickle.load(f))
    return got, ref, params


def _trim(tree, like):
    """The JAX tree's banks cut to the unpadded shapes of ``like``."""
    return jax.tree.map(lambda a, b: np.asarray(a)[:b.shape[0]]
                        if np.ndim(a) else np.asarray(a), tree, like)


# ------------------------------------------------------------ sharding

def test_pad_banks_and_owned_rows():
    from satrans_torch.parallel import sharding
    mesh = sharding.Mesh(None, 2, 4, torch.device("cpu"))
    bank = torch.ones(13 * 16, 8)  # 13 physical rows at rp = 16
    padded = sharding.pad_banks(bank, 4, 16)
    assert padded.shape == (16 * 16, 8)
    assert float(padded[13 * 16:].abs().sum()) == 0.0
    want = jsh.pad_banks({"emb": {"bank": jnp.ones((13, 128))}}, 4)
    assert want["emb"]["bank"].shape[0] * 16 == padded.shape[0]
    assert sharding.owned_rows(16, mesh) == slice(8, 12)
    x = np.arange(12)
    np.testing.assert_array_equal(sharding.shard_array(x, mesh), [6, 7, 8])
    with pytest.raises(ValueError, match="does not split"):
        sharding.shard_array(np.arange(10), mesh)


def test_place_shards_rows_and_state(run):
    """Each rank's rows after ``place`` are its block of the padded bank
    (the physical rows of the JAX package's padded bank), and the lazy
    ``mu``, ``nu``, ``last`` and the bank's Adam moments follow them; the
    gathered state the checkpoint holds is the single card's."""
    from satrans_torch.parallel import sharding
    got, _, params = run
    want = bridge.from_jax_params(
        params["SATrans"], wk._port_model("SATrans", None))["emb.bank"]
    padded = sharding.pad_banks(want, 4, 16).numpy()
    j_padded = jsh.pad_banks(params["SATrans"], 4)["emb"]["bank"]
    assert padded.shape[0] == np.asarray(j_padded).shape[0] * 16
    for r, g in enumerate(got[4]):
        for mode, res in g["place"].items():
            per = res["rows_per"]
            assert per * 4 * 16 == padded.shape[0]
            np.testing.assert_array_equal(
                res["bank"], padded[r * per * 16:(r + 1) * per * 16])
        assert g["place"]["lazy"]["lazy"] == {"mu": (per, 128),
                                              "nu": (per, 128),
                                              "last": (per,)}
        assert g["place"]["fused_eq"]["adam"]["exp_avg"] == (per * 16, 8)
    res = got[4][0]["train"]["satrans_lazy_alltoall"]
    assert res["file_bank"].shape == tuple(want.shape)
    np.testing.assert_array_equal(res["file_bank"], res["state"]["emb.bank"])
    lazy = res["lazy"]
    assert lazy["mu"].shape == (want.shape[0] // 16, 128)
    assert lazy["last"].shape == (want.shape[0] // 16,)


# ------------------------------------------------------------ lookups

@pytest.mark.parametrize("case", ["random", "dup_oob", "skew"])
@pytest.mark.parametrize("capf", [None, 2.0])
def test_alltoall_lookup_matches_jax(run, case, capf):
    got, ref, _ = run
    key = f"alltoall/{case}/{capf}"
    rows = np.concatenate([g["lookup"][key][0] for g in got[4]])
    want_rows, want_ov = ref["lookup"][key]
    np.testing.assert_allclose(rows, want_rows, **EXACT)
    for g in got[4]:
        np.testing.assert_array_equal(g["lookup"][key][1], want_ov)
    bank, ids, _ = wk.lookup_inputs(4)
    if want_ov.sum() == 0:
        np.testing.assert_array_equal(
            rows, bank[np.clip(ids[case], 0, wk.R_LOOKUP - 1)])
    if case == "skew" and capf == 2.0:
        assert (want_ov == 8).all()


def test_alltoall_lookup_2d_and_sharded_lookup(run):
    got, ref, _ = run
    bank, ids, _ = wk.lookup_inputs(4)
    rows = np.concatenate([g["lookup"]["alltoall/2d"][0] for g in got[4]])
    ids2 = got[4][0]["lookup"]["alltoall/2d"][2]
    np.testing.assert_allclose(rows, ref["lookup"]["alltoall/2d"][0], **EXACT)
    np.testing.assert_array_equal(rows, bank[ids2])
    for case, g_ids in ids.items():
        part = np.concatenate([g["lookup"][f"sharded/{case}"]
                               for g in got[4]])
        np.testing.assert_array_equal(
            part, bank[np.clip(g_ids, 0, wk.R_LOOKUP - 1)])


def test_alltoall_lookup_gradient_matches_jax_grad(run):
    got, ref, _ = run
    for g in got[4]:
        np.testing.assert_allclose(g["lookup"]["grad"], ref["lookup"]["grad"],
                                   **EXACT)


# ------------------------------------------------------------ routed commit

@pytest.mark.parametrize("case", ["spread", "dup_oob", "skew"])
@pytest.mark.parametrize("capf", [2.0, None])
def test_lazy_routed_update_matches_jax(run, case, capf):
    got, ref, _ = run
    key = f"{case}/{capf}"
    want = ref["routed"][key]
    for g in got[4]:
        res = g["routed"][key]
        for name, a, b in zip(("bank", "mu", "nu"), res[:3], want[:3]):
            np.testing.assert_allclose(a, b, **EXACT, err_msg=name)
        np.testing.assert_array_equal(res[3], want[3])
        assert res[4] == want[4]
    if case == "skew" and capf == 2.0:
        assert want[4] > 0
    elif capf is None or case != "skew":
        # no drop: the port's single-process lazy_update, same step
        single = got[4][0]["routed"][f"{case}/single"]
        for name, a, b in zip(("bank", "mu", "nu", "last"),
                              got[4][0]["routed"][key][:4], single):
            np.testing.assert_allclose(a, b, **EXACT, err_msg=name)


# ------------------------------------------------------------ AUC

@pytest.mark.parametrize("case", ["ties_weights", "unweighted", "skew"])
def test_distributed_auc_matches_jax_and_auc_torch(run, case):
    got, ref, _ = run
    auc, ov, exact, dist_auc, unbounded = got[4][0]["auc"][case]
    j_auc, j_ov, j_exact, j_full = ref["auc"][case]
    y, s, w = wk.auc_inputs(4)[case]
    full = float(tmetrics.auc_torch(torch.from_numpy(y), torch.from_numpy(s),
                                    None if w is None
                                    else torch.from_numpy(w)))
    assert ov == j_ov
    for a in (exact, dist_auc, unbounded):
        assert abs(a - full) < 1e-9 and abs(a - j_full) < 1e-9
    assert abs(exact - j_exact) < 1e-9
    if ov == 0:
        assert abs(auc - j_auc) < 1e-9 and abs(auc - full) < 1e-9
    if case == "skew":
        assert ov > 0  # the bounded pass dropped, the retry is exact
    for g in got[4]:
        assert g["auc"][case] == got[4][0]["auc"][case]


# ------------------------------------------------------------ Trainer

def _compare_params(state, j_params, model_name, tol=TOL):
    tm = wk._port_model(model_name, None)
    want = bridge.from_jax_params(_trim(j_params, _params(model_name)), tm)
    for name, w in want.items():
        np.testing.assert_allclose(state[name], w.numpy(), **tol,
                                   err_msg=name)


@pytest.mark.parametrize("case", [c[0] for c in wk.TRAIN_CASES])
def test_mesh_trainer_matches_jax_mesh_trainer(run, case):
    got, ref, params = run
    spec = {c[0]: c for c in wk.TRAIN_CASES}[case]
    res, want = got[4][0]["train"][case], ref["train"][case]
    steps = res["steps"]
    if spec[6] > 1:  # the JAX program of k steps reports their sum
        steps = [{k: a[k] + b[k] for k in a}
                 for a, b in zip(steps[::2], steps[1::2])]
    assert len(steps) == len(want["steps"])
    for ts, js in zip(steps, want["steps"]):
        assert set(ts) == set(js)
        for k in js:
            np.testing.assert_allclose(ts[k], js[k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    _compare_params(res["state"], want["params"], spec[1])
    np.testing.assert_allclose(res["pred"], want["pred"], **TOL)
    for k in ("bank_overflow", "exchange_overflow"):
        assert res["history"].get(k) == want["history"].get(k)
    if "lazy" in res:
        b = want["opt"][1]
        rows = res["lazy"]["mu"].shape[0]
        assert res["lazy"]["count"] == int(b["count"]) == wk.STEPS
        np.testing.assert_array_equal(res["lazy"]["last"],
                                      np.asarray(b["last"])[:rows])
        for k in ("mu", "nu"):
            np.testing.assert_allclose(res["lazy"][k],
                                       np.asarray(b[k])[:rows], **TOL,
                                       err_msg=k)
    # every rank holds the same replicated parameters and the same view
    for g in got[4][1:]:
        other = g["train"][case]
        for name, a in res["state"].items():
            np.testing.assert_array_equal(other["state"][name], a,
                                          err_msg=name)
        np.testing.assert_array_equal(other["pred"], res["pred"])


def test_mesh_evaluate_domains_matches_jax(run):
    got, ref, _ = run
    want_m, want_d = ref["train"]["satrans_dense"]["eval"]
    for g in got[4]:
        m, d = g["train"]["satrans_dense"]["eval"]
        assert set(d) == set(want_d)
        np.testing.assert_allclose(m["auc"], want_m["auc"], atol=1e-6)
        np.testing.assert_allclose(m["binary_crossentropy"],
                                   want_m["binary_crossentropy"], atol=1e-6)
        for v, a in want_d.items():
            np.testing.assert_allclose(d[v], a, atol=1e-6)
        ev = g["train"]["satrans_dense"]["evaluate"]
        np.testing.assert_allclose(ev["auc"], m["auc"], atol=1e-6)


def test_fit_from_iterator_matches_jax_mesh(run):
    got, ref, _ = run
    want = ref["iterator"]
    for g in got[2]:
        res = g["iterator"]
        assert len(res["steps"]) == len(want["steps"]) == wk.STEPS
        for ts, js in zip(res["steps"], want["steps"]):
            for k in js:
                np.testing.assert_allclose(ts[k], js[k], rtol=1e-5,
                                           atol=1e-7, err_msg=k)
        _compare_params(res["state"], want["params"], "SATrans")
        rows = res["lazy"]["mu"].shape[0]
        np.testing.assert_array_equal(
            res["lazy"]["last"], np.asarray(want["opt"][1]["last"])[:rows])


def test_resolve_bank_mode_raises_under_a_mesh():
    from satrans_torch.parallel import make_mesh as port_mesh
    from satrans_torch.train import Trainer
    mesh = port_mesh("cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        Trainer(wk._port_model("SATrans", None), embedding_exchange="alltoall",
                device="cpu")
    tr = Trainer(wk._port_model("SATrans", None), mesh=mesh,
                 shard_embeddings=True, embedding_exchange="alltoall",
                 device="cpu")
    with pytest.raises(ValueError, match="single-device"):
        tr.compile(bank_update="lazy_stale")
    with pytest.raises(ValueError, match="'fused', 'fused_eq' or 'lazy'"):
        tr.compile(bank_update="dense")
    with pytest.raises(ValueError, match="stock 'adam'"):
        tr.compile(optimizer="sgd")
    tr.compile()
    assert tr._bank_mode == "fused_eq"
    with pytest.raises(ValueError, match="unknown embedding_exchange"):
        Trainer(wk._port_model("SATrans", None), mesh=mesh,
                embedding_exchange="ring", device="cpu")


# ------------------------------------------------------------ 2 ranks

def test_mesh_dropout_masks_equal_one_process(run):
    """Two ranks at dropout 0.1 on tiles of 16 draw the one-process
    masks: each rank's are its rows of the single run's, bit for bit."""
    got, _, _ = run
    single = got[2][0]["dropout"]["single"]
    ranks = [g["dropout"]["mesh"] for g in got[2]]
    assert len(single["masks"]) == len(ranks[0]["masks"]) > 0
    for i, masks in enumerate(single["masks"]):
        for j, m in enumerate(masks):
            if m is None:
                continue
            parts = np.concatenate([r["masks"][i][j] for r in ranks])
            np.testing.assert_array_equal(parts, m)
    for ts, ss in zip(ranks[0]["steps"], single["steps"]):
        for k in ss:
            np.testing.assert_allclose(ts[k], ss[k], rtol=1e-5, err_msg=k)
    for name, a in single["state"].items():
        np.testing.assert_allclose(ranks[0]["state"][name], a, **TOL,
                                   err_msg=name)


def test_mesh_star_batch_norm_equals_one_process(run):
    """STAR's domain BatchNorm takes the global batch's moments: two ranks'
    parameters and running statistics equal one process's."""
    got, _, _ = run
    single = got[2][0]["star"]["single"]
    for g in got[2]:
        res = g["star"]["mesh"]
        for ts, ss in zip(res["steps"], single["steps"]):
            for k in ss:
                np.testing.assert_allclose(ts[k], ss[k], rtol=1e-5,
                                           err_msg=k)
        for name, a in single["state"].items():
            np.testing.assert_allclose(res["state"][name], a, **TOL,
                                       err_msg=name)
    assert any(k.startswith("bn.") for k in single["state"])


# ------------------------------------------------------------ checkpoint

def test_mesh_checkpoint_round_trip(run):
    got, _, _ = run
    for g in got[4]:
        res = g["train"]["satrans_lazy_alltoall"]
        for restored in (res["restored"], res["from_single"]):
            state, lazy = restored
            for name, a in res["state"].items():
                np.testing.assert_array_equal(state[name], a, err_msg=name)
            for k in ("mu", "nu", "last"):
                np.testing.assert_array_equal(lazy[k], res["lazy"][k])
            assert lazy["count"] == res["lazy"]["count"]


def test_mesh_checkpoint_restores_on_one_card(run):
    got, _, _ = run
    res = got[4][0]["train"]["satrans_lazy_alltoall"]
    state, lazy = res["single"]
    for name, a in res["state"].items():
        np.testing.assert_array_equal(state[name], a, err_msg=name)
    for k in ("mu", "nu", "last"):
        np.testing.assert_array_equal(lazy[k], res["lazy"][k])


# ------------------------------------------------------------ CLI

def test_cli_two_ranks_print_the_same_aucs(run):
    got, _, _ = run
    lines = [g["cli"] for g in got[2]]
    assert lines[0] and lines[0][0].startswith("test AUC")
    assert any(ln.startswith("Domain") for ln in lines[0])
    assert lines[0] == lines[1]


def test_import_starts_no_process_group(run):
    """Importing the port (its CLI, the Trainer and ``parallel``) joins no
    process group and imports no JAX: each rank process's state before it
    initialises its group."""
    got, _, _ = run
    for ranks in got.values():
        for g in ranks:
            assert g["imported"] == {"process_group": False, "jax": []}


def test_initialize_refuses_what_nccl_cannot_run(monkeypatch):
    """``nccl`` takes one rank a card: more ranks than cards (here one)
    raises, naming the gloo setting; and it needs the card.  Checked
    before any process group starts."""
    from satrans_torch.parallel import distributed
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="SATRANS_DIST_BACKEND=gloo"):
        distributed.initialize("127.0.0.1:1", 2, 0, device="cuda")
    with pytest.raises(ValueError, match="needs the card"):
        distributed.initialize("127.0.0.1:1", 2, 0, backend="nccl",
                               device="cpu")
    with pytest.raises(ValueError, match="together"):
        distributed.initialize("127.0.0.1:1", 2, device="cpu")
    assert not torch.distributed.is_initialized()


def test_cli_mesh_must_be_the_world_size():
    from satrans_torch.cli.main import main
    with pytest.raises(ValueError, match="a rank is a process"):
        main(["--data_name", "synthetic", "--mesh", "2"], device="cpu")
