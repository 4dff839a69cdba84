"""One rank of ``tests/test_torch_parallel.py``: the port over gloo on the
CPU, one process a rank.

    python tests/torch_parallel_worker.py RANK WORLD PORT CLI_PORT IN_DIR OUT_DIR

runs every case of the group of ``WORLD`` ranks and writes
``OUT_DIR/rank<RANK>.pkl``.  The inputs are drawn here with numpy from
seeds (:func:`lookup_inputs`, :func:`routed_inputs`, :func:`auc_inputs`,
:func:`train_data`) and the test draws the same ones for the JAX side;
the models' parameters come from ``IN_DIR`` (the JAX models' pytrees,
written by the test), through ``satrans_torch.bridge``.  Neither JAX nor
the JAX package is imported.
"""

from __future__ import annotations

import contextlib
import io
import os
import pickle
import sys

import numpy as np

D = 8
R_LOOKUP, W_LOOKUP = 64, 8
LR, L2 = 0.01, 0.01
BATCH, STEPS = 32, 2
N_TRAIN = BATCH * STEPS


def columns(pkg):
    """Two large fields and the scenario column (a side-bank table)."""
    f = pkg.features
    return [f.SparseFeature("f0", 300, D), f.SparseFeature("f1", 500, D),
            f.SparseFeature("domain", 5, D)]


def satrans_kwargs(**extra):
    kw = dict(domain_cols=["domain"], num_domains_list=[3],
              domain_att_layer_num=2, att_head_num=2,
              meta_dnn_hidden_units=(16, D), dropout_rate=0.0,
              l2_reg_embedding=L2)
    kw.update(extra)
    return kw


DEEPFM = dict(dnn_hidden_units=(16, 8), l2_reg_embedding=L2)
STAR = dict(domain_col="domain", num_domains=3, dnn_hidden_units=(16, 8))

# (case, model, bank_update, shard_embeddings, embedding_exchange,
#  exchange_capacity_factor, scan_steps): the Trainer cases of 4 ranks
TRAIN_CASES = [
    ("deepfm_replicated", "DeepFM", "auto", False, "xla", None, 1),
    ("deepfm_sharded", "DeepFM", "auto", True, "xla", None, 1),
    ("deepfm_scan", "DeepFM", "auto", False, "xla", None, 2),
    ("satrans_lazy_alltoall", "SATrans", "lazy", True, "alltoall", 2.0, 1),
    ("satrans_fused_eq_sharded", "SATrans", "fused_eq", True, "xla", None,
     1),
    ("satrans_dense", "SATrans", "dense", False, "xla", None, 1),
]


def lookup_inputs(world):
    """(bank [R, W], {case: global ids [world * 16]}, w [world * 16, W])."""
    rng = np.random.default_rng(11)
    bank = rng.normal(size=(R_LOOKUP, W_LOOKUP)).astype(np.float32)
    n = world * 16
    ids = {"random": rng.integers(0, R_LOOKUP, n),
           "dup_oob": np.concatenate([rng.integers(0, 6, n - 4),
                                      [-3, 70, 5, 64]]),
           # every rank asks for the 16 rows rank 0 owns: past capacity 2
           "skew": np.tile(np.arange(R_LOOKUP // world), world)}
    w = rng.normal(size=(n, W_LOOKUP)).astype(np.float32)
    return bank, {k: v.astype(np.int32) for k, v in ids.items()}, w


def routed_inputs(world):
    """The lazy state and one step's rows: (bank, mu, nu, last, count,
    {case: (global ids [world * 24], g [world * 24, W])})."""
    rng = np.random.default_rng(12)
    bank = rng.normal(size=(R_LOOKUP, W_LOOKUP)).astype(np.float32)
    mu = (rng.normal(size=bank.shape) * 0.1).astype(np.float32)
    nu = rng.random(bank.shape).astype(np.float32) * 0.01
    count = 5
    last = rng.integers(0, count + 1, R_LOOKUP).astype(np.int32)
    n = world * 24
    g = rng.normal(size=(n, W_LOOKUP)).astype(np.float32)
    steps = {"spread": rng.integers(0, R_LOOKUP, n),
             "dup_oob": np.concatenate([rng.integers(0, 10, n - 2),
                                        [-4, 99]]),
             "skew": np.tile(np.arange(24) % (R_LOOKUP // world), world)}
    return bank, mu, nu, last, count, {k: (v.astype(np.int32), g)
                                       for k, v in steps.items()}


def auc_inputs(world):
    """{case: (y, s, w)} of world * 60 entries: ties (scores on a grid of
    0.05), weights in {0, 1, 2}, and a case sorted by score across the
    ranks, which overflows the splitters' buckets at capacity 2."""
    rng = np.random.default_rng(13)
    n = world * 60
    y = rng.integers(0, 2, n).astype(np.float32)
    s = (np.round(rng.random(n) * 20) / 20).astype(np.float32)
    w = rng.integers(0, 3, n).astype(np.float32)
    # distinct scores in ascending order: each rank's fall into one bucket
    skew = np.sort(rng.permutation(n) / n).astype(np.float32)
    return {"ties_weights": (y, s, w), "unweighted": (y, s, None),
            "skew": (y, skew, w)}


def train_data(n=N_TRAIN, seed=5):
    """The Trainer cases' rows (domains 1..3) and labels."""
    rng = np.random.default_rng(seed)
    x = {"f0": rng.integers(1, 300, n), "f1": rng.integers(1, 500, n),
         "domain": rng.integers(1, 4, n)}
    y = rng.integers(0, 2, n).astype(np.float32)
    return x, y


def block(a, rank, world):
    """Rank ``rank``'s block of a global array."""
    if a is None:
        return None
    per = len(a) // world
    return a[rank * per:(rank + 1) * per]


# ---------------------------------------------------------------- port side

def _port_model(name, params, state=None, **extra):
    import satrans_torch
    from satrans_torch import bridge
    from satrans_torch.models import MODEL_REGISTRY
    layout = satrans_torch.FeatureLayout(columns(satrans_torch))
    if name == "SATrans":
        m = MODEL_REGISTRY[name](layout, **satrans_kwargs(**extra),
                                 device="cpu")
    else:
        kw = DEEPFM if name == "DeepFM" else STAR
        m = MODEL_REGISTRY[name](layout, **kw, **extra, device="cpu")
    if params is not None:
        m.load_state_dict(bridge.from_jax_params(params, m, state))
    return m


def _full_state(tr):
    """The trainer's parameters and buffers with a row-sharded bank
    gathered, as numpy."""
    from satrans_torch.parallel.sharding import gather_bank
    sd = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    shard = getattr(tr.model.emb, "shard", None)
    if shard is not None:
        sd["emb.bank"] = gather_bank(sd["emb.bank"], shard, tr.model.emb.rp)
    return {k: v.numpy() for k, v in sd.items()}


def _lazy_state(tr):
    from satrans_torch.parallel.sharding import gather_bank
    shard = getattr(tr.model.emb, "shard", None)
    out = {}
    for k in ("mu", "nu", "last"):
        v = tr._lazy[k]
        out[k] = (gather_bank(v, shard, tr.model.emb.rp) if shard is not None
                  else v).numpy()
    out["count"] = tr._lazy["count"]
    return out


def _recording(tr):
    steps = []
    step = tr.train_step

    def record(*args):
        stats = step(*args)
        steps.append({k: float(v) for k, v in stats.items()})
        return stats

    tr.train_step = record
    return steps


def _trainer(mesh, case, params):
    from satrans_torch.train import Trainer
    _, name, mode, shard, exch, capf, _ = case
    tr = Trainer(_port_model(name, params), mesh=mesh, shard_embeddings=shard,
                 embedding_exchange=exch, exchange_capacity_factor=capf,
                 seed=7, device="cpu")
    tr.compile(learning_rate=LR, bank_update=mode)
    return tr


def lookup_cases(mesh):
    import torch
    from satrans_torch.parallel import embedding_sharded as es
    from satrans_torch.parallel.sharding import owned_rows
    bank, ids, w = lookup_inputs(mesh.world)
    local = torch.from_numpy(bank[owned_rows(R_LOOKUP, mesh)].copy())
    out = {}
    for case, g_ids in ids.items():
        mine = torch.from_numpy(block(g_ids, mesh.rank, mesh.world)).long()
        for capf in (None, 2.0):
            rows, ov = es.alltoall_lookup(local, mine, mesh, capf)
            out[f"alltoall/{case}/{capf}"] = (rows.numpy(), ov.numpy())
        out[f"sharded/{case}"] = es.sharded_lookup(
            local, mine.clamp(0, R_LOOKUP - 1), mesh).numpy()
    # the gradient through the exchange
    leaf = local.clone().requires_grad_(True)
    mine = torch.from_numpy(block(ids["random"], mesh.rank,
                                  mesh.world)).long()
    rows, _ = es.alltoall_lookup(leaf, mine, mesh, None)
    torch.sum(rows * torch.from_numpy(block(w, mesh.rank, mesh.world))
              ).backward()
    out["grad"] = mesh.all_gather(leaf.grad).numpy()
    # a [B, F] id block at the default capacity
    ids2 = torch.from_numpy(np.random.default_rng(3).integers(
        0, R_LOOKUP, (mesh.world * 8, 4))).long()
    rows, ov = es.alltoall_lookup(local, block(ids2, mesh.rank, mesh.world),
                                  mesh)
    out["alltoall/2d"] = (rows.numpy(), ov.numpy(), ids2.numpy())
    return out


def routed_cases(mesh):
    import torch
    from types import SimpleNamespace
    from satrans_torch.parallel import bank_sharded
    from satrans_torch.parallel.sharding import owned_rows
    from satrans_torch.train import bank_optimizer
    bank, mu, nu, last, count, steps = routed_inputs(mesh.world)
    rows = owned_rows(R_LOOKUP, mesh)
    out = {}
    for case, (g_ids, g) in steps.items():
        for capf in (2.0, None):
            b, m, v = (torch.from_numpy(a[rows].copy()) for a in
                       (bank, mu, nu))
            slots = torch.zeros(R_LOOKUP // mesh.world + 1,
                                dtype=torch.int64)
            slots[:-1] = torch.from_numpy(last[rows].astype(np.int64))
            ov = bank_sharded.lazy_routed_update(
                b, m, v, slots, count,
                torch.from_numpy(block(g_ids, mesh.rank, mesh.world)).long(),
                torch.from_numpy(block(g, mesh.rank, mesh.world)),
                lr=LR, l2=L2, mesh=mesh, capacity_factor=capf)
            out[f"{case}/{capf}"] = tuple(
                mesh.all_gather(t).numpy() for t in (b, m, v, slots[:-1])
            ) + (int(ov),)
        # the port's single-process lazy_update on the whole bank
        b, m, v = (torch.from_numpy(a.copy()) for a in (bank, mu, nu))
        slots = torch.zeros(R_LOOKUP + 1, dtype=torch.int64)
        slots[:-1] = torch.from_numpy(last.astype(np.int64))
        state = {"mu": m, "nu": v, "last": slots[:-1], "_last_slots": slots,
                 "count": count}
        bank_optimizer.lazy_update(
            SimpleNamespace(physical=lambda b=b: b), state,
            torch.from_numpy(g_ids).long(), torch.from_numpy(g), lr=LR,
            l2=L2)
        out[f"{case}/single"] = (b.numpy(), m.numpy(), v.numpy(),
                                 slots[:-1].numpy())
    return out


def auc_cases(mesh):
    import torch
    from satrans_torch.parallel import distributed as pd
    out = {}
    for case, (y, s, w) in auc_inputs(mesh.world).items():
        t = [None if a is None else
             torch.from_numpy(block(a, mesh.rank, mesh.world))
             for a in (y, s, w)]
        auc, ov = pd.auc_sharded(*t, mesh=mesh, return_overflow=True)
        out[case] = (float(auc), int(ov),
                     float(pd.auc_sharded_exact(*t, mesh=mesh)),
                     float(pd.distributed_auc(*t, mesh=mesh)),
                     float(pd.auc_sharded(*t, mesh=mesh,
                                          capacity_factor=None)))
    return out


def place_case(mesh, in_dir):
    """This rank's rows after placement, and the state that follows them:
    the lazy ``mu``, ``nu`` and ``last`` at once, the Adam moments of the
    bank after one ``fused_eq`` step."""
    from satrans_torch.train import Trainer
    x, y = train_data(BATCH)
    out = {}
    for mode in ("lazy", "fused_eq"):
        tr = Trainer(_port_model("SATrans", _load(in_dir, "SATrans")),
                     mesh=mesh, shard_embeddings=True, seed=7, device="cpu")
        tr.compile(learning_rate=LR, bank_update=mode)
        out[mode] = {"bank": tr.model.emb.bank.detach().numpy().copy(),
                     "rows_per": tr.model.emb.shard.rows_per}
        if mode == "lazy":
            out[mode]["lazy"] = {k: tuple(tr._lazy[k].shape)
                                 for k in ("mu", "nu", "last")}
        else:
            tr.fit(x, y, batch_size=BATCH, epochs=1, verbose=0)
            st = tr.optimizer.state[tr.model.emb.bank]
            out[mode]["adam"] = {k: tuple(v.shape) for k, v in st.items()}
    return out


def train_cases(mesh, in_dir, tmp):
    import torch
    from satrans_torch.train import Trainer, checkpoint
    x, y = train_data()
    out = {}
    for case in TRAIN_CASES:
        params = _load(in_dir, case[1])
        tr = _trainer(mesh, case, params)
        steps = _recording(tr)
        tr.fit(x, y, batch_size=BATCH, epochs=1, verbose=0, shuffle=True,
               scan_steps=case[6])
        res = {"steps": steps, "state": _full_state(tr),
               "history": dict(tr.history.history),
               "pred": tr.predict(x, batch_size=BATCH)}
        if tr._lazy is not None:
            res["lazy"] = _lazy_state(tr)
        if case[0] == "satrans_dense":
            xs = {k: v[mesh.rank::mesh.world] for k, v in x.items()}
            res["eval"] = tr.evaluate_domains(xs, y[mesh.rank::mesh.world],
                                              domain_col="domain",
                                              batch_size=BATCH)
            res["evaluate"] = tr.evaluate(x, y, batch_size=BATCH)
        if case[0] == "satrans_lazy_alltoall":
            # a round trip through a checkpoint, and from and to one card
            path = os.path.join(tmp, "mesh.ckpt")
            checkpoint.save(path, tr)
            again = _trainer(mesh, case, params)
            checkpoint.restore(path, again)
            res["restored"] = (_full_state(again), _lazy_state(again))
            if mesh.rank == 0:
                one = Trainer(_port_model("SATrans", params), seed=7,
                              device="cpu")
                one.compile(learning_rate=LR, bank_update="lazy")
                checkpoint.restore(path, one)
                res["single"] = (_full_state(one), _lazy_state(one))
                checkpoint.save(os.path.join(tmp, "single.ckpt"), one)
            mesh.barrier()
            back = _trainer(mesh, case, params)
            checkpoint.restore(os.path.join(tmp, "single.ckpt"), back)
            res["from_single"] = (_full_state(back), _lazy_state(back))
            res["file_bank"] = torch.load(path)["params"]["emb.bank"].numpy()
        out[case[0]] = res
    return out


def iterator_case(mesh, in_dir):
    """``fit_from_iterator`` on this rank's host shard
    (``ShardedBatchIterator(host_id=rank, num_hosts=world)``)."""
    from satrans_torch.data.loader import ShardedBatchIterator
    from satrans_torch.train import Trainer
    import satrans_torch
    x, y = train_data()
    m = _port_model("SATrans", _load(in_dir, "SATrans"))
    tr = Trainer(m, mesh=mesh, shard_embeddings=True,
                 embedding_exchange="alltoall", seed=7, device="cpu")
    tr.compile(learning_rate=LR, bank_update="lazy")
    steps = _recording(tr)
    layout = satrans_torch.FeatureLayout(columns(satrans_torch))
    it = ShardedBatchIterator(layout.batch_from_dict(x), y, BATCH, seed=3,
                              host_id=mesh.rank, num_hosts=mesh.world)
    tr.fit_from_iterator(it.epoch, epochs=1, domain_offset=1, verbose=0)
    return {"steps": steps, "state": _full_state(tr),
            "lazy": _lazy_state(tr)}


def dropout_case(mesh, in_dir):
    """SATrans at dropout 0.1 on tiles of 16 (a global batch of 32, so 16
    rows a rank), ``lazy`` on a sharded bank: the masks each layer drew,
    the statistics and the parameters; rank 0 also runs the one-process
    twin."""
    from satrans_torch.ops import prng
    from satrans_torch.train import Trainer
    x, y = train_data()
    params = _load(in_dir, "SATrans")
    drawn = []
    real = prng.dropout_masks

    def record(*args, **kw):
        masks = real(*args, **kw)
        drawn.append([None if m is None else m.numpy().copy()
                      for m in masks])
        return masks

    prng.dropout_masks = record

    def run(m):
        tr = Trainer(_port_model("SATrans", params, dropout_rate=0.1,
                                 fused_block_b=16), mesh=m,
                     shard_embeddings=m is not None,
                     embedding_exchange="alltoall" if m is not None
                     else "xla", seed=7, device="cpu")
        tr.compile(learning_rate=LR, bank_update="lazy")
        drawn.clear()
        steps = _recording(tr)
        tr.fit(x, y, batch_size=BATCH, epochs=1, verbose=0)
        return {"steps": steps, "state": _full_state(tr),
                "masks": list(drawn)}

    out = {"mesh": run(mesh)}
    if mesh.rank == 0:
        out["single"] = run(None)
    prng.dropout_masks = real
    return out


def star_case(mesh):
    """STAR (domain BatchNorm) at its own init, two ``dense`` steps on the
    mesh; rank 0 also runs the one-process twin."""
    from satrans_torch.train import Trainer
    x, y = train_data()

    def run(m):
        tr = Trainer(_port_model("Star_Net", None), mesh=m, seed=7,
                     device="cpu")
        tr.compile(learning_rate=LR)
        steps = _recording(tr)
        tr.fit(x, y, batch_size=BATCH, epochs=1, verbose=0)
        return {"steps": steps, "state": _full_state(tr)}

    out = {"mesh": run(mesh)}
    if mesh.rank == 0:
        out["single"] = run(None)
    return out


def cli_case(rank, world, port, tmp):
    """``cli.main`` as one rank of ``world`` processes, its own process
    group at ``port``; returns the AUC lines it printed."""
    from satrans_torch.cli.main import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["--data_name", "synthetic", "--synthetic_rows", "640",
              "--batch_size", "128", "--domain_att_layer_num", "1",
              "--embedding_dim", "8", "--att_head_num", "2",
              "--mesh", "all", "--coordinator_address",
              f"127.0.0.1:{port}", "--num_processes", str(world),
              "--process_id", str(rank), "--shard_embeddings", "True",
              "--bank_update", "lazy", "--embedding_exchange", "alltoall",
              "--results_dir", os.path.join(tmp, f"cli{rank}"),
              "--checkpoint_dir", os.path.join(tmp, f"ck{rank}")],
             device="cpu")
    return [ln for ln in buf.getvalue().splitlines() if "AUC" in ln]


def _load(in_dir, name):
    with open(os.path.join(in_dir, f"{name}.pkl"), "rb") as f:
        return pickle.load(f)


def run(rank, world, port, cli_port, in_dir, out_dir):
    import torch
    torch.set_num_threads(1)
    import satrans_torch.cli.main  # noqa: F401  (imports the whole port)
    from satrans_torch.parallel import distributed, make_mesh
    # the imports alone start no process group and bring no JAX in
    imported = {"process_group": torch.distributed.is_initialized(),
                "jax": sorted(m for m in sys.modules if m.split(".")[0]
                              in ("jax", "jaxlib", "satrans_tpu"))}
    distributed.initialize(f"127.0.0.1:{port}", world, rank, device="cpu",
                           timeout_s=240)
    mesh = make_mesh("cpu")
    tmp = os.path.join(out_dir, "tmp")
    os.makedirs(tmp, exist_ok=True)
    out = {"imported": imported}
    if world == 4:
        out["place"] = place_case(mesh, in_dir)
        out["lookup"] = lookup_cases(mesh)
        out["routed"] = routed_cases(mesh)
        out["auc"] = auc_cases(mesh)
        out["train"] = train_cases(mesh, in_dir, tmp)
    else:
        out["iterator"] = iterator_case(mesh, in_dir)
        out["dropout"] = dropout_case(mesh, in_dir)
        out["star"] = star_case(mesh)
        distributed.shutdown()
        out["cli"] = cli_case(rank, world, cli_port, tmp)
    distributed.shutdown()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    run(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
        int(sys.argv[4]), sys.argv[5], sys.argv[6])
