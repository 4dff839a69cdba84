"""Experiment entry point with the reference CLI surface (twin of
``satrans_tpu/cli/main.py`` for every ``--model_name`` of it: SATrans,
the ten baselines of the zoo: WDL, DeepFM, DCN, xDeepFM, NFM, AFM, PNN,
AutoInt, FiBiNET, AdaSparse, the multi-domain baselines Star_Net,
SharedBottom, MMOE, PLE and ESMM, and the legacy Star_Trans,
Starv2_Trans, Starv3_Trans and Starv4_Trans; and every ``--domain_col``,
several scenario columns past ``SATRANS_COMPOSITE_MAX`` combinations
included).

Mirrors reference main.py: the same argparse flags (main.py:39-61), the
fit/predict protocol (main.py:338-353), the overall and per-domain AUC
report (main.py:356-374) and the results-CSV row (main.py:381-395), so
that reference, JAX-package and port runs are diffable.  The flags
``showattn`` and ``instattn`` run the attention probes
(``train/attention_probe.py``; K1-scores on the card), ``dump`` writes a
checkpoint (``train/checkpoint.py``, ``torch.save``) and the test
predictions ``<config>_testpred.pkl``, ``--finetune True`` restores that
checkpoint before ``fit``, and ``test`` aborts after 5 steps.

    python -m satrans_torch.cli.main --data_name synthetic --flag showattn

runs on the card; ``main(argv, device="cpu")`` runs the plain PyTorch path
on the CPU.  ``--data_name alicpp`` and ``alimama`` read the reference's
h5 files from ``--data_path`` (``data/io.py``: through ``h5py``, or where
it is not installed the port's HDF5 reader, for files the port's
preprocessing wrote); ``synthetic`` needs no file and no package beyond
numpy.

Distributed runs (JAX cli/main.py:62-90, :256-273, :341-398): one
process a rank, each running this CLI with ``--coordinator_address
host:port --num_processes n --process_id r`` and ``--mesh all`` (or
``--mesh n``, the world size); ``--shard_embeddings True`` splits the
bank's rows among the ranks, ``--embedding_exchange alltoall`` reads them
by the two-round exchange.  The backend is ``nccl`` (one card a rank) or,
with ``SATRANS_DIST_BACKEND=gloo``, ``gloo`` (ranks that share a card).
With more than one process training goes through the host-sharded
iterator and ``fit_from_iterator``, and the report through
``evaluate_domains`` on each rank's ``[r::n]`` shard of the test set; the
probes are skipped under ``--mesh``, and so is the ``dump`` of the test
predictions with more than one process.

Not ported, raising ``NotImplementedError`` that names its ROADMAP item:
``--bank_update lazy_stale``.  The JAX package's compilation cache has no
counterpart.
"""

from __future__ import annotations

import os
from argparse import ArgumentParser
from datetime import datetime

import numpy as np


def boolean_string(s):
    if s not in {"False", "True"}:
        raise ValueError("Not a valid boolean string")
    return s == "True"


def parse_args(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--data_name", type=str, default="alicpp")
    parser.add_argument("--data_path", type=str, default="./data")
    parser.add_argument("--model_name", type=str, default="SATrans")
    parser.add_argument("--seed", type=int, default=1024)
    parser.add_argument("--merge", type=str, default="no")
    parser.add_argument("--num_query_bases", type=int, default=3)
    parser.add_argument("--share_domain_dnn_across_layers",
                        type=boolean_string, default=False)
    parser.add_argument("--domain_col", type=str, default="None")
    parser.add_argument("--embedding_dim", type=int, default=32)
    parser.add_argument("--att_layer_num", type=int, default=0)
    parser.add_argument("--domain_att_layer_num", type=int, default=3)
    parser.add_argument("--att_layer_type", type=str, default="deepctr")
    parser.add_argument("--att_head_num", type=int, default=4)
    parser.add_argument("--flag", type=str, default="None")
    parser.add_argument("--filter_feats", type=boolean_string, default=False)
    parser.add_argument("--learning_rate", type=float, default=0.001)
    parser.add_argument("--prompt", type=boolean_string, default=True)
    parser.add_argument("--finetune", type=boolean_string, default=False)
    parser.add_argument("--attn_batch_reg", type=float, default=0.1)
    parser.add_argument("--meta_mode", type=str, default="Query")
    # rebuild-specific
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--scan_steps", type=int, default=1)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--synthetic_rows", type=int, default=100_000)
    parser.add_argument("--results_dir", type=str, default=".")
    parser.add_argument("--checkpoint_dir", type=str, default="./checkpoints")
    # the distributed surface (one process a rank; the JAX package's flags)
    parser.add_argument("--mesh", type=str, default="none",
                        help="'none' (one device), 'all' (every rank of "
                             "the process group), or the world size")
    parser.add_argument("--shard_embeddings", type=boolean_string,
                        default=False,
                        help="row-shard the fused embedding banks over the "
                             "mesh (optimizer state follows the rows)")
    parser.add_argument("--bank_update", type=str, default="auto",
                        choices=["auto", "dense", "fused", "fused_eq",
                                 "lazy", "lazy_stale"],
                        help="embedding-bank update path "
                             "(train/bank_optimizer.py; 'lazy' is the "
                             "documented deviation, PARITY.md)")
    parser.add_argument("--embedding_exchange", type=str, default="xla",
                        choices=["xla", "alltoall"],
                        help="how a row-sharded bank is read: XLA SPMD "
                             "gather or the explicit two-round all-to-all")
    parser.add_argument("--exchange_capacity_factor", type=float,
                        default=None,
                        help="per-owner capacity of the forward exchange "
                             "(None = exact worst case; 2.0 recommended "
                             "at scale - see docs/SCALING.md)")
    parser.add_argument("--lazy_capacity_factor", type=float, default=2.0,
                        help="per-owner capacity of the lazy commit "
                             "exchange under a mesh")
    # multi-host bring-up (controller-less; every process runs this CLI)
    parser.add_argument("--coordinator_address", type=str, default=None)
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    return parser.parse_args(argv)


def config_str(args, domain_col: str, flag: str) -> str:
    """Run-config key, matching the reference's CSV/checkpoint naming
    (main.py:200-205, 383-393)."""
    m = args.model_name
    if "Star_Trans" in m:
        return (f"{m}_{args.embedding_dim}_{args.learning_rate}_"
                f"{args.domain_att_layer_num}_{args.att_head_num}_"
                f"{args.merge}_{args.seed}_{domain_col}_{flag}")
    if "SATrans" in m:
        return (f"{m}_{args.embedding_dim}_{args.learning_rate}_"
                f"{args.domain_att_layer_num}_{args.att_head_num}_"
                f"{args.meta_mode}_{args.seed}_{domain_col}_{flag}")
    if "AutoInt" in m:
        return (f"{m}_{args.embedding_dim}_{args.learning_rate}_"
                f"{args.att_layer_num}_{args.att_head_num}_"
                f"{args.att_layer_type}_{args.seed}_{domain_col}_{flag}")
    return (f"{m}_{args.embedding_dim}_{args.learning_rate}_"
            f"{args.seed}_{domain_col}_{flag}")


def value_counts(values) -> str:
    """The counts of ``pandas.Series(values).value_counts()`` as text, one
    ``value count`` line each, most frequent first (ties in order of first
    appearance), with numpy."""
    vals, first, counts = np.unique(np.asarray(values), return_index=True,
                                    return_counts=True)
    order = np.lexsort((first, -counts))
    return "\n".join(f"{vals[i]}    {counts[i]}" for i in order)


def load_dataset(args, flag: str, domain_col: str):
    """Returns (train, test, labels_name, sparse, dense, varlen, data_max,
    topk, extras) - ``extras`` carries dataset-derived artifacts (the
    sparseprice label-encoder classes, main.py:148-153, 335)."""
    from ..data import aliccp, alimama, synthetic

    if args.data_name == "alicpp":
        labels = "click"
        sparse = list(aliccp.SPARSE_FEATURES)
        var_features: list[str] = []
        dense: list[str] = []
        topk = 3
        h5 = os.path.join(args.data_path, "alicpp.h5")
        cols = [labels] + sparse + var_features
        train = aliccp.load_split(h5, "ctr_train", cols, k=topk)
        print("load train finish")
        test = aliccp.load_split(h5, "ctr_test", cols, k=topk)
        print("load test finish")
        # domain id starts from 1 (main.py:112-114)
        if train["301"].min() == 0:
            train["301"] = train["301"] + 1
            test["301"] = test["301"] + 1
        # scenario distribution diagnostics at load (main.py:116-117)
        if "-" not in domain_col:
            print(value_counts(train[domain_col]))
            print(value_counts(test[domain_col]))
        data_max = dict(aliccp.DATA_MAX)
        return (train, test, labels, sparse, dense, var_features, data_max,
                topk, {})

    if args.data_name == "alimama":
        labels = "clk"
        extras = {}
        sparse = list(alimama.SPARSE_FEATURES)
        data = alimama.load(os.path.join(args.data_path, "alimama.h5"))
        if "sparseprice" in flag:
            print("transform price")
            sparse = sparse + ["price"]
            dense = []
            # label-encode price (main.py:148-153); the encoder's classes
            # decode price ids in the instattn dump (main.py:335,
            # meta_basemodel.py:475)
            vals, inv = np.unique(data["price"], return_inverse=True)
            data["price"] = inv.astype(np.int64)
            extras = {"price_classes": vals}
        else:
            dense = ["price"]
            p = data["price"].astype(np.float64)
            lo, hi = p.min(), p.max()
            data["price"] = ((p - lo) / (hi - lo if hi > lo else 1.0)
                             ).astype(np.float32)
        # scenario distribution diagnostics at load (main.py:159-160)
        if "-" not in domain_col:
            print(value_counts(data[domain_col]))
        train, test = alimama.split_by_time(data)
        data_max = {k: int(v.max()) for k, v in data.items()}
        return train, test, labels, sparse, dense, [], data_max, 3, extras

    if args.data_name == "synthetic":
        labels = "click"
        num_sparse = 8
        sparse = [f"f{i}" for i in range(num_sparse)] + ["domain"]
        x, y = synthetic.synthetic_data(
            n=args.synthetic_rows, num_sparse=num_sparse, vocab=1000,
            num_domains=3, seed=args.seed)
        x[labels] = y
        n_train = int(0.8 * len(y))
        train = {k: v[:n_train] for k, v in x.items()}
        test = {k: v[n_train:] for k, v in x.items()}
        data_max = {k: int(x[k].max()) for k in sparse}
        return train, test, labels, sparse, [], [], data_max, 3, {}

    raise NotImplementedError(f"unknown data_name {args.data_name}")


def feature_layout(args, sparse, dense, var_features, data_max, topk):
    """The model's columns: each sparse and varlen field with vocab
    ``data_max + 2`` at ``--embedding_dim``, and the dense fields."""
    from ..features import (DenseFeature, FeatureLayout, SparseFeature,
                            VarLenSparseFeature)
    return FeatureLayout(
        [SparseFeature(f, int(data_max[f]) + 2, args.embedding_dim)
         for f in sparse]
        + [DenseFeature(f, 1) for f in dense]
        + [VarLenSparseFeature(f, int(data_max[f]) + 2, args.embedding_dim,
                               maxlen=topk, combiner="max")
           for f in var_features])


# the legacy Star-Trans models (satrans_tpu/cli/main.py:213-230)
LEGACY_MODELS = ("Star_Trans", "Starv2_Trans", "Starv3_Trans",
                 "Starv4_Trans")


def build_model(args, layout, domain_col_list, num_domains_list, flag, *,
                device="cuda"):
    """The model ``--model_name`` names, configured as the reference CLI
    configures it (satrans_tpu/cli/main.py:199-247): SATrans with MetaNet
    d -> 2d -> d and the flag's variant and switches; the legacy
    Star-Trans models with the first scenario column, ``--att_layer_num``,
    ``--domain_att_layer_num``, ``--att_head_num``, ``--att_layer_type``
    and the flag, Star_Trans with ``--merge``, Starv2_Trans with
    ``--num_query_bases``, ``--share_domain_dnn_across_layers`` and
    ``--attn_batch_reg``, Starv3_Trans and Starv4_Trans with
    ``--meta_mode``; Star_Net with the DNN (256, 128) and the domain DNN
    and BatchNorm; SharedBottom, MMOE, PLE and ESMM with one task a domain
    of the first scenario column (ESMM, which takes two, raises unless
    there are two); AutoInt with ``--att_layer_num`` (3 if 0) and
    ``--att_head_num``; the other zoo baselines with the first scenario
    column and its domain count."""
    from ..models import MODEL_REGISTRY, SATrans

    name = args.model_name
    if name not in MODEL_REGISTRY:
        raise ValueError("no such model")
    if name == "SATrans":
        return SATrans(layout, domain_col_list, num_domains_list,
                       domain_att_layer_num=args.domain_att_layer_num,
                       att_head_num=args.att_head_num,
                       meta_mode=args.meta_mode,
                       meta_dnn_hidden_units=(2 * args.embedding_dim,
                                              args.embedding_dim),
                       use_pos="pos" in flag,
                       variant=("gate" if "gate" in flag else
                                "bilinear" if "bilinear" in flag
                                else "metanet"),
                       only_emb="onlyemb" in flag, relu_out="relu" in flag,
                       no_emb_init="noembinit" in flag, seed=args.seed,
                       device=device)
    if name in LEGACY_MODELS:
        kw = dict(domain_col=domain_col_list[0],
                  num_domains=num_domains_list[0],
                  att_layer_num=args.att_layer_num,
                  domain_att_layer_num=args.domain_att_layer_num,
                  att_head_num=args.att_head_num,
                  att_layer_type=args.att_layer_type, flag=flag,
                  seed=args.seed, device=device)
        if name == "Star_Trans":
            kw["merge"] = args.merge
        if name == "Starv2_Trans":
            kw.update(num_query_bases=args.num_query_bases,
                      share_domain_dnn_across_layers=(
                          args.share_domain_dnn_across_layers),
                      attn_batch_reg=args.attn_batch_reg)
        if name in ("Starv3_Trans", "Starv4_Trans"):
            kw["meta_mode"] = args.meta_mode
        return MODEL_REGISTRY[name](layout, **kw)
    if name == "Star_Net":
        return MODEL_REGISTRY[name](
            layout, domain_col=domain_col_list[0],
            num_domains=num_domains_list[0], dnn_hidden_units=(256, 128),
            use_domain_dnn=True, use_domain_bn=True, flag=flag,
            seed=args.seed, device=device)
    if name in ("SharedBottom", "MMOE", "PLE", "ESMM"):
        return MODEL_REGISTRY[name](
            layout, num_tasks=num_domains_list[0],
            domain_col=domain_col_list[0], flag=flag, seed=args.seed,
            device=device)
    kw = dict(flag=flag, domain_col=domain_col_list[0],
              num_domains=num_domains_list[0], seed=args.seed, device=device)
    if name == "AutoInt":
        kw.update(att_layer_num=args.att_layer_num or 3,
                  att_head_num=args.att_head_num)
    return MODEL_REGISTRY[name](layout, **kw)


def _unported(args) -> None:
    """Raise for the JAX CLI's options the port does not have yet."""
    if args.bank_update == "lazy_stale":
        raise NotImplementedError(
            "--bank_update lazy_stale: ROADMAP queue 1 item 'lazy_stale'")


def _mesh(args, device):
    """Join the process group the coordinator flags name (the backend
    from ``SATRANS_DIST_BACKEND``, else ``nccl`` on the card and ``gloo``
    on the CPU) and return the mesh ``--mesh`` asks for, or None."""
    from ..parallel import distributed, make_mesh
    if args.coordinator_address is not None:
        distributed.initialize(
            args.coordinator_address, args.num_processes, args.process_id,
            backend=os.environ.get("SATRANS_DIST_BACKEND") or None,
            device=device)
    if args.mesh == "none":
        return None
    mesh = make_mesh(device)
    if args.mesh != "all" and int(args.mesh) != mesh.world:
        raise ValueError(
            f"--mesh {args.mesh} with {mesh.world} process(es): a rank is a "
            "process, so --mesh is 'all' or the world size (start one "
            "process a rank with --coordinator_address, --num_processes "
            "and --process_id)")
    print(f"mesh: {mesh.world} ranks, rank {mesh.rank} on {mesh.device}")
    return mesh


def main(argv=None, *, device="cuda"):
    """Run the experiment the flags describe; returns the rounded test AUC.
    ``device`` is the card unless the caller asks for the CPU."""
    from ..train import Trainer, callbacks as cb, metrics
    from ..utils import resolve_device

    args = parse_args(argv)
    _unported(args)
    device = resolve_device(device)
    mesh = _mesh(args, device)
    if mesh is not None:
        device = mesh.device
    model_name = args.model_name
    flag = args.flag
    batch_size = args.batch_size or (4096 if model_name == "xDeepFM"
                                     else 4096 * 2)
    test_batch_size = batch_size * 4
    print(args)

    default_domain_col = {"alicpp": "301", "alimama": "pid",
                          "synthetic": "domain"}
    domain_col = args.domain_col
    if domain_col == "None":
        domain_col = default_domain_col[args.data_name.split("_")[0]]
    domain_col_list = domain_col.split("-")

    (train, test, target, sparse, dense, var_features, data_max, topk,
     extras) = load_dataset(args, flag, domain_col)

    num_domains_list = [
        max(len(np.unique(train[c])), data_max[c]) for c in domain_col_list]

    layout = feature_layout(args, sparse, dense, var_features, data_max,
                            topk)

    model = build_model(args, layout, domain_col_list, num_domains_list,
                        flag, device=device)

    print(f"=============={args.data_name}===================================")
    print(f"model name: {model_name}..{flag}..{args.seed}...{domain_col}...")

    feature_names = sparse + dense + var_features
    train_x = {n: train[n] for n in feature_names}
    test_x = {n: test[n] for n in feature_names}

    trainer = Trainer(model, mesh=mesh,
                      shard_embeddings=args.shard_embeddings,
                      embedding_exchange=args.embedding_exchange,
                      exchange_capacity_factor=args.exchange_capacity_factor,
                      seed=args.seed, device=device)
    trainer.compile(learning_rate=args.learning_rate,
                    loss="binary_crossentropy",
                    metrics=["binary_crossentropy", "auc"],
                    bank_update=args.bank_update,
                    lazy_capacity_factor=args.lazy_capacity_factor)

    fit_callbacks = []
    if "test" in flag:
        # crash probe: abort after 5 steps with the loss printed
        # (reference meta_basemodel.py:321-323)
        fit_callbacks.append(cb.TestCrashProbe())

    if args.finetune:
        from ..train import checkpoint
        checkpoint.restore(os.path.join(args.checkpoint_dir,
                                        config_str(args, domain_col, flag)),
                           trainer)
        print("restored checkpoint for finetuning")

    nprocs = mesh.world if mesh is not None else 1
    pid = mesh.rank if mesh is not None else 0
    if nprocs > 1:
        # every rank feeds its shard of the global batch
        from ..data.loader import Prefetcher, ShardedBatchIterator
        it = ShardedBatchIterator(
            trainer.layout.batch_from_dict(train_x),
            np.asarray(train[target], np.float32), batch_size,
            seed=args.seed, host_id=pid, num_hosts=nprocs)
        trainer.fit_from_iterator(
            lambda e: Prefetcher(it.epoch(e)), epochs=args.epochs,
            domain_offset=int(np.min(train_x[domain_col_list[0]])),
            verbose=1 if pid == 0 else 0)
    else:
        trainer.fit(train_x, train[target], batch_size=batch_size,
                    epochs=args.epochs, verbose=1,
                    scan_steps=args.scan_steps, callbacks=fit_callbacks)

    os.makedirs(args.results_dir, exist_ok=True)
    domain_col_show = domain_col_list[0]

    if mesh is not None:
        # the report from the distributed evaluation: the scores stay on
        # each rank, the AUCs from the distributed rank AUC
        if "showattn" in flag or "instattn" in flag:
            print("attention probes need a single device - skipped "
                  "under --mesh")
        tx = ({k: v[pid::nprocs] for k, v in test_x.items()}
              if nprocs > 1 else test_x)
        ty = (np.asarray(test[target])[pid::nprocs]
              if nprocs > 1 else test[target])
        m, dom_aucs = trainer.evaluate_domains(
            tx, ty, domain_col=domain_col_show, batch_size=test_batch_size)
        test_auc = round(m["auc"], 4)
        test_loss = m["binary_crossentropy"]
        test_auc_list = [str(test_auc)]
        print("test AUC", test_auc)
        for i, domain_auc in dom_aucs.items():
            print(f"Domain {i} test AUC", round(domain_auc, 4))
            test_auc_list.append(str(round(domain_auc, 4)))
        pred = None
        if "dump" in flag:
            if nprocs > 1:
                print("dump: skipping testpred.pkl (each process holds "
                      "only its shard of the test set)")
            else:
                pred = trainer.predict(test_x, test_batch_size)
        return _write_results(args, domain_col, flag, test_auc,
                              test_auc_list, test_loss, trainer, pred)

    if "showattn" in flag and hasattr(model, "domain_cols"):
        from ..train.attention_probe import predict_with_attention
        pred, attn_stats = predict_with_attention(
            trainer, test_x, test[target], batch_size=test_batch_size)
        np.save(os.path.join(args.results_dir, "attn_stats.npy"),
                np.asarray(attn_stats, dtype=object), allow_pickle=True)
    else:
        pred = trainer.predict(test_x, test_batch_size)
    if "instattn" in flag and hasattr(model, "domain_cols"):
        if args.data_name == "alimama" and "sparseprice" in flag:
            # byte-format parity with the reference's Alimama dump
            # (meta_basemodel.py:460-499, price decode main.py:335)
            from ..train.attention_probe import \
                dump_instance_attention_reference
            dump_instance_attention_reference(
                trainer, test_x, test[target], flag=flag,
                classes_=extras.get("price_classes"),
                batch_size=test_batch_size, out_dir=args.results_dir)
        else:
            from ..train.attention_probe import dump_instance_attention
            dump_instance_attention(
                trainer, test_x, batch_size=test_batch_size,
                out_prefix=os.path.join(args.results_dir, "inst_attn"))

    test_auc = round(metrics.auc(test[target], pred), 4)
    test_loss = metrics.log_loss(test[target], pred)
    test_auc_list = [str(test_auc)]
    print("test AUC", test_auc)

    # per-domain report slices on the first scenario column (with a composite
    # --domain_col a-b, reference main.py:367-368 would index a missing key)
    for i, domain_auc in metrics.per_domain_auc(
            test[target], pred, test_x[domain_col_show]).items():
        print(f"Domain {i} test AUC", round(domain_auc, 4))
        test_auc_list.append(str(round(domain_auc, 4)))

    return _write_results(args, domain_col, flag, test_auc, test_auc_list,
                          test_loss, trainer, pred)


def _write_results(args, domain_col, flag, test_auc, test_auc_list,
                   test_loss, trainer, pred):
    """Results-CSV row + optional dump (reference main.py:381-401).  Under
    a mesh the first rank alone writes the row and the predictions."""
    dt = datetime.now().strftime("%m-%d-%H-%M")
    print(dt)
    config = config_str(args, domain_col, flag)
    first = trainer.mesh is None or trainer.mesh.rank == 0
    if first:
        os.makedirs(args.results_dir, exist_ok=True)
        file_name = os.path.join(args.results_dir,
                                 f"{args.data_name}_results.csv")
        with open(file_name, "a") as f:
            f.write(f"{dt}-{config}," + ",".join(test_auc_list)
                    + f",{test_loss:.6f}\n")

    if "dump" in flag:
        from ..data import io as data_io
        from ..train import checkpoint
        path = os.path.join(args.checkpoint_dir, config)
        checkpoint.save(path, trainer)
        if pred is not None and first:
            data_io.dump_pkl(pred, path + "_testpred.pkl")  # main.py:401
        print(f"checkpoint saved to {path}")

    return test_auc


if __name__ == "__main__":
    main()
