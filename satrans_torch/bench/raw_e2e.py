"""The raw AliCCP workflow end to end on the port (twin of
``satrans_tpu/bench/raw_e2e.py``): generated raw inputs through
``data.aliccp.preprocess_raw`` and ``cli.main`` to the overall and
per-domain test AUCs, which ``RAWE2E_r05.json`` pins.

The real AliCCP release is not at hand, so the module GENERATES the
reference's raw input files from a seed - ``sample_skeleton_{train,test}.csv``
with GLOBAL feature ids (aliccp_dataset_processing.py:158 MIN_V offsets)
and ``common_features_{train,test}.csv`` with the \\x01/\\x02/\\x03-packed
history kvs (:254-295) - with a planted domain-dependent click signal;
the generator is the JAX package's, so the same seed gives the same
files.  Then ``preprocess_raw`` builds ``alicpp.h5`` and ``cli.main``
trains SATrans on it at the golden's flags (d = 8, 2 heads, 1 layer,
batch 1024) and writes the results CSV.

    python3 -m satrans_torch.bench.raw_e2e            # on the card
    python3 -m satrans_torch.bench.raw_e2e --device cpu

prints one JSON line: the AUCs, the test loss, the golden's AUCs and
whether each is within its tolerance, and the seconds of each stage.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from ..data import aliccp

N_TRAIN = 80_000
N_TEST = 20_000
N_USERS = 1_500
SEED = 7
# small local-id caps keep the synthetic vocabs learnable at this scale
# while still exercising every field's MIN_V offset
CAP = 50
GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "RAWE2E_r05.json")


def _skeleton(n: int, rng) -> dict[str, np.ndarray]:
    cols: dict[str, np.ndarray] = {}
    for c in aliccp.SPARSE_FEATURES:
        hi = min(aliccp.DATA_MAX[c], CAP)
        cols[c] = rng.integers(1, hi + 1, n)
    cols["301"] = rng.integers(1, 4, n)  # 3 scenarios, 1-based local
    # planted signal: domain-DEPENDENT feature effects, so per-domain AUC
    # is meaningful and a routing bug (wrong domain slicing) shows up
    d = cols["301"]
    f_a = cols["126"].astype(np.float64)  # vocab 3
    f_b = cols["121"].astype(np.float64) % 5
    coef = np.array([0.0, 1.2, -1.0, 0.8])[d]
    logits = coef * (f_a - 2.0) + 0.5 * (f_b - 2.0) * (d == 2) - 0.1
    p = 1.0 / (1.0 + np.exp(-logits))
    cols["click"] = (rng.random(n) < p).astype(np.int64)
    cols["purchase"] = (cols["click"] & (rng.random(n) < 0.1)).astype(
        np.int64)
    # to GLOBAL ids (what the raw skeleton carries; normalize_ids undoes)
    return {c: v + (aliccp.MIN_V[c] - 1) for c, v in cols.items()}


def _write_skeleton(path: str, cols: dict[str, np.ndarray]) -> None:
    import pandas as pd

    names = ["click", "purchase"] + list(aliccp.SPARSE_FEATURES)
    pd.DataFrame({c: cols[c] for c in names}).to_csv(path, index=False)


def _write_common_features(path: str, uids, rng) -> None:
    """One line per user: ``line_id,count,kvs`` with the packed history
    triples the parser expects (``data.aliccp.parse_common_features``)."""
    with open(path, "w") as f:
        for i, uid in enumerate(uids):
            kvs = [f"101\x02{uid}\x031.0"]
            for col, vocab, base in (("109_14", 200, 1_000_100),
                                     ("110_14", 300, 1_000_200),
                                     ("150_14", 150, 1_000_300),
                                     ("127_14", 120, 1_000_400)):
                for _ in range(int(rng.integers(2, 7))):
                    fid = base + int(rng.integers(1, vocab))
                    score = round(float(rng.random()), 4)
                    kvs.append(f"{col}\x02{fid}\x03{score}")
            joined = "\x01".join(kvs)
            f.write(f"{i},{len(kvs)},{joined}\n")


def generate_raw(dirpath: str, n_train: int = N_TRAIN, n_test: int = N_TEST,
                 seed: int = SEED) -> dict[str, str]:
    """Write the four raw CSVs into ``dirpath``; returns their paths."""
    rng = np.random.default_rng(seed)
    tr = _skeleton(n_train, rng)
    te = _skeleton(n_test, rng)
    # tie the skeleton's user ids to the common-features users so the
    # history join actually lands
    uids_local = rng.integers(1, N_USERS + 1, n_train + n_test)
    tr["101"] = uids_local[:n_train] + (aliccp.MIN_V["101"] - 1)
    te["101"] = uids_local[n_train:] + (aliccp.MIN_V["101"] - 1)
    paths = {
        "skeleton_train": os.path.join(dirpath, "sample_skeleton_train.csv"),
        "skeleton_test": os.path.join(dirpath, "sample_skeleton_test.csv"),
        "common_train": os.path.join(dirpath, "common_features_train.csv"),
        "common_test": os.path.join(dirpath, "common_features_test.csv"),
    }
    _write_skeleton(paths["skeleton_train"], tr)
    _write_skeleton(paths["skeleton_test"], te)
    users = np.arange(1, N_USERS + 1) + (aliccp.MIN_V["101"] - 1)
    _write_common_features(paths["common_train"], users[: N_USERS * 4 // 5],
                           rng)
    _write_common_features(paths["common_test"], users[N_USERS * 2 // 5:],
                           rng)
    return paths


def preprocess(workdir: str, n_train: int = N_TRAIN,
               n_test: int = N_TEST) -> str:
    """Generate the raw files in ``workdir`` and build its ``alicpp.h5``
    (k = 3, the CLI reader's ``{col}_3`` history contract); returns the
    h5 path."""
    raw = generate_raw(workdir, n_train, n_test)
    h5 = os.path.join(workdir, "alicpp.h5")
    aliccp.preprocess_raw(raw["skeleton_train"], raw["skeleton_test"],
                          raw["common_train"], raw["common_test"], h5, k=3)
    return h5


def cli_argv(workdir: str, res_dir: str) -> list[str]:
    """The golden's CLI flags on ``workdir``'s ``alicpp.h5``."""
    return ["--data_name", "alicpp", "--data_path", workdir,
            "--model_name", "SATrans", "--embedding_dim", "8",
            "--learning_rate", "0.01", "--domain_att_layer_num", "1",
            "--att_head_num", "2", "--meta_mode", "QK", "--domain_col",
            "301", "--flag", "sota", "--batch_size", "1024", "--seed",
            "1021", "--results_dir", res_dir]


def run(workdir: str, device="cuda", n_train: int = N_TRAIN,
        n_test: int = N_TEST) -> dict:
    """Generate the raw files, preprocess them and run the CLI on
    ``device``; returns the AUCs, the test loss and each stage's
    seconds."""
    from ..cli import main as cli

    t0 = time.perf_counter()
    preprocess(workdir, n_train, n_test)
    t1 = time.perf_counter()
    res_dir = os.path.join(workdir, "res")
    cli.main(cli_argv(workdir, res_dir), device=device)
    t2 = time.perf_counter()
    with open(os.path.join(res_dir, "alicpp_results.csv")) as f:
        fields = f.read().strip().splitlines()[-1].split(",")
    # {config},{overall},{d1},{d2},{d3},{loss} (reference main.py:381-395)
    return {"overall_auc": float(fields[1]),
            "per_domain_auc": [float(v) for v in fields[2:5]],
            "test_loss": float(fields[5]),
            "preprocess_s": t1 - t0, "cli_s": t2 - t1}


def against_golden(res: dict, golden_path: str = GOLDEN) -> dict:
    """Each AUC of ``res`` beside the golden's, and whether all four are
    within the golden's tolerance."""
    with open(golden_path) as f:
        golden = json.load(f)
    want = golden["results"]
    got = [res["overall_auc"]] + res["per_domain_auc"]
    ref = [want["overall_auc"]] + want["per_domain_auc"]
    return {"golden_auc": ref, "tolerance": golden["tolerance"],
            "max_auc_gap": max(abs(a - b) for a, b in zip(got, ref)),
            "within": all(abs(a - b) <= golden["tolerance"]
                          for a, b in zip(got, ref))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory() as td:
        res = run(td, device=args.device)
    res.update(against_golden(res))
    print(json.dumps(res))
    return 0 if res["within"] else 1


if __name__ == "__main__":
    sys.exit(main())
