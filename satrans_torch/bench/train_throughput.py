"""SATrans training throughput on one card (twin of the JAX package's root
``bench.py``).

    python3 -m satrans_torch.bench.train_throughput [--modes dense,lazy]
        [--alimama | --no-alimama] [--chunks 4] [--steps 10]

The workload is ``bench.py``'s (bench.py:56-129): the full optimizer step
(forward, backward, Adam, the embedding L2) of SATrans at batch 8192, 3
meta-transformer layers, 4 heads, meta_mode QK, MetaNet 32 -> 64 -> 32,
dropout at the model default (0.1), ``Trainer(seed=1021)``:

* AliCCP sota (reference readme.md:17-19): the 19 fields with the real
  vocab sizes (``data/aliccp.py``), scenario column ``"301"`` with 3
  domains, lr 0.005;
* Alimama sota-pos (readme.md:21-23): the 15 fields with the public vocab
  sizes (``data/alimama.py``) and one dense column, scenario column
  ``shopping_level`` with 3 domains, ``use_pos``, lr 0.001.

The data is ``bench.py``'s: ``default_rng(0)``, ids uniform in ``[1,
DATA_MAX]`` for ``steps`` batches stacked on the field axis, 0/1 labels,
unit weights, staged on the card once.  The JAX package's ``lax.scan`` of
``steps`` steps is here ``steps`` calls of ``Trainer.train_step`` on the
staged batches, a chunk.  The kernels' build (all sources at once, where
they are not built yet) and one chunk of first launches are ``build_s``;
one more chunk warms up, then ``chunks`` chunks are
timed by ``ops/profiling.time_fn`` (CUDA events, one synchronize).

Arms: AliCCP ``dense`` (the exact reference update) and ``lazy`` (the
documented deviation, PARITY.md) with the split tail (K4, Adam, K2) and,
as ``lazy_fusedtail``, with ``SATRANS_LAZY_TAIL=fused`` (K5); Alimama
sota-pos ``lazy``.  As each arm ends it prints one JSON line: examples/s
and ms a step of the staged chunks, ``build_s``, the device busy time of
one staged step (``torch.profiler``; null where not measured), the
examples/s of ``Trainer.fit`` over a host feed of the same batches (batch
assembly included), the last step's loss per example, the kernels'
launches a step, and the card's name and power limit.  The last line
keeps ``bench.py``'s summary keys.

``--device cpu`` runs the plain path on the CPU and only with ``--tiny``
(a few narrow fields, batch 64): for tests, not for numbers.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

import numpy as np
import torch

from ..data import aliccp, alimama
from ..ops import _build, launch_counts, profiling
from ..utils import resolve_device

# an estimate of the reference PyTorch code on its published GTX 1080 Ti
# set-up (BASELINE.md), the anchor of bench.py's vs_baseline
REFERENCE_EXAMPLES_PER_SEC = 60_000.0

BATCH = 8192
SCAN = 10          # train_step calls a chunk (bench.py's lax.scan length)
CHUNKS = 4         # timed chunks

ALICCP_DATA_MAX = {k: aliccp.DATA_MAX[k] for k in aliccp.SPARSE_FEATURES}
ALIMAMA_DATA_MAX = {k: alimama.DATA_MAX[k]
                    for k in alimama.SPARSE_FEATURES}

# the kernels' sources, built in parallel before an arm's first chunk
SOURCES = ["meta_block_fwd", "meta_block_bwd", "bank_rows", "eqgemm"]


@dataclasses.dataclass(frozen=True)
class Config:
    """One published configuration at one scale."""
    data_max: dict
    domain_col: str
    num_domains: int
    lr: float
    use_pos: bool = False
    dense_cols: int = 0
    dim: int = 32
    layers: int = 3
    heads: int = 4
    units: tuple = (64, 32)
    batch: int = BATCH


ALICCP = Config(ALICCP_DATA_MAX, "301", 3, 0.005)
ALIMAMA_POS = Config(ALIMAMA_DATA_MAX, alimama.DOMAIN_COL,
                     alimama.NUM_DOMAINS, 0.001, use_pos=True, dense_cols=1)
# the same shapes cut for the CPU tests: two large fields (vocab past the
# side bank's 256), one small one and the scenario column; d = 8, 2 layers
_TINY = dict(dim=8, layers=2, heads=2, units=(16, 8), batch=64)
TINY_ALICCP = Config({"101": 400, "205": 500, "122": 13, "301": 3}, "301",
                     3, 0.005, **_TINY)
TINY_ALIMAMA_POS = Config({"user_id": 400, "adgroup_id": 500,
                           "shopping_level": 3}, alimama.DOMAIN_COL,
                          alimama.NUM_DOMAINS, 0.001, use_pos=True,
                          dense_cols=1, **_TINY)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def staged_arrays(cfg: Config, steps: int):
    """``bench.py``'s numpy batches (bench.py:77-85): ``(sparse [steps, B,
    F] int32, dense [steps, B, dense_cols] float32 or None, y, w [steps,
    B] float32)`` from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    b = cfg.batch
    sparse = np.stack([rng.integers(1, v + 1, size=(steps, b))
                       for v in cfg.data_max.values()],
                      axis=2).astype(np.int32)
    dense = (rng.normal(size=(steps, b, cfg.dense_cols)).astype(np.float32)
             if cfg.dense_cols else None)
    y = rng.integers(0, 2, (steps, b)).astype(np.float32)
    w = np.ones((steps, b), np.float32)
    return sparse, dense, y, w


def build(cfg: Config, bank_update: str, device):
    """The model and its compiled Trainer (bench.py:62-75)."""
    from ..features import DenseFeature, FeatureLayout, SparseFeature
    from ..models import SATrans
    from ..train import Trainer
    cols = [SparseFeature(name, vocab + 2, cfg.dim)
            for name, vocab in cfg.data_max.items()]
    cols += [DenseFeature(f"dense{i}", 1) for i in range(cfg.dense_cols)]
    model = SATrans(FeatureLayout(cols), [cfg.domain_col],
                    [cfg.num_domains], domain_att_layer_num=cfg.layers,
                    att_head_num=cfg.heads, meta_mode="QK",
                    meta_dnn_hidden_units=cfg.units, use_pos=cfg.use_pos,
                    device=device)
    trainer = Trainer(model, seed=1021, scan_unroll=1, device=device)
    trainer.compile(learning_rate=cfg.lr, bank_update=bank_update)
    return model, trainer


def run_arm(arm: str, cfg: Config, bank_update: str, *, tail=None,
            steps: int = SCAN, chunks: int = CHUNKS, device="cuda",
            card=None) -> dict:
    """Train one arm and print its JSON line; returns it as a dict."""
    dev = resolve_device(device)
    saved = os.environ.get("SATRANS_LAZY_TAIL")
    if tail is not None:
        os.environ["SATRANS_LAZY_TAIL"] = tail
    try:
        model, trainer = build(cfg, bank_update, dev)
        sparse, dense, y, w = staged_arrays(cfg, steps)
        staged = []
        for s in range(steps):
            batch = {"sparse": torch.from_numpy(sparse[s]).to(dev)}
            if dense is not None:
                batch["dense"] = torch.from_numpy(dense[s]).to(dev)
            staged.append((batch, torch.from_numpy(y[s]).to(dev),
                           torch.from_numpy(w[s]).to(dev)))
        last = {}

        def chunk():
            for b, yb, wb in staged:
                last["stats"] = trainer.train_step(b, yb, wb)

        sync = torch.cuda.synchronize if dev.type == "cuda" else \
            (lambda: None)
        sync()
        t0 = time.perf_counter()
        if dev.type == "cuda":
            _build.build(SOURCES)   # all at once; a no-op once built
        chunk()
        sync()
        build_s = time.perf_counter() - t0
        log(f"[{arm}] kernel build and first chunk ({steps} steps): "
            f"{build_s:.1f}s")
        before = launch_counts()
        sec = profiling.time_fn(chunk, iters=chunks, warmup=1, device=dev)
        sync()
        after = launch_counts()
        counted = (chunks + 1) * steps   # the warmup chunk and the timed
        per_step = {n: (after[n] - before[n]) / counted for n in after
                    if after[n] != before[n]}
        stats = {k: float(v) for k, v in last["stats"].items()}
        loss = stats["loss"] / max(stats["count"], 1.0)
        busy = profiling.device_busy_ms(trainer.train_step, *staged[0]) \
            if dev.type == "cuda" else None

        # fit over a host feed of the same batches: numpy columns, batch
        # assembly and the copies to the card included
        layout = trainer.layout
        x = {name: sparse[:, :, f].reshape(-1)
             for f, name in enumerate(layout.sparse_names)}
        if dense is not None:
            for i in range(cfg.dense_cols):
                x[f"dense{i}"] = dense[:, :, i].reshape(-1)
        sync()
        t0 = time.perf_counter()
        trainer.fit(x, y.reshape(-1), batch_size=cfg.batch, epochs=1,
                    verbose=0)
        sync()
        fit_s = time.perf_counter() - t0
    finally:
        if tail is not None:
            if saved is None:
                os.environ.pop("SATRANS_LAZY_TAIL", None)
            else:
                os.environ["SATRANS_LAZY_TAIL"] = saved
    rec = {"arm": arm, "bank_update": bank_update,
           "lazy_tail": (tail or "split") if bank_update == "lazy" else None,
           "examples_per_s": cfg.batch * steps / sec,
           "ms_per_step": 1e3 * sec / steps, "build_s": build_s,
           "device_busy_ms": busy,
           "fit_examples_per_s": cfg.batch * steps / fit_s,
           "loss": loss, "launches_per_step": per_step,
           "batch": cfg.batch, "steps": steps, "chunks": chunks,
           "device": str(dev), "card": card}
    log(f"[{arm}] {chunks * steps} steps: {rec['examples_per_s']:,.0f} "
        f"examples/s ({rec['ms_per_step']:.3f} ms/step); fit "
        f"{rec['fit_examples_per_s']:,.0f} examples/s")
    print(json.dumps(rec), flush=True)
    del model, trainer, staged
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def run_mode(bank_update: str, tail=None, *, tiny=False, **kw) -> dict:
    """AliCCP sota config (reference readme.md:17-19); ``tail`` the lazy
    update's ``SATRANS_LAZY_TAIL`` (None: the split tail)."""
    arm = f"{bank_update}_{tail}tail" if tail else bank_update
    return run_arm(arm, TINY_ALICCP if tiny else ALICCP, bank_update,
                   tail=tail, **kw)


def run_alimama_pos(bank_update: str, *, tiny=False, **kw) -> dict:
    """Alimama sota-pos config (reference readme.md:21-23): 15 sparse
    fields and one dense column, ``shopping_level``, ``use_pos``."""
    return run_arm(f"alimama_pos_{bank_update}",
                   TINY_ALIMAMA_POS if tiny else ALIMAMA_POS, bank_update,
                   **kw)


def _rate(rec):
    """``{"value", "vs_baseline"}`` of an arm; the baseline compares card
    numbers only (null on the CPU)."""
    if rec is None:
        return None
    v = rec["examples_per_s"]
    on_card = rec["device"].startswith("cuda")
    return {"value": round(v, 1), "vs_baseline": round(
        v / REFERENCE_EXAMPLES_PER_SEC, 3) if on_card else None}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--modes", default="dense,lazy",
                    help="AliCCP bank updates, comma-separated; lazy runs "
                         "the split tail (K4, Adam, K2) and the fused one "
                         "(K5)")
    ap.add_argument("--alimama", action=argparse.BooleanOptionalAction,
                    default=True, help="the Alimama sota-pos lazy arm")
    ap.add_argument("--chunks", type=int, default=CHUNKS)
    ap.add_argument("--steps", type=int, default=SCAN,
                    help="train_step calls (staged batches) a chunk")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="a few narrow fields at batch 64 (the CPU tests)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cpu" and not args.tiny:
        ap.error("--device cpu runs only with --tiny: the CPU gives no "
                 "number of the card")
    return args


def main(argv=None) -> list[dict]:
    """Run the arms; returns their records and the summary, printed as
    JSON lines as they end."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    card = profiling.card_name(dev)
    if card:
        log(card)
    kw = dict(tiny=args.tiny, steps=args.steps, chunks=args.chunks,
              device=dev, card=card)
    recs = {}
    for mode in filter(None, args.modes.split(",")):
        for tail in (None, "fused") if mode == "lazy" else (None,):
            rec = run_mode(mode, tail, **kw)
            recs[rec["arm"]] = rec
    if args.alimama:
        rec = run_alimama_pos("lazy", **kw)
        recs[rec["arm"]] = rec
    lazy = recs.get("lazy")
    summary = {
        "metric": "satrans_train_throughput",
        "value": round(lazy["examples_per_s"], 1) if lazy else None,
        "unit": "examples/s/chip",
        "vs_baseline": _rate(lazy)["vs_baseline"] if lazy else None,
        "mode": "bank_update=lazy (documented deviation, PARITY.md)",
        "exact_parity_mode": _rate(recs.get("dense")),
        "alimama_sota_pos": _rate(recs.get("alimama_pos_lazy")),
        "lazy_fusedtail": _rate(recs.get("lazy_fusedtail")),
        "device": str(dev), "card": card,
    }
    if not all(math.isfinite(r["loss"]) for r in recs.values()):
        raise RuntimeError("a loss that is not finite: "
                           + json.dumps({a: r["loss"]
                                         for a, r in recs.items()}))
    print(json.dumps(summary), flush=True)
    return [*recs.values(), summary]


if __name__ == "__main__":
    main()
