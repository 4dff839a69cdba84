"""Serving throughput of the AOT Predictor on one card (twin of
``satrans_tpu/bench/serving_throughput.py``).

    python3 -m satrans_torch.bench.serving_throughput [--root DIR]
        [--batches 8] [--reps 16] [--passes 3]

The model is the JAX twin's: SATrans at the AliCCP sota width (19 fields
with the real vocab sizes, d = 32, 3 layers, 4 heads, QK, MetaNet 32 ->
64 -> 32, seed 1021, the default N(0, 1e-4) embeddings), served by
``serving.Predictor`` at the reference's eval batch of 32,768
(main.py:353) on ids uniform in ``[1, DATA_MAX]`` from ``default_rng(0)``.

* ``device_path_ms``: the captured score of one staged batch
  (``Predictor.aot_compile``'s CUDA graph) replayed ``--reps`` times,
  timed by CUDA events (``ops/profiling.time_fn``): the serving compute
  ceiling, the twin of the JAX in-jit loop.
* ``e2e_examples_per_sec``: ``Predictor.__call__`` on a request of
  ``--batches`` batches at pipeline depths 1, 2 and 4 (host padding, the
  pinned staging, the copies and the copy back), each depth's scores
  equal to depth 1's bit for bit; the host clock around the call, the
  median of ``--passes`` calls after one warm call.

The same numbers of the eager Predictor (no ``aot_compile``) stand beside
them under ``eager``, its scores equal to the graph's bit for bit, with
the host's ms to queue one eager forward (``forward_queue_ms``) and the
embedding lookup's device ms (``embed_ms``).  The
JSON line also gives the card's name and power limit, the capture's
seconds and the graph's launches by kernel (replays times the captured
launches).

``--root DIR`` times the ``satrans_torch`` of another checkout (for
parent against change on one card, run in turns: parent, change, change,
parent); a tree without ``aot_compile`` or ``pipeline_depth`` gives null
where it lacks them.  ``--device cpu --tiny`` runs a small model on the
CPU with the host clock: for tests, not for numbers.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import sys
import time

import numpy as np

SEED = 1021
EVAL_BATCH = 32768     # reference main.py:353: predict batch = 4x train
REPS = 16
BATCHES = 8
# the tiny CPU model's fields: two large, one small, the scenario column
TINY = dict(data_max={"101": 400, "205": 500, "122": 13, "301": 3},
            dim=8, layers=2, heads=2, units=(16, 8), batch=64)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None,
                    help="the checkout whose satrans_torch is timed")
    ap.add_argument("--batches", type=int, default=BATCHES)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    if args.device == "cpu" and not args.tiny:
        ap.error("--device cpu runs only with --tiny")
    return args


def build(device, tiny: bool):
    """(model, layout, data_max, batch) of the twin's configuration, or of
    the tiny one."""
    from satrans_torch.data import aliccp
    from satrans_torch.features import FeatureLayout, SparseFeature
    from satrans_torch.models import SATrans
    if tiny:
        dm, d = TINY["data_max"], TINY["dim"]
        layout = FeatureLayout([SparseFeature(n, v + 2, d)
                                for n, v in dm.items()])
        model = SATrans(layout, ["301"], [3],
                        domain_att_layer_num=TINY["layers"],
                        att_head_num=TINY["heads"], meta_mode="QK",
                        meta_dnn_hidden_units=TINY["units"], seed=SEED,
                        device=device)
        return model, layout, dm, TINY["batch"]
    dm = {k: aliccp.DATA_MAX[k] for k in aliccp.SPARSE_FEATURES}
    layout = FeatureLayout(aliccp.sota_columns(32))
    model = SATrans(layout, ["301"], [3], domain_att_layer_num=3,
                    att_head_num=4, meta_mode="QK",
                    meta_dnn_hidden_units=(64, 32), seed=SEED, device=device)
    return model, layout, dm, EVAL_BATCH


def request(data_max: dict, rows: int) -> dict:
    rng = np.random.default_rng(0)
    return {name: rng.integers(1, v + 1, rows).astype(np.int32)
            for name, v in data_max.items()}


def e2e(pred, big: dict, depths, passes: int, takes_depth: bool):
    """Examples/s of ``pred(big)`` at each depth (the median of
    ``passes`` host-clock calls after a warm one) and each depth's
    scores."""
    rows = len(next(iter(big.values())))
    rates, scores = {}, {}
    for depth in depths:
        if depth > 1 and not takes_depth:
            rates[f"depth{depth}"] = None
            continue
        kw = {"pipeline_depth": depth} if takes_depth else {}
        scores[depth] = pred(big, **kw)
        ms = []
        for _ in range(passes):
            t0 = time.perf_counter()
            pred(big, **kw)
            ms.append(time.perf_counter() - t0)
        rates[f"depth{depth}"] = rows / statistics.median(ms)
    return rates, scores


def queue_ms(fn, dev, iters: int) -> float:
    """Host ms to queue one call of ``fn`` without waiting for the card
    (close to the call's device ms: the host sets the pace)."""
    import torch
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    wall = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return 1e3 * wall / iters


def run(args) -> dict:
    import torch

    from satrans_torch import embeddings, serving
    from satrans_torch.ops import profiling
    from satrans_torch.utils import resolve_device

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
    card = profiling.card_name(dev)
    if card:
        log(card)
    model, layout, dm, bs = build(dev, args.tiny)
    feats = request(dm, bs)
    big = {k: np.tile(v, args.batches) for k, v in feats.items()}
    takes_depth = "pipeline_depth" in inspect.signature(
        serving.Predictor.__call__).parameters
    can_capture = hasattr(serving.Predictor, "aot_compile")
    depths = (1, 2, 4)

    def device_ms(fn):
        return 1e3 * profiling.time_fn(fn, iters=args.reps, device=dev)

    arms = {}
    for arm in ("graph", "eager"):
        if arm == "graph" and not can_capture:
            arms[arm] = None
            continue
        pred = serving.Predictor(model, batch_size=bs, device=dev)
        t0 = time.perf_counter()
        if arm == "graph":
            pred.aot_compile()
        else:
            pred.warmup()
        ready_s = time.perf_counter() - t0
        extra = {}
        with torch.inference_mode():
            batch = {k: torch.from_numpy(v).to(dev) for k, v in
                     layout.batch_from_dict(feats).items()}
            graph = getattr(pred, "graph", None)
            if graph is not None:
                for k, t in batch.items():
                    graph.inputs[k].copy_(t)
                ms = device_ms(graph.replay)
            else:
                ms = device_ms(lambda: pred._score(batch))
                # the eager forward's host time to queue it, and the
                # embedding lookup's device time alone
                extra = dict(
                    forward_queue_ms=queue_ms(lambda: pred._score(batch),
                                              dev, args.reps),
                    embed_ms=device_ms(lambda: embeddings.embed_fields(
                        model.emb, layout, batch)))
        rates, scores = e2e(pred, big, depths, args.passes, takes_depth)
        for depth, s in scores.items():
            if not np.array_equal(s, scores[1]):
                raise AssertionError(f"{arm}: depth {depth}'s scores differ "
                                     "from depth 1's")
        arms[arm] = dict(
            device_path_ms=ms, device_examples_per_sec=bs / (ms / 1e3),
            e2e_examples_per_sec=rates["depth1"],
            e2e_overlapped_examples_per_sec=rates, ready_s=ready_s,
            launches=pred.launches() if graph is not None else None,
            scores=scores[1], **extra)
        log(f"[{arm}] device path {ms:.4f} ms/batch; e2e {rates}")
        del pred
    if arms["graph"] is not None and not np.array_equal(
            arms["graph"]["scores"], arms["eager"]["scores"]):
        raise AssertionError("the graph's scores differ from the eager "
                             "Predictor's")
    main_arm = arms["graph"] or arms["eager"]
    eager = {k: v for k, v in arms["eager"].items()
             if k not in ("scores", "launches", "ready_s")}
    return {
        "workload": f"satrans_aliccp_sota_serve_b{bs}",
        "device_path_ms": main_arm["device_path_ms"],
        "device_examples_per_sec": main_arm["device_examples_per_sec"],
        "e2e_examples_per_sec": main_arm["e2e_examples_per_sec"],
        "e2e_overlapped_examples_per_sec":
            main_arm["e2e_overlapped_examples_per_sec"],
        "aot_compile_s": arms["graph"]["ready_s"] if arms["graph"] else None,
        "launches": arms["graph"]["launches"] if arms["graph"] else None,
        "eager": eager,
        "batches": args.batches,
        "root": os.path.dirname(os.path.dirname(os.path.abspath(
            serving.__file__))),
        "card": card, "device": dev.type}


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.root is not None:
        root = os.path.abspath(args.root)
        loaded = sys.modules.get("satrans_torch")
        if loaded is not None and not os.path.abspath(
                loaded.__file__).startswith(root + os.sep):
            # run this file as a script, so that the other tree's package
            # is the one imported
            os.execv(sys.executable, [sys.executable,
                                      os.path.abspath(__file__),
                                      *(sys.argv[1:] if argv is None
                                        else argv)])
        sys.path.insert(0, root)
    if args.device != "cpu":
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("serving_throughput: no CUDA device")
    out = run(args)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
