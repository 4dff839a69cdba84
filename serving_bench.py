"""Time the port's serving path on one NVIDIA GPU.

    python3 serving_bench.py [--root DIR] [--passes N]

Serves the AliCCP sota SATrans of chip_smoke.py's phase 3 (19 fields with
the real vocab sizes, d=32, 3 layers, embeddings N(0, 1), seed 1021)
through ``satrans_torch.serving.Predictor`` at batch 8192: ``--passes``
passes over 3 requests of 20,000 examples each, after one warmup pass.
``--root`` picks the checkout whose ``satrans_torch`` is imported (default:
this script's), so two versions can be timed in one run on one card.

Prints the card's name and power limit and one JSON line: the request's
host-clock ms (median and least over the passes; the request waits for
its scores), examples/s at the median, and for one staged batch the
model's forward and ``embed_fields`` alone, each as CUDA-event ms and as
the host's queue ms (host clock, not waiting for the card).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 1021
BATCH = 8192
REQUESTS, REQUEST_ROWS = 3, 20_000


def event_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queue_ms(fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * wall / iters


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--passes", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serving_bench: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from satrans_torch import embeddings
    from satrans_torch.data import aliccp
    from satrans_torch.features import FeatureLayout
    from satrans_torch.models import SATrans
    from satrans_torch.serving import Predictor

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    layout = FeatureLayout(aliccp.sota_columns(32))
    model = SATrans(layout, ["301"], [3], domain_att_layer_num=3,
                    att_head_num=4, meta_mode="QK",
                    meta_dnn_hidden_units=(64, 32), no_emb_init=True,
                    seed=SEED, device=dev)
    pred = Predictor(model, batch_size=BATCH, device=dev).warmup()
    rng = np.random.default_rng(SEED)
    reqs = [{name: rng.integers(1, aliccp.DATA_MAX[name] + 1, REQUEST_ROWS)
             for name in aliccp.SPARSE_FEATURES} for _ in range(REQUESTS)]
    for x in reqs:  # warmup pass
        pred(x)
    request_ms = []
    for _ in range(args.passes):
        for x in reqs:
            t0 = time.perf_counter()
            pred(x)
            request_ms.append(1e3 * (time.perf_counter() - t0))
    med = statistics.median(request_ms)

    batch = pred._stage(layout.batch_from_dict(reqs[0]), 0, BATCH)
    with torch.inference_mode():
        fwd = lambda: model(batch)                           # noqa: E731
        emb = lambda: embeddings.embed_fields(               # noqa: E731
            model.emb, layout, batch)
        out = dict(
            root=os.path.relpath(root), card=card,
            request_ms_median=med, request_ms_min=min(request_ms),
            examples_per_s=REQUEST_ROWS / (med / 1e3),
            forward_event_ms=event_ms(fwd), forward_queue_ms=queue_ms(fwd),
            embed_event_ms=event_ms(emb), embed_queue_ms=queue_ms(emb))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
