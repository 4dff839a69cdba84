"""Probe-mode (``return_scores``) prediction throughput on one card: the
fused K1-scores route against the plain layer (twin of
``satrans_tpu/bench/probe_throughput.py``).

    python3 -m satrans_torch.bench.probe_throughput [out.json]

The showattn and instattn probes need each layer's attention
probabilities.  On the card the metanet model's probe forward takes
K1-scores (``ops/meta_block.fused_meta_layer_with_scores``, the logits
clamped); ``SATRANS_PROBE_FUSED=0`` sends it to the plain layer without
the clamp (the JAX package's XLA route).  Each arm runs the probe at the
AliCCP sota shapes (19 fields, d = 32, 3 layers, 4 heads, QK, MetaNet 32
-> 64 -> 32) on a batch of 32,768 (the reference's eval batch), ids
uniform in ``[1, DATA_MAX]`` from ``default_rng(0)``: the forward with
the scores and a per-(layer, head) mean of the maps (the probes reduce
them on the device), captured as one CUDA graph (the twin of the JAX
``jax.jit``; ``compile_s`` is the warmup and the capture) and replayed
``REPS`` times, timed by CUDA events.  Each arm reports ms a batch,
examples/s, its kernels' launches (replays times the captured ones) and
whether the graph's last replay returned the eager forward's predictions
and means bit for bit (``graph_equals_eager``); the fused arm also how
far its predictions and means lie from the plain arm's
(``pred_max_abs_diff``, ``stats_max_abs_diff``).

``--device cpu --tiny`` runs a small model on the CPU, eagerly and with
the host clock: for tests, not for numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

BATCH = 32_768   # the reference's eval batch (main.py:81)
REPS = 20


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _host(out) -> tuple:
    """The probe's (predictions, per-(layer, head) means) on the host."""
    import torch
    pred, means = out
    return (pred.double().cpu().numpy(),
            torch.stack(list(means)).double().cpu().numpy())


def run_mode(fused: bool, device, tiny: bool, reps: int = REPS):
    """(the arm's numbers, its outputs on the host)."""
    import torch

    from satrans_torch.ops import profiling
    from satrans_torch.serving import Captured

    from .serving_throughput import build, request

    # the card's probes take K1-scores unless SATRANS_PROBE_FUSED=0: each
    # arm sets it for its own forward
    before = os.environ.get("SATRANS_PROBE_FUSED")
    os.environ["SATRANS_PROBE_FUSED"] = "1" if fused else "0"
    try:
        model, layout, dm, bs = build(device, tiny)
        if not tiny:
            bs = BATCH
        batch = {k: torch.from_numpy(v).to(device) for k, v in
                 layout.batch_from_dict(request(dm, bs)).items()}

        def probe(b):
            pred, scores = model(b, return_scores=True)
            return pred, [s.mean(dim=0) for s in scores]

        with torch.inference_mode():
            t0 = time.perf_counter()
            if device.type == "cuda":
                graph = Captured(probe, batch, f"the probe forward "
                                 f"({'fused' if fused else 'plain'})")
                torch.cuda.synchronize()
                call = graph.replay
            else:
                graph, call = None, lambda: probe(batch)
                call()
            compile_s = time.perf_counter() - t0
            sec = profiling.time_fn(call, iters=reps, device=device)
            got = _host(call())
            same = None if graph is None else all(
                np.array_equal(a, b)
                for a, b in zip(got, _host(probe(batch))))
    finally:
        if before is None:
            os.environ.pop("SATRANS_PROBE_FUSED", None)
        else:
            os.environ["SATRANS_PROBE_FUSED"] = before
    name = "fused" if fused else "plain"
    log(f"[{name}] {sec * 1e3:.4f} ms/batch -> {bs / sec:,.0f} examples/s "
        f"(compile {compile_s:.2f}s)")
    return {"examples_per_s": bs / sec, "ms_per_batch": sec * 1e3,
            "compile_s": compile_s,
            "launches": graph.launches() if graph is not None else None,
            "graph_equals_eager": same}, got


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", nargs="?", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args(argv)
    if args.device == "cpu" and not args.tiny:
        ap.error("--device cpu runs only with --tiny")
    import torch

    from satrans_torch.ops import profiling
    from satrans_torch.utils import resolve_device
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    card = profiling.card_name(dev)
    fused, (f_pred, f_means) = run_mode(True, dev, args.tiny, args.reps)
    plain, (p_pred, p_means) = run_mode(False, dev, args.tiny, args.reps)
    fused["pred_max_abs_diff"] = float(np.abs(f_pred - p_pred).max())
    fused["stats_max_abs_diff"] = float(np.abs(f_means - p_means).max())
    doc = {"workload": f"satrans_probe_return_scores_b"
                       f"{BATCH if not args.tiny else 'tiny'}",
           "unit": "examples/s/chip",
           "results": {"fused_scores": fused, "xla_scores": plain},
           "card": card, "device": dev.type}
    line = json.dumps(doc)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return doc


if __name__ == "__main__":
    main()
