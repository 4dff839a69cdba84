"""The serving forward's four hot paths against their speed of light (twin
of ``satrans_tpu/bench/kernels.py``).

    python3 -m satrans_torch.bench.kernels

At B = 8192, F = 19, d = 32, 4 heads (the AliCCP sota forward), each
path's time on the card: ``REPS`` calls captured as one CUDA graph (the
twin's loop inside one jit: the host's pace is out of the number),
replayed and timed by CUDA events (``ops/profiling.time_fn``), and its
roofline (``ops/profiling.roofline``, the H100 SXM peaks: float32 outside
the tensor cores and HBM3; K1-fwd's at the rate of its own arithmetic,
:func:`fused_peak_flops`):

* ``embedding_gather``: ``embeddings.lookup_rows`` of B x F ids from a
  bank of 6,571,968 rows of d floats, a new draw of ids for each of the
  ``REPS`` calls (one draw's rows, 20 MB, would stay in the 50 MB L2);
* ``meta_param_generation``: the scenario encoder (one linear d -> P, P
  the flat MetaNet size) over 4 table rows;
* ``interaction_attention_xla``: one meta-transformer layer forward on
  the plain layer (``nn.attention.meta_transformer_apply``, the JAX XLA
  route's twin), and ``interaction_attention_fused`` on the card only:
  K1-fwd (``ops/meta_block.fused_meta_layer``), with its launches
  (the graph's replays times its captured launches) and its graph's
  output against the plain layer's on the same input (``max_abs_err``,
  ``within_tol`` at ``FUSED_TOL``);
* ``scoring``: the head's GEMV over the flattened fields and the sigmoid.

The work counts (:func:`work_counts`) are the model's, whatever the
layout: the JAX twin's for the MetaNet generation (kernels.py:104) and
the layer (:113), and for the gather B * F * d * 4 bytes, since the
port's bank rows are d floats wide where the JAX twin counts a physical
row of 128 lanes a lookup (kernels.py:86), four times as many bytes at
d = 32.  The JSON line also gives the card's name and power limit.
``--device cpu --tiny`` runs small shapes on the CPU with the host clock:
for tests, not for numbers.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

REPS = 16
SHAPES = dict(batch=8192, fields=19, dim=32, vocab_rows=6_571_968,
              heads=4)
TINY = dict(batch=64, fields=5, dim=8, vocab_rows=1000, heads=2)
FUSED_TOL = dict(atol=1e-4, rtol=1e-4)  # K1-fwd against the plain layer


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def work_counts(batch: int, fields: int, dim: int, heads: int) -> dict:
    """The FLOP and bytes of each hot path at these shapes (the heads do
    not change them)."""
    d, P = dim, 2 * dim * dim + 2 * dim * dim  # MetaNet [d, 2d, d]
    return {
        "embedding_gather": {"flops": 0,
                             "bytes": batch * fields * d * 4},
        "meta_param_generation": {"flops": 2 * 4 * d * P, "bytes": 0},
        "interaction_attention": {
            "flops": 2 * batch * fields * (
                3 * d * d + 2 * (d * 2 * d + 2 * d * d) + 2 * fields * d
                + d * d),
            "bytes": 0},
        "scoring": {"flops": 2 * batch * fields * d,
                    "bytes": batch * fields * d * 4},
    }


def fused_peak_flops(batch: int, fields: int, dim: int) -> float:
    """The rate at which K1-fwd can do the layer's work at best: its
    products but q k^T and p v in 3xTF32 on the tensor cores, those two in
    float32 on the CUDA cores, the two pipes side by side (the bound of
    the port's kernel table)."""
    from satrans_torch.ops import profiling
    flops = work_counts(batch, fields, dim, 0)[
        "interaction_attention"]["flops"]
    cores = 2 * batch * fields * 2 * fields * dim  # q k^T and p v
    return flops / max(cores / profiling.H100_PEAK_F32_FLOPS,
                       (flops - cores) / profiling.H100_PEAK_TF32X3_FLOPS)


def run(batch, fields, dim, vocab_rows, heads, device="cuda",
        reps: int = REPS) -> dict:
    import torch

    from satrans_torch import embeddings
    from satrans_torch.features import FeatureLayout, SparseFeature
    from satrans_torch.nn import attention, core, metanet
    from satrans_torch.ops import meta_block, profiling
    from satrans_torch.serving import Captured
    from satrans_torch.utils import make_generator, resolve_device

    dev = resolve_device(device)
    work = work_counts(batch, fields, dim, heads)
    rng = np.random.default_rng(0)
    gen = make_generator(0, dev)
    results = {}

    def timed(name, fn, key=None, **peak):
        """Time ``fn(i)`` for i < ``reps``: on the card the ``reps`` calls
        captured as one CUDA graph (the twin's loop inside one jit) and
        the graph replayed, by CUDA events; on the CPU the host clock.
        Returns the graph (None on the CPU), whose output is the last
        call's."""
        def loop(_=None):
            for i in range(reps):
                out = fn(i)
            return out
        graph = None
        if dev.type == "cuda":
            graph = Captured(loop, {"i": torch.zeros(1, device=dev)}, name)
            sec = profiling.time_fn(graph.replay, iters=3,
                                    device=dev) / reps
        else:
            sec = profiling.time_fn(loop, iters=1, device=dev) / reps
        w = work[key or name]
        results[name] = dict(profiling.roofline(
            sec, flops=w["flops"], bytes_moved=w["bytes"], **peak), **w)
        log(f"[{name}] {sec * 1e3:.4f} ms/iter")
        return graph

    with torch.inference_mode():
        # --- embedding gather: a new draw of ids a call
        layout = FeatureLayout([SparseFeature("f", vocab_rows - 2, dim)])
        bank = embeddings.bank_init(gen, layout)
        draws = [torch.from_numpy(rng.integers(
            0, vocab_rows - 4, size=(batch, fields))).to(dev)
            for _ in range(reps)]
        timed("embedding_gather",
              lambda i: embeddings.lookup_rows(bank, draws[i]))
        del bank, draws

        # --- meta-parameter generation (the scenario encoder)
        d = dim
        units = [d, 2 * d, d]
        P = metanet.param_size(units)
        enc = core.MLP(gen, d, [P], init_std=1e-4, final_activation=False)
        table = torch.from_numpy(rng.normal(size=(4, d)).astype(
            np.float32)).to(dev)
        timed("meta_param_generation", lambda i: enc(table))

        # --- interaction attention: one layer forward
        layer = attention.meta_transformer_init(gen, d, units).to(dev)
        tq = torch.from_numpy(rng.normal(size=(4, P)).astype(
            np.float32)).to(dev)
        tables = {"Q": tq, "K": tq, "V": tq}
        x = torch.from_numpy(rng.normal(size=(batch, fields, d)).astype(
            np.float32)).to(dev)
        dom = torch.from_numpy(rng.integers(0, 4, size=batch)).to(dev)
        def plain(i=None):
            return attention.meta_transformer_apply(
                layer, x, tables, units, mode="QK", head_num=heads,
                domain_ids=dom, dense_select=True)
        timed("interaction_attention_xla", plain, "interaction_attention")
        if dev.type == "cuda":
            graph = timed(
                "interaction_attention_fused", lambda i: meta_block.
                fused_meta_layer(x, layer, tables, dom, meta_units=units,
                                 head_num=heads), "interaction_attention",
                peak_flops=fused_peak_flops(batch, fields, dim))
            want = plain()
            results["interaction_attention_fused"].update(
                launches=graph.launches().get("meta_block_fwd", 0),
                max_abs_err=float((graph.output - want).abs().max()),
                within_tol=bool(torch.allclose(graph.output, want,
                                               **FUSED_TOL)))

        # --- scoring: the head's GEMV and the sigmoid
        head = core.Linear(gen, fields * d, 1)
        flat = x.reshape(batch, -1)
        timed("scoring", lambda i: torch.sigmoid(head(flat)))
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
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
    out = run(**(TINY if args.tiny else SHAPES), device=dev, reps=args.reps)
    for name, r in out.items():
        log(f"{name}: {r['seconds'] * 1e3:.4f} ms (speed-of-light "
            f"{r['speed_of_light_s'] * 1e3:.4f} ms, bound={r['bound']})")
    doc = dict(out, card=profiling.card_name(dev), device=dev.type)
    print(json.dumps(doc), flush=True)
    return doc


if __name__ == "__main__":
    main()
