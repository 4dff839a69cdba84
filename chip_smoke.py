"""Drive the PyTorch port (satrans_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build every CUDA kernel from satrans_torch/csrc (one nvcc per source,
   all at once);
2. hold each kernel against its plain PyTorch version on the card at the
   AliCCP sota widths (B=8192 and a ragged 8190, F=19, d=32, 4 heads, 4
   meta rows, MetaNet 32->64->32), in meta modes QK and Query with
   relu_out off and on, and time both with CUDA events;
3. serve 3 requests of 20,000 examples through satrans_torch.serving's
   Predictor at batch 8192 with SATrans at the AliCCP sota width (19
   fields with the real vocab sizes, an ~841 MB embedding bank on the
   card), count the kernel's launches, and compare the scores with the
   same model on its plain path;
4. hold the backward kernel (K1-bwd) against autograd of the plain layer
   at the same widths, batches and modes, every gradient, and time both
   in every case;
5. train the same model with satrans_torch.train's Trainer (Adam, lr
   0.005, dense bank update, dropout 0) for 24 steps at batch 8192 on
   bench.py-style synthetic ids and labels (the last batch a padded
   tail): one step's gradients on the kernel path against the plain
   path, exactly 3 forward and 3 backward launches per step, a finite
   loss at every step, trained examples/s, a torch.profiler breakdown of
   one step, and predict/evaluate on 20,000 examples.

It prints the card's name and power limit, one JSON line naming each
kernel with its launches, error and times, and as its last line
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 2 and
prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 1021
BATCH = 8192
REQUESTS, REQUEST_ROWS = 3, 20_000
LAYERS = 3
# H100 SXM data-sheet peaks at 700 W: float32 outside the tensor cores,
# and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
KERNEL_TOL = dict(atol=1e-4, rtol=1e-4)
SERVING_TOL = 1e-5
# a gradient of K1-bwd (and of the training step) may differ from the
# plain one by GRAD_RTOL times the largest entry of that gradient plus
# GRAD_ATOL: the parameter gradients are float32 sums over B * F = 155,648
# rows (and 8192 examples) taken in another order
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
TRAIN_STEPS, TRAIN_LR = 24, 0.005
TRAIN_ROWS = (TRAIN_STEPS - 1) * BATCH + 5000  # the last batch is a tail


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def time_ms(fn, iters: int, warmup: int = 3) -> float:
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


def meta_layer_bound_ms(B, F, d, h, heads, meta_rows, apply_q, apply_k):
    """Least time for one layer: the larger of its float32 FMA work over
    the card's float32 peak and its bytes (x in, y out, dom and the
    weights read once) over the HBM rate.  Returns (ms, bound_by)."""
    per_example = (2 * F * d * 3 * d                       # x @ Wqkv
                   + (apply_q + apply_k) * 2 * F * 2 * d * h  # MetaNets
                   + 2 * 2 * F * F * d                     # q k^T and p v
                   + 2 * F * d * d)                        # o @ Wout
    flops = B * per_example
    weights = 4 * d * d + meta_rows * 2 * d * h + 6 * d
    nbytes = 4 * (2 * B * F * d + B + weights)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


def meta_layer_bwd_bound_ms(B, F, d, h, heads, meta_rows, apply_q, apply_k):
    """Least time for the layer's backward with its forward recomputed:
    the forward's operations, then dWout and do (2 x 2Fd^2), the attention
    backward (dv, dP, dq, dk: 4 x 2F^2 d), per applied MetaNet dW2, dhid,
    dW1 and dt0 (4 x 2Fdh), and dWqkv and dx (2 x 6Fd^2); bytes are x, g
    and dom in, dx out, the weights in and their gradients out."""
    fwd_ms, _ = meta_layer_bound_ms(B, F, d, h, heads, meta_rows, apply_q,
                                    apply_k)
    per_example = (4 * F * d * d + 8 * F * F * d
                   + (apply_q + apply_k) * 8 * F * d * h + 12 * F * d * d)
    t_ops = fwd_ms / 1e3 + B * per_example / PEAK_F32_FLOPS
    weights = 4 * d * d + meta_rows * 2 * d * h + 6 * d
    t_bytes = 4 * (3 * B * F * d + B + 2 * weights) / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


def grad_errors(got: dict, want: dict) -> dict:
    """max |got - want| per gradient; raises past the stated tolerance."""
    check(set(got) == set(want), f"gradients {sorted(got)} != {sorted(want)}")
    errs = {}
    for name, w in want.items():
        g = got[name]
        err = (g - w).abs().max().item()
        errs[name] = err
        check(bool(torch.isfinite(g).all()), f"gradient {name} not finite")
        check(err <= GRAD_RTOL * w.abs().max().item() + GRAD_ATOL,
              f"gradient {name} differs from the plain one by {err} "
              f"(largest entry {w.abs().max().item()})")
    return errs


def kernel_phase(dev):
    """Kernel vs plain at full width.  Returns the JSON fields measured."""
    from satrans_torch.nn import attention, initializers as init, metanet
    from satrans_torch.ops import meta_block
    from satrans_torch.utils import make_generator

    F, d, h, heads, rows = 19, 32, 64, 4, 4
    units = [d, h, d]
    gen = make_generator(SEED, dev)
    layer = attention.MetaTransformerLayer(gen, d)
    table = init.normal(gen, (rows, metanet.param_size(units)), 0.1)
    tables = {"Q": table, "K": table}
    worst, main = 0.0, None
    for B in (BATCH, BATCH - 2):
        x = init.normal(gen, (B, F, d), 1.0)
        dom = torch.randint(0, rows, (B,), generator=gen, device=dev)
        for mode in ("QK", "Query"):
            for relu_out in (False, True):
                kw = dict(meta_units=units, head_num=heads, mode=mode,
                          relu_out=relu_out)
                with torch.no_grad():
                    y = meta_block.fused_meta_layer(x, layer, tables, dom,
                                                    **kw)
                    ref = meta_block.meta_layer_reference(x, layer, tables,
                                                          dom, **kw)
                torch.cuda.synchronize()
                err = (y - ref).abs().max().item()
                worst = max(worst, err)
                ok = bool(torch.isfinite(y).all()) and torch.allclose(
                    y, ref, **KERNEL_TOL)
                line = (f"kernel meta_block_fwd B={B} mode={mode} "
                        f"relu_out={relu_out}: max_abs_err={err:.3e}")
                if B == BATCH:
                    with torch.no_grad():
                        k_ms = time_ms(lambda: meta_block.fused_meta_layer(
                            x, layer, tables, dom, **kw), iters=50)
                        p_ms = time_ms(lambda: meta_block.meta_layer_reference(
                            x, layer, tables, dom, **kw), iters=10)
                    b_ms, b_by = meta_layer_bound_ms(
                        B, F, d, h, heads, rows, "Q" in mode, "K" in mode)
                    line += (f" kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                             f"bound_ms={b_ms:.4f} ({b_by})")
                    if mode == "QK" and not relu_out:  # the serving config
                        main = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                    bound_by=b_by)
                print(line, flush=True)
                check(ok, f"kernel disagrees with its plain version "
                          f"(B={B} mode={mode} relu_out={relu_out}, "
                          f"max_abs_err={err}, tolerance {KERNEL_TOL})")
    return dict(max_abs_err=worst, **main)


def layer_grads(fn, x, layer, table, dom, g, **kw):
    """Gradients of sum(fn(...) * g) by name: x, the table, the layer's
    parameters."""
    x = x.detach().requires_grad_(True)
    table = table.detach().requires_grad_(True)
    params = dict(layer.named_parameters())
    y = fn(x, layer, {"Q": table, "K": table}, dom, **kw)
    got = torch.autograd.grad((y * g).sum(), [x, table, *params.values()],
                              allow_unused=True)
    return {n: gr for n, gr in zip(["x", "table", *params], got)
            if gr is not None}


def backward_phase(dev):
    """K1-bwd against autograd of the plain layer at full width.  Returns
    the JSON fields measured."""
    from satrans_torch.nn import attention, initializers as init, metanet
    from satrans_torch.ops import meta_block
    from satrans_torch.utils import make_generator

    F, d, h, heads, rows = 19, 32, 64, 4, 4
    units = [d, h, d]
    gen = make_generator(SEED + 1, dev)
    layer = attention.MetaTransformerLayer(gen, d)
    with torch.no_grad():  # move the meta LayerNorm off its (1, 0) init
        layer.q_meta.ln.scale.add_(init.normal(gen, (d,), 0.1))
        layer.q_meta.ln.bias.add_(init.normal(gen, (d,), 0.1))
    table = init.normal(gen, (rows, metanet.param_size(units)), 0.1)
    worst, main = 0.0, None
    for B in (BATCH, BATCH - 2):
        x = init.normal(gen, (B, F, d), 1.0)
        g = init.normal(gen, (B, F, d), 1.0)
        dom = torch.randint(0, rows, (B,), generator=gen, device=dev)
        for mode in ("QK", "Query"):
            for relu_out in (False, True):
                kw = dict(meta_units=units, head_num=heads, mode=mode,
                          relu_out=relu_out)
                got = layer_grads(meta_block.fused_meta_layer, x, layer,
                                  table, dom, g, **kw)
                want = layer_grads(meta_block.meta_layer_reference, x,
                                   layer, table, dom, g, **kw)
                torch.cuda.synchronize()
                errs = grad_errors(got, want)
                err = max(errs.values())
                worst = max(worst, err)
                ops, cfg = meta_block.pack_operands(
                    x, layer, {"Q": table, "K": table}, dom, **kw)
                ops = [t.detach() for t in ops]
                k_ms = time_ms(lambda: meta_block.launch_bwd(g, *ops, cfg),
                               iters=20)
                xr = x.detach().requires_grad_(True)
                tr = table.detach().requires_grad_(True)
                inputs = [xr, tr, *layer.parameters()]
                y = meta_block.meta_layer_reference(
                    xr, layer, {"Q": tr, "K": tr}, dom, **kw)
                p_ms = time_ms(lambda: torch.autograd.grad(
                    y, inputs, g, retain_graph=True), iters=5)
                del y
                b_ms, b_by = meta_layer_bwd_bound_ms(
                    B, F, d, h, heads, rows, "Q" in mode, "K" in mode)
                print(f"kernel meta_block_bwd B={B} mode={mode} "
                      f"relu_out={relu_out}: max_abs_err={err:.3e} (worst "
                      f"{max(errs, key=errs.get)}) kernel_ms={k_ms:.4f} "
                      f"plain_ms={p_ms:.4f} bound_ms={b_ms:.4f} ({b_by})",
                      flush=True)
                if B == BATCH and mode == "QK" and not relu_out:
                    # the training configuration
                    main = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                bound_by=b_by)
    return dict(max_abs_err=worst, **main)


def device_ops(prof):
    """``[(name, device ms, count)]`` of the kernels and copies a
    torch.profiler run saw on the device, largest first.  Spans of
    record_function annotations (such as ``Optimizer.step``) also appear
    on the device's timeline; they enclose kernels already counted and
    are left out."""
    from torch.autograd import DeviceType
    by_name = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.self_device_time_total / 1e3, n + 1)
    return sorted(((k, ms, n) for k, (ms, n) in by_name.items()),
                  key=lambda t: -t[1])


def device_profile(label, run, ref_ms, card, top=12):
    """Device time by kernel over one ``run()`` (torch.profiler), and the
    device's busy share of its wall time, with the profiler on and against
    ``ref_ms``, the same work's time without it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    ops = device_ops(prof)
    if not ops:
        print(f"profile: {label}: the profiler saw no device time: not "
              "measured")
        return
    busy_ms = sum(ms for _, ms, _ in ops)
    print(f"profile [{card}]: {label}: device busy {busy_ms:.3f} ms; wall "
          f"{wall_ms:.3f} ms with the profiler ({100 * busy_ms / wall_ms:.1f}"
          f" % busy), {ref_ms:.3f} ms without it "
          f"({100 * busy_ms / ref_ms:.1f} % busy)", flush=True)
    for name, ms, n in ops[:top]:
        print(f"profile: {ms:9.3f} ms {n:5d}x  {name[:100]}")


def serving_phase(dev, card):
    """Serve the AliCCP sota model through the kernel and through its plain
    path.  Returns the kernel's launch count in the kernel run."""
    from satrans_torch.data import aliccp
    from satrans_torch.features import FeatureLayout
    from satrans_torch.models import SATrans
    from satrans_torch.ops import meta_block
    from satrans_torch.serving import Predictor

    layout = FeatureLayout(aliccp.sota_columns(32))
    # no_emb_init (the reference's 'noembinit' flag) draws the embeddings
    # N(0, 1): with the default N(0, 1e-4) the layers would see inputs of
    # 1e-4 and the comparison below would hardly test them
    kw = dict(domain_att_layer_num=LAYERS, att_head_num=4, meta_mode="QK",
              meta_dnn_hidden_units=(64, 32), no_emb_init=True, seed=SEED,
              device=dev)
    t0 = time.perf_counter()
    model = SATrans(layout, ["301"], [3], **kw)
    torch.cuda.synchronize()
    bank_mb = model.emb.bank.numel() * 4 / 1e6
    print(f"serving: model built in {time.perf_counter() - t0:.2f}s, bank "
          f"{model.emb.bank.shape[0]} x {model.emb.bank.shape[1]} = "
          f"{bank_mb:.1f} MB on {dev}", flush=True)
    pred = Predictor(model, batch_size=BATCH, device=dev).warmup()

    rng = np.random.default_rng(SEED)
    reqs = [{name: rng.integers(1, aliccp.DATA_MAX[name] + 1, REQUEST_ROWS)
             for name in aliccp.SPARSE_FEATURES} for _ in range(REQUESTS)]
    batches = REQUESTS * -(-REQUEST_ROWS // BATCH)

    meta_block.launches = 0
    t0 = time.perf_counter()
    scores = [pred(x) for x in reqs]
    wall = time.perf_counter() - t0
    launches = meta_block.launches
    check(launches == LAYERS * batches,
          f"meta_block_fwd launched {launches} times, want "
          f"{LAYERS} layers x {batches} batches")
    for s in scores:
        check(s.shape == (REQUEST_ROWS,) and s.dtype == np.float64,
              f"scores of shape {s.shape} and type {s.dtype}")
        check(bool(np.all(np.isfinite(s)) and np.all((s > 0) & (s < 1))),
              "scores not finite in (0, 1)")
    n = REQUESTS * REQUEST_ROWS
    print(f"serving [{card}]: {n} examples in {batches} batches of "
          f"{BATCH}: {wall:.4f}s, {n / wall:.1f} examples/s, "
          f"{1e3 * wall / batches:.3f} ms/batch (kernel path, launches "
          f"{launches}); score mean {np.mean(scores):.4f} std "
          f"{np.std(scores):.4f}", flush=True)
    t0 = time.perf_counter()
    for x in reqs:
        pred(x)
    wall2 = time.perf_counter() - t0
    print(f"serving [{card}]: repeat {n / wall2:.1f} examples/s, "
          f"{1e3 * wall2 / batches:.3f} ms/batch (kernel path)", flush=True)
    device_profile(f"one request of {REQUEST_ROWS} examples",
                   lambda: pred(reqs[0]), 1e3 * wall2 / REQUESTS, card)

    plain_model = SATrans(layout, ["301"], [3], use_kernel=False, **kw)
    plain_model.load_state_dict(model.state_dict())
    plain = Predictor(plain_model, batch_size=BATCH, device=dev).warmup()
    t0 = time.perf_counter()
    want = [plain(x) for x in reqs]
    wall_p = time.perf_counter() - t0
    diff = max(float(np.abs(a - b).max()) for a, b in zip(scores, want))
    print(f"serving [{card}]: plain path {n / wall_p:.1f} examples/s, "
          f"{1e3 * wall_p / batches:.3f} ms/batch; max |kernel - plain| = "
          f"{diff:.3e}", flush=True)
    check(diff <= SERVING_TOL, f"serving scores differ from the plain path "
                               f"by {diff} > {SERVING_TOL}")
    return launches


def training_phase(dev, card):
    """Train SATrans at the AliCCP sota width through the kernels.
    Returns the launch counts of the timed fit."""
    from satrans_torch.data import aliccp
    from satrans_torch.features import FeatureLayout
    from satrans_torch.models import SATrans
    from satrans_torch.ops import meta_block
    from satrans_torch.train import Trainer, callbacks

    layout = FeatureLayout(aliccp.sota_columns(32))
    model = SATrans(layout, ["301"], [3], domain_att_layer_num=LAYERS,
                    att_head_num=4, meta_mode="QK",
                    meta_dnn_hidden_units=(64, 32), dropout_rate=0.0,
                    seed=SEED, device=dev)
    trainer = Trainer(model, seed=SEED, device=dev)
    trainer.compile(learning_rate=TRAIN_LR, bank_update="dense")
    # bench.py's synthetic batch: ids uniform in [1, DATA_MAX], labels 0/1
    rng = np.random.default_rng(SEED)
    x = {name: rng.integers(1, aliccp.DATA_MAX[name] + 1, TRAIN_ROWS)
         for name in aliccp.SPARSE_FEATURES}
    y = rng.integers(0, 2, TRAIN_ROWS).astype(np.float32)

    # one step's gradients, kernel path against plain path
    data = layout.batch_from_dict(x)
    batch = trainer._device_batch({k: v[:BATCH] for k, v in data.items()})
    yb, wb = trainer._device_batch({"y": y[:BATCH],
                                    "w": np.ones(BATCH, np.float32)}).values()
    model.train()
    grads = {}
    for use_kernel in (True, False):
        model.use_kernel = use_kernel
        before = (meta_block.launches, meta_block.bwd_launches)
        model.zero_grad(set_to_none=True)
        total = trainer.loss_terms(batch, yb, wb)[0]
        total.backward()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(total)), "training loss not finite")
        grads[use_kernel] = {n: p.grad.clone()
                             for n, p in model.named_parameters()}
        launched = (meta_block.launches - before[0],
                    meta_block.bwd_launches - before[1])
        check(launched == ((LAYERS, LAYERS) if use_kernel else (0, 0)),
              f"one step launched {launched} forward/backward kernels")
    model.use_kernel = True
    errs = grad_errors(grads[True], grads[False])
    worst = max(errs, key=errs.get)
    print(f"train [{card}]: one step's gradients, kernel path vs plain "
          f"path: max_abs_err {errs[worst]:.3e} ({worst}); loss "
          f"{total.item() / BATCH:.6f} per example", flush=True)
    del grads
    model.zero_grad(set_to_none=True)

    trainer.fit({k: v[:2 * BATCH] for k, v in x.items()}, y[:2 * BATCH],
                batch_size=BATCH, verbose=0)  # warmup: two steps
    losses = []

    class Record(callbacks.Callback):
        def on_batch_end(self, step, logs=None):
            losses.append(logs["loss"])

    torch.cuda.synchronize()
    meta_block.launches = meta_block.bwd_launches = 0
    t0 = time.perf_counter()
    hist = trainer.fit(x, y, batch_size=BATCH, epochs=1, verbose=0,
                       callbacks=[Record()])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = (meta_block.launches, meta_block.bwd_launches)
    check(launched == (LAYERS * TRAIN_STEPS, LAYERS * TRAIN_STEPS),
          f"{TRAIN_STEPS} steps launched {launched} forward/backward "
          f"kernels, want {LAYERS} of each per step")
    step_loss = torch.stack(losses).cpu().numpy()
    check(len(step_loss) == TRAIN_STEPS and bool(np.isfinite(
        step_loss).all()) and np.isfinite(hist.history["loss"][0]),
          "training loss not finite at every step")
    per_ex = step_loss[:-1] / BATCH
    print(f"train [{card}]: {TRAIN_ROWS} examples in {TRAIN_STEPS} steps of "
          f"{BATCH} (last a tail of {TRAIN_ROWS - (TRAIN_STEPS - 1) * BATCH})"
          f": {wall:.4f}s, {TRAIN_ROWS / wall:.1f} trained examples/s, "
          f"{1e3 * wall / TRAIN_STEPS:.3f} ms/step (host batch assembly "
          f"included); launches fwd {launched[0]} bwd {launched[1]}; loss "
          f"per example step 1 {per_ex[0]:.6f} step {TRAIN_STEPS - 1} "
          f"{per_ex[-1]:.6f}; epoch loss {hist.history['loss'][0]:.6f}",
          flush=True)

    # the step alone on a staged batch: device time without host assembly
    step_ms = time_ms(lambda: trainer.train_step(batch, yb, wb), iters=10)
    print(f"train [{card}]: train_step on a staged batch {step_ms:.3f} "
          f"ms/step, {1e3 * BATCH / step_ms:.1f} examples/s", flush=True)
    device_profile(f"one training step of {BATCH} examples",
                   lambda: trainer.train_step(batch, yb, wb), step_ms, card,
                   top=16)

    ev = {name: rng.integers(1, aliccp.DATA_MAX[name] + 1, REQUEST_ROWS)
          for name in aliccp.SPARSE_FEATURES}
    ev_y = rng.integers(0, 2, REQUEST_ROWS).astype(np.float32)
    scores = trainer.predict(ev, batch_size=BATCH)
    check(scores.shape == (REQUEST_ROWS,) and bool(np.all(
        np.isfinite(scores))), "predict after training not finite")
    res = trainer.evaluate(ev, ev_y, batch_size=BATCH)
    check(all(np.isfinite(v) for v in res.values()),
          f"evaluate gave {res}")
    print(f"train [{card}]: evaluate on {REQUEST_ROWS} random examples: "
          + ", ".join(f"{k} {v:.6f}" for k, v in res.items()), flush=True)
    return launched


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)

    from satrans_torch.ops import _build
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {json.dumps(built)} in {time.perf_counter() - t0:.2f}s",
          flush=True)
    for name, log in _build.build_log.items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"build {name}: {ln.strip()}")

    k = kernel_phase(dev)
    served = serving_phase(dev, card)
    kb = backward_phase(dev)
    trained = training_phase(dev, card)

    # launches: both main paths run K1-fwd (serving and training, each
    # counted from 0 just before it); only training runs K1-bwd
    kernels = [dict(name="meta_block_fwd", route="cuda",
                    source="satrans_torch/csrc/meta_block_fwd.cu",
                    replaces="satrans_tpu/ops/pallas/meta_block.py:404",
                    launches=served + trained[0],
                    launches_by_path={"serving": served,
                                      "training": trained[0]},
                    max_abs_err=k["max_abs_err"],
                    ms=k["ms"], plain_ms=k["plain_ms"],
                    bound_ms=k["bound_ms"], bound_by=k["bound_by"],
                    library_ms=None),
               dict(name="meta_block_bwd", route="cuda",
                    source="satrans_torch/csrc/meta_block_bwd.cu",
                    replaces="satrans_tpu/ops/pallas/meta_block.py:685",
                    launches=trained[1],
                    launches_by_path={"training": trained[1]},
                    max_abs_err=kb["max_abs_err"],
                    ms=kb["ms"], plain_ms=kb["plain_ms"],
                    bound_ms=kb["bound_ms"], bound_by=kb["bound_by"],
                    library_ms=None)]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
