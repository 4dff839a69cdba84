"""Drive the PyTorch port (satrans_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build every CUDA kernel from satrans_torch/csrc, anew: each source
   without a shape once, the layer bodies' at the AliCCP sota shapes
   (d = 32, 4 heads; 2- and 3-matrix MetaNets) and at phase 18's, one
   library a shape, one nvcc a core (each library's nvcc seconds
   printed); print each tile body (every K1 and K7 forward and
   backward, csrc/meta_stash_{fwd,bwd}.cuh, K6-bwd's and K6-fwd's) with
   its registers and spills (ptxas -v), its dynamic shared memory at F =
   19 and 15 (K6-fwd's also its blocks an SM) and the HMMA instructions
   in its SASS (cuobjdump -sass; none fails the run);
2. hold each layer forward kernel against its plain PyTorch version on
   the card at the AliCCP sota widths (B=8192 and a ragged 8190, F=19,
   d=32, 4 heads, 4 meta rows, MetaNet 32->64->32), in meta modes QK and
   Query with relu_out off and on: K1-fwd, and the output and every
   residual of K1-stash and of K1-stash light, at dropout 0 and (B=8192)
   at dropout 0.1 with the same masks on both sides, and K1-fwd's output
   against K1-stash's (the no-stash mode of the same tile body: bit for
   bit expected, a difference reported and held to the tolerance); check
   the keep share of every dropout site (0.9 within 0.005) and time the
   kernels and the plain version with CUDA events, K1-fwd also at a
   request of 512; K1-fwd, K1-stash, K1-stash light and K1-scores also on
   a skewed domain mix (90 / 5 / 5 % over three rows);
3. serve 3 requests of 20,000 examples through satrans_torch.serving's
   Predictor at batch 8192 with SATrans at the AliCCP sota width (19
   fields with the real vocab sizes, an ~841 MB embedding bank on the
   card), count the kernel's launches (K1-fwd only, never K1-stash), and
   compare the scores with the same model on its plain path;
4. hold the three backward kernels (K1-bwd after K1-fwd, K1-bwd-stash
   after K1-stash, K1-bwd-stash light after K1-stash light) against
   autograd of the plain layer with the same masks at
   the same widths and modes, every gradient, at B=8192 at dropout 0 and
   0.1 and at B=8190 at dropout 0 (the examples with a relu input within
   1e-6 of its kink get no upstream gradient: rounding may flip its
   side), and time them; K1-bwd (the recompute mode of the backward tile
   body) against K1-bwd-stash on the same masks within 1e-5 of each
   gradient's largest entry; each also on the skewed domain mix, where
   K1-bwd-stash twice on the same inputs gives the same bits; and at
   B=2000 K1-bwd and K1-bwd-stash on the card's grid and on one block
   (every weight-gradient sum over all 38,000 rows in one block) against
   the float64 plain layer within 1e-4 of each gradient's largest entry
   plus 1e-5, beside the float32 plain layer's own error;
5. train the same model with satrans_torch.train's Trainer (Adam, lr
   0.005, dense bank update, dropout 0.1 as bench.py publishes it) for 24
   steps at batch 8192 on bench.py-style synthetic ids and labels (the
   last batch a padded tail), once with bwd='stash' and once with
   bwd='recompute': one step's gradients on the kernel path against the
   plain path, exactly 3 forward and 3 backward launches of the arm's
   kernels per step, a finite and falling loss, trained examples/s, the
   staged step, the host queue time and a torch.profiler breakdown of one
   step; then predict/evaluate on 20,000 examples, through K1-fwd only;
6. hold each row kernel of the sparse bank updates against its plain
   PyTorch version at the AliCCP sota shapes (bank, mu and nu of
   1,642,953 x 128 float32, 841 MB each; N = 81,920 ids of a training
   batch's gather plan and a ragged N; the equality combine at ids
   [10, 8192], also on a padded tail batch, at B = 8190 and 8191, with a
   field of one id and one of no duplicate): K2 scatter and K4 gather
   exactly,
   K3 within 1e-5 of its largest total with byte-identical duplicate
   positions and two launches bit for bit, K5 within 2 float32 ulp; and
   time each kernel, its plain version and the one PyTorch call that
   computes the same function where there is one; K3's ids' distinct
   values and longest run a field, and K3 at the batch and the tail with
   its device time by kernel;
7. train the phase-5 model (dropout 0.1, bwd='stash') in the sparse bank
   modes fused, fused_eq, lazy and lazy with SATRANS_LAZY_TAIL=fused (24
   steps and a tail each, after fused against dense from one start after
   3 steps): the exact launches of every kernel per step, a finite and
   falling loss, trained examples/s, the staged step and a torch.profiler
   breakdown of one step;
8. hold the gate and bilinear layer kernels (K6-fwd, and K6-bwd against
   autograd of the plain layer, every gradient) against their plain
   version at the same widths (B=8192 at dropout 0 and 0.1, the ragged
   8190 at 0; gate in QK and Query modes and bilinear, relu_out off and
   on) and time them; K6-fwd also at the odd B=8191, at F=20 and with a
   bilinear table of 64 rows (past the staged tables' budget), and timed,
   queued behind a sleep of the stream, at B=512;
9. serve one request of 20,000 examples through Predictor with the
   AliCCP sota model of the gate and of the bilinear variant (exactly 3
   K6-fwd launches a batch, no K1), and train each in ``lazy`` at
   dropout 0.1 for 12 steps and a tail (exactly 3 K6-fwd and 3 K6-bwd
   launches a step, no K1): one step's gradients kernel vs plain path, a
   finite and falling loss, trained examples/s, the staged step and a
   torch.profiler breakdown of one step;
10. the Alimama sota-pos configuration (``SATrans(use_pos=True)``: 15
   sparse fields with the public vocab sizes and the dense price column,
   per-layer Q and K MetaNet tables and a k_meta LayerNorm): (a) every K1
   body against the plain layer at its widths (B=8192 at dropout 0 and
   0.1, the ragged 8190 at 0; F=15) with distinct Q and K tables, the
   light backward against the full one on the same residuals (within
   1e-6 of each gradient's largest entry), each body timed with its bound
   at F=15, and K6 with distinct Q and K gates; (b) one request of 20,000
   examples through Predictor (exactly 3 K1-fwd a batch); (c) ``lazy``
   training at lr 0.001 and dropout 0.1 for 12 steps and a tail, once with
   bwd='stash' and once with bwd='stash_light' (exactly 3 + 3 launches of
   the arm's pair a step and the lazy row kernels', gradients kernel vs
   plain path, a falling loss, v_meta bit-identical, examples/s, staged
   step, profile), and the two stashes' staged steps in turns;
11. the AliCCP multicol configuration (scenario columns ``301`` and
   ``122``, the reference's ``--domain_col 301-122``: a composite table
   of 4 x 14 = 56 rows, so the batch is dispatched into single-domain
   tiles of 32 and every layer runs K7): (a) K7-fwd, K7-stash (and its
   residuals), K7-bwd-stash and K7-bwd (with the plan's tile_count, as
   the model calls them: the slack slots skipped; the forwards also on
   every slot, K7-fwd's output against K7-stash's, K7-fwd timed at a
   request of 512 too) against the plain tiled
   layer at the full workload's dispatch (B=8192 in 9984 slots) at
   dropout 0 and 0.1, QK and Query, relu_out off and on, and with
   distinct Q and K tables, the two backwards against each other within
   1e-5 of each gradient's largest entry, each body timed with its bound
   (the backwards also on every slot), the backwards' grid, boundary
   tiles and skipped slack slots printed; (b) one request of 20,000
   examples through Predictor (exactly 3 K7-fwd a batch, no K1 or K6);
   (c) ``lazy`` training at lr 0.005 and dropout 0.1 for 12 steps and a
   tail under SATRANS_TILED_BWD=stash and recompute (exactly 3 + 3
   launches of the arm's K7 pair a step and the lazy row kernels', no K1
   or K6, gradients kernel vs plain path, a falling loss, domain_emb and
   domain_bank's large part bit-identical, examples/s, staged step,
   profile), and the two backwards' staged steps in turns;
12. the attention probes and the experiment entry point: (a) K1-scores against
   the plain layer at the AliCCP sota width (B=8192, F=19; QK, and Query
   with relu_out; shared and distinct Q and K tables; dropout 0, and 0.1
   in training with the same seed): the output within the forward
   tolerance, the probabilities within 1e-6 of the plain layer's clamped
   ones, every row summing to 1 within 1e-5, and bit-identical to
   K1-stash's ``s``; timed beside K1-fwd and K1-stash at 8192 and at the
   probes' 32,768; (b) ``predict_with_attention`` over 3 batches of
   32,768 on phase 5's model and ids, on K1-scores (exactly 3 launches a
   batch, no other K1 body) and on the plain layer
   (SATRANS_PROBE_FUSED=0): examples/s, device busy share, the two
   routes' means within 1e-5; ``dump_instance_attention`` of 1,000
   instances on both (the same triples but at the threshold); (c)
   ``satrans_torch.cli.main.main`` with ``--data_name synthetic
   --synthetic_rows 200000 --flag showattn_instattn_dump`` at the CLI's
   defaults into a temporary directory: AUCs, launches, the results row
   and files; the dumped checkpoint restored into a Trainer predicting the
   run's ``_testpred.pkl`` bit for bit on the same path (K1-scores), and
   ``serving.load`` of it (K1-fwd, another mode of the same tile body) bit
   for bit too; a ``--finetune True`` run.

13. 3-matrix MetaNets (``meta_dnn_hidden_units=(64, 64, 32)``, units
   [32, 64, 64, 32]: the middle matrix in every K1 and K7 body): (a) every
   K1 body against the plain layer at B=8192 (dropout 0 and 0.1) and 8190
   (0), F=19 (QK; Query with relu_out) with one table and F=15 with
   distinct Q and K tables, the outputs, residuals, probabilities and
   every gradient (the tables' middle block included), each body timed
   with its bound; the four K7 bodies at the multicol dispatch (QK at 0
   and 0.1, Query with relu_out and distinct tables at 0.1); (b) the
   AliCCP sota model with them: 3 requests of 20,000 (K1-fwd only, against
   the plain path), ``lazy`` training at 0.1 under bwd='stash' for 12
   steps and a tail (one step's gradients kernel vs plain path, launches,
   staged step, profile), staged steps under 'stash_light' and
   'recompute', one ``predict_with_attention`` batch of 32,768 on
   K1-scores; (c) the multicol model with them: one request (K7-fwd),
   ``lazy`` training under SATRANS_TILED_BWD=stash and staged steps under
   recompute.  The JSON line lists the 3-matrix instances as
   ``<body>_3mat``, with their launches on phase 13's paths.

14. the row-DMA probes (P1, P2: per-row bulk copies of the TMA in
   ``csrc/row_dma.cu``): ``satrans_torch.bench.scatter_probe`` and
   ``gather_probe`` at their production shape (arrays of 1,638,400 x 128
   float32, N = 81,920 ids; P1 sorted unique, P2 with duplicates): every
   variant (bulk, slots) and rb (64, 128, 256), P2 on one array and on
   three, against ``index_copy_`` and ``index_select`` exactly, timed
   beside the plain version, the library call, K2 / K4 and a null body,
   with the bytes bound; an N that rb does not divide raises;
15. the port's bench, ``satrans_torch.bench.train_throughput --chunks 1``,
   in-process: its four arms (AliCCP dense, lazy, lazy with the fused
   tail; Alimama sota-pos lazy) at batch 8192 on 10 staged batches, each
   line with a finite loss, examples/s of the staged chunk and of ``fit``
   above 0, and exactly 3 + 3 K1-stash / K1-bwd-stash launches a step, with
   K4, K2 and K3 (split tail) or K4, K3 and K5 (fused tail) in ``lazy``;
16. the baseline zoo (WDL, DeepFM, DCN, xDeepFM, NFM, AFM, PNN, AutoInt,
   FiBiNET, AdaSparse), each built as ``satrans_torch.cli.main`` builds
   it, at the AliCCP sota width (batch 8192, xDeepFM 4096): the forward on
   the card against the same weights on the CPU, 3 ``fit`` steps in
   ``lazy`` with the split tail and 3 with ``SATRANS_LAZY_TAIL=fused``
   (finite losses, exactly 2 K4, 1 K2 and 1 K3 a step, or 1 K4, 1 K3 and 1
   K5; no layer kernel), examples/s, the staged step and its device-busy
   share; AdaSparse trains ``dense`` with no kernel and refuses ``lazy``;
   DeepFM ``fused`` equal to ``dense`` bit for bit after 3 steps; WDL at
   ``dnn_dropout`` 0.1 with its masks' keep share (0.9 within 0.005);
   and SATrans trained in ``lazy`` at dropout 0.1 at batch 8190, which no
   dropout tile divides: the JAX package's XLA route, no layer kernel;
17. STAR and the multi-task models (Star_Net, SharedBottom, MMOE, PLE as
   the CLI builds them, ESMM with 2 tasks on 301 ids from {1, 2}) at the
   same width and batch: STAR ``fused`` equal to ``dense`` after 3 steps,
   every parameter and BatchNorm buffer bit for bit, each domain's count
   3, then a batch without domain 3 keeping its mean and var; 3 ``dense``
   steps (no kernel) and 3 + 3 ``lazy`` steps (exact K2-K5 launches a
   step), the staged step and a profile; STAR's counts equal to its
   steps; MMOE's routed ``predict`` of 20,000 equal to its ``Predictor``
   and to ``serving.load``'s bit for bit, each score its domain's head;
   each forward on the card against a CPU copy (parameters N(0, 0.1),
   STAR's trained statistics kept); then ``cli.main --model_name
   Star_Net`` and ``MMOE`` on 40,960 synthetic rows in ``lazy`` (fit,
   predict, report), each with its steps' K2-K5 launches.
18. the reference CLI's other widths and head counts (MetaNet (2d, d),
   each shape's kernels built at the start with the others): (a) at
   (d, heads) (8, 2), (8, 8), (16, 2), (32, 1), (32, 8), (64, 1) and
   (64, 8), B = 512 at dropout 0 and 0.1 (QK, 4 table rows): K1-fwd,
   K1-stash, K1-stash light and K1-scores (output and residuals), K1-bwd,
   K1-bwd-stash and K1-bwd-stash light (every gradient), K7's four bodies
   on the multicol dispatch, K6-fwd and K6-bwd (gate and bilinear)
   against their plain versions at the d = 32 phases' tolerances; each
   body timed at 8192 and at 512 at dropout 0.1, with its bound and the
   plain version's time; each shape's shared memory, layouts and build
   seconds; (b) at d = 64 with 8 heads (AliCCP sota fields, a bank of
   1.68 GB): a request of 20,000 through Predictor (K1-fwd, scores
   against the plain path), 3 staged ``lazy`` stash steps and 3 ``dense``
   recompute steps, one showattn probe batch (K1-scores); (c) the gate
   and bilinear models (K6) and the multicol model (K7, stash then
   recompute) at (64, 8) and (16, 2), 3 ``lazy`` steps and one request
   each; (d) Alimama sota-pos at (16, 2), 3 ``lazy`` stash_light steps;
   (e) ``cli.main --embedding_dim 8 --att_head_num 2`` and 16 / 2 with
   ``--bank_update lazy`` on 40,960 synthetic rows.  Every path's
   launches by kernel are counted from 0 and the plain layer's calls
   with them (none), each step's device busy time printed.  The JSON
   line gives each layer kernel's fields by shape (``widths``) and its
   launches on these paths.

19. many meta rows (K1's backwards past the rows their blocks' slices
   hold walk the batch sorted by domain row; K6-bwd keeps every row in its
   slices): (a) at d = 32, 4 heads, B = 8192, dropout 0.1, K1's four
   forwards (output and residuals) and three backwards (every gradient)
   at 56 and 64 rows, K6-fwd and K6-bwd (gate at 56, 64, 98 and 128 rows,
   bilinear at 56, 64 and 128) against their plain versions; (b) K1's
   backwards timed at 4, 56 and 64 rows (d = 32 / 4 heads) and 4, 14 and
   32 (d = 64 / 8 heads), K6-bwd at 4 to 256 rows, each with its scratch
   bytes, bound and plain time, and the sorted walk's scratch at every
   shape of the set at the JAX cap; (c) at the AliCCP sota width: the gate
   and the bilinear map on scenario columns 301 and 122 (56 rows), 3
   ``lazy`` steps and a request of 20,000 each; the gate on 121 (98
   rows), 3 ``lazy`` steps; d = 64, 8 heads, metanet on 122 (14 rows), 3
   ``lazy`` stash and 3 ``dense`` recompute steps; a metanet on one column
   of 63 values (64 rows), 3 ``lazy`` stash steps.  Every path's launches
   counted from 0 with the plain layer's calls (none) and each step's
   device busy time.

20. the legacy Star-Trans models and SATrans past SATRANS_COMPOSITE_MAX,
   at the AliCCP sota layout (19 fields, d = 32, the real vocabularies,
   batch 8192; their layers, the JAX package's XLA computations, are plain
   PyTorch with the XLA route's dropout masks at 0.1): (a) Star_Trans,
   also with ``--att_layer_num 2 --att_layer_type trans --merge sum``,
   Starv2_Trans (3 query bases, ``attn_batch_reg`` 0.1), Starv3_Trans
   (``--meta_mode Query``), Starv4_Trans with and without ``aggmap``,
   each built as the JAX CLI builds it (scenario 301, 3 domain layers, 4
   heads): 3 ``fit`` steps in ``dense`` and 3 + 3 in ``lazy`` (split
   tail, fused tail) with K2-K5's launches a step held and no layer
   kernel, every loss finite and Starv2's aux loss above 0, each staged
   step's device busy time and top kernels, the forward on the card
   against a CPU copy; (b) SATrans on ``--domain_col 301-122-125`` (448
   combinations: per-example meta parameters), metanet and gate: 3
   ``lazy`` steps, a Predictor answering 3 requests of 8192 (no kernel
   at all), the forward against the CPU; (c) ``cli.main --model_name
   Starv2_Trans`` and ``--model_name SATrans --domain_col domain-f0``
   (4 x 1,000 combinations) with ``--bank_update lazy`` on 40,960
   synthetic rows, each with its steps' K2-K5 launches.

21. the data pipeline and the rest of the single-card Trainer, at the
   AliCCP sota configuration (19 fields, the 6,571,812 x 32 bank, 3
   layers, 4 heads, dropout 0.1, batch 8192): (a) the native batcher
   (``satrans_torch/native``, built here with g++): ``gather_rows`` and
   ``gather_columns`` equal numpy on a batch of 8192, each timed on the
   host beside numpy; (b) ``fit_from_iterator`` through
   ``Prefetcher(ShardedBatchIterator(...).epoch(e))`` against two runs of
   ``fit`` on the same rows in ``lazy`` (5 steps and a tail): the
   parameters and the lazy state within twice ``fit``'s own run-to-run
   spread (bit for bit where ``fit`` is), K1-stash, K1-bwd-stash, K4, K2
   and K3 launched exactly as phase 7's steps, examples/s of both; (c)
   ``sgd``, ``adagrad``, ``rmsprop`` and a custom ``torch.optim.SGD`` in
   ``dense``, 3 steps (sgd: 1 checked, its diverging second and third
   reported): each step's gradients on the kernel and the plain path at
   the same parameters within phase 5's tolerance, the parameters the
   optimizer makes of each from the same state within OPT_PARAM_TOL
   (rmsprop: but for at most RMSPROP_FLIP_SHARE of a tensor, within its
   step bound), 3 + 3 K1-stash / K1-bwd-stash launches a step; (d)
   ``callbacks.ModelCheckpoint`` under ``rmsprop`` restored into a new
   trainer bit for bit; (e) ``evaluate_domains`` on 4 x 8192 examples on
   K1-fwd alone against ``metrics.auc`` / ``per_domain_auc`` (1e-5) and
   ``log_loss`` (1e-6) on ``predict()``'s scores; (f)
   ``satrans_torch.bench.raw_e2e.run``: 80,000 + 20,000 generated raw
   rows through ``data.aliccp.preprocess_raw`` (the port's HDF5 writer
   where ``h5py`` is not installed) and ``cli.main`` at d = 8, 2 heads,
   1 layer: the four AUCs within 0.015 of RAWE2E_r05.json, K1's launches
   exactly the run's steps and predict batches.

22. the mesh (``satrans_torch/parallel``, a rank a process; see
   ``parallel_phase``).

23. the serving path as CUDA graphs (``serving_graph_phase``): for each
   family the Predictor serves (the AliCCP sota metanet at 32,768 and
   8192; gate; bilinear; Alimama sota-pos; multicol 301-122 on K7; the
   3-matrix MetaNet; DeepFM; MMOE; Star_Trans; SATrans per-example on
   301-122-125; one each, at 8192 but the first), ``Predictor.aot_compile``
   captures one CUDA graph of a batch's score (its captured launches: 3
   K1-fwd, K6-fwd or K7-fwd a batch, or none), and a request of three
   batches and a half is served at pipeline depths 1, 2 and 4 through
   the graph and through the eager Predictor: every score equal bit for
   bit, no counter moving under replay (launches are replays times the
   captured ones), the scores against the plain route within 1e-5 (or,
   with no layer kernel, a CPU copy on 2048 rows); the replay's ms, each
   arm's examples/s a depth, the card's busy share of a request and the
   capture's seconds; then ``satrans_torch.bench.serving_throughput``
   (the graph's scores equal to the eager Predictor's),
   ``probe_throughput`` (K1-scores captured: its predictions and means
   against the plain layer's within 1e-5) and ``kernels`` (K1-fwd
   captured: its output against the plain layer's within 1e-4) once
   each.

Phases 2 and 4 also hold K1 where a share of the attention logits passes
the kernels' clamp at 60 against the clamped plain layer.

It prints the card's name and power limit, one JSON line naming each
kernel with its launches, error and times, and as its last line
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 2 and
prints no result.
"""

from __future__ import annotations

import copy
import functools
import gc
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 1021
BATCH = 8192
# the bench.py workload's dropout; the layer checks draw with a seed whose
# seed + tile wraps past int32 on the last tiles of a batch of 8192
DROP_RATE, DROP_SEED, DROP_TILE = 0.1, 2 ** 31 - 40, 128
KEEP_SHARE_TOL = 0.005
REQUESTS, REQUEST_ROWS = 3, 20_000
LAYERS = 3
# H100 SXM data-sheet peaks at 700 W: float32 outside the tensor cores,
# TF32 on them (a 3xTF32 product of the tile bodies issues three), and
# HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_TF32X3_FLOPS = 495e12 / 3
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
TAIL = TRAIN_ROWS - (TRAIN_STEPS - 1) * BATCH
# the lazy arms of phases 9 and 10: 12 full steps and the tail
ARM_STEPS = 13
ARM_ROWS = (ARM_STEPS - 1) * BATCH + TAIL
# the Alimama sota-pos configuration (phase 10): its 15 fields and the
# bench.py arm's learning rate
ALIMAMA_F = 15
POS_LR = 0.001
# K1-bwd-stash against K1-bwd and K7-bwd-stash against K7-bwd on the same
# masks, as a share of each gradient's largest entry (the stash holds the
# forward's residuals, which the recompute modes compute in another order)
STASH_RECOMPUTE_RTOL = 1e-5
# K1-bwd-stash light against K1-bwd-stash on the same residuals, as a share
# of each gradient's largest entry (the same probabilities: bit for bit is
# expected)
STASH_LIGHT_RTOL = 1e-6
# K5 rounds each operation as PyTorch's kernels do: within 2 float32 ulp;
# K3 sums in another order than the plain GEMM: 1e-5 of the largest total
LAZY_TAIL_TOL = dict(rtol=2.4e-7, atol=1e-12)
EQGEMM_RTOL = 1e-5
# fused against dense after 3 steps: the tolerance of the CPU parity tests
# (Adam's sign-like first step amplifies float32 round-off)
PARAM_TOL = dict(atol=5e-5, rtol=1e-3)
# the layer kernels' launch counters in ops/meta_block.py, and the names
# of their kernels in the JSON line
K1_COUNTS = ("launches", "stash_launches", "bwd_launches",
             "stash_bwd_launches", "stash_light_launches",
             "stash_light_bwd_launches")
K1_NAMES = ("meta_block_fwd", "meta_block_fwd_stash", "meta_block_bwd",
            "meta_block_bwd_stash", "meta_block_fwd_stash_light",
            "meta_block_bwd_stash_light")
# each backward's pair of K1 bodies a layer, in K1_COUNTS order
K1_PAIR = {"recompute": (1, 0, 1, 0, 0, 0), "stash": (0, 1, 0, 1, 0, 0),
           "stash_light": (0, 0, 0, 0, 1, 1)}
NO_K1 = (0,) * len(K1_COUNTS)
# each backward mode's K1 backward body
K1_BWD_NAME = {"stash": "meta_block_bwd_stash",
               "stash_light": "meta_block_bwd_stash_light",
               "recompute": "meta_block_bwd"}
# K7's counters in ops/tiled_meta.py, its names in the JSON line, and each
# backward's pair a layer in K7_COUNTS order
K7_COUNTS = ("launches", "stash_launches", "bwd_launches",
             "stash_bwd_launches")
K7_NAMES = ("tiled_meta_fwd", "tiled_meta_fwd_stash", "tiled_meta_bwd",
            "tiled_meta_bwd_stash")
K7_PAIR = {"recompute": (1, 0, 1, 0), "stash": (0, 1, 0, 1)}
NO_K7 = (0,) * len(K7_COUNTS)
# the MetaNet units of the kernel shapes: 2 matrices (every phase but 13)
# and 3 matrices (phase 13: meta_dnn_hidden_units=(64, 64, 32))
UNITS2, UNITS3 = (32, 64, 32), (32, 64, 64, 32)
# the 3-matrix instances' names in the JSON line, by the 2-matrix body's
K1_NAMES3 = {n: f"{n}_3mat" for n in K1_NAMES + ("meta_block_fwd_scores",)}
K7_NAMES3 = {n: f"{n}_3mat" for n in K7_NAMES}
# the AliCCP multicol configuration (phase 11): two scenario columns, a
# composite table of (3 + 1) x (13 + 1) rows, dispatch tiles of 32
MULTICOL_COLS, MULTICOL_DOMAINS = ["301", "122"], [3, 13]
MULTICOL_ROWS, MULTICOL_TILE = 56, 32
# the sparse training arms: (name, bank_update, SATRANS_LAZY_TAIL) and the
# launches a step of K4 gather, K2 scatter, K3 eqgemm, K5 lazy tail
SPARSE_ARMS = (("fused", "fused", None, (2, 1, 0, 0)),
               ("fused_eq", "fused_eq", None, (2, 1, 1, 0)),
               ("lazy", "lazy", None, (2, 1, 1, 0)),
               ("lazy_fused_tail", "lazy", "fused", (1, 0, 1, 1)))
ROW_KERNELS = ("gather", "scatter", "eqgemm", "lazy_tail")
ROW_NAMES = ("gather_rows", "scatter_rows_set", "eqgemm_positions",
             "lazy_adam_rows")
# the row kernels' launches a step in 'lazy' (the split tail)
LAZY_ROWS_PER_STEP = SPARSE_ARMS[2][3]


# the sources of the tile bodies, which the C entries of csrc/
# meta_block_{fwd,bwd}.cu launch
TILE_SOURCES = {n: "satrans_torch/csrc/meta_stash_" + (
    "bwd.cuh" if "bwd" in n else "fwd.cuh") for n in (
    "meta_block_fwd", "meta_block_fwd_stash", "meta_block_fwd_stash_light",
    "meta_block_fwd_scores", "tiled_meta_fwd", "tiled_meta_fwd_stash",
    "meta_block_bwd_stash",
    "meta_block_bwd", "meta_block_bwd_stash_light", "tiled_meta_bwd",
    "tiled_meta_bwd_stash")}
# the tile bodies (csrc/meta_stash_fwd.cuh, csrc/meta_stash_bwd.cuh) by
# kernel, mode (enum StashMode) and walk (the forward's TILED; the
# backward's enum BwdWalk: 0 K1 on its blocks' slices, 1 K7, 2 K1 past its
# slice rows on the batch sorted by domain row), as the JSON line names
# them (the sorted walk's bodies under "_sorted")
TILE_BODIES = {
    ("meta_stash_fwd_kernel", 0, 0): "meta_block_fwd",
    ("meta_stash_fwd_kernel", 1, 0): "meta_block_fwd_stash",
    ("meta_stash_fwd_kernel", 2, 0): "meta_block_fwd_stash_light",
    ("meta_stash_fwd_kernel", 3, 0): "meta_block_fwd_scores",
    ("meta_stash_fwd_kernel", 0, 1): "tiled_meta_fwd",
    ("meta_stash_fwd_kernel", 1, 1): "tiled_meta_fwd_stash",
    ("meta_stash_bwd_kernel", 0, 0): "meta_block_bwd",
    ("meta_stash_bwd_kernel", 1, 0): "meta_block_bwd_stash",
    ("meta_stash_bwd_kernel", 2, 0): "meta_block_bwd_stash_light",
    ("meta_stash_bwd_kernel", 1, 1): "tiled_meta_bwd_stash",
    ("meta_stash_bwd_kernel", 0, 1): "tiled_meta_bwd",
    ("meta_stash_bwd_kernel", 0, 2): "meta_block_bwd_sorted",
    ("meta_stash_bwd_kernel", 1, 2): "meta_block_bwd_stash_sorted",
    ("meta_stash_bwd_kernel", 2, 2): "meta_block_bwd_stash_light_sorted"}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """CUDA-event ms per call of ``fn``, the calls queued back to back by
    the host: a call shorter than the host's time to queue it
    (:func:`host_ms`) shows the host's pace, which a step's time should
    (the B = 512 kernel times use :func:`queued_ms`)."""
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


def queued_ms(fn, iters: int = 50) -> float:
    """CUDA-event ms per call of ``fn`` with the calls queued ahead of the
    card: the stream sleeps while the host queues them, so that the events
    time the kernels back to back, not the host's pace (which a kernel
    shorter than the host's time to queue it would show)."""
    for _ in range(3):
        fn()
    per = host_ms(fn)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # twice the host's time for the calls, at 2 GHz or less
    torch.cuda._sleep(int(2e6 * (2 * per * iters + 1)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 10) -> float:
    """Host time per call of ``fn`` without waiting for the device: the
    time to queue its work.  Where it is close to the call's time with the
    device (``time_ms``), the host, not the card, sets the pace."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * wall / iters


def _bound(flops: float, nbytes: float, mma_flops: float = 0.0):
    """(ms, bound_by): the largest of the float32 work on the CUDA cores
    over the card's float32 peak, the work of products run in 3xTF32 on
    the tensor cores (``mma_flops`` of ``flops``) over a third of its TF32
    peak (the two pipes run side by side), and the bytes over the HBM
    rate."""
    t_ops = max((flops - mma_flops) / PEAK_F32_FLOPS,
                mma_flops / PEAK_TF32X3_FLOPS)
    t_bytes = nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


def _meta_floats(d, h, h2=0):
    """Floats of one MetaNet: W1 [d, h], the middle [h, h2] of a 3-matrix
    one (h2 > 0), W2 [h2 or h, d]."""
    return d * h + h * h2 + (h2 or h) * d


def _layer_flops(F, d, h, apply_q, apply_k, h2=0):
    """Float operations of one example's layer forward."""
    return (2 * F * d * 3 * d                       # x @ Wqkv
            + (apply_q + apply_k) * 2 * F * _meta_floats(d, h, h2)
            + 2 * 2 * F * F * d                     # q k^T and p v
            + 2 * F * d * d)                        # o @ Wout


def _weight_floats(d, h, meta_rows, h2=0):
    return 4 * d * d + meta_rows * _meta_floats(d, h, h2) + 6 * d


def _residual_floats(F, d, heads, stash="full"):
    """The residuals of one example: qkv, uq, uk and o, and in the full
    stash the probabilities s; K1-scores' ('scores') the probabilities
    alone."""
    if stash == "scores":
        return heads * F * F
    return F * 3 * d + 3 * F * d + (heads * F * F if stash == "full" else 0)


def meta_layer_bound_ms(B, F, d, h, heads, meta_rows, apply_q, apply_k,
                        stash=None, h2=0, occupied=None,
                        tensor_cores=True):
    """Least time for one layer forward: its float work, and its bytes (x
    in, y out, dom and the weights read once; with ``stash`` 'full' or
    'light' the residuals of K1-stash or K1-stash light written, with
    'scores' K1-scores' probabilities).  The dropout hash's integer work
    (about 46 k operations an example, 11 us at B=8192 over the card's
    33.5 T int32 operations a second) is under a fifth of the float time
    and left out.  ``h2`` is a 3-matrix MetaNet's second hidden width (0: 2
    matrices).  Every mode (K1-fwd and K7-fwd included, since they run on
    the forward tile body) computes its products (all but q k^T and p v)
    in 3xTF32 on the tensor cores; the count with ``tensor_cores`` False
    runs every product on the CUDA cores, as the template body that K1-fwd
    and K7-fwd first ran on did.  K7 computes the ``occupied`` slots of its
    ``B`` (x read, the work) and writes y (and the residuals) of all ``B``
    (zeros on the slack slots).  Returns (ms, bound_by)."""
    n = B if occupied is None else occupied
    nbytes = 4 * (n * F * d + B * F * d + n
                  + _weight_floats(d, h, meta_rows, h2))
    if stash:
        nbytes += 4 * B * _residual_floats(F, d, heads, stash)
    flops = _layer_flops(F, d, h, apply_q, apply_k, h2)
    mma = flops - 4 * F * F * d if tensor_cores else 0
    return _bound(n * flops, nbytes, n * mma)


def meta_layer_bwd_bound_ms(B, F, d, h, heads, meta_rows, apply_q, apply_k,
                            stash=None, h2=0, occupied=None):
    """Least time for the layer's backward: K1-bwd and K7-bwd recompute the
    forward (its operations); K1-bwd-stash (``stash='full'``) only the
    MetaNet hidden layers (2Fdh an applied MetaNet, and 2F h h2 more for a
    3-matrix one's second) and zlin = o @ Wout (2Fd^2), and reads the
    residuals; K1-bwd-stash light (``'light'``) also the logits q k^T
    (2F^2 d), and reads the residuals but s.  Then dWout and do (2 x
    2Fd^2), the attention backward (dv, dP, dq, dk: 4 x 2F^2 d), per
    applied MetaNet dW2, dhid, dW1 and dt0 (4 x 2Fdh; a 3-matrix one also
    dWm and dh1, 2 x 2F h h2), and dWqkv and dx (2 x 6Fd^2).  Bytes are x,
    g and dom in, dx out, the weights in and their gradients out, and the
    residuals in.  Every backward runs on the tile body, whose products
    but the attention's are 3xTF32 on the tensor cores.  K7's work is that
    of the ``occupied`` slots of its ``B`` (the slack slots' dx is
    written, nothing else of them is needed)."""
    n = B if occupied is None else occupied
    n_meta = apply_q + apply_k
    hidden = d * h + h * h2  # the forward's products up to the last hidden
    again = (n_meta * 2 * F * hidden + 2 * F * d * d if stash
             else _layer_flops(F, d, h, apply_q, apply_k, h2))
    if stash == "light":
        again += 2 * F * F * d
    backward = (4 * F * d * d + 8 * F * F * d
                + n_meta * 4 * F * _meta_floats(d, h, h2) + 12 * F * d * d)
    nbytes = 4 * (2 * n * F * d + B * F * d + n
                  + 2 * _weight_floats(d, h, meta_rows, h2))
    if stash:
        nbytes += 4 * n * _residual_floats(F, d, heads, stash)
    # the attention's products: the backward's, and the logits (and p v)
    # that the light stash (the recompute modes) recompute
    attention = 8 * F * F * d + {"light": 2 * F * F * d, "full": 0,
                                 None: 4 * F * F * d}[stash]
    mma = again + backward - attention
    return _bound(n * (again + backward), nbytes, n * mma)


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


def test_layer(dev, seed, units=UNITS2):
    """The layer of phases 2 and 4 (its meta LayerNorm moved off its (1, 0)
    init), its 4-row table of MetaNets of ``units`` and the generator after
    them."""
    from satrans_torch.nn import attention, initializers as init, metanet
    from satrans_torch.utils import make_generator
    gen = make_generator(seed, dev)
    layer = attention.MetaTransformerLayer(gen, 32)
    with torch.no_grad():
        layer.q_meta.ln.scale.add_(init.normal(gen, (32,), 0.1))
        layer.q_meta.ln.bias.add_(init.normal(gen, (32,), 0.1))
    table = init.normal(gen, (4, metanet.param_size(units)), 0.1)
    return gen, layer, table


def hot_layer(dev, seed):
    """The layer of :func:`test_layer` with its meta LayerNorm scaled 6
    times, so that a share of the attention logits passes the kernels'
    clamp at 60; returns (gen, layer, table)."""
    gen, layer, table = test_layer(dev, seed)
    with torch.no_grad():
        layer.q_meta.ln.scale.mul_(6.0)
    return gen, layer, table


def logit_share_past_clamp(x, layer, table, dom, **kw):
    """The share of the plain layer's attention logits beyond +-60."""
    from satrans_torch.nn import attention
    from satrans_torch.ops import meta_block
    res = {}
    with torch.no_grad():
        meta_block.meta_layer_reference(x, layer, {"Q": table, "K": table},
                                        dom, **kw, residuals=res)
        heads = kw["head_num"]
        q, k = (attention._split_heads(layer.q_meta.ln(res[u]), heads)
                for u in ("uq", "uk"))
        logits = q @ k.transpose(-1, -2) / (q.shape[-1] ** 0.5)
        return (logits.abs() > attention.LOGIT_CLAMP).double().mean().item()


def clamp_forward_case(dev):
    """K1-fwd and K1-stash against the clamped plain layer where a share
    of the logits passes 60 (B=8192, QK, dropout 0.1); the unclamped plain
    layer must differ.  Returns the worst error."""
    from satrans_torch.nn import initializers as init
    from satrans_torch.ops import meta_block, prng
    F, d, heads, rows = 19, 32, 4, 4
    gen, layer, table = hot_layer(dev, SEED + 4)
    tables = {"Q": table, "K": table}
    x = init.normal(gen, (BATCH, F, d), 1.0)
    dom = torch.randint(0, rows, (BATCH,), generator=gen, device=dev)
    kw = dict(meta_units=[d, 64, d], head_num=heads, mode="QK",
              relu_out=False)
    drop = drop_kw(DROP_RATE)
    masks = meta_block.layer_masks(x, head_num=heads, mode="QK", **drop)
    ops, cfg = meta_block.pack_operands(x, layer, tables, dom, **kw)
    kargs = prng.kernel_args(True, DROP_RATE, DROP_SEED, DROP_TILE, F)
    with torch.no_grad():
        y = meta_block.fused_meta_layer(x, layer, tables, dom, **kw, **drop)
        st = meta_block.launch_fwd(*ops, cfg, kargs, stash="full")[0]
        ref = meta_block.meta_layer_reference(x, layer, tables, dom, **kw,
                                              masks=masks)
        free = meta_block.meta_layer_reference(x, layer, tables, dom, **kw,
                                               masks=masks, clamp=False)
    torch.cuda.synchronize()
    share = logit_share_past_clamp(x, layer, table, dom, **kw)
    err = max((y - ref).abs().max().item(), (st - ref).abs().max().item())
    gap = (ref - free).abs().max().item()
    same, _ = fwd_stash_gap(y, st, "K1-fwd past the clamp")
    print(f"kernel meta_block_fwd, logits past the clamp (share "
          f"{share:.4f}), B={BATCH} QK dropout={DROP_RATE}: K1-fwd and "
          f"K1-stash max_abs_err={err:.3e} against the clamped plain "
          f"layer, K1-fwd's y bit-identical to K1-stash's: {same}; "
          f"clamped - unclamped plain {gap:.3e}", flush=True)
    check(share > 0.01 and gap > 1e-2, f"the clamp case does not pass 60 "
          f"(share {share}, clamped - unclamped {gap})")
    check(bool(torch.isfinite(y).all()) and torch.allclose(
        y, ref, **KERNEL_TOL) and torch.allclose(st, ref, **KERNEL_TOL),
          f"K1 forwards disagree with the clamped plain layer past 60 "
          f"(max_abs_err {err}, tolerance {KERNEL_TOL})")
    return err


def skewed_dom(gen, B, dev):
    """Domain rows of a skewed mix: 90 % row 0, 5 % row 1, 5 % row 2, so
    that the tile bodies' domain segments are long and uneven."""
    u = torch.rand(B, generator=gen, device=dev)
    return (u >= 0.9).long() + (u >= 0.95).long()


def skewed_forward_case(dev):
    """K1-stash, K1-stash light and K1-scores against the plain layer on a
    skewed domain mix (:func:`skewed_dom`; B=8192, QK, dropout 0.1): the
    output and every residual within KERNEL_TOL, the light ones and K1-
    scores' s equal to K1-stash's, K1-fwd's y to K1-stash's
    (:func:`fwd_stash_gap`).  Returns the worst error."""
    from satrans_torch.nn import initializers as init
    from satrans_torch.ops import meta_block, prng
    F, d, heads = 19, 32, 4
    gen, layer, table = test_layer(dev, SEED + 6)
    tables = shared(table)
    x = init.normal(gen, (BATCH, F, d), 1.0)
    dom = skewed_dom(gen, BATCH, dev)
    kw = dict(meta_units=[d, 64, d], head_num=heads, mode="QK",
              relu_out=False)
    drop = drop_kw(DROP_RATE)
    masks = meta_block.layer_masks(x, head_num=heads, mode="QK", **drop)
    ops, cfg = meta_block.pack_operands(x, layer, tables, dom, **kw)
    kargs = prng.kernel_args(True, DROP_RATE, DROP_SEED, DROP_TILE, F)
    res = {}
    with torch.no_grad():
        st = meta_block.launch_fwd(*ops, cfg, kargs, stash="full")
        lt = meta_block.launch_fwd(*ops, cfg, kargs, stash="light")
        sc = meta_block.launch_fwd(*ops, cfg, kargs, stash="scores")
        fw = meta_block.launch_fwd(*ops, cfg, kargs)
        ref = meta_block.meta_layer_reference(x, layer, tables, dom, **kw,
                                              masks=masks, residuals=res)
    torch.cuda.synchronize()
    names = ("y", "qkv", "uq", "uk", "s", "o")
    want = (ref, *(res[n] for n in names[1:]))
    errs = {n: (g - w).abs().max().item() for n, g, w in zip(names, st, want)}
    shares = torch.bincount(dom, minlength=3).double() / BATCH
    print(f"kernel meta_block_fwd_stash, skewed domains (shares "
          f"{[round(v, 4) for v in shares.tolist()]}), B={BATCH} QK "
          f"dropout={DROP_RATE}: " + " ".join(
              f"{n} {e:.3e}" for n, e in errs.items()), flush=True)
    for n, g, w in zip(names, st, want):
        check(bool(torch.isfinite(g).all()) and torch.allclose(
            g, w, **KERNEL_TOL), f"K1-stash's {n} disagrees with the plain "
            f"layer on skewed domains (max_abs_err {errs[n]})")
    check(all(torch.equal(a, st[i]) for a, i in zip(lt, (0, 1, 2, 3, 5))),
          "K1-stash light differs from K1-stash on skewed domains")
    check(torch.equal(sc[0], st[0]) and torch.equal(sc[1], st[4]),
          "K1-scores differs from K1-stash on skewed domains")
    fwd_stash_gap(fw, st[0], "K1-fwd on skewed domains")
    return max(errs.values())


def drop_kw(rate):
    return dict(train=True, drop_rate=rate, seed=DROP_SEED,
                block_b=DROP_TILE)


# the small request of the forwards' timing, beside the full batch
SMALL_BATCH = 512


def k1_fwd_ms(dev, B, units=UNITS2):
    """K1-fwd at batch ``B`` at the AliCCP sota widths (F=19, d=32, 4
    heads, QK, 4 meta rows, MetaNets of ``units``; no dropout, as in
    serving): (its CUDA-event ms with the calls queued ahead,
    :func:`queued_ms`; the host's ms to queue a call)."""
    from satrans_torch.nn import initializers as init
    from satrans_torch.ops import meta_block, prng
    F = 19
    gen, layer, table = test_layer(dev, SEED + 70, units)
    x = init.normal(gen, (B, F, 32), 1.0)
    dom = torch.randint(0, 4, (B,), generator=gen, device=dev)
    ops, cfg = meta_block.pack_operands(x, layer, shared(table), dom,
                                        meta_units=list(units), head_num=4)
    ops = [t if t is None else t.detach() for t in ops]
    kargs = prng.kernel_args(False, 0.0, 0, DROP_TILE, F)
    with torch.no_grad():
        run = functools.partial(meta_block.launch_fwd, *ops, cfg, kargs)
        return queued_ms(run), host_ms(run)


def k7_fwd_ms(dev, B, units=UNITS2):
    """K7-fwd on the AliCCP multicol dispatch of a batch of ``B``
    (:func:`multicol_dispatch`; F=19, QK, no dropout) with the plan's
    tile_count, as the model calls it: (its CUDA-event ms with the calls
    queued ahead, the host's ms to queue a call, the slots)."""
    from satrans_torch.nn import initializers as init, metanet
    from satrans_torch.ops import dispatch, meta_block, prng, tiled_meta
    F = 19
    gen, layer, _ = test_layer(dev, SEED + 71, units)
    plan = multicol_dispatch(dev, gen, B)
    table = init.normal(gen, (MULTICOL_ROWS, metanet.param_size(units)),
                        0.1)[plan.tile_dom.long()]
    x = dispatch.scatter(init.normal(gen, (B, F, 32), 1.0), plan)
    weights, cfg = meta_block.pack_weights(layer, shared(table),
                                           meta_units=list(units),
                                           head_num=4)
    weights = [t if t is None else t.detach() for t in weights]
    kargs = prng.kernel_args(False, 0.0, 0, MULTICOL_TILE, F)
    with torch.no_grad():
        run = functools.partial(tiled_meta.launch_fwd, x, *weights, cfg,
                                kargs, MULTICOL_TILE,
                                tile_count=plan.tile_count)
        return queued_ms(run), host_ms(run), plan.n_slots


def fwd_stash_gap(y, y_stash, what):
    """K1-fwd's (K7-fwd's) y against K1-stash's (K7-stash's) on the same
    inputs and masks: the same instructions compute both, so bit for bit
    is expected; a difference is reported and held to KERNEL_TOL.  Returns
    (bit-identical, max_abs_diff)."""
    same = torch.equal(y, y_stash)
    gap = (y - y_stash).abs().max().item()
    check(same or torch.allclose(y, y_stash, **KERNEL_TOL),
          f"{what}: the no-stash y differs from the stash's by {gap}")
    return same, gap


def _tile_body(mangled: str):
    """The JSON name of a tile body's mangled kernel name (``_3mat`` for a
    3-matrix MetaNet; K6-bwd's body ``gate_block_bwd``, ``_bilinear`` for
    the bilinear map; K6-fwd's ``gate_block_fwd`` likewise), or None for
    another kernel."""
    for kernel, name in (("gate_stash_bwd_kernel", "gate_block_bwd"),
                         ("gate_block_fwd_kernel", "gate_block_fwd")):
        if kernel in mangled:
            return name + ("_bilinear" if re.findall(r"Lb(\d)E", mangled)
                           == ["1"] else "")
    for (kernel, mode, walk), name in TILE_BODIES.items():
        if kernel in mangled:
            ints = list(map(int, re.findall(r"Li(\d+)E", mangled)))
            d, h, h2, heads, m = ints[:5]
            w = ints[5] if len(ints) > 5 else int(
                re.findall(r"Lb(\d)E", mangled) == ["1"])
            if m == mode and w == walk:
                return name + ("_3mat" if h2 else "")
    return None


def tile_body_report():
    """Each tile body's registers and spills (ptxas -v, from the build),
    its dynamic shared memory at F = 19 and 15, and the HMMA (tensor-core
    mma) instructions in its SASS (cuobjdump -sass of the built library).
    Fails if a body has none.  Returns the fields by JSON name."""
    from pathlib import Path
    from satrans_torch.ops import _build, gate_block, meta_block
    import ctypes
    report = {}
    for src, shape in (("meta_block_fwd", (32, 64, 0, 4)),
                       ("meta_block_fwd", (32, 64, 64, 4)),
                       ("meta_block_bwd", (32, 64, 0, 4)),
                       ("meta_block_bwd", (32, 64, 64, 4)),
                       ("gate_block_bwd", (32, 4)),
                       ("gate_block_fwd", (32, 4))):
        body = None
        for ln in _build.log(src, shape).splitlines():
            if "Compiling entry function" in ln or \
                    "Function properties for" in ln:
                body = _tile_body(ln)
            elif body and (m := re.search(r"Used (\d+) registers", ln)):
                report.setdefault(body, {})["registers"] = int(m[1])
            elif body and (m := re.search(
                    r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                    ln)):
                report.setdefault(body, {}).update(
                    spill_store_bytes=int(m[1]), spill_load_bytes=int(m[2]))
        lib = _build._target(src, shape)[1]
        sass = subprocess.run(
            [str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass",
             str(lib)], capture_output=True, text=True, check=True,
            timeout=300).stdout
        for part in sass.split("Function : ")[1:]:
            body = _tile_body(part.split()[0])
            if body:
                lines = part.splitlines()
                report.setdefault(body, {}).update(
                    sass_hmma=sum("HMMA" in ln for ln in lines),
                    sass_instructions=sum(
                        bool(re.match(r"\s*/\*[0-9a-f]{4,}\*/", ln))
                        for ln in lines))
    def fwd_smem(h2, F, mode):
        return meta_block.kernel_fn(
            "meta_block_fwd", "satrans_meta_block_fwd_stash_smem",
            [ctypes.c_int] * 6, shape=(32, 64, h2, 4))(32, 64, h2, 4, F, mode)

    def bwd_smem(h2, F):
        return meta_block.kernel_fn(
            "meta_block_bwd", "satrans_meta_block_bwd_stash_smem",
            [ctypes.c_int] * 5, shape=(32, 64, h2, 4))(32, 64, h2, 4, F)

    gate_smem = meta_block.kernel_fn(
        "gate_block_bwd", "satrans_gate_block_bwd_smem", [ctypes.c_int] * 5)
    bodies = [(name + suffix, {F: (fwd_smem(h2, F, mode)
                                   if "fwd" in kernel else bwd_smem(h2, F))
                               for F in (19, 15)})
              for (kernel, mode, _), name in TILE_BODIES.items()
              for h2, suffix in ((0, ""), (64, "_3mat"))]
    # K6-bwd's body with the 4-row tables of the gate phase
    bodies += [(name, {F: gate_smem(32, 4, 4, bilinear, F)
                       for F in (19, 15)})
               for bilinear, name in ((0, "gate_block_bwd"),
                                      (1, "gate_block_bwd_bilinear"))]
    # K6-fwd's body with those tables (its layout does not depend on F)
    # and the blocks an SM the card runs it at
    fwd_gate = [ctypes.c_int] * 4
    gate_fwd_smem = gate_block.kernel_fn(
        "gate_block_fwd", "satrans_gate_block_fwd_smem", fwd_gate)
    gate_fwd_occ = gate_block.kernel_fn(
        "gate_block_fwd", "satrans_gate_block_fwd_blocks_per_sm", fwd_gate)
    for bilinear, name in ((0, "gate_block_fwd"),
                           (1, "gate_block_fwd_bilinear")):
        bodies.append((name, {F: gate_fwd_smem(32, 4, 4, bilinear)
                              for F in (19, 15)}))
        report.setdefault(name, {})["blocks_per_sm"] = gate_fwd_occ(
            32, 4, 4, bilinear)
    for name, smem in bodies:
        r = report.setdefault(name, {})
        r["smem_bytes"] = smem
        print(f"tile body {name}: {r.get('registers')} registers, spill "
              f"stores {r.get('spill_store_bytes')} B and loads "
              f"{r.get('spill_load_bytes')} B, dynamic shared memory "
              f"{smem[19]} B at F=19 and {smem[15]} B at F=15, "
              f"{r.get('sass_hmma')} HMMA instructions in its SASS of "
              f"{r.get('sass_instructions')}"
              + (f", {r['blocks_per_sm']} blocks an SM"
                 if "blocks_per_sm" in r else ""), flush=True)
        check(r.get("sass_hmma", 0) > 0 and "registers" in r,
              f"the tile body {name} has no tensor-core instruction in its "
              f"SASS, or no ptxas line: {r}")
    return report


def kernel_phase(dev):
    """K1-fwd, K1-stash and K1-stash light against the plain version at
    full width, K1-fwd's y against K1-stash's (:func:`fwd_stash_gap`),
    K1-fwd timed at SMALL_BATCH beside the full batch, and the keep share
    of every dropout site.  Returns the JSON fields measured, by
    kernel."""
    from satrans_torch.nn import initializers as init
    from satrans_torch.ops import meta_block, prng

    F, d, h, heads, rows = 19, 32, 64, 4, 4
    units = [d, h, d]
    gen, layer, table = test_layer(dev, SEED)
    tables = {"Q": table, "K": table}
    worst = {"fwd": 0.0, "stash": 0.0, "light": 0.0}
    out = {}
    names = ("y", "qkv", "uq", "uk", "s", "o")
    light_names = ("y", "qkv", "uq", "uk", "o")
    fwd_gaps = []  # K1-fwd's y against K1-stash's: (bit-identical, diff)
    for B in (BATCH, BATCH - 2):
        x = init.normal(gen, (B, F, d), 1.0)
        dom = torch.randint(0, rows, (B,), generator=gen, device=dev)
        for mode in ("QK", "Query"):
            for relu_out in (False, True):
                kw = dict(meta_units=units, head_num=heads, mode=mode,
                          relu_out=relu_out)
                for rate in (0.0, DROP_RATE) if B == BATCH else (0.0,):
                    drop = drop_kw(rate)
                    masks = meta_block.layer_masks(x, head_num=heads,
                                                   mode=mode, **drop)
                    ops, cfg = meta_block.pack_operands(x, layer, tables,
                                                        dom, **kw)
                    kargs = prng.kernel_args(True, rate, DROP_SEED,
                                             DROP_TILE, F)
                    res = {}
                    with torch.no_grad():
                        y = meta_block.fused_meta_layer(x, layer, tables,
                                                        dom, **kw, **drop)
                        st = meta_block.launch_fwd(*ops, cfg, kargs,
                                                   stash="full")
                        lt = meta_block.launch_fwd(*ops, cfg, kargs,
                                                   stash="light")
                        ref = meta_block.meta_layer_reference(
                            x, layer, tables, dom, **kw, masks=masks,
                            residuals=res)
                    torch.cuda.synchronize()
                    want = (ref, *(res[n] for n in names[1:]))
                    errs = {n: (g - w).abs().max().item()
                            for n, g, w in zip(names, st, want)}
                    light_want = dict(zip(names, want))
                    light_errs = {n: (g - light_want[n]).abs().max().item()
                                  for n, g in zip(light_names, lt)}
                    err = (y - ref).abs().max().item()
                    worst["fwd"] = max(worst["fwd"], err)
                    worst["stash"] = max(worst["stash"], *errs.values())
                    worst["light"] = max(worst["light"],
                                         *light_errs.values())
                    fwd_gaps.append(fwd_stash_gap(
                        y, st[0], f"K1-fwd (B={B} mode={mode} relu_out="
                        f"{relu_out} dropout={rate})"))
                    line = (f"kernel meta_block_fwd B={B} mode={mode} "
                            f"relu_out={relu_out} dropout={rate}: "
                            f"max_abs_err={err:.3e}, y bit-identical to "
                            f"K1-stash's: {fwd_gaps[-1][0]} (max_abs_diff "
                            f"{fwd_gaps[-1][1]:.3e}); stash max_abs_err "
                            + " ".join(f"{n} {e:.3e}"
                                       for n, e in errs.items())
                            + "; light stash "
                            + " ".join(f"{n} {e:.3e}"
                                       for n, e in light_errs.items()))
                    if B == BATCH and mode == "QK" and not relu_out:
                        # the serving (rate 0) and training configurations
                        with torch.no_grad():
                            k_ms = time_ms(lambda: meta_block.launch_fwd(
                                *ops, cfg, kargs), iters=50)
                            s_ms = time_ms(lambda: meta_block.launch_fwd(
                                *ops, cfg, kargs, stash="full"), iters=50)
                            l_ms = time_ms(lambda: meta_block.launch_fwd(
                                *ops, cfg, kargs, stash="light"), iters=50)
                            p_ms = time_ms(
                                lambda: meta_block.meta_layer_reference(
                                    x, layer, tables, dom, **kw,
                                    masks=masks), iters=10)
                        a = ("Q" in mode, "K" in mode)
                        b_ms, b_by = meta_layer_bound_ms(B, F, d, h, heads,
                                                         rows, *a)
                        cc_ms = meta_layer_bound_ms(B, F, d, h, heads, rows,
                                                    *a, tensor_cores=False)[0]
                        sb_ms, sb_by = meta_layer_bound_ms(
                            B, F, d, h, heads, rows, *a, stash="full")
                        line += (f"; K1-fwd kernel_ms={k_ms:.4f} K1-stash "
                                 f"kernel_ms={s_ms:.4f} K1-stash light "
                                 f"kernel_ms={l_ms:.4f} plain_ms={p_ms:.4f} "
                                 f"bound_ms={b_ms:.4f} ({b_by}; every "
                                 f"product on the CUDA cores {cc_ms:.4f}), "
                                 f"stash {sb_ms:.4f} ({sb_by})")
                        out[("fwd", rate)] = dict(ms=k_ms, plain_ms=p_ms,
                                                  bound_ms=b_ms, bound_by=b_by,
                                                  cuda_core_bound_ms=cc_ms)
                        out[("stash", rate)] = dict(ms=s_ms, plain_ms=p_ms,
                                                    bound_ms=sb_ms,
                                                    bound_by=sb_by)
                        out[("light", rate)] = dict(ms=l_ms)
                    print(line, flush=True)
                    tol = KERNEL_TOL
                    check(bool(torch.isfinite(y).all()) and torch.allclose(
                        y, ref, **tol), f"K1-fwd disagrees with its plain "
                        f"version (B={B} mode={mode} relu_out={relu_out} "
                        f"dropout={rate}, max_abs_err={err}, tolerance {tol})")
                    for n, g, w in zip(names, st, want):
                        check(bool(torch.isfinite(g).all())
                              and torch.allclose(g, w, **tol),
                              f"K1-stash's {n} disagrees with the plain "
                              f"version's (B={B} mode={mode} relu_out="
                              f"{relu_out} dropout={rate}, max_abs_err "
                              f"{errs[n]}, tolerance {tol})")
                    check(len(lt) == len(light_names),
                          f"K1-stash light returned {len(lt)} tensors")
                    for n, g in zip(light_names, lt):
                        check(bool(torch.isfinite(g).all())
                              and torch.allclose(g, light_want[n], **tol),
                              f"K1-stash light's {n} disagrees with the "
                              f"plain version's (B={B} mode={mode} "
                              f"relu_out={relu_out} dropout={rate}, "
                              f"max_abs_err {light_errs[n]}, tolerance "
                              f"{tol})")
    small_ms, small_host = k1_fwd_ms(dev, SMALL_BATCH)
    same = sum(g[0] for g in fwd_gaps)
    print(f"kernel meta_block_fwd: y bit-identical to K1-stash's in {same} "
          f"of {len(fwd_gaps)} cases (largest difference "
          f"{max(g[1] for g in fwd_gaps):.3e}); B={SMALL_BATCH} kernel_ms="
          f"{small_ms:.4f} (the host queues a call in {small_host:.4f} ms)",
          flush=True)
    clamp_err = clamp_forward_case(dev)
    worst["fwd"] = max(worst["fwd"], clamp_err)
    worst["stash"] = max(worst["stash"], clamp_err)
    skew_err = skewed_forward_case(dev)
    worst["stash"] = max(worst["stash"], skew_err)
    worst["light"] = max(worst["light"], skew_err)
    # the keep share of every site at the AliCCP shape, on the card
    masks = prng.dropout_masks(DROP_SEED, BATCH, F, d, heads, DROP_TILE,
                               DROP_RATE, True, True, dev)
    shares = {n: (m > 0).double().mean().item()
              for n, m in zip(("yq", "yk", "s", "z"), masks)}
    print(f"dropout keep share at rate {DROP_RATE}, B={BATCH}: " + ", ".join(
        f"{n} {v:.5f}" for n, v in shares.items()), flush=True)
    check(all(abs(v - (1 - DROP_RATE)) <= KEEP_SHARE_TOL
              for v in shares.values()),
          f"a dropout site's keep share is off 0.9 by more than "
          f"{KEEP_SHARE_TOL}: {shares}")
    return dict(fwd=dict(max_abs_err=worst["fwd"], **out[("fwd", 0.0)],
                         dropout_ms=out[("fwd", DROP_RATE)]["ms"],
                         small_batch_ms=small_ms,
                         bit_identical_to_stash=f"{same} of {len(fwd_gaps)}",
                         max_abs_diff_vs_stash=max(g[1] for g in fwd_gaps)),
                stash=dict(max_abs_err=worst["stash"],
                           **out[("stash", DROP_RATE)],
                           no_dropout_ms=out[("stash", 0.0)]["ms"]),
                light=dict(max_abs_err=worst["light"],
                           aliccp_ms=out[("light", DROP_RATE)]["ms"]))


def kink_free(g, x, layer, tables, dom, masks, **kw):
    """``g`` with zero rows for the examples whose relu inputs (the
    MetaNets' hidden layers, and the output projection under relu_out) lie
    within 1e-6 of 0: float32 rounding may put such an input on either
    side of the kink, where the gradient jumps, and the kernel and the
    plain version would then differ by the jump.  Returns (g, the count
    of examples zeroed)."""
    from satrans_torch.nn import metanet
    from satrans_torch.ops import meta_block
    res = {}
    with torch.no_grad():
        meta_block.meta_layer_reference(x, layer, tables, dom, **kw,
                                        masks=masks, residuals=res)
        d = x.shape[-1]
        pre = []  # every hidden layer of the applied MetaNets
        for i, p in enumerate("QK"):
            if p not in kw["mode"]:
                continue
            h = res["qkv"][..., i * d:(i + 1) * d]
            for w in metanet.slice_weights(tables[p],
                                           kw["meta_units"])[:-1]:
                h = torch.einsum("bfi,bio->bfo", h, w[dom.long()])
                pre.append(h)
                h = torch.relu(h)
        if kw["relu_out"]:
            pre.append(res["o"] @ layer.wout)
        near = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
        for t in pre:
            near |= (t.abs() < 1e-6).flatten(1).any(1)
    return g.masked_fill(near[:, None, None], 0.0), int(near.sum())


def shared(table):
    """The Q and K tables of a non-'pos' layer: one tensor."""
    return {"Q": table, "K": table}


def layer_grads(fn, x, layer, tables, dom, g, **kw):
    """Gradients of sum(fn(...) * g) by name: x, the tables ('table' where
    Q and K share one, else 'table.Q' and 'table.K'), the layer's
    parameters (v_meta, never applied, has none)."""
    x = x.detach().requires_grad_(True)
    if tables["K"] is tables["Q"]:
        named = {"table": tables["Q"].detach().requires_grad_(True)}
        tabs = shared(named["table"])
    else:
        named = {f"table.{k}": tables[k].detach().requires_grad_(True)
                 for k in "QK"}
        tabs = {k: named[f"table.{k}"] for k in "QK"}
    params = dict(layer.named_parameters())
    y = fn(x, layer, tabs, dom, **kw)
    names = ["x", *named, *params]
    got = torch.autograd.grad((y * g).sum(),
                              [x, *named.values(), *params.values()],
                              allow_unused=True)
    return {n: gr for n, gr in zip(names, got) if gr is not None}


def clamp_backward_case(dev):
    """The three K1 backwards against autograd of the clamped plain layer
    where
    a share of the logits passes 60 (B=8192, QK, dropout 0.1; the clamp
    passes the gradient straight through).  Returns the worst error by
    backward."""
    from satrans_torch.nn import initializers as init
    from satrans_torch.ops import meta_block
    F, d, heads, rows = 19, 32, 4, 4
    gen, layer, table = hot_layer(dev, SEED + 5)
    x = init.normal(gen, (BATCH, F, d), 1.0)
    g = init.normal(gen, (BATCH, F, d), 1.0)
    dom = torch.randint(0, rows, (BATCH,), generator=gen, device=dev)
    kw = dict(meta_units=[d, 64, d], head_num=heads, mode="QK",
              relu_out=False)
    drop = drop_kw(DROP_RATE)
    masks = meta_block.layer_masks(x, head_num=heads, mode="QK", **drop)
    g, kinks = kink_free(g, x, layer, shared(table), dom, masks, **kw)
    want = layer_grads(meta_block.meta_layer_reference, x, layer,
                       shared(table), dom, g, **kw, masks=masks)
    share = logit_share_past_clamp(x, layer, table, dom, **kw)
    out = {}
    for bwd in meta_block.BWD_MODES:
        got = layer_grads(meta_block.fused_meta_layer, x, layer,
                          shared(table), dom, g, **kw, **drop, bwd=bwd)
        torch.cuda.synchronize()
        errs = grad_errors(got, want)
        out[bwd] = max(errs.values())
        print(f"kernel meta_block_bwd ({bwd}), logits past the clamp "
              f"(share {share:.4f}), B={BATCH} QK dropout={DROP_RATE}: "
              f"max_abs_err={out[bwd]:.3e} (worst {max(errs, key=errs.get)}"
              f"; {kinks} examples at a kink left out)", flush=True)
    check(share > 0.01, f"the clamp case does not pass 60 (share {share})")
    return out


def skewed_backward_case(dev):
    """The three K1 backwards against autograd of the plain layer on a
    skewed domain mix (:func:`skewed_dom`; B=8192, QK, dropout 0.1), each
    gradient within GRAD_RTOL/GRAD_ATOL; K1-bwd-stash twice on the same
    inputs gives the same bits.  Returns the worst error by backward."""
    from satrans_torch.nn import initializers as init
    from satrans_torch.ops import meta_block, prng
    F, d, heads = 19, 32, 4
    gen, layer, table = test_layer(dev, SEED + 7)
    x = init.normal(gen, (BATCH, F, d), 1.0)
    g = init.normal(gen, (BATCH, F, d), 1.0)
    dom = skewed_dom(gen, BATCH, dev)
    kw = dict(meta_units=[d, 64, d], head_num=heads, mode="QK",
              relu_out=False)
    drop = drop_kw(DROP_RATE)
    masks = meta_block.layer_masks(x, head_num=heads, mode="QK", **drop)
    g, kinks = kink_free(g, x, layer, shared(table), dom, masks, **kw)
    want = layer_grads(meta_block.meta_layer_reference, x, layer,
                       shared(table), dom, g, **kw, masks=masks)
    out = {}
    for bwd in meta_block.BWD_MODES:
        got = layer_grads(meta_block.fused_meta_layer, x, layer,
                          shared(table), dom, g, **kw, **drop, bwd=bwd)
        torch.cuda.synchronize()
        errs = grad_errors(got, want)
        out[bwd] = max(errs.values())
        print(f"kernel meta_block_bwd ({bwd}), skewed domains, B={BATCH} QK "
              f"dropout={DROP_RATE}: max_abs_err={out[bwd]:.3e} (worst "
              f"{max(errs, key=errs.get)}; {kinks} examples at a kink left "
              f"out)", flush=True)
    ops, cfg = meta_block.pack_operands(x, layer, shared(table), dom, **kw)
    ops = [t if t is None else t.detach() for t in ops]
    kargs = prng.kernel_args(True, DROP_RATE, DROP_SEED, DROP_TILE, F)
    with torch.no_grad():
        res = meta_block.launch_fwd(*ops, cfg, kargs, stash="full")[1:]
        once, again = (meta_block.launch_bwd(g, *ops, cfg, kargs, res=res)
                       for _ in range(2))
    check(all(a is b or torch.equal(a, b) for a, b in zip(once, again)),
          "K1-bwd-stash gives other bits on the same inputs")
    return out


def long_range_backward_case(dev):
    """The weight-gradient sums of a block over a long range of the batch:
    K1-bwd and K1-bwd-stash at B=2000 (F=19, QK, dropout 0.1) on the
    card's grid and on one block (all 38,000 rows in one block's sums),
    and the plain layer in float32 on the card, each against autograd of
    the plain layer in float64 with the same masks: every gradient's error
    over its largest entry.  Each kernel's within GRAD_RTOL of the largest
    entry plus GRAD_ATOL, as the card test of forced grids."""
    from satrans_torch.nn import initializers as init
    from satrans_torch.ops import meta_block
    F, d, heads, rows, B = 19, 32, 4, 4, 2000
    gen, layer, table = test_layer(dev, SEED + 8)
    x = init.normal(gen, (B, F, d), 1.0)
    g = init.normal(gen, (B, F, d), 1.0)
    dom = torch.randint(0, rows, (B,), generator=gen, device=dev)
    kw = dict(meta_units=[d, 64, d], head_num=heads, mode="QK",
              relu_out=False)
    drop = drop_kw(DROP_RATE)
    masks = meta_block.layer_masks(x, head_num=heads, mode="QK", **drop)
    masks64 = tuple(None if m is None else m.double() for m in masks)
    layer64, table64 = copy.deepcopy(layer).double(), table.double()
    g64, kinks = kink_free(g.double(), x.double(), layer64, shared(table64),
                           dom, masks64, **kw)
    g = g64.float()
    want = layer_grads(meta_block.meta_layer_reference, x.double(), layer64,
                       shared(table64), dom, g64, **kw, masks=masks64)

    def report(label, got):
        """Prints the errors; returns the gradients past the tolerance."""
        rel = {n: ((got[n].double() - w).abs().max()
                   / w.abs().max()).item() for n, w in want.items()}
        worst = max(rel, key=rel.get)
        print(f"long range B={B} F={F} QK dropout={DROP_RATE} ({kinks} "
              f"examples at a kink left out), {label}: error over the "
              f"largest entry {rel[worst]:.3e} (worst {worst}; wout "
              f"{rel['wout']:.3e}, wq {rel['wq']:.3e}, table "
              f"{rel['table']:.3e})", flush=True)
        return [f"{label}: {n}" for n, w in want.items()
                if (got[n].double() - w).abs().max().item()
                > GRAD_RTOL * w.abs().max().item() + GRAD_ATOL]

    report("plain layer in float32",
           layer_grads(meta_block.meta_layer_reference, x, layer,
                       shared(table), dom, g, **kw, masks=masks))
    past = []
    card_sms = meta_block.sm_count
    for blocks in (None, 1):
        for bwd in ("recompute", "stash"):
            if blocks:
                meta_block.sm_count = lambda device: blocks
            try:
                got = layer_grads(meta_block.fused_meta_layer, x, layer,
                                  shared(table), dom, g, **kw, **drop,
                                  bwd=bwd)
                torch.cuda.synchronize()
            finally:
                meta_block.sm_count = card_sms
            where = "one block" if blocks else "the card's grid"
            past += report(f"{bwd} on {where}", got)
    check(not past, f"past the float64 layer's tolerance at B={B}: {past}")


def backward_phase(dev):
    """K1-bwd, K1-bwd-stash and K1-bwd-stash light against autograd of the
    plain layer at full width with the same masks, the examples at a relu
    kink given no upstream gradient (:func:`kink_free`).  Returns the JSON
    fields measured, by kernel."""
    from satrans_torch.nn import initializers as init
    from satrans_torch.ops import meta_block, prng

    F, d, h, heads, rows = 19, 32, 64, 4, 4
    units = [d, h, d]
    gen, layer, table = test_layer(dev, SEED + 1)
    worst = dict.fromkeys(meta_block.BWD_MODES, 0.0)
    # the residuals each backward reads, out of K1-stash's
    pick = {"recompute": None, "stash": (0, 1, 2, 3, 4),
            "stash_light": (0, 1, 2, 4)}
    out = {}
    for B in (BATCH, BATCH - 2):
        x = init.normal(gen, (B, F, d), 1.0)
        g_all = init.normal(gen, (B, F, d), 1.0)
        dom = torch.randint(0, rows, (B,), generator=gen, device=dev)
        for mode in ("QK", "Query"):
            for relu_out in (False, True):
                kw = dict(meta_units=units, head_num=heads, mode=mode,
                          relu_out=relu_out)
                for rate in (0.0, DROP_RATE) if B == BATCH else (0.0,):
                    drop = drop_kw(rate)
                    masks = meta_block.layer_masks(x, head_num=heads,
                                                   mode=mode, **drop)
                    g, kinks = kink_free(g_all, x, layer, shared(table),
                                         dom, masks, **kw)
                    want = layer_grads(meta_block.meta_layer_reference, x,
                                       layer, shared(table), dom, g, **kw,
                                       masks=masks)
                    main = B == BATCH and mode == "QK" and not relu_out
                    if main:  # the training configuration
                        xr = x.detach().requires_grad_(True)
                        tr = table.detach().requires_grad_(True)
                        inputs = [xr, tr, *layer.parameters()]
                        y = meta_block.meta_layer_reference(
                            xr, layer, {"Q": tr, "K": tr}, dom, **kw,
                            masks=masks)
                        p_ms = time_ms(lambda: torch.autograd.grad(
                            y, inputs, g, retain_graph=True), iters=5)
                        del y
                        ops, cfg = meta_block.pack_operands(
                            x, layer, {"Q": table, "K": table}, dom, **kw)
                        ops = [t if t is None else t.detach() for t in ops]
                        kargs = prng.kernel_args(True, rate, DROP_SEED,
                                                 DROP_TILE, F)
                        res = meta_block.launch_fwd(*ops, cfg, kargs,
                                                    stash="full")[1:]
                    for bwd in meta_block.BWD_MODES:
                        got = layer_grads(meta_block.fused_meta_layer, x,
                                          layer, shared(table), dom, g, **kw,
                                          **drop, bwd=bwd)
                        torch.cuda.synchronize()
                        errs = grad_errors(got, want)
                        err = max(errs.values())
                        worst[bwd] = max(worst[bwd], err)
                        line = (f"kernel meta_block_bwd ({bwd}) B={B} "
                                f"mode={mode} relu_out={relu_out} dropout="
                                f"{rate}: max_abs_err={err:.3e} (worst "
                                f"{max(errs, key=errs.get)}; {kinks} "
                                f"examples at a kink left out)")
                        if main:
                            r = None if pick[bwd] is None else [
                                res[i] for i in pick[bwd]]
                            k_ms = time_ms(lambda: meta_block.launch_bwd(
                                g, *ops, cfg, kargs, res=r), iters=20)
                            b_ms, b_by = meta_layer_bwd_bound_ms(
                                B, F, d, h, heads, rows, "Q" in mode,
                                "K" in mode, stash={"stash": "full",
                                                    "stash_light": "light"}
                                .get(bwd))
                            line += (f" kernel_ms={k_ms:.4f} plain_ms="
                                     f"{p_ms:.4f} bound_ms={b_ms:.4f} "
                                     f"({b_by})")
                            out[(bwd, rate)] = dict(ms=k_ms, plain_ms=p_ms,
                                                    bound_ms=b_ms,
                                                    bound_by=b_by)
                        print(line, flush=True)
                    if main:
                        # K1-bwd against K1-bwd-stash on the same masks
                        rec, stf = (meta_block.launch_bwd(
                            g, *ops, cfg, kargs, res=r) for r in (None, res))
                        torch.cuda.synchronize()
                        gap = max((a - b).abs().max().item()
                                  / b.abs().max().item()
                                  for a, b in zip(rec, stf) if b is not None)
                        print(f"K1-bwd vs K1-bwd-stash dropout={rate}: "
                              f"{gap:.3e} of a gradient's largest entry",
                              flush=True)
                        check(gap <= STASH_RECOMPUTE_RTOL, f"K1-bwd differs "
                              f"from K1-bwd-stash on the same masks by {gap} "
                              f"of a gradient's largest entry")
                        del res, rec, stf
    for case in (clamp_backward_case, skewed_backward_case):
        for bwd, err in case(dev).items():
            worst[bwd] = max(worst[bwd], err)
    long_range_backward_case(dev)
    return {bwd: dict(max_abs_err=worst[bwd], **out[(bwd, DROP_RATE)],
                      no_dropout_ms=out[(bwd, 0.0)]["ms"])
            for bwd in meta_block.BWD_MODES}


def device_profile(label, run, ref_ms, card, top=12):
    """Device time by kernel over one ``run()`` (torch.profiler), and the
    device's busy share of its wall time, with the profiler on and against
    ``ref_ms``, the same work's time without it.  Returns the busy ms, or
    None where the profiler saw no device time."""
    from satrans_torch.ops import profiling
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    ops = profiling.device_ops(prof)
    if not ops:
        print(f"profile: {label}: the profiler saw no device time: not "
              "measured")
        return None
    busy_ms = sum(ms for _, ms, _ in ops)
    print(f"profile [{card}]: {label}: device busy {busy_ms:.3f} ms; wall "
          f"{wall_ms:.3f} ms with the profiler ({100 * busy_ms / wall_ms:.1f}"
          f" % busy), {ref_ms:.3f} ms without it "
          f"({100 * busy_ms / ref_ms:.1f} % busy)", flush=True)
    for name, ms, n in ops[:top]:
        print(f"profile: {ms:9.3f} ms {n:5d}x  {name[:100]}")
    return busy_ms


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

    zero_counts()
    t0 = time.perf_counter()
    scores = [pred(x) for x in reqs]
    wall = time.perf_counter() - t0
    launches = meta_block.launches
    check(k1_counts() == (LAYERS * batches,) + NO_K1[1:],
          f"serving launched {k1_counts()} ({', '.join(K1_COUNTS)}), want "
          f"K1-fwd only, {LAYERS} layers x {batches} batches")
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

    plain_model = SATrans(layout, ["301"], [3], route="plain", **kw)
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


def training_model(dev, bank_update, variant="metanet", units=UNITS2,
                   seed=SEED):
    """The AliCCP sota SATrans of phases 5, 7, 9, 13 and 21 (dropout 0.1,
    the default N(0, 1e-4) embeddings drawn from ``seed``; the layers of
    ``variant``, MetaNets of ``units``) and its compiled Trainer (Adam, lr
    0.005)."""
    from satrans_torch.data import aliccp
    from satrans_torch.features import FeatureLayout
    from satrans_torch.models import SATrans
    from satrans_torch.train import Trainer
    model = SATrans(FeatureLayout(aliccp.sota_columns(32)), ["301"], [3],
                    domain_att_layer_num=LAYERS, att_head_num=4,
                    meta_mode="QK", meta_dnn_hidden_units=units[1:],
                    dropout_rate=DROP_RATE, seed=seed, variant=variant,
                    device=dev)
    trainer = Trainer(model, seed=SEED, device=dev)
    trainer.compile(learning_rate=TRAIN_LR, bank_update=bank_update)
    return model, trainer


def training_data():
    """bench.py's synthetic batch: ids uniform in [1, DATA_MAX], labels
    0/1.  Returns (ids, labels)."""
    from satrans_torch.data import aliccp
    rng = np.random.default_rng(SEED)
    x = {name: rng.integers(1, aliccp.DATA_MAX[name] + 1, TRAIN_ROWS)
         for name in aliccp.SPARSE_FEATURES}
    y = rng.integers(0, 2, TRAIN_ROWS).astype(np.float32)
    return x, y


def zero_counts():
    """Every kernel's launch count to 0."""
    from satrans_torch.ops import eqgemm, gate_block, gather, lazy_tail, \
        meta_block, scatter, tiled_meta
    for name in K1_COUNTS:
        setattr(meta_block, name, 0)
    meta_block.scores_launches = 0
    for name in K7_COUNTS:
        setattr(tiled_meta, name, 0)
    from satrans_torch.bench import gather_probe, scatter_probe
    for mod in (gather, scatter, eqgemm, lazy_tail, gather_probe,
                scatter_probe):
        mod.launches = 0
    gate_block.launches = gate_block.bwd_launches = 0


def k6_counts():
    from satrans_torch.ops import gate_block
    return gate_block.launches, gate_block.bwd_launches


def k1_counts():
    from satrans_torch.ops import meta_block
    return tuple(getattr(meta_block, name) for name in K1_COUNTS)


def k7_counts():
    from satrans_torch.ops import tiled_meta
    return tuple(getattr(tiled_meta, name) for name in K7_COUNTS)


def timed_fit(trainer, x, y, steps=TRAIN_STEPS):
    """One epoch of ``fit`` (``steps`` steps) after the launch counts are
    set to 0: returns (seconds, per-step data losses, the epoch loss).
    Fails unless the loss is finite at every step and falls (the mean
    per-example loss of the last 4 full steps below that of the first
    4)."""
    from satrans_torch.train import callbacks
    losses = []

    class Record(callbacks.Callback):
        def on_batch_end(self, step, logs=None):
            losses.append(logs["loss"])

    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    hist = trainer.fit(x, y, batch_size=BATCH, epochs=1, verbose=0,
                       callbacks=[Record()])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_loss = torch.stack(losses).cpu().numpy()
    check(len(step_loss) == steps and bool(np.isfinite(
        step_loss).all()) and np.isfinite(hist.history["loss"][0]),
          "training loss not finite at every step")
    per_ex = step_loss[:-1] / BATCH
    check(per_ex[-4:].mean() < per_ex[:4].mean(),
          f"training loss did not fall: {per_ex.tolist()}")
    return wall, step_loss, hist.history["loss"][0]


def training_phase(dev, card):
    """Train SATrans at the AliCCP sota width through the kernels, at
    dropout 0.1, once with each backward (SATRANS_BWD).  Returns the
    layer kernels' launch counts of each arm's timed fit and of the
    evaluation."""
    launched = {}
    for bwd in ("stash", "recompute"):
        os.environ["SATRANS_BWD"] = bwd
        trainer, launched[bwd] = training_arm(dev, card, bwd)
        if bwd == "stash":
            launched["eval"] = eval_check(trainer, card)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    # the two backwards on one trainer, in turns: the host's clock spreads
    # from arm to arm, so stash and recompute are compared here
    model, trainer = training_model(dev, "dense")
    x, y = training_data()
    batch, yb, wb = staged_batch(trainer, x, y)
    for bwd in ("stash", "recompute", "recompute", "stash"):
        os.environ["SATRANS_BWD"] = bwd
        step_ms = time_ms(lambda: trainer.train_step(batch, yb, wb), iters=10)
        queue_ms = host_ms(lambda: trainer.train_step(batch, yb, wb))
        print(f"train in turns, {bwd} [{card}]: train_step on a staged "
              f"batch {step_ms:.3f} ms/step; the host queues a step in "
              f"{queue_ms:.3f} ms", flush=True)
    os.environ.pop("SATRANS_BWD")
    del model, trainer, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launched


def staged_batch(trainer, x, y, bsz=BATCH):
    """The first training batch of ``bsz`` on the card: (batch, labels,
    weights)."""
    data = trainer.layout.batch_from_dict(x)
    batch = trainer._device_batch({k: v[:bsz] for k, v in data.items()})
    yb, wb = trainer._device_batch({"y": y[:bsz],
                                    "w": np.ones(bsz, np.float32)}).values()
    return batch, yb, wb


def training_arm(dev, card, bwd):
    """One dense training arm: one step's gradients kernel vs plain path,
    24 steps of ``fit``, the staged step and its profile.  Returns the
    trainer and the timed fit's K1 launch counts."""
    model, trainer = training_model(dev, "dense")
    x, y = training_data()
    per_step = K1_PAIR[bwd]

    # one step's gradients, kernel path against plain path (the same
    # masks: the layers' fixed seeds)
    batch, yb, wb = staged_batch(trainer, x, y)
    model.train()
    grads = {}
    for use_kernel in (True, False):
        model.route = "kernel" if use_kernel else "plain"
        zero_counts()
        model.zero_grad(set_to_none=True)
        total = trainer.loss_terms(batch, yb, wb)[0]
        total.backward()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(total)), "training loss not finite")
        grads[use_kernel] = {n: p.grad.clone()
                             for n, p in model.named_parameters()}
        want = tuple(LAYERS * c for c in per_step) if use_kernel \
            else NO_K1
        check(k1_counts() == want,
              f"one step ({bwd}) launched {k1_counts()} "
              f"({', '.join(K1_COUNTS)}), want {want}")
    model.route = "kernel"
    errs = grad_errors(grads[True], grads[False])
    worst = max(errs, key=errs.get)
    print(f"train {bwd} [{card}]: one step's gradients at dropout "
          f"{DROP_RATE}, kernel path vs plain path: max_abs_err "
          f"{errs[worst]:.3e} ({worst}); loss {total.item() / BATCH:.6f} "
          f"per example", flush=True)
    del grads
    model.zero_grad(set_to_none=True)

    trainer.fit({k: v[:2 * BATCH] for k, v in x.items()}, y[:2 * BATCH],
                batch_size=BATCH, verbose=0)  # warmup: two steps
    wall, step_loss, epoch_loss = timed_fit(trainer, x, y)
    launched = k1_counts()
    want = tuple(TRAIN_STEPS * LAYERS * c for c in per_step)
    check(launched == want,
          f"{TRAIN_STEPS} steps ({bwd}) launched {launched} "
          f"({', '.join(K1_COUNTS)}), want {want}")
    per_ex = step_loss[:-1] / BATCH
    print(f"train {bwd} [{card}]: {TRAIN_ROWS} examples in {TRAIN_STEPS} "
          f"steps of {BATCH} (last a tail of {TAIL}) at dropout "
          f"{DROP_RATE}: {wall:.4f}s, {TRAIN_ROWS / wall:.1f} trained "
          f"examples/s, {1e3 * wall / TRAIN_STEPS:.3f} ms/step (host batch "
          f"assembly included); launches {launched}; loss per example step "
          f"1 {per_ex[0]:.6f} step {TRAIN_STEPS - 1} {per_ex[-1]:.6f}; epoch "
          f"loss {epoch_loss:.6f}", flush=True)

    # the step alone on a staged batch: device time without host assembly
    step_ms = time_ms(lambda: trainer.train_step(batch, yb, wb), iters=10)
    queue_ms = host_ms(lambda: trainer.train_step(batch, yb, wb))
    print(f"train {bwd} [{card}]: train_step on a staged batch "
          f"{step_ms:.3f} ms/step, {1e3 * BATCH / step_ms:.1f} examples/s; "
          f"the host queues a step in {queue_ms:.3f} ms", flush=True)
    device_profile(f"{bwd}: one training step of {BATCH} examples",
                   lambda: trainer.train_step(batch, yb, wb), step_ms, card,
                   top=16)
    return trainer, launched


def eval_check(trainer, card):
    """predict and evaluate on 20,000 random examples: finite, and through
    K1-fwd only.  Returns the K1 launch counts."""
    from satrans_torch.data import aliccp
    rng = np.random.default_rng(SEED + 2)
    ev = {name: rng.integers(1, aliccp.DATA_MAX[name] + 1, REQUEST_ROWS)
          for name in aliccp.SPARSE_FEATURES}
    ev_y = rng.integers(0, 2, REQUEST_ROWS).astype(np.float32)
    zero_counts()
    scores = trainer.predict(ev, batch_size=BATCH)
    check(scores.shape == (REQUEST_ROWS,) and bool(np.all(
        np.isfinite(scores))), "predict after training not finite")
    res = trainer.evaluate(ev, ev_y, batch_size=BATCH)
    check(all(np.isfinite(v) for v in res.values()),
          f"evaluate gave {res}")
    launched = k1_counts()
    want = (2 * LAYERS * -(-REQUEST_ROWS // BATCH),) + NO_K1[1:]
    check(launched == want, f"predict and evaluate launched {launched} "
          f"({', '.join(K1_COUNTS)}), want {want}")
    print(f"train [{card}]: evaluate on {REQUEST_ROWS} random examples: "
          + ", ".join(f"{k} {v:.6f}" for k, v in res.items())
          + f"; launches {launched}", flush=True)
    return launched


def bytes_bound_ms(nbytes: float) -> float:
    return 1e3 * nbytes / PEAK_HBM_BYTES


def gather_plan(layout, rng, real: int, dev):
    """The physical row ids one training batch gathers: ids uniform in
    [1, DATA_MAX] as in phase 5, the rows past ``real`` zero ids as in a
    padded tail batch."""
    from satrans_torch import embeddings
    from satrans_torch.data import aliccp
    x = {name: rng.integers(1, aliccp.DATA_MAX[name] + 1, BATCH)
         for name in aliccp.SPARSE_FEATURES}
    sparse = layout.batch_from_dict(x)["sparse"]
    sparse[real:] = 0
    return embeddings.bank_gather_plan(
        layout, {"sparse": torch.from_numpy(sparse).to(dev)},
        embeddings.pack_factor(32))


def bank_kernel_phase(dev, card):
    """K2, K3, K4 and K5 against their plain versions at the AliCCP sota
    shapes, and timed.  Returns the JSON fields measured, by kernel."""
    from satrans_torch import embeddings
    from satrans_torch.data import aliccp
    from satrans_torch.features import FeatureLayout
    from satrans_torch.nn import initializers as init
    from satrans_torch.ops import eqgemm, gather, lazy_tail, scatter
    from satrans_torch.utils import make_generator

    layout = FeatureLayout(aliccp.sota_columns(32))
    rp = embeddings.pack_factor(32)
    width = rp * 32
    rows = -(-layout.small_split(
        embeddings.SMALL_TABLE_THRESHOLD)["large_rows"] // rp)
    rng = np.random.default_rng(SEED + 6)
    ids = gather_plan(layout, rng, BATCH, dev)          # N = 81,920
    tail_ids = gather_plan(layout, rng, TAIL, dev)      # a padded tail
    n = ids.numel()
    fields = n // BATCH
    gen = make_generator(SEED + 6, dev)
    bank = init.normal(gen, (rows, width), 1.0)
    mu = init.normal(gen, (rows, width), 0.01)
    nu = init.normal(gen, (rows, width), 0.01).abs_()
    arrays = (bank, mu, nu)
    print(f"bank kernels: 3 arrays of {rows} x {width} float32 "
          f"({rows * width * 4 / 1e6:.1f} MB each); N = {n} ids of one "
          f"batch's gather plan ({fields} large fields)", flush=True)
    out = {}

    def report(name, err, k_ms, p_ms, lib_ms, b_ms, b_by, what):
        lib = "none" if lib_ms is None else f"{lib_ms:.4f}"
        print(f"kernel {name} [{card}]: {what}: max_abs_err={err:.3e} "
              f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={lib} "
              f"bound_ms={b_ms:.4f} ({b_by})", flush=True)
        out[name] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)

    # K4: out[a][i] = arr[a][ids[i]]
    for idc in (ids, ids[:-3]):
        got = gather.gather_rows(arrays, idc)
        want = gather.gather_rows_reference(arrays, idc)
        torch.cuda.synchronize()
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"gather_rows differs from its plain version (N={idc.numel()})")
    del got, want
    distinct = torch.unique(ids).numel()
    report("gather_rows", 0.0,
           time_ms(lambda: gather.gather_rows(arrays, ids), 50),
           time_ms(lambda: gather.gather_rows_reference(arrays, ids), 50),
           time_ms(lambda: [a.index_select(0, ids) for a in arrays], 50),
           bytes_bound_ms(8 * n + 3 * 4 * width * (distinct + n)), "bytes",
           f"3 arrays, N={n} and {n - 3}, {distinct} distinct rows")

    # K2: arr[a][tgt[i]] = vals[a][i]; duplicate ids carry identical values
    # and every 97th position is the sentinel (dropped)
    tgt = ids.clone()
    tgt[::97] = rows
    cols = torch.arange(width, device=dev, dtype=torch.float32)
    vals = [torch.sin(tgt[:, None].float() * (a + 1) + cols)
            for a in range(3)]
    for m in (n, n - 3):
        got = [a.clone() for a in arrays]
        want = [a.clone() for a in arrays]
        scatter.scatter_rows_set(got, tgt[:m], [v[:m] for v in vals],
                                 drop_oob=True)
        scatter.scatter_rows_set_reference(want, tgt[:m],
                                           [v[:m] for v in vals],
                                           drop_oob=True)
        torch.cuda.synchronize()
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"scatter_rows_set differs from its plain version (N={m})")
    # the bound reads one value row and writes one array row per distinct
    # kept target (duplicates carry the same values), as K4 reads one
    # array row per distinct id
    keep = tgt < rows
    kept, kvals = tgt[keep], [v[keep] for v in vals]
    kept_n, kept_distinct = kept.numel(), torch.unique(kept).numel()
    report("scatter_rows_set", 0.0,
           time_ms(lambda: scatter.scatter_rows_set(got, tgt, vals,
                                                    drop_oob=True), 50),
           time_ms(lambda: scatter.scatter_rows_set_reference(
               want, tgt, vals, drop_oob=True), 50),
           time_ms(lambda: [a.index_put_((kept,), v)
                            for a, v in zip(want, kvals)], 50),
           bytes_bound_ms(8 * n + 3 * 4 * width * 2 * kept_distinct),
           "bytes", f"3 arrays, N={n} and {n - 3}, {n - kept_n} sentinels")
    del got, want, vals, kvals

    # K5: each distinct row once (sorted, duplicates to the sentinel), as
    # the lazy update's equality path gives them
    srt = torch.sort(ids).values
    first = torch.ones_like(srt, dtype=torch.bool)
    first[1:] = srt[1:] != srt[:-1]
    ids_k = torch.where(first, srt, rows)
    g = init.normal(gen, (n, width), 0.01)
    k = torch.randint(0, 9, (n,), device=dev).float()
    dec = (0.9 ** k, 0.999 ** k, (1.0 - 2.0 * 1e-5 * TRAIN_LR) ** (k + 1))
    hyper = (1.0 / (1.0 - 0.9 ** 5), 1.0 / (1.0 - 0.999 ** 5))
    kw = dict(lr=TRAIN_LR, b1=0.9, b2=0.999, eps=1e-8)
    err = 0.0
    for m in (n, n - 3):
        got = [a.clone() for a in arrays]
        want = [a.clone() for a in arrays]
        lazy_tail.lazy_adam_rows(*got, ids_k[:m], g[:m],
                                 *(d[:m] for d in dec), *hyper, **kw)
        lazy_tail.lazy_adam_rows_reference(*want, ids_k[:m], g[:m],
                                           *(d[:m] for d in dec), *hyper,
                                           **kw)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            err = max(err, (a - b).abs().max().item())
            check(bool(torch.isfinite(a).all()) and torch.allclose(
                a, b, **LAZY_TAIL_TOL),
                  f"lazy_adam_rows differs from its plain version (N={m}, "
                  f"max_abs_err {err}, tolerance {LAZY_TAIL_TOL})")
    # the bound reads every id, and the g row, the decays and the three
    # array rows of each touched row only (sentinels skip), and writes
    # the three array rows back
    touched = int(first.sum())
    report("lazy_adam_rows", err,
           time_ms(lambda: lazy_tail.lazy_adam_rows(
               *got, ids_k, g, *dec, *hyper, **kw), 50),
           time_ms(lambda: lazy_tail.lazy_adam_rows_reference(
               *want, ids_k, g, *dec, *hyper, **kw), 20),
           None, bytes_bound_ms(8 * n + (4 * width + 12) * touched
                                + 2 * 3 * 4 * width * touched), "bytes",
           f"N={n} and {n - 3}, {touched} rows touched")
    del got, want, g, arrays, bank, mu, nu
    torch.cuda.empty_cache()

    # K3: per-field duplicate sums at ids [10, 8192], W = 128: the batch,
    # a padded tail, B - 2, an odd B - 1, a field of one id and a field of
    # no duplicate beside the batch's others
    gq = init.normal(gen, (fields, BATCH, width), 1.0)
    one = ids.view(BATCH, fields).t().contiguous()
    one[0] = one[0, 0]
    one[1] = torch.randperm(BATCH, device=dev) * 7 + 1
    err = 0.0
    for plan, b in ((ids, BATCH), (tail_ids, BATCH), (ids, BATCH - 2),
                    (ids, BATCH - 1), (one.t().reshape(-1), BATCH)):
        ids_fb = plan.view(BATCH, fields).t()[:, :b].contiguous()
        gb = gq[:, :b].contiguous()
        got = eqgemm.eqgemm_positions(ids_fb, gb)
        again = eqgemm.eqgemm_positions(ids_fb, gb)
        want = eqgemm.eqgemm_positions_reference(ids_fb, gb)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"eqgemm_positions: two launches "
              f"differ (B={b})")
        e = (got - want).abs().max().item()
        err = max(err, e)
        check(e <= EQGEMM_RTOL * want.abs().max().item(),
              f"eqgemm_positions differs from its plain version by {e} "
              f"(B={b}, largest total {want.abs().max().item()})")
        for f in range(fields):
            order = torch.argsort(ids_fb[f], stable=True)
            srow, sid = got[f][order], ids_fb[f][order]
            same = sid[1:] == sid[:-1]
            check(torch.equal(srow[1:][same], srow[:-1][same]),
                  f"eqgemm_positions: duplicate positions of field {f} "
                  f"differ (B={b})")
        del got, again, want
    # the bound: ids in, g in, s out (the grouping is the kernel's own
    # work: no compare is counted)
    b_ms = bytes_bound_ms(8 * n + 2 * 4 * width * n)
    parts = eqgemm.blocks_a_field(fields, dev)
    timed = {}
    for label, plan in (("batch", ids), ("tail", tail_ids)):
        ids_fb = plan.view(BATCH, fields).t().contiguous()
        runs = [torch.unique_consecutive(torch.sort(r).values,
                                         return_counts=True)[1]
                for r in ids_fb]
        print(f"eqgemm_positions ids ({label}): distinct / longest run a "
              f"field: " + ", ".join(f"{c.numel()}/{int(c.max())}"
                                     for c in runs), flush=True)
        run = functools.partial(eqgemm.eqgemm_positions, ids_fb, gq)
        timed[label] = time_ms(run, 50)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                run()
            torch.cuda.synchronize()
        by_kernel = ", ".join(
            f"{re.search(r'eqgemm_[a-z]+_kernel(<[^>]*>)?', e.key)[0]} "
            f"{e.device_time_total / 5e3:.4f}"
            for e in prof.key_averages()
            if e.device_time_total > 0 and "eqgemm_" in e.key)
        print(f"kernel eqgemm_positions [{card}] ({label}, {parts} grouping "
              f"blocks a field): {timed[label]:.4f} ms, bound {b_ms:.4f} "
              f"ms; device ms by kernel: {by_kernel}", flush=True)
    ids_fb = ids.view(BATCH, fields).t().contiguous()
    report("eqgemm_positions", err, timed["batch"],
           time_ms(lambda: eqgemm.eqgemm_positions_reference(ids_fb, gq), 5),
           None, b_ms, "bytes",
           f"ids [{fields}, {BATCH}] W={width} (also a padded tail, "
           f"B={BATCH - 2}, a field of one id, one of no duplicate)")
    out["eqgemm_positions"].update(tail_ms=timed["tail"],
                                   grouping_blocks=parts)
    return out


def sparse_training_phase(dev, card):
    """Train the phase-5 model (bwd='stash') in each sparse bank mode.
    Returns the launches of every kernel in each arm's timed fit, by
    arm."""
    from satrans_torch.ops import eqgemm, gather, lazy_tail, scatter

    x, y = training_data()
    # fused against dense from one start: every parameter after 3 steps
    first3 = {k: v[:3 * BATCH] for k, v in x.items()}
    params = {}
    for mode in ("dense", "fused"):
        model, trainer = training_model(dev, mode)
        trainer.fit(first3, y[:3 * BATCH], batch_size=BATCH, verbose=0)
        params[mode] = {k: v.detach().clone()
                        for k, v in model.state_dict().items()}
        del model, trainer
    worst = max(((params["fused"][k] - v).abs().max().item(), k)
                for k, v in params["dense"].items())
    for k, v in params["dense"].items():
        f = params["fused"][k]
        bad = ~torch.isclose(f, v, **PARAM_TOL)
        check(not bool(bad.any()),
              f"fused differs from dense after 3 steps in {k}: "
              f"{int(bad.sum())} of {v.numel()} entries outside "
              f"{PARAM_TOL}, max_abs_err {(f - v).abs().max().item():.3e}")
    same = sum(torch.equal(params["fused"][k], v)
               for k, v in params["dense"].items())
    print(f"train fused vs dense [{card}]: every parameter after 3 steps "
          f"within {PARAM_TOL}, {same} of {len(params['dense'])} "
          f"bit-identical; max_abs_err {worst[0]:.3e} ({worst[1]})",
          flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    mods = (gather, scatter, eqgemm, lazy_tail)
    launched = {}
    for arm, mode, tail, per_step in SPARSE_ARMS:
        if tail:
            os.environ["SATRANS_LAZY_TAIL"] = tail
        model, trainer = training_model(dev, mode)
        batch, yb, wb = staged_batch(trainer, x, y)
        trainer.fit({k: v[:2 * BATCH] for k, v in x.items()}, y[:2 * BATCH],
                    batch_size=BATCH, verbose=0)  # warmup: two steps
        wall, step_loss, epoch_loss = timed_fit(trainer, x, y)
        got = (*k1_counts(), *(m.launches for m in mods))
        want = (*(LAYERS * TRAIN_STEPS * c for c in K1_PAIR["stash"]),
                *(c * TRAIN_STEPS for c in per_step))
        check(got == want, f"{arm}: {TRAIN_STEPS} steps launched {got} "
                           f"({', '.join(K1_COUNTS)}, "
                           f"{', '.join(ROW_KERNELS)}), want {want}")
        launched[arm] = dict(zip(K1_NAMES + ROW_NAMES, got))
        per_ex = step_loss[:-1] / BATCH
        print(f"train {arm} [{card}]: {TRAIN_ROWS} examples in "
              f"{TRAIN_STEPS} steps of {BATCH} (last a tail of {TAIL}): "
              f"{wall:.4f}s, {TRAIN_ROWS / wall:.1f} trained examples/s, "
              f"{1e3 * wall / TRAIN_STEPS:.3f} ms/step; launches {got}; "
              f"loss per example step 1 {per_ex[0]:.6f} step "
              f"{TRAIN_STEPS - 1} {per_ex[-1]:.6f}; epoch loss "
              f"{epoch_loss:.6f}", flush=True)
        step_ms = time_ms(lambda: trainer.train_step(batch, yb, wb), iters=10)
        queue_ms = host_ms(lambda: trainer.train_step(batch, yb, wb))
        print(f"train {arm} [{card}]: train_step on a staged batch "
              f"{step_ms:.3f} ms/step, {1e3 * BATCH / step_ms:.1f} "
              f"examples/s; the host queues a step in {queue_ms:.3f} ms",
              flush=True)
        device_profile(f"{arm}: one training step of {BATCH} examples",
                       lambda: trainer.train_step(batch, yb, wb), step_ms,
                       card, top=16)
        os.environ.pop("SATRANS_LAZY_TAIL", None)
        del model, trainer, batch
        gc.collect()
        torch.cuda.empty_cache()
    return launched


def gate_layer_bound_ms(B, F, d, heads, meta_rows, variant, apply_q,
                        apply_k, bwd=False, tensor_cores=True):
    """Least time for K6-fwd, or with ``bwd`` K6-bwd: the work over the
    card's peak for its kind against the bytes over the HBM rate.  The
    forward is x @ Wqkv (2F d 3d), the transform (the gate F d a
    projection, the bilinear map 2F d dh), q k^T and p v (2 x 2F^2 d), o @
    Wout (2F d^2) and LN_o (8F d); the backward recomputes it and adds
    dWout and do (2 x 2F d^2), the attention backward (4 x 2F^2 d), the
    transform's (the gate 3F d a projection, the bilinear map 2 x 2F d dh),
    LN_o's (10F d) and dWqkv and dx (2 x 6F d^2).  K6-fwd and K6-bwd run
    on tile bodies whose products (x Wqkv, o Wout, and the backward's
    dWout, do, dWqkv, dx) are 3xTF32 on the tensor cores, the rest float32
    on the CUDA cores (``tensor_cores`` False: every operation on the CUDA
    cores, as the template body K6-fwd first ran on).  Bytes are x (and g)
    and dom in, y (dx) out, the weights and tables in (and their gradients
    out)."""
    dh = d // heads
    width = d if variant == "gate" else d * dh
    if variant == "gate":
        n = apply_q + apply_k
        fwd_t, bwd_t = n * F * d, n * 3 * F * d
    else:
        fwd_t, bwd_t = 2 * F * d * dh, 4 * F * d * dh
    fwd_mma = 6 * F * d * d + 2 * F * d * d
    fwd = fwd_mma + fwd_t + 4 * F * F * d + 8 * F * d
    weights = 4 * d * d + 2 * d + 2 * meta_rows * width
    if not bwd:
        return _bound(B * fwd, 4 * (2 * B * F * d + B + weights),
                      B * fwd_mma if tensor_cores else 0)
    back_mma = 4 * F * d * d + 12 * F * d * d
    back = back_mma + 8 * F * F * d + bwd_t + 10 * F * d
    mma = fwd_mma + back_mma if tensor_cores else 0
    return _bound(B * (fwd + back), 4 * (3 * B * F * d + B + 2 * weights),
                  B * mma)


def gate_test_layer(dev, seed, variant):
    """A gate or bilinear layer and its 4-row tables (distinct Q and K
    gates), and the generator after them."""
    from satrans_torch.nn import attention, initializers as init
    from satrans_torch.utils import make_generator
    gen = make_generator(seed, dev)
    layer = attention.MetaTransformerLayer(gen, 32, variant=variant)
    names = ("Q", "K") if variant == "gate" else ("bilinear",)
    width = 32 if variant == "gate" else 32 * 8
    return gen, layer, {n: init.normal(gen, (4, width), 0.5)
                        for n in names}


def k6_fwd_ms(dev, B, variant="gate"):
    """K6-fwd at batch ``B`` at the AliCCP sota widths (F=19, d=32, 4
    heads, QK, 4 table rows; no dropout, as in serving): (its CUDA-event
    ms with the calls queued ahead, :func:`queued_ms`; the host's ms to
    queue a call)."""
    from satrans_torch.nn import initializers as init
    from satrans_torch.ops import gate_block, prng
    F = 19
    gen, layer, tables = gate_test_layer(dev, SEED + 72, variant)
    x = init.normal(gen, (B, F, 32), 1.0)
    dom = torch.randint(0, 4, (B,), generator=gen, device=dev)
    ops, cfg = gate_block.pack_operands(x, layer, tables, dom, head_num=4)
    ops = [t.detach() for t in ops]
    kargs = prng.kernel_args(False, 0.0, 0, DROP_TILE, F,
                             pad_mult=gate_block.PAD_FIELDS)
    with torch.no_grad():
        run = functools.partial(gate_block.launch_fwd, *ops, cfg, kargs)
        return queued_ms(run), host_ms(run)


def gate_fwd_cases(dev):
    """K6-fwd against the plain version (KERNEL_TOL), and timed, past the
    gate phase's shapes: the odd B = 8191, F = 20 (the most fields), and
    bilinear maps of 64 table rows (past the staged tables' budget: each
    row's map read from device memory), at dropout 0 and 0.1.  Returns
    the worst error."""
    from satrans_torch.nn import attention, initializers as init
    from satrans_torch.ops import gate_block, prng
    from satrans_torch.utils import make_generator
    worst = 0.0
    for n, (variant, B, F, rows) in enumerate((
            ("gate", BATCH - 1, 19, 4), ("gate", BATCH, 20, 4),
            ("bilinear", BATCH, 20, 4), ("bilinear", BATCH, 19, 64))):
        gen = make_generator(SEED + 80 + n, dev)
        layer = attention.MetaTransformerLayer(gen, 32, variant=variant)
        names = ("Q", "K") if variant == "gate" else ("bilinear",)
        width = 32 if variant == "gate" else 32 * 8
        tables = {k: init.normal(gen, (rows, width), 0.5) for k in names}
        x = init.normal(gen, (B, F, 32), 1.0)
        dom = torch.randint(0, rows, (B,), generator=gen, device=dev)
        kw = dict(head_num=4, mode="QK", relu_out=False)
        for rate in (0.0, DROP_RATE):
            drop = drop_kw(rate)
            masks = gate_block.layer_masks(x, head_num=4, **drop)
            with torch.no_grad():
                y = gate_block.fused_simple_layer(x, layer, tables, dom,
                                                  **kw, **drop)
                ref = gate_block.simple_layer_reference(
                    x, layer, tables, dom, **kw, masks=masks)
            torch.cuda.synchronize()
            err = (y - ref).abs().max().item()
            worst = max(worst, err)
            what = (f"{variant} B={B} F={F} {rows} table rows dropout="
                    f"{rate}")
            check(bool(torch.isfinite(y).all()) and torch.allclose(
                y, ref, **KERNEL_TOL), f"K6-fwd disagrees with its plain "
                f"version ({what}, max_abs_err={err})")
            ops, cfg = gate_block.pack_operands(x, layer, tables, dom, **kw)
            kargs = prng.kernel_args(True, rate, DROP_SEED, DROP_TILE, F,
                                     pad_mult=gate_block.PAD_FIELDS)
            ops = [t.detach() for t in ops]
            with torch.no_grad():
                ms = time_ms(lambda: gate_block.launch_fwd(*ops, cfg, kargs),
                             iters=10)
            print(f"kernel gate_block_fwd {what}: max_abs_err={err:.3e}; "
                  f"kernel_ms={ms:.4f}", flush=True)
    return worst


def gate_grads(fn, x, layer, tables, dom, g, **kw):
    """Gradients of sum(fn(...) * g) by name: x, the tables, the layer's
    parameters (an unread table has none)."""
    x = x.detach().requires_grad_(True)
    tables = {k: t.detach().requires_grad_(True) for k, t in tables.items()}
    params = dict(layer.named_parameters())
    y = fn(x, layer, tables, dom, **kw)
    names = ["x", *(f"table.{k}" for k in tables), *params]
    got = torch.autograd.grad((y * g).sum(),
                              [x, *tables.values(), *params.values()],
                              allow_unused=True)
    return {n: gr for n, gr in zip(names, got) if gr is not None}


def gate_kernel_phase(dev):
    """K6-fwd and K6-bwd against the plain version and its autograd at the
    AliCCP sota widths (B=8192 at dropout 0 and 0.1, the ragged 8190 at
    0): gate in QK and Query modes and bilinear, relu_out off and on,
    every gradient (the examples whose output projection lies within 1e-6
    of the relu kink get no upstream gradient), and timed, K6-fwd also at
    SMALL_BATCH; then :func:`gate_fwd_cases`.  Returns the JSON fields
    measured, by kernel."""
    from satrans_torch.nn import attention, initializers as init
    from satrans_torch.ops import gate_block, prng

    F, d, heads, rows = 19, 32, 4, 4
    worst = {"fwd": 0.0, "bwd": 0.0}
    out = {}
    for n, (variant, mode) in enumerate((("gate", "QK"), ("gate", "Query"),
                                         ("bilinear", "QK"))):
        gen, layer, tables = gate_test_layer(dev, SEED + 10 + n, variant)
        for B in (BATCH, BATCH - 2):
            x = init.normal(gen, (B, F, d), 1.0)
            g_all = init.normal(gen, (B, F, d), 1.0)
            dom = torch.randint(0, rows, (B,), generator=gen, device=dev)
            for relu_out in (False, True):
                kw = dict(head_num=heads, mode=mode, relu_out=relu_out)
                for rate in (0.0, DROP_RATE) if B == BATCH else (0.0,):
                    drop = drop_kw(rate)
                    masks = gate_block.layer_masks(x, head_num=heads, **drop)
                    g, kinks = g_all, 0
                    if relu_out:
                        res = {}
                        with torch.no_grad():
                            attention.meta_transformer_apply(
                                layer, x, tables, (), **kw, domain_ids=dom,
                                masks=masks, clamp=True, residuals=res)
                            near = ((res["o"] @ layer.wout).abs() < 1e-6
                                    ).flatten(1).any(1)
                        g = g_all.masked_fill(near[:, None, None], 0.0)
                        kinks = int(near.sum())
                    with torch.no_grad():
                        y = gate_block.fused_simple_layer(
                            x, layer, tables, dom, **kw, **drop)
                        ref = gate_block.simple_layer_reference(
                            x, layer, tables, dom, **kw, masks=masks)
                    torch.cuda.synchronize()
                    err = (y - ref).abs().max().item()
                    worst["fwd"] = max(worst["fwd"], err)
                    check(bool(torch.isfinite(y).all()) and torch.allclose(
                        y, ref, **KERNEL_TOL), f"K6-fwd disagrees with its "
                        f"plain version ({variant} {mode} B={B} relu_out="
                        f"{relu_out} dropout={rate}, max_abs_err={err})")
                    got = gate_grads(gate_block.fused_simple_layer, x,
                                     layer, tables, dom, g, **kw, **drop)
                    want = gate_grads(gate_block.simple_layer_reference, x,
                                      layer, tables, dom, g, **kw,
                                      masks=masks)
                    torch.cuda.synchronize()
                    errs = grad_errors(got, want)
                    berr = max(errs.values())
                    worst["bwd"] = max(worst["bwd"], berr)
                    line = (f"kernel gate_block {variant} mode={mode} B={B} "
                            f"relu_out={relu_out} dropout={rate}: forward "
                            f"max_abs_err={err:.3e}; backward max_abs_err="
                            f"{berr:.3e} (worst {max(errs, key=errs.get)}; "
                            f"{kinks} examples at a kink left out)")
                    if B == BATCH and mode == "QK" and not relu_out:
                        # the serving (0) and training (0.1) configurations
                        ops, cfg = gate_block.pack_operands(
                            x, layer, tables, dom, **kw)
                        ops = [t.detach() for t in ops]
                        kargs = prng.kernel_args(
                            True, rate, DROP_SEED, DROP_TILE, F,
                            pad_mult=gate_block.PAD_FIELDS)
                        with torch.no_grad():
                            f_ms = time_ms(lambda: gate_block.launch_fwd(
                                *ops, cfg, kargs), iters=50)
                            pf_ms = time_ms(
                                lambda: gate_block.simple_layer_reference(
                                    x, layer, tables, dom, **kw,
                                    masks=masks), iters=10)
                        b_ms = time_ms(lambda: gate_block.launch_bwd(
                            g, *ops, cfg, kargs), iters=20)
                        xr = x.detach().requires_grad_(True)
                        tr = {k: t.detach().requires_grad_(True)
                              for k, t in tables.items()}
                        inputs = [xr, *tr.values(), *layer.parameters()]
                        yr = gate_block.simple_layer_reference(
                            xr, layer, tr, dom, **kw, masks=masks)
                        pb_ms = time_ms(lambda: torch.autograd.grad(
                            yr, inputs, g, retain_graph=True), iters=5)
                        del yr
                        a = gate_block.applied(variant, mode)
                        fb = gate_layer_bound_ms(B, F, d, heads, rows,
                                                 variant, *a)
                        fc = gate_layer_bound_ms(B, F, d, heads, rows,
                                                 variant, *a,
                                                 tensor_cores=False)
                        bb = gate_layer_bound_ms(B, F, d, heads, rows,
                                                 variant, *a, bwd=True)
                        cc = gate_layer_bound_ms(B, F, d, heads, rows,
                                                 variant, *a, bwd=True,
                                                 tensor_cores=False)
                        line += (f"; K6-fwd kernel_ms={f_ms:.4f} plain_ms="
                                 f"{pf_ms:.4f} bound_ms={fb[0]:.4f} ({fb[1]};"
                                 f" every operation on the CUDA cores "
                                 f"{fc[0]:.4f}); K6-bwd kernel_ms="
                                 f"{b_ms:.4f} plain_ms="
                                 f"{pb_ms:.4f} bound_ms={bb[0]:.4f} "
                                 f"({bb[1]}; every operation on the CUDA "
                                 f"cores {cc[0]:.4f})")
                        out[(variant, "fwd", rate)] = dict(
                            ms=f_ms, plain_ms=pf_ms, bound_ms=fb[0],
                            bound_by=fb[1], cuda_core_bound_ms=fc[0])
                        out[(variant, "bwd", rate)] = dict(
                            ms=b_ms, plain_ms=pb_ms, bound_ms=bb[0],
                            bound_by=bb[1], cuda_core_bound_ms=cc[0])
                    print(line, flush=True)
    worst["fwd"] = max(worst["fwd"], gate_fwd_cases(dev))
    # K6-fwd at SMALL_BATCH, its calls queued ahead
    small_ms, small_host = k6_fwd_ms(dev, SMALL_BATCH)
    print(f"kernel gate_block_fwd gate QK B={SMALL_BATCH}: kernel_ms="
          f"{small_ms:.4f} (the host queues a call in {small_host:.4f} ms)",
          flush=True)
    return dict(
        fwd=dict(max_abs_err=worst["fwd"], **out[("gate", "fwd", 0.0)],
                 dropout_ms=out[("gate", "fwd", DROP_RATE)]["ms"],
                 bilinear_ms=out[("bilinear", "fwd", 0.0)]["ms"],
                 small_batch_ms=small_ms),
        bwd=dict(max_abs_err=worst["bwd"], **out[("gate", "bwd", DROP_RATE)],
                 no_dropout_ms=out[("gate", "bwd", 0.0)]["ms"],
                 bilinear_ms=out[("bilinear", "bwd", DROP_RATE)]["ms"],
                 bilinear_bound_ms=out[("bilinear", "bwd", DROP_RATE)][
                     "bound_ms"]))


def gate_serving(dev, card, variant):
    """Serve one request of 20,000 examples through Predictor with the
    AliCCP sota model of ``variant``: exactly 3 K6-fwd launches a batch
    and no other layer kernel, scores against the plain path.  Returns the
    K6-fwd launches."""
    from satrans_torch.data import aliccp
    from satrans_torch.features import FeatureLayout
    from satrans_torch.models import SATrans
    from satrans_torch.serving import Predictor

    layout = FeatureLayout(aliccp.sota_columns(32))
    kw = dict(domain_att_layer_num=LAYERS, att_head_num=4, meta_mode="QK",
              no_emb_init=True, seed=SEED, variant=variant, device=dev)
    model = SATrans(layout, ["301"], [3], **kw)
    pred = Predictor(model, batch_size=BATCH, device=dev).warmup()
    rng = np.random.default_rng(SEED + 3)
    req = {name: rng.integers(1, aliccp.DATA_MAX[name] + 1, REQUEST_ROWS)
           for name in aliccp.SPARSE_FEATURES}
    batches = -(-REQUEST_ROWS // BATCH)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    scores = pred(req)
    wall = time.perf_counter() - t0
    launched = k6_counts()
    check(launched == (LAYERS * batches, 0) and k1_counts() == NO_K1,
          f"serving {variant} launched K6 {launched} and K1 {k1_counts()}, "
          f"want K6-fwd only, {LAYERS} layers x {batches} batches")
    check(scores.shape == (REQUEST_ROWS,) and bool(
        np.all(np.isfinite(scores)) and np.all((scores > 0) & (scores < 1))),
          f"serving {variant}: scores not finite in (0, 1)")
    t0 = time.perf_counter()
    for _ in range(5):
        pred(req)
    wall2 = (time.perf_counter() - t0) / 5
    device_profile(f"serve {variant}: one request of {REQUEST_ROWS} "
                   "examples", lambda: pred(req), 1e3 * wall2, card)
    plain_model = SATrans(layout, ["301"], [3], route="plain", **kw)
    plain_model.load_state_dict(model.state_dict())
    want = Predictor(plain_model, batch_size=BATCH, device=dev)(req)
    diff = float(np.abs(scores - want).max())
    print(f"serve {variant} [{card}]: {REQUEST_ROWS} examples in {batches} "
          f"batches of {BATCH}: first {wall:.4f}s, then {wall2:.4f}s a "
          f"request, {REQUEST_ROWS / wall2:.1f} examples/s, "
          f"{1e3 * wall2 / batches:.3f} ms/batch; launches K6 {launched}; "
          f"score mean {scores.mean():.4f} std {scores.std():.4f}; max "
          f"|kernel - plain| = {diff:.3e}", flush=True)
    check(diff <= SERVING_TOL, f"serving {variant}: scores differ from the "
                               f"plain path by {diff} > {SERVING_TOL}")
    return launched[0]


# the layer kernels' launch counts: K6-fwd, K6-bwd, then K1's and K7's
LAYER_NAMES = ("gate_block_fwd", "gate_block_bwd") + K1_NAMES + K7_NAMES


def layer_counts():
    return (*k6_counts(), *k1_counts(), *k7_counts())


def lazy_arm(card, label, model, trainer, x, y, per_step, f64=False):
    """Train ``model`` with its ``lazy`` ``trainer`` (dropout 0.1) for one
    epoch of ``x`` (ARM_STEPS steps, the last a tail): one step's gradients
    kernel vs plain path (with ``f64`` both against the plain path of a
    float64 copy of the model, the kernel path's within the tolerance plus
    the float32 plain path's own distance from it: phase 13's float32 sums
    over the 3-matrix tables, in the plain path's order, miss float64 by
    more than the tolerance of the encoder's gradient), exactly
    ``per_step`` launches a step of each
    layer kernel (in LAYER_NAMES order) and the lazy row kernels', a finite
    falling loss, the parameters that get no gradient bit-identical after
    the epoch, trained examples/s, the staged step, the host queue time and
    a profile of one step.  Returns (the staged batch, the launches by
    kernel, the names of the parameters with no gradient)."""
    from satrans_torch.ops import eqgemm, gather, lazy_tail, scatter
    batch, yb, wb = staged_batch(trainer, x, y)
    model.train()
    grads = {}
    for use_kernel in (True, False):
        model.route = "kernel" if use_kernel else "plain"
        zero_counts()
        model.zero_grad(set_to_none=True)
        total = trainer.loss_terms(batch, yb, wb)[0]
        total.backward()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(total)), "training loss not finite")
        grads[use_kernel] = {n: p.grad.clone()
                             for n, p in model.named_parameters()
                             if p.grad is not None}
        want = tuple(LAYERS * c * use_kernel for c in per_step)
        check(layer_counts() == want,
              f"one {label} step launched {layer_counts()} "
              f"({', '.join(LAYER_NAMES)}), want {want}")
    if f64:  # trainer.loss_terms on a float64 copy, the plain path
        ref = copy.deepcopy(model).double()
        ref.zero_grad(set_to_none=True)
        (trainer.strategy.loss(ref(batch), yb.double(), batch,
                               wb.double())
         + ref.reg_loss()).backward()
        exact = {n: p.grad for n, p in ref.named_parameters()
                 if n in grads[True]}
        del ref
        errs, plain_errs = {}, {}
        direct = max((grads[True][n] - grads[False][n]).abs().max().item()
                     for n in exact)
        for n, w in exact.items():
            errs[n] = (grads[True][n].double() - w).abs().max().item()
            plain_errs[n] = (grads[False][n].double() - w).abs().max().item()
            check(bool(torch.isfinite(grads[True][n]).all())
                  and errs[n] <= GRAD_RTOL * w.abs().max().item()
                  + GRAD_ATOL + plain_errs[n],
                  f"gradient {n} differs from the float64 plain one by "
                  f"{errs[n]}, the float32 plain one by {plain_errs[n]} "
                  f"(largest entry {w.abs().max().item()})")
    else:
        errs = grad_errors(grads[True], grads[False])
    model.route = "kernel"
    worst = max(errs, key=errs.get)
    print(f"train {label} [{card}]: one step's gradients at dropout "
          f"{DROP_RATE}, kernel path vs plain path"
          + (f" in float64: max_abs_err {errs[worst]:.3e} ({worst}; the "
             f"float32 plain path's {plain_errs[worst]:.3e}, its worst "
             f"{max(plain_errs.values()):.3e}; kernel vs float32 plain "
             f"{direct:.3e})" if f64 else
             f": max_abs_err {errs[worst]:.3e} ({worst})"), flush=True)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if n not in grads[True]}
    del grads
    model.zero_grad(set_to_none=True)

    trainer.fit({k: v[:2 * BATCH] for k, v in x.items()}, y[:2 * BATCH],
                batch_size=BATCH, verbose=0)  # warmup: two steps
    wall, step_loss, epoch_loss = timed_fit(trainer, x, y, ARM_STEPS)
    mods = (gather, scatter, eqgemm, lazy_tail)
    got = (*layer_counts(), *(m.launches for m in mods))
    want = (*(LAYERS * ARM_STEPS * c for c in per_step),
            *(c * ARM_STEPS for c in LAZY_ROWS_PER_STEP))
    check(got == want, f"{label}: {ARM_STEPS} steps launched {got} "
                       f"({', '.join(LAYER_NAMES + ROW_NAMES)}), want {want}")
    params = dict(model.named_parameters())
    check(all(torch.equal(params[n], v) for n, v in frozen.items()),
          f"{label}: a parameter with no gradient moved ({sorted(frozen)})")
    per_ex = step_loss[:-1] / BATCH
    print(f"train {label} [{card}]: {len(y)} examples in {ARM_STEPS} steps "
          f"of {BATCH} (last a tail of {TAIL}) at dropout {DROP_RATE}, lr "
          f"{trainer._lr}: {wall:.4f}s, {len(y) / wall:.1f} trained "
          f"examples/s, {1e3 * wall / ARM_STEPS:.3f} ms/step; launches "
          f"{got}; loss per example step 1 {per_ex[0]:.6f} step "
          f"{ARM_STEPS - 1} {per_ex[-1]:.6f}; epoch loss {epoch_loss:.6f}; "
          f"{len(frozen)} parameters without a gradient bit-identical",
          flush=True)
    step_ms = time_ms(lambda: trainer.train_step(batch, yb, wb), iters=10)
    queue_ms = host_ms(lambda: trainer.train_step(batch, yb, wb))
    print(f"train {label} [{card}]: train_step on a staged batch "
          f"{step_ms:.3f} ms/step, {1e3 * BATCH / step_ms:.1f} examples/s; "
          f"the host queues a step in {queue_ms:.3f} ms", flush=True)
    device_profile(f"{label}: one training step of {BATCH} examples",
                   lambda: trainer.train_step(batch, yb, wb), step_ms, card,
                   top=16)
    return (batch, yb, wb), dict(zip(LAYER_NAMES + ROW_NAMES, got)), \
        sorted(frozen)


def gate_training(dev, card, variant):
    """Train the AliCCP sota model of ``variant`` in ``lazy`` (dropout
    0.1, :func:`lazy_arm`): exactly 3 K6-fwd and 3 K6-bwd launches a step
    and no K1.  Returns the launches by kernel."""
    model, trainer = training_model(dev, "lazy", variant)
    x, y = training_data()
    _, launched, _ = lazy_arm(card, f"{variant} lazy", model, trainer,
                              {k: v[:ARM_ROWS] for k, v in x.items()},
                              y[:ARM_ROWS], (1, 1) + NO_K1 + NO_K7)
    del model, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return launched


def gate_paths_phase(dev, card):
    """Serve and train the gate and bilinear variants.  Returns the
    launches by path and kernel."""
    paths = {}
    for variant in ("gate", "bilinear"):
        paths[f"serve_{variant}"] = {"gate_block_fwd": gate_serving(
            dev, card, variant)}
        gc.collect()
        torch.cuda.empty_cache()
        paths[f"train_{variant}_lazy"] = gate_training(dev, card, variant)
    return paths


def pos_test_layer(dev, seed, units=UNITS2):
    """A 'pos' layer (its q_meta and k_meta LayerNorms moved off their
    (1, 0) init, each its own way), its distinct 4-row Q and K tables of
    MetaNets of ``units``, and the generator after them."""
    from satrans_torch.nn import attention, initializers as init, metanet
    from satrans_torch.utils import make_generator
    gen = make_generator(seed, dev)
    layer = attention.MetaTransformerLayer(gen, 32, share_kv_metanet=False)
    with torch.no_grad():
        for meta in (layer.q_meta, layer.k_meta):
            meta.ln.scale.add_(init.normal(gen, (32,), 0.1))
            meta.ln.bias.add_(init.normal(gen, (32,), 0.1))
    p = metanet.param_size(units)
    return gen, layer, {k: init.normal(gen, (4, p), 0.1) for k in "QK"}


def pos_kernel_phase(dev):
    """Phase 10a: every K1 body against its plain version at the Alimama
    widths (B=8192 at dropout 0 and 0.1, the ragged 8190 at 0; F=15, QK)
    with distinct Q and K tables and a k_meta LayerNorm of its own: the
    forward's output and each stash's residuals, the three backwards'
    gradients against autograd of the plain layer (examples at a relu
    kink given no upstream gradient), and K1-bwd-stash light against
    K1-bwd-stash on the same residuals (within STASH_LIGHT_RTOL of each
    gradient's largest entry); each body timed with its bound at F=15.
    Then a gate layer with distinct Q and K gates at the same widths.
    Returns the JSON fields measured, by kernel name."""
    from satrans_torch.nn import initializers as init
    from satrans_torch.ops import gate_block, meta_block, prng

    F, d, h, heads, rows = ALIMAMA_F, 32, 64, 4, 4
    gen, layer, tables = pos_test_layer(dev, SEED + 20)
    check(not torch.equal(layer.k_meta.ln.scale, layer.q_meta.ln.scale)
          and not torch.equal(tables["Q"], tables["K"]),
          "the pos test layer's Q and K operands are not distinct")
    kw = dict(meta_units=[d, h, d], head_num=heads, mode="QK",
              relu_out=False)
    names = dict(zip(("full", "light"), (("qkv", "uq", "uk", "s", "o"),
                                         ("qkv", "uq", "uk", "o"))))
    worst = dict.fromkeys(K1_NAMES, 0.0)
    light_gap = 0.0
    out = {}
    for B in (BATCH, BATCH - 2):
        x = init.normal(gen, (B, F, d), 1.0)
        g_all = init.normal(gen, (B, F, d), 1.0)
        dom = torch.randint(0, rows, (B,), generator=gen, device=dev)
        for rate in (0.0, DROP_RATE) if B == BATCH else (0.0,):
            drop = drop_kw(rate)
            masks = meta_block.layer_masks(x, head_num=heads, mode="QK",
                                           **drop)
            ops, cfg = meta_block.pack_operands(x, layer, tables, dom, **kw)
            ops = [t if t is None else t.detach() for t in ops]
            kargs = prng.kernel_args(True, rate, DROP_SEED, DROP_TILE, F)
            res = {}
            with torch.no_grad():
                y = meta_block.fused_meta_layer(x, layer, tables, dom, **kw,
                                                **drop)
                st = {s: meta_block.launch_fwd(*ops, cfg, kargs, stash=s)
                      for s in ("full", "light")}
                ref = meta_block.meta_layer_reference(
                    x, layer, tables, dom, **kw, masks=masks, residuals=res)
            torch.cuda.synchronize()
            errs = {"meta_block_fwd": (y - ref).abs().max().item()}
            fwd_same, fwd_gap = fwd_stash_gap(
                y, st["full"][0], f"K1-fwd at the Alimama widths (B={B} "
                f"dropout={rate})")
            for s, name in (("full", "meta_block_fwd_stash"),
                            ("light", "meta_block_fwd_stash_light")):
                got, want = st[s], (ref, *(res[n] for n in names[s]))
                check(len(got) == len(want), f"stash {s} returned "
                      f"{len(got)} tensors, want {len(want)}")
                errs[name] = max((a - b).abs().max().item()
                                 for a, b in zip(got, want))
                for n, a, b in zip(("y", *names[s]), got, want):
                    check(bool(torch.isfinite(a).all()) and torch.allclose(
                        a, b, **KERNEL_TOL), f"{name}'s {n} disagrees with "
                        f"the plain version's at the Alimama widths (B={B} "
                        f"dropout={rate}, tolerance {KERNEL_TOL})")
            check(torch.allclose(y, ref, **KERNEL_TOL), f"K1-fwd disagrees "
                  f"with the plain pos layer (B={B} dropout={rate}, "
                  f"max_abs_err {errs['meta_block_fwd']})")
            g, kinks = kink_free(g_all, x, layer, tables, dom, masks, **kw)
            want = layer_grads(meta_block.meta_layer_reference, x, layer,
                               tables, dom, g, **kw, masks=masks)
            for bwd, name in K1_BWD_NAME.items():
                got = layer_grads(meta_block.fused_meta_layer, x, layer,
                                  tables, dom, g, **kw, **drop, bwd=bwd)
                torch.cuda.synchronize()
                e = grad_errors(got, want)
                errs[name] = max(e.values())
                check(not any(n.startswith("v_meta") for n in got)
                      and not torch.allclose(got["table.Q"], got["table.K"]),
                      f"{name}: v_meta got a gradient, or the Q and K "
                      "tables' gradients agree")
            # the light backward against the full one on the same
            # residuals: the probabilities are recomputed with the
            # forward's device code, so bit for bit is expected
            full_res = st["full"][1:]
            light_res = [full_res[i] for i in (0, 1, 2, 4)]
            gf, gl = ([t for t in meta_block.launch_bwd(
                g, *ops, cfg, kargs, res=r) if t is not None]
                      for r in (full_res, light_res))  # no middle matrix
            torch.cuda.synchronize()
            gaps = [(a - b).abs().max().item() / b.abs().max().item()
                    for a, b in zip(gl, gf)]
            same = sum(torch.equal(a, b) for a, b in zip(gl, gf))
            light_gap = max(light_gap, *gaps)
            check(max(gaps) <= STASH_LIGHT_RTOL, f"K1-bwd-stash light "
                  f"differs from K1-bwd-stash on the same residuals by "
                  f"{max(gaps)} of a gradient's largest entry (B={B} "
                  f"dropout={rate})")
            for n, e in errs.items():
                worst[n] = max(worst[n], e)
            line = (f"kernel pos B={B} F={F} dropout={rate}: " + ", ".join(
                f"{n} {e:.3e}" for n, e in errs.items())
                + f" ({kinks} examples at a kink left out); K1-fwd's y "
                f"bit-identical to K1-stash's: {fwd_same} (max_abs_diff "
                f"{fwd_gap:.3e}); light vs full "
                f"backward {max(gaps):.3e} of the largest entry, {same} of "
                f"{len(gf)} gradients bit-identical")
            if B == BATCH:  # the serving (0) and training (0.1) widths
                with torch.no_grad():
                    p_ms = time_ms(lambda: meta_block.meta_layer_reference(
                        x, layer, tables, dom, **kw, masks=masks), iters=10)
                    for s, name in ((None, "meta_block_fwd"),
                                    ("full", "meta_block_fwd_stash"),
                                    ("light", "meta_block_fwd_stash_light")):
                        ms = time_ms(lambda: meta_block.launch_fwd(
                            *ops, cfg, kargs, stash=s), iters=50)
                        b_ms, b_by = meta_layer_bound_ms(
                            B, F, d, h, heads, rows, 1, 1, stash=s)
                        out[(name, rate)] = dict(ms=ms, plain_ms=p_ms,
                                                 bound_ms=b_ms, bound_by=b_by)
                xr = x.detach().requires_grad_(True)
                tr = {k: t.detach().requires_grad_(True)
                      for k, t in tables.items()}
                inputs = [xr, *tr.values(), layer.wq, layer.wk, layer.wv,
                          layer.wout, *layer.ln.parameters(),
                          *layer.q_meta.parameters(),
                          *layer.k_meta.parameters()]
                yr = meta_block.meta_layer_reference(xr, layer, tr, dom,
                                                     **kw, masks=masks)
                pb_ms = time_ms(lambda: torch.autograd.grad(
                    yr, inputs, g, retain_graph=True), iters=5)
                del yr
                for bwd, name in K1_BWD_NAME.items():
                    r = {"stash": full_res, "stash_light": light_res}.get(bwd)
                    ms = time_ms(lambda: meta_block.launch_bwd(
                        g, *ops, cfg, kargs, res=r), iters=20)
                    b_ms, b_by = meta_layer_bwd_bound_ms(
                        B, F, d, h, heads, rows, 1, 1, stash={
                            "stash": "full", "stash_light": "light"}.get(bwd))
                    out[(name, rate)] = dict(ms=ms, plain_ms=pb_ms,
                                             bound_ms=b_ms, bound_by=b_by)
                line += "; " + ", ".join(
                    f"{n} kernel_ms={out[(n, rate)]['ms']:.4f} bound_ms="
                    f"{out[(n, rate)]['bound_ms']:.4f}" for n in K1_NAMES) + (
                    f"; plain forward {p_ms:.4f} ms, backward {pb_ms:.4f} ms")
            print(line, flush=True)
            del st, gf, gl, full_res, light_res
    gate_err = pos_gate_case(dev)
    # the F=15 times beside the AliCCP fields of the earlier phases;
    # the light bodies' main numbers are these
    fields = {}
    for name in K1_NAMES:
        t0, t1 = out[(name, 0.0)], out[(name, DROP_RATE)]
        if name.endswith("stash_light"):
            fields[name] = dict(max_abs_err=worst[name], **t1,
                                no_dropout_ms=t0["ms"])
        else:
            fields[name] = dict(max_abs_err=worst[name],
                                alimama_ms=t1["ms"],
                                alimama_no_dropout_ms=t0["ms"],
                                alimama_bound_ms=t1["bound_ms"])
    fields["meta_block_bwd_stash_light"]["max_rel_diff_vs_stash"] = light_gap
    return fields, gate_err


def pos_gate_case(dev):
    """K6-fwd and K6-bwd with distinct Q and K gates at the Alimama widths
    (B=8192, F=15, QK, dropout 0.1) against the plain layer.  Returns the
    worst errors (forward, backward)."""
    from satrans_torch.nn import initializers as init
    from satrans_torch.ops import gate_block
    F, heads, rows = ALIMAMA_F, 4, 4
    gen, layer, tables = gate_test_layer(dev, SEED + 21, "gate")
    check(not torch.equal(tables["Q"], tables["K"]),
          "the gate case's Q and K gates are not distinct")
    x = init.normal(gen, (BATCH, F, 32), 1.0)
    g = init.normal(gen, (BATCH, F, 32), 1.0)
    dom = torch.randint(0, rows, (BATCH,), generator=gen, device=dev)
    kw = dict(head_num=heads, mode="QK", relu_out=False)
    drop = drop_kw(DROP_RATE)
    masks = gate_block.layer_masks(x, head_num=heads, **drop)
    with torch.no_grad():
        y = gate_block.fused_simple_layer(x, layer, tables, dom, **kw, **drop)
        ref = gate_block.simple_layer_reference(x, layer, tables, dom, **kw,
                                                masks=masks)
    torch.cuda.synchronize()
    err = (y - ref).abs().max().item()
    check(torch.allclose(y, ref, **KERNEL_TOL), f"K6-fwd with distinct Q "
          f"and K gates disagrees with the plain layer ({err})")
    got = gate_grads(gate_block.fused_simple_layer, x, layer, tables, dom,
                     g, **kw, **drop)
    want = gate_grads(gate_block.simple_layer_reference, x, layer, tables,
                      dom, g, **kw, masks=masks)
    torch.cuda.synchronize()
    errs = grad_errors(got, want)
    check(not torch.allclose(got["table.Q"], got["table.K"]),
          "the Q and K gates' gradients agree")
    print(f"kernel gate_block, distinct Q and K gates, B={BATCH} F={F} QK "
          f"dropout={DROP_RATE}: forward max_abs_err={err:.3e}; backward "
          f"max_abs_err={max(errs.values()):.3e} (worst "
          f"{max(errs, key=errs.get)})", flush=True)
    return err, max(errs.values())


def alimama_model(dev, **kw):
    """SATrans at the Alimama sota-pos width (the reference's
    ``--domain_col shopping_level --flag sota-pos``): 15 sparse fields with
    the public vocab sizes and the dense price column, d = 32, 3 layers, 4
    heads, QK, MetaNet 32->64->32, use_pos."""
    from satrans_torch.data import alimama
    from satrans_torch.features import FeatureLayout
    from satrans_torch.models import SATrans
    return SATrans(FeatureLayout(alimama.sota_columns(32)),
                   [alimama.DOMAIN_COL], [alimama.NUM_DOMAINS],
                   domain_att_layer_num=LAYERS, att_head_num=4,
                   meta_mode="QK", meta_dnn_hidden_units=(64, 32),
                   use_pos=True, seed=SEED, device=dev, **kw)


def alimama_data(rows, seed):
    """bench.py's synthetic Alimama batch: ids uniform in [1, DATA_MAX],
    price N(0, 1), labels 0/1.  Returns (features, labels)."""
    from satrans_torch.data import alimama
    rng = np.random.default_rng(seed)
    x = {name: rng.integers(1, alimama.DATA_MAX[name] + 1, rows)
         for name in alimama.SPARSE_FEATURES}
    x["price"] = rng.normal(size=rows).astype(np.float32)
    return x, rng.integers(0, 2, rows).astype(np.float32)


def pos_serving(dev, card):
    """Phase 10b: one request of 20,000 examples through Predictor with
    the Alimama sota-pos model: exactly 3 K1-fwd launches a batch and no
    other layer kernel, scores against the plain path.  Returns the K1-fwd
    launches."""
    from satrans_torch.serving import Predictor
    model = alimama_model(dev, no_emb_init=True)
    pred = Predictor(model, batch_size=BATCH, device=dev).warmup()
    req = alimama_data(REQUEST_ROWS, SEED + 30)[0]
    batches = -(-REQUEST_ROWS // BATCH)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    scores = pred(req)
    wall = time.perf_counter() - t0
    launched = k1_counts()
    check(launched == (LAYERS * batches,) + NO_K1[1:]
          and k6_counts() == (0, 0), f"serving pos launched K1 {launched} "
          f"({', '.join(K1_COUNTS)}) and K6 {k6_counts()}, want K1-fwd "
          f"only, {LAYERS} layers x {batches} batches")
    check(scores.shape == (REQUEST_ROWS,) and bool(
        np.all(np.isfinite(scores)) and np.all((scores > 0) & (scores < 1))),
          "serving pos: scores not finite in (0, 1)")
    t0 = time.perf_counter()
    for _ in range(5):
        pred(req)
    wall2 = (time.perf_counter() - t0) / 5
    device_profile(f"serve alimama pos: one request of {REQUEST_ROWS} "
                   "examples", lambda: pred(req), 1e3 * wall2, card)
    plain_model = alimama_model(dev, no_emb_init=True, route="plain")
    plain_model.load_state_dict(model.state_dict())
    want = Predictor(plain_model, batch_size=BATCH, device=dev)(req)
    diff = float(np.abs(scores - want).max())
    print(f"serve alimama pos [{card}]: {REQUEST_ROWS} examples in "
          f"{batches} batches of {BATCH}: first {wall:.4f}s, then "
          f"{wall2:.4f}s a request, {REQUEST_ROWS / wall2:.1f} examples/s, "
          f"{1e3 * wall2 / batches:.3f} ms/batch; launches {launched}; "
          f"score mean {scores.mean():.4f} std {scores.std():.4f}; max "
          f"|kernel - plain| = {diff:.3e}", flush=True)
    check(diff <= SERVING_TOL, f"serving pos: scores differ from the plain "
                               f"path by {diff} > {SERVING_TOL}")
    del model, plain_model, pred
    gc.collect()
    torch.cuda.empty_cache()
    return launched[0]


def pos_training(dev, card, bwd):
    """Phase 10c, one arm: train the Alimama sota-pos model in ``lazy``
    (lr 0.001, dropout 0.1, the bench.py arm; :func:`lazy_arm`) under
    ``SATRANS_BWD=bwd``: exactly 3 + 3 launches a step of the arm's K1
    pair and no K6, the price column staged, v_meta (and nothing else)
    without a gradient and bit-identical.  Returns (trainer, staged
    batch, launches by kernel)."""
    from satrans_torch.train import Trainer
    os.environ["SATRANS_BWD"] = bwd
    model = alimama_model(dev, dropout_rate=DROP_RATE)
    trainer = Trainer(model, seed=SEED, device=dev)
    trainer.compile(learning_rate=POS_LR, bank_update="lazy")
    x, y = alimama_data(ARM_ROWS, SEED)
    staged, launched, frozen = lazy_arm(
        card, f"alimama pos {bwd} lazy", model, trainer, x, y,
        (0, 0) + K1_PAIR[bwd] + NO_K7)
    check("dense" in staged[0] and staged[0]["dense"].shape == (BATCH, 1),
          "the staged batch has no price column")
    v_meta = sorted(n for n, _ in model.named_parameters()
                    if ".v_meta." in n)
    check(len(v_meta) == 2 * LAYERS and frozen == v_meta,
          f"the parameters without a gradient are {frozen}, want v_meta's")
    return trainer, staged, launched


def pos_paths_phase(dev, card):
    """Phases 10b and 10c: serve the Alimama sota-pos model, and train it
    in ``lazy`` once with each stash; then the two stashes' staged steps in
    turns on one trainer.  Returns the launches by path and kernel."""
    paths = {"serve_alimama_pos": {"meta_block_fwd": pos_serving(dev,
                                                                  card)}}
    for bwd in ("stash", "stash_light"):
        trainer, staged, paths[f"train_alimama_pos_{bwd}_lazy"] = \
            pos_training(dev, card, bwd)
        if bwd == "stash":
            del trainer, staged
            gc.collect()
            torch.cuda.empty_cache()
    # the host's clock spreads from arm to arm: the two stashes in turns
    for bwd in ("stash", "stash_light", "stash_light", "stash"):
        os.environ["SATRANS_BWD"] = bwd
        step_ms = time_ms(lambda: trainer.train_step(*staged), iters=10)
        queue_ms = host_ms(lambda: trainer.train_step(*staged))
        print(f"train alimama pos in turns, {bwd} [{card}]: train_step on a "
              f"staged batch {step_ms:.3f} ms/step; the host queues a step "
              f"in {queue_ms:.3f} ms", flush=True)
    os.environ.pop("SATRANS_BWD")
    del trainer, staged
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def multicol_dispatch(dev, gen, B=BATCH):
    """The AliCCP multicol dispatch of a batch of ``B``: ids of 301 and
    122 uniform in [1, DATA_MAX] (phase 5's), their composite row, and the
    plan on tiles of 32 (39 of the 56 rows occupied).  Returns the plan."""
    from satrans_torch.data import aliccp
    from satrans_torch.ops import dispatch
    dom = None
    for col, n in zip(MULTICOL_COLS, MULTICOL_DOMAINS):
        ids = torch.randint(1, aliccp.DATA_MAX[col] + 1, (B,),
                            generator=gen, device=dev)
        dom = ids if dom is None else dom * (n + 1) + ids
    return dispatch.plan(dom, MULTICOL_ROWS, MULTICOL_TILE)


def tiled_kernel_phase(dev, units=UNITS2, cases=None):
    """Phase 11a (13a with 3-matrix ``units``, on the given ``cases`` of
    (mode, relu_out, rate, pos)): K7-fwd (on every slot, and with the
    plan's tile_count on the occupied slots, zeros on the slack ones; its
    y against K7-stash's, :func:`fwd_stash_gap`; timed at SMALL_BATCH
    too), K7-stash (output and every residual),
    K7-bwd-stash and K7-bwd against the plain tiled layer at the AliCCP
    multicol workload's dispatch (B=8192 in 9984 slots of 312 tiles; F=19,
    56 table rows gathered per tile), in QK and Query with relu_out off
    and on at dropout 0 and 0.1, and QK with distinct Q and K tables at
    0.1; the backwards' gradients (x, the layer's parameters, the per-tile
    table blocks) against autograd of the plain layer with the same masks
    (examples at a relu kink given no upstream gradient), at the
    tolerances of phases 2 and 4.  Each body timed with its bound at
    n_slots rows with per-tile weights.  Returns the JSON fields by
    kernel name."""
    from satrans_torch.nn import initializers as init, metanet
    from satrans_torch.ops import dispatch, meta_block, prng, tiled_meta

    F, d, h, heads = 19, 32, 64, 4
    h2 = units[2] if len(units) == 4 else 0
    tag = "" if units == UNITS2 else f" {len(units) - 1}-matrix"
    gen, layer, _ = test_layer(dev, SEED + 40, units)
    _, pos_layer, _ = pos_test_layer(dev, SEED + 41, units)
    plan = multicol_dispatch(dev, gen)
    T = plan.n_slots // MULTICOL_TILE
    slack = int((plan.src < 0).sum())
    live = (plan.src >= 0).view(T, MULTICOL_TILE).any(1)
    grid = torch.cuda.get_device_properties(dev).multi_processor_count
    occupied = int(plan.tile_count.sum())
    check(occupied == BATCH, f"tile_count sums to {occupied}, want {BATCH}")
    print(f"kernel tiled_meta{tag}: B={BATCH} dispatched into {plan.n_slots} "
          f"slots, {T} tiles of {MULTICOL_TILE} ({int(live.sum())} "
          f"occupied, of {torch.unique(plan.tile_dom[live]).numel()} of "
          f"the {MULTICOL_ROWS} rows), {slack} slack slots; the backwards' "
          f"grid {grid} blocks, the {slack} slack slots skipped", flush=True)
    p = metanet.param_size(units)
    tables = {k: init.normal(gen, (MULTICOL_ROWS, p), 0.1) for k in "QK"}
    tile_dom = plan.tile_dom.long()
    tiled = {k: t[tile_dom] for k, t in tables.items()}
    x = dispatch.scatter(init.normal(gen, (BATCH, F, d), 1.0), plan)
    g_all = dispatch.scatter(init.normal(gen, (BATCH, F, d), 1.0), plan)
    rows = tiled_meta.tile_rows(plan.n_slots, MULTICOL_TILE, dev)
    occ = plan.src >= 0
    worst = dict.fromkeys(K7_NAMES, 0.0)
    out = {}
    fwd_gaps = []  # K7-fwd's y against K7-stash's: (bit-identical, diff)
    if cases is None:
        cases = [(mode, relu_out, rate, False) for mode in ("QK", "Query")
                 for relu_out in (False, True) for rate in (0.0, DROP_RATE)]
        cases.append(("QK", False, DROP_RATE, True))
    for mode, relu_out, rate, pos in cases:
        lay = pos_layer if pos else layer
        tabs = tiled if pos else shared(tiled["Q"])
        kw = dict(meta_units=list(units), head_num=heads, mode=mode,
                  relu_out=relu_out)
        drop = dict(train=True, drop_rate=rate, seed=DROP_SEED,
                    block_b=MULTICOL_TILE)
        masks = tiled_meta.layer_masks(x, head_num=heads, mode=mode, **drop)
        weights, cfg = meta_block.pack_weights(lay, tabs, **kw)
        weights = [t if t is None else t.detach() for t in weights]
        kargs = prng.kernel_args(True, rate, DROP_SEED, MULTICOL_TILE, F)
        res = {}
        with torch.no_grad():
            y = tiled_meta.fused_tiled_layer(x, lay, tabs, **kw, **drop)
            # K7-fwd on the model's path: the occupied slots alone
            fs = tiled_meta.fused_tiled_layer(x, lay, tabs, **kw, **drop,
                                              tile_count=plan.tile_count)
            st = tiled_meta.launch_fwd(x, *weights, cfg, kargs,
                                       MULTICOL_TILE, stash=True)
            # the model's path: the occupied slots alone, zeros elsewhere
            sk = tiled_meta.launch_fwd(x, *weights, cfg, kargs,
                                       MULTICOL_TILE, stash=True,
                                       tile_count=plan.tile_count)
            ref = tiled_meta.tiled_layer_reference(
                x, lay, tabs, **kw, block_b=MULTICOL_TILE, masks=masks,
                residuals=res)
        torch.cuda.synchronize()
        errs = {"tiled_meta_fwd": max(
            (y - ref).abs().max().item(),
            (fs[occ] - ref[occ]).abs().max().item())}
        what = (f"mode={mode} relu_out={relu_out} dropout={rate} "
                f"pos={pos}{tag}")
        fwd_gaps.append(fwd_stash_gap(y, st[0], f"K7-fwd ({what})"))
        fwd_skip_same = torch.equal(fs[occ], y[occ])
        check(fwd_skip_same or torch.allclose(fs[occ], y[occ], **KERNEL_TOL),
              f"K7-fwd with tile_count differs from every slot ({what})")
        check(not bool(fs[~occ].any()), f"K7-fwd with tile_count left a "
              f"nonzero y on a slack slot ({what})")
        want = (ref, *(res[n] for n in tiled_meta.STASH_RESIDUALS))
        errs["tiled_meta_fwd_stash"] = max(
            max((a - b).abs().max().item(), (c[occ] - b[occ]).abs().max()
                .item()) for a, c, b in zip(st, sk, want))
        skip_gap = max((a[occ] - c[occ]).abs().max().item()
                       for a, c in zip(st, sk))
        for n, a, c, b in zip(("y",) + tiled_meta.STASH_RESIDUALS, st, sk,
                              want):
            check(bool(torch.isfinite(a).all()) and torch.allclose(
                a, b, **KERNEL_TOL) and torch.allclose(
                c[occ], b[occ], **KERNEL_TOL), f"K7-stash's {n} disagrees "
                f"with the plain version's (mode={mode} relu_out="
                f"{relu_out} dropout={rate} pos={pos}, tolerance "
                f"{KERNEL_TOL}; every slot and the occupied slots alone)")
            check(not bool(c[~occ].any()), f"K7-stash with tile_count "
                  f"left a nonzero {n} on a slack slot")
        del sk
        check(bool(torch.isfinite(y).all()) and torch.allclose(
            y, ref, **KERNEL_TOL), f"K7-fwd disagrees with the plain "
            f"version (mode={mode} relu_out={relu_out} dropout={rate} "
            f"pos={pos}, max_abs_err {errs['tiled_meta_fwd']})")
        g, kinks = kink_free(g_all, x, lay, tabs, rows, masks, **kw)
        ref_fn = functools.partial(tiled_meta.tiled_layer_reference,
                                   block_b=MULTICOL_TILE, masks=masks)
        want_g = layer_grads(lambda x, l, t, _, **k: ref_fn(x, l, t, **k),
                             x, lay, tabs, rows, g, **kw)
        grads = {}
        for bwd, name in (("stash", "tiled_meta_bwd_stash"),
                          ("recompute", "tiled_meta_bwd")):
            # the model's path: the plan's tile_count, the slack skipped
            grads[bwd] = layer_grads(
                lambda x, l, t, _, **k: tiled_meta.fused_tiled_layer(
                    x, l, t, **k, **drop, bwd=bwd,
                    tile_count=plan.tile_count),
                x, lay, tabs, rows, g, **kw)
            torch.cuda.synchronize()
            e = grad_errors(grads[bwd], want_g)
            errs[name] = max(e.values())
        # the two backwards on the same masks, each gradient within
        # STASH_RECOMPUTE_RTOL of its largest entry (a gradient that is
        # zero in exact arithmetic, k_meta.ln.bias, is all round-off: the
        # absolute term covers it)
        gaps = {n: (grads["stash"][n] - grads["recompute"][n]).abs().max()
                .item() for n in want_g}
        gap = max(gaps.values())
        check(all(gaps[n] <= STASH_RECOMPUTE_RTOL * w.abs().max().item()
                  + GRAD_ATOL for n, w in want_g.items()),
              f"K7-bwd-stash and K7-bwd differ on the same masks: {gaps}")
        for n, e in errs.items():
            worst[n] = max(worst[n], e)
        line = (f"kernel tiled_meta{tag} mode={mode} relu_out={relu_out} "
                f"dropout={rate} pos={pos}: " + ", ".join(
                    f"{n} {e:.3e}" for n, e in errs.items())
                + f" ({kinks - slack} examples at a kink left out, and the "
                f"{slack} slack slots, whose gradient is zero); stash vs "
                f"recompute backward max_abs_diff {gap:.3e}; K7-stash on "
                f"the occupied slots vs every slot max_abs_diff "
                f"{skip_gap:.3e}, its slack slots zero; K7-fwd's y "
                f"bit-identical to K7-stash's: {fwd_gaps[-1][0]} "
                f"(max_abs_diff {fwd_gaps[-1][1]:.3e}), on the occupied "
                f"slots to every slot: "
                f"{fwd_skip_same}, its slack slots zero")
        if mode == "QK" and not relu_out and not pos:
            # the serving (0) and training (0.1) configurations
            with torch.no_grad():
                p_ms = time_ms(lambda: tiled_meta.tiled_layer_reference(
                    x, lay, tabs, **kw, block_b=MULTICOL_TILE, masks=masks),
                    iters=10)
                for stash, name in ((False, "tiled_meta_fwd"),
                                    (True, "tiled_meta_fwd_stash")):
                    # K7-fwd and K7-stash on the model's path (tile_count)
                    # and on every slot
                    ms = time_ms(lambda: tiled_meta.launch_fwd(
                        x, *weights, cfg, kargs, MULTICOL_TILE,
                        stash=stash, tile_count=plan.tile_count), iters=50)
                    mode_ = "full" if stash else None
                    b_ms, b_by = meta_layer_bound_ms(
                        plan.n_slots, F, d, h, heads, T, 1, 1,
                        stash=mode_, h2=h2, occupied=occupied)
                    out[(name, rate)] = dict(ms=ms, plain_ms=p_ms,
                                             bound_ms=b_ms, bound_by=b_by)
                    out[(name, rate)].update(
                        every_slot_ms=time_ms(
                            lambda: tiled_meta.launch_fwd(
                                x, *weights, cfg, kargs, MULTICOL_TILE,
                                stash=stash), iters=50),
                        cuda_core_bound_ms=meta_layer_bound_ms(
                            plan.n_slots, F, d, h, heads, T, 1, 1,
                            stash=mode_, h2=h2, tensor_cores=False)[0])
            xr = x.detach().requires_grad_(True)
            tr = tabs["Q"].detach().requires_grad_(True)
            inputs = [xr, tr, *lay.parameters()]
            yr = tiled_meta.tiled_layer_reference(
                xr, lay, shared(tr), **kw, block_b=MULTICOL_TILE,
                masks=masks)
            pb_ms = time_ms(lambda: torch.autograd.grad(
                yr, inputs, g, retain_graph=True), iters=5)
            del yr
            for res_, name in ((st[1:], "tiled_meta_bwd_stash"),
                               (None, "tiled_meta_bwd")):
                ms = time_ms(lambda: tiled_meta.launch_bwd(
                    g, x, *weights, cfg, kargs, MULTICOL_TILE, res=res_,
                    tile_count=plan.tile_count), iters=20)
                every_ms = time_ms(lambda: tiled_meta.launch_bwd(
                    g, x, *weights, cfg, kargs, MULTICOL_TILE, res=res_),
                    iters=20)
                # the kernel's own split of this grid: the dispatch tiles
                # it shares between two blocks
                _, tails = tiled_meta.launch_bwd(
                    g, x, *weights, cfg, kargs, MULTICOL_TILE, res=res_,
                    tile_count=plan.tile_count, tails=True)
                split = int((tails >= 0).sum())
                check(tails.numel() == grid, f"{name} ran {tails.numel()} "
                      f"blocks, want {grid}")
                b_ms, b_by = meta_layer_bwd_bound_ms(
                    plan.n_slots, F, d, h, heads, T, 1, 1,
                    stash="full" if res_ is not None else None, h2=h2,
                    occupied=occupied)
                out[(name, rate)] = dict(ms=ms, plain_ms=pb_ms,
                                         bound_ms=b_ms, bound_by=b_by,
                                         every_slot_ms=every_ms,
                                         grid=grid, split_tiles=split)
            line += "; " + ", ".join(
                f"{n} kernel_ms={out[(n, rate)]['ms']:.4f} bound_ms="
                f"{out[(n, rate)]['bound_ms']:.4f}" for n in K7_NAMES) + (
                "; on every slot (no tile_count) " + ", ".join(
                    f"{n} {out[(n, rate)]['every_slot_ms']:.4f} ms"
                    for n in K7_NAMES)
                + "; the forwards' bounds with every slot's products on "
                "the CUDA cores " + ", ".join(
                    f"{n} {out[(n, rate)]['cuda_core_bound_ms']:.4f} ms"
                    for n in K7_NAMES[:2])
                + "; " + ", ".join(
                    f"{n} split {out[(n, rate)]['split_tiles']} boundary "
                    f"tiles between two of its {grid} blocks"
                    for n in K7_NAMES[2:])
                + f"; plain forward {p_ms:.4f} ms, backward {pb_ms:.4f} ms")
        print(line, flush=True)
        del st, grads, want_g
    small_ms, small_host, small_slots = k7_fwd_ms(dev, SMALL_BATCH, units)
    same = sum(g[0] for g in fwd_gaps)
    print(f"kernel tiled_meta_fwd{tag}: y bit-identical to K7-stash's in "
          f"{same} of {len(fwd_gaps)} cases (largest difference "
          f"{max(g[1] for g in fwd_gaps):.3e}); B={SMALL_BATCH} "
          f"({small_slots} slots) kernel_ms={small_ms:.4f} (the host "
          f"queues a call in {small_host:.4f} ms)", flush=True)
    fields = {}
    for name in K7_NAMES:
        t0, t1 = out[(name, 0.0)], out[(name, DROP_RATE)]
        main = t0 if name == "tiled_meta_fwd" else t1
        fields[name] = dict(max_abs_err=worst[name], **main,
                            n_slots=plan.n_slots, tiles=T)
        if name == "tiled_meta_fwd":
            fields[name].update(
                dropout_ms=t1["ms"], small_batch_ms=small_ms,
                bit_identical_to_stash=f"{same} of {len(fwd_gaps)}",
                max_abs_diff_vs_stash=max(g[1] for g in fwd_gaps))
        else:
            fields[name]["no_dropout_ms"] = t0["ms"]
    return fields


def multicol_model(dev, units=UNITS2, **kw):
    """SATrans at the AliCCP sota width with the scenario columns 301 and
    122 (the reference's ``--domain_col 301-122``; satrans_tpu's bench arm
    ``multicol``): 19 sparse fields with the real vocab sizes, d = 32, 3
    layers, 4 heads, QK, MetaNets of ``units`` (32->64->32), a composite
    table of 56 rows."""
    from satrans_torch.data import aliccp
    from satrans_torch.features import FeatureLayout
    from satrans_torch.models import SATrans
    model = SATrans(FeatureLayout(aliccp.sota_columns(32)), MULTICOL_COLS,
                    MULTICOL_DOMAINS, domain_att_layer_num=LAYERS,
                    att_head_num=4, meta_mode="QK",
                    meta_dnn_hidden_units=units[1:], seed=SEED, device=dev,
                    **kw)
    check(model.tiled and model.meta_rows == MULTICOL_ROWS
          and model.block_b(BATCH) == MULTICOL_TILE,
          "the multicol model does not take the tiled layer on tiles of 32")
    return model


def multicol_serving(dev, card, units=UNITS2):
    """Phase 11b (13c with 3-matrix ``units``): one request of 20,000
    examples through Predictor with the AliCCP multicol model: exactly 3
    K7-fwd launches a batch and no other layer kernel, scores against the
    plain path.  Returns the K7-fwd launches."""
    from satrans_torch.data import aliccp
    from satrans_torch.serving import Predictor
    tag = "" if units == UNITS2 else f" {len(units) - 1}-matrix"
    model = multicol_model(dev, units, no_emb_init=True)
    pred = Predictor(model, batch_size=BATCH, device=dev).warmup()
    rng = np.random.default_rng(SEED + 50)
    req = {name: rng.integers(1, aliccp.DATA_MAX[name] + 1, REQUEST_ROWS)
           for name in aliccp.SPARSE_FEATURES}
    batches = -(-REQUEST_ROWS // BATCH)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    scores = pred(req)
    wall = time.perf_counter() - t0
    launched = layer_counts()
    want = (0, 0) + NO_K1 + (LAYERS * batches,) + NO_K7[1:]
    check(launched == want, f"serving multicol launched {launched} "
          f"({', '.join(LAYER_NAMES)}), want {want}")
    check(scores.shape == (REQUEST_ROWS,) and bool(
        np.all(np.isfinite(scores)) and np.all((scores > 0) & (scores < 1))),
          "serving multicol: scores not finite in (0, 1)")
    t0 = time.perf_counter()
    for _ in range(5):
        pred(req)
    wall2 = (time.perf_counter() - t0) / 5
    device_profile(f"serve multicol{tag}: one request of {REQUEST_ROWS} "
                   "examples", lambda: pred(req), 1e3 * wall2, card)
    plain_model = multicol_model(dev, units, no_emb_init=True,
                                 route="plain")
    plain_model.load_state_dict(model.state_dict())
    want = Predictor(plain_model, batch_size=BATCH, device=dev)(req)
    diff = float(np.abs(scores - want).max())
    print(f"serve multicol{tag} [{card}]: {REQUEST_ROWS} examples in "
          f"{batches} "
          f"batches of {BATCH}: first {wall:.4f}s, then {wall2:.4f}s a "
          f"request, {REQUEST_ROWS / wall2:.1f} examples/s, "
          f"{1e3 * wall2 / batches:.3f} ms/batch; launches "
          f"{launched[-len(K7_COUNTS):]} (K7: {', '.join(K7_COUNTS)}) in the "
          f"first request; score mean {scores.mean():.4f} std "
          f"{scores.std():.4f}; max |kernel - plain| = {diff:.3e}",
          flush=True)
    check(diff <= SERVING_TOL, f"serving multicol: scores differ from the "
                               f"plain path by {diff} > {SERVING_TOL}")
    del model, plain_model, pred
    gc.collect()
    torch.cuda.empty_cache()
    return launched[-len(K7_COUNTS)]


def multicol_training(dev, card, bwd, units=UNITS2):
    """Phase 11c (13c with 3-matrix ``units``), one arm: train the AliCCP
    multicol model in ``lazy`` (lr 0.005, dropout 0.1; :func:`lazy_arm`)
    under ``SATRANS_TILED_BWD=bwd``: exactly 3 + 3 launches a step of the
    arm's K7 pair and no K1 or K6; domain_emb and domain_bank's large part
    without a gradient and bit-identical; 3-matrix ``units`` hold the
    kernel path's gradients against a float64 plain path.  Returns
    (trainer, staged batch, launches by kernel)."""
    from satrans_torch.train import Trainer
    os.environ["SATRANS_TILED_BWD"] = bwd
    tag = "" if units == UNITS2 else f" {len(units) - 1}-matrix"
    model = multicol_model(dev, units, dropout_rate=DROP_RATE)
    trainer = Trainer(model, seed=SEED, device=dev)
    trainer.compile(learning_rate=TRAIN_LR, bank_update="lazy")
    x, y = training_data()
    staged, launched, frozen = lazy_arm(
        card, f"multicol{tag} {bwd} lazy", model, trainer,
        {k: v[:ARM_ROWS] for k, v in x.items()}, y[:ARM_ROWS],
        (0, 0) + NO_K1 + K7_PAIR[bwd], f64=units != UNITS2)
    check({"domain_emb", "domain_bank.bank"} <= set(frozen),
          f"the parameters without a gradient are {frozen}, want "
          "domain_emb and domain_bank.bank among them")
    return trainer, staged, launched


def multicol_paths_phase(dev, card):
    """Phases 11b and 11c: serve the AliCCP multicol model, and train it
    in ``lazy`` once with each tiled backward; then the two backwards'
    staged steps in turns on one trainer.  Returns the launches by path
    and kernel."""
    paths = {"serve_multicol": {"tiled_meta_fwd": multicol_serving(dev,
                                                                   card)}}
    for bwd in ("stash", "recompute"):
        trainer, staged, paths[f"train_multicol_{bwd}_lazy"] = \
            multicol_training(dev, card, bwd)
        if bwd == "stash":
            del trainer, staged
            gc.collect()
            torch.cuda.empty_cache()
    for bwd in ("stash", "recompute", "recompute", "stash"):
        os.environ["SATRANS_TILED_BWD"] = bwd
        step_ms = time_ms(lambda: trainer.train_step(*staged), iters=10)
        queue_ms = host_ms(lambda: trainer.train_step(*staged))
        print(f"train multicol in turns, {bwd} [{card}]: train_step on a "
              f"staged batch {step_ms:.3f} ms/step; the host queues a step "
              f"in {queue_ms:.3f} ms", flush=True)
    os.environ.pop("SATRANS_TILED_BWD")
    del trainer, staged
    gc.collect()
    torch.cuda.empty_cache()
    return paths


# the probes of phase 12: the CLI's test batch (4 x 8192), the batches of
# predict_with_attention, the instances of dump_instance_attention and its
# threshold; K1-scores' probabilities against the plain layer's, and the
# two probe routes' (layer, domain, class) means against each other
PROBE_BATCH, PROBE_BATCHES, PROBE_INSTANCES = 4 * BATCH, 3, 1000
INST_THRESHOLD = 0.2
SCORES_TOL, ROW_SUM_TOL, PROBE_STATS_TOL = 1e-6, 1e-5, 1e-5
# phase 12c: the CLI at its defaults on synthetic data
CLI_ROWS = 200_000


def scores_kernel_phase(dev):
    """Phase 12a: K1-scores against the plain layer at the AliCCP sota
    width (B = 8192, F = 19): QK, and Query with relu_out, shared and
    distinct Q and K tables, dropout 0 and (in training, the same seed)
    0.1: the output within KERNEL_TOL, the probabilities within
    SCORES_TOL of the plain layer's clamped ones, each row summing to 1
    within ROW_SUM_TOL, and equal bit for bit to K1-stash's ``s`` on the
    same inputs, the output to K1-fwd's.  Times K1-scores beside K1-fwd
    and K1-stash, at B = 8192
    and at the probes' 32,768.  Returns the JSON fields."""
    from satrans_torch.nn import initializers as init
    from satrans_torch.ops import meta_block, prng

    F, d, h, heads, rows = 19, 32, 64, 4, 4
    units = [d, h, d]
    worst = {"y": 0.0, "s": 0.0, "row_sum": 0.0}
    same_y = []
    out = {}
    for pos in (False, True):
        if pos:
            gen, layer, tables = pos_test_layer(dev, SEED + 12)
        else:
            gen, layer, table = test_layer(dev, SEED + 12)
            tables = shared(table)
        x = init.normal(gen, (BATCH, F, d), 1.0)
        dom = torch.randint(0, rows, (BATCH,), generator=gen, device=dev)
        for mode, relu_out in (("QK", False), ("Query", True)):
            kw = dict(meta_units=units, head_num=heads, mode=mode,
                      relu_out=relu_out)
            for rate in (0.0, DROP_RATE):
                drop = drop_kw(rate) if rate else dict(
                    train=False, drop_rate=0.0, seed=0, block_b=DROP_TILE)
                kargs = prng.kernel_args(drop["train"], rate, DROP_SEED,
                                         DROP_TILE, F)
                masks = meta_block.layer_masks(x, head_num=heads, mode=mode,
                                               **drop)
                ops, cfg = meta_block.pack_operands(x, layer, tables, dom,
                                                    **kw)
                res = {}
                with torch.no_grad():
                    y, s = meta_block.fused_meta_layer_with_scores(
                        x, layer, tables, dom, **kw, **drop)
                    st = meta_block.launch_fwd(*ops, cfg, kargs,
                                               stash="full")
                    y_fwd = meta_block.launch_fwd(*ops, cfg, kargs)
                    ref = meta_block.meta_layer_reference(
                        x, layer, tables, dom, **kw, masks=masks,
                        residuals=res)
                torch.cuda.synchronize()
                errs = {"y": (y - ref).abs().max().item(),
                        "s": (s - res["s"]).abs().max().item(),
                        "row_sum": (s.sum(-1) - 1).abs().max().item()}
                for k, v in errs.items():
                    worst[k] = max(worst[k], v)
                same_s = torch.equal(s, st[4])
                same_y.append(torch.equal(y, y_fwd))
                print(f"kernel meta_block_fwd_scores B={BATCH} pos={pos} "
                      f"mode={mode} relu_out={relu_out} dropout={rate}: y "
                      f"max_abs_err={errs['y']:.3e}, s max_abs_err="
                      f"{errs['s']:.3e}, row sums within "
                      f"{errs['row_sum']:.3e} of 1; s bit-identical to "
                      f"K1-stash's: {same_s}; y bit-identical to K1-fwd's: "
                      f"{same_y[-1]}, to K1-stash's: "
                      f"{torch.equal(y, st[0])}", flush=True)
                case = (f"(pos={pos} mode={mode} relu_out={relu_out} "
                        f"dropout={rate})")
                check(bool(torch.isfinite(y).all()) and torch.allclose(
                    y, ref, **KERNEL_TOL), f"K1-scores' output disagrees "
                    f"with the plain layer {case}: {errs['y']}")
                check(s.shape == (BATCH, heads, F, F)
                      and bool(torch.isfinite(s).all())
                      and errs["s"] <= SCORES_TOL,
                      f"K1-scores' probabilities disagree with the plain "
                      f"layer's {case}: {errs['s']} > {SCORES_TOL}")
                check(errs["row_sum"] <= ROW_SUM_TOL,
                      f"K1-scores' rows do not sum to 1 {case}: "
                      f"{errs['row_sum']}")
                check(same_s, f"K1-scores' s differs from K1-stash's {case}")
                if not pos and mode == "QK" and rate == 0.0:
                    a = ("Q" in mode, "K" in mode)
                    with torch.no_grad():
                        for B in (BATCH, PROBE_BATCH):
                            xb = x if B == BATCH else x.repeat(4, 1, 1)
                            db = dom if B == BATCH else dom.repeat(4)
                            opsb, _ = meta_block.pack_operands(
                                xb, layer, tables, db, **kw)
                            t = {n: time_ms(lambda: meta_block.launch_fwd(
                                *opsb, cfg, kargs, stash=stash), iters=50)
                                for n, stash in (("fwd", None),
                                                 ("scores", "scores"),
                                                 ("stash", "full"),
                                                 ("scores_", "scores"),
                                                 ("fwd_", None))}
                            p_ms = time_ms(
                                lambda: meta_block.meta_layer_reference(
                                    xb, layer, tables, db, **kw,
                                    residuals={}), iters=5)
                            b_ms, b_by = meta_layer_bound_ms(
                                B, F, d, h, heads, rows, *a, stash="scores")
                            print(f"kernel meta_block_fwd_scores B={B}: "
                                  f"K1-scores kernel_ms={t['scores']:.4f} "
                                  f"(again {t['scores_']:.4f}), K1-fwd "
                                  f"{t['fwd']:.4f} (again {t['fwd_']:.4f}),"
                                  f" K1-stash {t['stash']:.4f}, plain_ms="
                                  f"{p_ms:.4f} bound_ms={b_ms:.4f} ({b_by})",
                                  flush=True)
                            out[B] = dict(ms=t["scores"], plain_ms=p_ms,
                                          bound_ms=b_ms, bound_by=b_by,
                                          fwd_ms=t["fwd"],
                                          stash_ms=t["stash"])
    print(f"K1-scores: y bit-identical to K1-fwd's in {sum(same_y)} of "
          f"{len(same_y)} cases", flush=True)
    check(all(same_y), "K1-scores' y differs from K1-fwd's, another mode of "
          "the same tile body")
    return dict(max_abs_err=max(worst["y"], worst["s"]),
                scores_max_abs_err=worst["s"], **out[BATCH],
                probe_batch_ms=out[PROBE_BATCH]["ms"])


def scores_count():
    from satrans_torch.ops import meta_block
    return meta_block.scores_launches


def probe_run(label, card, run, rows):
    """One probe call after the counts are set to 0, timed with the host
    clock; then its device busy share over a second call.  Returns (the
    first call's result, seconds, K1 counts, K1-scores launches)."""
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    result = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = (k1_counts(), scores_count())
    print(f"probe [{card}]: {label}: {rows} examples in {wall:.4f}s, "
          f"{rows / wall:.1f} examples/s; K1 launches {counts[0]}, "
          f"K1-scores {counts[1]}", flush=True)
    device_profile(label, run, 1e3 * wall, card)
    return result, wall, counts[0], counts[1]


def _dump_lines(prefix, domains):
    """{(domain, instance, layer, i, j): printed score} of a dump."""
    out = {}
    for dm in domains:
        with open(f"{prefix}_{dm}.txt") as f:
            for ln in f:
                idx, layer, i, j, score = ln.split("\t")
                out[(dm, idx, layer, i, j)] = float(score)
    return out


def probe_phase(dev, card):
    """Phase 12b: the probes at the CLI's test batch on phase 5's ids and
    the AliCCP sota model with phase 3's N(0, 1) embeddings (with the
    default N(0, 1e-4) ones the layers' inputs sit below the LayerNorms'
    epsilon and every attention row is within 0.01 of uniform, so no
    score would reach the dump's threshold): ``predict_with_attention``
    over 3 batches of 32,768 on K1-scores and under SATRANS_PROBE_FUSED=0
    (the plain layer), then ``dump_instance_attention`` of 1,000
    instances on both.  Returns the launches by path."""
    import tempfile

    from satrans_torch.data import aliccp
    from satrans_torch.features import FeatureLayout
    from satrans_torch.models import SATrans
    from satrans_torch.train import Trainer, attention_probe

    model = SATrans(FeatureLayout(aliccp.sota_columns(32)), ["301"], [3],
                    domain_att_layer_num=LAYERS, att_head_num=4,
                    meta_mode="QK", meta_dnn_hidden_units=(64, 32),
                    no_emb_init=True, seed=SEED, device=dev)
    trainer = Trainer(model, seed=SEED, device=dev)
    x, y = training_data()
    n = PROBE_BATCHES * PROBE_BATCH
    x = {k: v[:n] for k, v in x.items()}
    y = y[:n]
    paths, stats, preds, dumps = {}, {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for route in ("kernel", "plain"):
            if route == "plain":
                os.environ["SATRANS_PROBE_FUSED"] = "0"
            (preds[route], stats[route]), wall, k1, sc = probe_run(
                f"predict_with_attention, {route}", card,
                lambda: attention_probe.predict_with_attention(
                    trainer, x, y, batch_size=PROBE_BATCH), n)
            want = PROBE_BATCHES * LAYERS if route == "kernel" else 0
            check(k1 == NO_K1 and sc == want,
                  f"predict_with_attention on the {route} route launched "
                  f"{k1} ({', '.join(K1_COUNTS)}) and {sc} K1-scores, want "
                  f"{want} K1-scores and nothing else")
            prefix = os.path.join(tmp, route)
            domains, dwall, k1, sc = probe_run(
                f"dump_instance_attention of {PROBE_INSTANCES}, {route}",
                card, lambda: attention_probe.dump_instance_attention(
                    trainer, x, batch_size=PROBE_BATCH,
                    threshold=INST_THRESHOLD, out_prefix=prefix,
                    max_instances=PROBE_INSTANCES), PROBE_INSTANCES)
            want = LAYERS if route == "kernel" else 0
            check(k1 == NO_K1 and sc == want,
                  f"dump_instance_attention on the {route} route launched "
                  f"{k1} and {sc} K1-scores, want {want} K1-scores only")
            dumps[route] = _dump_lines(prefix, domains)
            if route == "kernel":
                paths = {"probe_showattn": PROBE_BATCHES * LAYERS,
                         "probe_instattn": LAYERS}
        os.environ.pop("SATRANS_PROBE_FUSED")
    check(preds["kernel"].shape == (n,) and bool(np.all(np.isfinite(
        preds["kernel"]))), "probe predictions not finite")
    pred_diff = float(np.abs(preds["kernel"] - preds["plain"]).max())
    stat_diff = max(
        float(np.abs(a[name] - b[name]).max())
        for la, lb in zip(stats["kernel"], stats["plain"])
        for a, b in zip(la, lb) for name in ("pos", "neg", "all"))
    print(f"probe: the two routes' predictions within {pred_diff:.3e}, "
          f"their (layer, domain, class) means within {stat_diff:.3e}",
          flush=True)
    check(pred_diff <= SERVING_TOL and stat_diff <= PROBE_STATS_TOL,
          f"the probe routes disagree: predictions {pred_diff}, means "
          f"{stat_diff} (tolerances {SERVING_TOL}, {PROBE_STATS_TOL})")
    a, b = dumps["kernel"], dumps["plain"]
    differ = [k for k in set(a) | set(b) if a.get(k) != b.get(k)]
    # a triple on one side only must lie at the threshold (its printed
    # score within 1e-4 + 1e-5 of it); a printed score may differ by one
    # unit of its last digit
    bad = [k for k in differ
           if (k in a and k in b and abs(a[k] - b[k]) > 1.0001e-4)
           or ((k in a) != (k in b) and abs(a.get(k, b.get(k))
                                            - INST_THRESHOLD) > 1.1e-4)]
    print(f"probe: instattn triples kernel {len(a)}, plain {len(b)}; "
          f"{len(differ)} differ ({len(bad)} away from the threshold and "
          f"the last printed digit)", flush=True)
    check(len(a) > 0 and not bad,
          f"the instattn dumps disagree: {sorted(bad)[:5]}")
    del model, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def cli_phase(dev, card):
    """Phase 12c: the CLI on the card at its defaults (d = 32, 3 layers, 4
    heads, Query, MetaNet 32 -> 64 -> 32, batch 8192, test batch 32,768,
    lr 0.001, dropout 0.1) on synthetic data, with the probes and the
    dump; the dumped checkpoint restored into a Trainer (its predictions
    on the probes' path equal the run's ``_testpred.pkl`` bit for bit, its
    Predictor's equal ``serving.load``'s bit for bit, both on K1-fwd, and
    those equal ``_testpred.pkl`` bit for bit); then a
    ``--finetune True`` run from it.  Returns the launches
    by path and kernel."""
    import pickle
    import tempfile

    from satrans_torch import serving
    from satrans_torch.cli import main as cli
    from satrans_torch.ops import meta_block
    from satrans_torch.train import metrics

    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--data_name", "synthetic", "--synthetic_rows",
                str(CLI_ROWS), "--flag", "showattn_instattn_dump",
                "--results_dir", os.path.join(tmp, "results"),
                "--checkpoint_dir", os.path.join(tmp, "checkpoints")]
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        auc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(zip(K1_NAMES, k1_counts()),
                      meta_block_fwd_scores=scores_count())
        args = cli.parse_args(argv)
        (train, test, target, sparse, dense, var, data_max, topk,
         _) = cli.load_dataset(args, args.flag, "domain")
        steps = -(-len(train[target]) // BATCH)
        test_batches = -(-len(test[target]) // PROBE_BATCH)
        want = dict(zip(K1_NAMES, NO_K1), meta_block_fwd_stash=LAYERS * steps,
                    meta_block_bwd_stash=LAYERS * steps,
                    meta_block_fwd_scores=LAYERS * (test_batches + 1))
        print(f"cli [{card}]: {len(train[target])} training rows in {steps} "
              f"steps, {len(test[target])} test rows; {wall:.2f}s; test AUC "
              f"{auc}; launches {counts}", flush=True)
        check(counts == want, f"the CLI launched {counts}, want {want}")
        paths["cli"] = counts
        config = cli.config_str(args, "domain", args.flag)
        ckpt = os.path.join(args.checkpoint_dir, config)
        with open(ckpt + "_testpred.pkl", "rb") as f:
            pred = pickle.load(f)
        y, dom = test[target], test["domain"]
        aucs = metrics.per_domain_auc(y, pred, dom)
        overall = metrics.auc(y, pred)
        print(f"cli [{card}]: test AUC {overall:.6f}, per domain "
              + ", ".join(f"{k}: {v:.6f}" for k, v in aucs.items()),
              flush=True)
        check(pred.shape == (len(y),) and bool(np.all(np.isfinite(pred)))
              and bool(np.all((pred > 0) & (pred < 1))),
              "the CLI's test predictions are not finite in (0, 1)")
        check(overall > 0.5 and len(aucs) == 3 and round(overall, 4) == auc,
              f"the CLI's test AUC {overall} (per domain {aucs})")
        with open(os.path.join(args.results_dir,
                               "synthetic_results.csv")) as f:
            row = f.read().splitlines()
        check(len(row) == 1 and config in row[0]
              and len(row[0].split(",")) == 6,
              f"the results CSV holds {row}")
        stats = np.load(os.path.join(args.results_dir, "attn_stats.npy"),
                        allow_pickle=True)
        check(stats.shape == (LAYERS, 3), f"attn_stats of shape "
                                          f"{stats.shape}")
        inst = sorted(p for p in os.listdir(args.results_dir)
                      if p.startswith("inst_attn_"))
        check(inst == ["inst_attn_1.txt", "inst_attn_2.txt",
                       "inst_attn_3.txt"], f"instattn files {inst}")

        layout = cli.feature_layout(args, sparse, dense, var, data_max, topk)
        nums = [max(len(np.unique(train["domain"])), data_max["domain"])]
        model = cli.build_model(args, layout, ["domain"], nums, args.flag,
                                device=dev)
        pred_serv = serving.load(ckpt, model, batch_size=PROBE_BATCH,
                                 device=dev)
        test_x = {k: test[k] for k in sparse}
        zero_counts()
        served = pred_serv(test_x)
        counts = dict(zip(K1_NAMES, k1_counts()))
        diff = float(np.abs(served - pred).max())
        # The dump came from the probes' path, K1-scores (the tile body of
        # csrc/meta_stash_fwd.cuh): the checkpoint restored into a Trainer
        # of its own model gives it bit for bit on that path, and served
        # through a Predictor (K1-fwd, as serving.load serves) gives
        # serving.load's predictions bit for bit.  K1-fwd is the no-stash
        # mode of the same tile body, whose y equals K1-scores' bit for
        # bit, so the served predictions equal the dumped ones bit for bit
        # too.
        from satrans_torch.train import Trainer, checkpoint
        from satrans_torch.train.attention_probe import \
            predict_with_attention
        restored = Trainer(cli.build_model(args, layout, ["domain"], nums,
                                           args.flag, device=dev),
                           seed=args.seed, device=dev)
        restored.compile(learning_rate=args.learning_rate,
                         loss="binary_crossentropy",
                         metrics=["binary_crossentropy", "auc"],
                         bank_update=args.bank_update)
        checkpoint.restore(ckpt, restored)
        with torch.no_grad():
            probed, _ = predict_with_attention(restored, test_x, y,
                                               batch_size=PROBE_BATCH)
        resaved = serving.Predictor.from_trainer(
            restored, batch_size=PROBE_BATCH)(test_x)
        print(f"cli [{card}]: serving.load of the checkpoint: launches "
              f"{counts}; bit-identical to the restored Trainer's Predictor: "
              f"{np.array_equal(served, resaved)}; max |served - "
              f"_testpred.pkl| = {diff:.3e}; the restored checkpoint on the "
              f"probes' path bit-identical to _testpred.pkl: "
              f"{np.array_equal(probed, pred)}", flush=True)
        check(counts["meta_block_fwd"] == LAYERS * test_batches
              and sum(counts.values()) == counts["meta_block_fwd"],
              f"serving.load's Predictor launched {counts}")
        check(np.array_equal(probed, pred), "the restored checkpoint's "
              "predictions on the probes' path differ from the dumped ones")
        check(np.array_equal(served, resaved), "serving.load's predictions "
              "differ from the restored Trainer's Predictor's")
        check(np.array_equal(served, pred), f"the served predictions "
              f"differ from the dumped ones by {diff}")
        paths["cli_serving_load"] = counts
        del restored
        del model, pred_serv

        t0 = time.perf_counter()
        auc2 = cli.main(argv + ["--finetune", "True"])
        wall2 = time.perf_counter() - t0
        with open(os.path.join(args.results_dir,
                               "synthetic_results.csv")) as f:
            rows = f.read().splitlines()
        print(f"cli [{card}]: --finetune True from the checkpoint: "
              f"{wall2:.2f}s, test AUC {auc2}", flush=True)
        check(len(rows) == 2 and np.isfinite(auc2),
              f"the finetune run wrote {rows}")
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def probes_and_cli_phase(dev, card):
    """Phase 12: K1-scores, the probes and the CLI.  Returns the K1-scores
    fields, its launches by path, and the other K1 bodies' launches by
    path and kernel on the CLI's paths."""
    t0 = time.perf_counter()
    fields = scores_kernel_phase(dev)
    scores_paths = probe_phase(dev, card)
    cli = cli_phase(dev, card)
    scores_paths["cli"] = cli["cli"]["meta_block_fwd_scores"]
    k1_paths = {p: {k: n[k] for k in K1_NAMES} for p, n in cli.items()}
    print(f"phase 12: {time.perf_counter() - t0:.2f}s", flush=True)
    return fields, scores_paths, k1_paths


def metanet3_layer_phase(dev):
    """Phase 13a, K1: every K1 body with 3-matrix MetaNets (units [32, 64,
    64, 32]) against its plain version, at B=8192 (dropout 0 and 0.1) and
    the ragged 8190 (dropout 0), F=19 with one table in QK and in Query
    with relu_out, and F=15 with distinct Q and K tables and a k_meta
    LayerNorm (the pos layer): K1-fwd's output, the residuals of K1-stash
    and K1-stash light, K1-scores' y and s, and the three backwards'
    gradients (x, the layer's parameters and the tables, whose middle
    block must move) against autograd of the plain layer with the same
    masks (examples at a relu kink given no upstream gradient), at the
    tolerances of phases 2 and 4.  Each body timed with its bound at
    F=19, QK, one table.  Returns the JSON fields by 2-matrix body name."""
    from satrans_torch.nn import initializers as init
    from satrans_torch.ops import meta_block, prng
    from satrans_torch.utils import make_generator

    d, h, h2, heads, rows = 32, 64, 64, 4, 4
    units = list(UNITS3)
    _, layer, table = test_layer(dev, SEED + 60, UNITS3)
    _, pos_layer, pos_tables = pos_test_layer(dev, SEED + 61, UNITS3)
    gen = make_generator(SEED + 62, dev)
    names = (*K1_NAMES, "meta_block_fwd_scores")
    worst = dict.fromkeys(names, 0.0)
    out = {}
    mid = slice(d * h, d * h + h * h2)  # the tables' middle block
    cases = []
    for B in (BATCH, BATCH - 2):
        for rate in (0.0, DROP_RATE) if B == BATCH else (0.0,):
            cases += [(B, rate, 19, "QK", False, False),
                      (B, rate, 19, "Query", True, False),
                      (B, rate, ALIMAMA_F, "QK", False, True)]
    for B, rate, F, mode, relu_out, pos in cases:
        lay = pos_layer if pos else layer
        tables = pos_tables if pos else shared(table)
        x = init.normal(gen, (B, F, d), 1.0)
        g_all = init.normal(gen, (B, F, d), 1.0)
        dom = torch.randint(0, rows, (B,), generator=gen, device=dev)
        kw = dict(meta_units=units, head_num=heads, mode=mode,
                  relu_out=relu_out)
        drop = drop_kw(rate)
        masks = meta_block.layer_masks(x, head_num=heads, mode=mode, **drop)
        ops, cfg = meta_block.pack_operands(x, lay, tables, dom, **kw)
        ops = [t if t is None else t.detach() for t in ops]
        kargs = prng.kernel_args(True, rate, DROP_SEED, DROP_TILE, F)
        res = {}
        with torch.no_grad():
            y = meta_block.fused_meta_layer(x, lay, tables, dom, **kw, **drop)
            st = {s: meta_block.launch_fwd(*ops, cfg, kargs, stash=s)
                  for s in ("full", "light", "scores")}
            ref = meta_block.meta_layer_reference(
                x, lay, tables, dom, **kw, masks=masks, residuals=res)
        torch.cuda.synchronize()
        what = (f"B={B} F={F} mode={mode} relu_out={relu_out} pos={pos} "
                f"dropout={rate}")
        errs = {"meta_block_fwd": (y - ref).abs().max().item()}
        check(bool(torch.isfinite(y).all()) and torch.allclose(
            y, ref, **KERNEL_TOL), f"3-matrix K1-fwd disagrees with the "
            f"plain layer ({what}, max_abs_err {errs['meta_block_fwd']})")
        fwd_same, fwd_gap = fwd_stash_gap(y, st["full"][0],
                                          f"3-matrix K1-fwd ({what})")
        for s, name in (("full", "meta_block_fwd_stash"),
                        ("light", "meta_block_fwd_stash_light"),
                        ("scores", "meta_block_fwd_scores")):
            got = st[s]
            want = (ref, *(res[n] for n in meta_block.STASH_RESIDUALS[s]))
            check(len(got) == len(want), f"3-matrix stash {s} returned "
                  f"{len(got)} tensors, want {len(want)}")
            errs[name] = max((a - b).abs().max().item()
                             for a, b in zip(got, want))
            for n, a, b in zip(("y", *meta_block.STASH_RESIDUALS[s]), got,
                               want):
                check(bool(torch.isfinite(a).all()) and torch.allclose(
                    a, b, **KERNEL_TOL), f"3-matrix {name}'s {n} disagrees "
                    f"with the plain layer's ({what}, tolerance "
                    f"{KERNEL_TOL})")
        g, kinks = kink_free(g_all, x, lay, tables, dom, masks, **kw)
        want = layer_grads(meta_block.meta_layer_reference, x, lay, tables,
                           dom, g, **kw, masks=masks)
        for bwd, name in K1_BWD_NAME.items():
            got = layer_grads(meta_block.fused_meta_layer, x, lay, tables,
                              dom, g, **kw, **drop, bwd=bwd)
            torch.cuda.synchronize()
            errs[name] = max(grad_errors(got, want).values())
            check(all(got[n][:, mid].abs().max().item() > 0
                      for n in got if n.startswith("table")),
                  f"3-matrix {name}: a table's middle block got no "
                  f"gradient ({what})")
        for n, e in errs.items():
            worst[n] = max(worst[n], e)
        line = (f"kernel 3-matrix {what}: " + ", ".join(
            f"{n} {e:.3e}" for n, e in errs.items())
            + f" ({kinks} examples at a kink left out); K1-fwd's y "
            f"bit-identical to K1-stash's: {fwd_same} (max_abs_diff "
            f"{fwd_gap:.3e})")
        if B == BATCH and F == 19 and mode == "QK":
            with torch.no_grad():
                p_ms = time_ms(lambda: meta_block.meta_layer_reference(
                    x, lay, tables, dom, **kw, masks=masks), iters=10)
                for s, name in ((None, "meta_block_fwd"),
                                ("full", "meta_block_fwd_stash"),
                                ("light", "meta_block_fwd_stash_light"),
                                ("scores", "meta_block_fwd_scores")):
                    ms = time_ms(lambda: meta_block.launch_fwd(
                        *ops, cfg, kargs, stash=s), iters=50)
                    b_ms, b_by = meta_layer_bound_ms(
                        B, F, d, h, heads, rows, 1, 1, stash=s, h2=h2)
                    out[(name, rate)] = dict(ms=ms, plain_ms=p_ms,
                                             bound_ms=b_ms, bound_by=b_by)
            xr = x.detach().requires_grad_(True)
            tr = table.detach().requires_grad_(True)
            inputs = [xr, tr, *lay.parameters()]
            yr = meta_block.meta_layer_reference(xr, lay, shared(tr), dom,
                                                 **kw, masks=masks)
            pb_ms = time_ms(lambda: torch.autograd.grad(
                yr, inputs, g, retain_graph=True), iters=5)
            del yr
            full_res = st["full"][1:]
            light_res = [full_res[i] for i in (0, 1, 2, 4)]
            for bwd, name in K1_BWD_NAME.items():
                r = {"stash": full_res, "stash_light": light_res}.get(bwd)
                ms = time_ms(lambda: meta_block.launch_bwd(
                    g, *ops, cfg, kargs, res=r), iters=20)
                b_ms, b_by = meta_layer_bwd_bound_ms(
                    B, F, d, h, heads, rows, 1, 1, h2=h2, stash={
                        "stash": "full", "stash_light": "light"}.get(bwd))
                out[(name, rate)] = dict(ms=ms, plain_ms=pb_ms,
                                         bound_ms=b_ms, bound_by=b_by)
            line += "; " + ", ".join(
                f"{n} kernel_ms={out[(n, rate)]['ms']:.4f} bound_ms="
                f"{out[(n, rate)]['bound_ms']:.4f}" for n in names) + (
                f"; plain forward {p_ms:.4f} ms, backward {pb_ms:.4f} ms")
        print(line, flush=True)
        del st
    fields = {}
    for name in names:
        # the serving and probe bodies at dropout 0, the training ones at
        # 0.1 (phases 2, 4 and 12)
        serve = name in ("meta_block_fwd", "meta_block_fwd_scores")
        main, other = (0.0, DROP_RATE) if serve else (DROP_RATE, 0.0)
        fields[name] = dict(max_abs_err=worst[name], **out[(name, main)])
        fields[name]["dropout_ms" if serve else "no_dropout_ms"] = \
            out[(name, other)]["ms"]
    return fields


def staged_steps(card, label, trainer, staged, per_step, steps=5):
    """``steps`` train_step calls on a staged batch after the launch counts
    are set to 0: finite losses and exactly ``per_step`` launches a step of
    each layer kernel (LAYER_NAMES order).  Returns the launches by
    kernel."""
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    losses = [trainer.train_step(*staged)["loss"] for _ in range(steps)]
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / steps
    got = layer_counts()
    want = tuple(LAYERS * steps * c for c in per_step)
    check(got == want, f"{label}: {steps} staged steps launched {got} "
                       f"({', '.join(LAYER_NAMES)}), want {want}")
    check(bool(torch.isfinite(torch.stack(losses)).all()),
          f"{label}: a staged step's loss is not finite")
    print(f"train {label} [{card}]: {steps} train_step calls on a staged "
          f"batch, {ms:.3f} ms/step with the host clock; launches {got}",
          flush=True)
    return dict(zip(LAYER_NAMES, got))


def metanet3_paths_phase(dev, card):
    """Phases 13b and 13c: the AliCCP sota model with 3-matrix MetaNets
    (meta_dnn_hidden_units=(64, 64, 32)): 3 requests of 20,000 through
    Predictor (K1-fwd only, against the plain path); ``lazy`` training at
    dropout 0.1 under bwd='stash' for 12 steps and a tail
    (:func:`lazy_arm`: one step's gradients kernel vs plain path, 3 + 3
    launches a step, a falling loss, the staged step and its profile),
    then staged steps under 'stash_light' and 'recompute' (their K1
    pairs); one ``predict_with_attention`` batch of 32,768 on K1-scores.
    Then the multicol model with them: one request (K7-fwd), ``lazy``
    training under SATRANS_TILED_BWD=stash (:func:`lazy_arm`) and staged
    steps under recompute.  Returns the launches by path and kernel."""
    from satrans_torch.data import aliccp
    from satrans_torch.features import FeatureLayout
    from satrans_torch.models import SATrans
    from satrans_torch.serving import Predictor
    from satrans_torch.train import attention_probe

    paths = {}
    kw = dict(domain_att_layer_num=LAYERS, att_head_num=4, meta_mode="QK",
              meta_dnn_hidden_units=UNITS3[1:], no_emb_init=True, seed=SEED,
              device=dev)
    layout = FeatureLayout(aliccp.sota_columns(32))
    model = SATrans(layout, ["301"], [3], **kw)
    check(model.metanet_kernel and model.meta_units == list(UNITS3),
          "the 3-matrix model does not take the K1 route")
    pred = Predictor(model, batch_size=BATCH, device=dev).warmup()
    rng = np.random.default_rng(SEED + 70)
    reqs = [{name: rng.integers(1, aliccp.DATA_MAX[name] + 1, REQUEST_ROWS)
             for name in aliccp.SPARSE_FEATURES} for _ in range(REQUESTS)]
    batches = REQUESTS * -(-REQUEST_ROWS // BATCH)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    scores = [pred(r) for r in reqs]
    wall = time.perf_counter() - t0
    launched = layer_counts()
    want = (0, 0, LAYERS * batches) + NO_K1[1:] + NO_K7
    check(launched == want and scores_count() == 0,
          f"serving 3-matrix launched {launched} ({', '.join(LAYER_NAMES)})"
          f", want {want}")
    paths["serve_3mat"] = {"meta_block_fwd": LAYERS * batches}
    device_profile(f"serve 3-matrix: one request of {REQUEST_ROWS} "
                   "examples", lambda: pred(reqs[0]),
                   1e3 * wall / REQUESTS, card)
    plain_model = SATrans(layout, ["301"], [3], route="plain", **kw)
    plain_model.load_state_dict(model.state_dict())
    plain = Predictor(plain_model, batch_size=BATCH, device=dev)
    diff = max(float(np.abs(a - plain(r)).max())
               for a, r in zip(scores, reqs))
    n = REQUESTS * REQUEST_ROWS
    print(f"serve 3-matrix [{card}]: {n} examples in {batches} batches of "
          f"{BATCH}: {wall:.4f}s, {n / wall:.1f} examples/s, "
          f"{1e3 * wall / batches:.3f} ms/batch; score mean "
          f"{np.mean(scores):.4f} std {np.std(scores):.4f}; max |kernel - "
          f"plain| = {diff:.3e}", flush=True)
    check(all(np.all(np.isfinite(a)) and np.all((a > 0) & (a < 1))
              for a in scores), "serving 3-matrix: scores not finite in "
                                "(0, 1)")
    check(diff <= SERVING_TOL, f"serving 3-matrix: scores differ from the "
                               f"plain path by {diff} > {SERVING_TOL}")
    del model, plain_model, pred, plain
    gc.collect()
    torch.cuda.empty_cache()

    os.environ["SATRANS_BWD"] = "stash"
    model, trainer = training_model(dev, "lazy", units=UNITS3)
    x, y = training_data()
    staged, paths["train_3mat_stash_lazy"], _ = lazy_arm(
        card, "3-matrix stash lazy", model, trainer,
        {k: v[:ARM_ROWS] for k, v in x.items()}, y[:ARM_ROWS],
        (0, 0) + K1_PAIR["stash"] + NO_K7, f64=True)
    for bwd in ("stash_light", "recompute"):
        os.environ["SATRANS_BWD"] = bwd
        paths[f"train_3mat_{bwd}_staged"] = staged_steps(
            card, f"3-matrix {bwd}", trainer, staged,
            (0, 0) + K1_PAIR[bwd] + NO_K7)
    os.environ.pop("SATRANS_BWD")
    xp = {k: v[:PROBE_BATCH] for k, v in x.items()}
    (probe_pred, _), _, k1, sc = probe_run(
        f"3-matrix predict_with_attention, one batch of {PROBE_BATCH}",
        card, lambda: attention_probe.predict_with_attention(
            trainer, xp, y[:PROBE_BATCH], batch_size=PROBE_BATCH),
        PROBE_BATCH)
    check(k1 == NO_K1 and sc == LAYERS and probe_pred.shape == (
        PROBE_BATCH,) and bool(np.all(np.isfinite(probe_pred))),
          f"the 3-matrix probe launched {k1} and {sc} K1-scores (want "
          f"{LAYERS} K1-scores only), or its predictions are not finite")
    paths["probe_3mat"] = {"meta_block_fwd_scores": sc}
    del model, trainer, staged
    gc.collect()
    torch.cuda.empty_cache()

    paths["serve_multicol_3mat"] = {"tiled_meta_fwd": multicol_serving(
        dev, card, UNITS3)}
    trainer, staged, paths["train_multicol_3mat_stash_lazy"] = \
        multicol_training(dev, card, "stash", UNITS3)
    os.environ["SATRANS_TILED_BWD"] = "recompute"
    paths["train_multicol_3mat_recompute_staged"] = staged_steps(
        card, "multicol 3-matrix recompute", trainer, staged,
        (0, 0) + NO_K1 + K7_PAIR["recompute"])
    os.environ.pop("SATRANS_TILED_BWD")
    del trainer, staged
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def metanet3_phase(dev, card):
    """Phase 13: 3-matrix MetaNets.  Returns the JSON fields by 2-matrix
    body name (K1's and K7's) and the launches by path and kernel."""
    t0 = time.perf_counter()
    fields = metanet3_layer_phase(dev)
    fields.update(tiled_kernel_phase(dev, UNITS3, cases=[
        ("QK", False, 0.0, False), ("QK", False, DROP_RATE, False),
        ("Query", True, DROP_RATE, False), ("QK", False, DROP_RATE, True)]))
    paths = metanet3_paths_phase(dev, card)
    print(f"phase 13: {time.perf_counter() - t0:.2f}s", flush=True)
    return fields, paths


# P1 and P2 (phase 14): name in the JSON line, probe module, the TPU
# function they replace
ROW_DMA = (("row_dma_scatter", "scatter_probe",
            "satrans_tpu/bench/pallas_scatter_probe.py:118 (pallas_scatter "
            ":109, _scatter_kernel :42)"),
           ("row_dma_gather", "gather_probe",
            "satrans_tpu/bench/pallas_gather_probe.py:96 (pallas_gather "
            ":87, _gather_kernel :46)"))


def row_dma_phase(dev, card):
    """Phase 14: the row-DMA probes P1 and P2 at their production shape,
    run as ``python3 -m satrans_torch.bench.scatter_probe`` (and
    ``gather_probe``) run them, with the launch counts from 0.  Returns the
    JSON fields and the launches by kernel."""
    import importlib
    t0 = time.perf_counter()
    out, launched = {}, {}
    for name, module, _ in ROW_DMA:
        probe = importlib.import_module(f"satrans_torch.bench.{module}")
        # an N that rb does not divide raises, on the card as on the CPU
        ids = torch.arange(130, device=dev)
        bank = torch.zeros(200, 128, device=dev)
        try:
            if module == "scatter_probe":
                probe.row_dma_scatter(bank, ids, bank[:130], rb=128)
            else:
                probe.row_dma_gather([bank], ids, rb=128)
            raised = False
        except ValueError:
            raised = True
        check(raised, f"{name}: N = 130 at rb 128 did not raise")
        zero_counts()
        res = probe.main([])
        launched[name] = probe.launches
        errs = res["max_abs_err"]
        arrays = (1, 3) if module == "gather_probe" else (None,)
        keys = [f"tma_{v}_rb{rb}" + (f"_x{a}" if a else "")
                for v in probe.VARIANTS for rb in probe.RBS for a in arrays]
        check(sorted(errs) == sorted(keys)
              and all(e == 0.0 for e in errs.values()),
              f"{name}: not every variant and rb equals its plain version: "
              f"{errs}")
        ms = res["ms"]
        if module == "scatter_probe":
            tma = {k: ms[k] for k in keys}
            best = min(tma, key=tma.get)
            fields = dict(ms=tma[best], variant=best, ms_by_variant=tma,
                          plain_ms=ms["plain"], library_ms=ms["index_copy_"],
                          k2_ms=ms["k2_scatter_rows_set"],
                          null_ms=ms["null_body"], bound_ms=res["bound_ms"])
        else:
            tma = {k: ms[k] for k in keys}
            x1 = {k: v for k, v in tma.items() if k.endswith("_x1")}
            best = min(x1, key=x1.get)
            best3 = min((k for k in tma if k.endswith("_x3")), key=tma.get)
            fields = dict(ms=x1[best], variant=best, ms_by_variant=tma,
                          ms_x3=tma[best3], variant_x3=best3,
                          plain_ms=ms["plain_x1"],
                          library_ms=ms["index_select_x1"],
                          plain_ms_x3=ms["plain_x3"],
                          library_ms_x3=ms["index_select_x3"],
                          k4_ms=ms["k4_gather_rows_x1"],
                          k4_ms_x3=ms["k4_gather_rows_x3"],
                          null_ms=ms["null_body"],
                          bound_ms=res["bound_ms"]["x1"],
                          bound_ms_x3=res["bound_ms"]["x3"])
        out[name] = dict(fields, max_abs_err=max(errs.values()),
                         bound_by="bytes", workload=res["workload"])
        print(f"kernel {name} [{card}]: {res['workload']}: every variant "
              f"and rb exact; fastest {best} {fields['ms']:.4f} ms, plain "
              f"{fields['plain_ms']:.4f}, library {fields['library_ms']:.4f},"
              f" bound {fields['bound_ms']:.4f} ms (bytes); launches "
              f"{launched[name]}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"phase 14: {time.perf_counter() - t0:.2f}s", flush=True)
    return out, launched


# each bench arm's kernel launches a step (phase 15): the stash pair, and
# in lazy the split tail's K4, K2, K3 or the fused tail's K4, K3, K5
BENCH_PER_STEP = {
    "dense": {},
    "lazy": dict(zip(ROW_NAMES, LAZY_ROWS_PER_STEP)),
    "lazy_fusedtail": dict(zip(ROW_NAMES, SPARSE_ARMS[3][3])),
    "alimama_pos_lazy": dict(zip(ROW_NAMES, LAZY_ROWS_PER_STEP)),
}


def bench_phase(card):
    """Phase 15: ``python3 -m satrans_torch.bench.train_throughput --chunks
    1`` in-process, the launch counts from 0.  Returns the launches by
    kernel."""
    from satrans_torch.bench import train_throughput
    t0 = time.perf_counter()
    os.environ.pop("SATRANS_BWD", None)
    os.environ.pop("SATRANS_LAZY_TAIL", None)
    zero_counts()
    recs = train_throughput.main(["--chunks", "1"])
    launched = train_throughput.launch_counts()
    arms, summary = recs[:-1], recs[-1]
    check([a["arm"] for a in arms] == list(BENCH_PER_STEP),
          f"bench arms {[a['arm'] for a in arms]}")
    for a in arms:
        want = {"meta_block_fwd_stash": LAYERS,
                "meta_block_bwd_stash": LAYERS,
                **{k: v for k, v in BENCH_PER_STEP[a["arm"]].items() if v}}
        check(np.isfinite(a["loss"]) and a["examples_per_s"] > 0
              and a["fit_examples_per_s"] > 0,
              f"bench {a['arm']}: loss {a['loss']}, examples/s "
              f"{a['examples_per_s']}, fit {a['fit_examples_per_s']}")
        check(a["launches_per_step"] == want,
              f"bench {a['arm']}: launches a step {a['launches_per_step']}, "
              f"want {want}")
        print(f"bench {a['arm']} [{card}]: {a['examples_per_s']:.1f} "
              f"examples/s, {a['ms_per_step']:.3f} ms/step staged, busy "
              f"{a['device_busy_ms']} ms a step; fit "
              f"{a['fit_examples_per_s']:.1f} examples/s; build "
              f"{a['build_s']:.2f}s", flush=True)
    check(summary["metric"] == "satrans_train_throughput"
          and summary["value"] > 0, f"bench summary {summary}")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 15: {time.perf_counter() - t0:.2f}s", flush=True)
    return {k: v for k, v in launched.items() if v}


# the baseline zoo of phase 16, as the CLI names the models
ZOO_MODELS = ("WDL", "DeepFM", "DCN", "xDeepFM", "NFM", "AFM", "PNN",
              "AutoInt", "FiBiNET", "AdaSparse")
ZOO_STEPS, ZOO_LR = 3, 0.001
# the card-vs-CPU forward: its rows, and every parameter redrawn N(0,
# 0.1) first, so that each layer moves the predictions (the default init
# draws the embeddings and the DNN at N(0, 1e-4)); float32 sums in
# another order on the two devices
ZOO_FWD_ROWS, ZOO_FWD_STD, ZOO_FWD_TOL = 2048, 0.1, 1e-5
# the repaired route: SATrans at dropout 0.1 at a batch no dropout tile
# (128, 256, ..., 16) divides
UNTILED_BATCH = 8190


def zoo_model(dev, name, flag="None", **over):
    """``name`` as ``satrans_torch.cli.main.build_model`` builds it for
    ``--model_name name`` at the AliCCP sota layout (scenario column
    ``301``, 3 domains), its attributes then set from ``over``."""
    from satrans_torch.cli import main as cli
    from satrans_torch.data import aliccp
    from satrans_torch.features import FeatureLayout
    args = cli.parse_args(["--model_name", name, "--flag", flag])
    model = cli.build_model(args, FeatureLayout(aliccp.sota_columns(32)),
                            ["301"], [3], flag, device=dev)
    for k, v in over.items():
        setattr(model, k, v)
    return model


def zoo_batch(name):
    """The CLI's batch size for ``name``."""
    return 4096 if name == "xDeepFM" else BATCH


def zoo_fit(trainer, x, y, bsz, steps=ZOO_STEPS):
    """``steps`` full steps of ``fit`` after the counts are set to 0:
    (seconds, per-step data losses, the row kernels' launches (K4, K2,
    K3, K5), the layer kernels')."""
    from satrans_torch.ops import eqgemm, gather, lazy_tail, scatter
    from satrans_torch.train import callbacks
    losses = []

    class Record(callbacks.Callback):
        def on_batch_end(self, step, logs=None):
            losses.append(logs["loss"])

    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    trainer.fit({k: v[:steps * bsz] for k, v in x.items()},
                y[:steps * bsz], batch_size=bsz, epochs=1, verbose=0,
                callbacks=[Record()])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = tuple(m.launches for m in (gather, scatter, eqgemm, lazy_tail))
    layers = layer_counts()
    step_loss = torch.stack(losses).cpu().numpy()
    check(len(step_loss) == steps and bool(np.isfinite(step_loss).all()),
          f"zoo: the loss is not finite at every step: {step_loss}")
    return wall, step_loss, rows, layers


def zoo_forward_check(dev, card, name, x, model=None):
    """``name``'s eval forward on the card (``model``, else a new one),
    every parameter redrawn N(0, ZOO_FWD_STD) from a seeded generator and
    every buffer kept, against a CPU copy of it on the first ZOO_FWD_ROWS
    rows.  Returns the largest difference."""
    model = (zoo_model(dev, name) if model is None else model).eval()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    data = model.layout.batch_from_dict(
        {k: v[:ZOO_FWD_ROWS] for k, v in x.items()})
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, ZOO_FWD_STD, generator=gen)
        got = model({k: torch.from_numpy(v).to(dev)
                     for k, v in data.items()}).cpu()
        host = copy.deepcopy(model).cpu()
        want = host({k: torch.from_numpy(v) for k, v in data.items()})
    del model, host
    err = (got - want).abs().max().item()
    std = got.std().item()
    print(f"zoo {name} [{card}]: forward of {ZOO_FWD_ROWS} on the card vs "
          f"the CPU, parameters N(0, {ZOO_FWD_STD}): max_abs_err "
          f"{err:.3e}; predictions mean {got.mean().item():.4f} std "
          f"{std:.4f}", flush=True)
    check(bool(torch.isfinite(got).all()) and err <= ZOO_FWD_TOL
          and std > 1e-3, f"zoo {name}: the card's forward differs from "
                          f"the CPU's by {err} > {ZOO_FWD_TOL}, or its "
                          f"predictions' std is {std}")
    return err


def zoo_model_run(dev, card, name, x, y):
    """Phase 16 for one model: the forward check, then training (``lazy``
    with the split tail and with the fused one; AdaSparse ``dense``, and
    its ``lazy`` refused), timed and profiled.  Returns the launches by
    kernel and the forward's error."""
    from satrans_torch.train import Trainer, bank_optimizer
    bsz = zoo_batch(name)
    err = zoo_forward_check(dev, card, name, x)
    model = zoo_model(dev, name)
    sparse = bank_optimizer.eligible(model)
    check(sparse == (name != "AdaSparse"),
          f"zoo {name}: standard_bank_access is {sparse}")
    if not sparse:
        try:
            Trainer(model, device=dev).compile(bank_update="lazy")
            refused = False
        except ValueError:
            refused = True
        check(refused, f"zoo {name}: bank_update='lazy' was not refused")
    trainer = Trainer(model, seed=SEED, device=dev)
    launched = {}
    arms = (("lazy", None), ("lazy", "fused")) if sparse else \
        (("dense", None),)
    for mode, tail in arms:
        if tail:
            os.environ["SATRANS_LAZY_TAIL"] = tail
        if not launched:
            trainer.compile(learning_rate=ZOO_LR, bank_update=mode)
            zoo_fit(trainer, x, y, bsz, 1)  # warmup: one step
        wall, step_loss, rows, layers = zoo_fit(trainer, x, y, bsz)
        per_step = {"lazy": dict(zip(ROW_NAMES, LAZY_ROWS_PER_STEP)),
                    "fused": dict(zip(ROW_NAMES, SPARSE_ARMS[3][3]))}.get(
            tail or mode, {})
        want = tuple(ZOO_STEPS * per_step.get(n, 0) for n in ROW_NAMES)
        check(rows == want and not any(layers),
              f"zoo {name} {mode} {tail or 'split'}: {ZOO_STEPS} steps "
              f"launched {rows} ({', '.join(ROW_NAMES)}) and {layers} "
              f"layer kernels, want {want} and none")
        for k, n in zip(ROW_NAMES, rows):
            launched[k] = launched.get(k, 0) + n
        arm = f"{mode}" + (f" tail {tail}" if tail else "")
        batch, yb, wb = staged_batch(trainer, x, y, bsz)
        step_ms = time_ms(lambda: trainer.train_step(batch, yb, wb), iters=5)
        print(f"zoo {name} {arm} [{card}]: {ZOO_STEPS} steps of {bsz}: "
              f"{wall:.4f}s, {ZOO_STEPS * bsz / wall:.1f} trained "
              f"examples/s; losses per example "
              f"{(step_loss / bsz).round(6).tolist()}; launches {rows}; "
              f"train_step on a staged batch {step_ms:.3f} ms, "
              f"{1e3 * bsz / step_ms:.1f} examples/s", flush=True)
        if tail is None:
            device_profile(f"zoo {name} {arm}: one training step of {bsz}",
                           lambda: trainer.train_step(batch, yb, wb),
                           step_ms, card, top=6)
        os.environ.pop("SATRANS_LAZY_TAIL", None)
        del batch
    del model, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return launched, err


def zoo_fused_vs_dense(dev, card, x, y):
    """DeepFM after 3 steps in ``fused`` and in ``dense`` from one start:
    every parameter bit for bit."""
    from satrans_torch.train import Trainer
    params = {}
    for mode in ("dense", "fused"):
        model = zoo_model(dev, "DeepFM")
        trainer = Trainer(model, seed=SEED, device=dev)
        trainer.compile(learning_rate=ZOO_LR, bank_update=mode)
        trainer.fit({k: v[:ZOO_STEPS * BATCH] for k, v in x.items()},
                    y[:ZOO_STEPS * BATCH], batch_size=BATCH, verbose=0)
        params[mode] = {k: v.detach().clone()
                        for k, v in model.state_dict().items()}
        del model, trainer
    differ = [k for k, v in params["dense"].items()
              if not torch.equal(params["fused"][k], v)]
    worst = max((params["fused"][k] - params["dense"][k]).abs().max().item()
                for k in params["dense"])
    print(f"zoo DeepFM fused vs dense [{card}]: after {ZOO_STEPS} steps "
          f"{len(params['dense']) - len(differ)} of {len(params['dense'])} "
          f"parameters bit-identical; max_abs_err {worst:.3e}", flush=True)
    check(not differ, f"zoo DeepFM: fused differs from dense in {differ}")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def zoo_dropout_case(dev, card, x, y):
    """WDL at ``dnn_dropout`` 0.1 in ``lazy``: the masks its DNN's
    ``core.dropout`` draws inside ``fit`` (the JAX package's
    ``jax.random.bernoulli`` masks, ``ops/threefry.py``), recorded as they
    are drawn in a first run of ZOO_STEPS steps: one a DNN layer a step,
    layer ``i`` of step 1 from ``fold_in(sub, i)`` of the Trainer's first
    step key ``sub``, a new key every step, each keeping 0.9 of its
    elements within KEEP_SHARE_TOL; the first equals the CPU's mask of
    its key.  Then a timed run.  Returns the launches by kernel."""
    from satrans_torch.ops import threefry
    from satrans_torch.train import Trainer
    model = zoo_model(dev, "WDL", dnn_dropout=DROP_RATE)
    trainer = Trainer(model, seed=SEED, device=dev)
    trainer.compile(learning_rate=ZOO_LR, bank_update="lazy")
    drawn, draw = [], threefry.bernoulli

    def record(key, p, shape, device="cpu"):
        mask = draw(key, p, shape, device)
        drawn.append((tuple(int(w) for w in key), tuple(shape), p,
                      mask.double().mean().item()))
        return mask

    threefry.bernoulli = record
    try:
        zoo_fit(trainer, x, y, BATCH)  # the recorded run, and the warmup
    finally:
        threefry.bernoulli = draw
    layers = len(model.dnn.layers)
    sub = threefry.split(threefry.PRNGKey(SEED + 1))[1]  # step 1's key
    want_keys = [tuple(threefry.fold_in(sub, i)) for i in range(layers)]
    shares = [share for *_, share in drawn]
    step_keys = [drawn[s * layers][0] for s in range(ZOO_STEPS)]
    check(len(drawn) == ZOO_STEPS * layers
          and [k for k, *_ in drawn[:layers]] == want_keys
          and len(set(step_keys)) == ZOO_STEPS
          and all(sh[0] == BATCH and p == 1 - DROP_RATE
                  for _, sh, p, _ in drawn)
          and all(abs(s - (1 - DROP_RATE)) <= KEEP_SHARE_TOL for s in shares),
          f"zoo WDL dropout: fit drew {len(drawn)} masks, want "
          f"{ZOO_STEPS * layers}: keys, shapes, p and keep shares "
          f"{drawn}; step 1's keys want {want_keys}")
    key, shape, _, _ = drawn[0]
    check(torch.equal(threefry.bernoulli(key, 1 - DROP_RATE, shape,
                                         dev).cpu(),
                      threefry.bernoulli(key, 1 - DROP_RATE, shape)),
          "zoo WDL dropout: the card's mask is not the CPU's")
    wall, step_loss, rows, layer_launches = zoo_fit(trainer, x, y, BATCH)
    check(rows == tuple(ZOO_STEPS * c for c in LAZY_ROWS_PER_STEP)
          and not any(layer_launches), f"zoo WDL dropout: launches {rows}, "
                                       f"{layer_launches}")
    print(f"zoo WDL dnn_dropout {DROP_RATE} lazy [{card}]: keep share of "
          f"the {len(drawn)} masks fit drew in {ZOO_STEPS} steps "
          f"({layers} DNN layers, a new key a step) {shares}; "
          f"{ZOO_STEPS * BATCH / wall:.1f} trained examples/s; losses per "
          f"example {(step_loss / BATCH).round(6).tolist()}", flush=True)
    del model, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return dict(zip(ROW_NAMES, rows))


def untiled_dropout_case(dev, card, x, y):
    """SATrans (phase 5's model, dropout 0.1) in ``lazy`` at batch 8190:
    the JAX package's XLA route, its masks drawn with the step key; no
    layer kernel, the lazy row kernels a step, finite losses.  Returns
    the launches by kernel."""
    model, trainer = training_model(dev, "lazy")
    check(model.block_b(UNTILED_BATCH) is None,
          f"a dropout tile divides {UNTILED_BATCH}")
    zoo_fit(trainer, x, y, UNTILED_BATCH, 1)  # warmup: one step
    wall, step_loss, rows, layers = zoo_fit(trainer, x, y, UNTILED_BATCH)
    check(rows == tuple(ZOO_STEPS * c for c in LAZY_ROWS_PER_STEP)
          and not any(layers), f"SATrans at batch {UNTILED_BATCH}: "
                               f"launches {rows}, {layers}")
    print(f"train SATrans lazy at batch {UNTILED_BATCH}, dropout "
          f"{DROP_RATE} [{card}]: the XLA route, no layer kernel; "
          f"{ZOO_STEPS * UNTILED_BATCH / wall:.1f} trained examples/s; "
          f"losses per example "
          f"{(step_loss / UNTILED_BATCH).round(6).tolist()}", flush=True)
    batch, yb, wb = staged_batch(trainer, x, y, UNTILED_BATCH)
    step_ms = time_ms(lambda: trainer.train_step(batch, yb, wb), iters=3)
    device_profile(f"SATrans lazy at batch {UNTILED_BATCH}, the XLA route: "
                   "one training step", lambda: trainer.train_step(
                       batch, yb, wb), step_ms, card, top=8)
    del model, trainer, batch
    gc.collect()
    torch.cuda.empty_cache()
    return dict(zip(ROW_NAMES, rows))


def zoo_phase(dev, card):
    """Phase 16: the baseline zoo and the repaired XLA route.  Returns
    the launches by path and kernel."""
    t0 = time.perf_counter()
    x, y = training_data()
    paths, errs = {}, {}
    for name in ZOO_MODELS:
        paths[f"zoo_{name}"], errs[name] = zoo_model_run(dev, card, name,
                                                         x, y)
    zoo_fused_vs_dense(dev, card, x, y)
    paths["zoo_WDL_dropout"] = zoo_dropout_case(dev, card, x, y)
    paths["satrans_untiled_dropout"] = untiled_dropout_case(dev, card, x, y)
    print(f"phase 16: {time.perf_counter() - t0:.2f}s; the forwards' worst "
          f"error {max(errs.values()):.3e}", flush=True)
    return paths


# phase 17: STAR and the multi-task models, as the CLI names them; ESMM
# (two tasks) through the Python API on ids of 301 drawn from {1, 2}
STAR_MTL_MODELS = ("Star_Net", "SharedBottom", "MMOE", "PLE", "ESMM")
# MMOE's serving check: a request the batch does not divide
STAR_MTL_REQUEST = 20_000
# the CLI runs' synthetic rows: 4 training steps of the batch, 8,192 tests
STAR_MTL_CLI_ROWS = 40_960


def star_mtl_model(dev, name):
    """``name`` as the CLI builds it at the AliCCP sota layout (3
    domains); ESMM with ``num_tasks=2`` on the scenario column 301."""
    if name != "ESMM":
        return zoo_model(dev, name)
    from satrans_torch.data import aliccp
    from satrans_torch.features import FeatureLayout
    from satrans_torch.models import ESMM
    return ESMM(FeatureLayout(aliccp.sota_columns(32)), num_tasks=2,
                domain_col="301", device=dev)


def star_mtl_data(name, x):
    """Phase 16's ids; for ESMM the 301 column redrawn from {1, 2}."""
    if name != "ESMM":
        return x
    rng = np.random.default_rng(SEED + 17)
    return dict(x, **{"301": rng.integers(1, 3, len(x["301"]))})


def bn_counts(model):
    return [int(bn.count) for bn in model.bn]


def count_steps(trainer) -> list:
    """Wrap ``trainer.train_step`` (which ``fit`` calls) to count its
    calls in the returned one-element list."""
    calls, step = [0], trainer.train_step

    def counted(*args, **kw):
        calls[0] += 1
        return step(*args, **kw)

    trainer.train_step = counted
    return calls


def star_mtl_arm(card, name, trainer, x, y, mode, tail=None, timed=True,
                 profile=False):
    """ZOO_STEPS ``fit`` steps of one arm with the K2-K5 launches a step
    held (none in ``dense``) and no layer kernel; with ``timed`` the
    staged step timed and, with ``profile``, its device-busy time.
    Returns the row kernels' launches."""
    if tail:
        os.environ["SATRANS_LAZY_TAIL"] = tail
    try:
        wall, step_loss, rows, layers = zoo_fit(trainer, x, y, BATCH)
        per_step = {"lazy": dict(zip(ROW_NAMES, LAZY_ROWS_PER_STEP)),
                    "fused_tail": dict(zip(ROW_NAMES, SPARSE_ARMS[3][3])),
                    "fused": dict(zip(ROW_NAMES, SPARSE_ARMS[0][3]))}.get(
            "fused_tail" if tail else mode, {})
        want = tuple(ZOO_STEPS * per_step.get(n, 0) for n in ROW_NAMES)
        arm = mode + (f" tail {tail}" if tail else "")
        check(rows == want and not any(layers),
              f"{name} {arm}: {ZOO_STEPS} steps launched {rows} "
              f"({', '.join(ROW_NAMES)}) and {layers} layer kernels, want "
              f"{want} and none")
        print(f"{name} {arm} [{card}]: {ZOO_STEPS} steps of {BATCH}: "
              f"{wall:.4f}s, {ZOO_STEPS * BATCH / wall:.1f} trained "
              f"examples/s; losses per example "
              f"{(step_loss / BATCH).round(6).tolist()}; launches {rows}",
              flush=True)
        if timed:
            batch, yb, wb = staged_batch(trainer, x, y)
            step_ms = time_ms(lambda: trainer.train_step(batch, yb, wb),
                              iters=5)
            print(f"{name} {arm} [{card}]: train_step on a staged batch "
                  f"{step_ms:.3f} ms, {1e3 * BATCH / step_ms:.1f} "
                  "examples/s", flush=True)
            if profile:
                device_profile(f"{name} {arm}: one training step of "
                               f"{BATCH}", lambda: trainer.train_step(
                                   batch, yb, wb), step_ms, card, top=6)
            del batch
    finally:
        os.environ.pop("SATRANS_LAZY_TAIL", None)
    return dict(zip(ROW_NAMES, rows))


def star_fused_vs_dense(dev, card, x, y):
    """STAR ZOO_STEPS steps in ``dense`` and in ``fused`` from one start:
    every parameter and BatchNorm buffer bit for bit, each domain's count
    ZOO_STEPS; then one ``dense`` step on a batch with no domain-3
    example: domain 3's mean and var unchanged, its count up by one.
    Returns the launches by arm."""
    from satrans_torch.train import Trainer
    states, launched = {}, {}
    for mode in ("fused", "dense"):  # the dense model is kept
        model = star_mtl_model(dev, "Star_Net")
        trainer = Trainer(model, seed=SEED, device=dev)
        trainer.compile(learning_rate=ZOO_LR, bank_update=mode)
        launched[f"Star_Net_{mode}"] = star_mtl_arm(
            card, "Star_Net", trainer, x, y, mode, timed=False)
        states[mode] = {k: v.detach().clone()
                        for k, v in model.state_dict().items()}
        counts = bn_counts(model)
        check(counts == [ZOO_STEPS] * 3, f"Star_Net {mode}: BatchNorm "
                                         f"counts {counts} after "
                                         f"{ZOO_STEPS} steps")
        if mode == "fused":
            del model, trainer
            gc.collect()
            torch.cuda.empty_cache()
    want = states["dense"]
    differ = [k for k, v in want.items()
              if not torch.equal(states["fused"][k], v)]
    print(f"Star_Net fused vs dense [{card}]: {len(want) - len(differ)} of "
          f"{len(want)} parameters and buffers bit-identical", flush=True)
    check(not differ, f"Star_Net: fused differs from dense in {differ}")
    # a batch with no domain-3 example
    data = model.layout.batch_from_dict(
        {**{k: v[:BATCH] for k, v in x.items()},
         "301": np.where(x["301"][:BATCH] == 3, 1, x["301"][:BATCH])})
    batch = trainer._device_batch(data)
    yb, wb = trainer._device_batch({"y": y[:BATCH],
                                    "w": np.ones(BATCH, np.float32)}).values()
    before = {k: v.clone() for k, v in model.named_buffers()}
    trainer.train_step(batch, yb, wb)
    torch.cuda.synchronize()
    same = {(d, k): torch.equal(getattr(model.bn[d], k),
                                before[f"bn.{d}.{k}"])
            for d in range(3) for k in ("mean", "var")}
    check(all(same[(2, k)] for k in ("mean", "var"))
          and not any(same[(d, k)] for d in (0, 1) for k in ("mean", "var"))
          and bn_counts(model) == [counts[0] + 1] * 3,
          f"Star_Net: a batch with no domain 3: unchanged {same}, counts "
          f"{bn_counts(model)} after {counts}")
    print(f"Star_Net [{card}]: BatchNorm counts {counts} after "
          f"{ZOO_STEPS} fit steps; a batch without domain 3 keeps its mean "
          f"and var bit for bit, counts {bn_counts(model)}", flush=True)
    del model, trainer, states, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launched


def mmoe_serving_check(dev, card, trainer, x):
    """MMOE's routed ``predict`` on STAR_MTL_REQUEST examples against its
    ``Predictor`` and the ``Predictor`` that ``serving.load`` builds from
    its checkpoint, bit for bit; each example's score is its domain's
    head."""
    import tempfile

    from satrans_torch import serving
    req = {k: v[:STAR_MTL_REQUEST] for k, v in x.items()}
    pred = trainer.predict(req, batch_size=BATCH)
    direct = serving.Predictor.from_trainer(trainer, batch_size=BATCH)(req)
    model = trainer.model.eval()
    offset = model.domain_id_offset
    data = model.layout.batch_from_dict(req)
    with torch.no_grad():  # the heads on predict's padded batches
        heads = torch.cat([model(trainer._device_batch(
            {k: trainer._pad(v[s:s + BATCH], BATCH)
             for k, v in data.items()}))
            for s in range(0, STAR_MTL_REQUEST, BATCH)]).cpu().numpy()
    routed = heads[np.arange(STAR_MTL_REQUEST), req["301"] - offset]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mmoe")
        serving.save(path, trainer)
        fresh = star_mtl_model(dev, "MMOE")
        fresh.set_domain_offset(offset + 5)
        loaded = serving.load(path, fresh, batch_size=BATCH, device=dev)
        got = loaded(req)
    check(fresh.domain_id_offset == offset, "MMOE: serving.load did not "
                                            "restore the offset")
    check(np.array_equal(pred, direct) and np.array_equal(pred, got),
          f"MMOE: predict, Predictor and the loaded Predictor differ: max "
          f"{np.abs(pred - direct).max()}, {np.abs(pred - got).max()}")
    check(np.array_equal(pred, routed.astype("float64")),
          "MMOE: a score is not its domain's head")
    print(f"MMOE serving [{card}]: predict of {STAR_MTL_REQUEST} = "
          f"Predictor = serving.load's Predictor bit for bit, each score "
          f"its domain's head (offset {offset}); scores mean "
          f"{pred.mean():.6f}", flush=True)
    del fresh, loaded
    gc.collect()
    torch.cuda.empty_cache()


def star_mtl_run(dev, card, name, x, y):
    """Phase 17 for one model: 3 ``fit`` steps in ``dense`` (not STAR,
    whose dense arm is ``star_fused_vs_dense``'s) and in ``lazy`` with
    the split tail and the fused one, the split arm profiled; MMOE's
    serving; then the forward on the card against the CPU on the lazy
    model (STAR's BatchNorm statistics moved by its steps).  Returns the
    launches by arm and the forward's error."""
    from satrans_torch.train import Trainer
    x = star_mtl_data(name, x)
    launched = {}
    for mode in (("lazy",) if name == "Star_Net" else ("dense", "lazy")):
        model = star_mtl_model(dev, name)
        trainer = Trainer(model, seed=SEED, device=dev)
        trainer.compile(learning_rate=ZOO_LR, bank_update=mode)
        steps = count_steps(trainer)
        zoo_fit(trainer, x, y, BATCH, 1)  # warmup: one step
        tails = (None, "fused") if mode == "lazy" else (None,)
        for tail in tails:
            launched[f"{name}_{mode}" + (f"_{tail}" if tail else "")] = \
                star_mtl_arm(card, name, trainer, x, y, mode, tail,
                             profile=mode == "lazy" and tail is None)
        if mode == "dense":
            del model, trainer
            gc.collect()
            torch.cuda.empty_cache()
    if name == "MMOE":
        mmoe_serving_check(dev, card, trainer, x)
    if name == "Star_Net":
        counts = bn_counts(model)
        check(counts == [steps[0]] * 3, f"Star_Net lazy: BatchNorm counts "
                                        f"{counts} after {steps[0]} steps")
    err = zoo_forward_check(dev, card, name, x, model)
    del model, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return launched, err


def star_mtl_cli(dev, card):
    """``cli.main --model_name Star_Net`` and ``MMOE`` end to end on the
    card (:func:`cli_lazy_runs`).  Returns the launches by run."""
    return cli_lazy_runs(dev, card, [(f"{name}_cli", ["--model_name", name])
                                     for name in ("Star_Net", "MMOE")])


def cli_lazy_runs(dev, card, runs):
    """``cli.main`` end to end on the card for each ``(label, argv)`` of
    ``runs``: STAR_MTL_CLI_ROWS synthetic rows, ``--bank_update lazy``,
    fit, predict and the report.  Each run's K2-K5 launches are counted
    from 0 and must be its steps' (the split tail's), with no layer
    kernel; the test AUC must lie in [0, 1] and the report hold one row.
    Returns the launches by run."""
    import tempfile

    from satrans_torch.cli import main as cli
    from satrans_torch.ops import eqgemm, gather, lazy_tail, scatter
    steps = -(-int(0.8 * STAR_MTL_CLI_ROWS) // BATCH)
    want = tuple(steps * n for n in LAZY_ROWS_PER_STEP)
    launched = {}
    for label, argv in runs:
        name = " ".join(argv)
        with tempfile.TemporaryDirectory() as tmp:
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            auc = cli.main(["--data_name", "synthetic", "--synthetic_rows",
                            str(STAR_MTL_CLI_ROWS), *argv,
                            "--bank_update", "lazy", "--results_dir", tmp],
                           device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rows = tuple(m.launches
                         for m in (gather, scatter, eqgemm, lazy_tail))
            layers = layer_counts()
            with open(os.path.join(tmp, "synthetic_results.csv")) as f:
                report = f.readlines()
        check(0.0 <= auc <= 1.0 and len(report) == 1,
              f"cli {name}: test AUC {auc}, {len(report)} report rows")
        check(rows == want and not any(layers),
              f"cli {name}: {steps} lazy steps launched {rows} "
              f"({', '.join(ROW_NAMES)}) and {layers} layer kernels, want "
              f"{want} and none")
        launched[label] = dict(zip(ROW_NAMES, rows))
        print(f"cli {name} --bank_update lazy [{card}]: "
              f"{STAR_MTL_CLI_ROWS} synthetic rows, {steps} steps of {BATCH}, "
              f"data, fit, predict and report in {wall:.4f}s; test AUC "
              f"{auc}; launches {rows}", flush=True)
    return launched


def star_mtl_phase(dev, card):
    """Phase 17: STAR and the multi-task models.  Returns the launches by
    path and kernel."""
    t0 = time.perf_counter()
    x, y = training_data()
    paths, errs = star_fused_vs_dense(dev, card, x, y), {}
    for name in STAR_MTL_MODELS:
        launched, errs[name] = star_mtl_run(dev, card, name, x, y)
        paths.update(launched)
    paths.update(star_mtl_cli(dev, card))
    print(f"phase 17: {time.perf_counter() - t0:.2f}s; the forwards' worst "
          f"error {max(errs.values()):.3e}", flush=True)
    return paths


# phase 18: the reference CLI's other widths and head counts (MetaNet (2d,
# d) at each): every layer kernel against its plain version at these
# (d, heads); the main path at the widest; the gate and bilinear variants
# and the multicol model at the widest and a narrow one; Alimama sota-pos
# at the narrow one; the CLI at the JAX package's CLI-test widths
WIDTH_SHAPES = ((8, 2), (8, 8), (16, 2), (32, 1), (32, 8), (64, 1), (64, 8))
WIDE, NARROW = (64, 8), (16, 2)
WIDTH_CLI = ((8, 2), (16, 2))
WIDTH_STEPS = 3
# the CLI runs' synthetic rows: 4 training steps of the batch
WIDTH_CLI_ROWS = 40_960
# the kernels' names by phase 18's kernel case keys
WIDTH_KERNELS = K1_NAMES + ("meta_block_fwd_scores",) + K7_NAMES + (
    "gate_block_fwd", "gate_block_bwd")


def width_targets():
    """The libraries phase 18 launches: K1 and K7 with MetaNet (2d, d), and
    K6, at each of its shapes."""
    return ([(n, (d, 2 * d, 0, h)) for d, h in WIDTH_SHAPES
             for n in ("meta_block_fwd", "meta_block_bwd")]
            + [(n, (d, h)) for d, h in WIDTH_SHAPES
               for n in ("gate_block_fwd", "gate_block_bwd")])


def close_err(got, want, what):
    """max |got - want|; raises past KERNEL_TOL or where got is not
    finite."""
    err = (got - want).abs().max().item()
    check(bool(torch.isfinite(got).all())
          and torch.allclose(got, want, **KERNEL_TOL),
          f"{what}: max |kernel - plain| = {err}")
    return err


def width_layers(dev, d, heads, seed):
    """A metanet layer (its meta LayerNorm moved off its init) and its
    4-row table of MetaNets (2d, d); the gate and bilinear layers and
    their 4-row tables; and the generator after them."""
    from satrans_torch.nn import attention, initializers as init, metanet
    from satrans_torch.utils import make_generator
    gen = make_generator(seed, dev)
    layer = attention.MetaTransformerLayer(gen, d)
    with torch.no_grad():
        layer.q_meta.ln.scale.add_(init.normal(gen, (d,), 0.1))
        layer.q_meta.ln.bias.add_(init.normal(gen, (d,), 0.1))
    table = init.normal(gen, (4, metanet.param_size((d, 2 * d, d))), 0.1)
    simple = {}
    for variant in ("gate", "bilinear"):
        lay = attention.MetaTransformerLayer(gen, d, variant=variant)
        names = ("Q", "K") if variant == "gate" else ("bilinear",)
        width = d if variant == "gate" else d * (d // heads)
        simple[variant] = (lay, {n: init.normal(gen, (4, width), 0.5)
                                 for n in names})
    return gen, layer, table, simple


def width_check_case(dev, d, heads):
    """Phase 18a at one shape: at B = SMALL_BATCH, dropout 0 and 0.1 (QK),
    K1-fwd, K1-stash, K1-stash light and K1-scores (the output and every
    residual) against the plain layer; K1-bwd, K1-bwd-stash and
    K1-bwd-stash light (each through the autograd wrapper) against its
    autograd, every gradient; K7-fwd and K7-stash (with the plan's
    tile_count, on the occupied slots) and K7-bwd and K7-bwd-stash on the
    multicol dispatch of the batch; K6-fwd and K6-bwd, gate and bilinear.
    KERNEL_TOL for outputs, GRAD_RTOL / GRAD_ATOL for gradients (the d =
    32 phases').  Returns the worst error by kernel."""
    from satrans_torch.nn import initializers as init, metanet
    from satrans_torch.ops import (dispatch, gate_block, meta_block, prng,
                                   tiled_meta)
    F, units = 19, (d, 2 * d, d)
    gen, layer, table, simple = width_layers(dev, d, heads,
                                             SEED + 180 + d + heads)
    tables = shared(table)
    table7 = init.normal(gen, (MULTICOL_ROWS, metanet.param_size(units)),
                         0.1)
    kw = dict(meta_units=units, head_num=heads, mode="QK", relu_out=False)
    errs = {n: 0.0 for n in WIDTH_KERNELS}

    def worst(name, err):
        errs[name] = max(errs[name], err)

    for rate in (0.0, DROP_RATE):
        B = SMALL_BATCH
        x = init.normal(gen, (B, F, d), 1.0)
        g = init.normal(gen, (B, F, d), 1.0)
        dom = torch.randint(0, 4, (B,), generator=gen, device=dev)
        drop = dict(train=True, drop_rate=rate, seed=DROP_SEED,
                    block_b=DROP_TILE)
        masks = meta_block.layer_masks(x, head_num=heads, mode="QK", **drop)
        kargs = prng.kernel_args(True, rate, DROP_SEED, DROP_TILE, F)
        ops, cfg = meta_block.pack_operands(x, layer, tables, dom, **kw)
        ops = [t if t is None else t.detach() for t in ops]
        res = {}
        with torch.no_grad():
            want = meta_block.meta_layer_reference(
                x, layer, tables, dom, **kw, masks=masks, residuals=res)
            worst("meta_block_fwd", close_err(meta_block.launch_fwd(
                *ops, cfg, kargs), want, f"K1-fwd {d}/{heads} {rate}"))
            for stash, name in (("full", "meta_block_fwd_stash"),
                                ("light", "meta_block_fwd_stash_light"),
                                ("scores", "meta_block_fwd_scores")):
                got = meta_block.launch_fwd(*ops, cfg, kargs, stash=stash)
                worst(name, close_err(got[0], want, f"{name} y"))
                for rn, a in zip(meta_block.STASH_RESIDUALS[stash], got[1:]):
                    worst(name, close_err(a, res[rn], f"{name} {rn}"))
        gk, _ = kink_free(g, x, layer, tables, dom, masks, **kw)
        want_g = layer_grads(meta_block.meta_layer_reference, x, layer,
                             tables, dom, gk, **kw, masks=masks)
        for bwd in ("stash", "stash_light", "recompute"):
            got_g = layer_grads(meta_block.fused_meta_layer, x, layer,
                                tables, dom, gk, **kw, **drop, bwd=bwd)
            worst(K1_BWD_NAME[bwd], max(grad_errors(got_g,
                                                    want_g).values()))
        # K7 on the multicol dispatch of the batch (56 rows, tiles of 32)
        plan = multicol_dispatch(dev, gen, B)
        occ = plan.src >= 0
        tq = table7[plan.tile_dom.long()]
        t7 = shared(tq)
        xs, gs = dispatch.scatter(x, plan), dispatch.scatter(g, plan)
        rows = tiled_meta.tile_rows(plan.n_slots, MULTICOL_TILE, dev)
        drop7 = dict(drop, block_b=MULTICOL_TILE)
        masks7 = tiled_meta.layer_masks(xs, head_num=heads, mode="QK",
                                        **drop7)
        res7 = {}
        with torch.no_grad():
            want7 = tiled_meta.tiled_layer_reference(
                xs, layer, t7, **kw, block_b=MULTICOL_TILE, masks=masks7,
                residuals=res7)
            y7 = tiled_meta.fused_tiled_layer(xs, layer, t7, **kw, **drop7,
                                              tile_count=plan.tile_count)
            worst("tiled_meta_fwd", close_err(y7[occ], want7[occ],
                                              "K7-fwd"))
            weights, cfg7 = meta_block.pack_weights(layer, t7, **kw)
            st = tiled_meta.launch_fwd(
                xs, *weights, cfg7, prng.kernel_args(
                    True, rate, DROP_SEED, MULTICOL_TILE, F), MULTICOL_TILE,
                stash=True, tile_count=plan.tile_count)
            for rn, a in zip(("y",) + tiled_meta.STASH_RESIDUALS, st):
                w = want7 if rn == "y" else res7[rn]
                worst("tiled_meta_fwd_stash", close_err(
                    a[occ], w[occ], f"K7-stash {rn}"))
        gs, _ = kink_free(gs, xs, layer, t7, rows, masks7, **kw)

        def tiled_fn(x, lay, tabs, dom, **k):
            return tiled_meta.fused_tiled_layer(x, lay, tabs, **k,
                                                tile_count=plan.tile_count)

        def tiled_ref(x, lay, tabs, dom, **k):
            return tiled_meta.tiled_layer_reference(
                x, lay, tabs, block_b=MULTICOL_TILE, **k)

        want_g7 = layer_grads(tiled_ref, xs, layer, t7, None, gs, **kw,
                              masks=masks7)
        for bwd, name in (("stash", "tiled_meta_bwd_stash"),
                          ("recompute", "tiled_meta_bwd")):
            got_g = layer_grads(tiled_fn, xs, layer, t7, None, gs, **kw,
                                **drop7, bwd=bwd)
            worst(name, max(grad_errors(got_g, want_g7).values()))
        # K6, gate (QK) and bilinear
        for variant, (lay, tabs) in simple.items():
            masks6 = gate_block.layer_masks(x, head_num=heads, **drop)
            kw6 = dict(head_num=heads, mode="QK", relu_out=False)
            with torch.no_grad():
                worst("gate_block_fwd", close_err(
                    gate_block.fused_simple_layer(x, lay, tabs, dom, **kw6,
                                                  **drop),
                    gate_block.simple_layer_reference(
                        x, lay, tabs, dom, **kw6, masks=masks6),
                    f"K6-fwd {variant}"))
            got_g = gate_grads(gate_block.fused_simple_layer, x, lay, tabs,
                               dom, g, **kw6, **drop)
            want_g6 = gate_grads(gate_block.simple_layer_reference, x, lay,
                                 tabs, dom, g, **kw6, masks=masks6)
            worst("gate_block_bwd", max(grad_errors(got_g,
                                                    want_g6).values()))
    return errs


def width_time_case(dev, d, heads):
    """Phase 18a's times at one shape, dropout 0.1 in training (QK, 4 table
    rows; K7 on the multicol dispatch): each kernel at B = 8192 (CUDA
    events, the calls back to back) and at SMALL_BATCH (queued ahead of the
    card, :func:`queued_ms`), its bound at 8192, and the plain version's
    time at 8192 (the forward; for a backward, autograd's backward over a
    kept graph).  Returns the fields by kernel."""
    from satrans_torch.nn import initializers as init, metanet
    from satrans_torch.ops import (dispatch, gate_block, meta_block, prng,
                                   tiled_meta)
    F, h, units = 19, 2 * d, (d, 2 * d, d)
    gen, layer, table, simple = width_layers(dev, d, heads,
                                             SEED + 190 + d + heads)
    tables = shared(table)
    table7 = init.normal(gen, (MULTICOL_ROWS, metanet.param_size(units)),
                         0.1)
    kw = dict(meta_units=units, head_num=heads, mode="QK", relu_out=False)
    out = {n: {} for n in WIDTH_KERNELS}
    for B in (BATCH, SMALL_BATCH):
        big = B == BATCH
        timer = (lambda fn: time_ms(fn, iters=20)) if big else queued_ms
        x = init.normal(gen, (B, F, d), 1.0)
        g = init.normal(gen, (B, F, d), 1.0)
        dom = torch.randint(0, 4, (B,), generator=gen, device=dev)
        kargs = prng.kernel_args(True, DROP_RATE, DROP_SEED, DROP_TILE, F)
        ops, cfg = meta_block.pack_operands(x, layer, tables, dom, **kw)
        ops = [t if t is None else t.detach() for t in ops]
        key = "ms" if big else "ms_512"
        with torch.no_grad():
            res = {s: meta_block.launch_fwd(*ops, cfg, kargs, stash=s)[1:]
                   for s in ("full", "light")}
            for stash, name in ((None, "meta_block_fwd"),
                                ("full", "meta_block_fwd_stash"),
                                ("light", "meta_block_fwd_stash_light"),
                                ("scores", "meta_block_fwd_scores")):
                out[name][key] = timer(lambda: meta_block.launch_fwd(
                    *ops, cfg, kargs, stash=stash))
                if big:
                    out[name]["bound_ms"], out[name]["bound_by"] = \
                        meta_layer_bound_ms(B, F, d, h, heads, 4, 1, 1,
                                            stash=stash)
            for r, name in ((res["full"], "meta_block_bwd_stash"),
                            (res["light"], "meta_block_bwd_stash_light"),
                            (None, "meta_block_bwd")):
                out[name][key] = timer(lambda: meta_block.launch_bwd(
                    g, *ops, cfg, kargs, res=r))
                if big:
                    out[name]["bound_ms"], out[name]["bound_by"] = \
                        meta_layer_bwd_bound_ms(
                            B, F, d, h, heads, 4, 1, 1,
                            stash=None if r is None else
                            ("full" if len(r) == 5 else "light"))
            del res
        if big:  # the plain layer at 8192: forward, then backward
            masks = meta_block.layer_masks(x, head_num=heads, mode="QK",
                                           train=True, drop_rate=DROP_RATE,
                                           seed=DROP_SEED, block_b=DROP_TILE)
            with torch.no_grad():
                p_ms = time_ms(lambda: meta_block.meta_layer_reference(
                    x, layer, tables, dom, **kw, masks=masks), iters=5)
            xr = x.detach().requires_grad_(True)
            tr = table.detach().requires_grad_(True)
            yr = meta_block.meta_layer_reference(xr, layer, shared(tr), dom,
                                                 **kw, masks=masks)
            pb_ms = time_ms(lambda: torch.autograd.grad(
                yr, [xr, tr, *layer.parameters()], g, retain_graph=True),
                iters=3)
            del yr
            for name in K1_NAMES + ("meta_block_fwd_scores",):
                out[name]["plain_ms"] = pb_ms if "bwd" in name else p_ms
        # K7 on the multicol dispatch of the batch
        plan = multicol_dispatch(dev, gen, B)
        tq = table7[plan.tile_dom.long()].detach()
        xs, gs = dispatch.scatter(x, plan), dispatch.scatter(g, plan)
        weights, cfg7 = meta_block.pack_weights(layer, shared(tq), **kw)
        weights = [t if t is None else t.detach() for t in weights]
        k7 = prng.kernel_args(True, DROP_RATE, DROP_SEED, MULTICOL_TILE, F)
        T, occupied = plan.tile_dom.numel(), int((plan.src >= 0).sum())
        with torch.no_grad():
            st = tiled_meta.launch_fwd(xs, *weights, cfg7, k7, MULTICOL_TILE,
                                       stash=True,
                                       tile_count=plan.tile_count)
            for stash, name in ((False, "tiled_meta_fwd"),
                                (True, "tiled_meta_fwd_stash")):
                out[name][key] = timer(lambda: tiled_meta.launch_fwd(
                    xs, *weights, cfg7, k7, MULTICOL_TILE, stash=stash,
                    tile_count=plan.tile_count))
                if big:
                    out[name]["bound_ms"], out[name]["bound_by"] = \
                        meta_layer_bound_ms(plan.n_slots, F, d, h, heads, T,
                                            1, 1, stash="full" if stash
                                            else None, occupied=occupied)
            for r, name in ((st[1:], "tiled_meta_bwd_stash"),
                            (None, "tiled_meta_bwd")):
                out[name][key] = timer(lambda: tiled_meta.launch_bwd(
                    gs, xs, *weights, cfg7, k7, MULTICOL_TILE, res=r,
                    tile_count=plan.tile_count))
                if big:
                    out[name]["bound_ms"], out[name]["bound_by"] = \
                        meta_layer_bwd_bound_ms(
                            plan.n_slots, F, d, h, heads, T, 1, 1,
                            stash=None if r is None else "full",
                            occupied=occupied)
            del st
        if big:
            masks7 = tiled_meta.layer_masks(
                xs, head_num=heads, mode="QK", train=True,
                drop_rate=DROP_RATE, seed=DROP_SEED, block_b=MULTICOL_TILE)
            with torch.no_grad():
                p_ms = time_ms(lambda: tiled_meta.tiled_layer_reference(
                    xs, layer, shared(tq), **kw, block_b=MULTICOL_TILE,
                    masks=masks7), iters=5)
            xr = xs.detach().requires_grad_(True)
            tr = tq.detach().requires_grad_(True)
            yr = tiled_meta.tiled_layer_reference(
                xr, layer, shared(tr), **kw, block_b=MULTICOL_TILE,
                masks=masks7)
            pb_ms = time_ms(lambda: torch.autograd.grad(
                yr, [xr, tr, *layer.parameters()], gs, retain_graph=True),
                iters=3)
            del yr
            for name in K7_NAMES:
                out[name]["plain_ms"] = pb_ms if "bwd" in name else p_ms
        # K6, gate (QK) and bilinear: each body's times by variant
        kg = prng.kernel_args(True, DROP_RATE, DROP_SEED, DROP_TILE, F,
                              pad_mult=gate_block.PAD_FIELDS)
        for variant, (lay, tabs) in simple.items():
            ops6, cfg6 = gate_block.pack_operands(x, lay, tabs, dom,
                                                  head_num=heads)
            ops6 = [t.detach() for t in ops6]
            tag = "" if variant == "gate" else "_bilinear"
            with torch.no_grad():
                for name, run in (
                        ("gate_block_fwd", lambda: gate_block.launch_fwd(
                            *ops6, cfg6, kg)),
                        ("gate_block_bwd", lambda: gate_block.launch_bwd(
                            g, *ops6, cfg6, kg))):
                    out[name][key + tag] = timer(run)
                    if big:
                        b_ms, b_by = gate_layer_bound_ms(
                            B, F, d, heads, 4, variant, 1, 1,
                            bwd="bwd" in name)
                        out[name]["bound_ms" + tag] = b_ms
                        out[name]["bound_by" + tag] = b_by
            if big:
                masks6 = gate_block.layer_masks(
                    x, head_num=heads, train=True, drop_rate=DROP_RATE,
                    seed=DROP_SEED, block_b=DROP_TILE)
                kw6 = dict(head_num=heads, mode="QK", relu_out=False)
                with torch.no_grad():
                    p_ms = time_ms(lambda: gate_block.simple_layer_reference(
                        x, lay, tabs, dom, **kw6, masks=masks6), iters=5)
                xr = x.detach().requires_grad_(True)
                trs = {k: t.detach().requires_grad_(True)
                       for k, t in tabs.items()}
                yr = gate_block.simple_layer_reference(xr, lay, trs, dom,
                                                       **kw6, masks=masks6)
                pb_ms = time_ms(lambda: torch.autograd.grad(
                    yr, [xr, *trs.values(), *lay.parameters()], g,
                    retain_graph=True), iters=3)
                del yr
                out["gate_block_fwd"]["plain_ms" + tag] = p_ms
                out["gate_block_bwd"]["plain_ms" + tag] = pb_ms
        gc.collect()
        torch.cuda.empty_cache()
    return out


def width_smem(d, heads):
    """The dynamic shared memory (bytes) at F = 19 of each body at the
    shape (K6 with 4 table rows), and the forward and backward tile
    bodies' layouts."""
    import ctypes
    from satrans_torch.ops import _build
    shape, h = (d, 2 * d, 0, heads), 2 * d

    def fn(src, name, n, shp=shape):
        return _build.kernel_fn(src, name, [ctypes.c_int] * n, shape=shp)

    fwd = fn("meta_block_fwd", "satrans_meta_block_fwd_stash_smem", 6)
    return {"fwd": fwd(d, h, 0, heads, 19, 0),
            "stash": fwd(d, h, 0, heads, 19, 1),
            "bwd": fn("meta_block_bwd", "satrans_meta_block_bwd_stash_smem",
                      5)(d, h, 0, heads, 19),
            "fwd_plan": fn("meta_block_fwd", "satrans_meta_block_fwd_plan",
                           0)(),
            "bwd_plan": fn("meta_block_bwd", "satrans_meta_block_bwd_plan",
                           0)(),
            "k1_bwd_max_rows": fn("meta_block_bwd",
                                  "satrans_meta_block_bwd_max_domains", 0)(),
            "gate_fwd": fn("gate_block_fwd", "satrans_gate_block_fwd_smem",
                           4, (d, heads))(d, heads, 4, 0),
            "bilinear_fwd": fn("gate_block_fwd",
                               "satrans_gate_block_fwd_smem", 4,
                               (d, heads))(d, heads, 4, 1),
            "gate_bwd": fn("gate_block_bwd", "satrans_gate_block_bwd_smem",
                           5, (d, heads))(d, heads, 4, 0, 19),
            "bilinear_bwd": fn("gate_block_bwd",
                               "satrans_gate_block_bwd_smem", 5,
                               (d, heads))(d, heads, 4, 1, 19)}


def plain_layer_calls():
    """Count the plain layer's calls (``attention.meta_transformer_apply``,
    which every plain route runs and no kernel route does) in the returned
    one-element list, until :func:`plain_layer_restore`."""
    from satrans_torch.nn import attention
    calls, plain = [0], attention.meta_transformer_apply

    def counted(*args, **kw):
        calls[0] += 1
        return plain(*args, **kw)

    counted.plain = plain
    attention.meta_transformer_apply = counted
    return calls


def plain_layer_restore():
    from satrans_torch.nn import attention
    attention.meta_transformer_apply = attention.meta_transformer_apply.plain


def width_model(dev, d, heads, variant="metanet", cols=("301",),
                domains=(3,), pos=False, **kw):
    """SATrans at the AliCCP sota fields (or with ``pos`` the Alimama
    sota-pos ones) at width ``d``, ``heads`` heads, 3 layers, QK, MetaNet
    (2d, d), dropout 0.1, the layers of ``variant``."""
    from satrans_torch.data import aliccp, alimama
    from satrans_torch.features import FeatureLayout
    from satrans_torch.models import SATrans
    if pos:
        layout = FeatureLayout(alimama.sota_columns(d))
        cols, domains = [alimama.DOMAIN_COL], [alimama.NUM_DOMAINS]
    else:
        layout = FeatureLayout(aliccp.sota_columns(d))
    return SATrans(layout, list(cols), list(domains),
                   domain_att_layer_num=LAYERS, att_head_num=heads,
                   meta_mode="QK", meta_dnn_hidden_units=(2 * d, d),
                   dropout_rate=DROP_RATE, use_pos=pos, seed=SEED,
                   variant=variant, device=dev, **kw)


def width_run(card, label, run, per_call):
    """``run()`` once after the launch counts are set to 0 and with the
    plain layer counted: exactly ``per_call`` launches of each layer
    kernel (in LAYER_NAMES order), and the plain layer never.  Returns
    (the result, the launches by kernel)."""
    torch.cuda.synchronize()
    zero_counts()
    calls = plain_layer_calls()
    try:
        result = run()
        torch.cuda.synchronize()
    finally:
        plain_layer_restore()
    got = layer_counts()
    check(got == tuple(per_call) and calls[0] == 0,
          f"{label}: launched {got} ({', '.join(LAYER_NAMES)}), want "
          f"{tuple(per_call)}, and ran the plain layer {calls[0]} times")
    launched = {n: c for n, c in zip(LAYER_NAMES, got) if c}
    if scores_count():
        launched["meta_block_fwd_scores"] = scores_count()
    print(f"widths {label} [{card}]: launches {launched}, the plain layer "
          "never", flush=True)
    return result, launched


def width_steps(card, label, trainer, batch, per_step):
    """WIDTH_STEPS staged training steps (:func:`width_run`, ``per_step``
    launches a layer a step), finite losses; then the staged step's time
    and its device-busy time (a profile).  Returns the launches by
    kernel."""
    from satrans_torch.ops import eqgemm, gather, lazy_tail, scatter
    losses, launched = width_run(
        card, label, lambda: [trainer.train_step(*batch)["loss"]
                              for _ in range(WIDTH_STEPS)],
        [WIDTH_STEPS * LAYERS * c for c in per_step])
    check(all(bool(torch.isfinite(v)) for v in losses),
          f"{label}: a loss is not finite")
    launched.update({n: m.launches for n, m in zip(
        ROW_NAMES, (gather, scatter, eqgemm, lazy_tail)) if m.launches})
    step_ms = time_ms(lambda: trainer.train_step(*batch), iters=3)
    busy = device_profile(f"widths {label}: one training step of {BATCH}",
                          lambda: trainer.train_step(*batch), step_ms, card,
                          top=6)
    print(f"widths {label} [{card}]: losses "
          f"{[round(float(v) / BATCH, 6) for v in losses]}; staged step "
          f"{step_ms:.3f} ms, device busy {busy} ms a step", flush=True)
    return launched


def width_wide_path(dev, card):
    """Phase 18b: the main path at the widest shape (d = 64, 8 heads;
    AliCCP sota fields and vocab sizes, a bank of 1.68 GB): one request of
    REQUEST_ROWS through Predictor (K1-fwd only; the scores against the
    plain path), WIDTH_STEPS staged ``lazy`` steps under bwd='stash'
    (K1-stash and K1-bwd-stash), WIDTH_STEPS ``dense`` steps under
    'recompute' (K1-fwd and K1-bwd) and one showattn probe batch of
    PROBE_BATCH (K1-scores).  Returns the launches by path."""
    from satrans_torch.data import aliccp
    from satrans_torch.serving import Predictor
    from satrans_torch.train import Trainer, attention_probe
    d, heads = WIDE
    tag = f"d{d}h{heads}"
    paths = {}
    model = width_model(dev, d, heads, no_emb_init=True)
    print(f"widths {tag}: bank {model.emb.bank.shape[0]} x "
          f"{model.emb.bank.shape[1]} = {model.emb.bank.numel() * 4 / 1e9:.3f}"
          " GB", flush=True)
    rng = np.random.default_rng(SEED + 18)
    req = {n: rng.integers(1, aliccp.DATA_MAX[n] + 1, REQUEST_ROWS)
           for n in aliccp.SPARSE_FEATURES}
    pred = Predictor(model, batch_size=BATCH, device=dev).warmup()
    batches = -(-REQUEST_ROWS // BATCH)
    t0 = time.perf_counter()
    scores, paths[f"widths_serve_{tag}"] = width_run(
        card, f"{tag} serve", lambda: pred(req),
        (0, 0, LAYERS * batches) + (0,) * 9)
    wall = time.perf_counter() - t0
    device_profile(f"widths {tag}: one request of {REQUEST_ROWS}",
                   lambda: pred(req), 1e3 * wall, card, top=6)
    model.route = "plain"
    want = Predictor(model, batch_size=BATCH, device=dev)(req)
    model.route = "kernel"
    diff = float(np.abs(scores - want).max())
    check(bool(np.all(np.isfinite(scores))) and diff <= SERVING_TOL,
          f"widths {tag} serve: scores differ from the plain path by {diff}")
    print(f"widths {tag} serve [{card}]: {REQUEST_ROWS} examples in "
          f"{wall:.4f}s; max |kernel - plain| = {diff:.3e}", flush=True)
    x, y = training_data()
    for bank, bwd in (("lazy", "stash"), ("dense", "recompute")):
        os.environ["SATRANS_BWD"] = bwd
        trainer = Trainer(model, seed=SEED, device=dev)
        trainer.compile(learning_rate=TRAIN_LR, bank_update=bank)
        model.train()
        paths[f"widths_train_{tag}_{bank}_{bwd}"] = width_steps(
            card, f"{tag} {bank} {bwd}", trainer,
            staged_batch(trainer, x, y), (0, 0) + K1_PAIR[bwd] + NO_K7)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    os.environ.pop("SATRANS_BWD")
    trainer = Trainer(model, seed=SEED, device=dev)
    n = PROBE_BATCH
    (_, stats), _ = width_run(
        card, f"{tag} showattn probe", lambda: attention_probe.
        predict_with_attention(trainer, {k: v[:n] for k, v in x.items()},
                               y[:n], batch_size=n), (0,) * 12)
    check(scores_count() == LAYERS, f"the probe launched {scores_count()} "
                                    f"K1-scores, want {LAYERS}")
    paths[f"widths_probe_{tag}"] = {"meta_block_fwd_scores": LAYERS}
    del model, trainer, pred
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def width_variant_paths(dev, card):
    """Phase 18c-e: the gate and bilinear models (K6) and the multicol model
    (scenario columns 301 and 122, 56 composite rows: K7) at the widest and
    the narrow shape, each WIDTH_STEPS staged ``lazy`` steps (K7 under
    SATRANS_TILED_BWD=stash, then WIDTH_STEPS more under recompute) and one
    request of REQUEST_ROWS (finite, against the plain path); the Alimama
    sota-pos model at the narrow shape, WIDTH_STEPS ``lazy`` steps under
    bwd='stash_light'.  Returns the launches by path."""
    from satrans_torch.data import aliccp
    from satrans_torch.serving import Predictor
    from satrans_torch.train import Trainer
    x, y = training_data()
    rng = np.random.default_rng(SEED + 19)
    req = {n: rng.integers(1, aliccp.DATA_MAX[n] + 1, REQUEST_ROWS)
           for n in aliccp.SPARSE_FEATURES}
    batches = -(-REQUEST_ROWS // BATCH)
    paths = {}
    for d, heads in (WIDE, NARROW):
        tag = f"d{d}h{heads}"
        for variant in ("gate", "bilinear", "multicol"):
            multi = variant == "multicol"
            model = width_model(
                dev, d, heads, "metanet" if multi else variant,
                cols=MULTICOL_COLS if multi else ("301",),
                domains=MULTICOL_DOMAINS if multi else (3,))
            trainer = Trainer(model, seed=SEED, device=dev)
            trainer.compile(learning_rate=TRAIN_LR, bank_update="lazy")
            batch = staged_batch(trainer, x, y)
            arms = ((("stash", K7_PAIR["stash"]),
                     ("recompute", K7_PAIR["recompute"])) if multi
                    else ((None, None),))
            for bwd, pair in arms:
                if bwd:
                    os.environ["SATRANS_TILED_BWD"] = bwd
                per_step = ((0, 0) + NO_K1 + pair if multi
                            else (1, 1) + NO_K1 + NO_K7)
                label = f"{tag} {variant} lazy" + (f" {bwd}" if bwd else "")
                paths[f"widths_train_{tag}_{variant}" + (
                    f"_{bwd}" if bwd else "")] = width_steps(
                    card, label, trainer, batch, per_step)
            os.environ.pop("SATRANS_TILED_BWD", None)
            model.eval()
            pred = Predictor(model, batch_size=BATCH, device=dev)
            fwd = ((0, 0) + NO_K1 + (batches * LAYERS, 0, 0, 0) if multi
                   else (batches * LAYERS, 0) + NO_K1 + NO_K7)
            scores, paths[f"widths_serve_{tag}_{variant}"] = width_run(
                card, f"{tag} {variant} serve", lambda: pred(req), fwd)
            model.route = "plain"
            want = Predictor(model, batch_size=BATCH, device=dev)(req)
            model.route = "kernel"
            diff = float(np.abs(scores - want).max())
            check(bool(np.all(np.isfinite(scores))) and diff <= SERVING_TOL,
                  f"widths {tag} {variant} serve: scores differ from the "
                  f"plain path by {diff}")
            print(f"widths {tag} {variant} serve [{card}]: max |kernel - "
                  f"plain| = {diff:.3e}", flush=True)
            del model, trainer, batch, pred
            gc.collect()
            torch.cuda.empty_cache()
    d, heads = NARROW
    tag = f"d{d}h{heads}"
    os.environ["SATRANS_BWD"] = "stash_light"
    model = width_model(dev, d, heads, pos=True)
    trainer = Trainer(model, seed=SEED, device=dev)
    trainer.compile(learning_rate=POS_LR, bank_update="lazy")
    xa, ya = alimama_data(BATCH, SEED)
    paths[f"widths_train_{tag}_alimama_pos_stash_light"] = width_steps(
        card, f"{tag} alimama pos lazy stash_light", trainer,
        staged_batch(trainer, xa, ya),
        (0, 0) + K1_PAIR["stash_light"] + NO_K7)
    os.environ.pop("SATRANS_BWD")
    del model, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def width_cli(dev, card):
    """Phase 18f: ``cli.main --model_name SATrans --embedding_dim d
    --att_head_num heads`` at the JAX package's CLI-test widths, on
    WIDTH_CLI_ROWS synthetic AliCCP rows with ``--bank_update lazy``: fit,
    predict and the per-domain AUCs in the report, each run's layer
    launches counted from 0 (K1-stash and K1-bwd-stash a layer a step,
    K1-fwd on the evaluation), the plain layer never.  Returns the
    launches by run."""
    import tempfile

    from satrans_torch.cli import main as cli
    steps = -(-int(0.8 * WIDTH_CLI_ROWS) // BATCH)
    paths = {}
    for d, heads in WIDTH_CLI:
        tag = f"d{d}h{heads}"
        with tempfile.TemporaryDirectory() as tmp:
            torch.cuda.synchronize()
            zero_counts()
            calls = plain_layer_calls()
            t0 = time.perf_counter()
            try:
                auc = cli.main(["--data_name", "synthetic",
                                "--synthetic_rows", str(WIDTH_CLI_ROWS),
                                "--embedding_dim", str(d), "--att_head_num",
                                str(heads), "--bank_update", "lazy",
                                "--results_dir", tmp], device=dev)
                torch.cuda.synchronize()
            finally:
                plain_layer_restore()
            wall = time.perf_counter() - t0
            got = dict(zip(LAYER_NAMES, layer_counts()))
            with open(os.path.join(tmp, "synthetic_results.csv")) as f:
                report = f.read().splitlines()
        fields = report[0].split(",")[1:] if report else []
        check(0.0 <= auc <= 1.0 and len(report) == 1 and len(fields) == 5,
              f"cli {tag}: test AUC {auc}, report {report}")
        check(calls[0] == 0 and got["meta_block_fwd_stash"] == steps * LAYERS
              and got["meta_block_bwd_stash"] == steps * LAYERS
              and got["meta_block_fwd"] > 0
              and sum(got.values()) == 2 * steps * LAYERS
              + got["meta_block_fwd"],
              f"cli {tag}: launched {got}, the plain layer {calls[0]} times")
        paths[f"widths_cli_{tag}"] = {n: c for n, c in got.items() if c}
        print(f"widths cli --embedding_dim {d} --att_head_num {heads} "
              f"--bank_update lazy [{card}]: {WIDTH_CLI_ROWS} rows, {steps} "
              f"steps; fit, predict and report in {wall:.4f}s; test AUC "
              f"{auc}; AUC, per-domain AUCs, loss {fields}; launches "
              f"{paths[f'widths_cli_{tag}']}, the plain layer never",
              flush=True)
    return paths


def widths_phase(dev, card, built):
    """Phase 18: the other widths and head counts.  Each shape's shared
    memory, layouts and build seconds (``built``, by library); the kernel
    cases (:func:`width_check_case`, :func:`width_time_case`); the paths.
    Returns (the kernels' fields by shape, the launches by path)."""
    t0 = time.perf_counter()
    fields = {}
    for d, heads in WIDTH_SHAPES:
        tag = f"d{d}h{heads}"
        smem = width_smem(d, heads)
        secs = {k: round(v, 2) for k, v in built.items()
                if f"[{d}, {2 * d}, 0, {heads}]" in k
                or k.endswith(f"[{d}, {heads}]")}
        print(f"widths {tag}: dynamic shared memory at F=19 {smem}; build "
              f"seconds {secs}", flush=True)
        errs = width_check_case(dev, d, heads)
        times = width_time_case(dev, d, heads)
        for name in WIDTH_KERNELS:
            fields.setdefault(name, {})[tag] = dict(
                max_abs_err=errs[name], **times[name])
        print(f"widths {tag} [{card}]: " + "; ".join(
            f"{n} err {errs[n]:.3e} " + " ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in times[n].items())
            for n in WIDTH_KERNELS), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"phase 18a: {time.perf_counter() - t0:.2f}s", flush=True)
    paths = width_wide_path(dev, card)
    paths.update(width_variant_paths(dev, card))
    paths.update(width_cli(dev, card))
    print(f"phase 18: {time.perf_counter() - t0:.2f}s", flush=True)
    return fields, paths


# Phase 19: many meta rows.  K1's backwards past their slice rows walk the
# batch sorted by domain row (kSorted), K6-bwd keeps every row in its
# blocks' slices: both checked at the composite's 56 rows and the JAX cap
# at d = 32 (64), K6 also at 98 and 128 rows (the gate's tables staged in
# shared memory up to 133, the bilinear maps' up to 33); each timed at B =
# 8192 beside its 4-row time in the same call, with its scratch bytes
MANY_ROWS_CHECK = {"metanet": (56, 64), "gate": (56, 64, 98, 128),
                   "bilinear": (56, 64, 128)}
MANY_ROWS_K1_TIMES = ((32, 4, (4, 56, 64)), (64, 8, (4, 14, 32)))
# the gate also on 1372 rows: ``--domain_col 121-122`` (98 x 14), the
# composite of AliCCP's two scenario columns of most values
MANY_ROWS_K6_TIMES = {"gate": (4, 56, 98, 256, 1372),
                      "bilinear": (4, 56, 128)}
# the JAX kernel route's bound on meta rows x the widest hidden layer
ROUTE_WIDTH = 4096
# path 4: a single scenario column of 63 values (64 rows, the JAX cap at d
# = 32): AliCCP's 121 (97 values) drawn over 1..63
CAP_COL, CAP_DOMAINS = "121", 63
# path 2: AliCCP's 121 as it is, 98 rows
COL121_DOMAINS = 97


def many_rows_tables(gen, rows):
    """The metanet layer of :func:`test_layer` with a ``rows``-row table,
    and the gate and bilinear layers (d = 32, 4 heads) with ``rows``-row
    tables."""
    from satrans_torch.nn import attention, initializers as init, metanet
    layer = attention.MetaTransformerLayer(gen, 32)
    with torch.no_grad():
        layer.q_meta.ln.scale.add_(init.normal(gen, (32,), 0.1))
        layer.q_meta.ln.bias.add_(init.normal(gen, (32,), 0.1))
    table = init.normal(gen, (rows, metanet.param_size(UNITS2)), 0.1)
    simple = {}
    for variant in ("gate", "bilinear"):
        lay = attention.MetaTransformerLayer(gen, 32, variant=variant)
        names = ("Q", "K") if variant == "gate" else ("bilinear",)
        width = 32 if variant == "gate" else 32 * 8
        simple[variant] = (lay, {n: init.normal(gen, (rows, width), 0.5)
                                 for n in names})
    return layer, table, simple


def many_rows_check(dev):
    """Phase 19a: at d = 32, 4 heads, B = 8192, F = 19, QK, dropout 0.1 and
    rows uniform over the table: K1-fwd, K1-stash, K1-stash light and
    K1-scores (the output and every residual) and K1-bwd, K1-bwd-stash and
    K1-bwd-stash light (every gradient, on the sorted walk) at 56 and 64
    rows; K6-fwd and K6-bwd, gate at 56, 64, 98 and 128 rows and bilinear
    at 56, 64 and 128, against their plain versions (KERNEL_TOL, GRAD_RTOL
    / GRAD_ATOL).  Returns the worst error by kernel."""
    from satrans_torch.nn import initializers as init
    from satrans_torch.ops import gate_block, meta_block, prng
    from satrans_torch.utils import make_generator
    F, B = 19, BATCH
    kw = dict(meta_units=UNITS2, head_num=4, mode="QK", relu_out=False)
    drop = dict(train=True, drop_rate=DROP_RATE, seed=DROP_SEED,
                block_b=DROP_TILE)
    kargs = prng.kernel_args(True, DROP_RATE, DROP_SEED, DROP_TILE, F)
    errs = {}

    def worst(name, err):
        errs[name] = max(errs.get(name, 0.0), err)

    rows_all = sorted(set(sum(MANY_ROWS_CHECK.values(), ())))
    for rows in rows_all:
        gen = make_generator(SEED + 190 + rows, dev)
        layer, table, simple = many_rows_tables(gen, rows)
        tables = shared(table)
        x = init.normal(gen, (B, F, 32), 1.0)
        g = init.normal(gen, (B, F, 32), 1.0)
        dom = torch.randint(0, rows, (B,), generator=gen, device=dev)
        if rows in MANY_ROWS_CHECK["metanet"]:
            check(meta_block.slice_rows((32, 64, 0, 4)) < rows,
                  f"{rows} rows are within K1's slices")
            masks = meta_block.layer_masks(x, head_num=4, mode="QK", **drop)
            ops, cfg = meta_block.pack_operands(x, layer, tables, dom, **kw)
            ops = [t if t is None else t.detach() for t in ops]
            res = {}
            with torch.no_grad():
                want = meta_block.meta_layer_reference(
                    x, layer, tables, dom, **kw, masks=masks, residuals=res)
                worst("meta_block_fwd", close_err(meta_block.launch_fwd(
                    *ops, cfg, kargs), want, f"K1-fwd {rows} rows"))
                for stash, name in (("full", "meta_block_fwd_stash"),
                                    ("light", "meta_block_fwd_stash_light"),
                                    ("scores", "meta_block_fwd_scores")):
                    got = meta_block.launch_fwd(*ops, cfg, kargs,
                                                stash=stash)
                    worst(name, close_err(got[0], want,
                                          f"{name} y, {rows} rows"))
                    for rn, a in zip(meta_block.STASH_RESIDUALS[stash],
                                     got[1:]):
                        worst(name, close_err(a, res[rn],
                                              f"{name} {rn}, {rows} rows"))
            del res, ops
            gk, _ = kink_free(g, x, layer, tables, dom, masks, **kw)
            want_g = layer_grads(meta_block.meta_layer_reference, x, layer,
                                 tables, dom, gk, **kw, masks=masks)
            for bwd in ("stash", "stash_light", "recompute"):
                got_g = layer_grads(meta_block.fused_meta_layer, x, layer,
                                    tables, dom, gk, **kw, **drop, bwd=bwd)
                worst(K1_BWD_NAME[bwd],
                      max(grad_errors(got_g, want_g).values()))
        kw6 = dict(head_num=4, mode="QK", relu_out=False)
        masks6 = gate_block.layer_masks(x, head_num=4, **drop)
        for variant, (lay, tabs) in simple.items():
            if rows not in MANY_ROWS_CHECK[variant]:
                continue
            with torch.no_grad():
                worst("gate_block_fwd", close_err(
                    gate_block.fused_simple_layer(x, lay, tabs, dom, **kw6,
                                                  **drop),
                    gate_block.simple_layer_reference(
                        x, lay, tabs, dom, **kw6, masks=masks6),
                    f"K6-fwd {variant} {rows} rows"))
            got_g = gate_grads(gate_block.fused_simple_layer, x, lay, tabs,
                               dom, g, **kw6, **drop)
            want_g6 = gate_grads(gate_block.simple_layer_reference, x, lay,
                                 tabs, dom, g, **kw6, masks=masks6)
            worst("gate_block_bwd", max(grad_errors(got_g,
                                                    want_g6).values()))
        gc.collect()
        torch.cuda.empty_cache()
    return errs


def sorted_scratch_bytes(d, h, h2, rows, B=BATCH):
    """K1's backward scratch on the sorted walk, in bytes: a block's dense
    and LayerNorm sums (dWqkv, dWout: 4 d^2; the LayerNorms' 6 rows) and its
    two boundary slots of both MetaNets' blocks (4 x the MetaNet's
    floats); and the sort's ints on ``rows`` rows (rank, perm and the
    sorted rows of the B examples, a count a row a chunk of 256 and the
    rows' starts).  Returns (bytes a block, bytes of the sort)."""
    per_block = 4 * d * d + 6 * d + 4 * _meta_floats(d, h, h2)
    chunks = -(-B // 256)
    return 4 * per_block, 4 * (3 * B + chunks * rows + rows + 1)


def many_rows_scratch(sms):
    """The sorted walk's scratch at every shape of the kernels' set at the
    JAX cap (4096 / the widest hidden layer rows), B = 8192 on ``sms``
    blocks, held against the C entry's count where the shape's library is
    built.  Returns the bytes by shape."""
    import ctypes
    from satrans_torch.ops import _build, meta_block
    table = {}
    for shape in sorted(meta_block.KERNEL_SHAPES):
        d, h, h2, heads = shape
        cap = ROUTE_WIDTH // max(h, h2)
        per_block, sort = sorted_scratch_bytes(d, h, h2, cap)
        total = sms * per_block + sort
        if _build._target("meta_block_bwd", shape)[1].exists():
            blocks = meta_block.kernel_fn(
                "meta_block_bwd", "satrans_meta_block_bwd_stash_blocks",
                [ctypes.c_int] * 3, shape=shape)(BATCH, 19, sms)
            got = 4 * meta_block.scratch_floats(shape, BATCH, cap, blocks)
            check(blocks == sms and got == total,
                  f"scratch at {shape}: the C entry counts {got} bytes on "
                  f"{blocks} blocks, the formula {total}")
        table[str(list(shape))] = dict(rows=cap, block_bytes=per_block,
                                       sort_bytes=sort, total_bytes=total)
    most = max(v["block_bytes"] for v in table.values())
    print(f"many rows: the sorted walk's scratch at the JAX cap, B = "
          f"{BATCH} on {sms} blocks, by (d, h1, h2, heads): "
          + "; ".join(f"{k} {v['rows']} rows {v['block_bytes']} B a block "
                      f"+ {v['sort_bytes']} B sort = {v['total_bytes']} B"
                      for k, v in table.items())
          + f"; at most {most} B a block", flush=True)
    check(most <= 1 << 20, f"the sorted walk's scratch, {most} B a block, "
                           "passes 1 MiB")
    return table


def many_rows_time(dev, card):
    """Phase 19b: B = 8192, F = 19, QK, dropout 0.1, CUDA events, the calls
    back to back: K1-bwd-stash, K1-bwd-stash light and K1-bwd at d = 32 / 4
    heads on 4, 56 and 64 rows and at d = 64 / 8 heads on 4, 14 and 32
    rows (4 rows on the blocks' slices, the rest on the sorted walk), and
    the unchanged K1-fwd and K1-stash beside them with their bounds;
    K6-bwd, gate on 4, 56, 98, 256 and 1372 rows and bilinear on 4, 56
    and 128; each with its walk or staging, scratch bytes, bound and the
    plain layer's autograd backward.  Returns the fields by kernel and case."""
    import ctypes
    from satrans_torch.nn import attention, initializers as init, metanet
    from satrans_torch.ops import gate_block, meta_block, prng
    from satrans_torch.utils import make_generator
    F, B = 19, BATCH
    out = {n: {} for n in ("meta_block_bwd", "meta_block_bwd_stash",
                           "meta_block_bwd_stash_light", "meta_block_fwd",
                           "meta_block_fwd_stash", "gate_block_bwd")}
    kargs = prng.kernel_args(True, DROP_RATE, DROP_SEED, DROP_TILE, F)
    masks_kw = dict(train=True, drop_rate=DROP_RATE, seed=DROP_SEED,
                    block_b=DROP_TILE)
    sms = meta_block.sm_count(dev)
    for d, heads, rows_list in MANY_ROWS_K1_TIMES:
        units, h = (d, 2 * d, d), 2 * d
        shape = (d, h, 0, heads)
        kw = dict(meta_units=units, head_num=heads, mode="QK",
                  relu_out=False)
        blocks = meta_block.kernel_fn(
            "meta_block_bwd", "satrans_meta_block_bwd_stash_blocks",
            [ctypes.c_int] * 3, shape=shape)(B, F, sms)
        gen = make_generator(SEED + 200 + d, dev)
        layer = attention.MetaTransformerLayer(gen, d)
        x = init.normal(gen, (B, F, d), 1.0)
        g = init.normal(gen, (B, F, d), 1.0)
        masks = meta_block.layer_masks(x, head_num=heads, mode="QK",
                                       **masks_kw)
        for rows in rows_list:
            table = init.normal(gen, (rows, metanet.param_size(units)), 0.1)
            dom = torch.randint(0, rows, (B,), generator=gen, device=dev)
            ops, cfg = meta_block.pack_operands(x, layer, shared(table), dom,
                                                **kw)
            ops = [t if t is None else t.detach() for t in ops]
            walk = "slices" if rows <= meta_block.slice_rows(shape) \
                else "sorted"
            scratch = 4 * meta_block.scratch_floats(shape, B, rows, blocks)
            with torch.no_grad():
                # the forwards (unchanged) beside them
                for stash, name in ((None, "meta_block_fwd"),
                                    ("full", "meta_block_fwd_stash")):
                    ms = time_ms(lambda: meta_block.launch_fwd(
                        *ops, cfg, kargs, stash=stash), iters=20)
                    b_ms, b_by = meta_layer_bound_ms(B, F, d, h, heads,
                                                     rows, 1, 1, stash=stash)
                    out[name][f"d{d}h{heads}_{rows}rows"] = dict(
                        ms=ms, bound_ms=b_ms, bound_by=b_by)
                res = {s: meta_block.launch_fwd(*ops, cfg, kargs,
                                                stash=s)[1:]
                       for s in ("full", "light")}
                for r, name, stash in (
                        (res["full"], "meta_block_bwd_stash", "full"),
                        (res["light"], "meta_block_bwd_stash_light",
                         "light"), (None, "meta_block_bwd", None)):
                    ms = time_ms(lambda: meta_block.launch_bwd(
                        g, *ops, cfg, kargs, res=r), iters=20)
                    b_ms, b_by = meta_layer_bwd_bound_ms(
                        B, F, d, h, heads, rows, 1, 1, stash=stash)
                    out[name][f"d{d}h{heads}_{rows}rows"] = dict(
                        ms=ms, bound_ms=b_ms, bound_by=b_by, walk=walk,
                        scratch_bytes=scratch, blocks=blocks)
            del res
            xr = x.detach().requires_grad_(True)
            tr = table.detach().requires_grad_(True)
            yr = meta_block.meta_layer_reference(xr, layer, shared(tr), dom,
                                                 **kw, masks=masks)
            pb_ms = time_ms(lambda: torch.autograd.grad(
                yr, [xr, tr, *layer.parameters()], g, retain_graph=True),
                iters=3)
            del yr
            for name in K1_BWD_NAME.values():
                out[name][f"d{d}h{heads}_{rows}rows"]["plain_ms"] = pb_ms
            gc.collect()
            torch.cuda.empty_cache()
    gen = make_generator(SEED + 210, dev)
    x = init.normal(gen, (B, F, 32), 1.0)
    g = init.normal(gen, (B, F, 32), 1.0)
    masks6 = gate_block.layer_masks(x, head_num=4, **masks_kw)
    kg = prng.kernel_args(True, DROP_RATE, DROP_SEED, DROP_TILE, F,
                          pad_mult=gate_block.PAD_FIELDS)
    kw6 = dict(head_num=4, mode="QK", relu_out=False)
    blocks = gate_block.kernel_fn(
        "gate_block_bwd", "satrans_gate_block_bwd_blocks",
        [ctypes.c_int] * 3)(B, F, sms)
    floats = gate_block.kernel_fn(
        "gate_block_bwd", "satrans_gate_block_bwd_grad_floats",
        [ctypes.c_int] * 4)
    smem = gate_block.kernel_fn(
        "gate_block_bwd", "satrans_gate_block_bwd_smem", [ctypes.c_int] * 5)
    for variant, rows_list in MANY_ROWS_K6_TIMES.items():
        bil = int(variant == "bilinear")
        for rows in rows_list:
            lay = attention.MetaTransformerLayer(gen, 32, variant=variant)
            names = ("Q", "K") if variant == "gate" else ("bilinear",)
            width = 32 if variant == "gate" else 32 * 8
            tabs = {n: init.normal(gen, (rows, width), 0.5) for n in names}
            dom = torch.randint(0, rows, (B,), generator=gen, device=dev)
            ops6, cfg6 = gate_block.pack_operands(x, lay, tabs, dom, **kw6)
            ops6 = [t.detach() for t in ops6]
            ms = time_ms(lambda: gate_block.launch_bwd(g, *ops6, cfg6, kg),
                         iters=20)
            b_ms, b_by = gate_layer_bound_ms(B, F, 32, 4, rows, variant, 1,
                                             1, bwd=True)
            # the tables are staged where the body's layout with them fits
            staged = smem(32, 4, rows, bil, F) > smem(32, 4, 0, bil, F)
            trs = {k: t.detach().requires_grad_(True)
                   for k, t in tabs.items()}
            xr = x.detach().requires_grad_(True)
            yr = gate_block.simple_layer_reference(xr, lay, trs, dom, **kw6,
                                                   masks=masks6)
            pb_ms = time_ms(lambda: torch.autograd.grad(
                yr, [xr, *trs.values(), *lay.parameters()], g,
                retain_graph=True), iters=3)
            del yr
            out["gate_block_bwd"][f"{variant}_{rows}rows"] = dict(
                ms=ms, bound_ms=b_ms, bound_by=b_by, plain_ms=pb_ms,
                scratch_bytes=4 * blocks * floats(32, 4, rows, bil),
                blocks=blocks, tables_staged=staged)
    for name, cases in out.items():
        print(f"many rows {name} [{card}]: " + "; ".join(
            f"{c} " + " ".join(f"{k} {v:.4f}" if isinstance(v, float)
                               else f"{k} {v}" for k, v in f.items())
            for c, f in cases.items()), flush=True)
    base = out["meta_block_bwd_stash"]["d32h4_4rows"]["ms"]
    print(f"many rows: K1-bwd-stash at the AliCCP sota shape (4 rows) "
          f"{base:.4f} ms, {100 * (base / 0.7636 - 1):+.1f} % against "
          f"PERF.md's 0.7636 ms [{card}]", flush=True)
    return out


def many_rows_paths(dev, card):
    """Phase 19c: the reference CLI's many-row configurations at the AliCCP
    sota width (19 fields with the real vocab sizes, 3 layers, batch 8192,
    dropout 0.1), each path counted from 0 with the plain layer's calls
    (none) and each step's device busy time (:func:`width_steps`): (1) the
    gate and the bilinear map on scenario columns 301 and 122 (56
    composite rows, K6), 3 ``lazy`` steps and a request of REQUEST_ROWS
    each (against the plain path); (2) the gate on 121 (98 rows), 3
    ``lazy`` steps; (3) d = 64, 8 heads, metanet on 122 (14 rows, K1 past
    its slice rows there), 3 ``lazy`` stash steps and 3 ``dense``
    recompute steps; (4) d = 32, metanet on one column of 63 values (64
    rows, the JAX cap), 3 ``lazy`` stash steps.  Returns the launches by
    path."""
    from satrans_torch.data import aliccp
    from satrans_torch.serving import Predictor
    from satrans_torch.train import Trainer
    x, y = training_data()
    rng = np.random.default_rng(SEED + 21)
    req = {n: rng.integers(1, aliccp.DATA_MAX[n] + 1, REQUEST_ROWS)
           for n in aliccp.SPARSE_FEATURES}
    batches = -(-REQUEST_ROWS // BATCH)
    paths = {}
    gate_step = (1, 1) + NO_K1 + NO_K7

    def trained(model, bank="lazy"):
        trainer = Trainer(model, seed=SEED, device=dev)
        trainer.compile(learning_rate=TRAIN_LR, bank_update=bank)
        model.train()
        return trainer

    def freed():
        gc.collect()
        torch.cuda.empty_cache()

    for variant in ("gate", "bilinear"):
        tag = f"301_122_{variant}"
        model = width_model(dev, 32, 4, variant, cols=MULTICOL_COLS,
                            domains=MULTICOL_DOMAINS)
        check(model.meta_rows == MULTICOL_ROWS and model.simple_kernel
              and not model.tiled, f"{tag}: not K6 on {model.meta_rows} "
                                   "rows")
        trainer = trained(model)
        paths[f"many_train_{tag}"] = width_steps(
            card, f"many rows {tag} lazy", trainer,
            staged_batch(trainer, x, y), gate_step)
        model.eval()
        pred = Predictor(model, batch_size=BATCH, device=dev)
        t0 = time.perf_counter()
        scores, paths[f"many_serve_{tag}"] = width_run(
            card, f"many rows {tag} serve", lambda: pred(req),
            (batches * LAYERS, 0) + NO_K1 + NO_K7)
        wall = time.perf_counter() - t0
        device_profile(f"many rows {tag}: one request of {REQUEST_ROWS}",
                       lambda: pred(req), 1e3 * wall, card, top=6)
        model.route = "plain"
        want = Predictor(model, batch_size=BATCH, device=dev)(req)
        model.route = "kernel"
        diff = float(np.abs(scores - want).max())
        check(bool(np.all(np.isfinite(scores))) and diff <= SERVING_TOL,
              f"many rows {tag} serve: scores differ from the plain path "
              f"by {diff}")
        print(f"many rows {tag} serve [{card}]: {REQUEST_ROWS} examples in "
              f"{wall:.4f}s; max |kernel - plain| = {diff:.3e}", flush=True)
        del model, trainer, pred
        freed()
    model = width_model(dev, 32, 4, "gate", cols=("121",),
                        domains=(COL121_DOMAINS,))
    check(model.meta_rows == 98 and model.simple_kernel, "121 gate route")
    trainer = trained(model)
    paths["many_train_121_gate"] = width_steps(
        card, "many rows 121 gate lazy", trainer,
        staged_batch(trainer, x, y), gate_step)
    del model, trainer
    freed()
    model = width_model(dev, 64, 8, cols=("122",), domains=(13,),
                        no_emb_init=True)
    check(model.meta_rows == 14 and model.metanet_kernel,
          "d64 122 metanet route")
    for bank, bwd in (("lazy", "stash"), ("dense", "recompute")):
        os.environ["SATRANS_BWD"] = bwd
        trainer = trained(model, bank)
        paths[f"many_train_d64h8_122_{bank}_{bwd}"] = width_steps(
            card, f"many rows d64h8 122 {bank} {bwd}", trainer,
            staged_batch(trainer, x, y), (0, 0) + K1_PAIR[bwd] + NO_K7)
        del trainer
        freed()
    os.environ.pop("SATRANS_BWD")
    del model
    freed()
    model = width_model(dev, 32, 4, cols=(CAP_COL,), domains=(CAP_DOMAINS,))
    check(model.meta_rows * 64 == ROUTE_WIDTH and model.metanet_kernel,
          "the 64-row metanet route")
    trainer = trained(model)
    x4 = dict(x, **{CAP_COL: rng.integers(1, CAP_DOMAINS + 1, TRAIN_ROWS)})
    paths["many_train_64rows_lazy_stash"] = width_steps(
        card, "many rows 64-row metanet lazy stash", trainer,
        staged_batch(trainer, x4, y), (0, 0) + K1_PAIR["stash"] + NO_K7)
    del model, trainer
    freed()
    return paths


def many_rows_phase(dev, card):
    """Phase 19: many meta rows.  Returns (the changed kernels' errors,
    times and the sorted walk's scratch table, the launches by path)."""
    from satrans_torch.ops import meta_block
    t0 = time.perf_counter()
    errs = many_rows_check(dev)
    print(f"many rows [{card}]: worst |kernel - plain| at "
          f"{MANY_ROWS_CHECK}: " + "; ".join(
              f"{n} {e:.3e}" for n, e in errs.items()), flush=True)
    times = many_rows_time(dev, card)
    scratch = many_rows_scratch(meta_block.sm_count(dev))
    print(f"phase 19a-b: {time.perf_counter() - t0:.2f}s", flush=True)
    paths = many_rows_paths(dev, card)
    print(f"phase 19: {time.perf_counter() - t0:.2f}s", flush=True)
    return dict(errors=errs, times=times, scratch=scratch), paths


# phase 20: the legacy Star-Trans models as the JAX CLI builds them
# (satrans_tpu/cli/main.py:213-230; scenario 301, --domain_att_layer_num
# 3, --att_head_num 4, --att_layer_num 0 unless given), SATrans past
# SATRANS_COMPOSITE_MAX, and the CLI with both
LEGACY_RUNS = (
    ("Star_Trans", ["--model_name", "Star_Trans"]),
    ("Star_Trans_trans2_sum", ["--model_name", "Star_Trans",
                               "--att_layer_num", "2", "--att_layer_type",
                               "trans", "--merge", "sum"]),
    ("Starv2_Trans", ["--model_name", "Starv2_Trans", "--num_query_bases",
                      "3", "--attn_batch_reg", "0.1"]),
    ("Starv3_Trans", ["--model_name", "Starv3_Trans", "--meta_mode",
                      "Query"]),
    ("Starv4_Trans", ["--model_name", "Starv4_Trans"]),
    ("Starv4_Trans_aggmap", ["--model_name", "Starv4_Trans", "--flag",
                             "aggmap"]),
)
# 4 x 14 x 8 = 448 combinations, past SATRANS_COMPOSITE_MAX (256)
PER_EXAMPLE_COLS = ("301", "122", "125")
PER_EXAMPLE_REQUESTS = 3
LEGACY_CLI_RUNS = (
    ("cli_Starv2_Trans", ["--model_name", "Starv2_Trans"]),
    ("cli_SATrans_domain_f0", ["--model_name", "SATrans", "--domain_col",
                               "domain-f0"]),
)


def cli_model(dev, argv, cols=("301",)):
    """The model ``cli.build_model`` builds for ``argv`` at the AliCCP sota
    layout on the scenario columns ``cols``, each with the CLI's domain
    count (its DATA_MAX)."""
    from satrans_torch.cli import main as cli
    from satrans_torch.data import aliccp
    from satrans_torch.features import FeatureLayout
    args = cli.parse_args(argv)
    return cli.build_model(args, FeatureLayout(aliccp.sota_columns(32)),
                           list(cols), [aliccp.DATA_MAX[c] for c in cols],
                           args.flag, device=dev)


def legacy_arm(card, label, trainer, x, y, mode, tail=None, aux=False):
    """ZOO_STEPS ``fit`` steps of one arm (:func:`star_mtl_arm`: K2-K5's
    launches a step held, no layer kernel), every step's loss and aux loss
    finite, the aux loss above 0 with ``aux`` (0 without); then the staged
    step's time and device profile.  Returns (the launches by kernel, the
    device busy ms a step)."""
    stats, step = [], trainer.train_step

    def recorded(*args, **kw):
        stats.append(step(*args, **kw))
        return stats[-1]

    trainer.train_step = recorded
    try:
        launched = star_mtl_arm(card, label, trainer, x, y, mode, tail,
                                timed=False)
    finally:
        trainer.train_step = step
    arm = mode + (f" tail {tail}" if tail else "")
    got = np.array([[float(s[k]) for k in ("loss", "aux_loss")]
                    for s in stats])
    check(len(got) == ZOO_STEPS and bool(np.isfinite(got).all())
          and (bool((got[:, 1] > 0).all()) if aux
               else not got[:, 1].any()),
          f"{label} {arm}: per-step loss and aux loss {got.tolist()}")
    if tail:
        os.environ["SATRANS_LAZY_TAIL"] = tail
    try:
        batch, yb, wb = staged_batch(trainer, x, y, BATCH)
        step_ms = time_ms(lambda: trainer.train_step(batch, yb, wb), iters=3)
        busy = device_profile(f"{label} {arm}: one training step of {BATCH}",
                              lambda: trainer.train_step(batch, yb, wb),
                              step_ms, card, top=6)
    finally:
        os.environ.pop("SATRANS_LAZY_TAIL", None)
    print(f"{label} {arm} [{card}]: aux loss per step "
          f"{got[:, 1].round(6).tolist()}; staged step {step_ms:.3f} ms, "
          f"device busy {busy} ms a step", flush=True)
    return launched, busy


def legacy_run(dev, card, label, argv, x, y):
    """Phase 20a for one configuration: 3 ``dense`` steps, then 3 + 3
    ``lazy`` steps (split tail, fused tail) on one trainer, each arm timed
    and profiled; then the forward on the card against a CPU copy (on the
    lazy model).  Returns (the launches by path, busy ms a step by path,
    the forward's error)."""
    from satrans_torch.train import Trainer
    paths, busy = {}, {}
    for mode in ("dense", "lazy"):
        model = cli_model(dev, argv)
        trainer = Trainer(model, seed=SEED, device=dev)
        trainer.compile(learning_rate=ZOO_LR, bank_update=mode)
        zoo_fit(trainer, x, y, BATCH, 1)  # warmup: one step
        for tail in ((None, "fused") if mode == "lazy" else (None,)):
            arm = f"{label}_{mode}" + (f"_{tail}" if tail else "")
            paths[arm], busy[arm] = legacy_arm(
                card, label, trainer, x, y, mode, tail,
                aux=label.startswith("Starv2"))
        if mode == "dense":
            del model, trainer
            gc.collect()
            torch.cuda.empty_cache()
    err = zoo_forward_check(dev, card, label, x, model)
    del model, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return paths, busy, err


def per_example_run(dev, card, variant, x, y):
    """Phase 20b for one variant: SATrans as the CLI builds it on
    ``--domain_col 301-122-125`` (448 combinations, past
    SATRANS_COMPOSITE_MAX: per-example meta parameters on the XLA route):
    3 ``lazy`` steps (:func:`legacy_arm`), a Predictor answering
    PER_EXAMPLE_REQUESTS requests of BATCH with no kernel launched, timed
    and profiled, then the forward against a CPU copy.  Returns (the
    launches by path, busy ms a step by path, the forward's error)."""
    from satrans_torch.ops import eqgemm, gather, lazy_tail, scatter
    from satrans_torch.serving import Predictor
    from satrans_torch.train import Trainer
    label = f"SATrans_301_122_125_{variant}"
    model = cli_model(dev, ["--flag", "gate" if variant == "gate"
                            else "None"], cols=PER_EXAMPLE_COLS)
    check(model.per_example and model.product_domains == 448
          and model.variant == variant
          and not (model.metanet_kernel or model.simple_kernel
                   or model.tiled), f"{label}: not the per-example route")
    trainer = Trainer(model, seed=SEED, device=dev)
    trainer.compile(learning_rate=ZOO_LR, bank_update="lazy")
    zoo_fit(trainer, x, y, BATCH, 1)  # warmup: one step
    launched, busy = legacy_arm(card, label, trainer, x, y, "lazy")
    paths, busy = {f"{label}_lazy": launched}, {f"{label}_lazy": busy}
    model.eval()
    pred = Predictor(model, batch_size=BATCH, device=dev)
    reqs = [{k: v[i * BATCH:(i + 1) * BATCH] for k, v in x.items()}
            for i in range(PER_EXAMPLE_REQUESTS)]
    pred(reqs[0])  # warmup
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    scores = [pred(r) for r in reqs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = tuple(m.launches for m in (gather, scatter, eqgemm, lazy_tail))
    check(not any(layer_counts()) and not any(rows)
          and all(bool(np.isfinite(s).all()) and s.shape == (BATCH,)
                  for s in scores),
          f"{label} serving: launches {layer_counts()}, {rows}")
    busy[f"{label}_serve"] = device_profile(
        f"{label}: one request of {BATCH}", lambda: pred(reqs[0]),
        1e3 * wall / PER_EXAMPLE_REQUESTS, card, top=6)
    print(f"{label} serve [{card}]: {PER_EXAMPLE_REQUESTS} requests of "
          f"{BATCH} in {wall:.4f}s, no kernel; scores mean "
          f"{float(np.mean(scores)):.6f}", flush=True)
    err = zoo_forward_check(dev, card, label, x, model)
    del model, trainer, pred
    gc.collect()
    torch.cuda.empty_cache()
    return paths, busy, err


def legacy_phase(dev, card):
    """Phase 20: the legacy Star-Trans models, SATrans past
    SATRANS_COMPOSITE_MAX and the CLI with both.  Returns the launches by
    path and kernel."""
    t0 = time.perf_counter()
    x, y = training_data()
    paths, busy, errs = {}, {}, {}
    for label, argv in LEGACY_RUNS:
        p, b, errs[label] = legacy_run(dev, card, label, argv, x, y)
        paths.update(p)
        busy.update(b)
    for variant in ("metanet", "gate"):
        p, b, errs[variant] = per_example_run(dev, card, variant, x, y)
        paths.update(p)
        busy.update(b)
    paths.update(cli_lazy_runs(dev, card, LEGACY_CLI_RUNS))
    print(f"phase 20 [{card}]: {time.perf_counter() - t0:.2f}s; device "
          f"busy ms a step by path {json.dumps(busy)}; the forwards' worst "
          f"error {max(errs.values()):.3e}", flush=True)
    return paths


# phase 21: the data pipeline and the rest of the single-card Trainer
PIPE_STEPS = 6  # fit against fit_from_iterator: 5 full steps and a tail
PIPE_ROWS = (PIPE_STEPS - 1) * BATCH + TAIL
OPT_STEPS = 3
# the optimizers of phase 21: (name, compile's optimizer, checked steps).
# optax.sgd(0.01), which the JAX Trainer takes whatever the learning rate,
# diverges on the sum-reduced loss of a batch of 8192 (its second step
# doubles the loss, its third step's gradients are not finite): its first
# step is checked and the next two reported; the custom optimizer is
# torch's own SGD at 1e-4
OPT_ARMS = (("sgd", "sgd", 1), ("adagrad", "adagrad", OPT_STEPS),
            ("rmsprop", "rmsprop", OPT_STEPS),
            ("custom_sgd", lambda ps: torch.optim.SGD(ps, lr=1e-4),
             OPT_STEPS))
# each step's parameters from the kernel path's gradients against those
# from the plain path's, from the same parameters and optimizer state: an
# update moves a parameter by lr times a smooth function of its gradient
# (sgd: lr g; adagrad: lr g / sqrt(0.1 + sum g^2), at most lr / sqrt(0.1)
# = 0.032 per unit of g), and one step's gradients differ by at most
# about 1e-4 of their largest entry (phase 5): 1e-4 of each parameter
# plus 1e-4 holds them.  rmsprop's first update, lr g / sqrt(0.1 g^2 +
# 1e-8), is +-lr sqrt(10) once |g| >> 3e-4 whatever g's size, so an entry
# whose gradient lies within the gradient tolerance of 0 may step either
# way on the two paths: at most RMSPROP_FLIP_SHARE of a tensor's entries
# may leave the tolerance, none by more than 2 lr sqrt(10)
OPT_PARAM_TOL = dict(atol=1e-4, rtol=1e-4)
RMSPROP_FLIP_SHARE = 1e-3
RMSPROP_STEP_BOUND = 2 * TRAIN_LR * 10 ** 0.5
EVAL_ROWS = 4 * BATCH
EVAL_AUC_TOL, EVAL_LOSS_TOL = 1e-5, 1e-6


def row_counts():
    from satrans_torch.ops import eqgemm, gather, lazy_tail, scatter
    return tuple(m.launches for m in (gather, scatter, eqgemm, lazy_tail))


def path_counts():
    """The launches of K1's bodies and of the row kernels, by name."""
    return dict(zip(K1_NAMES + ROW_NAMES, (*k1_counts(), *row_counts())))


def native_check(card, x):
    """The native batcher, built on this host: ``gather_rows`` and
    ``gather_columns`` equal numpy on a batch of the AliCCP columns, and
    each is timed against numpy on the host."""
    from satrans_torch import native
    from satrans_torch.data import aliccp
    t0 = time.perf_counter()
    check(native.available(), "the native batcher did not build")
    build_s = time.perf_counter() - t0
    cols = [np.ascontiguousarray(x[c], dtype=np.int32)
            for c in aliccp.SPARSE_FEATURES]
    table = np.stack(cols, axis=1)
    idx = np.random.default_rng(SEED).permutation(len(cols[0]))[:BATCH]
    check(np.array_equal(native.gather_rows(table, idx), table[idx])
          and np.array_equal(native.gather_columns(cols, idx),
                             np.stack([c[idx] for c in cols], axis=1)),
          "the native gathers differ from numpy")

    def host(fn, iters=50):
        fn()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        return 1e3 * (time.perf_counter() - t) / iters

    ms = {"gather_rows": host(lambda: native.gather_rows(table, idx)),
          "numpy_rows": host(lambda: table[idx]),
          "gather_columns": host(lambda: native.gather_columns(cols, idx)),
          "numpy_columns": host(lambda: np.stack([c[idx] for c in cols],
                                                 axis=1))}
    print(f"native batcher [{card}]: built and loaded in {build_s:.2f}s, "
          f"{native.thread_count()} OpenMP threads; gather_rows and "
          f"gather_columns equal numpy on {BATCH} of {len(cols[0])} "
          f"rows x {len(cols)} int32 columns; host ms a batch: "
          + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()), flush=True)
    return ms


def iterator_check(dev, card, x, y):
    """``fit_from_iterator`` through ``Prefetcher(ShardedBatchIterator(
    ...).epoch(e))`` against ``fit`` on the same rows, ``lazy``: the
    parameters and the lazy state after PIPE_STEPS steps equal ``fit``'s
    within ``fit``'s own run-to-run spread (two runs of ``fit``; a
    parameter bit-identical between them must be bit-identical here too),
    every kernel's launches exactly phase 7's a step.  Returns the
    launches by path."""
    from satrans_torch.data.loader import Prefetcher, ShardedBatchIterator
    xs = {k: v[:PIPE_ROWS] for k, v in x.items()}
    ys = y[:PIPE_ROWS]
    want = dict(zip(K1_NAMES + ROW_NAMES, (
        *(LAYERS * PIPE_STEPS * c for c in K1_PAIR["stash"]),
        *(PIPE_STEPS * c for c in LAZY_ROWS_PER_STEP))))
    runs, paths, rates = [], {}, {}
    for label in ("fit", "fit_from_iterator", "fit_again"):
        model, trainer = training_model(dev, "lazy")
        it = ShardedBatchIterator(trainer.layout.batch_from_dict(xs), ys,
                                  BATCH, seed=trainer.seed)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        if label == "fit_from_iterator":
            trainer.fit_from_iterator(lambda e: Prefetcher(it.epoch(e)),
                                      epochs=1, verbose=0)
        else:
            trainer.fit(xs, ys, batch_size=BATCH, epochs=1, verbose=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = path_counts()
        check(got == want, f"{label}: launches {got}, want {want}")
        paths[f"pipeline_{label}"] = got
        rates[label] = PIPE_ROWS / wall
        state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        state.update({f"lazy.{k}": trainer._lazy[k].clone()
                      for k in ("mu", "nu", "last")})
        check(trainer._lazy["count"] == PIPE_STEPS, "lazy count")
        runs.append(state)
        del model, trainer
        gc.collect()
        torch.cuda.empty_cache()
    ref, it_run, again = runs
    spread = {k: (again[k] - v).abs().max().item() for k, v in ref.items()}
    gap = {k: (it_run[k] - v).abs().max().item() for k, v in ref.items()}
    bad = [k for k in ref if gap[k] > 2 * spread[k]]
    check(not bad, f"fit_from_iterator differs from fit past twice fit's "
                   f"run-to-run spread in {bad}: "
                   + ", ".join(f"{k} {gap[k]:.3e} vs {spread[k]:.3e}"
                               for k in bad))
    exact = sum(torch.equal(it_run[k], v) for k, v in ref.items())
    worst = max(gap, key=gap.get)
    print(f"fit_from_iterator vs fit [{card}]: lazy, {PIPE_STEPS} steps of "
          f"{BATCH} (the last a tail of {TAIL}): {exact} of {len(ref)} "
          f"tensors bit-identical, the largest gap {gap[worst]:.3e} "
          f"({worst}) against fit's run-to-run spread {spread[worst]:.3e} "
          f"(the largest spread {max(spread.values()):.3e}); launches "
          f"{want} each; trained examples/s: fit {rates['fit']:.1f} / "
          f"{rates['fit_again']:.1f}, fit_from_iterator "
          f"{rates['fit_from_iterator']:.1f}", flush=True)
    return paths, rates


def optimizer_check(dev, card, x, y):
    """The optimizers of OPT_ARMS in ``dense``, each step on the same batch
    and dropout key: the kernel path's gradients against the plain
    path's at the same parameters (:func:`step_grad_errors`), and the
    parameters the optimizer makes of each from the same parameters and
    state (OPT_PARAM_TOL; rmsprop's flips as stated there); exactly 3 + 3
    K1-stash / K1-bwd-stash launches a step on the kernel path and none on
    the plain one; sgd's diverging steps reported.  Returns the launches
    by path."""
    from satrans_torch.train import Trainer
    model, adam = training_model(dev, "dense")
    batches = [staged_batch(adam, {k: v[i * BATCH:] for k, v in x.items()},
                            y[i * BATCH:], BATCH) for i in range(OPT_STEPS)]
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    params = dict(model.named_parameters())
    per_step = tuple(LAYERS * c for c in K1_PAIR["stash"])
    paths = {}
    for name, opt, steps in OPT_ARMS:
        model.load_state_dict(start)
        trainer = Trainer(model, seed=SEED, device=dev).compile(
            optimizer=opt, learning_rate=TRAIN_LR)
        worst_grad, worst_param, losses = 0.0, (0.0, ""), []
        held_f64, flipped = set(), 0
        for step, (batch, yb, wb) in enumerate(batches):
            key = (0, step)
            if step >= steps:  # sgd's diverging steps, reported
                zero_counts()
                stats = trainer.train_step(batch, yb, wb, key=key)
                check(k1_counts() == per_step, f"{name}: step {step} "
                                               f"launched {k1_counts()}")
                finite = all(bool(torch.isfinite(p.grad).all())
                             for p in model.parameters())
                losses.append(f"{float(stats['loss']) / BATCH:.4f} (not "
                              f"checked; gradients finite: {finite})")
                continue
            grads = []
            for route in ("kernel", "plain"):
                model.train()
                model.route = route
                model.zero_grad(set_to_none=True)
                zero_counts()
                trainer.loss_terms(dict(batch, _weight=wb), yb, wb,
                                   key)[0].backward()
                want = per_step if route == "kernel" else NO_K1
                check(k1_counts() == want, f"{name} step {step} {route}: "
                      f"launches {k1_counts()}, want {want}")
                grads.append({n: p.grad.clone() for n, p in params.items()})
            model.route = "kernel"
            errs, f64 = step_grad_errors(trainer, *grads, batch, yb, wb, key)
            worst_grad = max(worst_grad, max(errs.values()))
            held_f64 |= f64
            # the plain path's step from this state, then the kernel
            # path's (the train step, its launches counted)
            before = {n: p.detach().clone() for n, p in params.items()}
            state = copy.deepcopy(trainer.optimizer.state_dict())
            for n, p in params.items():
                p.grad = grads[1][n]
            trainer.optimizer.step()
            plain = {n: p.detach().clone() for n, p in params.items()}
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(before[n])
            trainer.optimizer.load_state_dict(state)
            del grads, before, state
            zero_counts()
            stats = trainer.train_step(batch, yb, wb, key=key)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(stats["loss"])) and k1_counts()
                  == per_step, f"{name} step {step}: loss "
                  f"{float(stats['loss'])}, launches {k1_counts()}")
            losses.append(f"{float(stats['loss']) / BATCH:.6f}")
            for n, p in params.items():
                err = (p.detach() - plain[n]).abs().max().item()
                out = int((~torch.isclose(p.detach(), plain[n],
                                          **OPT_PARAM_TOL)).sum())
                flipped += out
                rms = name == "rmsprop"
                check(bool(torch.isfinite(p).all()) and (
                    not out or (rms and out <= RMSPROP_FLIP_SHARE * p.numel()
                                and err <= RMSPROP_STEP_BOUND)),
                      f"{name} step {step}: parameter {n} from the kernel "
                      f"path's gradients differs from the plain path's by "
                      f"{err:.3e}, {out} of {p.numel()} entries outside "
                      f"{OPT_PARAM_TOL}")
                worst_param = max(worst_param, (err, n))
            del plain
        moved = max((v - start[k]).abs().max().item()
                    for k, v in model.state_dict().items())
        check(moved > 0, f"{name}: no parameter moved")
        # a checked step launches its gradients' pass and the train step
        paths[f"pipeline_{name}"] = dict(zip(K1_NAMES, tuple(
            (steps + OPT_STEPS) * c for c in per_step)))
        print(f"optimizer {name} [{card}]: dense, {steps} checked steps of "
              f"{OPT_STEPS}: gradients kernel vs plain path max_abs_err "
              f"{worst_grad:.3e} ({sorted(held_f64) or 'none'} held to the "
              f"float64 criterion); parameters from the two paths' "
              f"gradients {worst_param[0]:.3e} ({worst_param[1]}; "
              f"{flipped} entries outside {OPT_PARAM_TOL}); the largest "
              f"move {moved:.3e}; loss a example {losses}; {LAYERS} + "
              f"{LAYERS} K1-stash / K1-bwd-stash a step", flush=True)
        del trainer
    del model, adam, start, params, batches
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def step_grad_errors(trainer, got, plain, batch, yb, wb, key):
    """One step's kernel-path gradients ``got`` against the plain path's
    ``plain`` at the same parameters (``trainer.model``'s) and key: each
    within phase 5's
    tolerance, or, where one misses it (after a large step a relu input
    or an attention logit sits near its kink and rounding flips its
    side), within that tolerance of the float64 plain path's gradient plus
    the float32 plain path's own distance from it (phase 13's criterion).
    Returns (max |got - plain| by name, the names held to float64)."""
    errs, missed = {}, []
    for name, w in plain.items():
        g = got[name]
        check(bool(torch.isfinite(g).all()), f"gradient {name} not finite")
        errs[name] = (g - w).abs().max().item()
        if errs[name] > GRAD_RTOL * w.abs().max().item() + GRAD_ATOL:
            missed.append(name)
    if missed:
        from satrans_torch.train import losses
        ref = copy.deepcopy(trainer.model).double()
        ref.route = "plain"
        ref.zero_grad(set_to_none=True)
        pred, aux = losses.forward_with_aux(ref, dict(batch, _weight=wb),
                                            key=key)
        (trainer.strategy.loss(pred, yb.double(), batch, wb.double())
         + ref.reg_loss() + aux).backward()
        exact = dict(ref.named_parameters())
        for name in missed:
            w = exact[name].grad
            err = (got[name].double() - w).abs().max().item()
            plain_err = (plain[name].double() - w).abs().max().item()
            check(err <= GRAD_RTOL * w.abs().max().item() + GRAD_ATOL
                  + plain_err,
                  f"gradient {name} differs from the float64 plain one by "
                  f"{err}, the float32 plain one by {plain_err} (largest "
                  f"entry {w.abs().max().item()})")
        del ref, exact
    return errs, set(missed)


def checkpoint_check(dev, card, x, y):
    """``callbacks.ModelCheckpoint`` under ``rmsprop``: the checkpoint
    written at the end of an epoch of 2 steps restores into a new trainer
    (another seed's model) with its parameters, its optimizer state and
    its offset equal bit for bit."""
    import tempfile

    from satrans_torch.train import Trainer, callbacks, checkpoint
    model, _ = training_model(dev, "dense")
    trainer = Trainer(model, seed=SEED, device=dev).compile(
        optimizer="rmsprop", learning_rate=TRAIN_LR)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "ckpt")
        t0 = time.perf_counter()
        trainer.fit({k: v[:2 * BATCH] for k, v in x.items()}, y[:2 * BATCH],
                    batch_size=BATCH, verbose=0,
                    callbacks=[callbacks.ModelCheckpoint(path)])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        other, _ = training_model(dev, "dense", seed=SEED + 1)
        fresh = Trainer(other, seed=SEED, device=dev).compile(
            optimizer="rmsprop", learning_rate=TRAIN_LR)
        t0 = time.perf_counter()
        checkpoint.restore(path, fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    names = dict(model.named_parameters())
    names2 = dict(other.named_parameters())
    check(all(torch.equal(v, other.state_dict()[k])
              for k, v in model.state_dict().items()),
          "the restored parameters differ")
    check(len(trainer.optimizer.state) == len(names) and all(
        torch.equal(trainer.optimizer.state[p]["nu"],
                    fresh.optimizer.state[names2[n]]["nu"])
        for n, p in names.items()), "the restored rmsprop state differs")
    check(getattr(model, "domain_id_offset", None)
          == getattr(other, "domain_id_offset", None), "the offset differs")
    print(f"ModelCheckpoint [{card}]: rmsprop, 2 steps of {BATCH} in "
          f"{fit_s:.2f}s with a checkpoint of {size / 2 ** 20:.1f} MiB at "
          f"the epoch's end; restored into a new trainer in "
          f"{restore_s:.2f}s: {len(names)} parameters and their nu bit for "
          f"bit, the offset equal", flush=True)
    return trainer


def evaluate_domains_check(card, trainer):
    """``evaluate_domains`` on EVAL_ROWS examples on K1-fwd alone, against
    ``metrics.auc``, ``per_domain_auc`` and ``log_loss`` on ``predict()``'s
    scores.  Returns the launches of the evaluation."""
    from satrans_torch.data import aliccp
    from satrans_torch.train import metrics
    rng = np.random.default_rng(SEED + 3)
    ev = {name: rng.integers(1, aliccp.DATA_MAX[name] + 1, EVAL_ROWS)
          for name in aliccp.SPARSE_FEATURES}
    # labels that follow the scenario, so the AUCs are not all near 0.5
    ev_y = (rng.random(EVAL_ROWS) < 0.2 * ev["301"]).astype(np.float32)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    res, dom = trainer.evaluate_domains(ev, ev_y, "301", batch_size=BATCH)
    wall = time.perf_counter() - t0
    launched = path_counts()
    want = dict(zip(K1_NAMES + ROW_NAMES, (LAYERS * EVAL_ROWS // BATCH,)
                    + (0,) * (len(K1_NAMES) + len(ROW_NAMES) - 1)))
    check(launched == want, f"evaluate_domains launched {launched}, "
                            f"want {want}")
    pred = trainer.predict(ev, batch_size=BATCH)
    want_auc = metrics.auc(ev_y, pred)
    want_dom = metrics.per_domain_auc(ev_y, pred, ev["301"])
    want_loss = metrics.log_loss(ev_y, pred)
    errs = [abs(res["auc"] - want_auc)] + [abs(dom[v] - a)
                                            for v, a in want_dom.items()]
    check(sorted(dom) == sorted(want_dom) and max(errs) <= EVAL_AUC_TOL,
          f"evaluate_domains' AUCs {res['auc']}, {dom} against "
          f"{want_auc}, {want_dom}")
    loss_err = abs(res["binary_crossentropy"] - want_loss)
    check(loss_err <= EVAL_LOSS_TOL, f"evaluate_domains' loss "
          f"{res['binary_crossentropy']} against {want_loss}")
    print(f"evaluate_domains [{card}]: {EVAL_ROWS} examples in "
          f"{1e3 * wall:.2f} ms: AUC {res['auc']:.6f}, by domain "
          + ", ".join(f"{v} {a:.6f}" for v, a in dom.items())
          + f"; against the host metrics on predict()'s scores: AUCs within "
          f"{max(errs):.2e}, loss within {loss_err:.2e}; launches "
          f"{launched['meta_block_fwd']} K1-fwd, nothing else", flush=True)
    return launched


def raw_workflow_check(card):
    """``bench.raw_e2e.run`` on the card: the raw CSVs (80,000 + 20,000
    rows) through the port's preprocessing and CLI; the overall and three
    per-domain AUCs within the golden's tolerance of RAWE2E_r05.json, and
    the CLI's K1 launches exactly its steps' and its predict batches'."""
    import tempfile

    from satrans_torch.bench import raw_e2e
    from satrans_torch.data import io
    with tempfile.TemporaryDirectory() as td:
        zero_counts()
        res = raw_e2e.run(td, device="cuda")
    res.update(raw_e2e.against_golden(res))
    steps = -(-raw_e2e.N_TRAIN // 1024)
    want = dict(zip(K1_NAMES + ROW_NAMES, (
        -(-raw_e2e.N_TEST // 4096), steps, 0, steps)
        + (0,) * (len(K1_NAMES) + len(ROW_NAMES) - 4)))
    launched = path_counts()
    check(launched == want, f"raw workflow launched {launched}, want "
                            f"{want}")
    check(res["within"], f"raw workflow AUCs off the golden: {res}")
    print(f"raw workflow [{card}]: h5 through "
          f"{'h5py' if io._h5py() else 'the port HDF5 writer (no h5py)'}; "
          f"AUC {res['overall_auc']}, by domain {res['per_domain_auc']} "
          f"against {res['golden_auc']} (the largest gap "
          f"{res['max_auc_gap']:.4f}, tolerance {res['tolerance']}); test "
          f"loss {res['test_loss']}; preprocessing {res['preprocess_s']:.2f}"
          f"s, the CLI (load, {steps} steps, predict, report) "
          f"{res['cli_s']:.2f}s; launches {launched}", flush=True)
    return launched, res


def pipeline_phase(dev, card):
    """Phase 21: the native batcher, ``fit_from_iterator``, the other
    optimizers, ``ModelCheckpoint``, ``evaluate_domains`` and the raw
    workflow.  Returns the launches by path and kernel."""
    t0 = time.perf_counter()
    x, y = training_data()
    native_ms = native_check(card, x)
    paths, rates = iterator_check(dev, card, x, y)
    paths.update(optimizer_check(dev, card, x, y))
    trainer = checkpoint_check(dev, card, x, y)
    paths["pipeline_evaluate_domains"] = evaluate_domains_check(card, trainer)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    paths["raw_e2e"], raw = raw_workflow_check(card)
    print(f"phase 21 [{card}]: {time.perf_counter() - t0:.2f}s; "
          + json.dumps({"native_host_ms": native_ms,
                        "examples_per_s": rates,
                        "raw_e2e_s": [raw["preprocess_s"], raw["cli_s"]]}),
          flush=True)
    return paths

# phase 22: the mesh (parallel/, a rank a process).  The arms: (name,
# bank_update, shard_embeddings, embedding_exchange, and the launches a
# step of K4 gather, K2 scatter, K3 eqgemm on each rank: the sharded banks
# read by the exchange, whose owners answer with K4, and the routed commit
# or the owners' update with K4 and K2; the replicated dense bank's rows
# read with K4)
PAR_ARMS = {"lazy_alltoall": ("lazy", True, "alltoall", (2, 1, 0)),
            "fused_eq_xla": ("fused_eq", True, "xla", (2, 1, 0)),
            "dense_replicated": ("dense", False, "xla", (1, 0, 0))}
PAR_STEPS = 3
# the exchanges' capacity factor (the JAX package's default).  A rank's
# rows for one owner may reach ``capacity_factor * ceil(N / n)``; past it
# a row is read as zeros and its update dropped (counted).  The bank's
# owners hold contiguous quarters of its rows, and at 4 ranks the last
# quarter holds 6 of AliCCP's 10 large fields: on uniform ids a rank
# sends it 2.52 times its share, so factor 2 drops rows there.  Each
# group checks the overflow at PAR_CAPACITY against the ownership rule's
# count on the host, and trains its arms at the group's factor, where
# nothing is dropped
PAR_CAPACITY = 2.0
PAR_EVAL_ROWS = 4 * BATCH
PAR_AUC_TOL = 1e-9
# a rank's state against the one-card run after PAR_STEPS steps: the ranks
# sum their gradients in another order, and where an entry's gradient is
# near 0 Adam's normalised step turns that round-off into a step of the
# other sign.  So an entry may leave PARAM_TOL, but at most PAR_FLIP_SHARE
# of a tensor's entries, and none by more than two runs' largest Adam
# moves (lr (1 - b1) / sqrt(1 - b2) = sqrt(10) lr a step, the bound of the
# rmsprop arm of phase 21)
PAR_FLIP_SHARE = 1e-2
PAR_STEP_BOUND = 2 * PAR_STEPS * TRAIN_LR * 10 ** 0.5
# (backend, ranks, arms, extras): ranks of one card over gloo, asked for
# explicitly; one rank over NCCL
PAR_GROUPS = (("nccl", 1, ("lazy_alltoall",), (), PAR_CAPACITY),
              ("gloo", 2, tuple(PAR_ARMS), ("masks",), PAR_CAPACITY),
              ("gloo", 4, tuple(PAR_ARMS), ("eval",), 3.0))
PAR_CLI_ARGV = ["--data_name", "synthetic", "--synthetic_rows", "40960",
                "--embedding_dim", "8", "--att_head_num", "2", "--mesh",
                "all", "--shard_embeddings", "True", "--bank_update", "lazy",
                "--embedding_exchange", "alltoall"]


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def parallel_trainer(dev, arm, mesh=None, capacity=PAR_CAPACITY):
    """The AliCCP sota model of ``training_model`` and its Trainer in the
    arm's mode, on ``mesh`` (None: one card), its exchanges at the
    capacity factor ``capacity``."""
    from satrans_torch.data import aliccp
    from satrans_torch.features import FeatureLayout
    from satrans_torch.models import SATrans
    from satrans_torch.train import Trainer
    mode, shard, exchange, _ = PAR_ARMS[arm]
    model = SATrans(FeatureLayout(aliccp.sota_columns(32)), ["301"], [3],
                    domain_att_layer_num=LAYERS, att_head_num=4,
                    meta_mode="QK", meta_dnn_hidden_units=UNITS2[1:],
                    dropout_rate=DROP_RATE, seed=SEED, device=dev)
    trainer = Trainer(model, mesh=mesh, shard_embeddings=shard and bool(mesh),
                      embedding_exchange=exchange if mesh else "xla",
                      exchange_capacity_factor=capacity
                      if exchange == "alltoall" else None,
                      seed=SEED, device=dev)
    trainer.compile(learning_rate=TRAIN_LR, bank_update=mode,
                    lazy_capacity_factor=capacity)
    return trainer


def parallel_data(rows):
    from satrans_torch.data import aliccp
    rng = np.random.default_rng(SEED + 22)
    x = {name: rng.integers(1, aliccp.DATA_MAX[name] + 1, rows)
         for name in aliccp.SPARSE_FEATURES}
    # labels that follow the scenario, so the AUCs are not all near 0.5
    y = (rng.random(rows) < 0.2 * x["301"]).astype(np.float32)
    return x, y


def rank_state_errors(trainer, ref) -> dict:
    """This rank's parameters, buffers and bank state against the one-card
    trainer ``ref``'s (its rows of the bank and the bank's state): the
    largest difference of each group, checked against PARAM_TOL."""
    from satrans_torch.parallel.sharding import shard_of
    emb = trainer.model.emb
    shard = getattr(emb, "shard", None)

    def mine(want, rp):
        return shard_of(want, shard, rp) if shard is not None else want

    pairs = [(k, v, mine(ref.model.state_dict()[k], emb.rp)
              if k == "emb.bank" else ref.model.state_dict()[k])
             for k, v in trainer.model.state_dict().items()]
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    rnames = dict(ref.model.named_parameters())
    for p, st in trainer.optimizer.state.items():
        for k, v in st.items():
            if v.dim():
                want = ref.optimizer.state[rnames[names[id(p)]]][k]
                pairs.append((f"adam.{names[id(p)]}.{k}", v, mine(want, emb.rp)
                              if names[id(p)] == "emb.bank" else want))
    if trainer._lazy is not None:
        for k in ("mu", "nu", "last"):
            pairs.append((f"lazy.{k}", trainer._lazy[k],
                          mine(ref._lazy[k], 1)))
    worst, share = {}, 0.0
    for k, got, want in pairs:
        group = k.split(".")[0]
        if not got.numel():
            continue
        if got.dtype.is_floating_point:
            bad = int((~torch.isclose(got, want, **PARAM_TOL)).sum())
            err = (got - want).abs().max().item()
            check(bad <= PAR_FLIP_SHARE * got.numel() and
                  err <= PAR_STEP_BOUND, f"rank state {k}: {bad} of "
                  f"{got.numel()} entries outside {PARAM_TOL} of the one-card"
                  f" run (at most {PAR_FLIP_SHARE} of them), max_abs_err "
                  f"{err:.3e} (at most {PAR_STEP_BOUND:.3e})")
            share = max(share, bad / got.numel())
        else:
            err = float((got != want).sum().item())
            check(err == 0, f"rank state {k}: {err:.0f} entries differ")
        worst[group] = max(worst.get(group, 0.0), err)
    worst["share_outside_tol"] = share
    return worst


def _timed_collectives(mesh):
    """Wrap ``mesh``'s collectives with host timers (the stream drained
    before and after each): returns the list the milliseconds go to."""
    spent = []
    for name in ("all_reduce", "all_gather", "all_to_all", "broadcast"):
        real = getattr(mesh, name)

        def timed(*a, real=real, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*a, **kw)
            torch.cuda.synchronize()
            spent.append(1e3 * (time.perf_counter() - t0))
            return out

        setattr(mesh, name, timed)
    return spent


def parallel_overflow(dev, mesh, trainer, x, y) -> dict:
    """The two exchanges (the lookup's and the routed commit's) of this
    rank's rows of the first batch at PAR_CAPACITY: each one's overflow
    against the ownership rule's count on the host (the distinct rows an
    owner gets from this rank past ``capacity_factor * ceil(N / n)``)."""
    from satrans_torch import embeddings
    from satrans_torch.parallel import bank_sharded, embedding_sharded
    emb = trainer.model.emb
    shard = emb.shard
    lo, hi = trainer._rank_rows(BATCH)
    batch, _, _ = staged_batch(trainer, {k: v[lo:hi] for k, v in x.items()},
                               y[lo:hi], hi - lo)
    flat = embeddings.bank_gather_plan(trainer.layout, batch,
                                       emb.rp).to(dev).contiguous()
    _, ov = embedding_sharded.alltoall_lookup(emb.physical(), flat, mesh,
                                              PAR_CAPACITY)
    _, _, routed = bank_sharded.route_to_owners(
        flat, torch.zeros(flat.shape[0], emb.physical().shape[1],
                          device=dev), mesh, shard.rows_per, PAR_CAPACITY)
    ids = np.unique(np.clip(flat.cpu().numpy(), 0, shard.total - 1))
    per_owner = np.bincount(ids // shard.rows_per, minlength=mesh.world)
    cap = min(len(flat), int(PAR_CAPACITY * -(-len(flat) // mesh.world)))
    want = int(np.maximum(per_owner - cap, 0).sum())
    got = ov.cpu().tolist()
    check(got[mesh.rank] == int(routed) == want,
          f"rank {mesh.rank}: overflow at factor {PAR_CAPACITY}: lookup "
          f"{got}, routed commit {int(routed)}, the rule's count {want}")
    return {"overflow": got, "per_owner": per_owner.tolist(),
            "capacity": cap}


def parallel_arm(dev, mesh, arm, x, y, capacity) -> dict:
    """One arm on this rank: PAR_STEPS steps of ``fit`` over the global
    batches (this rank's rows) at the exchanges' factor ``capacity``, its
    launches, its overflows, its state against the one-card run of the
    same mode, seed and rows, then a staged step's time, device busy time
    and time in the collectives."""
    from satrans_torch.ops import profiling
    per_step = PAR_ARMS[arm][3]
    trainer = parallel_trainer(dev, arm, mesh, capacity)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    hist = trainer.fit(x, y, batch_size=BATCH, epochs=1, verbose=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = path_counts()
    want = dict(zip(K1_NAMES + ROW_NAMES, (
        *(LAYERS * PAR_STEPS * c for c in K1_PAIR["stash"]),
        *(c * PAR_STEPS for c in per_step), 0)))
    check(launched == want, f"{arm}, rank {mesh.rank} of {mesh.world}: "
          f"{PAR_STEPS} steps launched {launched}, want {want}")
    overflow = {k: hist.history[k][0] for k in ("bank_overflow",
                                                "exchange_overflow")
                if k in hist.history}
    check(all(v == 0 for v in overflow.values()),
          f"{arm}: rows past capacity {capacity}: {overflow}")
    out = {"launches": launched, "overflow": overflow, "fit_s": wall,
           "loss": hist.history["loss"][0]}
    if PAR_ARMS[arm][2] == "alltoall":
        out["at_default_factor"] = parallel_overflow(dev, mesh, trainer, x, y)
    ref = parallel_trainer(dev, arm)
    ref.fit(x, y, batch_size=BATCH, epochs=1, verbose=0)
    out["max_abs_err"] = rank_state_errors(trainer, ref)
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    lo, hi = trainer._rank_rows(BATCH)
    batch, yb, wb = staged_batch(trainer, {k: v[lo:hi] for k, v in
                                           x.items()}, y[lo:hi], hi - lo)
    out["step_ms"] = time_ms(lambda: trainer.train_step(batch, yb, wb),
                             iters=3, warmup=1)
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train_step(batch, yb, wb)
        torch.cuda.synchronize()
    ops = profiling.device_ops(prof)
    out["busy_ms"] = sum(ms for _, ms, _ in ops) if ops else None
    out["top"] = [(name[:48], round(ms, 3), n) for name, ms, n in ops[:6]]
    spent = _timed_collectives(mesh)
    trainer.train_step(batch, yb, wb)
    torch.cuda.synchronize()
    out["exchange_ms"] = sum(spent)
    out["collectives"] = len(spent)
    for name in ("all_reduce", "all_gather", "all_to_all", "broadcast"):
        delattr(mesh, name)  # the class's own methods again
    return out, trainer


def parallel_eval(dev, mesh, trainer, tmp) -> dict:
    """``evaluate_domains`` of PAR_EVAL_ROWS on the ranks (each its
    ``[r::n]`` shard) and ``predict``, then a checkpoint written under the
    mesh and restored on one card (rank 0): its state bit for bit, its
    ``evaluate_domains`` within PAR_AUC_TOL and its scores."""
    from satrans_torch.parallel.sharding import gather_bank
    from satrans_torch.train import checkpoint
    ev, ev_y = parallel_data(PAR_EVAL_ROWS)
    r, n = mesh.rank, mesh.world
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    res, dom = trainer.evaluate_domains(
        {k: v[r::n] for k, v in ev.items()}, ev_y[r::n], "301",
        batch_size=PAR_EVAL_ROWS)
    wall = time.perf_counter() - t0
    launched = path_counts()
    pred = trainer.predict(ev, batch_size=PAR_EVAL_ROWS)
    path = os.path.join(tmp, "mesh.ckpt")
    checkpoint.save(path, trainer)
    emb = trainer.model.emb
    whole = {k: v.detach().clone() for k, v in
             trainer.model.state_dict().items()}
    whole["emb.bank"] = gather_bank(whole["emb.bank"], emb.shard, emb.rp)
    lazy = {k: gather_bank(trainer._lazy[k], emb.shard, emb.rp)
            for k in ("mu", "nu", "last")}
    out = {"eval_ms": 1e3 * wall, "auc": res["auc"], "domains": dom,
           "launches": launched}
    if r == 0:
        one = parallel_trainer(dev, "lazy_alltoall")
        checkpoint.restore(path, one)
        same = all(torch.equal(v, one.model.state_dict()[k])
                   for k, v in whole.items()) and all(
            torch.equal(v, one._lazy[k]) for k, v in lazy.items()) and \
            one._lazy["count"] == trainer._lazy["count"]
        check(same, "the checkpoint written under the mesh restores on one "
                    "card with another state")
        res1, dom1 = one.evaluate_domains(ev, ev_y, "301", batch_size=BATCH)
        errs = [abs(res["auc"] - res1["auc"])] + [
            abs(dom[v] - a) for v, a in dom1.items()]
        check(sorted(dom) == sorted(dom1) and max(errs) <= PAR_AUC_TOL,
              f"evaluate_domains on {n} ranks: {res['auc']}, {dom}; on one "
              f"card {res1['auc']}, {dom1}")
        pred1 = one.predict(ev, batch_size=BATCH)
        out.update(auc_err=max(errs), score_err=float(
            np.abs(pred - pred1).max()), checkpoint_bits_equal=same,
            checkpoint_mib=os.path.getsize(path) / 2 ** 20)
        del one
    mesh.barrier()
    return out


def parallel_masks(dev, mesh) -> dict:
    """The seeds and tiles of the K1 launches of one training step on this
    rank's rows, all-gathered; rank 0 also takes one step of the one-card
    run with the same key and compares the masks of both launches' seeds
    and tiles (``ops/prng.dropout_masks``, the kernels' rule) bit for
    bit."""
    from satrans_torch.ops import meta_block, prng, threefry
    x, y = parallel_data(BATCH)
    calls = []
    real = meta_block.fused_meta_layer

    def record(xx, *a, **kw):
        calls.append((int(kw["seed"]), int(kw["block_b"]), xx.shape[0]))
        return real(xx, *a, **kw)

    meta_block.fused_meta_layer = record
    key = threefry.PRNGKey(SEED + 5)
    trainer = parallel_trainer(dev, "dense_replicated", mesh)
    lo, hi = trainer._rank_rows(BATCH)
    batch, yb, wb = staged_batch(trainer, {k: v[lo:hi] for k, v in
                                           x.items()}, y[lo:hi], hi - lo)
    trainer.train_step(batch, yb, wb, key)
    mine = torch.tensor(calls, dtype=torch.int64, device=dev)
    every = mesh.all_gather(mine.view(1, *mine.shape)).cpu().tolist()
    del trainer
    out = {"launch_seeds": every}
    if mesh.rank == 0:
        calls.clear()
        one = parallel_trainer(dev, "dense_replicated")
        batch, yb, wb = staged_batch(one, x, y, BATCH)
        one.train_step(batch, yb, wb, key)
        compared = 0
        F = len(one.layout.sparse)
        for li, (seed, blk, rows) in enumerate(calls):
            want = prng.dropout_masks(seed, rows, F, 32, 4, blk, DROP_RATE,
                                      True, True, dev)
            parts = [prng.dropout_masks(rank[li][0], rank[li][2], F, 32, 4,
                                        rank[li][1], DROP_RATE, True, True,
                                        dev) for rank in every]
            for j, w in enumerate(want):
                if w is None:
                    continue
                got = torch.cat([p[j] for p in parts])
                check(torch.equal(got, w), f"layer {li}: the {mesh.world} "
                      f"ranks' K1 masks differ from one card's (mask {j})")
                compared += w.numel()
        out.update(compared=compared, one_card=calls[:])
        del one
    meta_block.fused_meta_layer = real
    mesh.barrier()
    return out


def parallel_rank(rank, world, port, backend, arms, extras, capacity,
                  out_dir):
    """One rank of a phase-22 group (``torch.multiprocessing`` spawn):
    each arm of ``arms``, then the extras; the results as JSON."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from satrans_torch.parallel import distributed, make_mesh
    distributed.initialize(f"127.0.0.1:{port}", world, rank, backend=backend,
                           timeout_s=300)
    mesh = make_mesh("cuda")
    dev = mesh.device
    x, y = parallel_data(PAR_STEPS * BATCH)
    res = {"rank": rank, "device": str(dev), "arms": {}}
    for arm in arms:
        res["arms"][arm], trainer = parallel_arm(dev, mesh, arm, x, y,
                                                 capacity)
        if arm == "lazy_alltoall" and "eval" in extras:
            res["eval"] = parallel_eval(dev, mesh, trainer, out_dir)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    if "masks" in extras:
        res["masks"] = parallel_masks(dev, mesh)
    with open(os.path.join(out_dir, f"{backend}{world}_r{rank}.json"),
              "w") as f:
        json.dump(res, f)
    distributed.shutdown()


def parallel_cli(card) -> dict:
    """``cli.main`` on two ranks sharing the card over gloo
    (``SATRANS_DIST_BACKEND=gloo``), each a process: both print the same
    AUC lines.  Returns the launches of rank 0's run."""
    import tempfile
    port = _free_port()
    env = dict(os.environ, SATRANS_DIST_BACKEND="gloo",
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "satrans_torch.cli.main", *PAR_CLI_ARGV,
             "--coordinator_address", f"127.0.0.1:{port}",
             "--num_processes", "2", "--process_id", str(r),
             "--results_dir", os.path.join(tmp, f"cli{r}"),
             "--checkpoint_dir", os.path.join(tmp, f"cli{r}", "ck")],
            env=env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for r in range(2)]
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=300)[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
    wall = time.perf_counter() - t0
    for r, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"the CLI's rank {r} failed:\n{out[-4000:]}")
    lines = [[ln for ln in out.splitlines() if "AUC" in ln] for out in outs]
    check(bool(lines[0]) and lines[0] == lines[1],
          f"the CLI's ranks print other AUC lines: {lines}")
    print(f"phase 22 CLI [{card}]: 2 ranks over gloo on one card, "
          f"{' '.join(PAR_CLI_ARGV)}: {wall:.2f}s, both ranks print "
          f"{lines[0]}", flush=True)
    return {"lines": lines[0], "s": wall}


def parallel_phase(dev, card):
    """Phase 22: the port on the mesh, a rank a process.  One rank over
    NCCL, and 2 and 4 ranks sharing the card over gloo (asked for), each
    arm PAR_STEPS steps of the AliCCP sota model at a global batch of
    BATCH against the one-card run; ``evaluate_domains`` on 4 ranks, a
    checkpoint from 4 ranks onto one card, the 2 ranks' dropout masks, the
    CLI on 2 ranks, and NCCL across cards where there are two.  Returns
    the launches by path (each arm's, summed over its ranks)."""
    import tempfile
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    groups = list(PAR_GROUPS)
    cards = torch.cuda.device_count()
    if cards >= 2:
        groups.append(("nccl", 2, ("lazy_alltoall",), (), PAR_CAPACITY))
    else:
        print(f"phase 22 [{card}]: {cards} card: NCCL across cards not run",
              flush=True)
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        for backend, world, arms, extras, capacity in groups:
            g0 = time.perf_counter()
            mp.spawn(parallel_rank, args=(world, _free_port(), backend, arms,
                                          extras, capacity, tmp),
                     nprocs=world)
            ranks = []
            for r in range(world):
                with open(os.path.join(tmp, f"{backend}{world}_r{r}.json")) \
                        as f:
                    ranks.append(json.load(f))
            for arm in arms:
                per = [rk["arms"][arm] for rk in ranks]
                paths[f"parallel_{backend}{world}_{arm}"] = {
                    k: sum(p["launches"][k] for p in per)
                    for k in per[0]["launches"]}
                worst = {}
                for p in per:
                    for k, v in p["max_abs_err"].items():
                        worst[k] = max(worst.get(k, 0.0), v)
                if "at_default_factor" in per[0]:
                    print(f"phase 22 {backend} x{world} {arm} [{card}]: "
                          f"at factor {PAR_CAPACITY} (capacity "
                          f"{per[0]['at_default_factor']['capacity']} rows "
                          f"an owner) the ranks' distinct rows by owner "
                          f"{[p['at_default_factor']['per_owner'] for p in per]}"
                          f", overflow by rank "
                          f"{per[0]['at_default_factor']['overflow']}, each "
                          f"the ownership rule's count in both exchanges",
                          flush=True)
                print(f"phase 22 {backend} x{world} {arm} [{card}]: "
                      f"{PAR_STEPS} steps of {BATCH} ({BATCH // world} a "
                      f"rank) at factor {capacity}; launches a step a rank "
                      f"{ {k: v // PAR_STEPS for k, v in per[0]['launches'].items() if v} }; "
                      f"overflow {per[0]['overflow']}; state against one "
                      f"card within {PARAM_TOL}, max_abs_err {worst}; "
                      f"loss {per[0]['loss']:.6f}; a rank's staged step "
                      f"(ranks sharing the card: not a scaling number) "
                      f"{[round(p['step_ms'], 3) for p in per]} ms, device "
                      f"busy {[p['busy_ms'] for p in per]} ms, in the "
                      f"collectives {[round(p['exchange_ms'], 3) for p in per]}"
                      f" ms ({per[0]['collectives']} calls, drained); rank "
                      f"0's top device ops {per[0]['top']}", flush=True)
            if "eval" in extras:
                ev = ranks[0]["eval"]
                paths[f"parallel_{backend}{world}_evaluate"] = {
                    k: sum(rk["eval"]["launches"][k] for rk in ranks)
                    for k in ev["launches"]}
                print(f"phase 22 evaluate_domains x{world} [{card}]: "
                      f"{PAR_EVAL_ROWS} examples, {ev['eval_ms']:.2f} ms, "
                      f"AUC {ev['auc']:.6f}, by domain {ev['domains']}; one "
                      f"card's within {ev['auc_err']:.3e}, scores within "
                      f"{ev['score_err']:.3e}; checkpoint of "
                      f"{ev['checkpoint_mib']:.1f} MiB from {world} ranks "
                      f"restored on one card bit for bit", flush=True)
            if "masks" in extras:
                m = ranks[0]["masks"]
                print(f"phase 22 masks x{world} [{card}]: K1 launches' "
                      f"(seed, block_b, rows) by rank {m['launch_seeds']}, "
                      f"one card {m['one_card']}; {m['compared']} mask "
                      "entries bit for bit", flush=True)
            print(f"phase 22 group {backend} x{world}: "
                  f"{time.perf_counter() - g0:.2f}s", flush=True)
    parallel_cli(card)
    print(f"phase 22 [{card}]: {time.perf_counter() - t0:.2f}s", flush=True)
    return paths


# phase 23: the serving path as CUDA graphs.  A request of GRAPH_REQUEST
# batches and a half (a padded tail); the pipeline depths each arm serves
# it at
GRAPH_REQUEST = 3.5
GRAPH_DEPTHS = (1, 2, 4)
EVAL_BATCH = 32768  # the reference's eval batch (main.py:353)


def graph_families():
    """Phase 23's families: (label, build(dev) -> (model, the same model on
    the plain route or None), the batch sizes, the data's maker, the
    launches of one captured batch).  The SATrans families draw their
    embeddings N(0, 1) (no_emb_init), the others' parameters are redrawn
    N(0, ZOO_FWD_STD) before the capture (:func:`graph_case`)."""
    def satrans(**kw):
        def build(dev):
            from satrans_torch.data import aliccp
            from satrans_torch.features import FeatureLayout
            from satrans_torch.models import SATrans
            args = dict(domain_att_layer_num=LAYERS, att_head_num=4,
                        meta_mode="QK", no_emb_init=True, seed=SEED,
                        device=dev, **kw)
            layout = FeatureLayout(aliccp.sota_columns(32))
            model = SATrans(layout, ["301"], [3], **args)
            plain = SATrans(layout, ["301"], [3], route="plain", **args)
            plain.load_state_dict(model.state_dict())
            return model, plain
        return build

    def twin(fn):
        def build(dev):
            model = fn(dev, no_emb_init=True)
            plain = fn(dev, no_emb_init=True, route="plain")
            plain.load_state_dict(model.state_dict())
            return model, plain
        return build

    def alone(fn):
        return lambda dev: (fn(dev), None)

    aliccp_ids = lambda rows: training_data_rows(rows)          # noqa: E731
    alimama_ids = lambda rows: alimama_data(rows, SEED + 23)[0]  # noqa: E731
    k1, k6, k7 = ({"meta_block_fwd": LAYERS}, {"gate_block_fwd": LAYERS},
                  {"tiled_meta_fwd": LAYERS})
    return (
        ("aliccp_metanet", satrans(meta_dnn_hidden_units=(64, 32)),
         (EVAL_BATCH, BATCH), aliccp_ids, k1),
        ("aliccp_gate", satrans(variant="gate"), (BATCH,), aliccp_ids, k6),
        ("aliccp_bilinear", satrans(variant="bilinear"), (BATCH,),
         aliccp_ids, k6),
        ("alimama_pos", twin(alimama_model), (BATCH,), alimama_ids, k1),
        ("multicol_301_122", twin(multicol_model), (BATCH,), aliccp_ids,
         k7),
        ("aliccp_metanet_3mat", satrans(meta_dnn_hidden_units=UNITS3[1:]),
         (BATCH,), aliccp_ids, k1),
        ("DeepFM", alone(lambda dev: zoo_model(dev, "DeepFM")), (BATCH,),
         aliccp_ids, {}),
        ("MMOE", alone(lambda dev: zoo_model(dev, "MMOE")), (BATCH,),
         aliccp_ids, {}),
        ("Star_Trans", alone(lambda dev: cli_model(
            dev, ["--model_name", "Star_Trans"])), (BATCH,), aliccp_ids, {}),
        ("per_example_301_122_125", alone(lambda dev: cli_model(
            dev, ["--flag", "None"], cols=PER_EXAMPLE_COLS)), (BATCH,),
         aliccp_ids, {}),
    )


def training_data_rows(rows):
    """AliCCP ids uniform in [1, DATA_MAX] for ``rows`` examples."""
    from satrans_torch.data import aliccp
    rng = np.random.default_rng(SEED + 23)
    return {name: rng.integers(1, aliccp.DATA_MAX[name] + 1, rows)
            for name in aliccp.SPARSE_FEATURES}


def graph_case(dev, card, label, model, plain, batch, x, want):
    """One family at one batch size: ``Predictor.aot_compile`` (the
    captured launches of a batch must be ``want``), the request at every
    depth through the graph and through the eager Predictor (every score
    equal bit for bit), the scores against the plain route's (SERVING_TOL)
    or, for a model without a layer kernel, against a CPU copy on its
    first ZOO_FWD_ROWS rows (ZOO_FWD_TOL); the replay's CUDA-event ms, each
    arm's examples/s a depth, the card's busy share of a request, the
    capture's seconds.  Returns the graph's launches on the path (replays
    times the captured launches) and the numbers."""
    from satrans_torch.ops import launch_counts
    from satrans_torch.serving import Predictor
    rows = len(next(iter(x.values())))
    batches = -(-rows // batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = Predictor(model, batch_size=batch, device=dev).aot_compile()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    check(pred.captured_launches == want,
          f"{label} b{batch}: the capture launched {pred.captured_launches}"
          f", want {want}")
    replay_ms = time_ms(pred.graph.replay, iters=20)
    eager = Predictor(model, batch_size=batch, device=dev).warmup()

    scores, rate = {}, {}
    for arm, p in (("graph", pred), ("eager", eager)):
        zero_counts()
        if arm == "graph":
            pred.graph.replays = 0
        calls = 0
        for depth in GRAPH_DEPTHS:
            p(x, pipeline_depth=depth)  # the ring's first use
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scores[arm, depth] = p(x, pipeline_depth=depth)
            rate[arm, depth] = rows / (time.perf_counter() - t0)
            calls += 2
        counted = {k: n for k, n in launch_counts().items() if n}
        if arm == "graph":
            launched = pred.launches()
            check(pred.graph.replays == calls * batches and not counted,
                  f"{label} b{batch}: {pred.graph.replays} replays, want "
                  f"{calls * batches}; counters moved under replay: "
                  f"{counted}")
        else:
            check(counted == {k: n * calls * batches
                              for k, n in want.items()},
                  f"{label} b{batch}: the eager Predictor launched "
                  f"{counted}")
    ref = scores["graph", 1]
    check(ref.shape == (rows,) and bool(np.isfinite(ref).all()),
          f"{label} b{batch}: scores of shape {ref.shape}, not finite")
    for (arm, depth), s in scores.items():
        check(np.array_equal(s, ref), f"{label} b{batch}: the {arm} "
              f"Predictor at depth {depth} differs from the graph at depth "
              f"1 by {float(np.abs(s - ref).max())}")
    if plain is not None:
        want_s = Predictor(plain, batch_size=batch, device=dev)(x)
        err, tol = float(np.abs(ref - want_s).max()), SERVING_TOL
    else:
        head = {k: v[:ZOO_FWD_ROWS] for k, v in x.items()}
        host = copy.deepcopy(model).cpu()
        want_s = Predictor(host, batch_size=ZOO_FWD_ROWS, device="cpu")(head)
        err, tol = float(np.abs(ref[:ZOO_FWD_ROWS] - want_s).max()), \
            ZOO_FWD_TOL
        del host
    check(err <= tol, f"{label} b{batch}: the graph's scores differ from "
                      f"the plain version's by {err} > {tol}")
    wall_ms = 1e3 * rows / rate["graph", 1]
    busy = device_profile(f"phase 23 {label} b{batch}: a request of {rows} "
                          "through the graph", lambda: pred(x), wall_ms,
                          card, top=4)
    out = dict(replay_ms=replay_ms, capture_s=capture_s, max_abs_err=err,
               busy_share=None if busy is None else busy / wall_ms,
               examples_per_s={f"{arm}_depth{d}": r
                               for (arm, d), r in rate.items()},
               captured=pred.captured_launches)
    print(f"phase 23 {label} b{batch} [{card}]: {rows} rows, {batches} "
          f"batches; " + json.dumps(out) + f"; launches {launched}",
          flush=True)
    del pred, eager
    return launched, out


def graph_instruments(dev, card):
    """Phase 23's three instruments, each run once in-process (one JSON
    line each).  Returns their launches by path: the AOT Predictor's graph
    (serving_throughput; its scores equal to the eager Predictor's bit
    for bit), the probe's fused graph (probe_throughput; each arm's graph
    equal to its eager forward bit for bit, the fused predictions and
    (layer, head) means against the plain layer's within SERVING_TOL and
    PROBE_STATS_TOL) and K1-fwd's graph (bench_kernels; its output against
    the plain layer's within KERNEL_TOL)."""
    from satrans_torch.bench import kernels, probe_throughput, \
        serving_throughput
    serve = serving_throughput.main([])
    check(serve["launches"] == {"meta_block_fwd": serve["launches"].get(
        "meta_block_fwd", 0)} and serve["launches"]["meta_block_fwd"] > 0,
          f"serving_throughput launched {serve['launches']}")
    probe = probe_throughput.main([])
    arms = probe["results"]
    fused = arms["fused_scores"]["launches"]
    check(set(fused) == {"meta_block_fwd_scores"}
          and not arms["xla_scores"]["launches"],
          f"probe_throughput launched {fused} (fused) and "
          f"{arms['xla_scores']['launches']} (plain)")
    check(all(a["graph_equals_eager"] for a in arms.values()),
          "probe_throughput: a graph's output differs from its eager "
          "forward's")
    pred_diff = arms["fused_scores"]["pred_max_abs_diff"]
    stat_diff = arms["fused_scores"]["stats_max_abs_diff"]
    check(pred_diff <= SERVING_TOL and stat_diff <= PROBE_STATS_TOL,
          f"probe_throughput: the fused graph's predictions differ from the "
          f"plain layer's by {pred_diff}, its means by {stat_diff} "
          f"(tolerances {SERVING_TOL}, {PROBE_STATS_TOL})")
    check(kernels.FUSED_TOL == KERNEL_TOL, "bench/kernels.py's FUSED_TOL "
          "is not KERNEL_TOL")
    bench = kernels.main([])
    attn = bench["interaction_attention_fused"]
    check(attn["launches"] > 0, "bench/kernels.py launched no K1-fwd")
    check(attn["within_tol"], f"bench/kernels.py: K1-fwd's graph differs "
          f"from the plain layer by {attn['max_abs_err']} (KERNEL_TOL)")
    print(f"phase 23 instruments [{card}]: the probe's fused graph within "
          f"{pred_diff:.3e} (predictions) and {stat_diff:.3e} (means) of "
          f"the plain layer; bench/kernels.py's K1-fwd graph within "
          f"{attn['max_abs_err']:.3e} of it", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"serving_throughput": serve["launches"],
            "probe_throughput": fused, "bench_kernels": {
                "meta_block_fwd": attn["launches"]}}


def serving_graph_phase(dev, card):
    """Phase 23: every family the Predictor serves, captured by
    ``aot_compile`` and checked (:func:`graph_case`), then the three
    instruments.  Returns the launches by path and kernel."""
    t0 = time.perf_counter()
    paths, numbers = {}, {}
    for label, build, batches, data, want in graph_families():
        model, plain = build(dev)
        if plain is None:  # no layer kernel: parameters that move the
            gen = torch.Generator(device=dev)  # scores
            gen.manual_seed(SEED)
            with torch.no_grad():
                for p in model.parameters():
                    p.normal_(0.0, ZOO_FWD_STD, generator=gen)
        for batch in batches:
            x = data(int(GRAPH_REQUEST * batch))
            key = f"graph_{label}_b{batch}"
            launched, numbers[key] = graph_case(dev, card, label, model,
                                                plain, batch, x, want)
            # the 3-matrix instances under their own names (phase 13's)
            paths[key] = {K1_NAMES3[k] if label.endswith("_3mat") else k: n
                          for k, n in launched.items()}
        del model, plain
        gc.collect()
        torch.cuda.empty_cache()
    paths.update(graph_instruments(dev, card))
    for name in ("meta_block_fwd", "meta_block_fwd_scores",
                 "gate_block_fwd", "tiled_meta_fwd"):
        check(sum(n.get(name, 0) for n in paths.values()) > 0,
              f"phase 23: {name} was launched on no path")
    print(f"phase 23 [{card}]: {time.perf_counter() - t0:.2f}s; "
          + json.dumps(numbers), flush=True)
    return paths


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
    targets = _build.default_targets() + width_targets()
    built = _build.build(targets)
    print(f"build: {len(built)} libraries, one nvcc a core, "
          f"{json.dumps({k: round(v, 2) for k, v in built.items()})} in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    for name, shape in targets:
        body = ""
        for ln in _build.log(name, shape).splitlines():
            if "Function properties for" in ln:
                # the template arguments of the mangled name: the layer
                # kernels' (d, h1, h2, heads), mode and TILED
                body = " ".join(re.findall(r"L[ib](\d+)E", ln.split()[-1]))
            elif "registers" in ln or "spill" in ln:
                print(f"build {_build.label(name, shape)} [{body}]: "
                      f"{ln.strip()}")

    tile = tile_body_report()
    k = kernel_phase(dev)
    served = serving_phase(dev, card)
    kb = backward_phase(dev)
    trained = training_phase(dev, card)
    rows = bank_kernel_phase(dev, card)
    sparse = sparse_training_phase(dev, card)
    kg = gate_kernel_phase(dev)
    gpaths = gate_paths_phase(dev, card)
    kp, gate_err = pos_kernel_phase(dev)
    ppaths = pos_paths_phase(dev, card)
    kt = tiled_kernel_phase(dev)
    mpaths = multicol_paths_phase(dev, card)
    ks, scores_paths, cli_paths = probes_and_cli_phase(dev, card)
    k3, paths3 = metanet3_phase(dev, card)
    kdma, dma_launched = row_dma_phase(dev, card)
    bench = bench_phase(card)
    zoo = zoo_phase(dev, card)
    star_mtl = star_mtl_phase(dev, card)
    widths, wpaths = widths_phase(dev, card, built)
    many, many_paths = many_rows_phase(dev, card)
    legacy = legacy_phase(dev, card)
    pipeline = pipeline_phase(dev, card)
    parallel = parallel_phase(dev, card)
    graphs = serving_graph_phase(dev, card)

    # launches, each path counted from 0 just before it: serving and the
    # evaluation run K1-fwd only; the dense recompute arm K1-fwd and
    # K1-bwd; the dense stash arm and every sparse arm K1-stash and
    # K1-bwd-stash; the Alimama pos arms their stash's pair
    paths = {"serving": {"meta_block_fwd": served},
             **{p: dict(zip(K1_NAMES, n)) for p, n in (
                 ("train_stash", trained["stash"]),
                 ("train_recompute", trained["recompute"]),
                 ("evaluate", trained["eval"]))},
             **sparse, **ppaths, **cli_paths, "bench": bench}
    kernels = []
    for name, source, replaces, fields in (
            ("meta_block_fwd", "meta_block_fwd.cu", "404", k["fwd"]),
            ("meta_block_fwd_stash", "meta_block_fwd.cu", "420 (stash_s="
             "True)", k["stash"]),
            ("meta_block_fwd_stash_light", "meta_block_fwd.cu", "420 "
             "(stash_s=False, :1196-1200)", k["light"]),
            ("meta_block_bwd", "meta_block_bwd.cu", "685", kb["recompute"]),
            ("meta_block_bwd_stash", "meta_block_bwd.cu", "902 (stash_s="
             "True)", kb["stash"]),
            ("meta_block_bwd_stash_light", "meta_block_bwd.cu", "902 "
             "(stash_s=False, :1232)", dict(
                 max_abs_err=kb["stash_light"]["max_abs_err"],
                 aliccp_ms=kb["stash_light"]["ms"]))):
        by_path = {p: n[name] for p, n in paths.items() if n.get(name)}
        # the AliCCP phases' fields and the Alimama phase's, the worst
        # error of both
        merged = {**fields, **kp[name], "max_abs_err": max(
            fields["max_abs_err"], kp[name]["max_abs_err"])}
        kernels.append(dict(
            name=name, route="cuda", source=TILE_SOURCES.get(
                name, f"satrans_torch/csrc/{source}"),
            replaces=f"satrans_tpu/ops/pallas/meta_block.py:{replaces}",
            launches=sum(by_path.values()), launches_by_path=by_path,
            library_ms=None, **merged, **tile.get(name, {})))
    # K1-scores runs on the probe paths of phase 12 and in the CLI
    kernels.append(dict(
        name="meta_block_fwd_scores", route="cuda",
        source=TILE_SOURCES["meta_block_fwd_scores"],
        replaces="satrans_tpu/ops/pallas/meta_block.py:502 "
                 "(fused_meta_layer_with_scores; _fwd_call :1177, "
                 "pallas_call :1212, _fwd_kernel_stash :420)",
        launches=sum(scores_paths.values()), launches_by_path=scores_paths,
        library_ms=None, **ks, **tile["meta_block_fwd_scores"]))
    # the row kernels run on the sparse training paths (phase 7 arms, the
    # phase 9 and 10 lazy arms, the bench, the zoo of phase 16 and STAR
    # and the multi-task models of phase 17)
    for name, source, replaces in (
            ("gather_rows", "bank_rows.cu", "gather.py:86"),
            ("scatter_rows_set", "bank_rows.cu", "scatter.py:139"),
            ("eqgemm_positions", "eqgemm.cu", "eqgemm.py:90"),
            ("lazy_adam_rows", "bank_rows.cu", "lazy_tail.py:174")):
        by_path = {arm: n[name] for arm, n in (*sparse.items(),
                                                *gpaths.items(),
                                                *ppaths.items(),
                                                *mpaths.items(),
                                                ("bench", bench),
                                                *zoo.items(),
                                                *star_mtl.items())
                   if n.get(name)}
        kernels.append(dict(name=name, route="cuda",
                            source=f"satrans_torch/csrc/{source}",
                            replaces=f"satrans_tpu/ops/pallas/{replaces}",
                            launches=sum(by_path.values()),
                            launches_by_path=by_path, **rows[name]))
    # K6 runs on the gate and bilinear paths of phase 9 (and is held with
    # distinct Q and K gates in phase 10a)
    for (name, replaces, fields), err in zip((
            ("gate_block_fwd", "gate_block.py:287 (_sfwd_kernel :96)",
             kg["fwd"]),
            ("gate_block_bwd", "gate_block.py:318 (_sbwd_kernel :131)",
             kg["bwd"])), gate_err):
        fields = dict(fields, max_abs_err=max(fields["max_abs_err"], err))
        by_path = {p: n[name] for p, n in gpaths.items() if n.get(name)}
        body = dict(tile.get(name, {}))
        if name in tile:
            body["bilinear_body"] = tile[name + "_bilinear"]
        kernels.append(dict(
            name=name, route="cuda",
            source=f"satrans_torch/csrc/{name}.cu",
            replaces=f"satrans_tpu/ops/pallas/{replaces}",
            launches=sum(by_path.values()), launches_by_path=by_path,
            library_ms=None, **fields, **body))
    # K7 runs on the multicol paths of phase 11
    for name, replaces in zip(K7_NAMES, (
            "141 (_fwd_kernel; _fwd_call :521, pallas_call :546)",
            "155 (_fwd_kernel_stash; _fwd_call :521, pallas_call :546)",
            "178 (_bwd_kernel; _bwd_call :562, pallas_call :634)",
            "341 (_bwd_kernel_stash; _bwd_call :562, pallas_call :634)")):
        by_path = {p: n[name] for p, n in mpaths.items() if n.get(name)}
        kernels.append(dict(
            name=name, route="cuda", source=TILE_SOURCES.get(
                name, "satrans_torch/csrc/meta_block_fwd.cu"),
            replaces=f"satrans_tpu/ops/pallas/tiled_meta.py:{replaces}",
            launches=sum(by_path.values()), launches_by_path=by_path,
            library_ms=None, **kt[name], **tile.get(name, {})))
    # the 3-matrix instances of K1 and K7 (phase 13), launched on phase
    # 13's paths only
    replaces = {k["name"]: k["replaces"] for k in kernels}
    for base, name in (*K1_NAMES3.items(), *K7_NAMES3.items()):
        by_path = {p: n[base] for p, n in paths3.items() if n.get(base)}
        source = "meta_block_bwd.cu" if "bwd" in base else \
            "meta_block_fwd.cu"
        middle = ("; 3-matrix: _tile_meta :55-89" if base in K7_NAMES3 else
                  "; 3-matrix: _meta_apply :158-195, _meta_bwd :869-899")
        kernels.append(dict(
            name=name, route="cuda", source=TILE_SOURCES.get(
                base, f"satrans_torch/csrc/{source}"),
            replaces=replaces[base] + middle, meta_units=list(UNITS3),
            launches=sum(by_path.values()), launches_by_path=by_path,
            library_ms=None, **k3[base], **tile.get(name, {})))
    # P1 and P2 run on the probes' paths (phase 14)
    for name, module, replaces in ROW_DMA:
        kernels.append(dict(
            name=name, route="cuda", source="satrans_torch/csrc/row_dma.cu",
            replaces=replaces, launches=dma_launched[name],
            launches_by_path={module: dma_launched[name]}, **kdma[name]))
    # phase 18: each kernel's launches on the paths at the other widths and
    # head counts, and each layer kernel's fields by shape
    for k in kernels:
        by_path = {p: n[k["name"]] for p, n in wpaths.items()
                   if n.get(k["name"])}
        k["launches_by_path"].update(by_path)
        k["launches"] += sum(by_path.values())
        if k["name"] in widths:
            k["widths"] = widths[k["name"]]
    # phase 19: each kernel's launches on the many-row paths; the changed
    # kernels' errors and times at many rows (K1's backwards also their
    # sorted walk's body and its scratch at the JAX cap), and the unchanged
    # forwards' errors there
    for k in kernels:
        name = k["name"]
        by_path = {p: n[name] for p, n in many_paths.items() if n.get(name)}
        k["launches_by_path"].update(by_path)
        k["launches"] += sum(by_path.values())
        if name in many["errors"]:
            k["many_rows"] = dict(max_abs_err=many["errors"][name],
                                  cases=many["times"].get(name, {}))
            k["max_abs_err"] = max(k["max_abs_err"], many["errors"][name])
        if name + "_sorted" in tile:
            k["sorted_body"] = tile[name + "_sorted"]
            k["many_rows"]["sorted_scratch_at_cap"] = many["scratch"]
    # phase 20: K2-K5's launches on the legacy and per-example paths;
    # phase 21: K1's and K2-K4's on the pipeline's paths; phase 22: K1's
    # and K2-K4's on the mesh's paths, summed over each arm's ranks; phase
    # 23: K1-fwd's, K1-scores', K6-fwd's and K7-fwd's on the graphs' paths
    # (replays times the captured launches)
    for k in kernels:
        by_path = {p: n[k["name"]] for p, n in (*legacy.items(),
                                                *pipeline.items(),
                                                *parallel.items(),
                                                *graphs.items())
                   if n.get(k["name"])}
        k["launches_by_path"].update(by_path)
        k["launches"] += sum(by_path.values())
    check(all(k["launches"] > 0 for k in kernels),
          "a kernel was launched on no path")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
