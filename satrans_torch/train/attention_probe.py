"""Attention inspection probes (twin of
``satrans_tpu/train/attention_probe.py``).

Reimplements the reference's ``showattn`` / ``instattn`` instrumentation
(meta_basemodel.py:421-517) on the model's ``forward(...,
return_scores=True)`` (K1-scores on the card for the metanet variant,
``models/satrans.py``):

* ``showattn``: during prediction, accumulate each layer's attention maps
  into per-(layer, domain, label-class) means - the paper's attention
  visualizations.  The (layer, domain, class) sums and the predictions
  accumulate on the device and reach the host once, at the end; no
  batch's ``[B, H, F, F]`` maps are copied to the host.
* ``instattn``: dump per-instance (field_i, field_j, score) triples whose
  attention exceeds a threshold to ``inst_attn_{domain}.txt``
  (meta_basemodel.py:460-499), or the reference's byte format for the
  Alimama sparseprice run.

Every batch is padded to ``batch_size`` as in the JAX package, including
the 1,000 instances of :func:`dump_instance_attention` (one padded batch).
"""

from __future__ import annotations

import bisect
import os

import numpy as np
import torch


def _scores_step(trainer, batch):
    """``(pred [B], [scores [B, H, F, F] per layer])`` of one padded batch
    (numpy arrays, or tensors already on the device) in eval mode, without
    autograd, on the trainer's device."""
    if not isinstance(next(iter(batch.values())), torch.Tensor):
        batch = trainer._device_batch(batch)
    trainer.model.eval()
    with torch.inference_mode():
        return trainer.model(batch, return_scores=True)


def _padded(trainer, data: dict, start: int, end: int, batch_size: int):
    return {k: trainer._pad(v[start:end], batch_size)
            for k, v in data.items()}


def predict_with_attention(trainer, x: dict, y, *, batch_size: int = 4096,
                           num_domains: int | None = None):
    """Returns (preds, stats) where ``stats[layer][domain]`` has 'pos'/'neg'/
    'all' mean attention maps ``[H, F, F]`` (head-major like the reference's
    ``normalized_att_scores``)."""
    model = trainer.model
    layout = trainer.layout
    dcol = layout.sparse_index(model.domain_cols[0])
    if num_domains is None:
        num_domains = int(getattr(model, "num_domains",
                                  model.num_domains_list[0]))

    data = layout.batch_from_dict(x)
    labels = np.asarray(y).reshape(-1)
    n = len(labels)
    bias = int(data["sparse"][:, dcol].min())  # meta_basemodel.py:438-441
    buckets = torch.arange(num_domains, device=trainer.device)

    preds = []
    acc_sums = None
    acc_counts = None
    for start in range(0, n, batch_size):
        end = min(start + batch_size, n)
        bsz = end - start
        batch_np = _padded(trainer, data, start, end, batch_size)
        yb = trainer._pad(labels[start:end], batch_size)
        # pad rows have domain id 0 -> 0 - bias falls in no bucket when
        # bias >= 1; for bias == 0 push them out of range
        if bias == 0 and bsz < batch_size:
            batch_np["sparse"] = batch_np["sparse"].copy()
            batch_np["sparse"][bsz:, dcol] = num_domains + 1
        batch = trainer._device_batch({**batch_np, "_y": yb})
        yt = batch.pop("_y")
        pred, scores = _scores_step(trainer, batch)
        with torch.inference_mode():
            ids = batch["sparse"][:, dcol].long()
            onehot = (ids[:, None] - bias == buckets[None]).float()  # [B, D]
            pos = (yt == 1).float()
            weights = {"pos": onehot * pos[:, None],
                       "neg": onehot * (1 - pos)[:, None], "all": onehot}
            sums = [{name: torch.einsum("bd,bhij->dhij", w, s)
                     for name, w in weights.items()} for s in scores]
            counts = {name: w.sum(dim=0) for name, w in weights.items()}
            preds.append(pred[:bsz])
            if acc_sums is None:
                acc_sums, acc_counts = sums, counts
            else:
                for acc, layer_sums in zip(acc_sums, sums):
                    for name in acc:
                        acc[name] += layer_sums[name]
                for name in acc_counts:
                    acc_counts[name] += counts[name]

    acc_sums = [{k: v.cpu().numpy() for k, v in layer_sums.items()}
                for layer_sums in acc_sums]
    acc_counts = {k: v.cpu().numpy() for k, v in acc_counts.items()}
    stats = []
    for layer_sums in acc_sums:
        per_layer = []
        for d in range(num_domains):
            per_layer.append({
                name: layer_sums[name][d]
                / max(float(acc_counts[name][d]), 1.0)
                for name in ("pos", "neg", "all")})
        stats.append(per_layer)
    pred = torch.cat(preds).cpu().numpy()
    return pred.astype("float64"), stats


# ---------------------------------------------------------------------------
# hard-coded Alimama visualization instance lists (reference
# submodules.py:243-310) - the row indices (into the test split) and their
# scenario ids that the paper's attention figures were drawn from.  Upstream's
# consumption loop is dead code (a stray ``break`` opens the loop body,
# meta_basemodel.py:441-445); ``collect_visual_instances`` below implements
# the evident intent.
# ---------------------------------------------------------------------------

ALIMAMA_TEST_VISUAL_IDS = [
    1453289, 42966022, 24205824, 16064524, 25503516, 3816928,
    7754202, 16947958, 41552490, 31733916, 9384867, 42806083,
    5328450, 21453215, 34663885, 17948903, 6822311, 1937201,
    4410285, 201744, 15171505, 4885268, 15800351, 13915527,
    27213000, 35978128, 28289712, 25123397, 25770247, 27379605,
    13760316, 10768337, 452273, 5274535, 35171148, 34114659,
    4660627, 23625906, 21004494, 28949905, 2653287, 21004523,
    2598530, 2058354, 4361359, 30024448, 21854660, 542100,
    16140508, 14360209, 6944232, 3417702, 24046308, 24350916,
    11629049, 11187604, 11629056, 11187612, 13184828, 7152854,
    33085373, 27794211, 24050906, 39595420, 8436213, 12633431,
    23422455, 18402585, 37030610, 27590084, 15272070, 13201925,
    6642612, 6527116, 5959166, 3252713, 42670791, 17064975,
    7826776, 6486620, 6678322, 5464538, 8589534, 4621928,
    22239583, 4621982, 1999744, 10213112, 12216345, 15436084,
    13461530, 34084101, 40170298, 34475377, 15591011, 10101370,
    15349269, 28524049, 17504711, 15349277, 3775317, 2815609,
    36539077, 42794663, 34870909, 29157348, 34870923, 29157361,
    13685414, 3031651, 33378505, 37496073, 12323623, 1473535,
    12323624, 1473550, 21577131, 18077461, 17589077, 594323,
    7054643, 27366202, 9829585, 3914425, 15037633, 3485856,
    4354720, 15268491, 6452190, 200160, 20131983, 19348389,
    27414407, 23073182, 623982, 11383393, 365066, 34383407,
    24621639, 11927453, 33979305, 24556419, 33979178, 33928232,
    34880803, 6376177, 630384, 15631931, 5951692, 7208557,
    15447211, 823224, 17987370, 20497886, 7104972, 11261277,
    4139805, 2518659, 15080545, 7805953, 12295454, 3571874,
    12295473, 3571892, 10182573, 9900270, 2777486, 16264490,
    18163604, 18088934, 39725987, 39497285, 3848595, 1177255,
    2490455, 8463106, 20776222, 22872501, 14865644, 27189783,
    27357813, 32926447, 15976511, 9037206, 16599797, 4066064,
    233709, 14820183, 39580645, 22254404, 21789170, 22254370,
    12251469, 10424663, 2228191, 13618755, 9990946, 4544418,
    8218479, 7867052, 13714297, 6830214, 13714394, 6830242,
    33087538, 8930753, 6766948, 12542448, 6766965, 12542468,
    15054031, 22726955, 42554055, 32536104, 2862756, 3599094,
    1995636, 430449, 26060671, 20681516, 16312505, 28367442,
    27610710, 1577758, 7035973, 1076148, 6505221, 12011328,
    6505225, 12011351, 35463824, 35597362, 11412430, 6738224,
    17175329, 35493826, 2708743, 6845084, 15823425, 16891493,
    7970124, 1993903, 1993917, 7970139, 14002840, 12057804,
    15992035, 23855897, 37358266, 32748952, 15288040, 13791942,
    9772821, 14922582, 3962870, 5702451, 18587646, 24862968,
    11718405, 13312948, 1424320, 3322337, 9908811, 14267302,
    4129804, 16178976, 6328636, 22669267, 22616032, 22469986,
    11918118, 4032157, 8726615, 14049473, 13442974, 15774644,
    996158, 13545838, 11434325, 5396649, 33397928, 29015019,
    7251893, 7193691, 3749412, 4288536, 19161122, 20572306,
    23708892, 11485419, 10235633, 3015786, 18315801, 10235674,
    3015864, 10235682, 18048354, 21544385, 18048367, 7588629,
    42790174, 33937873, 35901407, 33937889, 15626907, 11944843,
    21591872, 18622397, 7755823, 14457876, 4118822, 14245248]

ALIMAMA_DOMAIN_VISUAL_IDS = [
    2, 1, 2, 1, 2, 1, 1, 2, 1, 2, 2, 1, 2, 1, 1, 2, 2, 1, 1, 3, 1, 2,
    1, 2, 1, 3, 2, 1, 3, 1, 3, 1, 1, 2, 1, 2, 2, 3, 3, 1, 1, 3, 3, 1,
    1, 2, 2, 3, 3, 1, 2, 3, 1, 2, 2, 1, 2, 1, 2, 3, 3, 1, 1, 2, 2, 1,
    2, 1, 1, 3, 2, 3, 1, 2, 1, 2, 1, 2, 2, 1, 1, 2, 1, 2, 1, 2, 1, 2,
    1, 2, 2, 1, 2, 1, 2, 1, 1, 3, 3, 1, 1, 3, 2, 3, 1, 2, 1, 2, 1, 2,
    2, 1, 3, 1, 3, 1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 1, 2, 1, 3, 2, 1,
    2, 1, 2, 3, 2, 1, 1, 3, 1, 3, 1, 3, 2, 1, 1, 2, 1, 3, 1, 3, 1, 3,
    1, 2, 1, 3, 1, 2, 2, 1, 2, 1, 2, 1, 1, 3, 3, 1, 2, 1, 1, 2, 1, 2,
    1, 2, 1, 2, 3, 2, 3, 1, 1, 2, 1, 2, 1, 2, 1, 2, 2, 3, 2, 1, 1, 2,
    2, 1, 2, 1, 2, 1, 1, 3, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 3, 1, 3, 1,
    3, 2, 3, 2, 1, 2, 1, 2, 1, 2, 3, 1, 1, 2, 2, 1, 3, 1, 1, 2, 2, 1,
    1, 2, 1, 2, 1, 2, 2, 1, 3, 2, 3, 2, 1, 2, 3, 2, 1, 2, 3, 2, 2, 1,
    1, 3, 1, 2, 2, 3, 1, 2, 1, 2, 2, 3, 2, 1, 1, 2, 3, 1, 2, 3, 1, 3,
    2, 1, 2, 1, 1, 2, 2, 1, 2, 1, 3, 2, 3, 2, 2, 1, 2, 1, 2, 1, 1, 2,
    1, 2, 2, 1]


def collect_visual_instances(trainer, x: dict, *, ids=None,
                             batch_size: int = 4096):
    """Layer-0 attention maps ``{row_index: [H, F, F]}`` for the hard-coded
    visualization instances (reference meta_basemodel.py:440-445 intent;
    the upstream loop is disabled by a stray ``break``)."""
    if ids is None:
        ids = ALIMAMA_TEST_VISUAL_IDS
    data = trainer.layout.batch_from_dict(x)
    n = len(next(iter(data.values())))
    wanted = sorted(i for i in set(ids) if i < n)
    out = {}
    for start in range(0, n, batch_size):
        end = min(start + batch_size, n)
        lo = bisect.bisect_left(wanted, start)
        hi = bisect.bisect_left(wanted, end)
        if lo == hi:
            continue
        _, scores = _scores_step(trainer, _padded(trainer, data, start, end,
                                                  batch_size))
        rows = torch.tensor(wanted[lo:hi], device=scores[0].device) - start
        for idx, s in zip(wanted[lo:hi], scores[0][rows].cpu().numpy()):
            out[idx] = s
    return out


def dump_instance_attention_reference(trainer, x: dict, y, *,
                                      flag: str, classes_=None,
                                      batch_size: int = 4096,
                                      threshold: float = 0.2,
                                      out_dir: str = ".",
                                      pvalue_idx: int = 7, gender_idx: int = 5,
                                      shopping_idx: int = 8,
                                      price_idx: int = 15):
    """Byte-format parity ``instattn`` dump (reference
    meta_basemodel.py:460-499): one ``inst_attn_{flag}.txt`` of 3-line
    records per (head, instance) whose layer-0 attention matches the
    hard-coded Alimama-sparseprice rules:

    * gate: label==1 and pvalue_level==3
    * rule A: attn[pvalue->gender] and attn[pvalue->price] above threshold,
      raw price id > 10000
    * rule B: attn[price->pvalue] and (attn[price->gender] or
      attn[price->shopping]) above threshold, raw price id > 12000

    Record lines: ``score {pred},label {label},pvalue {p},price {decoded}``,
    the flattened F*F scores comma-joined (trailing comma), then the
    instance's feature values comma-joined (trailing comma) - matching the
    reference byte-for-byte given equal scores.  ``classes_`` is the price
    label-encoder's classes array (reference main.py:335).
    """
    layout = trainer.layout
    data = layout.batch_from_dict(x)
    labels = np.asarray(y).reshape(-1)
    n = len(labels)
    feat_names = ([c.name for c in layout.sparse]
                  + [c.name for c in layout.dense])

    path = os.path.join(out_dir, f"inst_attn_{flag}.txt")
    with open(path, "w") as f:
        for start in range(0, n, batch_size):
            end = min(start + batch_size, n)
            bsz = end - start
            pred, scores = _scores_step(
                trainer, _padded(trainer, data, start, end, batch_size))
            pred = pred[:bsz].cpu().numpy()
            # layer 0: [H, b, F, F]
            attn = scores[0][:bsz].cpu().numpy().transpose(1, 0, 2, 3)
            # the reference's x row: features in feature_index order, float
            xb = np.stack([np.asarray(x[nm][start:end], np.float64)
                           for nm in feat_names], axis=1)
            yb = labels[start:end]

            def write_record(h, i):
                p_id = int(xb[i][pvalue_idx])
                pr_id = int(xb[i][price_idx])
                price = classes_[pr_id] if classes_ is not None else pr_id
                f.write(f"score {pred[i].item()},label {yb[i].item()},"
                        f"pvalue {p_id},price {price}\n")
                s = [str(v) for v in attn[h, i].reshape(-1).tolist()]
                f.write(",".join(s) + ",\n")
                inst = ",".join(str(v) for v in xb[i].tolist())
                f.write(inst + ",\n")

            for h in range(attn.shape[0]):
                for i in range(bsz):
                    if not (yb[i] == 1 and xb[i][pvalue_idx] == 3):
                        continue
                    a = attn[h, i]
                    if (a[pvalue_idx][gender_idx] > threshold
                            and a[pvalue_idx][price_idx] > threshold
                            and xb[i][price_idx] > 10000
                            and xb[i][pvalue_idx] >= 2):
                        write_record(h, i)
                    if (a[price_idx][pvalue_idx] > threshold
                            and (a[price_idx][gender_idx] > threshold
                                 or a[price_idx][shopping_idx] > threshold)
                            and xb[i][price_idx] > 12000
                            and xb[i][pvalue_idx] >= 2):
                        write_record(h, i)
    return path


def dump_instance_attention(trainer, x: dict, *, batch_size: int = 4096,
                            threshold: float = 0.2, out_prefix: str =
                            "inst_attn", max_instances: int = 1000):
    """``instattn``: per instance, write high-attention (i, j, score) triples
    to ``{out_prefix}_{domain}.txt`` (meta_basemodel.py:460-499)."""
    dcol = trainer.layout.sparse_index(trainer.model.domain_cols[0])
    data = trainer.layout.batch_from_dict(x)
    n = min(len(next(iter(data.values()))), max_instances)

    files = {}
    try:
        for start in range(0, n, batch_size):
            end = min(start + batch_size, n)
            bsz = end - start
            batch_np = _padded(trainer, data, start, end, batch_size)
            _, scores = _scores_step(trainer, batch_np)
            # the head mean of each layer, [L, b, F, F], for the real rows
            scores = torch.stack([s[:bsz].mean(dim=1)
                                  for s in scores]).cpu().numpy()
            doms = batch_np["sparse"][:bsz, dcol]
            for b in range(bsz):
                d = int(doms[b])
                if d not in files:
                    files[d] = open(f"{out_prefix}_{d}.txt", "w")
                f = files[d]
                for layer in range(scores.shape[0]):
                    ii, jj = np.where(scores[layer, b] > threshold)
                    for i, j in zip(ii, jj):
                        f.write(f"{start + b}\t{layer}\t{i}\t{j}\t"
                                f"{scores[layer, b, i, j]:.4f}\n")
    finally:
        for f in files.values():
            f.close()
    return sorted(files)
