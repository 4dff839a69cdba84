"""Serving (twin of ``satrans_tpu/serving.py``).

:class:`Predictor` scores a feature dict with a frozen model: a fixed
batch size, the tail padded with zero rows, float64 scores out.  Batches
are staged and run without a synchronisation per batch; the one copy back
to the host at the end waits for the device.  A multi-task model's
``[B, num_tasks]`` output is routed as the Trainer routes it, each
example scored by its domain's head under the model's
``domain_id_offset`` (serving.py:47-54).  :meth:`Predictor.from_trainer`
serves a trainer's model; :func:`save` writes a trainer's checkpoint
(``train/checkpoint.py``) and :func:`load` rebuilds a Predictor from one
and a model of the same configuration.

The model scores in eval mode, as the JAX ``Predictor`` scores with
``train=False``: each call puts it there (a Trainer sharing the model
sets the mode each of its steps needs).

Staging (``pipeline_depth``, serving.py:36-45, :104-123).  On the card
each batch's rows are written on the host, straight from the request's
columns as ``FeatureLayout.columns`` types them, into a pinned slot of a
ring of ``pipeline_depth`` slots, the tail padded with zeros (the ids
field-major, so that each field's rows are one copy; the card transposes
them), and copied to the device on a copy stream; the compute stream
waits on that copy's event, and the host refills a slot only once the
slot's previous copy has completed, so up to ``pipeline_depth`` batches
are staged ahead of the card (depth 1 stages through pinned memory
too).  The request is never assembled whole on
the host: each batch is written while the card runs the previous ones.
On the CPU each batch is written into a slot of its own and a depth
above 1 stages from a thread pool, as the JAX package does.  Every depth
gives the same scores, bit for bit.

:meth:`Predictor.aot_compile` is the counterpart of the JAX
``jit(...).lower(...).compile()`` (serving.py:85-90).  On the card it
warms up at ``batch_size``, so that every kernel library is built and
loaded and every device constant is filled, then captures one CUDA graph
of the score of one batch on static input and output buffers.  Each
staged batch is then copied into the static inputs (a device-to-device
copy, so one graph serves every ring slot), the graph replayed and its
scores copied out before the next replay.  The graph reads the
parameters at the addresses it captured: a parameter updated in place
(``load_state_dict``, ``checkpoint.load_model``, an optimizer step) is
served as it now is, while a parameter or buffer replaced by another
tensor or a new ``domain_id_offset`` makes the next call capture anew,
so a stale graph is never replayed.  A capture that fails raises with
the CUDA error and the model's name; there is no quiet return to the
eager path.  On the CPU there is no
graph: ``aot_compile`` runs the warmup.

The kernels' launch counters (``ops.launch_counts``) move where a wrapper
launches its kernel, so a replay moves none: the Predictor keeps the
launches its capture made (:attr:`Predictor.captured_launches`) and its
replays, and :meth:`Predictor.launches` is their product.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .features import BATCH_DTYPES
from .ops import launch_counts
from .utils import resolve_device


class Captured:
    """``fn(inputs)`` captured as one CUDA graph on ``inputs``, a dict of
    static device tensors, after one warmup call on a side stream (as
    ``torch.cuda.graph`` asks): :meth:`replay` runs it again on what the
    inputs then hold and returns the static output, which the next replay
    overwrites.  It keeps the launches the capture made, by kernel
    (:attr:`captured`), and counts its replays.  A failed capture raises
    naming ``what``, with the CUDA error."""

    def __init__(self, fn, inputs: dict, what: str):
        dev = next(iter(inputs.values())).device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(inputs)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        try:
            with torch.cuda.graph(self.graph):
                self.output = fn(inputs)
        except Exception as err:
            raise RuntimeError(f"capturing {what} failed: {err}") from err
        after = launch_counts()
        self.inputs = inputs
        self.captured = {k: n - before[k] for k, n in after.items()
                         if n != before[k]}
        self.replays = 0

    def replay(self):
        self.graph.replay()
        self.replays += 1
        return self.output

    def launches(self) -> dict:
        """:attr:`replays` times the captured launches, by kernel."""
        return {k: self.replays * n for k, n in self.captured.items()}


class Predictor:
    def __init__(self, model: torch.nn.Module, *, batch_size: int = 4096,
                 pipeline_depth: int = 1, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.layout = model.layout
        self.batch_size = int(batch_size)
        self.pipeline_depth = max(1, int(pipeline_depth))
        # the captured score (aot_compile) and the model's fingerprint then
        self.graph: Captured | None = None
        self._fingerprint_at_capture = None
        self._rings: dict = {}
        self._copy_stream = None

    @classmethod
    def from_trainer(cls, trainer, *, batch_size: int = 4096) -> "Predictor":
        """A Predictor of ``trainer``'s model on its device."""
        return cls(trainer.model, batch_size=batch_size,
                   device=trainer.device)

    def _score(self, batch: dict) -> torch.Tensor:
        pred = self.model(batch)
        if pred.ndim > 1:  # the heads of a multi-task model
            from .train.losses import route_by_domain
            col = self.layout.sparse_index(self.model.domain_col)
            pred = route_by_domain(pred, batch["sparse"][:, col],
                                   self.model.domain_id_offset)
        return pred

    def _slot(self, cols: dict) -> dict:
        """Empty host buffers of one batch for ``cols``
        (``FeatureLayout.columns``), typed by ``BATCH_DTYPES``: the ids
        ``[S, batch_size]`` (each field's ids contiguous: the fill copies
        whole runs and the card transposes), the dense values
        ``[batch_size, dense_dim]``, the varlen ids ``[batch_size, V, L]``;
        pinned on the card's machine."""
        bs = self.batch_size
        shape = {"sparse": lambda p: (len(p), bs),
                 "dense": lambda p: (bs, sum(c.shape[1] for c in p)),
                 "varlen": lambda p: (bs, len(p), p[0].shape[1])}
        return {k: torch.empty(shape[k](p), dtype=torch.from_numpy(
                    np.empty(0, BATCH_DTYPES[k])).dtype,
                               pin_memory=self.device.type == "cuda")
                for k, p in cols.items()}

    @staticmethod
    def _fill(slot: dict, cols: dict, start: int, end: int) -> None:
        """Write rows ``start:end`` of ``cols`` into ``slot`` and zero the
        rest (the padded tail)."""
        m = end - start
        for k, parts in cols.items():
            buf = slot[k].numpy()
            if k == "sparse":
                for j, c in enumerate(parts):
                    buf[j, :m] = c[start:end]
                buf[:, m:] = 0
                continue
            off = 0
            for c in parts:
                if k == "dense":
                    buf[:m, off:off + c.shape[1]] = c[start:end]
                    off += c.shape[1]
                else:
                    buf[:m, off] = c[start:end]
                    off += 1
            buf[m:] = 0

    @staticmethod
    def _batch(slot: dict) -> dict:
        """A filled slot as the model's batch: the ids ``[batch_size, S]``
        (a transposed view)."""
        return {k: t.t() if k == "sparse" else t for k, t in slot.items()}

    def _host_batch(self, cols: dict, start: int, end: int) -> dict:
        """Rows ``start:end`` of ``cols`` as one padded batch in a new host
        slot (the CPU's staging, and the warmup's)."""
        slot = self._slot(cols)
        self._fill(slot, cols, start, end)
        return {k: t.contiguous() for k, t in self._batch(slot).items()}

    def _staged(self, cols: dict, spans, depth: int):
        """Each span's batch on the card, staged through a ring of
        ``depth`` pinned slots (kept across calls): its rows written into
        a slot once the slot's previous copy has completed, copied on the
        copy stream, the compute stream made to wait on the copy.  The ids
        arrive field-major (:meth:`_batch`)."""
        dev = self.device
        compute = torch.cuda.current_stream(dev)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(dev)
        copy = self._copy_stream
        key = (depth, tuple((k, tuple(c.shape[1:] for c in parts))
                            for k, parts in cols.items()))
        ring = self._rings.get(key)
        if ring is None:
            ring = self._rings[key] = [[self._slot(cols), None]
                                       for _ in range(depth)]
        for i, (s, e) in enumerate(spans):
            slot = ring[i % depth]
            host, done = slot
            if done is not None:
                done.synchronize()
            self._fill(host, cols, s, e)
            with torch.cuda.stream(copy):
                batch = {k: t.to(dev, non_blocking=True)
                         for k, t in host.items()}
                slot[1] = torch.cuda.Event()
                slot[1].record(copy)
            compute.wait_event(slot[1])
            for t in batch.values():  # allocated on the copy stream
                t.record_stream(compute)
            yield self._batch(batch)

    def _example_request(self) -> dict:
        """A request of ``batch_size`` rows: ids 1, dense and varlen
        values 0."""
        n, layout = self.batch_size, self.layout
        x = {c.name: np.ones(n, np.int32) for c in layout.sparse}
        x.update({c.name: np.zeros((n, c.dimension), np.float32)
                  for c in layout.dense})
        x.update({c.name: np.zeros((n, c.maxlen), np.int32)
                  for c in layout.varlen})
        return x

    def _example_batch(self) -> dict:
        """:meth:`_example_request` as one batch on the Predictor's
        device."""
        n, cols = self.layout.columns(self._example_request())
        return {k: t.to(self.device)
                for k, t in self._host_batch(cols, 0, n).items()}

    def warmup(self) -> "Predictor":
        """Run one dummy batch (the kernels build and load here)."""
        self.model.eval()
        with torch.inference_mode():
            self._score(self._example_batch()).cpu()
        return self

    def _fingerprint(self) -> tuple:
        """What a captured graph holds fixed: the model's
        ``domain_id_offset`` and the address, shape and type of every
        parameter and buffer."""
        m = self.model
        return (getattr(m, "domain_id_offset", None),
                tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                      for t in (*m.parameters(), *m.buffers())))

    def aot_compile(self) -> "Predictor":
        """Warm up and, on the card, capture the score of one batch as a
        CUDA graph that later calls replay (see the module's docstring).
        On the CPU only the warmup runs."""
        self.warmup()
        if self.device.type == "cuda":
            self.graph = None  # the old graph's memory first
            with torch.inference_mode():
                static = self._example_batch()
                self.graph = Captured(
                    self._score, static, f"the score of "
                    f"{type(self.model).__name__} at batch "
                    f"{self.batch_size}")
            self._fingerprint_at_capture = self._fingerprint()
        return self

    @property
    def captured_launches(self) -> dict:
        """The launches, by kernel, of the captured score of one batch
        (empty without a graph)."""
        return dict(self.graph.captured) if self.graph else {}

    def launches(self) -> dict:
        """The graph's launches, by kernel: its replays times the captured
        ones."""
        return self.graph.launches() if self.graph else {}

    def __call__(self, x: dict, *,
                 pipeline_depth: int | None = None) -> np.ndarray:
        depth = self.pipeline_depth if pipeline_depth is None \
            else max(1, int(pipeline_depth))
        self.model.eval()
        with torch.inference_mode():
            if self.device.type == "cuda":
                scores = self._serve_card(x, depth)
            else:
                scores = self._serve_host(x, depth)
        return scores.numpy().astype("float64")

    def _spans(self, n: int) -> list:
        bs = self.batch_size
        return [(s, min(s + bs, n)) for s in range(0, n, bs)]

    def _serve_host(self, x: dict, depth: int) -> torch.Tensor:
        n, cols = self.layout.columns(x)
        spans = self._spans(n)
        if depth == 1 or len(spans) == 1:
            outs = [self._score(self._host_batch(cols, s, e))[:e - s]
                    for s, e in spans]
        else:
            with ThreadPoolExecutor(max_workers=depth) as pool:
                futs = [pool.submit(self._host_batch, cols, s, e)
                        for s, e in spans]
                # scored in order; the staging runs ahead
                outs = [self._score(f.result())[:e - s]
                        for f, (s, e) in zip(futs, spans)]
        return torch.cat(outs)

    def _serve_card(self, x: dict, depth: int) -> torch.Tensor:
        if self.graph is not None and \
                self._fingerprint_at_capture != self._fingerprint():
            self.aot_compile()
        g = self.graph
        n, cols = self.layout.columns(x)
        spans = self._spans(n)
        out = None
        for (s, e), batch in zip(spans, self._staged(cols, spans, depth)):
            if g is None:
                pred = self._score({k: t.contiguous()
                                    for k, t in batch.items()})
            else:
                for k, t in batch.items():
                    g.inputs[k].copy_(t)
                pred = g.replay()
            if out is None:
                out = pred.new_empty(n)
            out[s:e].copy_(pred[:e - s])  # before the next replay
        return out.cpu()


def save(path: str, trainer) -> None:
    """Persist a trainer's parameters and state for serving
    (``train/checkpoint.save``)."""
    from .train import checkpoint
    checkpoint.save(path, trainer)


def load(path: str, model: torch.nn.Module, *, batch_size: int = 4096,
         device="cuda") -> Predictor:
    """Rebuild a Predictor from a checkpoint and a model of the same
    configuration: the checkpoint's parameters and buffers are loaded into
    ``model`` and its fit-learned ``domain_id_offset`` set (its optimizer
    state, which serving does not need, is not read, so a checkpoint of
    any bank mode loads)."""
    from .train import checkpoint
    dev = resolve_device(device)
    model = model.to(dev)
    checkpoint.load_model(checkpoint.read(path, dev), model)
    return Predictor(model, batch_size=batch_size, device=dev)
