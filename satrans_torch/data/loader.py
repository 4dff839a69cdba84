"""Host-sharded, globally shuffled batch iterator and a background
prefetcher (twin of ``satrans_tpu/data/loader.py``; numpy and the standard
library only).

* :class:`ShardedBatchIterator`: a seeded global permutation, drawn anew
  each epoch (``default_rng(seed + epoch)``); host ``h`` of ``H`` takes
  the permutation's slice ``h::H``, so the global batch is the union of
  the hosts' shards.  Epoch 0 of one host with ``seed=trainer.seed`` is
  the permutation ``Trainer.fit`` draws for its first epoch.
* :class:`Prefetcher`: runs a producer iterator in a thread with a
  bounded queue, so the next numpy batch is assembled while the card runs
  the current step; an exception of the producer is raised in the
  consumer.

Both replace the reference's ``DataLoader(shuffle=True)`` over an
in-memory TensorDataset (basemodel.py:278-279).
"""

from __future__ import annotations

import queue
import threading

import numpy as np


class ShardedBatchIterator:
    def __init__(self, data: dict[str, np.ndarray], labels: np.ndarray,
                 batch_size: int, *, shuffle: bool = True, seed: int = 0,
                 host_id: int = 0, num_hosts: int = 1,
                 drop_remainder: bool = False):
        if batch_size % num_hosts:
            raise ValueError("global batch_size must divide by num_hosts")
        self.data = data
        self.labels = labels
        self.n = len(labels)
        self.host_batch = batch_size // num_hosts
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.steps = (self.n // batch_size if drop_remainder
                      else (self.n - 1) // batch_size + 1)

    def epoch(self, epoch_idx: int):
        """Yield ``(batch dict, labels, weight)`` numpy triples for this
        host; the last batch is padded with zero rows of weight 0."""
        rng = np.random.default_rng(self.seed + epoch_idx)
        perm = rng.permutation(self.n) if self.shuffle else np.arange(self.n)
        shard = perm[self.host_id::self.num_hosts]
        hb = self.host_batch
        for step in range(self.steps):
            idx = shard[step * hb:(step + 1) * hb]
            w = np.zeros(hb, np.float32)
            w[:len(idx)] = 1.0
            batch = {k: _pad(v[idx], hb) for k, v in self.data.items()}
            yield batch, _pad(self.labels[idx], hb), w


def _pad(arr, target):
    n = len(arr)
    if n == target:
        return arr
    return np.pad(arr, [(0, target - n)] + [(0, 0)] * (arr.ndim - 1))


class Prefetcher:
    """Run a producer iterator in a background thread with a bounded
    queue of ``depth`` items, each passed through ``transform`` there."""

    _END = object()

    def __init__(self, iterator, depth: int = 2, transform=None):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.transform = transform

        def work():
            # a producer's crash must reach the consumer, not pass for the
            # end of the epoch (training would go on with truncated data)
            try:
                for item in iterator:
                    self.q.put(self.transform(item) if self.transform
                               else item)
            except BaseException as e:  # noqa: BLE001 - relayed, not handled
                self.q.put(e)
            else:
                self.q.put(self._END)

        self.thread = threading.Thread(target=work, daemon=True)
        self.thread.start()

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is self._END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
