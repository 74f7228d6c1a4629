"""Batching data loader: numpy collate and a background prefetch (the
port's own copy of ``istnet_tpu/data/loader.py``).

A thread pool maps ``dataset.__getitem__`` over each batch's indices in
order (``pool.map``), a producer thread puts the collated batches into a
bounded queue, and it stops when the consumer stops iterating. Threads,
not processes: the heavy per-sample work (OpenCV morphology, PNG decode)
releases the interpreter lock. Each epoch's order comes from one
``RandomState(seed)``, drawn as the JAX package draws it.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np


def collate(samples: list[dict]) -> dict:
    """Stack same-keyed numpy leaves along a new batch axis."""
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], np.ndarray) or np.isscalar(vals[0]) or isinstance(
                vals[0], (int, float, np.integer, np.floating)):
            out[k] = np.stack([np.asarray(v) for v in vals])
        else:
            out[k] = vals
    return out


class _Failed:
    """The producer's exception, carried to the consumer."""

    def __init__(self, error: Exception):
        self.error = error


class DataLoader:
    """Batches of ``batch_size`` samples of ``dataset``, shuffled per epoch
    (``shuffle``), the short last batch dropped (``drop_last``), loaded by
    ``num_workers`` threads up to ``prefetch`` batches ahead."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 4,
                 prefetch: int = 4, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self) -> list[np.ndarray]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        nb = len(self)
        return [order[i * self.batch_size:(i + 1) * self.batch_size] for i in range(nb)]

    def __iter__(self) -> Iterator[dict]:
        batches = self._batches()
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # bounded put that re-checks stop: a consumer abandoning iteration
            # must not leave the producer parked forever on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idxs in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__, idxs))
                        if not put(collate(samples)):
                            return
            except Exception as e:  # a failed sample: raised in the consumer
                put(_Failed(e))
                return
            put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, _Failed):
                    raise item.error
                yield item
        finally:
            stop.set()
