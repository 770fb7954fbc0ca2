"""Batched data loader: a copy of ``hsi_dmgasr_tpu/data/loader.py``.

Index-based datasets (__len__/__getitem__) are batched into stacked
numpy dicts/tuples with optional seeded shuffling and a background
prefetch thread (optionally a thread pool for the items). Items stay
numpy: the step moves a batch to the device. The JAX package's
multi-host ``distributed`` sharding is not ported (one process, one
card).
"""

from __future__ import annotations

import queue
import threading

import numpy as np


def _collate(items):
    first = items[0]
    if isinstance(first, dict):
        return {
            k: (
                np.stack([it[k] for it in items])
                if isinstance(first[k], np.ndarray)
                else np.asarray([it[k] for it in items])
            )
            for k in first
        }
    if isinstance(first, (tuple, list)):
        return tuple(np.stack([it[i] for it in items]) for i in range(len(first)))
    return np.stack(items)


class DataLoader:
    def __init__(self, dataset, batch_size=1, shuffle=False, drop_last=False,
                 seed=0, prefetch=2, num_workers=1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)
        self.prefetch = prefetch
        self.num_workers = num_workers
        self._pool = None

    def _fetch(self, batch_idx):
        if self.num_workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
            items = list(self._pool.map(lambda i: self.dataset[int(i)], batch_idx))
        else:
            items = [self.dataset[int(i)] for i in batch_idx]
        return _collate(items)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        bs = self.batch_size
        end = (len(idx) // bs) * bs if self.drop_last else len(idx)
        for i in range(0, end, bs):
            yield idx[i:i + bs]

    def __iter__(self):
        if self.prefetch <= 0:
            for batch_idx in self._index_batches():
                yield self._fetch(batch_idx)
            return

        q = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def _put(item):
            # bounded put with shutdown poll so an early-breaking consumer
            # (e.g. stage2_driver stopping at n_iter) never strands us
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            exc = None
            try:
                for batch_idx in self._index_batches():
                    if stop.is_set() or not _put(("data", self._fetch(batch_idx))):
                        return
            except BaseException as e:  # re-raised in the consumer
                exc = e
            _put(("end", exc))

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                kind, item = q.get()
                if kind == "end":
                    if item is not None:
                        raise item
                    break
                yield item
        finally:
            stop.set()
