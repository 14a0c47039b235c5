"""Parallel prefetching batch loader: the port's own copy of the JAX
package's data/loader.py (numpy and the standard library only; the same
batches in the same order for the same seed).

A thread pool runs the per-sample pipeline, batches are assembled in
submission order, and a bounded prefetch queue keeps the card fed while the
current step runs. ``batch_seconds`` records how long each batch took to
make: a consumer whose step is shorter than that waits on the queue. Per-shard slicing and epoch-keyed shuffling reproduce
DistributedSampler semantics (reference: train.py:153,278): epoch e visits
``np.random.default_rng(seed + e).permutation(len(dataset))``.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np


class BatchAssembly:
    """Mixin: batch assembly over `self.sample(i)` for any dataset."""

    _HOST_ONLY_SUFFIXES = ("_img_path", "_geodesic_center")

    def batch_from_indices(self, indices) -> dict:
        samples = [self.sample(int(i)) for i in indices]
        out = {}
        for key in samples[0]:
            if key == "act" or key.endswith(self._HOST_ONLY_SUFFIXES) or \
                    isinstance(samples[0][key], str):
                continue
            out[key] = np.stack([np.asarray(s[key]) for s in samples])
        return out

    def batch(self, start: int, batch_size: int) -> dict:
        n = len(self)
        idx = [(start + i) % n for i in range(batch_size)]
        samples = [self.sample(i) for i in idx]
        out = {}
        for key in samples[0]:
            if key.endswith(self._HOST_ONLY_SUFFIXES):
                continue
            if key == "act" or isinstance(samples[0][key], str):
                out[key] = [s[key] for s in samples]
            else:
                out[key] = np.stack([np.asarray(s[key]) for s in samples])
        return out

    def device_batch(self, start: int, batch_size: int) -> dict:
        b = self.batch(start, batch_size)
        return {k: v for k, v in b.items()
                if not (k == "act" or isinstance(v, list))}


class BatchLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 8,
        prefetch: int = 2,
        seed: int = 0,
        num_shards: int = 1,
        shard_index: int = 0,
        drop_last: bool = True,
    ):
        if batch_size % num_shards:
            raise ValueError("batch size must divide evenly across shards")
        self.dataset = dataset
        self.global_batch = batch_size
        self.local_batch = batch_size // num_shards
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.drop_last = drop_last
        self._pool = ThreadPoolExecutor(max_workers=num_workers)
        # seconds from submitting each batch's samples to its collation, in
        # the order made, over every epoch
        self.batch_seconds: list[float] = []

    def __len__(self):
        n = len(self.dataset) // self.global_batch
        if not self.drop_last and len(self.dataset) % self.global_batch:
            n += 1
        return n

    def _epoch_order(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return np.random.default_rng(self.seed + epoch).permutation(n)
        return np.arange(n)

    def epoch(self, epoch: int = 0):
        """Yield this shard's batches for one epoch, prefetched."""
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
        order = self._epoch_order(epoch)
        steps = len(self)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def submit(step):
            start = step * self.global_batch
            idx = order[start : start + self.global_batch]
            lo = self.shard_index * self.local_batch
            idx = idx[lo : lo + self.local_batch]
            return [self._pool.submit(self.dataset.sample, int(i))
                    for i in idx]

        def producer():
            for step in range(steps):
                if stop.is_set():
                    return
                t0 = time.perf_counter()
                futures = submit(step)
                batch = _collate([f.result() for f in futures])
                self.batch_seconds.append(time.perf_counter() - t0)
                q.put(batch)
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                yield batch
        finally:
            stop.set()
            # a consumer that stops early (--steps) leaves the producer
            # blocked on a full queue: drain it until the producer ends
            while t.is_alive():
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass


def _collate(samples) -> dict:
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], (str, bytes)):
            out[key] = vals
        elif key == "act":
            out[key] = vals
        else:
            out[key] = np.stack([np.asarray(v) for v in vals])
    return out
