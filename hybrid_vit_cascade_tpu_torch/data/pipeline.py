"""Epoch loader and the host→device copy (counterpart of
hybrid_vit_cascade_tpu/data/pipeline.py).

``DataLoader`` batches numpy items with a seeded per-epoch shuffle (the
``sampler.set_epoch`` equivalent), drops the ragged last batch by default and
can prefetch batches in one background thread, which runs the dataset and
the batch ``transform`` and never touches the device. ``batch_size`` is the
global batch: with ``world`` data-parallel ranks, rank r takes positions
[r·B/k, (r+1)·B/k) of each global batch whose size divides by k = ``world``,
so the ranks' batch s together hold a one-process run's batch s, and a
batch that does not divide (a ragged validation tail) is taken whole by
every rank, as the JAX trainer replicates it on one host. ``to_device``
takes the place of ``shard_batch``: each process feeds its own card, so
placing a batch is a copy of its arrays to the device, made in the caller's
thread. Multi-host loading has no counterpart (one host).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch


def to_device(batch: Dict, device: torch.device | str) -> Dict[str, torch.Tensor]:
    """The batch's numpy arrays as tensors on ``device``; entries that are not
    arrays (patient ids, flags) are dropped."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()
            if isinstance(v, np.ndarray)}


class DataLoader:
    """Minimal epoch-based loader: shuffle (seeded per epoch), batch, this
    rank's part of each batch, optional background prefetch of
    ``num_prefetch`` batches."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True, num_prefetch: int = 2, transform=None,
                 rank: int = 0, world: int = 1):
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside a world of {world}")
        if drop_last and batch_size % world:
            raise ValueError(f"a global batch of {batch_size} does not split over {world} ranks")
        self.dataset = dataset
        self.batch_size = batch_size
        self.rank, self.world = rank, world
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_prefetch = num_prefetch
        # host-side batch map (e.g. pre-resizing CT targets to the stage
        # resolution); runs in the prefetch thread when there is one
        self.transform = transform
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return np.random.default_rng(self.seed + self.epoch).permutation(n)
        return np.arange(n)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    @staticmethod
    def _collate(items) -> Dict:
        out: Dict = {}
        for key in items[0]:
            vals = [it[key] for it in items]
            out[key] = np.stack(vals) if isinstance(vals[0], np.ndarray) else vals
        return out

    def sharded(self, b: int) -> bool:
        """Whether global batch ``b`` is split over the ranks (else every
        rank takes it whole)."""
        size = min(self.batch_size, len(self.dataset) - b * self.batch_size)
        return self.world > 1 and size % self.world == 0

    def _batches(self) -> Iterator[Dict]:
        idx = self._indices()
        for b in range(len(self)):
            chunk = idx[b * self.batch_size:(b + 1) * self.batch_size]
            if self.sharded(b):
                per = len(chunk) // self.world
                chunk = chunk[self.rank * per:(self.rank + 1) * per]
            batch = self._collate([self.dataset[int(i)] for i in chunk])
            yield self.transform(batch) if self.transform is not None else batch

    def __iter__(self) -> Iterator[Dict]:
        if self.num_prefetch <= 0:
            yield from self._batches()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.num_prefetch)
        stop = threading.Event()
        done = object()
        err: list = []

        def producer():
            try:
                for batch in self._batches():
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except Exception as e:  # raised again in the consumer's thread
                err.append(e)
            finally:
                q.put(done)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            # a consumer that stops early releases the producer
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()
