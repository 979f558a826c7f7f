"""Threaded prefetching batch loader.

Index order as the JAX package's loader: ``random.Random(seed + epoch)``
shuffles each epoch's indices; batches are assembled by a thread pool
(numpy's gathers and arithmetic release the GIL) a few batches ahead of
the consumer and come out as stacked numpy arrays.  Each ``__iter__`` is
one epoch: it first hands the epoch to the dataset's ``set_epoch`` (the
``det_seed`` streams), and ``fast_forward`` positions the stream where a
run that drew ``batches_done`` batches would be.
"""

from __future__ import annotations

import random
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Tuple

import numpy as np


class DataLoader:
    PREFETCH = 2     # batches in flight ahead of the consumer

    def __init__(self, dataset, batch_size: int, shuffle: bool,
                 num_workers: int = 8, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.epoch = 0
        self._skip = 0

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def fast_forward(self, batches_done: int) -> None:
        """Position the stream as if ``batches_done`` batches had been
        drawn: the epoch, and the batches of it the next ``__iter__``
        drops.  With a ``det_seed`` dataset a resumed run then sees the
        batches an uninterrupted run would have."""
        n = len(self)
        self.epoch = batches_done // n
        self._skip = batches_done % n

    def _batches(self):
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idx)
        set_epoch = getattr(self.dataset, "set_epoch", None)
        if set_epoch is not None:
            set_epoch(self.epoch)
        self.epoch += 1
        skip, self._skip = self._skip, 0
        return [idx[i:i + self.batch_size]
                for i in range(0, len(idx), self.batch_size)][skip:]

    def _load(self, batch_idx) -> Tuple[np.ndarray, np.ndarray]:
        items = [self.dataset[i] for i in batch_idx]
        return (np.stack([it[0] for it in items]),
                np.stack([it[1] for it in items]))

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        it = iter(self._batches())
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = [pool.submit(self._load, b)
                       for b in (next(it, None) for _ in range(self.PREFETCH))
                       if b is not None]
            while pending:
                fut = pending.pop(0)
                nxt = next(it, None)
                if nxt is not None:
                    pending.append(pool.submit(self._load, nxt))
                yield fut.result()
