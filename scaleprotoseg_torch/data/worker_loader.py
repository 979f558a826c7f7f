"""Batch loader on worker processes: the threaded ``DataLoader``'s contract
on ``torch.utils.data.DataLoader`` workers.

The counterpart of the JAX package's grain loader with process workers
(``loader_backend = 'grain_processes'``), for augmentations that hold
the GIL (the color jitter's numpy); the reference fed torch's worker
processes too.  The sampled stream is the threaded loader's:
``DataLoader._batches`` (the per-epoch ``random.Random(seed + epoch)``
shuffle, ``set_epoch``, ``fast_forward``'s epoch and skip) is torch's
batch sampler, so with a ``det_seed`` dataset both backends yield the
same batches bit for bit.

- Workers are persistent (started at the first ``__iter__``, reused by
  every epoch) and the epoch reaches them with each item: the sampler
  hands out (epoch, index) pairs, and the worker sets its dataset copy's
  epoch before it reads the item.
- Workers are spawned, not forked: the trainer that owns the loader has
  CUDA initialised, a checkpoint-writer thread and a SIGTERM handler.
  They run numpy and the already-built native library, never CUDA.
- Workers leave the trainer's process group as they start, so a SIGTERM
  that a scheduler sends to the group reaches the trainer alone: it
  commits its state and exits 143, and its exit stops the workers.  They
  are spawned with SIGTERM blocked and unblock it once outside the group;
  a SIGTERM that reached one before that is dropped unless the trainer
  sent it (its exit stopping workers).
- Seeds come from an explicit ``torch.Generator`` seeded with the
  loader's seed, never from the process's global torch stream.
- Batches are stacked numpy arrays, as the threaded loader's; they come
  from the workers through shared memory.
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os
import signal
import weakref
from typing import Iterator, List, Tuple

import numpy as np
import torch
import torch.utils.data

from scaleprotoseg_torch.data.loader import DataLoader


class _EpochItems:
    """The dataset indexed by (epoch, index): the worker's copy takes the
    epoch of each item it reads."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, key):
        epoch, index = key
        set_epoch = getattr(self.dataset, "set_epoch", None)
        if set_epoch is not None:
            set_epoch(epoch)
        return self.dataset[index]


class _EpochBatches:
    """torch's batch sampler: each iteration is the owning loader's next
    epoch (``DataLoader._batches``).  Lazy, because torch asks for an
    iterator twice when it starts its workers and reads only the second."""

    def __init__(self, loader: "WorkerDataLoader"):
        self._loader = weakref.ref(loader)

    def __len__(self) -> int:
        return len(self._loader())

    def __iter__(self) -> Iterator[List[Tuple[int, int]]]:
        loader = self._loader()
        epoch = loader.epoch
        for batch in loader._batches():
            yield [(epoch, i) for i in batch]


def _stack(items) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batch's stacked arrays as tensors: torch hands tensors from its
    workers through shared memory, where arrays would be pickled through
    a pipe on the consumer's thread."""
    return (torch.from_numpy(np.stack([it[0] for it in items])),
            torch.from_numpy(np.stack([it[1] for it in items])))


def _leave_process_group(worker_id: int) -> None:
    """Worker start: out of the trainer's process group, then SIGTERM
    unblocked.  One that came while blocked is dropped, unless the
    trainer sent it."""
    os.setpgid(0, 0)
    pending = signal.sigtimedwait([signal.SIGTERM], 0)
    if pending is not None and pending.si_pid == os.getppid():
        os.kill(os.getpid(), signal.SIGTERM)    # delivered when unblocked
    signal.pthread_sigmask(signal.SIG_UNBLOCK, [signal.SIGTERM])


@contextlib.contextmanager
def _sigterm_blocked():
    """SIGTERM blocked in this thread: processes spawned meanwhile start
    with it blocked; the trainer receives one that came meanwhile after."""
    old = signal.pthread_sigmask(signal.SIG_BLOCK, [signal.SIGTERM])
    try:
        yield
    finally:
        signal.pthread_sigmask(signal.SIG_SETMASK, old)


class WorkerDataLoader(DataLoader):
    """``DataLoader`` (same arguments, ``__len__``, ``fast_forward``,
    stream) whose items are read and augmented in ``num_workers`` worker
    processes, at most one per batch of an epoch."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._torch = None

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        if self._torch is None:
            self._torch = torch.utils.data.DataLoader(
                _EpochItems(self.dataset), batch_sampler=_EpochBatches(self),
                num_workers=max(1, min(self.num_workers, len(self))),
                collate_fn=_stack, persistent_workers=True,
                multiprocessing_context=multiprocessing.get_context("spawn"),
                generator=torch.Generator().manual_seed(self.seed),
                worker_init_fn=_leave_process_group)
        with _sigterm_blocked():
            batches = iter(self._torch)
        return ((x.numpy(), y.numpy()) for x, y in batches)
