"""Pipelined streaming inference: overlap host IO with device compute.

Three stages run concurrently:

  1. decode/preprocess in host threads, a lookahead window ahead;
  2. device compute: each batch is stacked into a pinned host buffer,
     copied with ``non_blocking=True`` and the forward is enqueued; CUDA
     runs it asynchronously while the host moves on;
  3. result fetch: the copy back of batch *i* is queued (``non_blocking``
     into pinned memory) right behind its forward, and the host waits for
     it only after batch *i+1* has been dispatched, so the device always
     has the next batch queued while the host takes the results.

Batches are fixed-size: the tail is padded by repeating the last item and
trimmed after the fetch.  Results come back in input order.

On the card each batch's stream work (input copy, forward, result copy)
sits between two timing events; ``device_seconds`` adds up those spans as
the batches are fetched, so the device's idle share of a run is
``1 - device_seconds / wall seconds``.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from scaleprotoseg_torch.device import resolve_device


class ServingEngine:
    """Drive ``predict(batch) -> device tensor`` over a stream of items.

    Args:
      predict: batched forward on ``device``; must not synchronize.
      batch_size: fixed device batch.
      preprocess: item -> (H, W, 3) array, run in host threads (``None``:
        items already are arrays).
      workers: preprocess thread count.
      device: where ``predict`` runs (default ``cuda``, an error without
        a card); host batches are pinned for CUDA.
    """

    # dispatched-but-unfetched batches: 2 takes batch i's results while
    # batch i+1 runs
    MAX_INFLIGHT = 2

    def __init__(self, predict: Callable[[torch.Tensor], torch.Tensor],
                 batch_size: int,
                 preprocess: Optional[Callable[[Any], np.ndarray]] = None,
                 workers: int = 2,
                 device: Optional[Union[str, torch.device]] = None):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.predict = predict
        self.batch_size = batch_size
        self.preprocess = preprocess
        self.workers = max(1, workers)
        self.device = resolve_device(device)
        self.device_seconds = 0.0   # stream time of the fetched batches

    def _dispatch(self, arrs):
        """Enqueue one batch; returns (host output, (start, done) events
        or None)."""
        host = torch.from_numpy(np.stack(arrs))
        if self.device.type != "cuda":
            return self.predict(host.to(self.device)), None
        host = host.pin_memory()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        x = host.to(self.device, non_blocking=True)
        out = self.predict(x).to("cpu", non_blocking=True)
        done = torch.cuda.Event(enable_timing=True)
        done.record()
        return out, (start, done)

    def run(self, items: Iterable[Tuple[str, Any]]
            ) -> Iterator[Tuple[str, np.ndarray]]:
        """Yield ``(key, prediction)`` in input order; predictions are
        host numpy arrays (one item of the batched output each)."""
        B = self.batch_size
        prep = self.preprocess or (lambda raw: np.asarray(raw))
        inflight: deque = deque()   # (keys, n_valid, host_out, events)

        def flush_oldest():
            keys, n, out, events = inflight.popleft()
            if events is not None:
                start, done = events
                done.synchronize()
                self.device_seconds += start.elapsed_time(done) / 1e3
            host = out.numpy()
            for i, key in enumerate(keys[:n]):
                yield key, host[i]

        with ThreadPoolExecutor(self.workers) as pool:
            it = iter(items)
            window: deque = deque()   # (key, future) lookahead
            lookahead = B * (self.MAX_INFLIGHT + 1)

            def refill():
                while len(window) < lookahead:
                    nxt = next(it, None)
                    if nxt is None:
                        return
                    key, raw = nxt
                    window.append((key, pool.submit(prep, raw)))

            refill()
            while window:
                keys, arrs = [], []
                while window and len(arrs) < B:
                    key, fut = window.popleft()
                    keys.append(key)
                    arrs.append(fut.result())
                refill()
                n_valid = len(arrs)
                while len(arrs) < B:          # tail padding
                    arrs.append(arrs[-1])
                # at most MAX_INFLIGHT batches stay queued: the oldest is
                # taken before the next dispatch, while the newer one runs
                if len(inflight) >= self.MAX_INFLIGHT:
                    yield from flush_oldest()
                inflight.append((keys, n_valid, *self._dispatch(arrs)))
            while inflight:
                yield from flush_oldest()
