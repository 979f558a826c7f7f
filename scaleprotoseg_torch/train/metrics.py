"""Metric accumulation, bulk fetching and CSV/JSONL logging.

Metric names match the JAX package and the reference
(``train_/val_{loss,cross_entropy,kld_loss,...}``, ``val_accuracy``,
``avg_dist_proto``, ``training_stage``).  The external sinks of the JAX
package (TensorBoard, W&B) are not ported: ``MetricsLogger`` writes
``<run>/metrics.jsonl`` and ``<run>/metrics.csv`` only, and asking for
W&B (``USE_WANDB=1``) is refused.
"""

from __future__ import annotations

import csv
import json
import os
import statistics
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch


class MetricAccumulator:
    """Running sums of per-batch metrics: means per batch, and the
    accuracy from the summed ``n_correct`` / ``n_patches``."""

    def __init__(self):
        self.reset()

    def reset(self):
        """Clear in place (a ``BulkFetcher`` holds ``update``)."""
        self.sums = defaultdict(float)
        self.n_batches = 0
        self.n_correct = 0.0
        self.n_patches = 0.0

    def update(self, metrics: Dict[str, float]):
        for k, v in metrics.items():
            v = float(v)
            if k == "n_correct":
                self.n_correct += v
            elif k == "n_patches":
                self.n_patches += v
            else:
                self.sums[k] += v
        self.n_batches += 1

    def summary(self) -> Dict[str, float]:
        out = {k: v / max(self.n_batches, 1) for k, v in self.sums.items()}
        if self.n_patches > 0:
            out["accuracy"] = self.n_correct / self.n_patches
        return out


class BulkFetcher:
    """Holds per-step metric dicts of device scalars and copies them to
    the host ``limit`` steps at a time, in one transfer, so the training
    loop never waits for the card on a single step's numbers."""

    def __init__(self, sink: Callable[[Dict[str, float]], None],
                 limit: int = 32):
        self.sink = sink
        self.limit = limit
        self._pending: List[Dict[str, torch.Tensor]] = []

    def add(self, metrics: Dict[str, torch.Tensor]) -> None:
        self._pending.append(metrics)
        if len(self._pending) >= self.limit:
            self.drain()

    def drain(self) -> List[Dict[str, float]]:
        """Fetch everything held; returns the host dicts, in order."""
        if not self._pending:
            return []
        keys = list(self._pending[0])
        host = torch.stack([torch.stack([m[k].float() for k in keys])
                            for m in self._pending]).cpu().tolist()
        self._pending = []
        out = [dict(zip(keys, row)) for row in host]
        for m in out:
            self.sink(m)
        return out


class StepTimer:
    """Training throughput and the device's idle share, steps past the
    first ``skip`` (compile, autotune and allocation warm-up).

    On the card each step's stream work sits between two CUDA events; a
    timed window runs from the host clock at its first step to the host
    clock after the sync that closes it (``close``: the bulk fetch before
    a validation, or the phase end), so validation is not in it.  The
    idle share is ``1 - sum of step spans / window seconds``: the time
    the card waited between steps, for the loader or the host."""

    def __init__(self, device: torch.device, skip: int = 3):
        self.cuda = device.type == "cuda"
        self.skip = skip
        self.seen = 0
        self.spans: List = []      # (start, end) events or host seconds
        self.window_s = 0.0
        self._open: Optional[float] = None
        self._t0 = 0.0

    def begin(self) -> None:
        self.seen += 1
        if self.seen <= self.skip:
            return
        if self._open is None:
            self._open = time.perf_counter()
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.spans.append([ev, None])
        else:
            self._t0 = time.perf_counter()

    def end(self) -> None:
        if self.seen <= self.skip:
            return
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.spans[-1][1] = ev
        else:
            self.spans.append(time.perf_counter() - self._t0)

    def close(self) -> None:
        """End the open window; the caller has just synchronized."""
        if self._open is not None:
            if self.cuda:
                torch.cuda.synchronize()
            self.window_s += time.perf_counter() - self._open
            self._open = None

    def summary(self, batch_size: int) -> Dict[str, Optional[float]]:
        self.close()
        ms = [a.elapsed_time(b) for a, b in self.spans] if self.cuda \
            else [1e3 * t for t in self.spans]
        n = len(ms)
        return {"steps_timed": n,
                "img_per_s": n * batch_size / self.window_s
                if self.window_s else None,
                "step_ms_median": statistics.median(ms) if ms else None,
                "device_idle_share": 1.0 - sum(ms) / 1e3 / self.window_s
                if self.cuda and self.window_s else None}


class MetricsLogger:
    def __init__(self, model_dir: str, run_name: str = "metrics"):
        if os.environ.get("USE_WANDB", "0") not in ("", "0"):
            raise NotImplementedError("the W&B sink is not ported yet; "
                                      "unset USE_WANDB")
        os.makedirs(model_dir, exist_ok=True)
        self.jsonl_path = os.path.join(model_dir, f"{run_name}.jsonl")
        self.csv_path = os.path.join(model_dir, f"{run_name}.csv")
        self._csv_fields = None

    def log(self, metrics: Dict[str, float], step: int):
        record = {"step": int(step), "time": time.time(),
                  **{k: float(v) for k, v in metrics.items()}}
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        fields = sorted(record)
        write_header = self._csv_fields != fields or \
            not os.path.exists(self.csv_path)
        self._csv_fields = fields
        with open(self.csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fields, extrasaction="ignore")
            if write_header:
                w.writeheader()
            w.writerow(record)


def create_logger(log_file: str = None):
    """Line logger to stdout and, when given, ``log_file``."""

    def log(msg):
        line = f"[{time.strftime('%Y-%m-%d %H:%M:%S')}] {msg}"
        print(line, flush=True)
        if log_file:
            with open(log_file, "a") as fh:
                fh.write(line + "\n")

    return log
