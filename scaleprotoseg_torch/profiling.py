"""Timing, tracing and a per-kernel table of a trace.

- ``time_fn`` / ``time_fn_pipelined``: steady-state timing (CUDA events
  on the card, the host clock on the CPU);
- ``trace``: a ``torch.profiler`` context writing a gzipped Chrome trace
  (``*.pt.trace.json.gz``, read by Perfetto and by TensorBoard's PyTorch
  profiler plugin);
- ``flops_estimate``: ``FlopCounterMode``'s count of a call;
- ``StepProfiler``: ``train.profile_steps = N``, one trace of N
  micro-steps of a trainer, each inside a ``STEP_SPAN`` annotation;
- the table: ``load_trace``, ``aggregate`` and ``rollup_categories`` over
  such a trace, and the kernel grouping (``kernel_group``) that
  ``chip_smoke.py``'s profiles use too.

The table's CLI::

    python -m scaleprotoseg_torch.profiling TRACE_DIR [--top 25]
        [--steps-from 1] [--by-category]

reads the newest ``*.pt.trace.json.gz`` under TRACE_DIR (a trainer's
``<run>/profile``) and prints one JSON line per kernel (``op``,
``category``, ``ms_total``, ``ms_per_step``, ``pct``, ``count``; sorted by
time), one per category (``CATEGORY:<name>``) and a ``TOTAL`` line:
``n_steps_traced``, ``device_ms_per_step`` (the kernels', copies' and
memsets' summed time), ``wall_ms_per_step`` (from the first kept step's
start to the end of the last step's work) and ``idle_share`` (1 - the
union of the device intervals over that wall time).  A device event
belongs to the step whose span launched it (CUDA runtime correlation);
``--steps-from`` drops the first steps.  A trainer's trace starts three
micro-steps into its phase, past the warm-up, so ``--steps-from 0`` reads
all of it.  A trace with no device event (a CPU run) is tabled from its
outermost CPU operators instead, and its ``TOTAL`` says so
(``"timeline": "cpu"``, ``cpu_op_ms_per_step``, ``cpu_idle_share``).
A torch trace carries no operation or byte counts, so the lines have
none.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import glob
import gzip
import json
import os
import shutil
import socket
import time
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional

import torch

STEP_SPAN = "scaleprotoseg::train_step"
TRACE_SUFFIX = ".pt.trace.json.gz"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
WARMUP_STEPS = 3        # a trainer's trace starts this many steps in

# Kernel groups: a kernel whose lower-cased name holds one of a tuple's
# names is in that group, else in the conv/GEMM, elementwise or other one
SERVING_GROUPS = ("aspp_kernel", "proto_kernel", "upsample_argmax_kernel",
                  "conv", "batch_norm", "elementwise", "other")
QUANT_GROUPS = ("int8_gemm_kernel", "int8_conv3x3_kernel", "quantize_kernel",
                "absmax") + SERVING_GROUPS
TRAINING_GROUPS = ("aspp_kernel", "aspp_grad_pack_kernel",
                   "aspp_grad_weight_kernel", "split_sum_kernel", "adam",
                   "conv", "batch_norm", "elementwise", "other")
ALL_GROUPS = tuple(dict.fromkeys(TRAINING_GROUPS[:5] + QUANT_GROUPS))
_CONV_TOKENS = ("conv", "gemm", "xmma", "fprop", "dgrad", "wgrad", "cutlass",
                "nvjet")


def kernel_group(name: str, groups: Iterable[str] = ALL_GROUPS) -> str:
    low = name.lower()
    hit = next((g for g in groups if g in low), None)
    if hit is not None:
        return hit
    if any(t in low for t in _CONV_TOKENS):
        return "conv"
    return "elementwise" if "elementwise" in low else "other"


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def sync(x=None) -> None:
    """Wait for the card's work on ``x``'s device (every tensor of a
    tuple, list or dict); nothing on the CPU."""
    if isinstance(x, dict):
        x = list(x.values())
    leaves = x if isinstance(x, (list, tuple)) else [x]
    devs = {t.device for t in leaves if isinstance(t, torch.Tensor)
            and t.device.type == "cuda"}
    if x is None and torch.cuda.is_available():
        devs = {torch.device("cuda", torch.cuda.current_device())}
    for d in devs:
        torch.cuda.synchronize(d)


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2,
            **kwargs) -> Dict[str, float]:
    """{'mean_s', 'p50_s', 'best_s', 'iters_per_s'} of ``fn(*args)``:
    one call, ``warmup`` more, then ``iters`` timed one by one (CUDA
    events around each when an argument is on the card, the host clock
    after ``sync`` otherwise)."""
    sync(fn(*args, **kwargs))
    for _ in range(warmup):
        sync(fn(*args, **kwargs))
    times = []
    cuda = any(isinstance(a, torch.Tensor) and a.device.type == "cuda"
               for a in args)
    for _ in range(iters):
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn(*args, **kwargs)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 1e3)
        else:
            t0 = time.perf_counter()
            sync(fn(*args, **kwargs))
            times.append(time.perf_counter() - t0)
    times.sort()
    mean = sum(times) / len(times)
    return {"mean_s": mean, "p50_s": times[len(times) // 2],
            "best_s": times[0], "iters_per_s": 1.0 / mean}


def time_fn_pipelined(fn: Callable, *args, iters: int = 10,
                      **kwargs) -> float:
    """Calls a second with the launches pipelined: ``iters`` calls, one
    sync at the end."""
    sync(fn(*args, **kwargs))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(*args, **kwargs)
    sync(out)
    return iters / (time.perf_counter() - t0)


def flops_estimate(fn: Callable, *args) -> Optional[float]:
    """The floating-point operations ``FlopCounterMode`` counts in
    ``fn(*args)``, or None where it counts none."""
    from torch.utils.flop_counter import FlopCounterMode
    try:
        with FlopCounterMode(display=False) as counter:
            fn(*args)
        return float(counter.get_total_flops()) or None
    except Exception:
        return None


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------
def _activities(cuda: bool) -> list:
    from torch.profiler import ProfilerActivity
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])


def write_trace(prof, log_dir: str) -> str:
    """``prof``'s Chrome trace, gzipped, as ``<host>_<pid>.<ns>`` +
    ``TRACE_SUFFIX`` under ``log_dir``; written under a temporary name
    and renamed, so no half-written trace is ever left there."""
    os.makedirs(log_dir, exist_ok=True)
    stem = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}"
    tmp = os.path.join(log_dir, f".{stem}.partial")
    try:
        prof.export_chrome_trace(tmp + ".json")
        with open(tmp + ".json", "rb") as src, \
                gzip.open(tmp + ".gz", "wb", compresslevel=3) as dst:
            shutil.copyfileobj(src, dst)
        path = os.path.join(log_dir, stem + TRACE_SUFFIX)
        os.replace(tmp + ".gz", path)
        return path
    finally:
        for leftover in (tmp + ".json", tmp + ".gz"):
            if os.path.exists(leftover):
                os.remove(leftover)


@contextlib.contextmanager
def trace(log_dir: str, cuda: Optional[bool] = None):
    """Profile the block (CPU activity, and CUDA where there is a card)
    and write its trace under ``log_dir`` on exit."""
    from torch.profiler import profile
    if cuda is None:
        cuda = torch.cuda.is_available()
    with profile(activities=_activities(cuda)) as prof:
        yield log_dir
        sync()
    write_trace(prof, log_dir)


class StepProfiler:
    """``train.profile_steps = n``: one trace of ``n`` micro-steps per
    trainer, started ``WARMUP_STEPS`` micro-steps into a phase (from its
    restored step on a resume) and written to ``out_dir``.  As in the
    JAX package it traces once per ``PhaseTrainer``, in the first phase
    that reaches its start; a phase that ends mid-trace ends the trace.
    Each micro-step of the window runs inside ``span()``, a
    ``STEP_SPAN`` annotation (outside the window ``span()`` is a null
    context)."""

    def __init__(self, n_steps: int, out_dir: str, device: torch.device,
                 log=print):
        self.n_steps = int(n_steps or 0)
        self.out_dir = out_dir
        self.cuda = device.type == "cuda"
        self.log = log
        self.done = False
        self._prof = None
        self._until = 0

    @property
    def active(self) -> bool:
        return self._prof is not None

    def begin(self, step: int, steps0: int) -> None:
        """Before micro-step ``step + 1`` of a phase that started at
        ``steps0``."""
        if not self.n_steps or self.done or self.active or \
                step != steps0 + WARMUP_STEPS:
            return
        from torch.profiler import profile
        self._prof = profile(activities=_activities(self.cuda))
        self._prof.start()
        self._until = step + self.n_steps
        self.log(f"profiling steps {step + 1}..{self._until} -> "
                 f"{self.out_dir}")

    def span(self):
        if self._prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(STEP_SPAN)

    def due(self, step: int) -> bool:
        """True after the window's last micro-step."""
        return self.active and step >= self._until

    def stop(self) -> None:
        """End the trace (no-op when none runs) and write it."""
        if self._prof is None:
            return
        prof, self._prof, self.done = self._prof, None, True
        sync()
        prof.stop()
        path = write_trace(prof, self.out_dir)
        self.log(f"profiler trace written: {path}")

    def discard(self) -> None:
        """End the trace without writing it (an interrupted phase)."""
        if self._prof is None:
            return
        prof, self._prof, self.done = self._prof, None, True
        prof.stop()
        self.log("profiler trace discarded: the phase was interrupted")


# ---------------------------------------------------------------------------
# the table
# ---------------------------------------------------------------------------
def load_trace(trace_dir: str) -> dict:
    """The newest ``*.pt.trace.json.gz`` under ``trace_dir`` (or the file
    itself)."""
    if os.path.isfile(trace_dir):
        paths = [trace_dir]
    else:
        paths = glob.glob(os.path.join(trace_dir, "**", "*" + TRACE_SUFFIX),
                          recursive=True)
    if not paths:
        raise FileNotFoundError(f"no *{TRACE_SUFFIX} under {trace_dir}")
    with gzip.open(max(paths, key=os.path.getmtime), "rt") as f:
        return json.load(f)


def _outermost(events: List[dict]) -> List[dict]:
    """The events not inside another of ``events`` on their thread."""
    out = []
    ends = {}
    for e in sorted(events, key=lambda e: (e["ts"], -e.get("dur", 0))):
        key = (e.get("pid"), e.get("tid"))
        if e["ts"] >= ends.get(key, float("-inf")):
            out.append(e)
            ends[key] = e["ts"] + e.get("dur", 0)
    return out


def _union_us(intervals: List[tuple]) -> float:
    total, cur_lo, cur_hi = 0.0, None, None
    for lo, hi in sorted(intervals):
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        total += cur_hi - cur_lo
    return total


def aggregate(d: dict, steps_from: int = 1):
    """(per-op groups {name: {"us", "count", "category"}}, summary) of a
    torch Chrome trace; see the module docstring."""
    events = [e for e in d.get("traceEvents", []) if e.get("ph") == "X"]
    steps = sorted((e for e in events if e.get("name") == STEP_SPAN
                    and e.get("cat") == "user_annotation"),
                   key=lambda e: e["ts"])
    if steps_from > 0 and len(steps) > steps_from:
        steps = steps[steps_from:]
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    timeline = "device" if device else "cpu"
    if device:
        launched = {e["args"]["correlation"]: e["ts"] for e in events
                    if e.get("cat") in LAUNCH_CATEGORIES
                    and "correlation" in e.get("args", {})}
        ops = [(launched.get(e.get("args", {}).get("correlation"), e["ts"]),
                e) for e in device]
    else:
        # the steps' own thread (a CPU backward runs on it): loader
        # threads' operators overlap the spans without being the step's
        tids = {s.get("tid") for s in steps}
        ops = [(e["ts"], e) for e in _outermost(
            [e for e in events if e.get("cat") == "cpu_op"
             and (not steps or e.get("tid") in tids)])]
    starts = [s["ts"] for s in steps]

    def step_of(t: float) -> Optional[int]:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= steps[i]["ts"] + steps[i]["dur"]:
            return i
        return None

    kept = [e for t, e in ops if not steps or step_of(t) is not None]
    out = defaultdict(lambda: {"us": 0.0, "count": 0, "category": ""})
    for e in kept:
        g = out[e.get("name", "?")]
        g["us"] += float(e.get("dur", 0))
        g["count"] += 1
        g["category"] = kernel_group(e.get("name", "?"))
    n_steps = max(len(steps), 1)
    if steps:
        lo = steps[0]["ts"]
        hi = max([s["ts"] + s["dur"] for s in steps] +
                 [e["ts"] + e.get("dur", 0) for e in kept])
    elif kept:
        lo = min(e["ts"] for e in kept)
        hi = max(e["ts"] + e.get("dur", 0) for e in kept)
    else:
        lo = hi = 0.0
    busy = _union_us([(e["ts"], e["ts"] + e.get("dur", 0)) for e in kept])
    summary = dict(timeline=timeline, n_steps=n_steps,
                   total_us=sum(g["us"] for g in out.values()),
                   wall_us=hi - lo,
                   idle_share=1.0 - busy / (hi - lo) if hi > lo else None)
    return dict(out), summary


def rollup_categories(groups: Dict[str, dict]) -> Dict[str, dict]:
    """Per-op groups summed by category."""
    cats = defaultdict(lambda: {"us": 0.0, "count": 0, "category": ""})
    for g in groups.values():
        c = cats[g["category"]]
        c["us"] += g["us"]
        c["count"] += g["count"]
        c["category"] = g["category"]
    return dict(cats)


def table_lines(d: dict, top: int = 25, steps_from: int = 1,
                by_category: bool = False) -> List[dict]:
    """What the CLI prints, one dict per line."""
    groups, s = aggregate(d, steps_from)
    n, total = s["n_steps"], s["total_us"]

    def line(key, g):
        ms = g["us"] / 1e3
        return {"op": key[:160], "category": g["category"],
                "ms_total": round(ms, 4), "ms_per_step": round(ms / n, 4),
                "pct": round(100 * g["us"] / total, 2) if total else 0.0,
                "count": g["count"]}

    out = []
    if not by_category:
        out += [line(k, g) for k, g in sorted(
            groups.items(), key=lambda kv: -kv[1]["us"])[:top]]
    for k, c in sorted(rollup_categories(groups).items(),
                       key=lambda kv: -kv[1]["us"]):
        out.append(dict(line(k, c), op=f"CATEGORY:{k}"))
    gpu = s["timeline"] == "device"
    idle = None if s["idle_share"] is None else round(s["idle_share"], 4)
    out.append({
        "op": "TOTAL", "timeline": s["timeline"], "n_steps_traced": n,
        "device_ms_per_step" if gpu else "cpu_op_ms_per_step":
            round(total / 1e3 / n, 4),
        "wall_ms_per_step": round(s["wall_us"] / 1e3 / n, 4),
        "idle_share" if gpu else "cpu_idle_share": idle})
    return out


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(
        description="Per-kernel table of a torch profiler trace")
    p.add_argument("trace_dir")
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--steps-from", type=int, default=1,
                   help="drop the first steps (warm-up)")
    p.add_argument("--by-category", action="store_true",
                   help="print only the category rollup and the total")
    a = p.parse_args(argv)
    for rec in table_lines(load_trace(a.trace_dir), a.top, a.steps_from,
                           a.by_category):
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
