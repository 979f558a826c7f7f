"""The full train state of a phase on disk, for mid-phase resume.

The port's counterpart of the JAX package's ``checkpoints/orbax_io.py``
(Orbax is a JAX library and is not used), with its semantics:

- ``save_train_state`` snapshots the state to host memory in the step
  loop (on the card: a non-blocking copy into pinned buffers, reused from
  one save to the next, and an event the writer waits on) and returns; a
  background thread then writes ``state.pt`` (the tensors) and
  ``meta.json`` (format, step, every tensor's name and shape, the host
  extras) into a temporary directory and renames it onto ``path``.  A
  reader never sees a half-written state: the previous state is renamed
  aside first and dropped after the new one is in place, and a restore
  that finds only the one set aside (a crash between the two renames)
  reads it.
- A new save first waits for the previous one to commit;
  ``wait_for_checkpoints`` waits for the one in flight and raises if its
  commit failed; ``restore_train_state`` waits for it too.
- A state whose names or shapes differ from the template's is refused by
  name, before anything is written.
- Restoring writes into the template in place
  (``TrainState.load_state_dict``).

``last_save_stats()`` reports the last save's bytes, the host
milliseconds it held the step loop and the seconds its commit took.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Dict, List, Optional

import torch

FORMAT = "scaleprotoseg_torch/train_state/v1"
STATE_FILE = "state.pt"
META_FILE = "meta.json"


def _leaves(tree, prefix=""):
    """(key, tensor) leaves of nested dicts and lists, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    elif isinstance(tree, torch.Tensor):
        yield prefix[:-1], tree


def _rebuild(tree, leaves):
    """``tree`` with its tensor leaves replaced, in order, from the
    iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, leaves) for v in tree]
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    return tree


def _signature(state) -> Dict:
    """Names and shapes that a restore must match: every model tensor,
    every trainable parameter of the optimizer."""
    opt = state.optimizer
    return {"model": [[k, list(v.shape)]
                      for k, v in state.model.state_dict().items()],
            "optimizer": [[n, list(p.shape)]
                          for n, p in zip(opt.names, opt.params)]}


class _Writer:
    """One checkpoint in flight at a time, committed by a thread."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pinned: Dict = {}        # (shapes, dtypes) -> host buffers
        self.stats: Dict = {}

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"train state commit failed: {err}") from err

    def _host_copies(self, tensors: List[torch.Tensor]):
        """Host copies of ``tensors`` and the event that marks them
        complete (None when nothing came from the card)."""
        on_card = [t for t in tensors if t.is_cuda]
        if not on_card:
            return [t.detach().clone() for t in tensors], None
        key = tuple((tuple(t.shape), t.dtype) for t in on_card)
        bufs = self._pinned.get(key)
        if bufs is None:
            # one set of buffers, of the last layout saved
            self._pinned = {key: [torch.empty(t.shape, dtype=t.dtype,
                                              pin_memory=True)
                                  for t in on_card]}
            bufs = self._pinned[key]
        it = iter(bufs)
        out = []
        for t in tensors:
            if t.is_cuda:
                buf = next(it)
                buf.copy_(t.detach(), non_blocking=True)
                out.append(buf)
            else:
                out.append(t.detach().clone())
        event = torch.cuda.Event()
        event.record()
        return out, event

    def save(self, path: str, state, block: bool) -> None:
        self.wait()
        t0 = time.perf_counter()
        sd = state.state_dict()
        keyed = list(_leaves(sd))
        host, event = self._host_copies([t for _, t in keyed])
        snapshot = _rebuild(sd, iter(host))
        meta = {"format": FORMAT, "step": int(sd["step"]),
                "extra": sd["extra"], **_signature(state),
                "bytes": sum(t.numel() * t.element_size() for t in host)}
        self.stats = {"bytes": meta["bytes"], "step": meta["step"],
                      "snapshot_ms": 1e3 * (time.perf_counter() - t0)}
        self._thread = threading.Thread(
            target=self._commit, args=(os.path.abspath(path), snapshot,
                                       meta, event),
            name="train-state-commit")
        self._thread.start()
        if block:
            self.wait()

    def _commit(self, path: str, snapshot: Dict, meta: Dict, event) -> None:
        try:
            t0 = time.perf_counter()
            if event is not None:
                event.synchronize()
            tmp = f"{path}.tmp-{os.getpid()}"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(snapshot, os.path.join(tmp, STATE_FILE))
            with open(os.path.join(tmp, META_FILE), "w") as f:
                json.dump(meta, f)
            old = path + ".old"
            shutil.rmtree(old, ignore_errors=True)
            if os.path.isdir(path):
                os.replace(path, old)
            os.replace(tmp, path)
            shutil.rmtree(old, ignore_errors=True)
            self.stats["commit_s"] = time.perf_counter() - t0
        except BaseException as e:  # noqa: BLE001 - reported by wait()
            self._error = e


_WRITER = _Writer()


def save_train_state(path: str, state, block: bool = False) -> None:
    """Snapshot ``state`` (a ``TrainState``) and commit it to the
    directory ``path`` in the background; ``block`` waits for the
    commit."""
    _WRITER.save(path, state, block)


def wait_for_checkpoints() -> None:
    """Wait for the save in flight; raises if its commit failed."""
    _WRITER.wait()


def last_save_stats() -> Dict:
    """The last save's ``bytes``, ``step``, ``snapshot_ms`` (host time
    in the caller) and, once committed, ``commit_s``."""
    return dict(_WRITER.stats)


def _committed(path: str) -> Optional[str]:
    for d in (path, path + ".old"):
        if os.path.isfile(os.path.join(d, META_FILE)):
            return d
    return None


def restore_train_state(path: str, template):
    """Restore the state at ``path`` into ``template`` (a ``TrainState``
    of the same model and phase) in place and return it; None when no
    state was committed there."""
    wait_for_checkpoints()
    d = _committed(os.path.abspath(path))
    if d is None:
        return None
    with open(os.path.join(d, META_FILE)) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{d}: not a train state of this format "
                         f"({meta.get('format')!r})")
    want = _signature(template)
    for part in ("model", "optimizer"):
        have = {n: s for n, s in meta[part]}
        need = {n: s for n, s in want[part]}
        if have != need:
            names = sorted(n for n in set(have) | set(need)
                           if have.get(n) != need.get(n))
            raise ValueError(f"{d}: the saved {part} state does not match "
                             f"this one's names or shapes: {names[:8]}")
    state = torch.load(os.path.join(d, STATE_FILE), map_location="cpu",
                       weights_only=True)
    template.load_state_dict(state)
    return template
