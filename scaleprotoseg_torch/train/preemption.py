"""SIGTERM -> commit the train state at the next step boundary -> exit 143.

Schedulers send SIGTERM shortly before they evict a job.  The guard's
handler sets a flag; ``PhaseTrainer.run_phase`` reads it after every
micro-step, commits the full train state (``checkpoints/state_io.py``)
and raises ``Preempted``.  Relaunching the same command resumes the phase
where it stopped, bit for bit (``tests/test_torch_resume.py``).

One process only: the multi-process agreement on a common step, which
the JAX package takes from its preemption sync service, comes with the
port's data-parallel trainer.
"""

from __future__ import annotations

import signal
import threading
from typing import Optional


class Preempted(SystemExit):
    """Raised after the preemption checkpoint has committed: a
    ``SystemExit`` with code 143 (128 + SIGTERM), so that an entry point
    exits the way schedulers expect, without a traceback."""

    def __init__(self, step: int):
        super().__init__(143)
        self.step = step

    def __str__(self):
        return f"preempted at step {self.step} (state checkpointed)"


class PreemptionGuard:
    """The process's SIGTERM flag (use ``get_guard``).  The handler is
    installed only from the main thread (Python's signal API); it chains
    the handler installed before it."""

    def __init__(self, log=print):
        self._flag = False
        self._log = log
        self._prev = None
        if threading.current_thread() is threading.main_thread():
            self._prev = signal.getsignal(signal.SIGTERM)
            signal.signal(signal.SIGTERM, self._on_sigterm)
        else:
            log("PreemptionGuard: not in the main thread; SIGTERM does not "
                "checkpoint")

    def _on_sigterm(self, signum, frame):
        self._flag = True
        self._log("SIGTERM received: committing the train state at the "
                  "next step boundary, then exiting 143")
        # another component's cleanup (a sink flushing its buffers) still
        # runs
        prev = self._prev
        if callable(prev) and prev is not signal.default_int_handler:
            prev(signum, frame)

    def should_stop(self, step: int) -> bool:
        """True once a SIGTERM has arrived; ``step`` is the global step
        (the multi-process agreement will pick a common one)."""
        return self._flag


_guard: Optional[PreemptionGuard] = None


def get_guard(log=print) -> PreemptionGuard:
    """The process's guard; the first call installs the handler."""
    global _guard
    if _guard is None:
        _guard = PreemptionGuard(log=log)
    return _guard
