"""Preemption-safe training: checkpoint on SIGTERM and exit cleanly.

A copy of ``bts_tpu/training/preempt.py`` (no reference equivalent: the
reference's only recovery is a manual resume from the last periodic
checkpoint). Spot and preemptible machines deliver SIGTERM with a grace
window before eviction; catching it lets the train loop finish the
in-flight step, write a normal `model-{step}` checkpoint and return, so a
rescheduled job resumes with no lost work instead of up to `save_freq`
steps.
"""

from __future__ import annotations

import signal
import threading
from typing import Iterable


class PreemptionGuard:
    """Latches termination signals; the train loop polls `requested`.

    Installs handlers for `signals` (default SIGTERM only — SIGINT keeps
    its KeyboardInterrupt semantics for interactive use). Handler
    installation only works in the main thread; elsewhere (e.g. a loop
    driven from a worker thread) the guard degrades to an inert flag
    rather than raising. Use as a context manager to restore the previous
    handlers.
    """

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._previous = {}
        self._event = threading.Event()
        self.signal_received = None

    def _handle(self, signum, frame):
        self.signal_received = signum
        self._event.set()

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def __enter__(self) -> "PreemptionGuard":
        for s in self._signals:
            try:
                self._previous[s] = signal.signal(s, self._handle)
            except ValueError:  # not in the main thread
                pass
        return self

    def __exit__(self, *exc):
        for s, old in self._previous.items():
            signal.signal(s, old)
        self._previous.clear()
        return False
