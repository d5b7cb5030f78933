"""Admission control: bounded concurrent-query slots + a bounded wait
The port's copy of ``m3_tpu/x/admission.py`` (it imports nothing of ``m3_tpu``).
queue with queue timeout.

The read-path twin of the ingest load-shed (``INGEST_BACKOFF``):
under overload the query front door sheds EARLY with a typed
:class:`QueryShedError` (HTTP 503 + Retry-After) instead of queueing
unboundedly until every thread is wedged behind slow storage — the
degrade-predictably contract of the reference's per-query limits and
coordinator concurrency gates.

Shape: ``max_concurrent`` slots; up to ``max_queue`` callers may wait
``queue_timeout_s`` for a slot (bounded by the query's own deadline —
no point waiting longer than the caller will exist); everyone else is
shed immediately.  ``admit()`` is a context manager so release is
exception-safe; gauges/counters (`active`, `waiting`, `shed_total`,
`admitted_total`, `queue_timeout_total`) are mirrored onto /metrics by
the server assembly (``query_active``, ``query_shed_total``) and
asserted by the overload dtest's burst scenario.
"""

from __future__ import annotations

import contextlib
import threading
import time


class QueryShedError(RuntimeError):
    """Admission denied: the node is at its concurrent-query capacity
    and the wait queue is full (or the wait timed out).  The HTTP layer
    maps this to 503 with ``Retry-After: ceil(retry_after_s)``."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class AdmissionController:
    """Semaphore-gated query slots with a bounded, timed wait queue.

    ``max_concurrent <= 0`` disables gating entirely (the limits-style
    "0 = off" convention) — ``admit()`` is then a free no-op scope."""

    def __init__(self, max_concurrent: int = 0, max_queue: int = 0,
                 queue_timeout_s: float = 1.0,
                 clock=time.monotonic):
        self.max_concurrent = int(max_concurrent)
        self.max_queue = int(max_queue)
        self.queue_timeout_s = float(queue_timeout_s)
        self._clock = clock
        self._cv = threading.Condition(threading.Lock())
        self._active = 0
        self._waiting = 0
        self.admitted_total = 0
        self.shed_total = 0
        self.queue_timeout_total = 0

    # -- observability -----------------------------------------------------

    @property
    def active(self) -> int:
        return self._active

    @property
    def waiting(self) -> int:
        return self._waiting

    def metrics(self) -> dict:
        with self._cv:
            return {
                "active": self._active,
                "waiting": self._waiting,
                "admitted_total": self.admitted_total,
                "shed_total": self.shed_total,
                "queue_timeout_total": self.queue_timeout_total,
                "max_concurrent": self.max_concurrent,
                "max_queue": self.max_queue,
            }

    # -- live resize (the self-healing actuator seam) ----------------------

    def resize(self, max_concurrent: int | None = None,
               max_queue: int | None = None) -> dict:
        """Live-retune capacity (the x/controller actuator seam).

        Takes effect for the NEXT admit: active holders keep their
        slots (shrinking never evicts — the count drains naturally),
        and growing wakes every queued waiter so freed headroom is
        claimed immediately.  Returns the post-resize metrics doc."""
        with self._cv:
            if max_concurrent is not None:
                self.max_concurrent = int(max_concurrent)
            if max_queue is not None:
                self.max_queue = int(max_queue)
            self._cv.notify_all()
        return self.metrics()

    # -- gate --------------------------------------------------------------

    @contextlib.contextmanager
    def admit(self, deadline=None):
        """Hold one query slot for the scope.  Raises
        :class:`QueryShedError` when the node is saturated; waits at
        most ``queue_timeout_s`` (and never past ``deadline``) for a
        slot when the queue has room."""
        if self.max_concurrent <= 0:
            yield self
            return
        self._acquire(deadline)
        try:
            yield self
        finally:
            self._release()

    def _acquire(self, deadline) -> None:
        with self._cv:
            if self._active < self.max_concurrent:
                self._active += 1
                self.admitted_total += 1
                return
            if self._waiting >= self.max_queue:
                self.shed_total += 1
                raise QueryShedError(
                    f"query shed: {self._active} active, "
                    f"{self._waiting} queued (capacity "
                    f"{self.max_concurrent}+{self.max_queue})",
                    retry_after_s=self.queue_timeout_s)
            budget = self.queue_timeout_s
            if deadline is not None:
                budget = min(budget, deadline.remaining())
            expiry = self._clock() + budget
            self._waiting += 1
            try:
                while self._active >= self.max_concurrent:
                    wait = expiry - self._clock()
                    if wait <= 0.0:
                        self.shed_total += 1
                        self.queue_timeout_total += 1
                        raise QueryShedError(
                            f"query shed: queued {budget:.3f}s without "
                            f"a free slot ({self.max_concurrent} busy)",
                            retry_after_s=self.queue_timeout_s)
                    self._cv.wait(wait)
                self._active += 1
                self.admitted_total += 1
            finally:
                self._waiting -= 1

    def _release(self) -> None:
        with self._cv:
            self._active -= 1
            self._cv.notify()
