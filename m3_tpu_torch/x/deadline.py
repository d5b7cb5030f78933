"""End-to-end query deadlines + cooperative cancellation: the
counterpart of ``m3_tpu/x/deadline.py``, copied without its wire forms
(socket timeouts, the remaining budget in milliseconds, the wire-error
decoder), since the port has no wire protocol yet.

* :class:`Deadline`: an absolute expiry (monotonic clock) and a
  cooperative cancel flag.  ``remaining()`` is the budget left;
  ``check()`` raises the typed :class:`DeadlineExceeded` (or
  :class:`QueryCancelled`).
* Context propagation: ``bind(dl)`` installs the deadline for the
  current thread of execution (``contextvars``); ``current()`` reads
  it, so a storage's ``fetch_raw`` can consult it with its signature
  unchanged.  Worker threads do not inherit the binding.
* Query annotations: a bound deadline accumulates ``warnings`` and
  per-phase timings (``phase("fetch")``).

Counters (``deadline.exceeded`` / ``deadline.cancelled``) count queries,
not exception objects: one bump per :class:`Deadline` at its first
detection (:meth:`Deadline.exceeded`), never on bare construction.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from typing import Callable, Dict, List

__all__ = [
    "Deadline", "DeadlineExceeded", "QueryCancelled", "bind", "current",
    "check_current", "counters", "reset_counters",
]

_lock = threading.Lock()
_counters: Dict[str, int] = {}


def _bump(key: str) -> None:
    with _lock:
        _counters[key] = _counters.get(key, 0) + 1


def counters() -> Dict[str, int]:
    with _lock:
        return dict(_counters)


def reset_counters() -> None:
    with _lock:
        _counters.clear()


class DeadlineExceeded(RuntimeError):
    """The query's end-to-end budget ran out (HTTP 504).

    Deliberately NOT an ``OSError``/``TimeoutError`` subclass: transport
    handlers (reconnect-and-retry on ``OSError``) and the retry
    classifier must not treat an exhausted budget as a transient
    transport blip — retrying cannot un-expire a deadline.

    Constructing one does NOT bump the counters: ``deadline.exceeded``
    counts QUERIES (once per :class:`Deadline`, at first local
    detection, via :meth:`Deadline.exceeded`), not exception objects —
    a fanout with three stragglers is still one blown deadline, and a
    remote peer's trip decoded off the wire was already counted by the
    peer that detected it."""

    def __init__(self, msg: str = "deadline exceeded"):
        super().__init__(msg)


class QueryCancelled(DeadlineExceeded):
    """Cooperative cancellation observed (client went away / operator
    kill): same control flow as an expired deadline, typed apart for
    logs and counters."""

    def __init__(self, msg: str = "query cancelled"):
        super().__init__(msg)


class Deadline:
    """Absolute expiry + cooperative cancel flag, shared by every stage
    of one query.  Thread-safe: fan-out worker threads check and
    annotate the same instance."""

    __slots__ = ("timeout_s", "_expiry", "_clock", "_cancelled", "_mu",
                 "warnings", "phases", "started", "_counted")

    def __init__(self, timeout_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = float(timeout_s)
        self._clock = clock
        self.started = clock()
        self._expiry = self.started + self.timeout_s
        self._cancelled = False
        self._mu = threading.Lock()
        self._counted = False
        self.warnings: List[str] = []
        self.phases: Dict[str, float] = {}

    @classmethod
    def from_timeout(cls, timeout_s: float, clock=time.monotonic) -> "Deadline":
        return cls(timeout_s, clock)

    # -- budget ------------------------------------------------------------

    def remaining(self) -> float:
        """Seconds left; negative once expired."""
        return self._expiry - self._clock()

    def elapsed(self) -> float:
        return self._clock() - self.started

    @property
    def expired(self) -> bool:
        return self._cancelled or self.remaining() <= 0.0

    def cancel(self) -> None:
        """Cooperative cancel: the next ``check()`` on ANY thread
        sharing this deadline raises ``QueryCancelled``."""
        self._cancelled = True

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    def check(self, what: str = "query") -> None:
        """Raise if cancelled or expired — the cooperative cancellation
        point, cheap enough for per-eval-node / per-loop placement."""
        if self._cancelled:
            raise self.exceeded(f"{what}: cancelled")
        if self.remaining() <= 0.0:
            raise self.exceeded(
                f"{what}: deadline exceeded "
                f"({self.timeout_s:.3f}s budget spent)")

    def exceeded(self, msg: str) -> DeadlineExceeded:
        """The typed error for THIS deadline's expiry/cancellation,
        counted once per deadline no matter how many stages observe it
        (``deadline.exceeded``/``deadline.cancelled`` count queries,
        not exception objects)."""
        with self._mu:
            counted, self._counted = self._counted, True
        if not counted:
            _bump("deadline.cancelled" if self._cancelled
                  else "deadline.exceeded")
        return (QueryCancelled(msg) if self._cancelled
                else DeadlineExceeded(msg))

    # -- annotations -------------------------------------------------------

    def add_warning(self, msg: str) -> None:
        with self._mu:
            self.warnings.append(msg)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Accumulate wall time into ``phases[name]`` (slow-query log
        breakdown: how much of the budget each stage ate)."""
        t0 = self._clock()
        try:
            yield self
        finally:
            dt = self._clock() - t0
            with self._mu:
                self.phases[name] = self.phases.get(name, 0.0) + dt


# -- context propagation ----------------------------------------------------

_current: contextvars.ContextVar[Deadline | None] = contextvars.ContextVar(
    "m3_query_deadline", default=None)


def current() -> Deadline | None:
    """The deadline bound to this thread of execution, or None."""
    return _current.get()


@contextlib.contextmanager
def bind(dl: Deadline | None):
    """Install ``dl`` as the current deadline for the scope.  Binding
    None is a no-op scope (callers need no conditional).  New threads
    never inherit the binding — fan-out workers re-bind explicitly."""
    token = _current.set(dl)
    try:
        yield dl
    finally:
        _current.reset(token)


def check_current(what: str = "query") -> None:
    """``check()`` on the bound deadline, no-op when none is bound —
    the one-liner evaluation loops use between nodes/steps."""
    dl = _current.get()
    if dl is not None:
        dl.check(what)
