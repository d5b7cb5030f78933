"""Retry with exponential backoff, jitter, attempt caps and budgets.
The port's copy of ``m3_tpu/x/retry.py`` (it imports nothing of ``m3_tpu``).

Equivalent of the reference's ``src/x/retry`` (``retry.go``: initial/max
backoff, backoff factor, jitter, max retries, forever, a retryable
classifier) plus its shared retry *budget* — the M3 production stance
that every network edge retries transient failures, but the aggregate
retry volume is bounded so a dying dependency cannot amplify load.

Design points for this tree:

* **Pure math first** — :meth:`Retrier.backoff_for` is a deterministic
  function of (attempt, rng) so tests pin the schedule without sleeping;
  the clock and sleep are injectable everywhere.
* **Classifier default** — transport failures only (``ConnectionError``,
  ``TimeoutError``, other ``OSError``).  Application errors (CAS
  conflicts as ``ValueError``, ``RemoteError`` as ``RuntimeError``)
  never retry: the reference's ``xerrors.IsRetryableError`` contract.
* **Budget** — a token bucket shared across retriers if desired: each
  retry consumes one token; an empty bucket fails fast instead of
  stacking backoff sleeps on a dead peer.
* **Counters** — per-retrier-name module counters (attempts, retries,
  successes, exhausted, budget_exhausted, not_retryable), mirrored into
  a node's instrument registry by ``m3_tpu_torch.x.register_metrics`` and
  asserted by the dtest scenarios.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict

__all__ = ["RetryOptions", "RetryBudget", "Retrier", "default_retryable",
           "counters", "reset_counters"]


def default_retryable(e: BaseException) -> bool:
    """Transport-shaped failures only.  ``ProtocolError`` and
    ``FaultInjected`` subclass ``ConnectionError`` so they match."""
    return isinstance(e, (ConnectionError, TimeoutError, OSError))


@dataclass(frozen=True)
class RetryOptions:
    """Reference ``retry.Options`` surface (retry.go:40-78)."""

    initial_backoff_s: float = 0.05
    backoff_factor: float = 2.0
    max_backoff_s: float = 5.0
    max_attempts: int = 4        # total attempts including the first
    forever: bool = False
    jitter: bool = True          # uniform in [backoff/2, backoff]


class RetryBudget:
    """Token bucket bounding aggregate retry volume (x/retry budget
    role).  ``allow()`` refills by elapsed time and consumes one token;
    False means the retry is denied and the caller fails fast."""

    def __init__(self, capacity: float = 16.0, refill_per_s: float = 4.0,
                 clock: Callable[[], float] = time.monotonic):
        self.capacity = float(capacity)
        self.refill_per_s = float(refill_per_s)
        self._tokens = float(capacity)
        self._clock = clock
        self._last = clock()
        self._lock = threading.Lock()

    def allow(self) -> bool:
        with self._lock:
            now = self._clock()
            self._tokens = min(
                self.capacity,
                self._tokens + (now - self._last) * self.refill_per_s)
            self._last = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    @property
    def tokens(self) -> float:
        return self._tokens


_lock = threading.Lock()
_counters: Dict[str, int] = {}


def _bump(name: str, key: str, delta: int = 1) -> None:
    with _lock:
        k = f"{name}.{key}"
        _counters[k] = _counters.get(k, 0) + delta


def counters() -> Dict[str, int]:
    with _lock:
        return dict(_counters)


def reset_counters() -> None:
    with _lock:
        _counters.clear()


class Retrier:
    """``run(fn)`` calls ``fn`` until it returns, raises a
    non-retryable error, or the policy is exhausted (last error
    re-raised).  One Retrier is safe for concurrent use."""

    def __init__(self, opts: RetryOptions = RetryOptions(),
                 name: str = "default",
                 is_retryable: Callable[[BaseException], bool] | None = None,
                 budget: RetryBudget | None = None,
                 sleep: Callable[[float], None] = time.sleep,
                 seed: int | None = None):
        self.opts = opts
        self.name = name
        self.is_retryable = is_retryable or default_retryable
        self.budget = budget
        self._sleep = sleep
        # Seeded rng -> reproducible jitter schedules in tests; the
        # default stays wall-entropy like the reference.
        self._rng = random.Random(seed)
        self._rng_lock = threading.Lock()

    def backoff_for(self, retry_index: int) -> float:
        """Backoff before retry number ``retry_index`` (1-based): pure
        ``initial * factor**(i-1)`` capped at max, jittered to
        [backoff/2, backoff] when enabled (retry.go:150-170)."""
        if retry_index < 1:
            return 0.0
        # Exponent capped BEFORE exponentiation: an unbounded caller
        # (e.g. a reconnect loop counting failed rounds for hours)
        # must asymptote to max_backoff_s, not overflow float pow.
        b = self.opts.initial_backoff_s * (
            self.opts.backoff_factor ** min(retry_index - 1, 64))
        b = min(b, self.opts.max_backoff_s)
        if self.opts.jitter:
            with self._rng_lock:
                b = b / 2.0 + self._rng.random() * (b / 2.0)
        return b

    def run(self, fn: Callable[[], object], abort: Callable[[], bool] | None = None):
        """Run ``fn`` under the policy.  ``abort()`` (optional) is
        checked before each retry so callers can stop retrying a
        deliberately closed client without waiting out the schedule."""
        retry_index = 0
        while True:
            _bump(self.name, "attempts")
            try:
                result = fn()
            except Exception as e:  # noqa: BLE001 — classified below
                if not self.is_retryable(e):
                    _bump(self.name, "not_retryable")
                    raise
                retry_index += 1
                if (not self.opts.forever
                        and retry_index >= self.opts.max_attempts):
                    _bump(self.name, "exhausted")
                    raise
                if abort is not None and abort():
                    _bump(self.name, "aborted")
                    raise
                if self.budget is not None and not self.budget.allow():
                    _bump(self.name, "budget_exhausted")
                    raise
                _bump(self.name, "retries")
                self._sleep(self.backoff_for(retry_index))
                continue
            if retry_index:
                _bump(self.name, "recovered")
            _bump(self.name, "successes")
            return result
