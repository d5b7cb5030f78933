"""Per-peer circuit breakers: fail fast on a dead or drowning peer.
The port's copy of ``m3_tpu/x/breaker.py`` (it imports nothing of ``m3_tpu``).

Reference role: the M3 client's per-host health state (`host_queue`
connection health + the coordinator's remote-storage error thresholds)
— a peer that keeps failing or blowing deadlines stops being dialed at
all for a cool-down, so every query stops paying the full timeout to
rediscover the same dead region (the classic closed → open → half-open
breaker).

* **closed** — calls flow; ``failure_threshold`` CONSECUTIVE failures
  (transport errors or deadline blowouts — application errors from a
  responsive peer do NOT count) trip it open.
* **open** — calls raise :class:`BreakerOpenError` immediately for
  ``reset_timeout_s``; the fanout treats that like any per-source
  failure, so a dead region costs nothing instead of a full deadline.
* **half-open** — after the cool-down, ONE probe call passes; success
  closes the breaker, failure re-opens it (fresh cool-down).

Breakers are shared per peer through :func:`breaker_for` (a process
registry keyed by peer name) so `RemoteStorage`, the session read
fan-out, and the rpc ``RemoteDatabase`` all see one health state per
endpoint.  States are mirrored onto /metrics by
``m3_tpu_torch.x.register_metrics`` as ``breaker_state{peer=...}``
(0=closed, 1=half-open, 2=open) plus open/trip counters — the overload
dtest asserts the slow replica's breaker opening from outside the
process.

The registry has NAMESPACED keys: the name is
still the registry key, but breakers carry a ``kind`` — ``"peer"``
(the query federation and wire clients) or ``"stage"`` (the device
guard's per-hot-path-stage breakers, keyed ``stage:<name>`` by
``x.devguard``) — and ``breaker_state`` gains a matching ``kind``
label so a dashboard can split peer health from device-stage health
without parsing key prefixes.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict

__all__ = ["BreakerOpenError", "CircuitBreaker", "breaker_for",
           "all_breakers", "reset_registry", "counters", "reset_counters"]

CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
_STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class BreakerOpenError(RuntimeError):
    """Call refused: the peer's breaker is open.  A ``RuntimeError`` so
    the retry classifier never retries into an open breaker; fan-outs
    count it as that peer's failure like any other."""

    def __init__(self, peer: str, retry_in_s: float):
        super().__init__(
            f"circuit breaker open for peer {peer} "
            f"(retry in {max(retry_in_s, 0.0):.2f}s)")
        self.peer = peer
        self.retry_in_s = retry_in_s


_lock = threading.Lock()
_counters: Dict[str, int] = {}
_registry: Dict[str, "CircuitBreaker"] = {}


def _bump(name: str, key: str) -> None:
    with _lock:
        k = f"{name}.{key}"
        _counters[k] = _counters.get(k, 0) + 1


def counters() -> Dict[str, int]:
    with _lock:
        return dict(_counters)


def reset_counters() -> None:
    with _lock:
        _counters.clear()


class CircuitBreaker:
    """One peer's breaker; safe for concurrent use."""

    def __init__(self, name: str, failure_threshold: int = 5,
                 reset_timeout_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic,
                 is_failure: Callable[[BaseException], bool] | None = None,
                 kind: str = "peer"):
        self.name = name
        self.kind = kind
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self._clock = clock
        self._is_failure = is_failure or default_breaker_failure
        self._mu = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probing = False

    # -- observability -----------------------------------------------------

    @property
    def state(self) -> str:
        with self._mu:
            return self._effective_state()

    @property
    def state_code(self) -> int:
        return _STATE_CODE[self.state]

    def _effective_state(self) -> str:
        # callers hold self._mu
        if (self._state == OPEN
                and self._clock() - self._opened_at >= self.reset_timeout_s):
            return HALF_OPEN
        return self._state

    # -- state machine -----------------------------------------------------

    def allow(self) -> None:
        """Gate one call; raises :class:`BreakerOpenError` when open (or
        when half-open with the probe slot already taken)."""
        with self._mu:
            st = self._effective_state()
            if st == CLOSED:
                return
            if st == HALF_OPEN and not self._probing:
                self._probing = True  # this caller is the probe
                return
            retry_in = (self._opened_at + self.reset_timeout_s
                        - self._clock())
            _bump(self.name, "rejected")
        raise BreakerOpenError(self.name, retry_in)

    def record_success(self) -> None:
        with self._mu:
            if self._state != CLOSED:
                _bump(self.name, "closed")
            self._state = CLOSED
            self._consecutive = 0
            self._probing = False

    def record_failure(self) -> None:
        with self._mu:
            self._consecutive += 1
            was = self._effective_state()
            if (was == HALF_OPEN
                    or self._consecutive >= self.failure_threshold):
                if was != OPEN:
                    _bump(self.name, "opened")
                self._state = OPEN
                self._opened_at = self._clock()
                self._probing = False

    def force_open(self) -> None:
        """Administratively trip the breaker NOW (the x/controller
        evacuation verb).  Recovery is the normal path: after
        ``reset_timeout_s`` the breaker half-opens and a successful
        probe closes it — forced entry, earned exit."""
        with self._mu:
            if self._effective_state() != OPEN:
                _bump(self.name, "opened")
            self._state = OPEN
            self._opened_at = self._clock()
            self._probing = False

    def call(self, fn: Callable[[], object]):
        """``allow()`` → ``fn()`` → record.  Exceptions classified by
        ``is_failure`` count toward the trip threshold; application
        errors from a live peer reset it (the peer answered)."""
        self.allow()
        try:
            result = fn()
        except BaseException as e:
            if self._is_failure(e):
                self.record_failure()
            else:
                self.record_success()
            raise
        self.record_success()
        return result


def default_breaker_failure(e: BaseException) -> bool:
    """Peer-health failures: transport errors and deadline blowouts.
    Application errors (``RemoteError``, limit trips) come from a
    RESPONSIVE peer and must not open its breaker."""
    from m3_tpu_torch.x.deadline import DeadlineExceeded

    return isinstance(e, (ConnectionError, TimeoutError, OSError,
                          DeadlineExceeded))


# -- process registry (one breaker per peer, shared by every client) --------


def breaker_for(peer: str, failure_threshold: int = 5,
                reset_timeout_s: float = 10.0,
                clock: Callable[[], float] = time.monotonic,
                kind: str = "peer") -> CircuitBreaker:
    """The process-wide breaker for ``peer``, created on first use.
    Threshold/timeout/kind apply on creation only — all sharers see
    one state.  ``kind`` labels the breaker_state metric ("peer" for
    every wire caller; "stage" for x.devguard's per-stage breakers)."""
    with _lock:
        br = _registry.get(peer)
        if br is None:
            br = CircuitBreaker(peer, failure_threshold, reset_timeout_s,
                                clock, kind=kind)
            _registry[peer] = br
        return br


def all_breakers() -> Dict[str, CircuitBreaker]:
    with _lock:
        return dict(_registry)


def reset_registry() -> None:
    """Test hygiene: drop every registered breaker (and its state)."""
    with _lock:
        _registry.clear()
