"""Collector: client-side reporter that pre-aggregates then forwards.

The port's copy of ``m3_tpu/collector/reporter.py``.

Equivalent of the reference's collection agent (`src/collector` —
`collector/reporter` aggregates client-side within a reporting interval
and forwards to the aggregator over the shard-routed client).  Counters
fold to one sum per interval, gauges to the last value; timer samples
cannot be pre-aggregated without losing quantile fidelity, so they
buffer raw and forward every sample — exactly the reference's
reporter/aggregator split.

The sink is `(metric_type, id, value, time_nanos) -> None`, pluggable
with `AggregatorClient.write_untimed` for the wire path or an in-process
Aggregator for tests.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List

from m3_tpu_torch.metrics.types import MetricType

Sink = Callable[[int, bytes, float, int], None]


class _CounterCell:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0


class _GaugeCell:
    __slots__ = ("value", "set_")

    def __init__(self):
        self.value = 0.0
        self.set_ = False


class Reporter:
    """One per process; metric handles are cheap and interned by ID."""

    def __init__(self, sink: Sink, interval_s: float = 1.0,
                 now_nanos: Callable[[], int] = time.time_ns,
                 max_timer_buffer: int = 1 << 16):
        self.sink = sink
        self.interval_s = interval_s
        self.now_nanos = now_nanos
        self.max_timer_buffer = max_timer_buffer
        self._lock = threading.Lock()
        self._counters: Dict[bytes, _CounterCell] = {}
        self._gauges: Dict[bytes, _GaugeCell] = {}
        self._timers: List[tuple[bytes, float]] = []
        self.dropped_timers = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- client API --------------------------------------------------------

    def count(self, mid: bytes, delta: float = 1.0) -> None:
        with self._lock:
            cell = self._counters.get(mid)
            if cell is None:
                cell = self._counters[mid] = _CounterCell()
            cell.value += delta

    def gauge(self, mid: bytes, value: float) -> None:
        with self._lock:
            cell = self._gauges.get(mid)
            if cell is None:
                cell = self._gauges[mid] = _GaugeCell()
            cell.value = value
            cell.set_ = True

    def timer(self, mid: bytes, seconds: float) -> None:
        with self._lock:
            if len(self._timers) >= self.max_timer_buffer:
                self.dropped_timers += 1
                return
            self._timers.append((mid, seconds))

    # -- flush -------------------------------------------------------------

    def flush(self) -> int:
        """Forward the interval's aggregates; returns samples sent."""
        with self._lock:
            counters = {
                k: c.value for k, c in self._counters.items() if c.value != 0
            }
            for c in self._counters.values():
                c.value = 0.0
            gauges = {
                k: g.value for k, g in self._gauges.items() if g.set_
            }
            for g in self._gauges.values():
                g.set_ = False
            timers = self._timers
            self._timers = []
        now = self.now_nanos()
        sent = 0
        for mid, v in counters.items():
            self.sink(int(MetricType.COUNTER), mid, v, now)
            sent += 1
        for mid, v in gauges.items():
            self.sink(int(MetricType.GAUGE), mid, v, now)
            sent += 1
        for mid, v in timers:
            self.sink(int(MetricType.TIMER), mid, v, now)
            sent += 1
        return sent

    # -- background loop ---------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("reporter already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self.flush()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.flush()
            except Exception:  # noqa: BLE001 — reporting must not kill the app
                pass
