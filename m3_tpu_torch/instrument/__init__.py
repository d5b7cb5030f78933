"""Instrumentation substrate: metrics scopes + structured logging.
The port's copy of ``m3_tpu/instrument/__init__.py`` (it imports nothing of ``m3_tpu``).

Equivalent of the reference's `src/x/instrument` (`instrument.Options`
bundling a tally metrics scope and a zap logger, threaded through every
subsystem — e.g. `storage/mediator.go:58-72` defines a *Metrics struct of
counters/timers; `aggregator/aggregator/map.go` likewise).  Tally's
reporter plumbing collapses to an in-process registry that renders the
Prometheus text exposition format — the reference's most common reporter
— served by the HTTP API's /metrics handler.

Design: a `Scope` is (prefix, tags); instruments are interned in one
process-wide registry keyed by (full name, sorted tags) so concurrent
subsystems share counters, exactly like tally scope reuse.  All mutation
is lock-protected and O(1).

Two latency instruments with different contracts:

* :class:`Timer` — bounded uniform reservoir, LIFETIME quantiles.  For
  low-rate paths (mediator ticks, scrub sweeps) where "over the
  process's life" is the question.  Its summary never decays: a burst
  an hour ago still dominates p99, and ``max`` is all-time.  Hot-path
  latency surfaces must NOT use it (the staleness trap
  tests/test_instrument.py pins).
* :class:`Histogram` — fixed log-2 buckets shared by every histogram in
  every process, so cross-node merge is a plain vector add of bucket
  counts (the sketch-tier fixed-width discipline: SALSA/Counter-Pools
  lanes, arXiv:2102.12531).  Cumulative lanes render as Prometheus
  ``_bucket{le=...}``/``_sum``/``_count``; ``summary()`` answers from a
  two-window rotation so p50/p99 track the LAST 1-2 windows, not the
  process's life.  The hot-path default (ingest batches, query phases,
  flush/snapshot, rollup drain, migration streams).
"""

from __future__ import annotations

import bisect
import logging
import random
import threading
import time
from typing import Dict, Iterator, List, Tuple

__all__ = [
    "Counter", "Gauge", "Timer", "Histogram", "Scope", "Registry",
    "HISTOGRAM_BOUNDS", "quantile_from_buckets",
    "root_scope", "new_registry", "logger",
]

_TagKey = Tuple[Tuple[str, str], ...]


class Counter:
    __slots__ = ("_v", "_lock")

    def __init__(self):
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, delta: int = 1) -> None:
        with self._lock:
            self._v += delta

    @property
    def value(self) -> int:
        return self._v


class Gauge:
    __slots__ = ("_v", "_lock")

    def __init__(self):
        self._v = 0.0
        self._lock = threading.Lock()

    def update(self, value: float) -> None:
        with self._lock:
            self._v = float(value)

    @property
    def value(self) -> float:
        return self._v


class Timer:
    """Duration recorder with a fixed-size uniform reservoir (Vitter's
    algorithm R) — bounded memory, usable p50/p95/p99 summaries.

    LIFETIME semantics, by design: the reservoir samples uniformly over
    every recording since construction and ``max`` never decays, so
    ``summary()`` answers "what has this path looked like over the
    process's life", not "what does it look like now".  Appropriate for
    low-rate maintenance paths (mediator ticks, scrub sweeps) where a
    per-window view would mostly be empty; WRONG for hot-path latency
    surfaced on /health — a burst an hour ago keeps reading as today's
    p99.  Hot paths use :class:`Histogram`, whose summary rotates
    windows (see tests/test_instrument.py's staleness regression)."""

    __slots__ = ("_count", "_sum", "_max", "_reservoir", "_cap", "_lock", "_rng")

    def __init__(self, reservoir: int = 512):
        self._count = 0
        self._sum = 0.0
        self._max = 0.0
        self._reservoir: list[float] = []
        self._cap = reservoir
        self._lock = threading.Lock()
        self._rng = random.Random(1315)

    def record(self, seconds: float) -> None:
        with self._lock:
            self._count += 1
            self._sum += seconds
            self._max = max(self._max, seconds)
            if len(self._reservoir) < self._cap:
                self._reservoir.append(seconds)
            else:
                j = self._rng.randrange(self._count)
                if j < self._cap:
                    self._reservoir[j] = seconds

    def time(self) -> "_TimerCtx":
        return _TimerCtx(self)

    def summary(self) -> dict:
        with self._lock:
            if not self._count:
                return {"count": 0, "sum": 0.0, "max": 0.0}
            s = sorted(self._reservoir)
            q = lambda p: s[min(len(s) - 1, int(p * len(s)))]
            return {
                "count": self._count, "sum": self._sum, "max": self._max,
                "p50": q(0.50), "p95": q(0.95), "p99": q(0.99),
            }

    @property
    def count(self) -> int:
        return self._count


class _TimerCtx:
    __slots__ = ("_t", "_start")

    def __init__(self, t: Timer):
        self._t = t

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._t.record(time.perf_counter() - self._start)
        return False


# One fixed bucket ladder for EVERY histogram in every process: lane i
# counts samples <= HISTOGRAM_BOUNDS[i] (seconds), one overflow lane
# past the last bound.  2^-20 s (~1µs) .. 2^10 s (~17min) at log-2
# resolution — <=2x relative quantile error, 32 fixed-width lanes.
# Because the ladder never varies, cross-node merge is a vector add.
HISTOGRAM_BOUNDS: Tuple[float, ...] = tuple(
    2.0 ** e for e in range(-20, 11))
_NLANES = len(HISTOGRAM_BOUNDS) + 1  # +Inf overflow lane


def quantile_from_buckets(counts, q: float,
                          bounds: Tuple[float, ...] = HISTOGRAM_BOUNDS,
                          ) -> float:
    """Quantile estimate from per-lane (NON-cumulative) bucket counts.

    Log-linear interpolation inside the holding lane (buckets are
    log-2, so geometric interpolation is the unbiased choice); the
    overflow lane answers its lower bound.  Shared by Histogram
    summaries and cross-node merges of scraped ``_bucket`` lanes."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        cum += c
        if cum >= rank and c > 0:
            if i >= len(bounds):  # overflow lane: no upper bound
                return bounds[-1]
            hi = bounds[i]
            lo = bounds[i - 1] if i > 0 else hi / 2.0
            frac = (rank - (cum - c)) / c
            return lo * (hi / lo) ** frac
    return bounds[-1]


class Histogram:
    """Fixed log-2 bucket latency histogram (seconds).

    * **Mergeable**: every histogram shares :data:`HISTOGRAM_BOUNDS`,
      so two nodes' bucket vectors merge by element-wise addition —
      the property tests/test_instrument.py pins exactly.
    * **Cumulative lanes** (``_counts``/``_sum``/``_count``) only ever
      grow: they render as Prometheus ``_bucket{le=...}`` counters.
    * **Windowed summary**: ``summary()`` answers p50/p95/p99/max from
      the current + previous ``window_s`` windows, so /health reflects
      the last 1-2 windows and a burst ages out — the lifetime-bias
      fix over :class:`Timer`.
    """

    __slots__ = ("_counts", "_sum", "_count", "_lock", "_clock",
                 "window_s", "_cur", "_prev", "_cur_start",
                 "_cur_max", "_prev_max")

    def __init__(self, window_s: float = 60.0, clock=time.monotonic):
        self._counts = [0] * _NLANES
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()
        self._clock = clock
        self.window_s = float(window_s)
        self._cur = [0] * _NLANES
        self._prev = [0] * _NLANES
        self._cur_start = clock()
        self._cur_max = 0.0
        self._prev_max = 0.0

    def _rotate(self, now: float) -> None:
        # EVERY caller (record/summary) already holds self._lock —
        # the suppressions below record that reviewed invariant
        elapsed = now - self._cur_start
        if elapsed < self.window_s:
            return
        if elapsed < 2 * self.window_s:
            self._prev = self._cur  # m3lint: disable=lock-discipline
            self._prev_max = self._cur_max  # m3lint: disable=lock-discipline
        else:  # idle gap: both windows aged out
            self._prev = [0] * _NLANES  # m3lint: disable=lock-discipline
            self._prev_max = 0.0  # m3lint: disable=lock-discipline
        self._cur = [0] * _NLANES  # m3lint: disable=lock-discipline
        self._cur_max = 0.0  # m3lint: disable=lock-discipline
        self._cur_start = now - (elapsed % self.window_s)

    def record(self, seconds: float) -> None:
        seconds = float(seconds)
        lane = bisect.bisect_left(HISTOGRAM_BOUNDS, seconds)
        with self._lock:
            self._rotate(self._clock())
            self._counts[lane] += 1
            self._sum += seconds
            self._count += 1
            self._cur[lane] += 1
            self._cur_max = max(self._cur_max, seconds)

    def time(self) -> "_TimerCtx":
        return _TimerCtx(self)

    @property
    def count(self) -> int:
        return self._count

    def state(self) -> dict:
        """Mergeable cumulative state: per-lane counts (NON-cumulative),
        sum, count.  merge = vector add of two states' ``buckets``."""
        with self._lock:
            return {"buckets": list(self._counts), "sum": self._sum,
                    "count": self._count}

    def cumulative(self) -> List[int]:
        """Prometheus ``_bucket`` lanes: cumulative counts per ``le``
        bound, overflow folded into +Inf (== count)."""
        with self._lock:
            return self._cumulative_locked()

    def _cumulative_locked(self) -> List[int]:
        out, run = [], 0
        for c in self._counts:
            run += c
            out.append(run)
        return out

    def exposition_state(self) -> tuple:
        """(cumulative lanes, sum, count) under ONE lock acquisition:
        the exposition contract requires the +Inf lane to EQUAL _count
        in the same scrape, and a record() landing between two separate
        snapshots would render a scrape the strict parser rejects."""
        with self._lock:
            return self._cumulative_locked(), self._sum, self._count

    def summary(self) -> dict:
        """Windowed view (current + previous window): the /health
        document.  Falls back to zeros when both windows are empty."""
        with self._lock:
            self._rotate(self._clock())
            lanes = [a + b for a, b in zip(self._cur, self._prev)]
            wmax = max(self._cur_max, self._prev_max)
            total_count, total_sum = self._count, self._sum
        n = sum(lanes)
        out = {"count": total_count, "sum": total_sum,
               "window_count": n, "max": wmax}
        if n:
            out.update(p50=quantile_from_buckets(lanes, 0.50),
                       p95=quantile_from_buckets(lanes, 0.95),
                       p99=quantile_from_buckets(lanes, 0.99))
        return out


class Registry:
    """Process-wide instrument store; scopes are views into it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, _TagKey], Counter] = {}
        self._gauges: Dict[Tuple[str, _TagKey], Gauge] = {}
        self._timers: Dict[Tuple[str, _TagKey], Timer] = {}
        self._histograms: Dict[Tuple[str, _TagKey], Histogram] = {}
        # Scrape-time collectors: callables invoked before every
        # snapshot/exposition so components whose counters live outside
        # the registry (e.g. the aggregator engine's plain-int reject /
        # forward-error counts) can mirror fresh values into gauges —
        # the role of tally's cached-gauge Collect hooks.
        self._collectors: list = []

    def register_collector(self, fn) -> None:
        """Register fn() to run at the top of snapshot()/
        render_prometheus().  A raising collector is dropped from the
        scrape (never poisons /metrics) but re-tried next time.
        Components with a shutdown path must unregister_collector —
        the registry holds a strong reference."""
        with self._lock:
            self._collectors.append(fn)

    def unregister_collector(self, fn) -> None:
        with self._lock:
            try:
                self._collectors.remove(fn)
            except ValueError:
                pass

    def _collect(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except Exception:
                pass

    def _get(self, store: dict, name: str, tags: _TagKey, factory):
        with self._lock:
            inst = store.get((name, tags))
            if inst is None:
                inst = store[(name, tags)] = factory()
            return inst

    # -- introspection ----------------------------------------------------

    def snapshot(self) -> dict:
        """{metric_name: value-or-summary} with tags rendered inline."""
        self._collect()
        out = {}
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            timers = dict(self._timers)
            histograms = dict(self._histograms)
        for (name, tags), c in counters.items():
            out[_render_name(name, tags)] = c.value
        for (name, tags), g in gauges.items():
            out[_render_name(name, tags)] = g.value
        for (name, tags), t in timers.items():
            out[_render_name(name, tags)] = t.summary()
        for (name, tags), h in histograms.items():
            out[_render_name(name, tags)] = h.summary()
        return out

    def histogram_summaries(self) -> dict:
        """{rendered_name: windowed summary} for every histogram — the
        /health ``latency`` section's source."""
        self._collect()
        with self._lock:
            histograms = dict(self._histograms)
        return {_render_name(name, tags): h.summary()
                for (name, tags), h in histograms.items()}

    def render_prometheus(self) -> str:
        """Prometheus text exposition (the /metrics payload)."""
        self._collect()
        lines = []
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            timers = dict(self._timers)
            histograms = dict(self._histograms)
        for (name, tags), c in sorted(counters.items()):
            lines.append(f"{_prom_name(name, tags)} {c.value}")
        for (name, tags), g in sorted(gauges.items()):
            lines.append(f"{_prom_name(name, tags)} {g.value}")
        for (name, tags), t in sorted(timers.items()):
            s = t.summary()
            base, lbl = name.replace(".", "_"), _prom_labels(tags)
            lines.append(f"{base}_count{lbl} {s['count']}")
            lines.append(f"{base}_sum{lbl} {s['sum']}")
            for q, frac in (("p50", "0.5"), ("p95", "0.95"), ("p99", "0.99")):
                if q in s:
                    ql = _prom_labels(tags + (("quantile", frac),))
                    lines.append(f"{base}{ql} {s[q]}")
        for (name, tags), h in sorted(histograms.items()):
            base = name.replace(".", "_")
            # one atomic snapshot: +Inf lane and _count must agree
            # within a scrape (the strict parser enforces it)
            cum, hsum, hcount = h.exposition_state()
            for bound, c in zip(HISTOGRAM_BOUNDS, cum[:-1]):
                ll = _prom_labels(tags + (("le", repr(bound)),))
                lines.append(f"{base}_bucket{ll} {c}")
            inf = _prom_labels(tags + (("le", "+Inf"),))
            lines.append(f"{base}_bucket{inf} {cum[-1]}")
            lbl = _prom_labels(tags)
            lines.append(f"{base}_sum{lbl} {hsum}")
            lines.append(f"{base}_count{lbl} {hcount}")
        return "\n".join(lines) + "\n"

    def scope(self, prefix: str = "", tags: dict | None = None) -> "Scope":
        return Scope(self, prefix, tuple(sorted((tags or {}).items())))


def _render_name(name: str, tags: _TagKey) -> str:
    if not tags:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in tags) + "}"


def _escape_label(v) -> str:
    # Prometheus text-format label-value escaping: backslash, quote,
    # newline.  Without it one hostile/odd tag value corrupts the whole
    # scrape (the strict parser in instrument/exposition.py catches it).
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _prom_labels(tags) -> str:
    if not tags:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label(v)}"' for k, v in tags) + "}"


def _prom_name(name: str, tags: _TagKey) -> str:
    return name.replace(".", "_") + _prom_labels(tags)


class Scope:
    """A (prefix, tags) view — `scope("db").counter("writes")` interns
    db.writes in the registry (tally subscope semantics)."""

    __slots__ = ("_reg", "_prefix", "_tags")

    def __init__(self, registry: Registry, prefix: str, tags: _TagKey):
        self._reg = registry
        self._prefix = prefix
        self._tags = tags

    def _full(self, name: str) -> str:
        return f"{self._prefix}.{name}" if self._prefix else name

    def counter(self, name: str) -> Counter:
        return self._reg._get(self._reg._counters, self._full(name), self._tags, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._reg._get(self._reg._gauges, self._full(name), self._tags, Gauge)

    def timer(self, name: str) -> Timer:
        return self._reg._get(self._reg._timers, self._full(name), self._tags, Timer)

    def histogram(self, name: str) -> Histogram:
        return self._reg._get(self._reg._histograms, self._full(name),
                              self._tags, Histogram)

    def subscope(self, name: str) -> "Scope":
        return Scope(self._reg, self._full(name), self._tags)

    # Mediator and friends accept an `instrument` object exposing .scope()
    def scope(self, name: str) -> "Scope":
        return self.subscope(name)

    def tagged(self, tags: dict) -> "Scope":
        merged = dict(self._tags)
        merged.update(tags)
        return Scope(self._reg, self._prefix, tuple(sorted(merged.items())))

    @property
    def registry(self) -> Registry:
        return self._reg


_GLOBAL = Registry()


def new_registry() -> Registry:
    return Registry()


def root_scope(prefix: str = "", tags: dict | None = None) -> Scope:
    """The process-global scope (the reference's instrument.Options
    default); tests build isolated registries via new_registry()."""
    return _GLOBAL.scope(prefix, tags)


def logger(name: str) -> logging.Logger:
    """Structured logger (zap-equivalent): stdlib logging with a
    consistent format, configured once."""
    log = logging.getLogger(f"m3_tpu_torch.{name}" if name else "m3_tpu_torch")
    root = logging.getLogger("m3_tpu_torch")
    if not root.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s %(message)s"
        ))
        root.addHandler(h)
        root.setLevel(logging.INFO)
        root.propagate = False
    return log
