"""Per-query resource limits with lookback windows.

Equivalent of `src/dbnode/storage/limits`: global windowed limits on
docs matched and series/bytes read — each limit accumulates within a
lookback window and every query checks-and-adds before doing work;
exceeding returns a typed error the API maps to HTTP 429/400 rather
than letting one heavy query exhaust the node.

The port's copy of ``m3_tpu/storage/limits.py`` (it imports nothing of ``m3_tpu``).
"""

from __future__ import annotations

import contextlib
import re
import threading
import time
from dataclasses import dataclass

_LIMIT_MSG_RE = re.compile(
    r"query limit exceeded: ([\w-]+) \((\d+) > (\d+) within window\)"
)


class QueryLimitExceeded(RuntimeError):
    def __init__(self, name: str, value: int, limit: int):
        super().__init__(
            f"query limit exceeded: {name} ({value} > {limit} within window)"
        )
        self.name = name

    @classmethod
    def from_message(cls, msg: str) -> "QueryLimitExceeded":
        """Rebuild from the stable message form — the wire layers
        (query/remote, server/rpc) ship errors as ``TypeName: message``
        strings and must re-raise the REAL class client-side so a
        remote limit trip still maps to HTTP 429, not 500."""
        m = _LIMIT_MSG_RE.search(msg)
        if m:
            return cls(m.group(1), int(m.group(2)), int(m.group(3)))
        return cls("remote", 0, 0)


class _WindowedLimit:
    """check-and-add within a rolling lookback window
    (reference limits/query_limits.go lookbackLimit)."""

    def __init__(self, name: str, limit: int, lookback_s: float,
                 now=time.monotonic):
        self.name = name
        self.limit = limit
        self.lookback_s = lookback_s
        self._now = now
        self._value = 0
        self._window_start = now()
        self._lock = threading.Lock()

    def inc(self, n: int) -> None:
        if self.limit <= 0:  # disabled
            return
        with self._lock:
            t = self._now()
            if t - self._window_start >= self.lookback_s:
                self._value = 0
                self._window_start = t
            self._value += n
            if self._value > self.limit:
                raise QueryLimitExceeded(self.name, self._value, self.limit)

    @property
    def current(self) -> int:
        return self._value


@dataclass(frozen=True)
class LimitsOptions:
    """0 disables a limit (the reference's default)."""

    max_docs_matched: int = 0
    max_series_read: int = 0
    max_bytes_read: int = 0
    lookback_s: float = 5.0


class QueryLimits:
    def __init__(self, opts: LimitsOptions | None = None, now=time.monotonic,
                 instrument=None):
        self.opts = opts or LimitsOptions()
        self.docs = _WindowedLimit(
            "docs-matched", self.opts.max_docs_matched, self.opts.lookback_s, now
        )
        self.series = _WindowedLimit(
            "series-read", self.opts.max_series_read, self.opts.lookback_s, now
        )
        self.bytes = _WindowedLimit(
            "bytes-read", self.opts.max_bytes_read, self.opts.lookback_s, now
        )
        self._scope = (
            instrument.scope("query_limits") if instrument is not None else None
        )

    def inc_docs(self, n: int) -> None:
        self._inc(self.docs, n)

    def inc_series(self, n: int) -> None:
        self._inc(self.series, n)

    def inc_bytes(self, n: int) -> None:
        self._inc(self.bytes, n)

    def _inc(self, lim: _WindowedLimit, n: int) -> None:
        try:
            lim.inc(n)
        except QueryLimitExceeded:
            if self._scope is not None:
                self._scope.counter(f"exceeded_{lim.name}").inc()
            raise


NO_LIMITS = QueryLimits(LimitsOptions())


class NewSeriesLimiter:
    """Token bucket refilled at ``per_sec`` (0 = unlimited) gating
    series/entry CREATION — the churn control of the reference's
    entry.go rate limits and the dbnode write-new-series runtime keys
    (kvconfig/keys.go).  Shared by every shard's allocator;
    runtime-tunable via set_rate (the kvconfig watch calls it live).
    The bucket capacity is one second's budget, so a quiet period
    cannot bank an unbounded burst.  Rejections surface as typed
    counts (WriteResult.rejected / new_series_rejected counters), not
    exceptions — partial batch acceptance is the contract."""

    def __init__(self, per_sec: float = 0, now=time.monotonic):
        self._now = now
        self._lock = threading.Lock()
        self._tokens = float(per_sec)
        self._last = now()
        self.per_sec = float(per_sec)
        self.rejected_total = 0
        # Bypass depth is THREAD-LOCAL: a bootstrap/follower-ingest
        # bypass window on one thread must not exempt concurrent
        # foreground writes on other threads from the limit.
        self._bypass = threading.local()

    def set_rate(self, per_sec: float) -> None:
        with self._lock:
            self.per_sec = float(per_sec)
            self._tokens = min(self._tokens, self.per_sec)

    @contextlib.contextmanager
    def bypass(self):
        """Temporarily disable the limit: bootstrap/WAL replay must
        re-admit every previously-accepted series (the reference limits
        only foreground writes), and multi-policy fan-out charges the
        budget once, with follower lists riding the first list's
        decision under this bypass.  Scoped to the CALLING THREAD only
        (nestable depth counter): other threads' foreground writes keep
        paying the limit while a replay runs."""
        depth = getattr(self._bypass, "depth", 0)
        self._bypass.depth = depth + 1
        try:
            yield self
        finally:
            self._bypass.depth = depth

    def acquire_up_to(self, n: int) -> int:
        """Take up to ``n`` tokens; returns how many were granted
        (n when unlimited or bypassed).  Callers reject the
        shortfall."""
        if n <= 0:
            return 0
        with self._lock:
            if self.per_sec <= 0 or getattr(self._bypass, "depth", 0):
                return n
            t = self._now()
            self._tokens = min(
                self.per_sec, self._tokens + (t - self._last) * self.per_sec)
            self._last = t
            granted = int(min(n, self._tokens))
            self._tokens -= granted
            self.rejected_total += n - granted
            return granted
