"""Tracing: spans named from a tracepoint registry, with a bound trace
context and its 17-byte wire form.  The counterpart of
``m3_tpu/instrument/tracing.py``, so that a caller's ``Tracer`` works
with the port's engine as it does with the reference's, and a sampled
aggregator client stitches the ingest server's batch span into its
trace (the ``INGEST_TRACE`` preamble of ``msg/protocol.py``).

* ``bind(ctx)`` installs a parent :class:`TraceContext` for the current
  thread of execution (``contextvars``); ``current()`` reads it.
  Entering a recorded span binds its own context too.  New threads never
  inherit the binding.
* Wire clients read ``current_wire()`` and send it ahead of a frame;
  servers decode it with ``TraceContext.from_wire`` and ``bind`` it
  around dispatch.
* Sampling rides the context: root spans sample via the tracer's
  ``sample_rate``; a bound context's decision always wins.

Span ids are drawn from a per-process random 64-bit space (not a
counter), so ids minted by different processes in one trace cannot
collide.
"""

from __future__ import annotations

import contextlib
import contextvars
import random
import struct
import threading
import time
from collections import deque
from dataclasses import dataclass, field


class Tracepoint:
    """Stable span names (reference dbnode/tracepoint/tracepoint.go)."""

    DB_WRITE_BATCH = "db.writeBatch"
    DB_READ = "db.read"
    DB_QUERY_IDS = "db.queryIDs"
    DB_BOOTSTRAP = "db.bootstrap"
    DB_TICK = "db.tick"
    DB_SNAPSHOT = "db.snapshot"
    ENGINE_EXECUTE = "query.engine.execute"
    FETCH_COMPRESSED = "query.storage.fetchCompressed"
    API_QUERY_RANGE = "api.queryRange"
    API_WRITE = "api.write"
    INGEST_TCP_BATCH = "ingest.tcp.batch"
    AGG_CONSUME = "aggregator.consume"
    # cross-process hops: the server-side spans each wire
    # protocol opens around dispatch, and the client-side fan-out span
    RPC_SERVER = "rpc.server"
    RPC_CLIENT = "rpc.client"
    REMOTE_FETCH = "query.remote.fetch"
    SESSION_WRITE = "session.writeReplica"


# -- cross-process context ---------------------------------------------------


_WIRE = struct.Struct("<QQB")  # trace_id, parent span_id, flags


@dataclass(frozen=True)
class TraceContext:
    """What crosses a process boundary: which trace, which parent span,
    and whether the trace is sampled (W3C traceparent, packed)."""

    trace_id: int
    span_id: int
    sampled: bool = True

    WIRE_SIZE = _WIRE.size  # 17 bytes

    def to_wire(self) -> bytes:
        return _WIRE.pack(self.trace_id & (2**64 - 1),
                          self.span_id & (2**64 - 1),
                          1 if self.sampled else 0)

    @classmethod
    def from_wire(cls, raw: bytes, pos: int = 0) -> "TraceContext":
        tid, sid, flags = _WIRE.unpack_from(raw, pos)
        return cls(tid, sid, bool(flags & 1))


_current: contextvars.ContextVar[TraceContext | None] = contextvars.ContextVar(
    "m3_trace_context", default=None)


def current() -> TraceContext | None:
    """The trace context bound to this thread of execution, or None."""
    return _current.get()


@contextlib.contextmanager
def bind(ctx: TraceContext | None):
    """Install ``ctx`` for the scope (None = no-op scope, so callers
    need no conditional).  New threads never inherit the binding."""
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


def current_wire(default: bytes = b"") -> bytes:
    """Wire form of the bound context for frame preambles; ``default``
    (empty = no trace) when none is bound or the bound trace is
    unsampled — unsampled requests cost nothing downstream."""
    ctx = _current.get()
    if ctx is None or not ctx.sampled:
        return default
    return ctx.to_wire()


@dataclass
class Span:
    name: str
    trace_id: int
    span_id: int
    parent_id: int | None
    start_ns: int
    end_ns: int = 0
    tags: dict = field(default_factory=dict)
    error: str | None = None

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    def to_dict(self) -> dict:
        return {
            "name": self.name, "trace_id": self.trace_id,
            "span_id": self.span_id, "parent_id": self.parent_id,
            "start_ns": self.start_ns, "duration_ns": self.duration_ns,
            "tags": self.tags, "error": self.error,
        }

    @property
    def context(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id, sampled=True)


class _ActiveSpan:
    __slots__ = ("_tracer", "span", "_token")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self.span = span
        self._token = None

    def set_tag(self, key: str, value) -> None:
        self.span.tags[key] = value

    def __enter__(self) -> "_ActiveSpan":
        # the active span is the current trace context: in-process
        # children parent on it via the tracer stack, wire clients
        # serialize it via current_wire()
        self._token = _current.set(self.span.context)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc is not None:
            self.span.error = f"{type(exc).__name__}: {exc}"
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        self._tracer._finish(self.span)
        return False


class _NoopSpan:
    def set_tag(self, key: str, value) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


NOOP_SPAN = _NoopSpan()

_UNSAMPLED = TraceContext(0, 0, sampled=False)


class _UnsampledSpan:
    """Returned when a ROOT span loses the sampling roll: records
    nothing, but BINDS a not-sampled context for its scope so every
    descendant (and every wire hop) inherits the negative decision —
    otherwise each child would re-roll as a fresh root and litter the
    ring with unparented fragment traces."""

    __slots__ = ("_token",)

    def set_tag(self, key: str, value) -> None:
        pass

    def __enter__(self):
        self._token = _current.set(_UNSAMPLED)
        return self

    def __exit__(self, *exc) -> bool:
        _current.reset(self._token)
        return False


class Tracer:
    """Span factory + bounded finished-span ring; parentage flows
    through a thread-local active-span stack in-process and through the
    bound :class:`TraceContext` across processes."""

    def __init__(self, max_finished: int = 4096, enabled: bool = True,
                 sample_rate: float = 1.0):
        self.enabled = enabled
        self.sample_rate = float(sample_rate)
        self._ring: deque[Span] = deque(maxlen=max_finished)
        self._lock = threading.Lock()
        self._tls = threading.local()
        # Random 64-bit ids: two processes in one trace must not mint
        # colliding span ids the way a shared counter would.
        self._rng = random.Random()

    def _ids(self) -> int:
        with self._lock:
            return self._rng.getrandbits(64) or 1

    def _sample(self) -> bool:
        if self.sample_rate >= 1.0:
            return True
        with self._lock:
            return self._rng.random() < self.sample_rate

    def _stack(self) -> list:
        s = getattr(self._tls, "stack", None)
        if s is None:
            s = self._tls.stack = []
        return s

    def start_span(self, name: str, tags: dict | None = None):
        """Context manager: `with tracer.start_span(Tracepoint.DB_READ):`.

        Parent resolution: the innermost active LOCAL span, else the
        bound remote :class:`TraceContext` (a server dispatch joining
        its caller's trace), else a fresh root — sampled per
        ``sample_rate`` (a bound context's sampled flag always wins)."""
        if not self.enabled:
            return NOOP_SPAN
        stack = self._stack()
        parent = stack[-1] if stack else None
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            remote = _current.get()
            if remote is not None:
                if not remote.sampled:
                    return NOOP_SPAN
                trace_id, parent_id = remote.trace_id, remote.span_id
            else:
                if not self._sample():
                    # the negative decision is bound for the scope so
                    # in-process descendants don't re-roll as roots
                    return _UnsampledSpan()
                trace_id, parent_id = self._ids(), None
        span = Span(
            name=name,
            trace_id=trace_id,
            span_id=self._ids(),
            parent_id=parent_id,
            start_ns=time.monotonic_ns(),
            tags=dict(tags or {}),
        )
        stack.append(span)
        return _ActiveSpan(self, span)

    def _finish(self, span: Span) -> None:
        span.end_ns = time.monotonic_ns()
        stack = self._stack()
        if stack and stack[-1] is span:
            stack.pop()
        with self._lock:
            self._ring.append(span)

    # -- introspection -----------------------------------------------------

    def finished(self, name: str | None = None) -> list[Span]:
        with self._lock:
            spans = list(self._ring)
        return [s for s in spans if name is None or s.name == name]

    def traces(self) -> dict[int, list[Span]]:
        out: dict[int, list[Span]] = {}
        for s in self.finished():
            out.setdefault(s.trace_id, []).append(s)
        return out

    def inventory(self) -> list[dict]:
        """Ring inventory for the debug endpoint: one row per trace —
        id, span count, distinct tracepoint names, wall span."""
        out = []
        for tid, spans in sorted(self.traces().items()):
            start = min(s.start_ns for s in spans)
            end = max(s.end_ns or s.start_ns for s in spans)
            out.append({
                "trace_id": tid,
                "spans": len(spans),
                "names": sorted({s.name for s in spans}),
                "duration_ns": end - start,
            })
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


NOOP_TRACER = Tracer(enabled=False)


# -- cross-process trace assembly -------------------------------------------


def traces_response(tracer: "Tracer", trace_id=None,
                    name: str | None = None) -> dict:
    """The ``/api/v1/debug/traces`` response document — ONE
    implementation shared by the HTTP API's handlers.  ``trace_id`` → that trace's spans parent-before-child;
    ``name`` → spans of one tracepoint; default → ring inventory + raw
    spans."""
    if trace_id is not None:
        tid = int(trace_id)
        spans = [s.to_dict() for s in tracer.finished()
                 if s.trace_id == tid]
        return {"status": "success",
                "data": join_traces(spans).get(tid, [])}
    return {"status": "success",
            "inventory": tracer.inventory() if name is None else None,
            "data": [s.to_dict() for s in tracer.finished(name)]}


def join_traces(span_dicts: list[dict]) -> dict[int, list[dict]]:
    """Group span dicts (``Span.to_dict`` rows, typically collected
    from several processes' debug endpoints) by trace_id, each trace's
    spans ordered parent-before-child where links allow."""
    by_trace: dict[int, list[dict]] = {}
    for s in span_dicts:
        by_trace.setdefault(int(s["trace_id"]), []).append(s)
    for spans in by_trace.values():
        by_id = {s["span_id"]: s for s in spans}

        def depth(s, _seen=None) -> int:
            seen = _seen or set()
            d = 0
            while s.get("parent_id") in by_id and s["span_id"] not in seen:
                seen.add(s["span_id"])
                s = by_id[s["parent_id"]]
                d += 1
            return d

        spans.sort(key=lambda s: (depth(s), s["start_ns"]))
    return by_trace
