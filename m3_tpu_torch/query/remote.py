"""Remote query federation: the cross-coordinator fetch protocol.

Equivalent of the reference's gRPC query federation (`src/query/remote`
— rpcpb client/server letting one coordinator query another region's
storage, plugged into fanout as a remote store).  gRPC collapses to the
framework's framed TCP protocol (msg/protocol.py): a QUERY_FETCH frame
carries (name, matchers, start, end, remaining-deadline-ms); the
QUERY_RESULT frame carries the matched series (tags + raw points).
`RemoteStorage` implements the same `fetch_raw` seam as
DatabaseStorage, so it drops straight into `FanoutSource` —
cross-region federation is just another fanout source with a coarser
typical resolution.

Overload contract (the read-path mirror of the wire retries):

* the query's **deadline** rides the frame as a relative ms budget, so
  the server stops work for a client that already gave up, and every
  per-call socket timeout derives from ``remaining()`` instead of a
  fixed constant;
* server-side errors cross the wire **typed** (`TypeName: message`,
  like the rpc layer) — a remote ``QueryLimitExceeded`` surfaces as a
  client-side ``QueryLimitExceeded`` (HTTP 429), a remote deadline trip
  as ``DeadlineExceeded`` (504), never a generic ``RuntimeError`` 500;
* a small **per-peer connection pool** replaces the old single
  socket + lock, so concurrent fanout fetches never serialize behind —
  or wedge on — one slow peer's round-trip;
* every fetch flows through the peer's shared **circuit breaker**
  (x/breaker): a dead region fails fast instead of eating the whole
  deadline on every query.

The ``query.fetch`` faultpoint fires server-side in the storage adapter
(`query/storage_adapter.py`) so delay/error injection covers local and
federated reads through one point.

The port's copy of ``m3_tpu/query/remote.py``: frames byte-identical to
the reference's in both directions, so a JAX ``QueryServer`` serves a
port ``RemoteStorage`` and the reverse.
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading

import numpy as np

from m3_tpu_torch.instrument import tracing
from m3_tpu_torch.instrument.tracing import NOOP_TRACER, TraceContext, Tracepoint
from m3_tpu_torch.msg import protocol as wire
from m3_tpu_torch.query.block import RawBlock, SeriesMeta
from m3_tpu_torch.x import deadline as xdeadline
from m3_tpu_torch.x.breaker import CircuitBreaker
from m3_tpu_torch.x.deadline import Deadline, DeadlineExceeded

QUERY_FETCH = 8
QUERY_RESULT = 9


# -- payload codecs ---------------------------------------------------------


def encode_fetch(name: bytes | None, matchers, start: int, end: int,
                 deadline_ms: int = -1, trace_ctx: bytes = b"") -> bytes:
    parts = [struct.pack("<qq", start, end)]
    parts.append(struct.pack("<H", len(name) if name is not None else 0xFFFF))
    if name is not None:
        parts.append(name)
    parts.append(struct.pack("<H", len(matchers)))
    for m in matchers:
        op = m.op.encode()
        parts.append(struct.pack("<BHH", len(op), len(m.name), len(m.value)))
        parts.append(op)
        parts.append(m.name)
        parts.append(m.value)
    # trailer: the query's REMAINING budget (relative ms; -1 = none) so
    # the server stops work once the client's deadline is spent, then —
    # for sampled queries only — the caller's packed TraceContext (the
    # same grow-at-the-tail pattern the deadline trailer used: old
    # decoders read their prefix and ignore the rest)
    parts.append(struct.pack("<q", deadline_ms))
    parts.append(trace_ctx)
    return b"".join(parts)


def decode_fetch(raw: bytes):
    from m3_tpu_torch.query.promql import LabelMatcher

    start, end = struct.unpack_from("<qq", raw, 0)
    pos = 16
    (nlen,) = struct.unpack_from("<H", raw, pos)
    pos += 2
    name = None
    if nlen != 0xFFFF:
        name = raw[pos : pos + nlen]
        pos += nlen
    (nm,) = struct.unpack_from("<H", raw, pos)
    pos += 2
    matchers = []
    for _ in range(nm):
        ol, nl, vl = struct.unpack_from("<BHH", raw, pos)
        pos += 5
        op = raw[pos : pos + ol].decode()
        pos += ol
        mname = raw[pos : pos + nl]
        pos += nl
        value = raw[pos : pos + vl]
        pos += vl
        matchers.append(LabelMatcher(mname, op, value))
    deadline_ms = -1
    if pos + 8 <= len(raw):  # pre-deadline encoders have no trailer
        (deadline_ms,) = struct.unpack_from("<q", raw, pos)
        pos += 8
    tctx = None
    if pos + TraceContext.WIRE_SIZE <= len(raw):  # sampled caller
        tctx = TraceContext.from_wire(raw, pos)
    return name, tuple(matchers), start, end, deadline_ms, tctx


def encode_result(block: RawBlock) -> bytes:
    parts = [struct.pack("<I", len(block.series))]
    for i, meta in enumerate(block.series):
        tags = list(meta.tags)
        parts.append(struct.pack("<H", len(tags)))
        for k, v in tags:
            parts.append(struct.pack("<HH", len(k), len(v)))
            parts.append(k)
            parts.append(v)
        n = int(block.counts[i])
        parts.append(struct.pack("<I", n))
        parts.append(block.ts[i, :n].astype("<i8").tobytes())
        parts.append(block.values[i, :n].astype("<f8").tobytes())
    return b"".join(parts)


def decode_result(raw: bytes) -> RawBlock:
    (ns,) = struct.unpack_from("<I", raw, 0)
    pos = 4
    pts, metas = [], []
    for _ in range(ns):
        (ntags,) = struct.unpack_from("<H", raw, pos)
        pos += 2
        tags = []
        for _ in range(ntags):
            lk, lv = struct.unpack_from("<HH", raw, pos)
            pos += 4
            k = raw[pos : pos + lk]
            pos += lk
            v = raw[pos : pos + lv]
            pos += lv
            tags.append((k, v))
        (n,) = struct.unpack_from("<I", raw, pos)
        pos += 4
        ts = np.frombuffer(raw, "<i8", n, pos)
        pos += 8 * n
        vals = np.frombuffer(raw, "<f8", n, pos)
        pos += 8 * n
        metas.append(SeriesMeta(tuple(tags)))
        pts.append(list(zip(ts.tolist(), vals.tolist())))
    return RawBlock.from_lists(pts, metas)


# -- typed error mapping ----------------------------------------------------


def _decode_query_error(msg: str) -> Exception:
    """wire.ERROR payload (``TypeName: message``) → the exception to
    re-raise client-side.  Overload errors map through the shared
    ``x/deadline.decode_wire_error`` (one mapping for both wire
    protocols): a remote limit trip stays a ``QueryLimitExceeded``
    (HTTP 429) and a remote deadline trip a ``DeadlineExceeded``
    (504) — not a generic 500."""
    typed = xdeadline.decode_wire_error(msg)
    if typed is not None:
        return typed
    return RuntimeError(f"remote query failed: {msg}")


# -- server -----------------------------------------------------------------


class _QueryHandler(socketserver.BaseRequestHandler):
    def handle(self):
        srv = self.server
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        while True:
            try:
                frame = wire.recv_frame(sock)
            except (wire.ProtocolError, OSError):
                return
            if frame is None or frame[0] != QUERY_FETCH:
                return
            try:
                name, matchers, start, end, dl_ms, tctx = decode_fetch(
                    frame[1])
                # The client's remaining budget becomes THIS side's
                # deadline: storage stops work (typed) once the caller
                # has given up, instead of computing an answer nobody
                # will read.  A sampled caller's TraceContext binds the
                # same way, so the fetch span joins its trace.
                dl = Deadline(dl_ms / 1000.0) if dl_ms >= 0 else None
                with xdeadline.bind(dl), tracing.bind(tctx):
                    xdeadline.check_current("remote fetch")
                    span = (srv.tracer.start_span(
                        Tracepoint.REMOTE_FETCH, {"matchers": len(matchers)})
                        if tctx is not None else tracing.NOOP_SPAN)
                    with span:
                        block = srv.storage.fetch_raw(name, matchers,
                                                      start, end)
                wire.send_frame(sock, QUERY_RESULT, encode_result(block))
            except Exception as e:  # noqa: BLE001 — report, don't die
                try:
                    wire.send_frame(sock, wire.ERROR,
                                    f"{type(e).__name__}: {e}".encode()[:4096])
                except OSError:
                    return


class QueryServer(socketserver.ThreadingTCPServer):
    """Serves fetch_raw over TCP (reference query/remote/server.go)."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, storage, host: str = "127.0.0.1", port: int = 0,
                 tracer=None):
        self.storage = storage
        self.tracer = tracer if tracer is not None else NOOP_TRACER
        super().__init__((host, port), _QueryHandler)

    @property
    def port(self) -> int:
        return self.server_address[1]


def serve_query_background(storage, host: str = "127.0.0.1",
                           port: int = 0, tracer=None) -> QueryServer:
    srv = QueryServer(storage, host, port, tracer=tracer)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv


# -- client -----------------------------------------------------------------


class _ConnPool:
    """Small per-peer socket pool: concurrent queries each check out
    their own connection instead of serializing behind one shared
    socket (the old single-socket + lock shape let one slow peer wedge
    EVERY concurrent fanout fetch).  ``max_idle`` bounds what a burst
    leaves warm; checkouts beyond it dial fresh and close on return."""

    def __init__(self, address, max_idle: int = 4):
        self.address = address
        self.max_idle = int(max_idle)
        self._mu = threading.Lock()
        self._idle: list[socket.socket] = []
        self._closed = False

    def get(self, cap_s: float, fresh: bool = False) -> socket.socket:
        # per-checkout timeout from the bound deadline's remaining
        # budget (capped): a pooled socket must never outlive its query.
        # ``fresh`` skips the idle list and dials — retry-after-failure
        # must not pop ANOTHER socket staled by the same peer restart.
        timeout_s = xdeadline.socket_timeout(cap_s)
        if not fresh:
            with self._mu:
                if self._idle:
                    sock = self._idle.pop()
                    sock.settimeout(timeout_s)
                    return sock
        return wire.connect(self.address, timeout=timeout_s)

    def put(self, sock: socket.socket) -> None:
        with self._mu:
            if not self._closed and len(self._idle) < self.max_idle:
                self._idle.append(sock)
                return
        try:
            sock.close()
        except OSError:
            pass

    def close(self) -> None:
        with self._mu:
            self._closed = True
            idle, self._idle = self._idle, []
        for sock in idle:
            try:
                sock.close()
            except OSError:
                pass


class RemoteStorage:
    """fetch_raw over the wire: a drop-in fanout source
    (reference query/remote/client.go wrapped as a remote store).

    Deadline-aware: per-call socket timeouts derive from the bound
    deadline's ``remaining()`` (capped by ``timeout_s``), the remaining
    budget rides the QUERY_FETCH frame, and a transport timeout with
    the budget spent surfaces as typed ``DeadlineExceeded``.  All calls
    flow through ``breaker`` (one per peer) so a dead region fails fast
    for every sharer at once."""

    def __init__(self, address, timeout_s: float = 30.0, pool_size: int = 4,
                 breaker: CircuitBreaker | None = None):
        self.address = tuple(address)
        self.timeout_s = timeout_s
        self.breaker = breaker
        self._pool = _ConnPool(self.address, max_idle=pool_size)

    @property
    def peer(self) -> str:
        return f"{self.address[0]}:{self.address[1]}"

    def _round_trip(self, payload: bytes, fresh: bool = False):
        """One send/recv on a pooled connection; the connection returns
        to the pool only after a clean exchange.  EOF mid-exchange (the
        peer restarted; send into the half-closed socket still
        "succeeds") raises ``ConnectionError`` — an ``OSError``, so the
        caller's one-reconnect retry fires — and the dead socket is
        closed, never re-pooled."""
        xdeadline.check_current("remote fetch")
        sock = self._pool.get(self.timeout_s, fresh=fresh)
        try:
            wire.send_frame(sock, QUERY_FETCH, payload)
            frame = wire.recv_frame(sock)
            if frame is None:
                raise ConnectionError("remote query peer closed connection")
        except BaseException:
            try:
                sock.close()
            except OSError:
                pass
            raise
        self._pool.put(sock)
        return frame

    def fetch_raw(self, name, matchers, start_nanos, end_nanos) -> RawBlock:
        # A budget already spent UPSTREAM (engine eval, another fanout
        # source) raises here, before the breaker: it is the query's
        # failure, not this peer's — a burst of slow queries must not
        # trip a healthy peer's breaker open.
        xdeadline.check_current("remote fetch")
        if self.breaker is not None:
            return self.breaker.call(
                lambda: self._fetch_raw(name, matchers, start_nanos,
                                        end_nanos))
        return self._fetch_raw(name, matchers, start_nanos, end_nanos)

    def _fetch_raw(self, name, matchers, start_nanos, end_nanos) -> RawBlock:
        dl = xdeadline.current()

        def payload() -> bytes:
            # encoded per attempt: the trailer must carry the budget
            # REMAINING at send time, not at first-attempt time; a
            # sampled query's bound TraceContext rides the tail
            return encode_fetch(name, matchers, start_nanos, end_nanos,
                                deadline_ms=xdeadline.remaining_ms(),
                                trace_ctx=tracing.current_wire())

        try:
            try:
                frame = self._round_trip(payload())
            except (OSError, wire.ProtocolError):
                # one reconnect attempt (server restarts are routine);
                # ``fresh`` dials a new socket — the restart that staled
                # this one staled every idle pooled socket too
                if dl is not None:
                    dl.check("remote fetch retry")
                frame = self._round_trip(payload(), fresh=True)
        except (socket.timeout, TimeoutError) as e:
            if dl is not None and dl.expired:
                raise dl.exceeded(
                    f"remote fetch {self.peer}: deadline exceeded") from e
            raise
        ftype, body = frame
        if ftype == wire.ERROR:
            raise _decode_query_error(body.decode())
        if ftype != QUERY_RESULT:
            raise wire.ProtocolError(f"unexpected frame type {ftype}")
        return decode_result(body)

    def close(self) -> None:
        self._pool.close()
