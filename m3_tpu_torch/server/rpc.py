"""dbnode socket RPC: the cross-process data plane.  The port's
counterpart of ``m3_tpu/server/rpc.py``: the same frame types, method
numbers and payload bytes (frames through the port's ``msg/protocol.py``),
so a port client talks to a reference server and the reverse.  Arrays
cross the wire as host numpy, never as device tensors: the server hands
the port's ``Database`` host arrays and the database moves them to its
device.

Equivalent of the reference's TChannel+Thrift ``Node`` service
(`src/dbnode/network/server/tchannelthrift/node/service.go` — Write
:1664, WriteTagged :1711, FetchTagged :736, FetchBlocksMetadataRawV2
:1529) plus the client side's per-host connections
(`src/dbnode/client/host_queue.go`, `connection_pool.go`).  Thrift
collapses to the framework's framed binary protocol (msg/protocol.py:
length prefix + type byte + adler32, struct-packed payloads) — same
contract, no IDL toolchain.

Two halves:

* ``DbNodeRpcServer`` — ThreadingTCPServer exporting a ``Database``'s
  data plane: write/write_tagged/read/query_ids, plus the block-level
  replication surface (list_block_filesets / block_metadata /
  read_block / write_block) that repair and peers bootstrap run
  against, and a tick method for harness-driven maintenance (the role
  of m3em agent operations in the reference's dtests).
* ``RemoteDatabase`` — a connection-holding client exposing the SAME
  method surface as a local ``Database`` handle, so
  ``client/session.py`` (quorum fan-out) and ``storage/repair.py``
  (anti-entropy, peers bootstrap) work unchanged against remote
  replicas.  Calls raise ``ConnectionError`` on transport failure; the
  session counts those as per-replica errors exactly like the
  reference's per-host op failures.  The client reconnects lazily on
  the next call, so a bounced node heals without new plumbing.

Query ASTs (index/search.py) and documents travel as a compact
recursive binary form (`_enc_query`).
"""

from __future__ import annotations

import re
import socket
import socketserver
import struct
import threading
from typing import Dict, List, Tuple

import numpy as np

from m3_tpu_torch.index import search
from m3_tpu_torch.index.doc import Document, Field
from m3_tpu_torch.instrument import tracing
from m3_tpu_torch.instrument.tracing import NOOP_TRACER, TraceContext, Tracepoint
from m3_tpu_torch.msg.protocol import (
    ProtocolError, connect as wire_connect, recv_frame, send_frame,
)
from m3_tpu_torch.x import deadline as xdeadline
from m3_tpu_torch.x import fault
from m3_tpu_torch.x.breaker import CircuitBreaker
from m3_tpu_torch.x.deadline import Deadline, DeadlineExceeded

# frame types (disjoint from the bus's so a misdirected client fails fast)
RPC_REQ = 16     # legacy request: [method u8][body]
RPC_OK = 17
RPC_ERR = 18
RPC_REQ_DL = 19  # deadline-carrying request: [method u8][budget ms i64][body]
RPC_REQ_TR = 20  # + trace context: [method u8][budget ms i64]
                 # [TraceContext 17B][body] — sent only for SAMPLED
                 # requests, so unsampled traffic stays RPC_REQ_DL-sized


class RemoteError(RuntimeError):
    """Application-level failure reported by the remote node (RPC_ERR
    frame): the transport is healthy but the call failed there — e.g. a
    segment checksum error on a corrupt replica.  Kept a RuntimeError
    subclass so pre-existing broad handlers still match; sweeps like
    repair catch it per replica and demote the handle instead of
    aborting (reference: per-host fetch failures in
    src/dbnode/storage/repair.go:115-246 fail only that host)."""


# ShardNotOwnedError crosses the wire TYPED (not as a generic
# RemoteError): the session must tell "your placement is stale, refresh
# and re-route" apart from "the data operation failed".  The server side
# encodes it like any error (type name prefix); the client re-raises the
# real class, parsing namespace/shard back out of the stable message.
_SHARD_NOT_OWNED_RE = re.compile(
    r"shard (\d+) not owned by this node \(namespace '([^']*)'\)"
)


def _decode_remote_error(msg: str):
    """RPC_ERR payload → the exception to raise client-side.  Besides
    routing misses, the overload family crosses typed too (via the
    shared ``x/deadline.decode_wire_error`` mapping): a remote
    ``QueryLimitExceeded`` must surface as 429 and a remote deadline
    trip as 504 at the API boundary, never a generic ``RemoteError``
    500."""
    if msg.startswith("ShardNotOwnedError:"):
        from m3_tpu_torch.storage.database import ShardNotOwnedError

        m = _SHARD_NOT_OWNED_RE.search(msg)
        if m:
            return ShardNotOwnedError(m.group(2), int(m.group(1)))
        return ShardNotOwnedError(None, None)
    typed = xdeadline.decode_wire_error(msg)
    if typed is not None:
        return typed
    return RemoteError(msg)

# methods
M_WRITE_BATCH = 1
M_WRITE_TAGGED = 2
M_READ = 3
M_QUERY_IDS = 4
M_LIST_BLOCKS = 5
M_BLOCK_META = 6
M_READ_BLOCK = 7
M_WRITE_BLOCK = 8
M_TICK = 9
M_HEALTH = 10
M_READ_BATCH = 11  # batched M_READ: one call, N ids, N point lists


# ---------------------------------------------------------------------------
# payload codecs
# ---------------------------------------------------------------------------


def _pack_bytes(b: bytes) -> bytes:
    return struct.pack("<I", len(b)) + b


def _unpack_bytes(raw: bytes, pos: int) -> Tuple[bytes, int]:
    (n,) = struct.unpack_from("<I", raw, pos)
    return raw[pos + 4: pos + 4 + n], pos + 4 + n


def _enc_query(q: search.Query) -> bytes:
    if isinstance(q, search.All):
        return b"\x00"
    if isinstance(q, search.Term):
        return b"\x01" + _pack_bytes(q.field) + _pack_bytes(q.value)
    if isinstance(q, search.Regexp):
        return b"\x02" + _pack_bytes(q.field) + _pack_bytes(q.pattern)
    if isinstance(q, search.FieldExists):
        return b"\x03" + _pack_bytes(q.field)
    if isinstance(q, search.Conjunction):
        return (b"\x04" + struct.pack("<H", len(q.queries))
                + b"".join(_enc_query(s) for s in q.queries))
    if isinstance(q, search.Disjunction):
        return (b"\x05" + struct.pack("<H", len(q.queries))
                + b"".join(_enc_query(s) for s in q.queries))
    if isinstance(q, search.Negation):
        return b"\x06" + _enc_query(q.query)
    raise TypeError(f"unencodable query node: {q!r}")


def _dec_query(raw: bytes, pos: int = 0) -> Tuple[search.Query, int]:
    kind = raw[pos]
    pos += 1
    if kind == 0:
        return search.All(), pos
    if kind == 1:
        f, pos = _unpack_bytes(raw, pos)
        v, pos = _unpack_bytes(raw, pos)
        return search.Term(f, v), pos
    if kind == 2:
        f, pos = _unpack_bytes(raw, pos)
        p, pos = _unpack_bytes(raw, pos)
        return search.Regexp(f, p), pos
    if kind == 3:
        f, pos = _unpack_bytes(raw, pos)
        return search.FieldExists(f), pos
    if kind in (4, 5):
        (n,) = struct.unpack_from("<H", raw, pos)
        pos += 2
        subs = []
        for _ in range(n):
            s, pos = _dec_query(raw, pos)
            subs.append(s)
        cls = search.Conjunction if kind == 4 else search.Disjunction
        return cls(*subs), pos
    if kind == 6:
        s, pos = _dec_query(raw, pos)
        return search.Negation(s), pos
    raise ProtocolError(f"bad query node kind {kind}")


def _enc_doc(d: Document) -> bytes:
    parts = [_pack_bytes(d.id), struct.pack("<H", len(d.fields))]
    for f in d.fields:
        parts.append(_pack_bytes(f.name))
        parts.append(_pack_bytes(f.value))
    return b"".join(parts)


def _dec_doc(raw: bytes, pos: int) -> Tuple[Document, int]:
    sid, pos = _unpack_bytes(raw, pos)
    (n,) = struct.unpack_from("<H", raw, pos)
    pos += 2
    fields = []
    for _ in range(n):
        name, pos = _unpack_bytes(raw, pos)
        value, pos = _unpack_bytes(raw, pos)
        fields.append(Field(name, value))
    return Document(sid, tuple(fields)), pos


def _enc_points(pts: List[Tuple[int, float]]) -> bytes:
    ts = np.fromiter((p[0] for p in pts), np.int64, len(pts))
    vs = np.fromiter((p[1] for p in pts), np.float64, len(pts))
    return struct.pack("<I", len(pts)) + ts.tobytes() + vs.tobytes()


def _dec_points(raw: bytes, pos: int) -> Tuple[List[Tuple[int, float]], int]:
    (n,) = struct.unpack_from("<I", raw, pos)
    pos += 4
    ts = np.frombuffer(raw, np.int64, n, pos)
    pos += 8 * n
    vs = np.frombuffer(raw, np.float64, n, pos)
    pos += 8 * n
    return list(zip(ts.tolist(), vs.tolist())), pos


def _enc_series_list(series) -> bytes:
    parts = [struct.pack("<I", len(series))]
    for sid, seg in series:
        parts.append(_pack_bytes(sid))
        parts.append(_pack_bytes(seg))
    return b"".join(parts)


def _dec_series_list(raw: bytes, pos: int):
    (n,) = struct.unpack_from("<I", raw, pos)
    pos += 4
    out = []
    for _ in range(n):
        sid, pos = _unpack_bytes(raw, pos)
        seg, pos = _unpack_bytes(raw, pos)
        out.append((sid, seg))
    return out, pos


def _enc_str(s: str) -> bytes:
    return _pack_bytes(s.encode())


def _dec_str(raw: bytes, pos: int) -> Tuple[str, int]:
    b, pos = _unpack_bytes(raw, pos)
    return b.decode(), pos


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


class _RpcHandler(socketserver.BaseRequestHandler):
    def handle(self):
        srv: DbNodeRpcServer = self.server
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        while True:
            try:
                frame = recv_frame(sock)
            except (ProtocolError, OSError):
                return
            if frame is None or frame[0] not in (RPC_REQ, RPC_REQ_DL,
                                                 RPC_REQ_TR):
                return
            payload = frame[1]
            try:
                # Socket-boundary faultpoint: drop closes the conn (a
                # crashed-mid-request peer), error returns a typed
                # RPC_ERR via the handler below, delay stalls dispatch.
                act, payload = fault.mangle("rpc.server", payload)
                if act == "drop":
                    return
                tctx = None
                if frame[0] in (RPC_REQ_DL, RPC_REQ_TR):
                    # [method u8][remaining-deadline ms i64][body]: bind
                    # the client's surviving budget so the server stops
                    # work (typed DeadlineExceeded → RPC_ERR) once the
                    # caller has given up; -1 = no deadline.  RPC_REQ_TR
                    # additionally carries the caller's TraceContext
                    # between the budget and the body.
                    hdr = 9
                    if frame[0] == RPC_REQ_TR:
                        hdr += TraceContext.WIRE_SIZE
                    if len(payload) < hdr:
                        raise ProtocolError("short rpc request")
                    (dl_ms,) = struct.unpack_from("<q", payload, 1)
                    dl = Deadline(dl_ms / 1000.0) if dl_ms >= 0 else None
                    if frame[0] == RPC_REQ_TR:
                        tctx = TraceContext.from_wire(payload, 9)
                    body = payload[hdr:]
                else:
                    # legacy [method u8][body] frame from a pre-deadline
                    # client (rolling upgrade): no budget, full service
                    if not payload:
                        raise ProtocolError("empty rpc request")
                    dl = None
                    body = payload[1:]
                with xdeadline.bind(dl), tracing.bind(tctx):
                    xdeadline.check_current("rpc dispatch")
                    # The server-side hop span: opened only for SAMPLED
                    # requests (a bound context), joining the caller's
                    # trace; everything _dispatch opens (db.writeBatch
                    # etc.) parents on it.  Untraced traffic pays one
                    # None-check, never a root span per request.
                    span = (srv.tracer.start_span(
                        Tracepoint.RPC_SERVER, {"method": int(payload[0])})
                        if tctx is not None else tracing.NOOP_SPAN)
                    with span:
                        resp = self._dispatch(srv.db, payload[0], body)
                send_frame(sock, RPC_OK, resp)
            except Exception as e:  # application error -> typed error frame
                try:
                    send_frame(sock, RPC_ERR,
                               f"{type(e).__name__}: {e}".encode()[:4096])
                except OSError:
                    return

    def _dispatch(self, db, method: int, raw: bytes) -> bytes:
        if method == M_HEALTH:
            return b"ok"
        if method in (M_WRITE_BATCH, M_WRITE_TAGGED):
            # Disk-pressure admission (assembly wires the gate from
            # x.diskbudget.check_ingest): at CRITICAL the batch is
            # refused BEFORE decode with the typed DiskCapacityError —
            # the RPC_ERR frame below makes it a per-replica failure
            # the session's consistency level absorbs, so nothing is
            # acked here and nothing is lost.  Reads, repair streams
            # and ticks are never gated.
            gate = getattr(self.server, "ingest_gate", None)
            if gate is not None:
                gate()
        if method == M_WRITE_BATCH:
            ns, pos = _dec_str(raw, 0)
            (now,) = struct.unpack_from("<q", raw, pos)
            pos += 8
            (n,) = struct.unpack_from("<I", raw, pos)
            pos += 4
            ids = []
            for _ in range(n):
                sid, pos = _unpack_bytes(raw, pos)
                ids.append(sid)
            ts = np.frombuffer(raw, np.int64, n, pos)
            pos += 8 * n
            vs = np.frombuffer(raw, np.float64, n, pos)
            res = db.write_batch(ns, ids, ts.copy(), vs.copy(),
                                 None if now == -1 else now)
            # (ncold, new-series rejections): the wire carries the typed
            # back-pressure signal so remote writers see churn limits.
            return struct.pack("<II", int(res), getattr(res, "rejected", 0))
        if method == M_WRITE_TAGGED:
            ns, pos = _dec_str(raw, 0)
            (now,) = struct.unpack_from("<q", raw, pos)
            pos += 8
            (n,) = struct.unpack_from("<I", raw, pos)
            pos += 4
            docs = []
            for _ in range(n):
                d, pos = _dec_doc(raw, pos)
                docs.append(d)
            ts = np.frombuffer(raw, np.int64, n, pos)
            pos += 8 * n
            vs = np.frombuffer(raw, np.float64, n, pos)
            res = db.write_tagged_batch(ns, docs, ts.copy(), vs.copy(),
                                        None if now == -1 else now)
            return struct.pack("<II", int(res), getattr(res, "rejected", 0))
        if method == M_READ:
            ns, pos = _dec_str(raw, 0)
            sid, pos = _unpack_bytes(raw, pos)
            start, end = struct.unpack_from("<qq", raw, pos)
            return _enc_points(db.read(ns, sid, start, end))
        if method == M_READ_BATCH:
            # Batched read: the ledger-verify / bulk-fetch wire shape.
            # One storage read_batch amortizes the per-window sort
            # across every id; the response is each id's point list in
            # request order.
            ns, pos = _dec_str(raw, 0)
            start, end = struct.unpack_from("<qq", raw, pos)
            pos += 16
            (n,) = struct.unpack_from("<I", raw, pos)
            pos += 4
            sids = []
            for _ in range(n):
                sid, pos = _unpack_bytes(raw, pos)
                sids.append(sid)
            out = db.read_batch(ns, sids, start, end)
            return (struct.pack("<I", len(out))
                    + b"".join(_enc_points(p) for p in out))
        if method == M_QUERY_IDS:
            ns, pos = _dec_str(raw, 0)
            start, end = struct.unpack_from("<qq", raw, pos)
            pos += 16
            q, pos = _dec_query(raw, pos)
            docs = db.query_ids(ns, q, start, end)
            return (struct.pack("<I", len(docs))
                    + b"".join(_enc_doc(d) for d in docs))
        if method == M_LIST_BLOCKS:
            ns, pos = _dec_str(raw, 0)
            (shard,) = struct.unpack_from("<i", raw, pos)
            pairs = db.list_block_filesets(ns, shard)
            return (struct.pack("<I", len(pairs))
                    + b"".join(struct.pack("<qi", bs, vol)
                               for bs, vol in pairs))
        if method == M_BLOCK_META:
            ns, pos = _dec_str(raw, 0)
            shard, bs = struct.unpack_from("<iq", raw, pos)
            meta = db.block_metadata(ns, shard, bs)
            if meta is None:
                return b"\x00"
            parts = [b"\x01", struct.pack("<I", len(meta))]
            for sid, ck in sorted(meta.items()):
                parts.append(_pack_bytes(sid))
                parts.append(struct.pack("<I", ck))
            return b"".join(parts)
        if method == M_READ_BLOCK:
            ns, pos = _dec_str(raw, 0)
            shard, bs = struct.unpack_from("<iq", raw, pos)
            return _enc_series_list(db.read_block(ns, shard, bs))
        if method == M_WRITE_BLOCK:
            ns, pos = _dec_str(raw, 0)
            shard, bs = struct.unpack_from("<iq", raw, pos)
            pos += 12
            series, pos = _dec_series_list(raw, pos)
            db.write_block(ns, shard, bs, series)
            return b""
        if method == M_TICK:
            (now,) = struct.unpack_from("<q", raw, 0)
            db.tick(now)
            return b""
        raise ProtocolError(f"unknown rpc method {method}")


class DbNodeRpcServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, db, host: str = "127.0.0.1", port: int = 0,
                 tracer=None):
        self.db = db
        # default to the database's tracer so rpc.server spans land in
        # the same ring the debug endpoint serves
        self.tracer = (tracer if tracer is not None
                       else getattr(db, "tracer", None) or NOOP_TRACER)
        # Optional nullary admission gate for the write methods (raises
        # typed to refuse a batch un-acked); assembly binds it to the
        # disk ledger's check_ingest when disk.enabled.
        self.ingest_gate = None
        super().__init__((host, port), _RpcHandler)

    @property
    def port(self) -> int:
        return self.server_address[1]


def serve_rpc_background(db, host: str = "127.0.0.1",
                         port: int = 0, tracer=None) -> DbNodeRpcServer:
    srv = DbNodeRpcServer(db, host, port, tracer=tracer)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


class RemoteDatabase:
    """Database-shaped handle over one RPC connection.

    Lazily (re)connects per call; any transport failure closes the
    socket and raises ConnectionError so quorum layers can count the
    replica as failed and the next call can retry a bounced node.

    Deadline-aware: with a query deadline bound (x/deadline), per-call
    socket timeouts derive from ``remaining()`` (capped at
    ``timeout_s``), the surviving budget rides the RPC_REQ_DL frame so the
    server stops work too, and a transport timeout with the budget
    spent surfaces typed as ``DeadlineExceeded``.  An optional shared
    ``breaker`` (x/breaker, one per peer) makes calls to a dead node
    fail fast for every holder at once."""

    def __init__(self, address: Tuple[str, int], timeout_s: float = 180.0,
                 breaker: CircuitBreaker | None = None):
        # The generous default absorbs one-time jit compiles behind
        # flush/tick paths on a freshly started node (CPU backend pays
        # tens of seconds for the encoder scan); connect failures to a
        # dead node still surface immediately (ECONNREFUSED).
        self.address = tuple(address)
        self.timeout_s = timeout_s
        self.breaker = breaker
        self._sock: socket.socket | None = None
        self._mu = threading.Lock()

    # -- transport --

    def _connect(self) -> socket.socket:
        # dial timeout from the bound deadline's remaining budget
        # (capped by the legacy constant, never extended past it)
        return wire_connect(self.address,
                            timeout=xdeadline.socket_timeout(self.timeout_s))

    def _call(self, method: int, body: bytes) -> bytes:
        # A budget spent before this call is the QUERY's failure, not
        # this peer's: raise outside the breaker so overload upstream
        # cannot trip a healthy node's breaker open.
        xdeadline.check_current("rpc call")
        if self.breaker is not None:
            return self.breaker.call(lambda: self._call_inner(method, body))
        return self._call_inner(method, body)

    def _call_inner(self, method: int, body: bytes) -> bytes:
        dl = xdeadline.current()
        # Sampled callers (a bound trace context — e.g. the session's
        # replica fan-out span) upgrade the frame to RPC_REQ_TR so the
        # server's dispatch joins their trace; everyone else stays on
        # the deadline-only frame.  One contextvar read per call.
        tctx_wire = tracing.current_wire()
        ftype = RPC_REQ_TR if tctx_wire else RPC_REQ_DL
        header = (bytes([method]) + struct.pack("<q", xdeadline.remaining_ms())
                  + tctx_wire)
        with self._mu:
            try:
                # Socket-boundary faultpoint: drop/error surface as the
                # ConnectionError quorum layers count per replica (and
                # the session's retrier absorbs); delay = slow peer.
                if fault.fire("rpc.call") == "drop":
                    raise fault.FaultInjected("rpc.call: request dropped")
                if self._sock is None:
                    self._sock = self._connect()
                # per-call timeout from the remaining budget: a wire
                # hop must never outlive its query (raises typed when
                # the budget is already spent)
                self._sock.settimeout(
                    xdeadline.socket_timeout(self.timeout_s))
                send_frame(self._sock, ftype, header + body)
                frame = recv_frame(self._sock)
            except DeadlineExceeded:
                raise  # budget spent BEFORE I/O: the socket is intact
            except (OSError, ProtocolError) as e:
                self._drop()
                if dl is not None and dl.expired:
                    raise dl.exceeded(
                        f"rpc {self.address}: deadline exceeded") from e
                raise ConnectionError(f"rpc {self.address}: {e}") from e
            if frame is None:
                self._drop()
                raise ConnectionError(f"rpc {self.address}: connection closed")
        ftype, payload = frame
        if ftype == RPC_ERR:
            raise _decode_remote_error(payload.decode(errors="replace"))
        if ftype != RPC_OK:
            # _drop mutates the connection — retake the lock (the frame
            # was already read; another caller may be mid-_call).
            with self._mu:
                self._drop()
            raise ConnectionError(f"rpc {self.address}: bad frame {ftype}")
        return payload

    def _drop(self) -> None:
        # All callers hold self._mu (the _call error paths run inside
        # the with-block; close() and the bad-frame path retake it).
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None  # m3lint: disable=lock-discipline

    def close(self) -> None:
        with self._mu:
            self._drop()

    # -- data plane --

    def health(self) -> bool:
        return self._call(M_HEALTH, b"") == b"ok"

    def write_batch(self, namespace, ids, ts, vals, now_nanos=None) -> None:
        ts = np.asarray(ts, np.int64)
        vals = np.asarray(vals, np.float64)
        body = (_enc_str(namespace)
                + struct.pack("<q", -1 if now_nanos is None else now_nanos)
                + struct.pack("<I", len(ids))
                + b"".join(_pack_bytes(i) for i in ids)
                + ts.tobytes() + vals.tobytes())
        return self._dec_write_result(self._call(M_WRITE_BATCH, body))

    def write_tagged_batch(self, namespace, docs, ts, vals,
                           now_nanos=None) -> None:
        ts = np.asarray(ts, np.int64)
        vals = np.asarray(vals, np.float64)
        body = (_enc_str(namespace)
                + struct.pack("<q", -1 if now_nanos is None else now_nanos)
                + struct.pack("<I", len(docs))
                + b"".join(_enc_doc(d) for d in docs)
                + ts.tobytes() + vals.tobytes())
        return self._dec_write_result(self._call(M_WRITE_TAGGED, body))

    @staticmethod
    def _dec_write_result(payload: bytes):
        from m3_tpu_torch.storage.database import WriteResult

        if len(payload) < 8:
            return WriteResult(0, 0)
        ncold, rejected = struct.unpack_from("<II", payload, 0)
        return WriteResult(ncold, rejected)

    def read(self, namespace, sid, start, end):
        body = (_enc_str(namespace) + _pack_bytes(sid)
                + struct.pack("<qq", start, end))
        pts, _ = _dec_points(self._call(M_READ, body), 0)
        return pts

    def read_batch(self, namespace, sids, start, end):
        """Batched read: N ids in one round trip, point lists back in
        request order (the soak ledger verify reads millions of acked
        samples — per-id round trips would dominate the recovery
        check)."""
        body = (_enc_str(namespace) + struct.pack("<qq", start, end)
                + struct.pack("<I", len(sids))
                + b"".join(_pack_bytes(s) for s in sids))
        raw = self._call(M_READ_BATCH, body)
        (n,) = struct.unpack_from("<I", raw, 0)
        pos = 4
        out = []
        for _ in range(n):
            pts, pos = _dec_points(raw, pos)
            out.append(pts)
        return out

    def query_ids(self, namespace, q, start, end):
        body = (_enc_str(namespace) + struct.pack("<qq", start, end)
                + _enc_query(q))
        raw = self._call(M_QUERY_IDS, body)
        (n,) = struct.unpack_from("<I", raw, 0)
        pos = 4
        docs = []
        for _ in range(n):
            d, pos = _dec_doc(raw, pos)
            docs.append(d)
        return docs

    # -- block-level replication surface --

    def list_block_filesets(self, namespace, shard):
        raw = self._call(M_LIST_BLOCKS,
                         _enc_str(namespace) + struct.pack("<i", shard))
        (n,) = struct.unpack_from("<I", raw, 0)
        pos = 4
        out = []
        for _ in range(n):
            bs, vol = struct.unpack_from("<qi", raw, pos)
            pos += 12
            out.append((bs, vol))
        return out

    def block_metadata(self, namespace, shard, block_start):
        raw = self._call(M_BLOCK_META, _enc_str(namespace)
                         + struct.pack("<iq", shard, block_start))
        if raw[0] == 0:
            return None
        (n,) = struct.unpack_from("<I", raw, 1)
        pos = 5
        meta: Dict[bytes, int] = {}
        for _ in range(n):
            sid, pos = _unpack_bytes(raw, pos)
            (ck,) = struct.unpack_from("<I", raw, pos)
            pos += 4
            meta[sid] = ck
        return meta

    def read_block(self, namespace, shard, block_start):
        raw = self._call(M_READ_BLOCK, _enc_str(namespace)
                         + struct.pack("<iq", shard, block_start))
        series, _ = _dec_series_list(raw, 0)
        return series

    def write_block(self, namespace, shard, block_start, series) -> None:
        body = (_enc_str(namespace) + struct.pack("<iq", shard, block_start)
                + _enc_series_list(list(series)))
        self._call(M_WRITE_BLOCK, body)

    # -- harness-driven maintenance (m3em agent role) --

    def tick(self, now_nanos: int) -> None:
        self._call(M_TICK, struct.pack("<q", now_nanos))
