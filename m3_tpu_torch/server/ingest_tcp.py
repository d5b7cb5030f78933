"""TCP ingest server: the aggregator's wire front door.  The port's copy
of ``m3_tpu/server/ingest_tcp.py``: the same queue, budgets, replies,
faultpoint and instruments, in front of the port's ``Aggregator``.

Equivalent of the reference's rawtcp server
(`src/aggregator/server/rawtcp/server.go:52 struct, :125 handle loop`):
accept connections, iterate framed metric batches off each socket, and
feed them to the aggregator.  The reference's per-message protobuf
decode loop becomes one frame = one already-batched array payload — the
batching the reference does in its client queues happens in the wire
format itself.

Robustness (reference rawtcp sheds load on slow consumers): decoded
frames no longer run the sink inline on the handler thread — they land
in ONE bounded global ingest queue drained by a worker, and two budgets
guard it:

* a global high-watermark (``max_queue_frames``) — total decoded
  frames in flight across every connection;
* a per-connection inflight budget (``per_conn_inflight``) — one
  flooding client cannot own the whole queue.

A frame arriving over budget is REJECTED with an explicit
``INGEST_BACKOFF`` frame (retry-after hint) instead of silently
stalling the socket or dropping the connection; the connection stays
up and the shed is counted.  Clients that sent ``INGEST_HELLO`` with
the want-acks flag additionally receive ``INGEST_ACK`` after each
frame is FULLY ingested — the ack is the durability boundary, so a
well-behaved client never counts a sample as delivered that the server
then loses.  Legacy clients (no HELLO) see no reply traffic except
BACKOFF under overload — the pre-existing fire-and-forget contract.

A decode/protocol error still closes the connection (rawtcp's error
handling); the ``ingest_tcp.frame`` faultpoint (the port's ``x.fault``
registry) sits between recv and decode so a test can inject
drop/delay/corrupt/error at the exact socket boundary.

As in the reference, the sink drops a frame's ``agg_id``: every sample
takes its metric type's default aggregations.  The sink's lock is the
one a ``FlushManager`` tick must hold too: ``tick`` takes none, and the
ingest worker is a second thread on the same arenas.
"""

from __future__ import annotations

import queue
import select
import socket
import socketserver
import threading
import time

import numpy as np

from m3_tpu_torch.instrument import tracing
from m3_tpu_torch.instrument.tracing import NOOP_TRACER, Tracepoint
from m3_tpu_torch.metrics.policy import StoragePolicy
from m3_tpu_torch.metrics.types import MetricType
from m3_tpu_torch.msg import protocol as wire
from m3_tpu_torch.x import fault


class _IngestMetrics:
    """The server's instruments, interned ONCE at construction: the
    handler/worker loops run per frame, and a per-call registry
    intern (name lookup under the registry lock) would be hot-path
    waste."""

    __slots__ = ("decode_errors", "unknown_frames", "fault_errors",
                 "shed_frames", "shed_samples", "sink_errors", "samples",
                 "queue_depth", "batch_seconds")

    def __init__(self, scope):
        self.decode_errors = scope.counter("decode_errors")
        self.unknown_frames = scope.counter("unknown_frames")
        self.fault_errors = scope.counter("fault_errors")
        self.shed_frames = scope.counter("shed_frames")
        self.shed_samples = scope.counter("shed_samples")
        self.sink_errors = scope.counter("sink_errors")
        self.samples = scope.counter("samples")
        self.queue_depth = scope.gauge("queue_depth")
        # hot-path latency: windowed log-bucket histogram (mergeable
        # across nodes), NOT a lifetime-reservoir Timer
        self.batch_seconds = scope.histogram("batch_seconds")


def aggregator_sink(aggregator, lock: threading.Lock | None = None,
                    clock=time.time_ns):
    """Standard sink: group a wire batch by metric type (the engine
    ingests one type per call, like the reference's per-union dispatch
    in AddUntimed) and feed the aggregator under `lock`.

    The returned sink handles all three ingest classes (reference
    aggregator.go AddUntimed :263 / AddTimed :77 / AddPassthrough :86)
    via its ``kind`` argument — the frame type dispatches in the
    handler."""
    lock = lock or threading.Lock()

    def sink(batch, kind: int = wire.METRIC_BATCH) -> None:
        with lock:
            if kind == wire.PASSTHROUGH_BATCH:
                policy, ids, values, times = batch
                aggregator.add_passthrough_batch(
                    ids, values, times, StoragePolicy.parse(policy))
                return
            if kind == wire.FORWARDED_BATCH:
                policy, entries = batch
                aggregator.add_forwarded_batch(
                    StoragePolicy.parse(policy), entries)
                return
            mts = np.asarray(batch.metric_types)
            for mt in np.unique(mts):
                sel = np.nonzero(mts == mt)[0]
                ids = [batch.ids[i] for i in sel]
                if kind == wire.TIMED_BATCH:
                    # The server clock anchors fresh window rings
                    # (entry.go addTimed validates against now±buffer).
                    aggregator.add_timed_batch(
                        MetricType(int(mt)), ids,
                        batch.values[sel], batch.times[sel],
                        now_nanos=clock())
                else:
                    aggregator.add_untimed_batch(
                        MetricType(int(mt)), ids,
                        batch.values[sel], batch.times[sel])

    return sink


_BATCH_FRAMES = (wire.METRIC_BATCH, wire.TIMED_BATCH,
                 wire.PASSTHROUGH_BATCH, wire.FORWARDED_BATCH)


class _ConnState:
    """Per-connection book-keeping shared by the handler thread (recv,
    shed replies) and the ingest worker (acks): the write lock keeps a
    BACKOFF and an ACK from interleaving mid-frame on the socket.
    ``pending_trace`` is handler-thread-only: set by an INGEST_TRACE
    preamble frame, attached to the NEXT batch frame enqueued."""

    __slots__ = ("want_acks", "inflight", "wlock", "pending_trace")

    def __init__(self):
        self.want_acks = False
        self.inflight = 0  # frames queued; guarded by server._q_lock
        self.wlock = threading.Lock()
        self.pending_trace = None


class _IngestHandler(socketserver.BaseRequestHandler):
    def handle(self):
        srv = self.server
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn = _ConnState()
        mx = srv.metrics
        while True:
            try:
                frame = wire.recv_frame(sock)
            except (wire.ProtocolError, OSError):
                if mx is not None:
                    mx.decode_errors.inc()
                break
            if frame is None:
                break
            ftype, payload = frame
            if ftype == wire.INGEST_HELLO:
                try:
                    conn.want_acks = bool(
                        wire.decode_ingest_hello(payload)
                        & wire.HELLO_WANT_ACKS)
                except Exception:  # noqa: BLE001
                    if mx is not None:
                        mx.decode_errors.inc()
                    break
                continue
            if ftype == wire.INGEST_TRACE:
                # sampled client: the context rides a preamble frame
                # and stitches the NEXT batch's span into its trace
                try:
                    conn.pending_trace = wire.decode_ingest_trace(payload)
                except Exception:  # noqa: BLE001
                    if mx is not None:
                        mx.decode_errors.inc()
                    break
                continue
            if ftype not in _BATCH_FRAMES:
                if mx is not None:
                    mx.unknown_frames.inc()
                break
            # Socket-boundary faultpoint: drop kills the connection
            # (the lost-frame case rawtcp clients must survive), error
            # acts like a transport failure, corrupt feeds the decode
            # path a flipped byte, delay models a slow server.
            try:
                act, payload = fault.mangle("ingest_tcp.frame", payload)
            except fault.FaultInjected:
                if mx is not None:
                    mx.fault_errors.inc()
                break
            if act == "drop":
                break
            try:
                if ftype == wire.PASSTHROUGH_BATCH:
                    batch = wire.decode_passthrough_batch(payload)
                    n = len(batch[1])
                elif ftype == wire.FORWARDED_BATCH:
                    batch = wire.decode_forwarded_batch(payload)
                    n = len(batch[1])
                else:
                    batch = wire.decode_metric_batch(payload)
                    n = len(batch.ids)
            except (wire.ProtocolError, Exception):  # noqa: BLE001
                if mx is not None:
                    mx.decode_errors.inc()
                break
            tctx, conn.pending_trace = conn.pending_trace, None
            if not srv._try_enqueue(conn, sock, ftype, batch, n, tctx):
                # Load shed: explicit BACKOFF, connection stays up.
                # Writability-probed: a fire-and-forget client that
                # never reads its socket eventually closes the TCP
                # window, and a blocking send here would wedge this
                # handler (it must keep reading) — such a client gets
                # dropped instead.
                if mx is not None:
                    mx.shed_frames.inc()
                    mx.shed_samples.inc(n)
                with conn.wlock:
                    try:
                        _, writable, _ = select.select(
                            [], [sock], [], srv.ack_send_timeout_s)
                        if not writable:
                            break
                        wire.send_frame(
                            sock, wire.INGEST_BACKOFF,
                            wire.encode_ingest_backoff(srv.backoff_hint_ms))
                    except OSError:
                        break
                continue


class IngestServer(socketserver.ThreadingTCPServer):
    """sink(MetricBatch) is called per decoded frame — typically
    `lambda b: aggregator.add_untimed_batch(b.metric_types, b.ids,
    b.values, b.times)` behind a lock.

    Decoded frames flow through a bounded global queue drained by one
    worker thread (frame order per connection is preserved); acks are
    sent only after the sink call returns, so an acked frame is an
    ingested frame."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, sink, host: str = "127.0.0.1", port: int = 0,
                 instrument=None, aggregator=None,
                 max_queue_frames: int = 256, per_conn_inflight: int = 64,
                 backoff_hint_ms: int = 50, ack_send_timeout_s: float = 5.0,
                 tracer=None):
        self.sink = sink
        self.ack_send_timeout_s = ack_send_timeout_s
        self._closing = False
        self.scope = (
            instrument.scope("ingest_tcp") if instrument is not None else None
        )
        # instruments interned once (hot path: per-frame loops)
        self.metrics = (_IngestMetrics(self.scope)
                        if self.scope is not None else None)
        self.tracer = tracer if tracer is not None else NOOP_TRACER
        self.max_queue_frames = max_queue_frames
        self.per_conn_inflight = per_conn_inflight
        self.backoff_hint_ms = backoff_hint_ms
        # Optional nullary admission gate (raises typed DiskCapacityError
        # to refuse a frame un-acked), e.g. a disk ledger's check_ingest.
        self.ingest_gate = None
        self._queue: "queue.Queue" = queue.Queue()
        self._q_lock = threading.Lock()
        self._inflight = 0
        self._agg_collector = None
        self._registry = (
            instrument.registry if instrument is not None else None)
        super().__init__((host, port), _IngestHandler)
        self._worker = threading.Thread(target=self._drain, daemon=True)
        self._worker.start()
        if instrument is not None and aggregator is not None:
            # Surface the engine's plain-int counters (forwarded-tail
            # conflicts, timed rejects, series-limit rejects) on this
            # process's /metrics at scrape time.  After bind — a
            # failed construction must not leak the collector.
            from m3_tpu_torch.aggregator.engine import instrument_aggregator

            self._agg_collector = instrument_aggregator(
                instrument, aggregator)

    # -- ingest queue ------------------------------------------------------

    def _try_enqueue(self, conn, sock, ftype, batch, n, tctx=None) -> bool:
        # Disk-pressure shed rides the SAME refuse-before-ack path as
        # queue overflow: at CRITICAL the frame is never enqueued, the
        # client gets the explicit BACKOFF hint, and since the ack is
        # the durability boundary nothing un-acked is lost.
        gate = self.ingest_gate
        if gate is not None:
            try:
                gate()
            except OSError:  # DiskCapacityError — typed capacity refuse
                return False
        with self._q_lock:
            # A server mid-shutdown sheds (explicit BACKOFF) rather
            # than enqueueing onto a queue whose worker is stopping —
            # clients get a prompt signal instead of an ack that never
            # comes.
            if (self._closing
                    or self._inflight >= self.max_queue_frames
                    or conn.inflight >= self.per_conn_inflight):
                return False
            self._inflight += 1
            conn.inflight += 1
            if self.metrics is not None:
                self.metrics.queue_depth.update(self._inflight)
            # put() under the lock (never blocks: the Queue is
            # unbounded; the watermark above is the real bound) so an
            # accepted frame can never land AFTER the shutdown
            # sentinel, which is enqueued under this same lock.
            self._queue.put((conn, sock, ftype, batch, n, tctx))
        return True

    def _drain(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            conn, sock, ftype, batch, n, tctx = item
            t0 = time.perf_counter()
            try:
                # The worker thread never inherits a binding
                # (contextvar rule): the frame's own context is bound
                # here — BEFORE the span opens, so the batch span
                # parents on the SENDER's span, joining its trace.
                with tracing.bind(tctx):
                    span = (self.tracer.start_span(
                        Tracepoint.INGEST_TCP_BATCH,
                        {"n": n, "frame": ftype})
                        if tctx is not None else tracing.NOOP_SPAN)
                    with span:
                        if ftype == wire.METRIC_BATCH:
                            # one-arg call: custom sinks keep working
                            self.sink(batch)
                        else:
                            self.sink(batch, ftype)
            except Exception:  # noqa: BLE001 — a sink fault (e.g. no
                # passthrough handler configured, or a one-arg custom
                # sink receiving a timed frame) must close THIS
                # connection with a counter, not kill the worker
                # thread with an unrecorded traceback.
                self._dec_inflight(conn)
                if self.metrics is not None:
                    self.metrics.sink_errors.inc()
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                continue
            self._dec_inflight(conn)
            if self.metrics is not None:
                self.metrics.samples.inc(n)
                self.metrics.batch_seconds.record(time.perf_counter() - t0)
            if conn.want_acks:
                with conn.wlock:
                    # The lone drain worker must never wedge on one
                    # stalled client's full send buffer (it serves
                    # EVERY connection): probe writability first and
                    # drop the stalled connection instead of blocking.
                    try:
                        _, writable, _ = select.select(
                            [], [sock], [], self.ack_send_timeout_s)
                        if writable:
                            wire.send_frame(sock, wire.INGEST_ACK,
                                            wire.encode_ingest_ack(n))
                        else:
                            sock.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass  # client went away; its loss is counted
                        # client-side by the missing ack

    def _dec_inflight(self, conn) -> None:
        with self._q_lock:
            self._inflight -= 1
            conn.inflight -= 1
            if self.metrics is not None:
                self.metrics.queue_depth.update(self._inflight)

    # -- lifecycle ---------------------------------------------------------

    def _drop_collector(self):
        if self._agg_collector is not None and self._registry is not None:
            self._registry.unregister_collector(self._agg_collector)
            self._agg_collector = None

    def _stop_worker(self):
        if self._worker is not None:
            with self._q_lock:
                # _closing is already observed by the gate under this
                # lock, so the sentinel lands strictly after every
                # accepted frame: the worker drains the backlog (acks
                # included) before exiting.
                self._queue.put(None)
            self._worker.join(timeout=30)
            self._worker = None

    def shutdown(self):
        # Every call site stops via shutdown() (server_close is rarer):
        # drop the collector on either path, or the registry pins this
        # server's aggregator and scrapes it forever.  Order: flag
        # closing (handlers shed new frames), stop the accept loop,
        # then the worker drains the backlog (acks included) and exits.
        # _closing flips under _q_lock: the shed gate reads it under
        # that lock, so no handler can observe the pre-closing state
        # after this releases.
        self._drop_collector()
        with self._q_lock:
            self._closing = True
        super().shutdown()
        self._stop_worker()

    def server_close(self):
        self._drop_collector()
        with self._q_lock:
            self._closing = True
        self._stop_worker()
        super().server_close()

    @property
    def port(self) -> int:
        return self.server_address[1]


def serve_ingest_background(sink, host: str = "127.0.0.1", port: int = 0,
                            instrument=None, aggregator=None,
                            **kw) -> IngestServer:
    srv = IngestServer(sink, host, port, instrument, aggregator, **kw)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv
