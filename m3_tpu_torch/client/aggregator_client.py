"""Shard-routed aggregator client: per-instance queues over TCP.

Equivalent of the reference's aggregator client
(`src/aggregator/client/tcp_client.go` shard-aware routing from the
placement, `queue.go` per-instance buffered queues, `writer.go`
encode+flush).  Samples are routed shard = murmur3(id) % num_shards
(the aggregator's own router), buffered per owning instance, and
flushed as framed `METRIC_BATCH` payloads by a background writer thread
(or an explicit `flush()`).

Replica fan-out: every AVAILABLE owner of the shard receives the batch
(the reference writes to all instances in the shard's replica set —
mirrored placements — and lets leader election pick the emitter).

The port's copy of ``m3_tpu/client/aggregator_client.py``.  The batch
entry points (``write_batch``, ``write_timed_batch``,
``write_passthrough``) route a whole batch at once — one shard lookup a
sample, then one bulk append per owning instance — and leave every
queue, its order, its drop-oldest count and every frame's bytes as the
per-sample loop of the reference leaves them."""

from __future__ import annotations

import socket
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, Tuple

import numpy as np

from m3_tpu_torch.cluster.placement import Placement, ShardState
from m3_tpu_torch.core.hash import shard_for, shards_for
from m3_tpu_torch.instrument import tracing
from m3_tpu_torch.msg import protocol as wire
from m3_tpu_torch.x import fault
from m3_tpu_torch.x.retry import Retrier, RetryOptions


class _Backoff(Exception):
    """Server shed the frame (INGEST_BACKOFF): not a transport failure,
    so it must NOT be retried on the spot — the client parks the batch
    and honors the retry-after hint."""

    def __init__(self, retry_after_ms: int):
        super().__init__(f"server backoff {retry_after_ms}ms")
        self.retry_after_ms = retry_after_ms


class InstanceQueue:
    """Buffered samples + a lazily-connected socket for one instance
    (reference client/queue.go).  Connection errors park the buffer for
    the next flush (bounded by max_queue_size, drop-oldest).

    With ``want_acks`` (default), the connection opts into per-frame
    acknowledgements (INGEST_HELLO): a flush counts samples as ``sent``
    only after the server's INGEST_ACK — i.e. after the frame was fully
    ingested — so an acknowledged sample can never be silently shed
    server-side.  An INGEST_BACKOFF reply parks the batch and pauses
    flushing for the server's retry-after hint; transport failures
    retry on the x/retry schedule before parking.

    Delivery semantics are AT-LEAST-ONCE: when the connection dies
    after the server ingested a frame but before its ack was read, the
    retry resends the batch and the server ingests it again (the
    reference client's reconnect-and-replay queues make the same
    trade; losing acknowledged samples would be the worse failure).
    Acks also serialize the flush path — one frame in flight per
    queue, and since ``AggregatorClient.flush`` walks its queues on one
    thread, a cold/stalled instance head-of-line blocks the OTHER
    queues' flushes for up to ``ack_timeout_s`` too.  Pass
    ``want_acks=False`` (or a small ``ack_timeout_s``) where delivery
    latency matters more than the durability signal."""

    def __init__(self, address: Tuple[str, int], max_queue_size: int = 1 << 16,
                 frame_type: int = wire.METRIC_BATCH,
                 want_acks: bool = True, ack_timeout_s: float = 180.0,
                 retry_options: RetryOptions | None = None):
        self.address = address
        self.max_queue_size = max_queue_size
        self.frame_type = frame_type
        self.want_acks = want_acks
        # Generous ack default: the server's FIRST ingest pays one-time
        # kernel builds; a short timeout here would resend and duplicate.
        self.ack_timeout_s = ack_timeout_s
        self.retrier = Retrier(
            retry_options or RetryOptions(
                initial_backoff_s=0.05, max_backoff_s=1.0, max_attempts=3),
            name="ingest_client")
        self._mts: list[int] = []
        self._ids: list[bytes] = []
        self._values: list[float] = []
        self._times: list[int] = []
        self._sock: socket.socket | None = None
        self._lock = threading.Lock()
        # Serializes socket I/O: flush() (user thread AND auto-flush
        # thread) and send_raw() share one connection; interleaved
        # send/recv from two threads would steal each other's acks.
        self._io_lock = threading.Lock()
        self._backoff_until = 0.0
        self.dropped = 0
        self.sent = 0
        self.backoffs = 0
        # Trace-preamble compat state (guarded by _io_lock): a
        # pre-round-10 server kills the connection on the INGEST_TRACE
        # frame type, so if this connection dies after sending one we
        # permanently stop sending preambles on this queue — a mixed
        # fleet degrades to untraced delivery instead of a reconnect
        # loop (the batch itself is retried by the normal park/flush
        # machinery).
        self._trace_disabled = False
        self._sock_sent_trace = False

    def _connect(self) -> socket.socket:
        if self._sock is None:
            # fresh socket, no preamble yet; _connect only runs from
            # _send_one, which holds _io_lock
            self._sock_sent_trace = False  # m3lint: disable=lock-discipline
            s = wire.connect(self.address)
            try:
                if self.want_acks:
                    s.settimeout(self.ack_timeout_s)
                    wire.send_frame(s, wire.INGEST_HELLO,
                                    wire.encode_ingest_hello())
            except BaseException:
                # a failed HELLO must not leak the half-set-up socket
                s.close()
                raise
            self._sock = s
        return self._sock

    def _drop_sock(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def enqueue(self, mt: int, mid: bytes, value: float, t: int) -> None:
        with self._lock:
            if len(self._ids) >= self.max_queue_size:
                # drop-oldest (reference queue DropOldest strategy)
                self._mts.pop(0)
                self._ids.pop(0)
                self._values.pop(0)
                self._times.pop(0)
                self.dropped += 1
            self._mts.append(mt)
            self._ids.append(mid)
            self._values.append(value)
            self._times.append(t)

    def enqueue_many(self, mts, mids: list, values, times) -> None:
        """``enqueue`` for each sample in order, in one append: the
        queue keeps its newest ``max_queue_size`` samples and counts
        the rest as dropped, as the one-at-a-time drop-oldest does."""
        with self._lock:
            self._mts.extend(mts)
            self._ids.extend(mids)
            self._values.extend(values)
            self._times.extend(times)
            over = len(self._ids) - self.max_queue_size
            if over > 0:
                del self._mts[:over], self._ids[:over]
                del self._values[:over], self._times[:over]
                self.dropped += over

    def _send_one(self, ftype: int, payload: bytes) -> None:
        """One framed send (+ ack wait when enabled); raises _Backoff on
        a shed, ConnectionError/OSError on transport failure.  Holds
        the I/O lock for the whole send→ack exchange (retry backoffs
        happen outside, in the retrier)."""
        with self._io_lock:
            if fault.fire("ingest_tcp.send") == "drop":
                self._drop_sock()
                raise fault.FaultInjected("ingest_tcp.send: frame dropped")
            sock = self._connect()
            try:
                # Sampled caller (a bound trace context at SEND time —
                # e.g. a coordinator's api.write span): the context
                # rides an INGEST_TRACE preamble so the server's batch
                # span joins the trace.  Unsampled traffic sends
                # nothing extra; a queue whose connection previously
                # died after a preamble has tracing disabled (legacy
                # server — see protocol.encode_ingest_trace).
                tctx_wire = (b"" if self._trace_disabled
                             else tracing.current_wire())
                if tctx_wire:
                    wire.send_frame(sock, wire.INGEST_TRACE,
                                    wire.encode_ingest_trace(tctx_wire))
                    self._sock_sent_trace = True
                wire.send_frame(sock, ftype, payload)
                if self.want_acks:
                    resp = wire.recv_frame(sock)
                    if resp is None:
                        raise wire.ProtocolError("closed awaiting ingest ack")
                    rtype, rpayload = resp
                    if rtype == wire.INGEST_BACKOFF:
                        raise _Backoff(wire.decode_ingest_backoff(rpayload))
                    if rtype != wire.INGEST_ACK:
                        raise wire.ProtocolError(
                            f"unexpected frame {rtype} awaiting ingest ack")
                    # a completed exchange proves the server speaks the
                    # preamble: clear the suspicion marker
                    self._sock_sent_trace = False
            except (OSError, wire.ProtocolError):
                if self._sock_sent_trace:
                    # the connection died with a preamble outstanding —
                    # assume a legacy server rejected the frame type
                    # and stop tracing this queue (delivery first)
                    self._trace_disabled = True
                self._drop_sock()
                raise

    def flush(self) -> int:
        if time.monotonic() < self._backoff_until:
            return 0  # honoring the server's load-shed hint
        with self._lock:
            if not self._ids:
                return 0
            batch = wire.MetricBatch(
                np.asarray(self._mts, np.uint8), self._ids,
                np.asarray(self._values, np.float64),
                np.asarray(self._times, np.int64),
            )
            self._mts, self._ids, self._values, self._times = [], [], [], []
        payload = wire.encode_metric_batch(batch)
        try:
            self.retrier.run(
                lambda: self._send_one(self.frame_type, payload))
        except _Backoff as b:
            self._note_backoff(b)
            self._park(batch)
            return 0
        except (OSError, wire.ProtocolError):
            # park the batch back for the next flush (retry)
            self._park(batch)
            return 0
        # Stats mutate under the queue lock: flush() runs on both the
        # user thread and the auto-flush thread, and a bare += is a
        # load/op/store race that loses increments.
        with self._lock:
            self.sent += len(batch.ids)
        return len(batch.ids)

    def _note_backoff(self, b: "_Backoff") -> None:
        with self._lock:
            self.backoffs += 1
            self._backoff_until = (
                time.monotonic() + b.retry_after_ms / 1000.0)

    def _park(self, batch) -> None:
        with self._lock:
            self._mts = list(batch.metric_types) + self._mts
            self._ids = list(batch.ids) + self._ids
            self._values = list(batch.values) + self._values
            self._times = list(batch.times) + self._times

    def send_raw(self, ftype: int, payload: bytes) -> bool:
        """Send one pre-encoded frame immediately (passthrough traffic
        is not queued: it is already aggregated and latency-sensitive).
        Socket I/O happens OUTSIDE the queue lock, like flush(), so a
        slow/down instance cannot stall the flush thread behind a
        blocking connect.  Returns False on a connection error or when
        the server (or its earlier backoff hint) sheds the frame."""
        if time.monotonic() < self._backoff_until:
            return False
        try:
            self._send_one(ftype, payload)
            return True
        except _Backoff as b:
            self._note_backoff(b)
            return False
        except (OSError, wire.ProtocolError):
            return False

    def close(self) -> None:
        self.flush()
        if self._sock is not None:
            self._sock.close()
            self._sock = None


def _ints(a: np.ndarray) -> list:
    """``[int(x) for x in a]``, at C speed for an integer array."""
    return a.tolist() if a.dtype.kind in "iu" else [int(x) for x in a]


class AggregatorClient:
    """Routes each sample to every available owner of its shard.

    resolve(instance_id) -> (host, port) decouples placement identity
    from addressing (the reference stores the endpoint in the placement
    instance; tests pass a closure over ephemeral ports)."""

    def __init__(self, placement: Placement,
                 resolve: Callable[[str], Tuple[str, int]],
                 flush_interval_s: float = 0.1,
                 auto_flush: bool = False,
                 want_acks: bool = True,
                 ack_timeout_s: float = 180.0,
                 retry_options: RetryOptions | None = None):
        self.placement = placement
        self.resolve = resolve
        self.want_acks = want_acks
        self.ack_timeout_s = ack_timeout_s
        self.retry_options = retry_options
        self.queues: Dict[str, InstanceQueue] = {}
        self._flush_interval = flush_interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if auto_flush:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def _queue_for(self, instance_id: str,
                   frame_type: int = wire.METRIC_BATCH) -> InstanceQueue:
        key = (instance_id, frame_type)
        q = self.queues.get(key)
        if q is None:
            q = self.queues[key] = InstanceQueue(
                self.resolve(instance_id), frame_type=frame_type,
                want_acks=self.want_acks,
                ack_timeout_s=self.ack_timeout_s,
                retry_options=self.retry_options,
            )
        return q

    def _enqueue_routed(self, frame_type: int, mt: int, mid: bytes,
                        value: float, t: int) -> int:
        """Enqueue to every available owner of the sample's shard;
        returns owners reached (shared by the untimed/timed paths)."""
        shard = shard_for(mid, self.placement.num_shards)
        n = 0
        for inst in self.placement.instances_for_shard(shard):
            a = inst.shards[shard]
            if a.state == ShardState.LEAVING:
                continue
            self._queue_for(inst.id, frame_type).enqueue(mt, mid, value, t)
            n += 1
        return n

    def write_untimed(self, mt: int, mid: bytes, value: float, t: int) -> int:
        """Enqueue to every available owner; returns owners reached."""
        return self._enqueue_routed(wire.METRIC_BATCH, mt, mid, value, t)

    def _route_batch(self, ids) -> list:
        """Per owning instance, in the order the per-sample loop first
        reaches it: (instance id, the indices of the samples it owns, in
        order).  Owners are each shard's non-LEAVING instances, as in
        ``_enqueue_routed``."""
        shards = shards_for(ids, self.placement.num_shards)
        uniq, first = np.unique(shards, return_index=True)
        order = []  # (first sample, owner rank, instance id, shard)
        for s, f in zip(uniq.tolist(), first.tolist()):
            rank = 0
            for inst in self.placement.instances_for_shard(s):
                if inst.shards[s].state == ShardState.LEAVING:
                    continue
                order.append((f, rank, inst.id, s))
                rank += 1
        owned: Dict[str, list] = {}
        for f, rank, iid, s in sorted(order):
            owned.setdefault(iid, []).append(s)
        return [(iid, np.nonzero(np.isin(shards, ss))[0])
                for iid, ss in owned.items()]

    def _write_routed(self, frame_type: int, mts, ids, values, times) -> int:
        mts, values, times = (np.asarray(mts), np.asarray(values),
                              np.asarray(times))
        n = 0
        for iid, sel in self._route_batch(ids):
            self._queue_for(iid, frame_type).enqueue_many(
                _ints(mts[sel]), [ids[i] for i in sel],
                [float(v) for v in values[sel]] if values.dtype.kind not in "fiu"
                else values[sel].astype(np.float64).tolist(),
                _ints(times[sel]))
            n += len(sel)
        return n

    def write_batch(self, mts, ids, values, times) -> int:
        """``write_untimed`` for every sample; returns owners reached."""
        return self._write_routed(wire.METRIC_BATCH, mts, ids, values, times)

    def write_timed(self, mt: int, mid: bytes, value: float, t: int) -> int:
        """Timed samples ride their own queues and frame type so the
        server routes them through AddTimed's strict window validation
        (reference aggregator.go:77; client m3msg_client.go timed
        path)."""
        return self._enqueue_routed(wire.TIMED_BATCH, mt, mid, value, t)

    def write_timed_batch(self, mts, ids, values, times) -> int:
        """``write_timed`` for every sample; returns owners reached."""
        return self._write_routed(wire.TIMED_BATCH, mts, ids, values, times)

    def write_passthrough(self, ids, values, times, policy) -> int:
        """Pre-aggregated samples: shard-route and send IMMEDIATELY as
        PASSTHROUGH_BATCH frames (reference aggregator.go:86; these skip
        the aggregation queues entirely).  Returns frames delivered."""
        values = np.asarray(values, np.float64)
        times = np.asarray(times, np.int64)
        sent = 0
        for inst_id, sel in self._route_batch(ids):
            payload = wire.encode_passthrough_batch(
                str(policy), [ids[i] for i in sel], values[sel], times[sel])
            if self._queue_for(inst_id, wire.PASSTHROUGH_BATCH).send_raw(
                    wire.PASSTHROUGH_BATCH, payload):
                sent += 1
        return sent

    def flush(self) -> int:
        return sum(q.flush() for q in self.queues.values())

    def _loop(self) -> None:
        while not self._stop.wait(self._flush_interval):
            self.flush()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
        for q in self.queues.values():
            q.close()
