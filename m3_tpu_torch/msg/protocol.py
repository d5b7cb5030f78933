"""Framed binary wire protocol: the socket data plane.  The port's copy of
``m3_tpu/msg/protocol.py``: the same frame layout, frame type numbers,
payload bytes and decoder errors.

Equivalent of the reference's two TCP wire stacks: the aggregator's
rawtcp ingest protocol (protobuf `UnaggregatedIterator` loop,
`src/aggregator/server/rawtcp/server.go:125`, messages encoded by
`src/metrics/encoding/protobuf/unaggregated_iterator.go`) and m3msg's
size-prefixed protobuf framing (`src/msg/protocol/proto/encoder.go:49-52`,
`decoder.go:64`).  Protobuf collapses to struct-packed little-endian
frames; the framing contract is the same: length prefix, checksum,
typed payload, resynchronization-free streams.

Frame layout:   [len u32][type u8][crc u32][payload: len bytes]
                crc = adler32(type byte + payload) — a torn/corrupt frame
                kills the connection (sender retries), never desyncs.

The metric and passthrough batch codecs pack and parse whole batches
with numpy (one record matrix instead of a ``struct`` call per sample).
An encoder takes arrays and lists alike; a decoder takes payloads whose
ids share one length.  Whatever the array form refuses goes to the
per-sample loop — the reference's own code — which raises where the
reference raises (``struct.pack`` on an out-of-range field, a short or
trailing-byte payload) with the same exception and message, and reads
the payloads of ids of mixed lengths.
"""

from __future__ import annotations

import socket
import struct
import zlib
from dataclasses import dataclass

import numpy as np

_HDR = struct.Struct("<IBI")
MAX_FRAME = 64 << 20

# frame types (the reference's numbers)
METRIC_BATCH = 1
BUS_HELLO = 2
BUS_PUBLISH = 3
BUS_DELIVER = 4
BUS_ACK = 5
OK = 6
ERROR = 7
# (8/9 are the query federation frames; 16-18 the dbnode RPC;
#  24-26 the KV control plane — none of them ported.)
TIMED_BATCH = 11        # MetricBatch payload; samples land by own time
PASSTHROUGH_BATCH = 12  # pre-aggregated, carries a storage policy
FORWARDED_BATCH = 13    # stage-N pipeline outputs for the next stage
INGEST_HELLO = 10       # client opts into per-frame acks (flags u32)
INGEST_ACK = 14         # server: frame fully ingested (sample count u32)
INGEST_BACKOFF = 15     # server shed the frame: retry after (ms u32)
INGEST_TRACE = 21       # trace-context preamble: applies to the NEXT
                        # batch frame on this connection (17-byte
                        # instrument.tracing.TraceContext wire form)


class ProtocolError(ConnectionError):
    pass


def connect(address, timeout: float = 5.0) -> socket.socket:
    """Dial a wire peer: create_connection + TCP_NODELAY, closing the
    socket if the set-up after the connect raises."""
    s = socket.create_connection(address, timeout=timeout)
    try:
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except BaseException:
        s.close()
        raise
    return s


def _crc(ftype: int, payload) -> int:
    # adler32(type byte + payload) without building the concatenation
    return zlib.adler32(payload, zlib.adler32(bytes([ftype]))) & 0xFFFFFFFF


def send_frame(sock: socket.socket, ftype: int, payload: bytes) -> None:
    sock.sendall(_HDR.pack(len(payload), ftype, _crc(ftype, payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        try:
            k = sock.recv_into(view[got:], n - got)
        except (socket.timeout, TimeoutError):
            if got:
                # A timeout after partial data would desync the stream —
                # fatal; a timeout at a frame boundary is a clean poll.
                raise ProtocolError("timeout mid-frame") from None
            raise
        if not k:
            return None  # clean EOF only before a frame starts
        got += k
    return bytes(buf)


def recv_frame(sock: socket.socket) -> tuple[int, bytes] | None:
    """(type, payload) or None on EOF.  Raises ProtocolError on a torn
    or corrupt frame — callers drop the connection."""
    hdr = _recv_exact(sock, _HDR.size)
    if hdr is None:
        return None
    plen, ftype, crc = _HDR.unpack(hdr)
    if plen > MAX_FRAME:
        raise ProtocolError(f"frame too large: {plen}")
    payload = _recv_exact(sock, plen) if plen else b""
    if payload is None:
        raise ProtocolError("EOF mid-frame")
    if _crc(ftype, payload) != crc:
        raise ProtocolError("frame checksum mismatch")
    return ftype, payload


# -- record matrices: the array form of the per-sample struct loops ---------

_TV = np.dtype([("t", "<i8"), ("v", "<f8")])


def _pack_records(head: np.ndarray, ids: list, lens: np.ndarray,
                  tail: np.ndarray) -> bytes:
    """Concatenate per-record ``head`` bytes (n, h), the record's id, and
    ``tail`` bytes (n, k) — what the reference builds with one
    ``struct.pack`` per field per sample."""
    n = len(ids)
    h, k = head.shape[1], tail.shape[1]
    blob = np.frombuffer(b"".join(ids), np.uint8)
    if n and lens.min() == lens.max():  # one record width: a matrix
        L = int(lens[0])
        out = np.empty((n, h + L + k), np.uint8)
        out[:, :h] = head
        out[:, h:h + L] = blob.reshape(n, L)
        out[:, h + L:] = tail
        return out.tobytes()
    size = h + lens + k
    offs = np.zeros(n, np.int64)
    np.cumsum(size[:-1], out=offs[1:])
    total = int(offs[-1] + size[-1]) if n else 0
    out = np.empty(total, np.uint8)
    out[offs[:, None] + np.arange(h)] = head
    if blob.size:
        starts = np.zeros(n, np.int64)
        np.cumsum(lens[:-1], out=starts[1:])
        out[np.repeat(offs + h - starts, lens) + np.arange(blob.size)] = blob
    out[(offs + h + lens)[:, None] + np.arange(k)] = tail
    return out.tobytes()


def _id_lens(ids) -> np.ndarray | None:
    """Each id's length, or None when an id is not ``bytes`` or does not
    fit the u16 length field (the per-sample loop then decides)."""
    if ids and set(map(type, ids)) != {bytes}:
        return None
    lens = np.fromiter(map(len, ids), np.int64, len(ids))
    if lens.size and int(lens.max()) > 0xFFFF:
        return None
    return lens


def _column(x, n: int, kinds: str) -> np.ndarray | None:
    """``x`` (an array or a list) as a 1-D array of n elements whose
    dtype kind is one of ``kinds``, or None."""
    try:
        a = np.asarray(x)
    except (TypeError, ValueError):
        return None
    if a.ndim != 1 or a.shape[0] != n or a.dtype.kind not in kinds:
        return None
    return a


def _tv_bytes(times: np.ndarray, values: np.ndarray) -> np.ndarray:
    tv = np.empty(len(times), _TV)
    tv["t"] = times
    tv["v"] = values
    return tv.view(np.uint8).reshape(len(times), 16)


def _uniform_records(raw: bytes, pos: int, n: int, h: int, len_at: int,
                     k: int) -> np.ndarray | None:
    """Offsets of the n records from ``pos`` to the payload's end when
    all of them share one id length (each: h head bytes whose u16 id
    length sits at ``len_at``, the id, k tail bytes), else None."""
    size = len(raw)
    if n == 0 or pos + h > size:
        return None
    (l0,) = struct.unpack_from("<H", raw, pos + len_at)
    rec = h + l0 + k
    if size - pos != n * rec:
        return None
    m = np.frombuffer(raw, np.uint8, size - pos, pos).reshape(n, rec)
    if (m[:, len_at] != (l0 & 0xFF)).any() or (m[:, len_at + 1] != (l0 >> 8)).any():
        return None
    return pos + np.arange(n, dtype=np.int64) * rec, l0


def _gather(raw_u8: np.ndarray, at: np.ndarray, k: int) -> np.ndarray:
    return raw_u8[at[:, None] + np.arange(k)]


# -- metric batch codec (the unaggregated wire form) ------------------------


@dataclass(frozen=True)
class MetricBatch:
    """One ingest batch: parallel arrays + per-sample metric type.

    metric_types: uint8 array (MetricType values); ids: list of bytes;
    values/times: float64/int64 arrays; agg_id: compressed aggregation
    bitmask applied to the whole batch (0 = default per-type)."""

    metric_types: np.ndarray
    ids: list
    values: np.ndarray
    times: np.ndarray
    agg_id: int = 0


def _encode_metric_batch_loop(b: MetricBatch) -> bytes:
    parts = [struct.pack("<IQ", len(b.ids), b.agg_id)]
    for i, sid in enumerate(b.ids):
        parts.append(struct.pack("<BH", int(b.metric_types[i]), len(sid)))
        parts.append(sid)
        parts.append(struct.pack("<qd", int(b.times[i]), float(b.values[i])))
    return b"".join(parts)


def encode_metric_batch(b: MetricBatch) -> bytes:
    n = len(b.ids)
    lens = _id_lens(b.ids)
    mts = _column(b.metric_types, n, "iu")
    times = _column(b.times, n, "i")
    values = _column(b.values, n, "fiu")
    if (n == 0 or lens is None or mts is None or times is None or values is None
            or int(mts.min()) < 0 or int(mts.max()) > 0xFF
            or values.dtype.itemsize > 8):
        return _encode_metric_batch_loop(b)
    head = np.empty((n, 3), np.uint8)
    head[:, 0] = mts
    head[:, 1] = lens & 0xFF
    head[:, 2] = lens >> 8
    return (struct.pack("<IQ", n, b.agg_id)
            + _pack_records(head, b.ids, lens, _tv_bytes(times, values)))


def _decode_metric_batch_loop(raw: bytes) -> MetricBatch:
    n, agg_id = struct.unpack_from("<IQ", raw, 0)
    pos = 12
    mts = np.empty(n, np.uint8)
    ids = []
    values = np.empty(n, np.float64)
    times = np.empty(n, np.int64)
    for i in range(n):
        mt, idlen = struct.unpack_from("<BH", raw, pos)
        pos += 3
        ids.append(raw[pos : pos + idlen])
        pos += idlen
        t, v = struct.unpack_from("<qd", raw, pos)
        pos += 16
        mts[i] = mt
        times[i] = t
        values[i] = v
    if pos != len(raw):
        raise ProtocolError("metric batch trailing bytes")
    return MetricBatch(mts, ids, values, times, agg_id)


def decode_metric_batch(raw: bytes) -> MetricBatch:
    if type(raw) is bytes and len(raw) >= 12:
        n, agg_id = struct.unpack_from("<IQ", raw, 0)
        found = _uniform_records(raw, 12, n, 3, 1, 16)
        if found is not None:
            offs, L = found
            u8 = np.frombuffer(raw, np.uint8)
            tv = _gather(u8, offs + 3 + L, 16).view(_TV)[:, 0]
            return MetricBatch(u8[offs].copy(), [raw[a:a + L] for a in (offs + 3).tolist()],
                               tv["v"].copy(), tv["t"].copy(), agg_id)
    return _decode_metric_batch_loop(raw)


def _encode_passthrough_loop(policy: str, ids, values, times) -> bytes:
    p = policy.encode()
    parts = [struct.pack("<HI", len(p), len(ids)), p]
    for i, sid in enumerate(ids):
        parts.append(struct.pack("<H", len(sid)))
        parts.append(sid)
        parts.append(struct.pack("<qd", int(times[i]), float(values[i])))
    return b"".join(parts)


def encode_passthrough_batch(policy: str, ids, values, times) -> bytes:
    """PASSTHROUGH_BATCH payload: storage policy string + parallel
    (id, time, value) entries (reference aggregator.go:86 AddPassthrough
    carries metric + policy)."""
    n = len(ids)
    lens = _id_lens(ids)
    t = _column(times, n, "i")
    v = _column(values, n, "fiu")
    p = policy.encode()
    if (n == 0 or lens is None or t is None or v is None or v.dtype.itemsize > 8
            or len(p) > 0xFFFF):
        return _encode_passthrough_loop(policy, ids, values, times)
    head = np.empty((n, 2), np.uint8)
    head[:, 0] = lens & 0xFF
    head[:, 1] = lens >> 8
    return (struct.pack("<HI", len(p), n) + p
            + _pack_records(head, ids, lens, _tv_bytes(t, v)))


def _decode_passthrough_loop(raw: bytes):
    lp, n = struct.unpack_from("<HI", raw, 0)
    pos = 6
    policy = raw[pos:pos + lp].decode()
    pos += lp
    ids = []
    values = np.empty(n, np.float64)
    times = np.empty(n, np.int64)
    for i in range(n):
        (idlen,) = struct.unpack_from("<H", raw, pos)
        pos += 2
        ids.append(raw[pos:pos + idlen])
        pos += idlen
        t, v = struct.unpack_from("<qd", raw, pos)
        pos += 16
        times[i] = t
        values[i] = v
    if pos != len(raw):
        raise ProtocolError("passthrough batch trailing bytes")
    return policy, ids, values, times


def decode_passthrough_batch(raw: bytes):
    if type(raw) is bytes and len(raw) >= 6:
        lp, n = struct.unpack_from("<HI", raw, 0)
        pos = 6 + lp
        found = _uniform_records(raw, pos, n, 2, 0, 16)
        if found is not None:
            try:
                policy = raw[6:pos].decode()
            except UnicodeDecodeError:
                return _decode_passthrough_loop(raw)
            offs, L = found
            u8 = np.frombuffer(raw, np.uint8)
            tv = _gather(u8, offs + 2 + L, 16).view(_TV)[:, 0]
            return (policy, [raw[a:a + L] for a in (offs + 2).tolist()],
                    tv["v"].copy(), tv["t"].copy())
    return _decode_passthrough_loop(raw)


def encode_forwarded_batch(policy: str, entries) -> bytes:
    """FORWARDED_BATCH payload (reference forwarded_writer.go wire
    role): storage policy + per-entry (ForwardSpec, value, ts).  The
    spec's remaining tail is flattened as op records: kind 0 =
    transformation (type byte), kind 1 = applied rollup (id +
    aggregation mask) — enough to reconstruct the next stages."""
    from m3_tpu_torch.metrics.pipeline import AppliedRollupOp, TransformationOp

    p = policy.encode()
    parts = [struct.pack("<HI", len(p), len(entries)), p]
    for spec, v, ts in entries:
        parts.append(struct.pack("<H", len(spec.id)))
        parts.append(spec.id)
        parts.append(struct.pack("<QqdB", int(spec.aggregation_id),
                                 int(ts), float(v), len(spec.tail)))
        for op in spec.tail:
            if isinstance(op, TransformationOp):
                parts.append(struct.pack("<BB", 0, int(op.type)))
            elif isinstance(op, AppliedRollupOp):
                parts.append(struct.pack("<BH", 1, len(op.id)))
                parts.append(op.id)
                parts.append(struct.pack("<Q", int(op.aggregation_id)))
            else:
                raise ProtocolError(f"unencodable forwarded op {op!r}")
    return b"".join(parts)


def decode_forwarded_batch(raw: bytes):
    """Returns (policy str, entries list of (ForwardSpec, value, ts))."""
    from m3_tpu_torch.aggregator.engine import ForwardSpec
    from m3_tpu_torch.metrics.aggregation import AggregationID
    from m3_tpu_torch.metrics.pipeline import AppliedRollupOp, TransformationOp
    from m3_tpu_torch.metrics.transformation import TransformationType

    lp, n = struct.unpack_from("<HI", raw, 0)
    pos = 6
    policy = raw[pos:pos + lp].decode()
    pos += lp
    entries = []
    for _ in range(n):
        (idlen,) = struct.unpack_from("<H", raw, pos)
        pos += 2
        sid = raw[pos:pos + idlen]
        pos += idlen
        agg, ts, v, nops = struct.unpack_from("<QqdB", raw, pos)
        pos += 25
        tail = []
        for _ in range(nops):
            (kind,) = struct.unpack_from("<B", raw, pos)
            pos += 1
            if kind == 0:
                (tt,) = struct.unpack_from("<B", raw, pos)
                pos += 1
                tail.append(TransformationOp(TransformationType(tt)))
            elif kind == 1:
                (oplen,) = struct.unpack_from("<H", raw, pos)
                pos += 2
                oid = raw[pos:pos + oplen]
                pos += oplen
                (oagg,) = struct.unpack_from("<Q", raw, pos)
                pos += 8
                tail.append(AppliedRollupOp(oid, AggregationID(oagg)))
            else:
                raise ProtocolError(f"bad forwarded op kind {kind}")
        entries.append((ForwardSpec(sid, AggregationID(agg), tuple(tail)),
                        v, ts))
    if pos != len(raw):
        raise ProtocolError("forwarded batch trailing bytes")
    return policy, entries


# -- ingest ack / load-shed payloads ----------------------------------------

HELLO_WANT_ACKS = 1  # INGEST_HELLO flag: reply ACK/BACKOFF per frame


def encode_ingest_hello(flags: int = HELLO_WANT_ACKS) -> bytes:
    return struct.pack("<I", flags)


def decode_ingest_hello(raw: bytes) -> int:
    return struct.unpack_from("<I", raw, 0)[0]


def encode_ingest_ack(n_samples: int) -> bytes:
    return struct.pack("<I", n_samples)


def decode_ingest_ack(raw: bytes) -> int:
    return struct.unpack_from("<I", raw, 0)[0]


def encode_ingest_backoff(retry_after_ms: int) -> bytes:
    return struct.pack("<I", retry_after_ms)


def decode_ingest_backoff(raw: bytes) -> int:
    return struct.unpack_from("<I", raw, 0)[0]


def encode_ingest_trace(ctx_wire: bytes) -> bytes:
    """INGEST_TRACE payload: the packed TraceContext itself, sent by a
    sampled client immediately BEFORE a batch frame (a preamble keeps
    the batch codecs' exact-length contracts)."""
    return bytes(ctx_wire)


def decode_ingest_trace(raw: bytes):
    from m3_tpu_torch.instrument.tracing import TraceContext

    if len(raw) < TraceContext.WIRE_SIZE:
        raise ProtocolError("short ingest trace frame")
    return TraceContext.from_wire(raw, 0)


# -- bus transport payloads -------------------------------------------------


def encode_bus_hello(service: str, instance_id: str) -> bytes:
    s, i = service.encode(), instance_id.encode()
    return struct.pack("<HH", len(s), len(i)) + s + i


def decode_bus_hello(raw: bytes) -> tuple[str, str]:
    ls, li = struct.unpack_from("<HH", raw, 0)
    s = raw[4 : 4 + ls].decode()
    i = raw[4 + ls : 4 + ls + li].decode()
    return s, i


def encode_bus_publish(shard: int, payload: bytes) -> bytes:
    return struct.pack("<I", shard) + payload


def decode_bus_publish(raw: bytes) -> tuple[int, bytes]:
    (shard,) = struct.unpack_from("<I", raw, 0)
    return shard, raw[4:]


def encode_bus_deliver(mid: int, shard: int, payload: bytes) -> bytes:
    return struct.pack("<QI", mid, shard) + payload


def decode_bus_deliver(raw: bytes) -> tuple[int, int, bytes]:
    mid, shard = struct.unpack_from("<QI", raw, 0)
    return mid, shard, raw[12:]


def encode_bus_ack(mid: int) -> bytes:
    return struct.pack("<Q", mid)


def decode_bus_ack(raw: bytes) -> int:
    return struct.unpack_from("<Q", raw, 0)[0]
