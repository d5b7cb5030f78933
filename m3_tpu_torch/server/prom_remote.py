"""Prometheus remote write/read: snappy + protobuf wire handling.
The port's copy of ``m3_tpu/server/prom_remote.py`` (it imports nothing of ``m3_tpu``).

Equivalent of the reference's remote handlers
(`src/query/api/v1/handler/prometheus/remote/{write.go,read.go}`):
POST bodies are snappy-compressed `prompb.WriteRequest`/`ReadRequest`
messages.  No protobuf runtime is required — the prompb subset is four
tiny messages hand-decoded from the wire format (the schema is frozen
by the Prometheus remote-storage spec):

    WriteRequest { repeated TimeSeries timeseries = 1; }
    TimeSeries   { repeated Label labels = 1; repeated Sample samples = 2; }
    Label        { string name = 1; string value = 2; }
    Sample       { double value = 1; int64 timestamp = 2; }  # ms!

    ReadRequest  { repeated Query queries = 1; }
    Query        { int64 start_timestamp_ms = 1; int64 end_timestamp_ms = 2;
                   repeated LabelMatcher matchers = 3; }
    LabelMatcher { Type type = 1 (EQ/NEQ/RE/NRE); string name = 2;
                   string value = 3; }
    ReadResponse { repeated QueryResult results = 1; }
    QueryResult  { repeated TimeSeries timeseries = 1; }
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from m3_tpu_torch.server import snappy

# ---------------------------------------------------------------------------
# Minimal protobuf wire reader/writer
# ---------------------------------------------------------------------------


class ProtoError(ValueError):
    pass


def _uvarint(data: bytes, pos: int) -> tuple[int, int]:
    out = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise ProtoError("truncated varint")
        b = data[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 70:
            raise ProtoError("varint too long")


def _fields(data: bytes):
    """Yield (field_number, wire_type, value) triples."""
    pos = 0
    while pos < len(data):
        key, pos = _uvarint(data, pos)
        fnum, wtype = key >> 3, key & 7
        if wtype == 0:  # varint
            val, pos = _uvarint(data, pos)
        elif wtype == 1:  # 64-bit
            val = data[pos : pos + 8]
            pos += 8
        elif wtype == 2:  # length-delimited
            ln, pos = _uvarint(data, pos)
            val = data[pos : pos + ln]
            if len(val) != ln:
                raise ProtoError("truncated length-delimited field")
            pos += ln
        elif wtype == 5:  # 32-bit
            val = data[pos : pos + 4]
            pos += 4
        else:
            raise ProtoError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _emit_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _emit_field(fnum: int, wtype: int, payload: bytes) -> bytes:
    return _emit_varint((fnum << 3) | wtype) + payload


def _emit_len(fnum: int, payload: bytes) -> bytes:
    return _emit_field(fnum, 2, _emit_varint(len(payload)) + payload)


def _signed(v: int) -> int:
    """protobuf int64 varints are two's-complement in 64 bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


# ---------------------------------------------------------------------------
# prompb messages
# ---------------------------------------------------------------------------


@dataclass
class PromTimeSeries:
    labels: dict            # bytes -> bytes
    samples: list           # [(timestamp_nanos, value)]


def _parse_label(data: bytes) -> tuple[bytes, bytes]:
    name = value = b""
    for fnum, _wt, val in _fields(data):
        if fnum == 1:
            name = val
        elif fnum == 2:
            value = val
    return name, value


def _parse_sample(data: bytes) -> tuple[int, float]:
    value = 0.0
    ts_ms = 0
    for fnum, wt, val in _fields(data):
        if fnum == 1 and wt == 1:
            value = struct.unpack("<d", val)[0]
        elif fnum == 2 and wt == 0:
            ts_ms = _signed(val)
    return ts_ms * 10**6, value  # ms → nanos


def _parse_timeseries(data: bytes) -> PromTimeSeries:
    labels = {}
    samples = []
    for fnum, _wt, val in _fields(data):
        if fnum == 1:
            n, v = _parse_label(val)
            labels[n] = v
        elif fnum == 2:
            samples.append(_parse_sample(val))
    return PromTimeSeries(labels, samples)


def parse_write_request(body: bytes) -> list[PromTimeSeries]:
    """snappy-compressed WriteRequest → series list."""
    raw = snappy.decompress(body)
    out = []
    for fnum, _wt, val in _fields(raw):
        if fnum == 1:
            out.append(_parse_timeseries(val))
    return out


@dataclass
class PromMatcher:
    type: int  # 0 EQ, 1 NEQ, 2 RE, 3 NRE
    name: bytes
    value: bytes


@dataclass
class PromQuery:
    start_nanos: int
    end_nanos: int
    matchers: list = field(default_factory=list)


def _parse_matcher(data: bytes) -> PromMatcher:
    t = 0
    name = value = b""
    for fnum, wt, val in _fields(data):
        if fnum == 1 and wt == 0:
            t = val
        elif fnum == 2:
            name = val
        elif fnum == 3:
            value = val
    return PromMatcher(t, name, value)


def parse_read_request(body: bytes) -> list[PromQuery]:
    raw = snappy.decompress(body)
    queries = []
    for fnum, _wt, val in _fields(raw):
        if fnum != 1:
            continue
        q = PromQuery(0, 0)
        for f2, w2, v2 in _fields(val):
            if f2 == 1 and w2 == 0:
                q.start_nanos = _signed(v2) * 10**6
            elif f2 == 2 and w2 == 0:
                q.end_nanos = _signed(v2) * 10**6
            elif f2 == 3:
                q.matchers.append(_parse_matcher(v2))
        queries.append(q)
    return queries


def _emit_timeseries(ts: PromTimeSeries) -> bytes:
    parts = []
    for name, value in sorted(ts.labels.items()):
        parts.append(_emit_len(1, _emit_len(1, name) + _emit_len(2, value)))
    for t_nanos, v in ts.samples:
        sample = _emit_field(1, 1, struct.pack("<d", v)) + _emit_field(
            2, 0, _emit_varint((t_nanos // 10**6) & ((1 << 64) - 1))
        )
        parts.append(_emit_len(2, sample))
    return b"".join(parts)


def build_read_response(results: list[list[PromTimeSeries]]) -> bytes:
    """QueryResult per query → snappy-compressed ReadResponse."""
    out = []
    for series_list in results:
        qr = b"".join(_emit_len(1, _emit_timeseries(s)) for s in series_list)
        out.append(_emit_len(1, qr))
    return snappy.compress(b"".join(out))


def build_write_request(series_list: list[PromTimeSeries]) -> bytes:
    """For clients/tests: series → snappy-compressed WriteRequest."""
    body = b"".join(_emit_len(1, _emit_timeseries(s)) for s in series_list)
    return snappy.compress(body)
