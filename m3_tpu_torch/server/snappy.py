"""Snappy block-format codec (pure Python).
The port's copy of ``m3_tpu/server/snappy.py`` (it imports nothing of ``m3_tpu``).

Prometheus remote read/write bodies are snappy-compressed protobuf
(the reference handles them via golang/snappy in
`src/query/api/v1/handler/prometheus/remote`).  No snappy module ships
in this environment, so this implements the block format directly:
decompression handles the full tag set (literals + both copy forms);
compression emits a valid all-literal stream (legal snappy — every
decoder accepts it; we trade ratio for simplicity on the encode side,
exactly enough to serve read responses).

Format: [uncompressed length varint] then tagged elements:
  tag & 3 == 0  literal, length from tag (or trailing bytes for >60)
  tag & 3 == 1  copy: 4-11 byte length, 11-bit offset
  tag & 3 == 2  copy: 1-64 length, 16-bit LE offset
  tag & 3 == 3  copy: 1-64 length, 32-bit LE offset
"""

from __future__ import annotations


class SnappyError(ValueError):
    pass


def _read_uvarint(data: bytes, pos: int) -> tuple[int, int]:
    out = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise SnappyError("truncated varint")
        b = data[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 63:
            raise SnappyError("varint too long")


def _write_uvarint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def decompress(data: bytes) -> bytes:
    want, pos = _read_uvarint(data, 0)
    out = bytearray()
    while pos < len(data):
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            ln = tag >> 2
            if ln >= 60:
                nbytes = ln - 59
                if pos + nbytes > len(data):
                    raise SnappyError("truncated literal length")
                ln = int.from_bytes(data[pos : pos + nbytes], "little")
                pos += nbytes
            ln += 1
            if pos + ln > len(data):
                raise SnappyError("truncated literal")
            out += data[pos : pos + ln]
            pos += ln
            continue
        if kind == 1:
            ln = ((tag >> 2) & 0x7) + 4
            off = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:
            ln = (tag >> 2) + 1
            off = int.from_bytes(data[pos : pos + 2], "little")
            pos += 2
        else:
            ln = (tag >> 2) + 1
            off = int.from_bytes(data[pos : pos + 4], "little")
            pos += 4
        if off == 0 or off > len(out):
            raise SnappyError(f"bad copy offset {off}")
        start = len(out) - off
        if off >= ln:
            # non-overlapping (the common case): one slice extend
            out += out[start : start + ln]
        else:
            # overlapping forward copy (RLE): byte-by-byte semantics
            for i in range(ln):
                out.append(out[start + i])
    if len(out) != want:
        raise SnappyError(f"length mismatch: got {len(out)}, want {want}")
    return bytes(out)


def compress(data: bytes) -> bytes:
    """All-literal snappy: valid for every decoder, no back-references."""
    out = bytearray(_write_uvarint(len(data)))
    pos = 0
    while pos < len(data):
        chunk = data[pos : pos + 65536]
        n = len(chunk) - 1
        if n < 60:
            out.append(n << 2)
        elif n < (1 << 8):
            out.append(60 << 2)
            out += n.to_bytes(1, "little")
        else:  # chunks cap at 65536, so 2 length bytes always suffice
            out.append(61 << 2)
            out += n.to_bytes(2, "little")
        out += chunk
        pos += len(chunk)
    return bytes(out)
