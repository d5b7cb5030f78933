"""Proto value codec: per-field compression of message-valued series.

Equivalent of the reference's protobuf encoder
(`src/dbnode/encoding/proto` — custom marshal + per-field compression:
float fields XOR'd like the m3tsz float path
(`float_encoder_iterator.go`), int fields delta-compressed
(`int_encoder_iterator.go`), bytes fields through a small LRU dict
(`byteFieldDictLRUSize=4`, `encoding/options.go:33`); per-message
changed-field tracking so an unchanged field costs one bit).

Redesign notes (not a port): the reference parses real protobuf
descriptors; here a schema is an explicit ordered tuple of
(name, kind) with kind ∈ {INT, FLOAT, BYTES, BOOL} — the columnar
essence of the format without a protobuf runtime (message
marshal/unmarshal is the caller's business; this layer compresses the
*columns*).  The float path reuses the exact m3tsz `FloatXOR` control
bits; timestamps use a self-contained delta-of-delta (zigzag varbits)
with a continuation bit per message, since proto streams have no
cross-implementation bit-exactness contract to honor.

Stream layout:
  [first_ts: 64 bits]
  per message: [cont=1] [dod: zigzag varbits]
               [changed-bitset: one bit per schema field]
               per changed field its kind-specific payload:
                 FLOAT  m3tsz FloatXOR (full 64 bits first, XOR after)
                 INT    zigzag(delta) varbits
                 BYTES  2-bit LRU dict index, or literal marker +
                        varbits length + bytes
                 BOOL   1 bit
  [cont=0]  end of stream

The port's copy of ``m3_tpu/encoding/proto_codec.py``: host code over the
port's own ``bitstream`` and ``m3tsz``; its streams are the reference's
byte for byte in both directions.
"""

from __future__ import annotations

import copy
import enum
from dataclasses import dataclass

from m3_tpu_torch.encoding.bitstream import IStream, OStream
from m3_tpu_torch.encoding.m3tsz import FloatXOR, bits_to_float, float_to_bits

_DICT_SIZE = 4  # reference byteFieldDictLRUSize, encoding/options.go:33
_MASK64 = (1 << 64) - 1


class FieldKind(enum.IntEnum):
    INT = 0
    FLOAT = 1
    BYTES = 2
    BOOL = 3


@dataclass(frozen=True)
class Schema:
    """Ordered field schema; order is the wire order."""

    fields: tuple[tuple[str, FieldKind], ...]

    def __post_init__(self):
        if not self.fields:
            raise ValueError("empty schema")
        names = [n for n, _ in self.fields]
        if len(set(names)) != len(names):
            raise ValueError("duplicate field names in schema")


def _zigzag(v: int) -> int:
    # Arithmetic (not shift/mask) form, arbitrary precision on purpose:
    # varbits carry any magnitude, and the usual `(v << 1) ^ (v >> 63)`
    # silently corrupts deltas below -2**63 (e.g. 2**62 -> -(2**62)-1
    # between consecutive samples) because Python's arithmetic shift of
    # such values is no longer -1.
    return v << 1 if v >= 0 else ((-v) << 1) - 1


def _unzigzag(u: int) -> int:
    return (u >> 1) ^ -(u & 1)


def _write_varbits(os: OStream, u: int) -> None:
    """7-bit groups with a continuation bit, bit-packed."""
    while True:
        group = u & 0x7F
        u >>= 7
        os.write_bit(1 if u else 0)
        os.write_bits(group, 7)
        if not u:
            return


def _read_varbits(ist: IStream) -> int:
    out = 0
    shift = 0
    while True:
        more = ist.read_bit()
        out |= ist.read_bits(7) << shift
        shift += 7
        if not more:
            return out


class _FloatField:
    """m3tsz FloatXOR per float field."""

    __slots__ = ("xor", "first")

    def __init__(self):
        self.xor = FloatXOR()
        self.first = True

    def encode(self, os: OStream, value: float) -> None:
        bits = float_to_bits(value)
        if self.first:
            self.xor.write_full(os, bits)
            self.first = False
        else:
            self.xor.write_next(os, bits)

    def decode(self, ist: IStream) -> float:
        if self.first:
            self.xor.read_full(ist)
            self.first = False
        else:
            self.xor.read_next(ist)
        return bits_to_float(self.xor.prev_float_bits)


class _IntField:
    """zigzag(delta) varbits per int field (int_encoder_iterator.go's
    delta role, varbit form)."""

    __slots__ = ("prev",)

    def __init__(self):
        self.prev = 0

    def encode(self, os: OStream, value: int) -> None:
        _write_varbits(os, _zigzag(value - self.prev))
        self.prev = value

    def decode(self, ist: IStream) -> int:
        self.prev += _unzigzag(_read_varbits(ist))
        return self.prev


class _BytesField:
    """4-entry LRU dict per bytes field."""

    __slots__ = ("lru",)

    def __init__(self):
        self.lru: list[bytes] = []

    def _touch(self, value: bytes) -> None:
        if value in self.lru:
            self.lru.remove(value)
        self.lru.append(value)
        if len(self.lru) > _DICT_SIZE:
            self.lru.pop(0)

    def encode(self, os: OStream, value: bytes) -> None:
        if value in self.lru:
            os.write_bit(0)  # dict hit
            os.write_bits(self.lru.index(value), 2)
        else:
            os.write_bit(1)  # literal
            _write_varbits(os, len(value))
            os.write_bytes(value)
        self._touch(value)

    def decode(self, ist: IStream) -> bytes:
        if ist.read_bit() == 0:
            value = self.lru[ist.read_bits(2)]
        else:
            n = _read_varbits(ist)
            value = ist.read_bytes(n)
        self._touch(value)
        return value


def _state_for(kind: FieldKind):
    return {
        FieldKind.FLOAT: _FloatField,
        FieldKind.INT: _IntField,
        FieldKind.BYTES: _BytesField,
        FieldKind.BOOL: lambda: None,
    }[kind]()


_DEFAULTS = {
    FieldKind.INT: 0,
    FieldKind.FLOAT: 0.0,
    FieldKind.BYTES: b"",
    FieldKind.BOOL: False,
}


class ProtoEncoder:
    """Encode (timestamp, {field: value}) messages."""

    def __init__(self, schema: Schema, start_nanos: int):
        self.schema = schema
        self._os = OStream()
        self._os.write_bits(start_nanos & _MASK64, 64)
        self._prev_time = start_nanos
        self._prev_delta = 0
        self._states = [_state_for(kind) for _, kind in schema.fields]
        self._current = {
            name: _DEFAULTS[kind] for name, kind in schema.fields
        }
        self.num_encoded = 0

    def encode(self, timestamp_nanos: int, values: dict) -> None:
        unknown = set(values) - set(self._current)
        if unknown:
            raise ValueError(f"fields not in schema: {sorted(unknown)}")
        self._os.write_bit(1)  # continuation
        delta = timestamp_nanos - self._prev_time
        _write_varbits(self._os, _zigzag(delta - self._prev_delta))
        self._prev_time, self._prev_delta = timestamp_nanos, delta
        changed_idx = []
        for i, (name, kind) in enumerate(self.schema.fields):
            is_changed = name in values and values[name] != self._current[name]
            self._os.write_bit(1 if is_changed else 0)
            if is_changed:
                changed_idx.append(i)
        for i in changed_idx:
            name, kind = self.schema.fields[i]
            value = values[name]
            if kind == FieldKind.BOOL:
                self._os.write_bit(1 if value else 0)
            else:
                self._states[i].encode(self._os, value)
            self._current[name] = value
        self.num_encoded += 1

    def stream(self) -> bytes:
        """Finalized stream (the encoder stays usable — m3tsz encoders
        are likewise snapshot-able mid-stream for reads)."""
        final = copy.deepcopy(self._os)
        final.write_bit(0)  # end of stream
        raw, _pos = final.raw_bytes()
        return raw


class ProtoDecoder:
    def __init__(self, schema: Schema, data: bytes):
        self.schema = schema
        self._ist = IStream(data)
        self._first = True
        self._prev_time = 0
        self._prev_delta = 0
        self._states = [_state_for(kind) for _, kind in schema.fields]
        self._current = {
            name: _DEFAULTS[kind] for name, kind in schema.fields
        }

    def __iter__(self):
        while True:
            if self._first:
                self._prev_time = self._ist.read_bits(64)
                if self._prev_time >= 1 << 63:
                    self._prev_time -= 1 << 64
                self._first = False
            if self._ist.read_bit() == 0:
                return
            dod = _unzigzag(_read_varbits(self._ist))
            self._prev_delta += dod
            self._prev_time += self._prev_delta
            changed = [self._ist.read_bit() for _ in self.schema.fields]
            for i, (name, kind) in enumerate(self.schema.fields):
                if not changed[i]:
                    continue
                if kind == FieldKind.BOOL:
                    self._current[name] = bool(self._ist.read_bit())
                else:
                    self._current[name] = self._states[i].decode(self._ist)
            yield self._prev_time, dict(self._current)


def encode_proto_series(schema: Schema, messages, start_nanos: int) -> bytes:
    enc = ProtoEncoder(schema, start_nanos)
    for ts, values in messages:
        enc.encode(ts, values)
    return enc.stream()


def decode_proto_series(schema: Schema, data: bytes) -> list:
    return list(ProtoDecoder(schema, data))
