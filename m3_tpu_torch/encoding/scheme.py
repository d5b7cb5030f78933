"""Marker and delta-of-delta time encoding schemes.

Wire-compatible with the reference defaults in
``src/dbnode/encoding/scheme.go:28-62``:

* marker opcode ``0x100`` in 9 bits followed by a 2-bit marker value
  (end-of-stream=0, annotation=1, time-unit=2);
* per-unit delta-of-delta bucket schemes: zero bucket = 1 bit ``0``;
  buckets ``10``+7-bit, ``110``+9-bit, ``1110``+12-bit; default bucket
  ``1111`` + 32 bits (second/millisecond) or 64 bits (micro/nanosecond).

Values in buckets are two's-complement truncated to the value width and
sign-extended on read.

The port's copy of ``m3_tpu/encoding/scheme.py`` (it imports nothing of ``m3_tpu``).
"""

from __future__ import annotations

from dataclasses import dataclass

from m3_tpu_torch.core.xtime import Unit

MARKER_OPCODE = 0x100
NUM_MARKER_OPCODE_BITS = 9
NUM_MARKER_VALUE_BITS = 2

END_OF_STREAM_MARKER = 0
ANNOTATION_MARKER = 1
TIME_UNIT_MARKER = 2


@dataclass(frozen=True)
class TimeBucket:
    opcode: int
    num_opcode_bits: int
    num_value_bits: int

    @property
    def min(self) -> int:
        return -(1 << (self.num_value_bits - 1))

    @property
    def max(self) -> int:
        return (1 << (self.num_value_bits - 1)) - 1


@dataclass(frozen=True)
class TimeEncodingScheme:
    zero_bucket: TimeBucket
    buckets: tuple[TimeBucket, ...]
    default_bucket: TimeBucket


def _make_scheme(bucket_value_bits: list[int], default_value_bits: int) -> TimeEncodingScheme:
    buckets = []
    opcode = 0
    num_opcode_bits = 1
    for i, nbits in enumerate(bucket_value_bits):
        opcode = (1 << (i + 1)) | opcode
        buckets.append(TimeBucket(opcode, num_opcode_bits + 1, nbits))
        num_opcode_bits += 1
    default = TimeBucket(opcode | 0x1, num_opcode_bits, default_value_bits)
    return TimeEncodingScheme(TimeBucket(0x0, 1, 0), tuple(buckets), default)


_DEFAULT_BUCKET_BITS = [7, 9, 12]

DEFAULT_TIME_ENCODING_SCHEMES: dict[Unit, TimeEncodingScheme] = {
    Unit.SECOND: _make_scheme(_DEFAULT_BUCKET_BITS, 32),
    Unit.MILLISECOND: _make_scheme(_DEFAULT_BUCKET_BITS, 32),
    Unit.MICROSECOND: _make_scheme(_DEFAULT_BUCKET_BITS, 64),
    Unit.NANOSECOND: _make_scheme(_DEFAULT_BUCKET_BITS, 64),
}


def scheme_for_unit(unit: Unit) -> TimeEncodingScheme | None:
    return DEFAULT_TIME_ENCODING_SCHEMES.get(unit)


def sign_extend(v: int, num_bits: int) -> int:
    sign_bit = 1 << (num_bits - 1)
    return (v ^ sign_bit) - sign_bit


def write_special_marker(os, marker: int) -> None:
    os.write_bits(MARKER_OPCODE, NUM_MARKER_OPCODE_BITS)
    os.write_bits(marker, NUM_MARKER_VALUE_BITS)


def tail_bytes(last_byte: int, pos: int) -> bytes:
    """The end-of-stream tail: the used bits of the last byte followed by the
    end-of-stream marker, zero padded to a byte boundary.

    Mirrors the precomputed tails in ``scheme.go:198-212``.
    """
    from m3_tpu_torch.encoding.bitstream import OStream

    tmp = OStream()
    tmp.write_bits(last_byte >> (8 - pos), pos)
    write_special_marker(tmp, END_OF_STREAM_MARKER)
    return tmp.bytes_aligned()
