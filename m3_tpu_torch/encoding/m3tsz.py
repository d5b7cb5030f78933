"""Bit-exact M3TSZ codec (scalar host oracle).

This is a from-scratch implementation of the M3TSZ stream format — the
Gorilla-style TSZ codec with M3's int optimization — producing output
byte-identical to the reference implementation
(``src/dbnode/encoding/m3tsz/{encoder.go,timestamp_encoder.go,
float_encoder_iterator.go,int_sig_bits_tracker.go,m3tsz.go}`` and
``src/dbnode/encoding/scheme.go``).  It serves as the correctness oracle
for the batched TPU codec (``m3tsz_jax.py``) and the C++ host codec.

Stream layout (int-optimized mode, the default):

* 64-bit first timestamp (UnixNano of the encoder's start time), then per
  datapoint: [annotation marker?][time-unit marker?][delta-of-delta]
  [value bits].
* Delta-of-delta uses per-unit bucket schemes (see ``scheme.py``); a
  time-unit change writes a marker + unit byte + 64-bit nanosecond dod and
  resets the previous delta to zero.
* Values: first value writes a mode bit (0=int, 1=float); ints are stored
  as significant-bit-tracked diffs of ``value * 10^mult``; floats as XOR
  with leading/trailing-zero windows.
* The finalized stream ends with the 11-bit end-of-stream marker.

The port's copy of ``m3_tpu/encoding/m3tsz.py`` (it imports nothing of ``m3_tpu``).
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass, field

from m3_tpu_torch.core.xtime import (
    Unit,
    initial_time_unit,
    to_normalized_duration,
    unit_from_byte,
)
from m3_tpu_torch.encoding import scheme as _scheme
from m3_tpu_torch.encoding.bitstream import IStream, OStream
from m3_tpu_torch.encoding.scheme import (
    ANNOTATION_MARKER,
    END_OF_STREAM_MARKER,
    MARKER_OPCODE,
    NUM_MARKER_OPCODE_BITS,
    NUM_MARKER_VALUE_BITS,
    TIME_UNIT_MARKER,
    scheme_for_unit,
    sign_extend,
    tail_bytes,
    write_special_marker,
)

# --- constants mirroring m3tsz.go:28-62 ---

DEFAULT_INT_OPTIMIZATION_ENABLED = True

OPCODE_ZERO_SIG = 0x0
OPCODE_NON_ZERO_SIG = 0x1
NUM_SIG_BITS = 6

OPCODE_ZERO_VALUE_XOR = 0x0
OPCODE_CONTAINED_VALUE_XOR = 0x2
OPCODE_UNCONTAINED_VALUE_XOR = 0x3
OPCODE_NO_UPDATE_SIG = 0x0
OPCODE_UPDATE_SIG = 0x1
OPCODE_UPDATE = 0x0
OPCODE_NO_UPDATE = 0x1
OPCODE_UPDATE_MULT = 0x1
OPCODE_NO_UPDATE_MULT = 0x0
OPCODE_POSITIVE = 0x0
OPCODE_NEGATIVE = 0x1
OPCODE_REPEAT = 0x1
OPCODE_NO_REPEAT = 0x0
OPCODE_FLOAT_MODE = 0x1
OPCODE_INT_MODE = 0x0

SIG_DIFF_THRESHOLD = 3
SIG_REPEAT_THRESHOLD = 5

MAX_MULT = 6
NUM_MULT_BITS = 3

_MAX_INT = float(2**63)  # float64(math.MaxInt64) rounds up to 2^63
_MIN_INT = float(-(2**63))
_MAX_OPT_INT = 10.0**13
_MULTIPLIERS = [10.0**i for i in range(MAX_MULT + 1)]

_MASK64 = (1 << 64) - 1


def float_to_bits(v: float) -> int:
    return struct.unpack("<Q", struct.pack("<d", v))[0]


def bits_to_float(b: int) -> float:
    return struct.unpack("<d", struct.pack("<Q", b & _MASK64))[0]


def num_sig(v: int) -> int:
    """Number of significant bits in a uint64 (encoding.go:29-31)."""
    return v.bit_length()


def leading_and_trailing_zeros(v: int) -> tuple[int, int]:
    if v == 0:
        return 64, 0
    lead = 64 - v.bit_length()
    trail = (v & -v).bit_length() - 1
    return lead, trail


def convert_to_int_float(v: float, cur_max_mult: int) -> tuple[float, int, bool]:
    """Attempt float -> (scaled int, multiplier); mirrors m3tsz.go:78-118.

    Returns (value, multiplier, is_float).
    """
    if cur_max_mult == 0 and v < _MAX_INT:
        # Quick check for vals that are already ints.  Go's math.Mod
        # yields NaN for ±Inf (and NaN) inputs, which fails the r == 0
        # test and falls through to the float path; Python's math.fmod
        # RAISES on an infinite numerator, so guard explicitly to keep
        # the reference behavior (m3tsz.go:81-86).
        r = math.fmod(v, 1.0) if math.isfinite(v) else math.nan
        if r == 0:
            return v - r, 0, False

    if cur_max_mult > MAX_MULT:
        raise ValueError("supplied multiplier is invalid")

    val = v * _MULTIPLIERS[cur_max_mult]
    sign = 1.0
    if v < 0:
        sign = -1.0
        val = -val

    mult = cur_max_mult
    while mult <= MAX_MULT and val < _MAX_OPT_INT:
        r, i = math.modf(val)
        if r == 0:
            return sign * i, mult, False
        elif r < 0.1:
            # Round down and check.
            if math.nextafter(val, 0.0) <= i:
                return sign * i, mult, False
        elif r > 0.9:
            # Round up and check.
            nxt = i + 1
            if math.nextafter(val, nxt) >= nxt:
                return sign * nxt, mult, False
        val = val * 10.0
        mult += 1

    return v, 0, True


def convert_from_int_float(val: float, mult: int) -> float:
    if mult == 0:
        return val
    return val / _MULTIPLIERS[mult]


@dataclass
class Datapoint:
    timestamp: int  # UnixNano
    value: float
    # None = "derive from encoder state" (auto units): tuples and plain
    # constructions get exactness-preserving unit selection; decode
    # paths set the stream's explicit unit.
    unit: Unit | None = None
    annotation: bytes = b""


def _float_to_uint64_via_int64(val: float) -> int:
    """Go's ``uint64(int64(val))``: amd64 cvttsd2si semantics — NaN and
    out-of-int64-range floats convert to INT64_MIN, then reinterpret as uint64."""
    if math.isnan(val) or val >= _MAX_INT or val < _MIN_INT:
        return 1 << 63
    return int(val) & _MASK64


def _put_varint(x: int) -> bytes:
    """Go binary.PutVarint: zigzag + LEB128."""
    ux = (x << 1) ^ (x >> 63) if x < 0 else x << 1
    out = bytearray()
    while ux >= 0x80:
        out.append((ux & 0x7F) | 0x80)
        ux >>= 7
    out.append(ux)
    return bytes(out)


def _read_varint(istream: IStream) -> int:
    shift = 0
    ux = 0
    while True:
        b = istream.read_byte()
        ux |= (b & 0x7F) << shift
        if b < 0x80:
            break
        shift += 7
    # zigzag decode
    return (ux >> 1) ^ -(ux & 1)


@dataclass
class TimestampEncoder:
    """Delta-of-delta timestamp encoder state (timestamp_encoder.go:35-259)."""

    prev_time: int
    time_unit: Unit
    prev_time_delta: int = 0
    prev_annotation: bytes | None = None  # None == "empty" sentinel
    has_written_first: bool = False
    time_unit_encoded_manually: bool = False

    @classmethod
    def new(cls, start: int, unit: Unit = Unit.SECOND) -> "TimestampEncoder":
        return cls(prev_time=start, time_unit=initial_time_unit(start, unit))

    def write_time(self, os: OStream, curr: int, annotation: bytes, unit: Unit) -> None:
        if not self.has_written_first:
            self.write_first_time(os, curr, annotation, unit)
            self.has_written_first = True
            return
        self.write_next_time(os, curr, annotation, unit)

    def write_first_time(self, os: OStream, curr: int, annotation: bytes, unit: Unit) -> None:
        # First time is always written in nanoseconds (64 bits of start time).
        os.write_bits(self.prev_time & _MASK64, 64)
        self.write_next_time(os, curr, annotation, unit)

    def write_next_time(self, os: OStream, curr: int, annotation: bytes, unit: Unit) -> None:
        self._write_annotation(os, annotation)
        tu_changed = self._maybe_write_time_unit_change(os, unit)

        time_delta = curr - self.prev_time
        self.prev_time = curr
        if tu_changed or self.time_unit_encoded_manually:
            # Normalize to nanoseconds and write a full 64-bit dod.
            dod = time_delta - self.prev_time_delta
            os.write_bits(dod & _MASK64, 64)
            self.prev_time_delta = 0
            self.time_unit_encoded_manually = False
            return

        self._write_dod(os, self.prev_time_delta, time_delta, unit)
        self.prev_time_delta = time_delta

    def write_time_unit(self, os: OStream, unit: Unit) -> None:
        os.write_byte(int(unit))
        self.time_unit = unit
        self.time_unit_encoded_manually = True

    def auto_unit_for(self, curr: int) -> Unit:
        """State-aware unit choice: the current unit while it represents
        the next delta-of-delta exactly, else the coarsest unit that
        does (reference timestamp_encoder.go:205-246 switches units via
        markers; precision is never rounded away)."""
        dod = (curr - self.prev_time) - self.prev_time_delta
        u = self.time_unit
        if u.is_valid() and u.nanos() > 0 and dod % u.nanos() == 0:
            return u
        for cand in (Unit.SECOND, Unit.MILLISECOND, Unit.MICROSECOND):
            if dod % cand.nanos() == 0:
                return cand
        return Unit.NANOSECOND

    def _maybe_write_time_unit_change(self, os: OStream, unit: Unit) -> bool:
        if not unit.is_valid() or unit == self.time_unit:
            return False
        write_special_marker(os, TIME_UNIT_MARKER)
        self.write_time_unit(os, unit)
        return True

    def _write_annotation(self, os: OStream, annotation: bytes) -> None:
        if not annotation:
            return
        if self.prev_annotation is not None and annotation == self.prev_annotation:
            return
        write_special_marker(os, ANNOTATION_MARKER)
        os.write_bytes(_put_varint(len(annotation) - 1))
        os.write_bytes(annotation)
        self.prev_annotation = annotation

    def _write_dod(self, os: OStream, prev_delta: int, curr_delta: int, unit: Unit) -> None:
        u = unit.nanos()
        if u == 0:
            raise ValueError("invalid time unit for dod encoding")
        dod = to_normalized_duration(curr_delta - prev_delta, u)
        if unit in (Unit.MILLISECOND, Unit.SECOND):
            if not (-(2**31) <= dod < 2**31):
                raise OverflowError(f"deltaOfDelta value {dod} {unit} overflows 32 bits")
        tes = scheme_for_unit(unit)
        if tes is None:
            raise ValueError("time encoding scheme doesn't exist for unit")
        if dod == 0:
            zb = tes.zero_bucket
            os.write_bits(zb.opcode, zb.num_opcode_bits)
            return
        for b in tes.buckets:
            if b.min <= dod <= b.max:
                os.write_bits(b.opcode, b.num_opcode_bits)
                os.write_bits(dod & ((1 << b.num_value_bits) - 1), b.num_value_bits)
                return
        db = tes.default_bucket
        os.write_bits(db.opcode, db.num_opcode_bits)
        os.write_bits(dod & ((1 << db.num_value_bits) - 1), db.num_value_bits)


@dataclass
class FloatXOR:
    """XOR float encode/decode state (float_encoder_iterator.go:34-165)."""

    prev_xor: int = 0
    prev_float_bits: int = 0

    def write_full(self, os: OStream, bits: int) -> None:
        self.prev_float_bits = bits
        self.prev_xor = bits
        os.write_bits(bits, 64)

    def write_next(self, os: OStream, bits: int) -> None:
        xor = self.prev_float_bits ^ bits
        self._write_xor(os, xor)
        self.prev_xor = xor
        self.prev_float_bits = bits

    def _write_xor(self, os: OStream, cur_xor: int) -> None:
        if cur_xor == 0:
            os.write_bits(OPCODE_ZERO_VALUE_XOR, 1)
            return
        prev_lead, prev_trail = leading_and_trailing_zeros(self.prev_xor)
        cur_lead, cur_trail = leading_and_trailing_zeros(cur_xor)
        if cur_lead >= prev_lead and cur_trail >= prev_trail:
            os.write_bits(OPCODE_CONTAINED_VALUE_XOR, 2)
            os.write_bits(cur_xor >> prev_trail, 64 - prev_lead - prev_trail)
            return
        os.write_bits(OPCODE_UNCONTAINED_VALUE_XOR, 2)
        os.write_bits(cur_lead, 6)
        num_meaningful = 64 - cur_lead - cur_trail
        os.write_bits(num_meaningful - 1, 6)
        os.write_bits(cur_xor >> cur_trail, num_meaningful)

    def read_full(self, ist: IStream) -> None:
        bits = ist.read_bits(64)
        self.prev_float_bits = bits
        self.prev_xor = bits

    def read_next(self, ist: IStream) -> None:
        cb = ist.read_bits(1)
        if cb == OPCODE_ZERO_VALUE_XOR:
            self.prev_xor = 0
            return
        cb = (cb << 1) | ist.read_bits(1)
        if cb == OPCODE_CONTAINED_VALUE_XOR:
            prev_lead, prev_trail = leading_and_trailing_zeros(self.prev_xor)
            num_meaningful = 64 - prev_lead - prev_trail
            bits = ist.read_bits(num_meaningful)
            self.prev_xor = (bits << prev_trail) & _MASK64
            self.prev_float_bits ^= self.prev_xor
            return
        packed = ist.read_bits(12)
        num_lead = (packed >> 6) & 0x3F
        num_meaningful = (packed & 0x3F) + 1
        bits = ist.read_bits(num_meaningful)
        num_trail = 64 - num_lead - num_meaningful
        self.prev_xor = (bits << num_trail) & _MASK64
        self.prev_float_bits ^= self.prev_xor


@dataclass
class IntSigBitsTracker:
    """Significant-bit tracker for int diffs (int_sig_bits_tracker.go:27-91)."""

    num_sig: int = 0
    cur_highest_lower_sig: int = 0
    num_lower_sig: int = 0

    def write_int_val_diff(self, os: OStream, val_bits: int, neg: bool) -> None:
        os.write_bit(OPCODE_NEGATIVE if neg else OPCODE_POSITIVE)
        os.write_bits(val_bits & ((1 << self.num_sig) - 1 if self.num_sig < 64 else _MASK64),
                      self.num_sig)

    def write_int_sig(self, os: OStream, sig: int) -> None:
        if self.num_sig != sig:
            os.write_bit(OPCODE_UPDATE_SIG)
            if sig == 0:
                os.write_bit(OPCODE_ZERO_SIG)
            else:
                os.write_bit(OPCODE_NON_ZERO_SIG)
                os.write_bits(sig - 1, NUM_SIG_BITS)
        else:
            os.write_bit(OPCODE_NO_UPDATE_SIG)
        self.num_sig = sig

    def track_new_sig(self, sig: int) -> int:
        new_sig = self.num_sig
        if sig > self.num_sig:
            new_sig = sig
        elif self.num_sig - sig >= SIG_DIFF_THRESHOLD:
            if self.num_lower_sig == 0:
                self.cur_highest_lower_sig = sig
            elif sig > self.cur_highest_lower_sig:
                self.cur_highest_lower_sig = sig
            self.num_lower_sig += 1
            if self.num_lower_sig >= SIG_REPEAT_THRESHOLD:
                new_sig = self.cur_highest_lower_sig
                self.num_lower_sig = 0
        else:
            self.num_lower_sig = 0
        return new_sig


class Encoder:
    """M3TSZ stream encoder (encoder.go:42-250).

    Datapoints with ``unit=None`` derive their time unit from the
    encoder state: keep the current stream unit while it divides the
    delta-of-delta exactly, otherwise switch (with a marker) to the
    coarsest unit that does.  This is the faithful mapping of the
    reference's per-write unit metadata onto an API whose timestamps
    are raw int64 nanos — a sub-unit timestamp can NEVER be silently
    rounded (the round-4 flush-precision bug), and aligned streams stay
    byte-identical to the fixed-unit form."""

    def __init__(self, start: int, int_optimized: bool = True,
                 unit: Unit = Unit.SECOND):
        self.os = OStream()
        self.ts = TimestampEncoder.new(start, unit)
        self.float_enc = FloatXOR()
        self.sig_tracker = IntSigBitsTracker()
        self.int_val = 0.0
        self.num_encoded = 0
        self.max_mult = 0
        self.int_optimized = int_optimized
        self.is_float = False

    def encode(self, dp: Datapoint) -> None:
        unit = dp.unit
        if unit is None:  # derive exactness-preserving unit from state
            unit = self.ts.auto_unit_for(dp.timestamp)
        self.ts.write_time(self.os, dp.timestamp, dp.annotation, unit)
        if self.num_encoded == 0:
            self._write_first_value(dp.value)
        else:
            self._write_next_value(dp.value)
        self.num_encoded += 1

    def _write_first_value(self, v: float) -> None:
        if not self.int_optimized:
            self.float_enc.write_full(self.os, float_to_bits(v))
            return
        val, mult, is_float = convert_to_int_float(v, 0)
        if is_float:
            self.os.write_bit(OPCODE_FLOAT_MODE)
            self.float_enc.write_full(self.os, float_to_bits(v))
            self.is_float = True
            self.max_mult = mult
            return
        self.os.write_bit(OPCODE_INT_MODE)
        self.int_val = val
        neg_diff = True
        if val < 0:
            neg_diff = False
            val = -val
        val_bits = _float_to_uint64_via_int64(val)
        sig = num_sig(val_bits)
        self._write_int_sig_mult(sig, mult, False)
        self.sig_tracker.write_int_val_diff(self.os, val_bits, neg_diff)

    def _write_next_value(self, v: float) -> None:
        if not self.int_optimized:
            self.float_enc.write_next(self.os, float_to_bits(v))
            return
        val, mult, is_float = convert_to_int_float(v, self.max_mult)
        val_diff = 0.0
        if not is_float:
            val_diff = self.int_val - val
        if is_float or val_diff >= _MAX_INT or val_diff <= _MIN_INT:
            self._write_float_val(float_to_bits(val), mult)
            return
        self._write_int_val(val, mult, is_float, val_diff)

    def _write_float_val(self, bits: int, mult: int) -> None:
        if not self.is_float:
            self.os.write_bit(OPCODE_UPDATE)
            self.os.write_bit(OPCODE_NO_REPEAT)
            self.os.write_bit(OPCODE_FLOAT_MODE)
            self.float_enc.write_full(self.os, bits)
            self.is_float = True
            self.max_mult = mult
            return
        if bits == self.float_enc.prev_float_bits:
            self.os.write_bit(OPCODE_UPDATE)
            self.os.write_bit(OPCODE_REPEAT)
            return
        self.os.write_bit(OPCODE_NO_UPDATE)
        self.float_enc.write_next(self.os, bits)

    def _write_int_val(self, val: float, mult: int, is_float: bool, val_diff: float) -> None:
        if val_diff == 0 and is_float == self.is_float and mult == self.max_mult:
            self.os.write_bit(OPCODE_UPDATE)
            self.os.write_bit(OPCODE_REPEAT)
            return
        neg = False
        if val_diff < 0:
            neg = True
            val_diff = -val_diff
        val_diff_bits = int(val_diff)
        sig = num_sig(val_diff_bits)
        new_sig = self.sig_tracker.track_new_sig(sig)
        is_float_changed = is_float != self.is_float
        if mult > self.max_mult or self.sig_tracker.num_sig != new_sig or is_float_changed:
            self.os.write_bit(OPCODE_UPDATE)
            self.os.write_bit(OPCODE_NO_REPEAT)
            self.os.write_bit(OPCODE_INT_MODE)
            self._write_int_sig_mult(new_sig, mult, is_float_changed)
            self.sig_tracker.write_int_val_diff(self.os, val_diff_bits, neg)
            self.is_float = False
        else:
            self.os.write_bit(OPCODE_NO_UPDATE)
            self.sig_tracker.write_int_val_diff(self.os, val_diff_bits, neg)
        self.int_val = val

    def _write_int_sig_mult(self, sig: int, mult: int, float_changed: bool) -> None:
        self.sig_tracker.write_int_sig(self.os, sig)
        if mult > self.max_mult:
            self.os.write_bit(OPCODE_UPDATE_MULT)
            self.os.write_bits(mult, NUM_MULT_BITS)
            self.max_mult = mult
        elif self.sig_tracker.num_sig == sig and self.max_mult == mult and float_changed:
            self.os.write_bit(OPCODE_UPDATE_MULT)
            self.os.write_bits(self.max_mult, NUM_MULT_BITS)
        else:
            self.os.write_bit(OPCODE_NO_UPDATE_MULT)

    def stream(self) -> bytes:
        """Finalized stream: head bytes + tail (last byte bits + EOS marker)."""
        raw, pos = self.os.raw_bytes()
        if not raw:
            return b""
        return raw[:-1] + tail_bytes(raw[-1], pos)

    def last_encoded(self) -> Datapoint:
        if self.num_encoded == 0:
            raise ValueError("encoder has no encoded datapoints")
        value = (
            bits_to_float(self.float_enc.prev_float_bits) if self.is_float else self.int_val
        )
        return Datapoint(self.ts.prev_time, value, self.ts.time_unit)


class ReaderIterator:
    """M3TSZ stream decoder (iterator.go:47-278, timestamp_iterator.go:41-361)."""

    def __init__(self, data: bytes, int_optimized: bool = True,
                 default_unit: Unit = Unit.SECOND, skip_markers: bool = False):
        self.ist = IStream(data)
        self.int_optimized = int_optimized
        self.skip_markers = skip_markers
        self.default_unit = default_unit
        # timestamp state
        self.prev_time = 0
        self.prev_time_delta = 0
        self.time_unit = Unit.NONE
        self.time_unit_changed = False
        self.done = False
        self.cur_annotation: bytes = b""
        # value state
        self.float_iter = FloatXOR()
        self.int_val = 0.0
        self.mult = 0
        self.sig = 0
        self.is_float = False
        self.curr: Datapoint | None = None

    # -- timestamp path --

    def _read_timestamp(self) -> bool:
        """Returns True if this was the first timestamp; sets self.done on EOS."""
        self.cur_annotation = b""
        first = False
        if self.prev_time != 0:
            dod = self._read_marker_or_dod()
            if not self.done:
                self.prev_time_delta += dod
                self.prev_time += self.prev_time_delta
        else:
            first = True
            self._read_first_timestamp()
        if self.time_unit_changed:
            self.prev_time_delta = 0
            self.time_unit_changed = False
        return first

    def _read_first_timestamp(self) -> None:
        nt = sign_extend(self.ist.read_bits(64), 64)
        if self.time_unit == Unit.NONE:
            self.time_unit = initial_time_unit(nt, self.default_unit)
        dod = self._read_marker_or_dod()
        if self.done:
            return
        self.prev_time_delta += dod
        self.prev_time = nt + self.prev_time_delta

    def _read_marker_or_dod(self) -> int:
        if not self.skip_markers:
            dod, success = self._try_read_marker()
            if success or self.done:
                return dod
        return self._read_dod()

    def _try_read_marker(self) -> tuple[int, bool]:
        num_bits = NUM_MARKER_OPCODE_BITS + NUM_MARKER_VALUE_BITS
        peek = self.ist.try_peek_bits(num_bits)
        if peek is None:
            return 0, False
        opcode = peek >> NUM_MARKER_VALUE_BITS
        if opcode != MARKER_OPCODE:
            return 0, False
        marker = peek & ((1 << NUM_MARKER_VALUE_BITS) - 1)
        if marker == END_OF_STREAM_MARKER:
            self.ist.read_bits(num_bits)
            self.done = True
            return 0, True
        elif marker == ANNOTATION_MARKER:
            self.ist.read_bits(num_bits)
            ant_len = _read_varint(self.ist) + 1
            if ant_len <= 0:
                raise ValueError("expected annotation length to be >= 0")
            self.cur_annotation = self.ist.read_bytes(ant_len)
            return self._read_marker_or_dod(), True
        elif marker == TIME_UNIT_MARKER:
            self.ist.read_bits(num_bits)
            self._read_time_unit()
            return self._read_marker_or_dod(), True
        return 0, False

    def _read_time_unit(self) -> None:
        tu = unit_from_byte(self.ist.read_bits(8))
        if tu.is_valid() and tu != self.time_unit:
            self.time_unit_changed = True
        self.time_unit = tu

    def _read_dod(self) -> int:
        if self.time_unit_changed:
            # Full 64-bit nanosecond dod after a time unit change.
            return sign_extend(self.ist.read_bits(64), 64)
        tes = scheme_for_unit(self.time_unit)
        if tes is None:
            raise ValueError("time encoding scheme doesn't exist for unit")
        cb = self.ist.read_bits(1)
        if cb == tes.zero_bucket.opcode:
            return 0
        for bucket in tes.buckets:
            cb = (cb << 1) | self.ist.read_bits(1)
            if cb == bucket.opcode:
                dod = sign_extend(self.ist.read_bits(bucket.num_value_bits),
                                  bucket.num_value_bits)
                return dod * self.time_unit.nanos()
        dod = sign_extend(self.ist.read_bits(tes.default_bucket.num_value_bits),
                          tes.default_bucket.num_value_bits)
        return dod * self.time_unit.nanos()

    # -- value path --

    def _read_first_value(self) -> None:
        if not self.int_optimized:
            self.float_iter.read_full(self.ist)
            return
        if self.ist.read_bits(1) == OPCODE_FLOAT_MODE:
            self.float_iter.read_full(self.ist)
            self.is_float = True
            return
        self._read_int_sig_mult()
        self._read_int_val_diff()

    def _read_next_value(self) -> None:
        if not self.int_optimized:
            self.float_iter.read_next(self.ist)
            return
        if self.ist.read_bits(1) == OPCODE_UPDATE:
            if self.ist.read_bits(1) == OPCODE_REPEAT:
                return
            if self.ist.read_bits(1) == OPCODE_FLOAT_MODE:
                self.float_iter.read_full(self.ist)
                self.is_float = True
                return
            self._read_int_sig_mult()
            self._read_int_val_diff()
            self.is_float = False
            return
        if self.is_float:
            self.float_iter.read_next(self.ist)
            return
        self._read_int_val_diff()

    def _read_int_sig_mult(self) -> None:
        if self.ist.read_bits(1) == OPCODE_UPDATE_SIG:
            if self.ist.read_bits(1) == OPCODE_ZERO_SIG:
                self.sig = 0
            else:
                self.sig = self.ist.read_bits(NUM_SIG_BITS) + 1
        if self.ist.read_bits(1) == OPCODE_UPDATE_MULT:
            self.mult = self.ist.read_bits(NUM_MULT_BITS)
            if self.mult > MAX_MULT:
                raise ValueError("supplied multiplier is invalid")

    def _read_int_val_diff(self) -> None:
        if self.sig == 64:
            sign = 1.0 if self.ist.read_bits(1) == OPCODE_NEGATIVE else -1.0
            self.int_val += sign * float(self.ist.read_bits(self.sig))
            return
        bits = self.ist.read_bits(self.sig + 1)
        sign = -1.0
        if (bits >> self.sig) == OPCODE_NEGATIVE:
            sign = 1.0
            bits ^= 1 << self.sig
        self.int_val += sign * float(bits)

    # -- iteration --

    def __iter__(self):
        return self

    def __next__(self) -> Datapoint:
        if self.done:
            raise StopIteration
        first = self._read_timestamp()
        if self.done:
            raise StopIteration
        if first:
            self._read_first_value()
        else:
            self._read_next_value()
        if not self.int_optimized or self.is_float:
            value = bits_to_float(self.float_iter.prev_float_bits)
        else:
            value = convert_from_int_float(self.int_val, self.mult)
        self.curr = Datapoint(self.prev_time, value, self.time_unit, self.cur_annotation)
        return self.curr


def encode_series(datapoints, start: int | None = None,
                  int_optimized: bool = True, unit: Unit = Unit.SECOND) -> bytes:
    """Encode a sequence of (timestamp, value) or Datapoint into one stream.

    Bare (timestamp, value) tuples become unit=None datapoints, whose
    units derive per datapoint from the encoder state: a sub-unit delta
    switches the stream to a finer unit with a marker instead of being
    SILENTLY ROUNDED (the bug the round-4 race tier caught: flushed
    blocks lost nanosecond offsets), while aligned streams stay
    byte-identical to the fixed-unit form.  Datapoints with an explicit
    unit keep it — the reference's semantics, where precision is
    per-write metadata — and mixing the two forms is safe."""
    dps = [dp if isinstance(dp, Datapoint) else Datapoint(dp[0], dp[1])
           for dp in datapoints]
    if not dps:
        return b""
    if start is None:
        start = dps[0].timestamp
    enc = Encoder(start, int_optimized=int_optimized, unit=unit)
    for dp in dps:
        enc.encode(dp)  # unit=None datapoints (tuples) auto-derive
    return enc.stream()


def decode_series(data: bytes, int_optimized: bool = True,
                  default_unit: Unit = Unit.SECOND) -> list[Datapoint]:
    if not data:
        return []
    return list(ReaderIterator(data, int_optimized=int_optimized, default_unit=default_unit))
