"""Bit-level output/input streams, MSB-first within each byte.

Capability equivalent of the reference's ``src/dbnode/encoding/ostream.go``
(WriteBits writes the low ``n`` bits of a value most-significant-first,
``ostream.go:180-220``) and ``istream.go`` (ReadBits/PeekBits,
``istream.go:71-126``).  This host-side implementation backs the scalar
oracle codec; the batched TPU codec packs bits with vectorized scans
instead (see ``m3tsz_jax.py``).

The port's copy of ``m3_tpu/encoding/bitstream.py`` (it imports nothing of ``m3_tpu``).
"""

from __future__ import annotations

_MASK64 = (1 << 64) - 1


class OStream:
    """Append-only bit stream. Bits fill each byte from the MSB down."""

    __slots__ = ("_buf", "_pos")

    def __init__(self) -> None:
        self._buf = bytearray()
        # Number of bits used in the final byte (1..8); 8 means full/aligned.
        self._pos = 8

    def __len__(self) -> int:  # bytes, rounding the partial byte up
        return len(self._buf)

    @property
    def bit_length(self) -> int:
        if not self._buf:
            return 0
        return (len(self._buf) - 1) * 8 + self._pos

    @property
    def last_byte_pos(self) -> int:
        """Bits used in last byte (1..8); matches reference ``os.pos``."""
        return self._pos

    def write_bit(self, v: int) -> None:
        self.write_bits(v & 1, 1)

    def write_bits(self, v: int, num_bits: int) -> None:
        if num_bits <= 0:
            return
        v &= (1 << num_bits) - 1 if num_bits < 64 else _MASK64
        if num_bits > 64:  # mirror reference clamp (ostream.go:185-187)
            num_bits = 64
        buf, pos = self._buf, self._pos
        while num_bits > 0:
            if pos == 8:
                buf.append(0)
                pos = 0
            take = min(8 - pos, num_bits)
            chunk = (v >> (num_bits - take)) & ((1 << take) - 1)
            buf[-1] |= chunk << (8 - pos - take)
            pos += take
            num_bits -= take
        self._pos = pos

    def write_byte(self, v: int) -> None:
        self.write_bits(v & 0xFF, 8)

    def write_bytes(self, bs: bytes) -> None:
        if self._pos == 8:
            self._buf.extend(bs)
        else:
            for b in bs:
                self.write_byte(b)

    def raw_bytes(self) -> tuple[bytes, int]:
        """(raw buffer including partial last byte, bits used in last byte)."""
        return bytes(self._buf), self._pos

    def bytes_aligned(self) -> bytes:
        """Zero-padded byte string of everything written."""
        return bytes(self._buf)


class IStream:
    """Bit reader over a byte string, MSB-first."""

    __slots__ = ("_data", "_bitpos", "_nbits")

    def __init__(self, data: bytes) -> None:
        self._data = data
        self._bitpos = 0
        self._nbits = len(data) * 8

    @property
    def bit_pos(self) -> int:
        return self._bitpos

    def remaining_bits(self) -> int:
        return self._nbits - self._bitpos

    def read_bits(self, num_bits: int) -> int:
        v = self.peek_bits(num_bits)
        self._bitpos += num_bits
        return v

    def peek_bits(self, num_bits: int) -> int:
        if num_bits == 0:
            return 0
        start = self._bitpos
        end = start + num_bits
        if end > self._nbits:
            raise EOFError("end of stream")
        first_byte = start >> 3
        last_byte = (end + 7) >> 3
        word = int.from_bytes(self._data[first_byte:last_byte], "big")
        tail = (last_byte << 3) - end
        return (word >> tail) & ((1 << num_bits) - 1)

    def try_peek_bits(self, num_bits: int) -> int | None:
        if self._bitpos + num_bits > self._nbits:
            return None
        return self.peek_bits(num_bits)

    def read_bit(self) -> int:
        return self.read_bits(1)

    def read_byte(self) -> int:
        return self.read_bits(8)

    def read_bytes(self, n: int) -> bytes:
        return bytes(self.read_byte() for _ in range(n))
