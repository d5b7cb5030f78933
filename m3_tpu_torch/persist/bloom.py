"""Vectorized bloom filter over series IDs.

The reference writes a bloom filter file per fileset so reads can skip
filesets that cannot contain an ID (`src/dbnode/persist/fs/bloom_filter.go`,
written by `write.go`; M3 uses a k-hash bloom sized from (n, false-positive
rate)).  This one uses double hashing h1 + i*h2 over 64-bit FNV-1a — built
as numpy batch ops so constructing a filter over 100K IDs at flush is a
handful of vector instructions, not 100K hash-object calls.

The port's copy of ``m3_tpu/persist/bloom.py`` (it imports nothing of ``m3_tpu``).
"""

from __future__ import annotations

import math
import struct

import numpy as np

from m3_tpu_torch.persist.corruption import FormatCorruption

_FNV_OFFSET = np.uint64(14695981039346656037)
_FNV_PRIME = np.uint64(1099511628211)


def _fnv1a_batch(ids: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """64-bit FNV-1a of each ID, plus a second independent hash (FNV over
    the reversed bytes), vectorized over a padded (N, L) byte matrix."""
    n = len(ids)
    if n == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
    lens = np.fromiter((len(b) for b in ids), np.int64, n)
    L = max(1, int(lens.max()))
    mat = np.zeros((n, L), np.uint8)
    for i, b in enumerate(ids):
        mat[i, : len(b)] = np.frombuffer(b, np.uint8)
    mask = np.arange(L)[None, :] < lens[:, None]

    with np.errstate(over="ignore"):
        h1 = np.full(n, _FNV_OFFSET)
        h2 = np.full(n, _FNV_OFFSET)
        rev = mat[:, ::-1]
        rev_mask = mask[:, ::-1]
        for j in range(L):
            sel = mask[:, j]
            h1 = np.where(sel, (h1 ^ mat[:, j].astype(np.uint64)) * _FNV_PRIME, h1)
            sel_r = rev_mask[:, j]
            h2 = np.where(sel_r, (h2 ^ rev[:, j].astype(np.uint64)) * _FNV_PRIME, h2)
    # h2 must be odd so the double-hash stride cycles the whole table.
    return h1, h2 | np.uint64(1)


class BloomFilter:
    MAGIC = b"M3TB"

    def __init__(self, m_bits: int, k: int, bits: np.ndarray | None = None):
        self.m = m_bits
        self.k = k
        nwords = (m_bits + 63) // 64
        self.bits = bits if bits is not None else np.zeros(nwords, np.uint64)

    @classmethod
    def from_estimate(cls, n: int, fp_rate: float = 0.02) -> "BloomFilter":
        n = max(1, n)
        m = max(64, int(-n * math.log(fp_rate) / (math.log(2) ** 2)))
        k = max(1, round(m / n * math.log(2)))
        return cls(m, k)

    def _positions(self, ids: list[bytes]) -> np.ndarray:
        h1, h2 = _fnv1a_batch(ids)
        i = np.arange(self.k, dtype=np.uint64)[None, :]
        with np.errstate(over="ignore"):
            return ((h1[:, None] + i * h2[:, None]) % np.uint64(self.m)).astype(
                np.int64
            )

    def add_batch(self, ids: list[bytes]) -> None:
        pos = self._positions(ids).ravel()
        np.bitwise_or.at(
            self.bits, pos // 64, np.uint64(1) << (pos % 64).astype(np.uint64)
        )

    def contains_batch(self, ids: list[bytes]) -> np.ndarray:
        pos = self._positions(ids)
        word = self.bits[pos // 64]
        bit = (word >> (pos % 64).astype(np.uint64)) & np.uint64(1)
        return bit.all(axis=1)

    def contains(self, mid: bytes) -> bool:
        return bool(self.contains_batch([mid])[0])

    def to_bytes(self) -> bytes:
        return (
            self.MAGIC
            + struct.pack("<QI", self.m, self.k)
            + self.bits.tobytes()
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "BloomFilter":
        if data[:4] != cls.MAGIC:
            raise FormatCorruption("bad bloom filter magic",
                                   component="bloom", check="bloom-magic")
        m, k = struct.unpack_from("<QI", data, 4)
        bits = np.frombuffer(data[16:], np.uint64).copy()
        return cls(m, k, bits)
