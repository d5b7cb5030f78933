"""MurmurHash3 (32-bit, x86 variant) — the framework's shard router hash
(the port's copy of ``m3_tpu/core/hash.py``, with ``shards_for``: the
same hash over a whole batch of ids at once).

Reference parity: `src/dbnode/sharding/shardset.go:148-163` computes
`shard = murmur3.Sum32(id) % numShards`, and the aggregator's shard fn
(`src/aggregator/sharding`) uses the same family.  Matching the exact
hash means shard assignments agree with M3-compatible tooling (e.g. a
fileset written for shard 7 here is the same shard 7 an M3 operator
expects for that series ID).
"""

from __future__ import annotations

import functools

import numpy as np

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_M = 0xFFFFFFFF


def murmur3_32(data: bytes, seed: int = 0) -> int:
    """Standard MurmurHash3_x86_32 (verified against published vectors)."""
    h = seed & _M
    n = len(data) & ~3
    for i in range(0, n, 4):
        k = int.from_bytes(data[i : i + 4], "little")
        k = (k * _C1) & _M
        k = ((k << 15) | (k >> 17)) & _M
        k = (k * _C2) & _M
        h ^= k
        h = ((h << 13) | (h >> 19)) & _M
        h = (h * 5 + 0xE6546B64) & _M
    tail = data[n:]
    k = 0
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * _C1) & _M
        k = ((k << 15) | (k >> 17)) & _M
        k = (k * _C2) & _M
        h ^= k
    h ^= len(data)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M
    h ^= h >> 16
    return h


@functools.lru_cache(maxsize=1 << 20)
def shard_for(series_id: bytes, num_shards: int) -> int:
    """`murmur3(id) % numShards` (`sharding/shardset.go:148-163`).

    LRU-cached: ingest hashes the same hot IDs every batch, and the
    pure-Python murmur3 is ~100x slower than the C crc32 it replaced —
    the cache makes repeat routing a C-speed dict hit.
    """
    return murmur3_32(series_id) % num_shards


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def murmur3_32_many(ids, seed: int = 0) -> np.ndarray:
    """``murmur3_32`` of each id, as a uint32 array: ids of one length
    hash together, each step on a column of 32-bit words (numpy's
    uint32 arithmetic wraps as the scalar version's ``& 0xFFFFFFFF``)."""
    n = len(ids)
    out = np.empty(n, np.uint32)
    if n == 0:
        return out
    lens = np.fromiter(map(len, ids), np.int64, n)
    c1, c2 = np.uint32(_C1), np.uint32(_C2)
    uniq = np.unique(lens).tolist()
    with np.errstate(over="ignore"):
        for L in uniq:
            if len(uniq) == 1:
                sel, group = slice(None), ids
            else:
                sel = np.nonzero(lens == L)[0]
                group = [ids[i] for i in sel.tolist()]
            m = len(group)
            a = np.frombuffer(b"".join(group), np.uint8).reshape(m, L)
            nb = L // 4
            h = np.full(m, seed & _M, np.uint32)
            if nb:
                blocks = np.ascontiguousarray(a[:, :4 * nb]).view("<u4")
                for j in range(nb):
                    k = blocks[:, j] * c1
                    k = _rotl(k, 15) * c2
                    h ^= k
                    h = _rotl(h, 13) * np.uint32(5) + np.uint32(0xE6546B64)
            t = L & 3
            if t:
                k = np.zeros(m, np.uint32)
                if t >= 3:
                    k ^= a[:, 4 * nb + 2].astype(np.uint32) << np.uint32(16)
                if t >= 2:
                    k ^= a[:, 4 * nb + 1].astype(np.uint32) << np.uint32(8)
                k ^= a[:, 4 * nb].astype(np.uint32)
                h ^= _rotl(k * c1, 15) * c2
            h ^= np.uint32(L & _M)
            h ^= h >> np.uint32(16)
            h *= np.uint32(0x85EBCA6B)
            h ^= h >> np.uint32(13)
            h *= np.uint32(0xC2B2AE35)
            h ^= h >> np.uint32(16)
            out[sel] = h
    return out


def shards_for(ids, num_shards: int) -> np.ndarray:
    """``shard_for`` of each id, as an int64 array."""
    return (murmur3_32_many(ids) % np.uint32(num_shards)).astype(np.int64)
