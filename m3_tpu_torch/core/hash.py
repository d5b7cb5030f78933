"""MurmurHash3 (32-bit, x86 variant) — the framework's shard router hash
(the port's copy of ``m3_tpu/core/hash.py``).

Reference parity: `src/dbnode/sharding/shardset.go:148-163` computes
`shard = murmur3.Sum32(id) % numShards`, and the aggregator's shard fn
(`src/aggregator/sharding`) uses the same family.  Matching the exact
hash means shard assignments agree with M3-compatible tooling (e.g. a
fileset written for shard 7 here is the same shard 7 an M3 operator
expects for that series ID).
"""

from __future__ import annotations

import functools

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
