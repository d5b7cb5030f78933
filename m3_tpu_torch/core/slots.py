"""Host-side slot allocator: string IDs → dense device array slots.

The device only ever sees dense integer slots; the host owns the ID
dictionary.  This replaces the reference's concurrent-map + async insert
queue series registration (`src/dbnode/storage/shard.go:906`
TryRetrieveSeriesAndIncrementReaderWriterCount miss →
`shard_insert_queue.go` batched creation) — on TPU the "insert queue" is
just dictionary fills amortized over a batch, and the arena capacity is
fixed per shard (SURVEY.md §7 hard part #5).

The port's copy of ``m3_tpu/core/slots.py`` (it imports nothing of ``m3_tpu``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


class SlotAllocator:
    def __init__(self, capacity: int, limiter=None):
        self.capacity = capacity
        self._slots: Dict[bytes, int] = {}
        self._ids: List[bytes | None] = []
        self._free: List[int] = []
        # Optional shared NewSeriesLimiter (storage/limits.py): series
        # CHURN control — creations past the rate yield slot -1, which
        # write paths drop and count as typed rejections (reference
        # dbnode write-new-series runtime limits, kvconfig/keys.go).
        self.limiter = limiter

    def __len__(self) -> int:
        return len(self._slots)

    def __contains__(self, sid: bytes) -> bool:
        return sid in self._slots

    def get(self, sid: bytes) -> int | None:
        return self._slots.get(sid)

    def id_of(self, slot: int) -> bytes | None:
        return self._ids[slot] if slot < len(self._ids) else None

    def resolve(self, ids: Sequence[bytes]) -> np.ndarray:
        """Find-or-create slots for a batch of IDs (vectorized fast path
        for all-known batches).  When a new-series limiter is attached
        and exhausted, creations come back as slot -1 (existing series
        always resolve)."""
        out = np.empty(len(ids), np.int32)
        get = self._slots.get
        missing: List[int] = []
        for i, sid in enumerate(ids):
            s = get(sid)
            if s is None:
                missing.append(i)
                out[i] = -1
            else:
                out[i] = s
        if not missing:
            return out
        # Budget counts CREATIONS, not occurrences: a batch repeating
        # one new id many times must charge one token.  Capacity is a
        # budget too: a full allocator REJECTS the excess creations
        # (slot -1 — counted, existing series still land) instead of
        # raising out of the whole batch.  The round-12 soak found the
        # old behavior the hard way: past ~131K series/shard every
        # mixed batch DIED with an opaque RuntimeError, losing
        # existing-series samples to a capacity problem that only
        # concerns new ones (the same graceful-degradation contract as
        # the new-series rate limiter).  Headroom caps the limiter
        # ACQUISITION, not just the result: the token bucket is shared
        # namespace-wide, and a full shard draining tokens it can never
        # spend would starve shards that still have room.
        n_new = len({ids[i] for i in missing})
        headroom = self.capacity - len(self._ids) + len(self._free)
        n_ask = min(n_new, max(0, headroom))
        budget = (n_ask if self.limiter is None
                  else self.limiter.acquire_up_to(n_ask))
        for i in missing:
            sid = ids[i]
            s = self._slots.get(sid)  # duplicate id earlier in batch
            if s is None:
                if budget <= 0:
                    continue  # stays -1: rejected creation
                budget -= 1
                s = self._allocate(sid)
            out[i] = s
        return out

    def _allocate(self, sid: bytes) -> int:
        if self._free:
            s = self._free.pop()
            self._ids[s] = sid
        else:
            s = len(self._ids)
            if s >= self.capacity:
                raise RuntimeError(f"slot capacity {self.capacity} exhausted")
            self._ids.append(sid)
        self._slots[sid] = s
        return s

    def release(self, slot: int) -> None:
        sid = self._ids[slot]
        if sid is None:
            return
        del self._slots[sid]
        self._ids[slot] = None
        self._free.append(slot)
