"""Multi-source series merge: the one seam every read goes through.

Equivalent of the reference's iterator-merge stack
(`src/dbnode/encoding/multi_reader_iterator.go` merging replica/volume
streams, `series_iterator.go` merging block streams, and the buffer's
in-memory stream contribution `storage/series/buffer.go:705`) — but as a
single sorted dict-merge over (timestamp → value) instead of a k-way
heap of pull iterators: sources are small per-series point lists, and
batched decode already produced arrays.

Precedence: LATER sources win on duplicate timestamps.  Callers order
sources oldest-to-newest (fileset volume < open warm buffer < pending
cold overflow), giving last-write-wins — matching the reference's
version semantics where a higher fileset volume and newer buffer
versions supersede (`buffer.go:1016` BufferBucketVersions).

The port's copy of ``m3_tpu/storage/series_merge.py`` (it imports nothing of ``m3_tpu``).
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

Point = Tuple[int, float]


def merge_point_sources(sources: Iterable[Iterable[Point]]) -> List[Point]:
    """Merge per-source point lists into one time-sorted list with each
    timestamp appearing exactly once; later sources take precedence."""
    merged: dict[int, float] = {}
    for pts in sources:
        for t, v in pts:
            merged[t] = v
    return sorted(merged.items())
