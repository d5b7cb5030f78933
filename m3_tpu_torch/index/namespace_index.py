"""Namespace index: time-blocked, multi-segment, compacting.

Equivalent of `src/dbnode/storage/index` (`nsIndex`, `index.go:97`) plus
the segment-builder compaction tier
(`src/m3ninx/index/segment/builder/multi_segments_builder.go`): an
active mutable segment per index block start receives tagged writes
(`WriteBatch` `index.go:624`); sealing appends an immutable segment to
the block's segment LIST (cheap — no proportional-to-history merge on
the write path); a background compaction pass merges a block's segments
tiered-smallest-first down to a bounded count, dropping tombstoned
series, so sustained series churn neither grows the per-query segment
fan-out nor resurrects deleted series.  `Query` (`index.go:1483`)
executes a boolean query across every live segment of every overlapping
block, de-duplicating by series ID and filtering tombstones.

The counterpart of ``m3_tpu/index/namespace_index.py``: a copy, with
``device`` (None means CUDA, which raises without one) passed to the
bitset executor.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from m3_tpu_torch import resolve_device
from m3_tpu_torch.index.doc import Document
from m3_tpu_torch.index.search import Query, execute_segment
from m3_tpu_torch.index.segment import MutableSegment, SealedSegment, merge_segments
from m3_tpu_torch.instrument import logger

_LOG = logger("index.namespace_index")

# Compaction targets: a block holding more than MAX_SEGMENTS sealed
# segments gets merged down to at most TARGET_SEGMENTS (batching several
# seals per merge amortizes the rebuild, like the reference's
# size-tiered compaction plans).
MAX_SEGMENTS = 4
TARGET_SEGMENTS = 2


def _merge_excluding(segments: list[SealedSegment],
                     tombstones: set[bytes]) -> SealedSegment:
    """merge_segments with tombstone filtering: deleted series do not
    survive compaction (the reference drops them when the builder
    rewrites postings)."""
    m = MutableSegment()
    for seg in segments:
        for did in range(len(seg)):
            d = seg.doc(did)
            if d.id not in tombstones:
                m.insert(d)
    return m.seal()


class NamespaceIndex:
    def __init__(self, block_size_nanos: int, root: str | None = None,
                 namespace: str = "default", device=None):
        self.block_size = block_size_nanos
        self.device = resolve_device(device)
        self.root = root
        self.namespace = namespace
        self.mutable: dict[int, MutableSegment] = {}
        self.sealed: dict[int, list[SealedSegment]] = {}
        self.tombstones: dict[int, set[bytes]] = {}
        # per-block memo of the tombstone set already applied to the
        # SEALED segments (compaction cost control, see compact_block)
        self._tombs_applied: dict[int, frozenset] = {}
        # block_start -> (generation, sealed view) memo so read-heavy
        # workloads don't rebuild term tables per query.
        self._mutable_view: dict[int, tuple[int, SealedSegment]] = {}
        if root is not None:
            self._load_sealed()

    # -- write path --------------------------------------------------------

    def _block_for(self, ts_nanos: int) -> int:
        return ts_nanos // self.block_size * self.block_size

    def write_batch(self, docs: list[Document], ts_nanos: np.ndarray) -> None:
        """Index each tagged series in the block its timestamp falls in
        (reference forward-index semantics simplified: one insert per
        (doc, block)).  A re-created series clears any tombstone."""
        for doc, t in zip(docs, ts_nanos):
            bs = self._block_for(int(t))
            seg = self.mutable.get(bs)
            if seg is None:
                seg = self.mutable[bs] = MutableSegment()
            seg.insert(doc)
            ts = self.tombstones.get(bs)
            if ts:
                ts.discard(doc.id)

    def delete_series(self, block_start: int, ids) -> None:
        """Tombstone series within a block (series expiry/churn): they
        stop matching queries immediately and are physically dropped by
        the next compaction (the reference deletes at segment rewrite)."""
        self.tombstones.setdefault(block_start, set()).update(ids)
        self._tombs_applied.pop(block_start, None)

    # -- seal/persist ------------------------------------------------------

    def _seg_path(self, block_start: int, n: int) -> Path:
        return (
            Path(self.root) / "index" / self.namespace
            / f"segment-{block_start}-{n}.db"
        )

    def _persist_block(self, block_start: int) -> None:
        """Rewrite the block's segment files to match memory: new files
        first, then drop strays (crash between the two leaves extra
        segments, which are self-contained and merely re-compacted)."""
        if self.root is None:
            return
        d = Path(self.root) / "index" / self.namespace
        d.mkdir(parents=True, exist_ok=True)
        keep = set()
        for n, seg in enumerate(self.sealed.get(block_start, [])):
            p = self._seg_path(block_start, n)
            p.write_bytes(seg.to_bytes())
            keep.add(p.name)
        for f in d.glob(f"segment-{block_start}-*.db"):
            if f.name not in keep:
                f.unlink()
        legacy = d / f"segment-{block_start}.db"
        legacy.unlink(missing_ok=True)

    def seal_block(self, block_start: int) -> SealedSegment | None:
        """Mutable -> sealed: APPENDS to the block's segment list (O(new
        docs), the write path never pays a history-sized merge); the
        reference's equivalent is rotating the active segment into the
        flushed set, with compaction left to the background pass."""
        m = self.mutable.pop(block_start, None)
        self._mutable_view.pop(block_start, None)
        if m is None or len(m) == 0:
            return None
        sealed = m.seal()
        segs = self.sealed.setdefault(block_start, [])
        segs.append(sealed)
        # the fresh segment may carry tombstoned docs from the mutable
        # side: force the next compaction to re-apply the tombstone set
        self._tombs_applied.pop(block_start, None)
        # Persist ONLY the appended segment: sealed segments are
        # immutable and position-named, so earlier files are already
        # correct on disk — a full _persist_block here would rewrite the
        # whole block history per seal (O(total history) I/O, quadratic
        # under churn).  Full rewrites happen only in compact_block,
        # where the list structure actually changes.
        if self.root is not None:
            d = Path(self.root) / "index" / self.namespace
            d.mkdir(parents=True, exist_ok=True)
            self._seg_path(block_start, len(segs) - 1).write_bytes(
                sealed.to_bytes())
        return sealed

    def compact_block(self, block_start: int,
                      max_segments: int = MAX_SEGMENTS,
                      target_segments: int = TARGET_SEGMENTS) -> int:
        """Tiered compaction: while over ``max_segments``, merge the
        smallest segments together until at most ``target_segments``
        remain, dropping tombstones.  Returns merges performed."""
        segs = self.sealed.get(block_start)
        tombs = self.tombstones.get(block_start, set())
        if not segs:
            return 0
        if len(segs) <= max_segments and not tombs:
            return 0
        # Skip the per-doc tombstone scan when this exact tombstone set
        # was already applied to the sealed segments (it lingers only
        # because a mutable segment keeps it alive — see below): without
        # the memo every mediator tick would rescan every doc.
        tombs_f = frozenset(tombs)
        if (len(segs) <= max_segments
                and self._tombs_applied.get(block_start) == tombs_f):
            return 0
        merges = 0
        if len(segs) > max_segments:
            segs.sort(key=len)
            take = len(segs) - target_segments + 1
            merged = _merge_excluding(segs[:take], tombs)
            segs[:take] = [merged] if len(merged) else []
            merges += 1
        if tombs:
            # Drop tombstones from any remaining segment that holds one.
            out = []
            for seg in segs:
                if any(seg.doc(d).id in tombs for d in range(len(seg))):
                    rewritten = _merge_excluding([seg], tombs)
                    if len(rewritten):
                        out.append(rewritten)
                    merges += 1
                else:
                    out.append(seg)
            segs[:] = out
        if not segs:
            self.sealed.pop(block_start, None)
        # Tombstones may only be retired once no mutable segment can
        # still hold a deleted doc: the mutable side is filtered at
        # query time and physically dropped when it seals and the NEXT
        # compaction rewrites it — popping early would resurrect those.
        if block_start not in self.mutable:
            self.tombstones.pop(block_start, None)
            self._tombs_applied.pop(block_start, None)
        else:
            self._tombs_applied[block_start] = tombs_f
        if merges:
            self._persist_block(block_start)
        return merges

    def compact(self) -> int:
        """Background pass over every block (mediator tick hook)."""
        return sum(
            self.compact_block(bs) for bs in sorted(self.sealed)
        )

    @property
    def segment_counts(self) -> dict[int, int]:
        return {bs: len(segs) for bs, segs in self.sealed.items()}

    def _load_sealed(self) -> None:
        d = Path(self.root) / "index" / self.namespace
        if not d.exists():
            return
        for f in sorted(d.glob("segment-*.db")):
            parts = f.stem.split("-")
            bs = int(parts[1])
            try:
                seg = SealedSegment.from_bytes(f.read_bytes())
            except (ValueError, struct.error) as e:
                # A rotted sealed segment must not crash-loop node
                # start (same contract as restore_snapshot below): the
                # block's data still serves through filesets/WAL; only
                # its reverse-index entries are lost until re-indexed.
                _LOG.warning("skipping corrupt index segment %s: %s", f, e)
                continue
            self.sealed.setdefault(bs, []).append(seg)

    def snapshot_mutable(self, snap_root: str) -> int:
        """Persist a sealed VIEW of every mutable segment under
        `snap_root` without sealing it — the index half of a buffer
        snapshot (the reference's commitlog bootstrapper re-indexes from
        WAL metadata; covered logs are cleaned once snapshotted, so the
        snapshot must carry the un-flushed index state too)."""
        written = 0
        for bs, m in self.mutable.items():
            if len(m) == 0:
                continue
            p = (
                Path(snap_root) / "index" / self.namespace / f"segment-{bs}.db"
            )
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_bytes(m.seal().to_bytes())
            written += 1
        return written

    def restore_snapshot(self, snap_root: str) -> int:
        """Install snapshot index segments as sealed segments (appended
        to any already-sealed block).  Restored segments are re-persisted
        under the MAIN root immediately: the covering snapshot (and the
        WAL that carried the tags) may be cleaned up before this block
        ever seals again, so the main index dir must be durable now."""
        d = Path(snap_root) / "index" / self.namespace
        if not d.exists():
            return 0
        n = 0
        for f in d.glob("segment-*.db"):
            bs = int(f.stem.split("-")[1])
            try:
                seg = SealedSegment.from_bytes(f.read_bytes())
            except (ValueError, struct.error) as e:
                # A rotted snapshot index segment must not abort
                # bootstrap: the data half replays through the WAL and
                # tagged entries re-index themselves (database.py
                # _replay_entries) — skip loudly, don't crash.
                _LOG.warning(
                    "skipping corrupt snapshot index segment %s: %s", f, e)
                continue
            self.sealed.setdefault(bs, []).append(seg)
            self._persist_block(bs)
            n += 1
        return n

    # -- query path --------------------------------------------------------

    def query(self, q: Query, start_nanos: int, end_nanos: int,
              inc_docs=None) -> list[Document]:
        """Matching documents across all live segments of blocks
        overlapping [start, end); deduped by series ID, tombstones
        filtered.

        `inc_docs(n)` is called as matches accumulate (per segment) so a
        per-query docs limit can abort the match mid-way instead of
        after the full result materializes (reference storage/limits
        increments during matching)."""
        out: dict[bytes, Document] = {}
        for bs in sorted(set(self.mutable) | set(self.sealed)):
            if bs + self.block_size <= start_nanos or bs >= end_nanos:
                continue
            tombs = self.tombstones.get(bs, ())
            segs = list(self.sealed.get(bs, ()))
            if bs in self.mutable:
                m = self.mutable[bs]
                memo = self._mutable_view.get(bs)
                if memo is None or memo[0] != m.generation:
                    memo = (m.generation, m.seal())
                    self._mutable_view[bs] = memo
                segs.append(memo[1])
            for seg in segs:
                before = len(out)
                for did in execute_segment(seg, q, self.device):
                    doc = seg.doc(int(did))
                    if doc.id not in tombs:
                        out.setdefault(doc.id, doc)
                if inc_docs is not None:
                    inc_docs(len(out) - before)
        return list(out.values())
