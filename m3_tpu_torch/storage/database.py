"""The TSDB engine: database → namespace → shard (→ device buffers).
The counterpart of ``m3_tpu/storage/database.py``.

Structural equivalent of the reference's storage hierarchy
(`src/dbnode/storage/database.go:739 db.Write`, `namespace.go:698`,
`shard.go:867-1008 writeAndIndex`, read `shard.go:1079 ReadEncoded`,
flush orchestration `mediator.go:284 ongoingTick` + `flush.go`), with the
TPU-shaped substitutions:

* per-series encoder objects → one per-shard device append-log ring
  (`storage/buffer.py`) + batched M3TSZ encode at seal time;
* the lock-free series map + insert queue → a host `SlotAllocator`;
* warm flush → `DataFileSetWriter.write_all` of batch-encoded streams;
* cold writes → host overflow lists flushed as higher fileset volumes
  (reference `coldflush.go` + `fs/merger.go`: we merge the existing
  volume's streams with the cold points and write volume+1);
* commit log → WAL appends per ingest batch before buffering.

Reads serve from sealed filesets (scalar/batched decode) merged with the
open in-memory window — the same two-source merge the reference does with
`series buffer streams` + `block retriever` (`shard.go:1079`).

``device=None`` means CUDA (raises without one); the ``Database`` passes
its device to every shard's buffer, to the index's bitset executor and to
the flush's batched encoder.  ``instrument=`` takes a scope of the port's
registry (``m3_tpu_torch.instrument``) and keeps the reference's
counters and histograms under ``db``.  The block-level replication
surface (``list_block_filesets``, ``block_metadata``, ``read_block``,
``write_block``) that repair, peers bootstrap and the shard migrator run
against moves host bytes only: fileset segments are read and written as
the reference writes them.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from pathlib import Path

from typing import Dict, Iterable, List, Sequence

import numpy as np

from m3_tpu_torch import resolve_device
from m3_tpu_torch.core.hash import shard_for as hash_shard_for
from m3_tpu_torch.core.slots import SlotAllocator
from m3_tpu_torch.index.doc import Document, decode_tags, encode_tags
from m3_tpu_torch.index.namespace_index import NamespaceIndex
from m3_tpu_torch.index.search import Query
from m3_tpu_torch.encoding.m3tsz import decode_series, encode_series
from m3_tpu_torch.encoding.m3tsz_torch import encode_batch
from m3_tpu_torch.persist.commitlog import (
    CommitLogEntry, CommitLogWriter, commitlog_seq, list_commitlogs,
    read_commitlog,
)
from m3_tpu_torch.persist import capacity as cap
from m3_tpu_torch.persist.corruption import CorruptionError
from m3_tpu_torch.persist.fs import (
    DataFileSetReader, DataFileSetWriter, list_fileset_volumes, list_filesets,
    remove_fileset,
)
from m3_tpu_torch.persist import quarantine as quar
from m3_tpu_torch.persist import snapshot as snap
from m3_tpu_torch.instrument import logger
from m3_tpu_torch.instrument.tracing import NOOP_TRACER, Tracepoint
from m3_tpu_torch.storage.limits import NO_LIMITS, NewSeriesLimiter, QueryLimits
from m3_tpu_torch.storage.block_cache import BlockCache
from m3_tpu_torch.storage.buffer import ShardBuffer, dedupe_last_write_wins
from m3_tpu_torch.storage.series_merge import merge_point_sources

_LOG = logger("storage.database")


@dataclasses.dataclass(frozen=True)
class NamespaceOptions:
    """Retention/block options (reference `src/dbnode/namespace/options.go`:
    RetentionOptions blockSize/retentionPeriod/bufferPast/bufferFuture)."""

    block_size_nanos: int = 2 * 3600 * 10**9
    retention_nanos: int = 48 * 3600 * 10**9
    buffer_past_nanos: int = 10 * 60 * 10**9
    buffer_future_nanos: int = 2 * 60 * 10**9
    cold_writes_enabled: bool = True
    num_shards: int = 4
    slot_capacity: int = 1 << 17
    sample_capacity: int = 1 << 18


@dataclasses.dataclass(frozen=True)
class DatabaseOptions:
    root: str = "m3tpu_data"
    commitlog_enabled: bool = True
    # Active-segment size bound: the WAL rotates once a segment crosses
    # this many bytes, so cleanup can reclaim fully-flushed segments on
    # nodes whose snapshot cadence (the only other thing that rotates it) is
    # long.  0 = rotate only on snapshot (the pre-round-20 behavior).
    commitlog_rotate_bytes: int = 64 << 20
    # 0 = unlimited; live-tunable via the write_new_series_limit_per_sec
    # runtime option (reference dbnode/kvconfig/keys.go).
    write_new_series_limit_per_sec: float = 0.0


class ShardNotOwnedError(RuntimeError):
    """A write or read addressed a shard this node does not own under
    the current placement (reference dbnode's per-shard state check in
    `storage/shard.go` — writes to a shard the topology moved away are
    errors, not silent drops).  Wire-mapped by server/rpc.py so a
    remote caller gets the SAME typed error; the replicated session
    counts it as a per-replica routing miss (stale placement) and
    refreshes its topology, never as a data error."""

    def __init__(self, namespace: str | None, shard: int | None):
        super().__init__(
            f"shard {shard} not owned by this node (namespace {namespace!r})"
        )
        self.namespace = namespace
        self.shard = shard


class WriteResult(int):
    """Cold-write count (plain int for back-compat) carrying the typed
    ingest-rejection info: ``rejected`` = samples dropped because their
    series creation exceeded the new-series rate limit; ``accepted`` =
    per-input-sample bool mask (None when nothing was rejected —
    everything landed)."""

    rejected: int
    accepted = None
    # Samples dropped because their shard is not owned under the
    # current placement (mixed direct-ingest batches only — an
    # ALL-unowned batch raises ShardNotOwnedError instead, which is
    # what the per-shard session fan-out sees).
    not_owned: int

    def __new__(cls, ncold: int, rejected: int = 0, not_owned: int = 0):
        obj = super().__new__(cls, ncold)
        obj.rejected = rejected
        obj.not_owned = not_owned
        return obj


def shard_for_id(sid: bytes, num_shards: int) -> int:
    """murmur3(id) % N, bit-for-bit the reference's router
    (`sharding/shardset.go:148-163`).

    NOTE: data directories written before the crc32→murmur3 switch route
    differently and are not readable by this build (no deployed data
    exists; there is no migration path by design).
    """
    return hash_shard_for(sid, num_shards)


class Shard:
    def __init__(self, namespace: str, shard_id: int, opts: NamespaceOptions, root: str,
                 block_cache=None, new_series_limiter=None, corruption_cb=None,
                 device=None):
        self.namespace = namespace
        self.device = resolve_device(device)
        self.shard_id = shard_id
        self.opts = opts
        self.root = root
        self.block_cache = block_cache
        # Called (namespace, shard, block_start, volume, err) after a
        # corrupt volume is quarantined — the Database's counter/log hook.
        self._corruption_cb = corruption_cb
        self.slots = SlotAllocator(opts.slot_capacity,
                                   limiter=new_series_limiter)
        self.new_series_rejected = 0
        # Ring must cover (bufferPast + bufferFuture) / blockSize + 2 blocks.
        span = opts.buffer_past_nanos + opts.buffer_future_nanos
        num_windows = max(2, span // opts.block_size_nanos + 2)
        self.buffer = ShardBuffer(
            opts.block_size_nanos, int(num_windows), opts.sample_capacity,
            opts.slot_capacity, self.device,
        )
        self.flushed_blocks: set[int] = set()
        for bs, _vol in list_filesets(root, namespace, shard_id):
            self.flushed_blocks.add(bs)

    # -- write path --------------------------------------------------------

    def open_starts(self, now_nanos: int) -> set[int]:
        """Block starts accepting warm writes at `now` (reference
        buffer.go:311-398: [now-bufferPast, now+bufferFuture])."""
        bsz = self.opts.block_size_nanos
        lo = (now_nanos - self.opts.buffer_past_nanos) // bsz * bsz
        hi = (now_nanos + self.opts.buffer_future_nanos) // bsz * bsz
        return {bs for bs in range(lo, hi + bsz, bsz) if bs not in self.flushed_blocks}

    def write_batch(self, ids: Sequence[bytes], ts: np.ndarray, vals: np.ndarray,
                    now_nanos: int) -> int:
        slots = self.slots.resolve(ids)
        rejected = slots < 0
        nrej = 0
        if rejected.any():
            # New-series rate limit hit: drop ONLY the rejected
            # creations (existing series in the batch still land) and
            # count them — graceful degradation under churn, never
            # unbounded state growth (dbnode/kvconfig/keys.go
            # write-new-series limits).
            nrej = int(rejected.sum())
            self.new_series_rejected += nrej
            keep = ~rejected
            slots, ts, vals = slots[keep], ts[keep], vals[keep]
        ncold = self.buffer.write(slots, ts, vals, self.open_starts(now_nanos))
        res = WriteResult(ncold, nrej)
        res.accepted = ~rejected
        return res

    # -- flush path --------------------------------------------------------

    def _encode_runs(self, slots: np.ndarray, ts: np.ndarray, vals: np.ndarray,
                     block_start: int) -> list[tuple[bytes, bytes]]:
        """(sorted, deduped) flat runs -> [(id, m3tsz stream)] via the
        batched device encoder; fallback series use the scalar oracle.

        The JAX package sizes each stream for ~40 bits a point and sends
        the series that overflow it (raw doubles take ~70 bits a point on
        the XOR path) to the scalar encoder.  The port sizes the output
        to the longest stream (``fit_words``), so only what the batched
        encoder cannot express falls back; the bytes are the same either
        way (the batched encoder is byte-identical to the scalar one)."""
        if len(slots) == 0:
            return []
        uniq, starts_idx, counts = np.unique(slots, return_index=True, return_counts=True)
        S, T = len(uniq), int(counts.max())
        tmat = np.zeros((S, T), np.int64)
        vmat = np.zeros((S, T), np.float64)
        for r, (i0, c) in enumerate(zip(starts_idx, counts)):
            tmat[r, :c] = ts[i0 : i0 + c]
            vmat[r, :c] = vals[i0 : i0 + c]
            if c < T:  # pad with the last sample (ignored via counts)
                tmat[r, c:] = tmat[r, c - 1]
                vmat[r, c:] = vmat[r, c - 1]
        starts = np.full(S, block_start, np.int64)
        streams, fallback = encode_batch(
            tmat, vmat, starts, counts=counts, fit_words=True, device=self.device,
        )
        out = []
        for r, slot in enumerate(uniq):
            sid = self.slots.id_of(int(slot))
            if sid is None:
                continue
            if fallback[r]:
                pts = list(zip(tmat[r, : counts[r]].tolist(), vmat[r, : counts[r]].tolist()))
                stream = encode_series(pts, start=block_start)
            else:
                stream = streams[r]
            out.append((sid, stream))
        return out

    def warm_flush(self, block_start: int) -> int:
        """Seal + persist one block (reference buffer.go:634 WarmFlush →
        persist_manager flush).  Returns series flushed.

        The window clears only AFTER the volume is durably on disk
        (peek → write → discard): a DiskCapacityError mid-write leaves
        every sample buffered and readable, and the next tick retries
        the flush against whatever space the cleanup freed."""
        slots, ts, vals = self.buffer.peek(block_start)
        series = self._encode_runs(slots, ts, vals, block_start)
        DataFileSetWriter(
            self.root, self.namespace, self.shard_id, block_start,
            self.opts.block_size_nanos, volume=0,
        ).write_all(series)
        self.buffer.discard(block_start)
        self.flushed_blocks.add(block_start)
        return len(series)

    def cold_flush(self, skip_open: frozenset = frozenset()) -> int:
        """Merge cold overflow writes with the existing volume and write
        volume+1 (reference coldflush.go + fs/merger.go).

        ``skip_open`` holds block starts still inside the warm window:
        their overflow entries are writes that arrived beyond
        bufferFuture and whose block has since opened.  Flushing them
        before the block seals would race the later warm flush for
        volume numbering, so they wait for that block's seal, readable
        from the overflow lists meanwhile, and the cold flush that
        follows it merges them."""
        flushed = 0
        for block_start in sorted(self.buffer.cold.keys()):
            if block_start in skip_open:
                continue
            slots, ts, vals = self.buffer.peek_cold(block_start)
            if len(slots) == 0:
                self.buffer.discard_cold(block_start)
                continue
            vol = -1
            for bs, v in list_filesets(self.root, self.namespace, self.shard_id):
                if bs == block_start:
                    vol = v

            # Merge from the highest INTACT volume (corrupt ones are
            # quarantined and the next-lower tried); the rewrite still
            # lands at max_vol+1 so volume numbering stays monotonic
            # across a quarantine.
            def _decode_volume(merge_vol):
                r = DataFileSetReader(
                    self.root, self.namespace, self.shard_id,
                    block_start, merge_vol
                )
                return {
                    sid: {d.timestamp: d.value for d in decode_series(seg)}
                    for sid, seg in r.read_all()
                }

            merged: Dict[bytes, Dict[int, float]] = (
                self._fold_intact_volumes(block_start, _decode_volume) or {}
            )
            for slot, t, v in zip(slots, ts, vals):
                sid = self.slots.id_of(int(slot))
                if sid is None:
                    continue
                merged.setdefault(sid, {})[int(t)] = float(v)
            series = []
            for sid, pts in merged.items():
                items = sorted(pts.items())
                series.append((sid, encode_series(items, start=block_start)))
            DataFileSetWriter(
                self.root, self.namespace, self.shard_id, block_start,
                self.opts.block_size_nanos, volume=vol + 1,
            ).write_all(series)
            # staged overflow clears only once volume+1 is on disk —
            # same no-loss-on-ENOSPC ordering as warm_flush
            self.buffer.discard_cold(block_start)
            self.flushed_blocks.add(block_start)
            if self.block_cache is not None:
                # volume+1 supersedes the cached volume's blocks
                self.block_cache.invalidate_block(
                    self.namespace, self.shard_id, block_start
                )
            flushed += len(series)
        return flushed

    def snapshot_blocks(self, snap_root: str) -> int:
        """Persist every un-flushed block (open warm window + pending cold
        overflow) as a snapshot fileset under `snap_root` without touching
        the live buffers (reference buffer.go:537 Snapshot).  Returns
        series-blocks written."""
        written = 0
        for bs in sorted(set(self.buffer.open_blocks) | set(self.buffer.cold)):
            slots, ts, vals = self.buffer.peek(bs)
            parts = self.buffer.cold.get(bs, ())
            if len(parts):
                slots = np.concatenate([slots] + [p[0] for p in parts]).astype(np.int32)
                ts = np.concatenate([ts] + [p[1] for p in parts]).astype(np.int64)
                vals = np.concatenate([vals] + [p[2] for p in parts]).astype(np.float64)
                slots, ts, vals = dedupe_last_write_wins(slots, ts, vals)
            if len(slots) == 0:
                continue
            series = self._encode_runs(slots, ts, vals, bs)
            DataFileSetWriter(
                snap_root, self.namespace, self.shard_id, bs,
                self.opts.block_size_nanos, volume=0,
            ).write_all(series)
            written += len(series)
        return written

    # -- corruption handling ----------------------------------------------

    def quarantine_volume(self, block_start: int, volume: int, err) -> None:
        """Pull one corrupt fileset volume out of the live tree
        (persist/quarantine), drop its cached readers/blocks, and — when
        no intact volume remains for the block — un-mark it flushed so
        buffers/replay may serve it again (the corrupt volume is now
        *missing*, not half-readable)."""
        qdir = quar.quarantine_fileset(self.root, self.namespace,
                                       self.shard_id, block_start, volume, err)
        if self.block_cache is not None:
            self.block_cache.invalidate_block(
                self.namespace, self.shard_id, block_start
            )
        if not any(bs == block_start for bs, _ in list_filesets(
                self.root, self.namespace, self.shard_id)):
            self.flushed_blocks.discard(block_start)
        _LOG.warning(
            "quarantined corrupt fileset ns=%s shard=%d block=%d vol=%d: %s",
            self.namespace, self.shard_id, block_start, volume, err,
        )
        if self._corruption_cb is not None:
            self._corruption_cb(self.namespace, self.shard_id, block_start,
                                volume, err, quarantined=qdir is not None)

    def _fold_intact_volumes(self, block_start: int, consume):
        """Apply ``consume(volume)`` to the block's volumes, highest
        first, returning the first result that reads clean.  A corrupt
        volume is quarantined and the next-lower one tried; a missing
        one (raced cleanup/quarantine) is skipped.  ``consume`` must
        build any partial state fresh per call — a mid-read
        CorruptionError discards that attempt wholesale.  This is the
        ONE place the quarantine-and-fall-back contract lives (read
        path, cold-flush merge, and WAL-replay dedupe all fold through
        it)."""
        vols = sorted(
            (v for bs, v in list_fileset_volumes(
                self.root, self.namespace, self.shard_id)
             if bs == block_start),
            reverse=True,
        )
        for vol in vols:
            try:
                return consume(vol)
            except FileNotFoundError:
                continue
            except CorruptionError as e:
                self.quarantine_volume(block_start, vol, e)
                continue
        return None

    def _read_fileset_series(self, block_start: int, sid: bytes,
                             volume: int | None = None):
        """Points for ``sid`` from the highest INTACT volume of a block,
        or None.  A corrupt volume is quarantined and the next-lower
        volume tried — corruption degrades this one source (buffers and
        replicas still answer), it never fails the read (the reference's
        checksum-verify-and-skip read path, persist/fs/read.go +
        repair.go's expected-corruption contract).

        ``volume`` is the caller's already-known latest volume: the hot
        path reads it directly (no extra directory glob); only a
        corrupt/vanished volume falls back to enumerating what remains
        on disk."""
        def consume(vol):
            if self.block_cache is not None:
                return self.block_cache.read_series(
                    self.root, self.namespace, self.shard_id,
                    block_start, vol, sid,
                )
            r = DataFileSetReader(
                self.root, self.namespace, self.shard_id, block_start, vol
            )
            seg = r.read(sid)
            return ([(d.timestamp, d.value) for d in decode_series(seg)]
                    if seg else None)

        if volume is not None:
            try:
                return consume(volume)
            except FileNotFoundError:
                pass
            except CorruptionError as e:
                self.quarantine_volume(block_start, volume, e)
            # quarantined/vanished: whatever remains on disk, if anything
        return self._fold_intact_volumes(block_start, consume)

    # -- read path ---------------------------------------------------------

    def read_sources(
        self, sid: bytes, start_nanos: int, end_nanos: int
    ) -> list[list[tuple[int, float]]]:
        """Every source holding points for this series over the range,
        ordered oldest-precedence-first for the merge seam
        (series_merge.merge_point_sources): sealed fileset volume, open
        warm buffer, pending cold overflow.  This is the seam the
        reference builds from MultiReaderIterator + buffer streams
        (`shard.go:1079` ReadEncoded gathering disk + memory streams)."""
        bsz = self.opts.block_size_nanos
        slot = self.slots.get(sid)
        lo = start_nanos // bsz * bsz
        filesets = dict(list_filesets(self.root, self.namespace, self.shard_id))
        sources: list[list[tuple[int, float]]] = []
        for bs in range(lo, end_nanos + bsz, bsz):
            if bs in filesets:
                pts = self._read_fileset_series(bs, sid, volume=filesets[bs])
                if pts:
                    sources.append(pts)
            if slot is not None and bs in self.buffer.open_blocks:
                ts, vals = self.buffer.read_window(bs, slot)
                sources.append(list(zip(ts.tolist(), vals.tolist())))
            if slot is not None and bs in self.buffer.cold:
                # Cold writes awaiting flush are readable immediately
                # (the reference reads cold buckets too — versioned
                # buckets in buffer.go:1016 serve un-flushed cold data).
                pts: list[tuple[int, float]] = []
                for cslots, cts, cvals in self.buffer.cold[bs]:
                    m = cslots == slot
                    pts.extend(zip(cts[m].tolist(), cvals[m].tolist()))
                sources.append(pts)
        return sources

    def read(self, sid: bytes, start_nanos: int, end_nanos: int) -> list[tuple[int, float]]:
        merged = merge_point_sources(
            self.read_sources(sid, start_nanos, end_nanos)
        )
        return [(t, v) for t, v in merged if start_nanos <= t < end_nanos]

    def read_many(self, sids: Sequence[bytes], start_nanos: int,
                  end_nanos: int) -> list[list[tuple[int, float]]]:
        """Batched :meth:`read`: one result list per requested id, same
        merge/range contract as the single-id path.  The win is
        amortization — per BLOCK this pays one sorted-window snapshot
        (buffer.read_window_many) and one cold-overflow sort instead of
        per-id O(window) work, which is what makes verifying a
        million-series soak ledger (and serving batched fetches under
        load) feasible.  Fileset sources stay per-id: the block cache
        already amortizes the disk read across ids."""
        bsz = self.opts.block_size_nanos
        lo = start_nanos // bsz * bsz
        filesets = dict(list_filesets(self.root, self.namespace, self.shard_id))
        slots = np.asarray(
            [s if (s := self.slots.get(sid)) is not None else -1
             for sid in sids], np.int64)
        sources_per: list[list] = [[] for _ in sids]
        for bs in range(lo, end_nanos + bsz, bsz):
            if bs in filesets:
                vol = filesets[bs]
                for i, sid in enumerate(sids):
                    pts = self._read_fileset_series(bs, sid, volume=vol)
                    if pts:
                        sources_per[i].append(pts)
            if bs in self.buffer.open_blocks:
                for i, (wts, wvals) in enumerate(
                        self.buffer.read_window_many(bs, slots)):
                    if len(wts):
                        sources_per[i].append(
                            list(zip(wts.tolist(), wvals.tolist())))
            if bs in self.buffer.cold:
                parts = self.buffer.cold[bs]
                cslots = np.concatenate([p[0] for p in parts]).astype(np.int64)
                cts = np.concatenate([p[1] for p in parts])
                cvals = np.concatenate([p[2] for p in parts])
                # arrival-stable sort by slot so per-id extraction is a
                # binary search, with arrival order (the cold merge
                # rule's tie-break input) preserved within each slot
                order = np.argsort(cslots, kind="stable")
                cslots, cts, cvals = cslots[order], cts[order], cvals[order]
                los = np.searchsorted(cslots, slots)
                his = np.searchsorted(cslots, slots + 1)
                for i, (slo, shi) in enumerate(zip(los.tolist(), his.tolist())):
                    if shi > slo and slots[i] >= 0:
                        sources_per[i].append(
                            list(zip(cts[slo:shi].tolist(),
                                     cvals[slo:shi].tolist())))
        return [
            [(t, v) for t, v in merge_point_sources(srcs)
             if start_nanos <= t < end_nanos]
            for srcs in sources_per
        ]


class Namespace:
    def __init__(self, name: str, opts: NamespaceOptions, root: str,
                 block_cache=None, new_series_limiter=None,
                 corruption_cb=None, device=None):
        self.name = name
        self.device = resolve_device(device)
        self.opts = opts
        self.root = root
        self.shards = [
            Shard(name, i, opts, root, block_cache,
                  new_series_limiter=new_series_limiter,
                  corruption_cb=corruption_cb, device=self.device)
            for i in range(opts.num_shards)
        ]
        # Placement-driven ownership: None = own every shard (the
        # single-node / no-placement default, bit-compatible with the
        # pre-topology behavior); a set restricts writes AND reads to
        # exactly those shards — everything else raises the typed
        # ShardNotOwnedError (reference dbnode shard state gating).
        self.owned: frozenset | None = None
        self.index = NamespaceIndex(opts.block_size_nanos, root, name,
                                    device=self.device)

    def check_owned(self, shard: int) -> None:
        if self.owned is not None and shard not in self.owned:
            raise ShardNotOwnedError(self.name, shard)

    def write_tagged_batch(self, docs: Sequence[Document], ts: np.ndarray,
                           vals: np.ndarray, now_nanos: int) -> int:
        """Write + index tagged series (reference WriteTagged
        `database.go:771` → shard writeAndIndex → nsIndex.WriteBatch).
        The index only learns documents whose series were ACCEPTED —
        rate-limited churn must not grow the reverse index either (that
        is the unbounded-memory failure the limit exists to stop)."""
        res = self.write_batch([d.id for d in docs], ts, vals, now_nanos)
        if res.accepted is None:
            self.index.write_batch(list(docs), ts)
        else:
            acc = res.accepted
            kept = [d for d, a in zip(docs, acc) if a]
            if kept:
                self.index.write_batch(kept, ts[acc])
        return res

    def query_ids(self, q: Query, start: int, end: int,
                  inc_docs=None) -> list[Document]:
        """Index query → matching series documents (reference db.QueryIDs
        → nsIndex.Query `storage/index.go:1483`)."""
        return self.index.query(q, start, end, inc_docs=inc_docs)

    def write_batch(self, ids: Sequence[bytes], ts: np.ndarray, vals: np.ndarray,
                    now_nanos: int) -> int:
        by_shard: Dict[int, List[int]] = {}
        for i, sid in enumerate(ids):
            by_shard.setdefault(shard_for_id(sid, self.opts.num_shards), []).append(i)
        # Ownership gate BEFORE any shard buffers a sample.  An
        # ALL-unowned batch rejects atomically with the typed error —
        # the session fans single-shard sub-batches, so that maps to
        # one routing miss.  A MIXED direct-ingest batch (carbon/HTTP
        # front doors hash one flush across many shards) must NOT lose
        # its owned samples to one stray id: owned shards land, the
        # unowned remainder is dropped into the accepted mask like a
        # limiter rejection (counted as ``not_owned``; never
        # WAL-logged, never indexed).
        owned_set = self.owned
        unowned = ([] if owned_set is None
                   else sorted(sh for sh in by_shard if sh not in owned_set))
        if unowned and len(unowned) == len(by_shard):
            raise ShardNotOwnedError(self.name, unowned[0])
        ncold = nrej = ndropped = 0
        full = np.ones(len(ids), bool)
        for sh, idxs in by_shard.items():
            sel = np.asarray(idxs)
            if owned_set is not None and sh not in owned_set:
                full[sel] = False
                ndropped += len(idxs)
                continue
            res = self.shards[sh].write_batch(
                [ids[i] for i in idxs], ts[sel], vals[sel], now_nanos
            )
            ncold += int(res)
            nrej += res.rejected
            if res.accepted is not None:
                full[sel] = res.accepted
        out = WriteResult(ncold, nrej, ndropped)
        if nrej or ndropped:
            out.accepted = full
        return out

    @property
    def new_series_rejected(self) -> int:
        return sum(sh.new_series_rejected for sh in self.shards)

    def read(self, sid: bytes, start: int, end: int) -> list[tuple[int, float]]:
        shard = shard_for_id(sid, self.opts.num_shards)
        self.check_owned(shard)
        return self.shards[shard].read(sid, start, end)

    def read_many(self, sids: Sequence[bytes], start: int,
                  end: int) -> list[list[tuple[int, float]]]:
        """Batched read: group by shard, amortize the per-window sort
        (Shard.read_many), return point lists aligned with ``sids``.
        The ownership gate is per SHARD and atomic like write_batch's
        all-unowned case: any unowned shard in the batch raises typed
        (the session fans single-shard sub-batches, so this maps to one
        routing miss, never a partially-silent read)."""
        by_shard: Dict[int, List[int]] = {}
        for i, sid in enumerate(sids):
            by_shard.setdefault(shard_for_id(sid, self.opts.num_shards),
                                []).append(i)
        for sh in by_shard:
            self.check_owned(sh)
        out: list = [None] * len(sids)
        for sh, idxs in by_shard.items():
            for i, pts in zip(idxs, self.shards[sh].read_many(
                    [sids[i] for i in idxs], start, end)):
                out[i] = pts
        return out

    def tick(self, now_nanos: int) -> dict:
        """Seal + warm-flush every open block that has left the warm
        window (mediator.go tick → flush), then cold-flush overflow."""
        stats = {"warm_flushed": 0, "cold_flushed": 0, "index_sealed": 0}
        sealed_blocks: set[int] = set()
        for shard in self.shards:
            open_now = shard.open_starts(now_nanos)
            for bs in sorted(set(shard.buffer.open_blocks) - open_now):
                stats["warm_flushed"] += shard.warm_flush(bs)
                sealed_blocks.add(bs)
            if self.opts.cold_writes_enabled:
                stats["cold_flushed"] += shard.cold_flush(
                    skip_open=frozenset(open_now))
        # Index blocks seal alongside their data blocks (reference index
        # flush rides the same mediator file-system pass, mediator.go:318).
        for bs in sorted(sealed_blocks):
            if self.index.seal_block(bs) is not None:
                stats["index_sealed"] += 1
        # Background segment compaction: bound per-block segment counts
        # under churn (reference multi_segments_builder compaction).
        stats["index_compactions"] = self.index.compact()
        return stats


class Database:
    """Top-level engine (reference storage/database.go db struct;
    `Write` :739, `ReadEncoded` via namespaces, `Bootstrap` :1199)."""

    def __init__(self, opts: DatabaseOptions | None = None,
                 namespaces: Dict[str, NamespaceOptions] | None = None,
                 instrument=None, tracer=None, limits: QueryLimits | None = None,
                 new_series_limiter: NewSeriesLimiter | None = None,
                 device=None):
        self.opts = opts or DatabaseOptions()
        self._scope = instrument.scope("db") if instrument is not None else None
        # flush/snapshot latency: windowed mergeable histograms (the
        # /health ``latency`` section), interned once — these paths run
        # per mediator tick and must not pay a registry intern each time
        self._hist_tick = (self._scope.histogram("tick_seconds")
                           if self._scope is not None else None)
        self._hist_snapshot = (self._scope.histogram("snapshot_seconds")
                               if self._scope is not None else None)
        # per-batch ingest latency at the storage boundary (every front
        # door; WAL replay excluded by construction)
        self._hist_write = (self._scope.histogram("write_batch_seconds")
                            if self._scope is not None else None)
        self.device = resolve_device(device)
        self.tracer = tracer if tracer is not None else NOOP_TRACER
        self.limits = limits if limits is not None else NO_LIMITS
        # One engine-wide reentrant lock serializing state mutation:
        # ingest batches, the tick/snapshot/cleanup thread, bootstrap,
        # and reads that walk buffer state.  Every operation is already
        # a whole-batch array program, so one coarse lock adds no
        # meaningful serialization beyond what the batched design has.
        self._mu = threading.RLock()
        Path(self.opts.root).mkdir(parents=True, exist_ok=True)
        self.block_cache = BlockCache(instrument=instrument)
        # Engine-wide new-series rate limiter shared by every shard's
        # allocator (0 = unlimited).
        self.new_series_limiter = (
            new_series_limiter if new_series_limiter is not None
            else NewSeriesLimiter(self.opts.write_new_series_limit_per_sec))
        self.namespaces: Dict[str, Namespace] = {}
        for name, nopts in (namespaces or {"default": NamespaceOptions()}).items():
            self.namespaces[name] = Namespace(
                name, nopts, self.opts.root, self.block_cache,
                new_series_limiter=self.new_series_limiter,
                corruption_cb=self._note_corruption, device=self.device,
            )
        self.commitlog = (
            CommitLogWriter(
                self.opts.root,
                rotate_bytes=self.opts.commitlog_rotate_bytes,
                # fsync wall time on the db scope: a stalling disk is
                # SLO-visible long before it is full
                fsync_histogram=(
                    self._scope.histogram("commitlog_fsync_seconds")
                    if self._scope is not None else None),
            ) if self.opts.commitlog_enabled else None
        )
        self.corruption_detected = 0
        self.corruption_quarantined = 0
        # a leaf lock for the two counters alone: shards report from any
        # thread, and the hook must never wait on _mu
        self._corruption_lock = threading.Lock()
        # (num_shards, owned) the topology watcher last installed:
        # inherited by namespaces created later (see ensure_namespace).
        self._ownership_template: tuple | None = None
        self.bootstrapped = False

    def _note_corruption(self, namespace: str, shard: int, block_start: int,
                         volume: int, err, quarantined: bool = True) -> None:
        """Hook every shard's quarantine path reports through (also the
        ``corruption_*`` series on a node's /metrics): ``detected``
        counts every corruption event; ``quarantined`` only those where
        files were actually moved (a volume whose files vanished before
        the move detects without quarantining)."""
        with self._corruption_lock:
            self.corruption_detected += 1
            if quarantined:
                self.corruption_quarantined += 1
        if self._scope is not None:
            self._scope.counter("corruption_detected").inc()
            if quarantined:
                self._scope.counter("corruption_quarantined").inc()

    def quarantine_inventory(self) -> list:
        """Reason dicts of everything under <root>/quarantine/."""
        return quar.list_quarantined(self.opts.root)

    def quarantine_fileset_volume(self, namespace: str, shard: int,
                                  block_start: int, volume: int,
                                  err=None) -> None:
        """Engine-locked quarantine of one fileset volume (the
        scrubber's entry point — flushed-block bookkeeping must not
        race ingest/tick)."""
        with self._mu:
            self.namespaces[namespace].shards[shard].quarantine_volume(
                block_start, volume, err
            )

    # ---- placement-driven shard ownership -------------------------------

    def set_ownership_template(self, num_shards: int,
                               owned: Iterable[int] | None) -> None:
        """Ownership applied to namespaces created AFTER the placement
        was observed (dynamic namespace add, downsampler
        ensure_namespace): a new namespace sharing the placement's
        shard space must start placement-scoped, not own-all — without
        this it would silently bypass the ownership invariant until the
        next placement version bump."""
        with self._mu:
            self._ownership_template = (
                int(num_shards), None if owned is None else frozenset(owned))

    def set_shard_ownership(self, namespace: str | None,
                            owned: Iterable[int] | None) -> None:
        """Install the placement-derived shard set this node serves
        (None = own everything, the no-placement default).  Applies to
        one namespace, or to every namespace when ``namespace`` is None
        (the topology watcher's shape: one placement governs the node).
        Takes effect atomically under the engine lock — a mid-batch
        ingest either wholly precedes or wholly follows the swap."""
        with self._mu:
            targets = (self.namespaces.values() if namespace is None
                       else [self.namespaces[namespace]])
            for ns in targets:
                ns.owned = None if owned is None else frozenset(owned)

    def owned_shards(self, namespace: str) -> frozenset | None:
        ns = self.namespaces[namespace]
        return ns.owned

    def drop_shard(self, namespace: str, shard_id: int) -> int:
        """Discard one shard's local state: every fileset volume on
        disk, the in-memory buffers/slots, and cached blocks — the
        post-cutover cleanup of a LEAVING shard (reference dbnode
        closes and deletes shards the topology moved away).  Returns
        the number of fileset volumes removed.  The caller (migrator)
        is responsible for grace: by the time this runs, ownership has
        already been revoked and clients re-routed."""
        with self._mu:
            ns = self.namespaces[namespace]
            removed = 0
            for bs, vol in list_fileset_volumes(self.opts.root, namespace,
                                                shard_id):
                remove_fileset(self.opts.root, namespace, shard_id, bs, vol)
                self.block_cache.invalidate_block(namespace, shard_id, bs)
                removed += 1
            # A fresh Shard starts empty (the fileset scan above left
            # nothing) — buffers, slots and flushed-block bookkeeping
            # all reset in one swap; its ring is allocated on the
            # namespace's device.
            ns.shards[shard_id] = Shard(
                namespace, shard_id, ns.opts, self.opts.root,
                self.block_cache,
                new_series_limiter=self.new_series_limiter,
                corruption_cb=self._note_corruption, device=ns.device,
            )
            _LOG.info("dropped shard ns=%s shard=%d (%d fileset volumes)",
                      namespace, shard_id, removed)
            if self._scope is not None:
                self._scope.counter("shards_dropped").inc()
            return removed

    def ensure_namespace(self, name: str,
                         opts: NamespaceOptions | None = None) -> Namespace:
        """Create-if-missing (the reference adds namespaces dynamically
        through KV-watched namespace metadata, dbnode/namespace/dynamic.go;
        the coordinator provisions aggregated namespaces per policy).  A
        new namespace takes this database's device, new-series limiter and
        corruption hook."""
        with self._mu:
            ns = self.namespaces.get(name)
            if ns is None:
                ns = self.namespaces[name] = Namespace(
                    name, opts or NamespaceOptions(), self.opts.root,
                    self.block_cache,
                    new_series_limiter=self.new_series_limiter,
                    corruption_cb=self._note_corruption, device=self.device,
                )
                tpl = self._ownership_template
                if tpl is not None and tpl[0] == ns.opts.num_shards:
                    ns.owned = tpl[1]  # placement-scoped from birth
            return ns

    def write_batch(self, namespace: str, ids: Sequence[bytes], ts, vals,
                    now_nanos: int | None = None) -> int:
        ns = self.namespaces[namespace]
        ts = np.asarray(ts, np.int64)
        vals = np.asarray(vals, np.float64)
        if now_nanos is None:
            now_nanos = int(ts.max())
        t0 = time.perf_counter()
        with self._mu, self.tracer.start_span(
            Tracepoint.DB_WRITE_BATCH, {"n": len(ids), "ns": namespace}
        ):
            if self._scope is not None:
                self._scope.counter("writes").inc(len(ids))
            res = self._counted(lambda: ns.write_batch(ids, ts, vals,
                                                       now_nanos))
            # Log AFTER acceptance so the WAL never contains
            # rate-limit-rejected samples (the reference writes the
            # commitlog after the in-memory write succeeds, as an async
            # enqueue - commit_log.go:716).  Bootstrap replay then
            # re-admits exactly the accepted set, bypassing the limiter.
            if self.commitlog is not None:
                if res.accepted is None:
                    self.commitlog.write_batch(list(ids), ts, vals,
                                               namespace=namespace.encode())
                else:
                    acc = res.accepted
                    self.commitlog.write_batch(
                        [sid for sid, a in zip(ids, acc) if a],
                        ts[acc], vals[acc], namespace=namespace.encode())
            if self._hist_write is not None:
                self._hist_write.record(time.perf_counter() - t0)
            return res

    def _counted(self, write):
        """Run one namespace write, counting its not-owned and rejected
        samples on the db scope (the reference's counters)."""
        try:
            res = write()
        except ShardNotOwnedError:
            if self._scope is not None:
                self._scope.counter("shard_not_owned").inc()
            raise
        if self._scope is not None and getattr(res, "not_owned", 0):
            self._scope.counter("shard_not_owned").inc(res.not_owned)
        if self._scope is not None and res.rejected:
            self._scope.counter("new_series_rejected").inc(res.rejected)
        return res

    def write_tagged_batch(self, namespace: str, docs: Sequence[Document], ts, vals,
                           now_nanos: int | None = None) -> int:
        ns = self.namespaces[namespace]
        ts = np.asarray(ts, np.int64)
        vals = np.asarray(vals, np.float64)
        if now_nanos is None:
            now_nanos = int(ts.max())
        t0 = time.perf_counter()
        with self._mu, self.tracer.start_span(
            Tracepoint.DB_WRITE_BATCH, {"n": len(docs), "ns": namespace,
                                        "tagged": True}
        ):
            if self._scope is not None:
                self._scope.counter("writes_tagged").inc(len(docs))
            res = self._counted(lambda: ns.write_tagged_batch(
                docs, ts, vals, now_nanos))
            if self.commitlog is not None:
                # Tags ride the annotation field so WAL replay can rebuild
                # index documents (the reference's commitlog entries carry
                # the series metadata for the same reason).  Only the
                # ACCEPTED samples are logged - see write_batch.
                if res.accepted is None:
                    kept = list(docs)
                    kts, kvs = ts, vals
                else:
                    kept = [d for d, a in zip(docs, res.accepted) if a]
                    kts, kvs = ts[res.accepted], vals[res.accepted]
                if kept:
                    self.commitlog.write_batch(
                        [d.id for d in kept], kts, kvs,
                        namespace=namespace.encode(),
                        annotations=[encode_tags(d) for d in kept],
                    )
            if self._hist_write is not None:
                self._hist_write.record(time.perf_counter() - t0)
            return res

    def query_ids(self, namespace: str, q: Query, start: int, end: int):
        with self._mu, self.tracer.start_span(
            Tracepoint.DB_QUERY_IDS, {"ns": namespace}
        ):
            # windowed per-query limit, incremented DURING matching so a
            # heavy query aborts mid-match (reference storage/limits)
            return self.namespaces[namespace].query_ids(
                q, start, end, inc_docs=self.limits.inc_docs
            )

    def read(self, namespace: str, sid: bytes, start: int, end: int):
        if self._scope is not None:
            self._scope.counter("reads").inc()
        self.limits.inc_series(1)
        # bytes pre-check: an already-exhausted window rejects the read
        # BEFORE decoding; the exact size still accounts afterwards (it
        # is unknowable until decoded).
        self.limits.inc_bytes(0)
        with self._mu, self.tracer.start_span(Tracepoint.DB_READ):
            pts = self.namespaces[namespace].read(sid, start, end)
        # 16 bytes per (ts, value) sample — the bytes-read accounting unit
        self.limits.inc_bytes(16 * len(pts))
        return pts

    def read_batch(self, namespace: str, sids: Sequence[bytes],
                   start: int, end: int) -> list[list[tuple[int, float]]]:
        """Batched :meth:`read` (one engine-lock acquisition, one
        sorted-window snapshot per open block instead of per id).  Same
        limits accounting units as the single-id path."""
        if self._scope is not None:
            self._scope.counter("reads").inc(len(sids))
        self.limits.inc_series(len(sids))
        self.limits.inc_bytes(0)
        with self._mu, self.tracer.start_span(
                Tracepoint.DB_READ, {"n": len(sids)}):
            out = self.namespaces[namespace].read_many(sids, start, end)
        self.limits.inc_bytes(16 * sum(len(p) for p in out))
        return out

    def tick(self, now_nanos: int) -> dict:
        t0 = time.perf_counter()
        with self._mu, self.tracer.start_span(Tracepoint.DB_TICK):
            stats = {name: ns.tick(now_nanos)
                     for name, ns in self.namespaces.items()}
        if self._hist_tick is not None:
            self._hist_tick.record(time.perf_counter() - t0)
        return stats

    # ---- block-level replication surface -------------------------------
    # The handle interface repair and peers bootstrap run against; the
    # socket RPC (server/rpc.py) exports exactly these four methods so a
    # replica works the same whether it is this object or a remote node
    # (reference FetchBlocksMetadataRawV2 `node/service.go:1529` + the
    # peer block streaming in `client/peer.go`).  Segments cross as host
    # bytes: nothing here touches the device.

    def list_block_filesets(self, namespace: str, shard: int):
        """[(block_start, latest volume)] flushed for the shard."""
        return sorted(list_filesets(self.opts.root, namespace, shard))

    def block_metadata(self, namespace: str, shard: int, block_start: int):
        """Per-series stream checksums for one flushed block, or None
        when no fileset exists for it.

        Served from the fileset's index entries alone (the writer stores
        adler32-of-segment per entry), never touching the data file —
        the metadata-only property of the reference's
        FetchBlocksMetadataRawV2."""
        filesets = dict(list_filesets(self.opts.root, namespace, shard))
        if block_start not in filesets:
            return None
        r = DataFileSetReader(
            self.opts.root, namespace, shard, block_start, filesets[block_start]
        )
        return {e.id: e.checksum for e in r.entries()}

    def read_block(self, namespace: str, shard: int, block_start: int):
        """All (series id, encoded stream) pairs of one flushed block;
        [] when the block has no fileset."""
        filesets = dict(list_filesets(self.opts.root, namespace, shard))
        if block_start not in filesets:
            return []
        r = DataFileSetReader(
            self.opts.root, namespace, shard, block_start, filesets[block_start]
        )
        return list(r.read_all())

    def write_block(self, namespace: str, shard: int, block_start: int,
                    series) -> None:
        """Persist a full block's series as the next fileset volume and
        mark it flushed (repair rewrite / peers-bootstrap load)."""
        with self._mu:
            ns = self.namespaces[namespace]
            # A non-owner must not accept streamed blocks: repair
            # writing a merged block at a decommissioned replica would
            # resurrect data the topology moved away (callers treat
            # this like any per-replica failure and skip the replica).
            ns.check_owned(shard)
            filesets = dict(list_filesets(self.opts.root, namespace, shard))
            vol = filesets.get(block_start, -1) + 1
            DataFileSetWriter(
                self.opts.root, namespace, shard, block_start,
                ns.opts.block_size_nanos, volume=vol,
            ).write_all(sorted(series))
            ns.shards[shard].flushed_blocks.add(block_start)

    def snapshot(self) -> dict:
        """Capture every namespace's un-flushed buffers as snapshot
        filesets (reference mediator.go:318 runFileSystemProcesses →
        buffer.Snapshot; metadata commit gates visibility).  The commit
        log rotates first so the snapshot covers everything in the
        now-inactive logs — recovery then replays only seq >= the active
        log (`snapshot_metadata_write.go` commitlog-identifier role)."""
        t0 = time.perf_counter()
        with self._mu, self.tracer.start_span(Tracepoint.DB_SNAPSHOT):
            seq = snap.next_snapshot_seq(self.opts.root)
            if self.commitlog is not None:
                self.commitlog.rotate()
                cl_seq = self.commitlog.seq
            else:
                cl_seq = 0
            snap_root = str(snap.snapshot_data_root(self.opts.root, seq))
            written = 0
            index_segs = 0
            for ns in self.namespaces.values():
                for shard in ns.shards:
                    written += shard.snapshot_blocks(snap_root)
                index_segs += ns.index.snapshot_mutable(snap_root)
            snap.commit_snapshot(self.opts.root, seq, cl_seq)
        if self._hist_snapshot is not None:
            self._hist_snapshot.record(time.perf_counter() - t0)
        return {"seq": seq, "series_blocks": written, "index_segments": index_segs}

    def cleanup(self, now_nanos: int) -> dict:
        """Expired-data cleanup (reference `storage/cleanup.go`):
        out-of-retention fileset volumes, superseded (non-max) volumes,
        all-but-latest snapshots, and commitlogs fully covered by the
        latest snapshot."""
        stats = {"filesets": 0, "snapshots": 0, "commitlogs": 0}
        with self._mu:
            return self._cleanup_locked(now_nanos, stats)

    def _cleanup_locked(self, now_nanos: int, stats: dict) -> dict:
        for ns in self.namespaces.values():
            cutoff = now_nanos - ns.opts.retention_nanos - ns.opts.block_size_nanos
            for shard in ns.shards:
                vols = list_fileset_volumes(self.opts.root, ns.name, shard.shard_id)
                max_vol = {}
                for bs, vol in vols:
                    max_vol[bs] = max(max_vol.get(bs, -1), vol)
                for bs, vol in vols:
                    if bs <= cutoff or vol < max_vol[bs]:
                        remove_fileset(self.opts.root, ns.name, shard.shard_id, bs, vol)
                        self.block_cache.invalidate_block(
                            ns.name, shard.shard_id, bs
                        )
                        stats["filesets"] += 1
                        if bs <= cutoff:
                            shard.flushed_blocks.discard(bs)
        # Quarantine entries age out WITH their data's retention: once
        # the block is out of retention everywhere, the evidence (and
        # the scrubber's repair worklist entry) has nothing left to
        # heal toward — without this the inventory and /health payload
        # grow forever.
        import shutil as _shutil

        max_keep = max(
            (ns.opts.retention_nanos + ns.opts.block_size_nanos
             for ns in self.namespaces.values()),
            default=48 * 3600 * 10**9,
        )
        for entry in quar.list_quarantined(self.opts.root):
            ns = self.namespaces.get(entry.get("namespace"))
            bs = entry.get("block_start")
            if ns is not None and isinstance(bs, int):
                expired = (bs <= now_nanos - ns.opts.retention_nanos
                           - ns.opts.block_size_nanos)
            else:
                # No retention anchor (quarantined snapshots, dropped
                # namespaces, unreadable reasons): age out on the
                # wall-clock quarantine time against the longest
                # retention any namespace keeps.
                qa = entry.get("quarantined_at")
                expired = (isinstance(qa, (int, float))
                           and qa * 1e9 <= now_nanos - max_keep)
            if expired:
                _shutil.rmtree(entry["dir"], ignore_errors=True)
                stats["quarantine_reaped"] = stats.get("quarantine_reaped", 0) + 1
        stats["snapshots"] = snap.prune_snapshots(self.opts.root, keep=1)
        latest = snap.latest_snapshot(self.opts.root)
        for log in list_commitlogs(self.opts.root):
            if self.commitlog is not None and log == self.commitlog.path:
                continue
            if latest is not None and commitlog_seq(log) < latest.commitlog_seq:
                log.unlink(missing_ok=True)
                stats["commitlogs"] += 1
            elif self._commitlog_fully_flushed(log):
                # Size-rotated segments (rotate_bytes) are not covered
                # by any snapshot, so without this check they live to
                # retention — a segment every entry of which is durable
                # in a checkpointed fileset protects nothing.
                log.unlink(missing_ok=True)
                stats["commitlogs"] += 1
        return stats

    def _commitlog_fully_flushed(self, log) -> bool:
        """True iff EVERY entry in the (inactive) segment is durable in
        a checkpointed fileset: its block is flushed and nothing for
        that block is still pending in the warm/cold buffers.  Entries
        for unknown namespaces or unflushed blocks keep the segment
        (conservative — replay may still need it)."""
        try:
            for e in read_commitlog(log):
                ns = self.namespaces.get(e.namespace.decode())
                if ns is None:
                    return False
                shard = ns.shards[
                    shard_for_id(e.series_id, ns.opts.num_shards)]
                bs = (e.timestamp // ns.opts.block_size_nanos
                      * ns.opts.block_size_nanos)
                if bs not in shard.flushed_blocks:
                    return False
                if (bs in shard.buffer.open_blocks
                        or bs in shard.buffer.cold):
                    return False
        except OSError:
            return False
        return True

    def _replay_entries(self, name: str, entries: list,
                        flushed_pts: Dict[tuple, dict] | None = None) -> int:
        """Write recovered entries into a namespace's buffers, skipping
        blocks already covered by a checkpointed fileset (the fs
        bootstrapper's unfulfilled-ranges rule).  Entries whose
        annotation carries encoded tags re-index their document too, so
        recovery rebuilds the (unsealed) reverse index.  Never re-logs."""
        ns = self.namespaces.get(name)
        if ns is None:
            return 0
        if ns.owned is not None:
            # Placement-scoped recovery: WAL/snapshot entries for shards
            # this node no longer owns are NOT re-buffered (a restarting
            # ex-donor must not resurrect handed-off shards; the new
            # owner already streamed or re-ingested them).
            entries = [
                e for e in entries
                if shard_for_id(e.series_id, ns.opts.num_shards) in ns.owned
            ]
            if not entries:
                return 0
        ts = np.asarray([e.timestamp for e in entries], np.int64)
        vals = np.asarray([e.value for e in entries], np.float64)
        ids = [e.series_id for e in entries]
        keep = np.ones(len(ts), bool)
        # Lazy cache of fileset contents for flushed blocks touched by
        # recovery: a point already in the fileset is a duplicate (drop);
        # a point absent from it is a pending cold write that crashed
        # before cold_flush — keep it, and write_batch re-routes it cold
        # because the flushed block is not in open_starts.  The caller
        # (bootstrap) shares one cache across all logs so each fileset
        # decodes once, not once per commitlog file.
        if flushed_pts is None:
            flushed_pts = {}
        for i, sid in enumerate(ids):
            shard_id = shard_for_id(sid, ns.opts.num_shards)
            sh = ns.shards[shard_id]
            bs = int(ts[i]) // ns.opts.block_size_nanos * ns.opts.block_size_nanos
            if bs not in sh.flushed_blocks:
                continue
            key = (name, shard_id, bs)
            if key not in flushed_pts:
                # Decode the highest INTACT volume; a corrupt one is
                # quarantined and a lower volume tried.  When nothing
                # intact remains the dedupe set is empty, so every WAL
                # entry for the block is KEPT and re-buffered — replay
                # re-covers exactly the data the corrupt fileset lost.
                def _decode_timestamps(vol, _bs=bs, _shard=shard_id):
                    r = DataFileSetReader(
                        self.opts.root, ns.name, _shard, _bs, vol
                    )
                    return {
                        fsid: {d.timestamp for d in decode_series(seg)}
                        for fsid, seg in r.read_all()
                    }

                flushed_pts[key] = (
                    sh._fold_intact_volumes(bs, _decode_timestamps) or {}
                )
            if int(ts[i]) in flushed_pts[key].get(sid, ()):
                keep[i] = False
        if not keep.any():
            return 0
        kept = np.nonzero(keep)[0]
        now = int(ts.max())
        tagged_idx = []
        tagged_docs = []
        for i in kept:
            ann = entries[i].annotation
            doc = decode_tags(ids[i], ann) if ann else None
            if doc is not None:
                tagged_idx.append(i)
                tagged_docs.append(doc)
        if tagged_docs:
            sel = np.asarray(tagged_idx)
            ns.write_tagged_batch(tagged_docs, ts[sel], vals[sel], now)
        tagged_set = set(tagged_idx)
        plain = [i for i in kept if i not in tagged_set]
        if plain:
            sel = np.asarray(plain)
            ns.write_batch([ids[i] for i in plain], ts[sel], vals[sel], now)
        return len(kept)

    def bootstrap(self) -> dict:
        """fs → snapshot → commitlog bootstrap chain (reference
        `storage/bootstrap/process.go` + bootstrapper/README.md: filesets
        first, then the latest snapshot, then WAL-tail replay for whatever
        isn't covered — `bootstrapper/commitlog` reads snapshots + WAL)."""
        with self._mu, self.tracer.start_span(Tracepoint.DB_BOOTSTRAP):
            # Replay re-admits previously-ACCEPTED series: the limiter
            # gates foreground churn only (the WAL never contains
            # rejected samples - see write_batch's log-after-accept).
            with self.new_series_limiter.bypass():
                return self._bootstrap_locked()

    def _bootstrap_locked(self) -> dict:
        # Torn-write sweep FIRST: a crash (or classified ENOSPC whose
        # unlink itself failed) between temp-write and rename leaves a
        # dead ``*.tmp*`` beside the real artifact — invisible to every
        # reader but holding disk the ledger would count forever.
        swept = cap.sweep_temp_files(self.opts.root)
        if swept:
            _LOG.info("bootstrap: swept %d torn temp file(s)", len(swept))
        restored = 0
        flushed_pts: Dict[tuple, dict] = {}  # shared fileset-decode cache
        latest = snap.latest_snapshot(self.opts.root)
        if latest is not None:
            snap_root = str(snap.snapshot_data_root(self.opts.root, latest.seq))
            for name, ns in self.namespaces.items():
                ns.index.restore_snapshot(snap_root)
                for shard in ns.shards:
                    entries: list[CommitLogEntry] = []
                    for bs, vol in list_filesets(snap_root, name, shard.shard_id):
                        try:
                            r = DataFileSetReader(
                                snap_root, name, shard.shard_id, bs, vol
                            )
                            for sid, seg in r.read_all():
                                entries.extend(
                                    CommitLogEntry(sid, d.timestamp, d.value,
                                                   namespace=name.encode())
                                    for d in decode_series(seg)
                                )
                        except CorruptionError as e:
                            # A rotted snapshot fileset must not abort
                            # node start: quarantine it (under the DB
                            # root) and keep whatever decoded cleanly —
                            # replicas/repair re-converge the remainder.
                            qdir = quar.quarantine_fileset(
                                snap_root, name, shard.shard_id, bs, vol, e,
                                qroot=self.opts.root,
                                label=f"snapshot-{latest.seq}",
                            )
                            _LOG.warning(
                                "quarantined corrupt snapshot fileset "
                                "seq=%d ns=%s shard=%d block=%d vol=%d: %s",
                                latest.seq, name, shard.shard_id, bs, vol, e,
                            )
                            self._note_corruption(
                                name, shard.shard_id, bs, vol, e,
                                quarantined=qdir is not None)
                    if entries:
                        restored += self._replay_entries(name, entries, flushed_pts)
        replayed = 0
        min_seq = latest.commitlog_seq if latest is not None else -1
        for log in list_commitlogs(self.opts.root):
            if self.commitlog is not None and log == self.commitlog.path:
                continue
            if commitlog_seq(log) < min_seq:
                continue  # fully covered by the snapshot
            per_ns: Dict[str, list] = {}
            for e in read_commitlog(log):
                per_ns.setdefault(e.namespace.decode(), []).append(e)
            for name, entries in per_ns.items():
                replayed += self._replay_entries(name, entries, flushed_pts)
        self.bootstrapped = True
        return {"commitlog_replayed": replayed, "snapshot_restored": restored,
                "temp_files_swept": len(swept)}

    def close(self) -> None:
        with self._mu:
            if self.commitlog is not None:
                self.commitlog.close()
