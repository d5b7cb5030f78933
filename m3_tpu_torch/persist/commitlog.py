"""Commit log: the write-ahead log for crash recovery.

Equivalent of the reference's async batched WAL
(`src/dbnode/persist/fs/commitlog/commit_log.go:716 Write / :733
WriteBatch`, chunked writer with size+checksum headers `writer.go:43-52`,
fsync policy, reader/iterator for bootstrap `iterator.go`).  Differences
by design: entries are struct-framed binary (not msgpack — SURVEY.md §7
"what deliberately does NOT carry over"), and batching is explicit (the
ingest path is already batched arrays, so the WAL appends whole batches,
not per-sample enqueues).

Chunk layout:  [payload_len u32][payload_adler u32][header_adler u32]
               [payload]
Entry layout within a payload: repeated
  [ns_len u8][ns][id_len u16][id][timestamp i64][value f64][unit u8]
  [annot_len u16][annot]

A torn final chunk (crash mid-write) fails its checksum and is dropped by
the reader, truncating recovery to the last complete chunk — the same
guarantee the reference's chunked writer provides.

The port's copy of ``m3_tpu/persist/commitlog.py`` (it imports nothing of ``m3_tpu``).
"""

from __future__ import annotations

import os
import struct
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import numpy as np

from m3_tpu_torch.persist.capacity import capacity_guard, inject
from m3_tpu_torch.persist.corruption import ChecksumMismatch, FormatCorruption
from m3_tpu_torch.persist.digest import digest
from m3_tpu_torch.x import fault

_CHUNK_HDR = struct.Struct("<III")


@dataclass(frozen=True)
class CommitLogEntry:
    series_id: bytes
    timestamp: int
    value: float
    unit: int = 0
    annotation: bytes = b""
    namespace: bytes = b"default"


class FsyncPolicy:
    NEVER = "never"
    EVERY_WRITE = "every_write"
    INTERVAL = "interval"


class CommitLogWriter:
    """Appends batches as checksummed chunks; rotate() starts a new file
    (the reference rotates on block boundaries for cleanup —
    commit_log.go NotifyOpts/rotation)."""

    def __init__(self, root, fsync: str = FsyncPolicy.INTERVAL,
                 fsync_interval_s: float = 1.0, rotate_bytes: int = 0,
                 fsync_histogram=None):
        self.dir = Path(root) / "commitlogs"
        self.dir.mkdir(parents=True, exist_ok=True)
        self.fsync = fsync
        self.fsync_interval_s = fsync_interval_s
        # Size-based rotation bound (0 = only rotate on demand, the
        # pre-existing behavior).  Without it a node whose snapshot
        # cadence is long appends to ONE segment forever, and cleanup
        # can never reclaim WAL space — the growth bound that makes
        # commitlog bytes reclaimable under disk pressure.
        self.rotate_bytes = rotate_bytes
        # Optional instrument.Histogram: fsync wall time.  A stalling
        # disk shows up here long before ENOSPC does, and the histogram
        # is windowed so an SLO rule over it reflects *current* device
        # behavior.
        self._fsync_hist = fsync_histogram
        self._last_fsync = 0.0
        self._active_bytes = 0
        self._f = None
        self._seq = self._next_seq()
        self.rotate()

    def _next_seq(self) -> int:
        seqs = [int(p.stem.split("-")[1]) for p in self.dir.glob("commitlog-*.db")]
        return max(seqs, default=-1) + 1

    @property
    def seq(self) -> int:
        """Sequence number of the ACTIVE log file."""
        return self._seq

    @property
    def path(self) -> Path:
        return self.dir / f"commitlog-{self._seq}.db"

    def rotate(self) -> Path | None:
        """Close the active log and open the next one; returns the path
        of the ROTATED-OUT file (None on first open)."""
        old = None
        if self._f:
            old = self.path
            # through the commitlog.flush faultpoint (m3lint
            # fault-coverage): a rotation fsync is as injectable a
            # boundary as a write fsync
            self._flush_fsync()
            self._f.close()
            self._seq += 1
        with capacity_guard(path=self.path, component="commitlog", op="open"):
            self._f = open(self.path, "ab")
        self._active_bytes = self.path.stat().st_size
        return old

    def write_batch(self, ids: list[bytes], timestamps: np.ndarray,
                    values: np.ndarray, unit: int = 0,
                    annotations: list[bytes] | None = None,
                    namespace: bytes = b"default") -> None:
        parts = []
        for i, sid in enumerate(ids):
            ann = annotations[i] if annotations else b""
            parts.append(struct.pack("<B", len(namespace)))
            parts.append(namespace)
            parts.append(struct.pack("<H", len(sid)))
            parts.append(sid)
            parts.append(struct.pack("<qdB", int(timestamps[i]), float(values[i]), unit))
            parts.append(struct.pack("<H", len(ann)))
            parts.append(ann)
        payload = b"".join(parts)
        pd = digest(payload)
        hdr_body = struct.pack("<II", len(payload), pd)
        chunk = hdr_body + struct.pack("<I", digest(hdr_body)) + payload
        with capacity_guard(path=self.path, component="commitlog", op="write"):
            inject("commitlog.write")
            self._f.write(chunk)
        self._active_bytes += len(chunk)
        if self.rotate_bytes and self._active_bytes >= self.rotate_bytes:
            # Rotate AFTER the append so the chunk that crossed the
            # bound is fsynced by rotate()'s flush — the new segment
            # starts empty and the old one is immediately eligible for
            # reclaim once its entries are flushed to filesets.
            self.rotate()
        elif self.fsync == FsyncPolicy.EVERY_WRITE:
            self._flush_fsync()
        elif self.fsync == FsyncPolicy.INTERVAL:
            now = time.monotonic()
            if now - self._last_fsync >= self.fsync_interval_s:
                self._flush_fsync()
                self._last_fsync = now

    def _flush_fsync(self) -> None:
        """Disk-boundary faultpoint ``commitlog.flush``: delay models a
        slow device, error a failing one, and drop SKIPS the fsync —
        the durability hole a later SIGKILL turns into a torn tail the
        reader's checksum contract must absorb."""
        if fault.fire("commitlog.flush") == "drop":
            return
        t0 = time.monotonic()
        with capacity_guard(path=self.path, component="commitlog", op="fsync"):
            self._f.flush()
            os.fsync(self._f.fileno())
        if self._fsync_hist is not None:
            self._fsync_hist.record(time.monotonic() - t0)

    def close(self) -> None:
        if self._f:
            self._flush_fsync()
            self._f.close()
            self._f = None


def read_commitlog(path, strict: bool = False) -> Iterator[CommitLogEntry]:
    """Yields entries from one log file; stops (without raising) at the
    first torn/corrupt chunk — the crash-recovery contract.

    Streams CHUNK BY CHUNK: replay memory is bounded by the largest
    chunk (one ingest batch), not the log size — the reference's WAL
    reader is an iterator over the chunked writer's frames for the same
    reason (`persist/fs/commitlog/reader.go`).  The truncation contract
    is bit-for-bit the old whole-file reader's: a chunk is yielded only
    when its header digest AND payload digest verify, and the first
    failure ends iteration.

    ``strict=True`` (integrity tooling, never recovery) raises a typed
    :class:`CorruptionError` at the failure instead of truncating, so a
    scrub can distinguish "clean end" from "torn tail".
    """
    path = Path(path)
    with open(path, "rb") as f:
        while True:
            hdr = f.read(_CHUNK_HDR.size)
            if len(hdr) < _CHUNK_HDR.size:
                if hdr and strict:
                    raise FormatCorruption(
                        "torn chunk header", path=path,
                        component="commitlog", check="chunk-header-torn")
                return
            plen, pdig, hdig = _CHUNK_HDR.unpack(hdr)
            if digest(hdr[:8]) != hdig:
                if strict:
                    raise ChecksumMismatch(
                        "chunk header checksum mismatch", path=path,
                        component="commitlog", check="chunk-header")
                return
            payload = f.read(plen)
            if len(payload) < plen or digest(payload) != pdig:
                if strict:
                    raise ChecksumMismatch(
                        "chunk payload checksum mismatch", path=path,
                        component="commitlog", check="chunk-payload")
                return
            epos = 0
            while epos < plen:
                (nslen,) = struct.unpack_from("<B", payload, epos)
                epos += 1
                ns = payload[epos : epos + nslen]
                epos += nslen
                (idlen,) = struct.unpack_from("<H", payload, epos)
                epos += 2
                sid = payload[epos : epos + idlen]
                epos += idlen
                ts, val, unit = struct.unpack_from("<qdB", payload, epos)
                epos += 17
                (alen,) = struct.unpack_from("<H", payload, epos)
                epos += 2
                ann = payload[epos : epos + alen]
                epos += alen
                yield CommitLogEntry(sid, ts, val, unit, ann, ns)


def commitlog_seq(path) -> int:
    """Sequence number encoded in a commitlog filename."""
    return int(Path(path).stem.split("-")[1])


def list_commitlogs(root) -> list[Path]:
    d = Path(root) / "commitlogs"
    if not d.exists():
        return []
    return sorted(d.glob("commitlog-*.db"), key=commitlog_seq)
