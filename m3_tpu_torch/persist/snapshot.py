"""Snapshots: periodic durable captures of the in-memory buffer.

Equivalent of the reference's snapshot filesets + snapshot metadata files
(`src/dbnode/storage/series/buffer.go:537 Snapshot`,
`src/dbnode/persist/fs/snapshot_metadata_write.go` /
`snapshot_metadata_read.go`): the mediator periodically persists every
open (unsealed) block window so that crash recovery replays only the
commitlog *tail* written after the snapshot, not the whole WAL.

Layout under <root>/snapshots/:

    <seq>/data/<namespace>/<shard>/fileset-...   ordinary filesets
                                                 (same writer/reader as
                                                 persist/fs — the stream
                                                 bytes are exact M3TSZ)
    meta-<seq>.db                                metadata, written LAST

The metadata file carries (seq, commitlog_seq) and is checksummed; its
presence gates the snapshot's visibility exactly like a fileset's
checkpoint file (crash mid-snapshot leaves no meta → invisible, the
previous snapshot remains authoritative).  `commitlog_seq` is the
sequence number of the commitlog file that was ACTIVE when the snapshot
began — recovery = load snapshot + replay logs with seq >= commitlog_seq
(duplicates resolve in the buffer's last-write-wins dedupe).

The port's copy of ``m3_tpu/persist/snapshot.py`` (it imports nothing of ``m3_tpu``).
"""

from __future__ import annotations

import os
import shutil
import struct
from dataclasses import dataclass
from pathlib import Path

from m3_tpu_torch.persist.capacity import capacity_guard
from m3_tpu_torch.persist.corruption import ChecksumMismatch, FormatCorruption
from m3_tpu_torch.persist.digest import digest

_META_MAGIC = b"M3TS"
# record layout: magic (4) + seq u64 + commitlog_seq i64 + adler32-of-first-20


def snapshots_root(root) -> Path:
    return Path(root) / "snapshots"


def snapshot_data_root(root, seq: int) -> Path:
    """Root passed to DataFileSetWriter/Reader for snapshot `seq`."""
    return snapshots_root(root) / str(seq)


@dataclass(frozen=True)
class SnapshotMetadata:
    seq: int
    commitlog_seq: int

    def to_bytes(self) -> bytes:
        body = _META_MAGIC + struct.pack("<Qq", self.seq, self.commitlog_seq)
        return body + struct.pack("<I", digest(body))

    @classmethod
    def from_bytes(cls, b: bytes, path=None) -> "SnapshotMetadata":
        if len(b) != 24 or b[:4] != _META_MAGIC:
            raise FormatCorruption("bad snapshot metadata", path=path,
                                   component="snapshot.meta",
                                   check="meta-magic")
        seq, clseq = struct.unpack_from("<Qq", b, 4)
        (csum,) = struct.unpack_from("<I", b, 20)
        if digest(b[:20]) != csum:
            raise ChecksumMismatch("snapshot metadata checksum mismatch",
                                   path=path, component="snapshot.meta",
                                   check="meta-checksum")
        return cls(seq, clseq)


def meta_path(root, seq: int) -> Path:
    return snapshots_root(root) / f"meta-{seq}.db"


def next_snapshot_seq(root) -> int:
    d = snapshots_root(root)
    if not d.exists():
        return 0
    seqs = [int(p.stem.split("-")[1]) for p in d.glob("meta-*.db")]
    for p in d.iterdir():  # incomplete (meta-less) dirs still hold the seq
        if p.is_dir() and p.name.isdigit():
            seqs.append(int(p.name))
    return max(seqs, default=-1) + 1


def commit_snapshot(root, seq: int, commitlog_seq: int) -> None:
    """Write the metadata file — the snapshot's atomic commit point."""
    d = snapshots_root(root)
    d.mkdir(parents=True, exist_ok=True)
    final = meta_path(root, seq)
    tmp = final.with_suffix(".tmp")
    # fsync before the rename (the meta gates the whole snapshot's
    # visibility — a published-but-unsynced meta would be a torn commit
    # point after power loss), and classify ENOSPC on the way.
    with capacity_guard(path=final, component="snapshot", op="write",
                        cleanup=(tmp,)):
        with open(tmp, "wb") as f:
            f.write(SnapshotMetadata(seq, commitlog_seq).to_bytes())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)


def list_snapshots(root) -> list[SnapshotMetadata]:
    """Complete (committed) snapshots, oldest first; corrupt metas are
    skipped like checkpoint-less filesets."""
    d = snapshots_root(root)
    if not d.exists():
        return []
    out = []
    for p in sorted(d.glob("meta-*.db"), key=lambda p: int(p.stem.split("-")[1])):
        try:
            out.append(SnapshotMetadata.from_bytes(p.read_bytes(), path=p))
        except ValueError:  # CorruptionError — cleanup reaps it
            continue
    return out


def latest_snapshot(root) -> SnapshotMetadata | None:
    snaps = list_snapshots(root)
    return snaps[-1] if snaps else None


def remove_snapshot(root, seq: int) -> None:
    """Delete one snapshot (meta first so it can never be half-visible)."""
    meta_path(root, seq).unlink(missing_ok=True)
    shutil.rmtree(snapshot_data_root(root, seq), ignore_errors=True)


def prune_snapshots(root, keep: int = 1) -> int:
    """Remove all but the newest `keep` complete snapshots plus any
    uncommitted snapshot directories (crash leftovers) and any snapshot
    whose metadata file is CORRUPT — ``latest_snapshot`` skips those,
    so without this sweep the meta file (and its data dir) would leak
    on disk forever.  Returns count removed (reference cleanup.go
    snapshot/metadata cleanup)."""
    removed = 0
    d = snapshots_root(root)
    if d.exists():
        for p in d.glob("meta-*.db"):
            seq_s = p.stem.split("-")[1]
            try:
                raw = p.read_bytes()
            except OSError:
                # Unreadable ≠ corrupt: a transient EIO/race here must
                # NOT delete a snapshot whose read would succeed next
                # pass (its covering commitlogs may already be gone).
                continue
            try:
                SnapshotMetadata.from_bytes(raw, path=p)
            except ValueError as e:  # CorruptionError: verifiably rotten
                if seq_s.isdigit():
                    # Quarantine, don't destroy: the meta is rotten but
                    # the data filesets may be fully intact — at rf=1
                    # they can be the only copy of what the snapshot
                    # covered (the WAL it superseded is already reaped).
                    from m3_tpu_torch.persist.quarantine import quarantine_snapshot

                    quarantine_snapshot(root, int(seq_s), e)
                else:
                    p.unlink(missing_ok=True)
                removed += 1
    snaps = list_snapshots(root)
    for m in snaps[:-keep] if keep else snaps:
        remove_snapshot(root, m.seq)
        removed += 1
    if d.exists():
        live = {m.seq for m in list_snapshots(root)}
        for p in d.iterdir():
            if p.is_dir() and p.name.isdigit() and int(p.name) not in live:
                shutil.rmtree(p, ignore_errors=True)
                removed += 1
    return removed
