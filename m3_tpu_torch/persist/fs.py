"""Immutable fileset I/O: the durable form of a sealed block.

Structural equivalent of the reference's per-(shard, blockStart, volume)
fileset (`src/dbnode/persist/fs/files.go:618-624`, writer
`write.go`/`types.go:87-102 WriteAll`, reader `read.go`, binary-search
index `index_lookup.go`): an **info** file (block metadata), a **data**
file of concatenated compressed segments, an **index** file of per-series
entries sorted by ID, a **summaries** file sampling every Nth index entry,
a **bloom** filter file, a **digest** file of adler32s, and a
**checkpoint** file written last whose presence gates fileset visibility
(crash mid-flush leaves no checkpoint → the fileset is invisible and
re-flushed, the reference's atomicity story).

The byte framing is this framework's own (struct-packed little-endian, no
msgpack); the *stream bytes inside the data file are exact M3TSZ* so a
fileset round-trips the codec's golden contract.

The port's copy of ``m3_tpu/persist/fs.py`` (it imports nothing of ``m3_tpu``).
"""

from __future__ import annotations

import os
import struct
import threading
from bisect import bisect_right
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

from m3_tpu_torch.persist.bloom import BloomFilter
from m3_tpu_torch.persist.capacity import capacity_guard, inject
from m3_tpu_torch.persist.corruption import ChecksumMismatch, FormatCorruption
from m3_tpu_torch.persist.digest import digest, digest_file, pack_digest, unpack_digest
from m3_tpu_torch.x import fault

INFO_MAGIC = b"M3TI"
INDEX_MAGIC = b"M3TX"
# v2: summaries entries carry the index-file byte offset (was the entry
# ordinal, which nothing could seek with) — the reader's lookup ladder
# depends on it, so v1 filesets are rejected rather than mis-probed.
VERSION = 2
SUMMARY_EVERY = 64
INDEX_HEADER_LEN = 12  # INDEX_MAGIC + uint64 entry count

FILE_TYPES = ("info", "index", "data", "summaries", "bloom")


def fileset_dir(root, namespace: str, shard: int) -> Path:
    return Path(root) / "data" / namespace / str(shard)


def fileset_path(root, namespace: str, shard: int, block_start: int, volume: int, ftype: str) -> Path:
    return fileset_dir(root, namespace, shard) / (
        f"fileset-{block_start}-{volume}-{ftype}.db"
    )


@dataclass(frozen=True)
class FileSetInfo:
    block_start: int
    block_size: int
    volume: int
    num_series: int

    def to_bytes(self) -> bytes:
        return INFO_MAGIC + struct.pack(
            "<IqqIQ", VERSION, self.block_start, self.block_size, self.volume, self.num_series
        )

    @classmethod
    def from_bytes(cls, b: bytes, path=None) -> "FileSetInfo":
        if b[:4] != INFO_MAGIC:
            raise FormatCorruption("bad info magic", path=path,
                                   component="fileset", check="info-magic")
        try:
            ver, bs, bsz, vol, n = struct.unpack_from("<IqqIQ", b, 4)
        except struct.error as e:
            raise FormatCorruption(f"torn info file: {e}", path=path,
                                   component="fileset", check="info-torn")
        if ver != VERSION:
            raise FormatCorruption(f"unsupported fileset version {ver}",
                                   path=path, component="fileset",
                                   check="info-version")
        return cls(bs, bsz, vol, n)


@dataclass(frozen=True)
class IndexEntry:
    id: bytes
    offset: int
    length: int
    checksum: int  # adler32 of the data segment


def _write_atomic(path: Path, data: bytes) -> None:
    tmp = path.with_suffix(".tmp")
    # ENOSPC/EDQUOT here become typed DiskCapacityError and the temp
    # file is unlinked on the way out — a full disk never publishes a
    # half-written artifact and never litters beside the real one.
    with capacity_guard(path=path, component="fileset", op="write",
                        cleanup=(tmp,)):
        inject("fileset.write")
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)


class DataFileSetWriter:
    """Writes one complete fileset; `write_all` is all-or-nothing
    (reference DataFileSetWriter.WriteAll, persist/fs/types.go:87-102)."""

    def __init__(self, root, namespace: str, shard: int, block_start: int,
                 block_size: int, volume: int = 0):
        self.root = root
        self.namespace = namespace
        self.shard = shard
        self.block_start = block_start
        self.block_size = block_size
        self.volume = volume

    def write_all(self, series: list[tuple[bytes, bytes]]) -> None:
        """series: (id, m3tsz stream) pairs; empty streams are skipped."""
        series = sorted((s for s in series if s[1]), key=lambda kv: kv[0])
        d = fileset_dir(self.root, self.namespace, self.shard)
        d.mkdir(parents=True, exist_ok=True)
        p = lambda t: fileset_path(
            self.root, self.namespace, self.shard, self.block_start, self.volume, t
        )

        data_parts: list[bytes] = []
        index_parts: list[bytes] = [INDEX_MAGIC + struct.pack("<Q", len(series))]
        summary_parts: list[bytes] = []
        off = 0
        index_off = INDEX_HEADER_LEN
        for i, (sid, stream) in enumerate(series):
            entry = struct.pack("<I", len(sid)) + sid + struct.pack(
                "<QII", off, len(stream), digest(stream)
            )
            if i % SUMMARY_EVERY == 0:
                # Each summary carries the entry's BYTE OFFSET in the
                # index file, so the reader can seek straight to it and
                # scan at most SUMMARY_EVERY entries — the reference's
                # index_lookup.go ladder (open cost O(summaries)).
                summary_parts.append(
                    struct.pack("<I", len(sid)) + sid
                    + struct.pack("<Q", index_off)
                )
            index_parts.append(entry)
            data_parts.append(stream)
            off += len(stream)
            index_off += len(entry)

        bloom = BloomFilter.from_estimate(len(series))
        bloom.add_batch([sid for sid, _ in series])

        contents = {
            "info": FileSetInfo(
                self.block_start, self.block_size, self.volume, len(series)
            ).to_bytes(),
            "index": b"".join(index_parts),
            "data": b"".join(data_parts),
            "summaries": b"".join(summary_parts),
            "bloom": bloom.to_bytes(),
        }
        for t in FILE_TYPES:
            _write_atomic(p(t), contents[t])
        digests = b"".join(pack_digest(digest(contents[t])) for t in FILE_TYPES)
        _write_atomic(p("digest"), digests)
        # Checkpoint LAST: its digest-of-digests gates visibility.
        _write_atomic(p("checkpoint"), pack_digest(digest(digests)))


class DataFileSetReader:
    """Reader with the reference's lookup ladder: bloom filter →
    summaries (every ``SUMMARY_EVERY``-th id + its byte offset in the
    index file) → forward scan of at most ``SUMMARY_EVERY`` raw index
    entries → data segment + checksum verify (persist/fs/read.go,
    index_lookup.go, seek.go).

    The index is mmap'd and parsed LAZILY around the probe point: open
    cost is O(summaries) object work (the per-file adler32 verification
    still streams each file once, C-speed, no heap), and a long-lived
    reader holds no per-entry Python objects — at 100K+ series per
    (shard, block) the eager parse this replaces was exactly the cost
    the reference's summaries exist to avoid.  Data and index segments
    come from mmaps (`persist/fs/mmap_util.go` role): page-cache
    backed, stateless slices, so concurrent reads on a shared reader
    are safe without a lock."""

    def __init__(self, root, namespace: str, shard: int, block_start: int, volume: int):
        self.root = root
        self.namespace = namespace
        self.shard = shard
        self.block_start = block_start
        self.volume = volume
        p = lambda t: fileset_path(root, namespace, shard, block_start, volume, t)
        if not p("checkpoint").exists():
            raise FileNotFoundError(f"no checkpoint for {p('checkpoint')}")
        try:
            self._open_verified(p)
        except FileNotFoundError as e:
            # Deletion removes the checkpoint FIRST (remove_fileset /
            # quarantine_fileset), so checkpoint-present-but-file-
            # missing is genuine damage, not a cleanup race — type it
            # so scrub/read handlers quarantine instead of skipping.
            if p("checkpoint").exists():
                raise FormatCorruption(
                    f"fileset file missing with checkpoint present: "
                    f"{e.filename}", path=e.filename, component="fileset",
                    check="missing-file")
            raise  # checkpoint vanished since the check: a real race

    def _open_verified(self, p) -> None:
        digests_raw = p("digest").read_bytes()
        checkpoint_raw = p("checkpoint").read_bytes()
        if len(checkpoint_raw) < 4 or len(digests_raw) < 4 * len(FILE_TYPES):
            raise FormatCorruption(
                "torn checkpoint/digest file", path=p("checkpoint"),
                component="fileset", check="checkpoint-torn")
        if unpack_digest(checkpoint_raw) != digest(digests_raw):
            raise ChecksumMismatch(
                "checkpoint/digest mismatch", path=p("checkpoint"),
                component="fileset", check="checkpoint")
        for i, t in enumerate(FILE_TYPES):
            if digest_file(p(t)) != unpack_digest(digests_raw[i * 4 :]):
                raise ChecksumMismatch(
                    f"digest mismatch for {t} file", path=p(t),
                    component="fileset", check=f"digest:{t}")
        self.info = FileSetInfo.from_bytes(p("info").read_bytes(),
                                           path=p("info"))
        self._data_path = p("data")
        self._index_path = p("index")
        self._data_f = None
        self._data_mm = None
        self._index_f = None
        self._index_mm = None
        self._mm_init = threading.Lock()
        # Summaries: parallel sorted (ids, index-file byte offsets).
        self._sum_ids: list[bytes] = []
        self._sum_offs: list[int] = []
        raw = p("summaries").read_bytes()
        pos = 0
        while pos < len(raw):
            (idlen,) = struct.unpack_from("<I", raw, pos)
            pos += 4
            self._sum_ids.append(raw[pos : pos + idlen])
            pos += idlen
            self._sum_offs.append(struct.unpack_from("<Q", raw, pos)[0])
            pos += 8
        self.bloom = BloomFilter.from_bytes(p("bloom").read_bytes())

    def _mm(self, path: Path, attr_f: str, attr_mm: str):
        if getattr(self, attr_mm) is None:
            import mmap as _mmap

            # Initialization is the only mutation; reads thereafter are
            # lock-free slices.  Without the lock a first-read race
            # leaks the loser's fd + mmap.
            with self._mm_init:
                if getattr(self, attr_mm) is None:
                    f = open(path, "rb")
                    setattr(self, attr_f, f)
                    try:
                        setattr(self, attr_mm, _mmap.mmap(
                            f.fileno(), 0, access=_mmap.ACCESS_READ))
                    except ValueError:  # zero-length file (empty fileset)
                        setattr(self, attr_mm, b"")
        return getattr(self, attr_mm)

    def _data(self):
        return self._mm(self._data_path, "_data_f", "_data_mm")

    def _index_raw(self):
        mm = self._mm(self._index_path, "_index_f", "_index_mm")
        if len(mm) and bytes(mm[:4]) != INDEX_MAGIC:
            raise FormatCorruption("bad index magic", path=self._index_path,
                                   component="fileset", check="index-magic")
        return mm

    def close(self) -> None:
        for attr_mm, attr_f in (("_data_mm", "_data_f"),
                                ("_index_mm", "_index_f")):
            mm = getattr(self, attr_mm)
            if mm is not None and not isinstance(mm, bytes):
                mm.close()
            setattr(self, attr_mm, None)
            f = getattr(self, attr_f)
            if f is not None:
                f.close()
                setattr(self, attr_f, None)

    def __del__(self):  # belt-and-braces for transient readers
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    @staticmethod
    def _entry_at(raw, pos: int) -> tuple[IndexEntry, int]:
        """Parse one index entry at byte ``pos``; returns (entry, next_pos)."""
        (idlen,) = struct.unpack_from("<I", raw, pos)
        pos += 4
        sid = bytes(raw[pos : pos + idlen])
        pos += idlen
        off, length, csum = struct.unpack_from("<QII", raw, pos)
        return IndexEntry(sid, off, length, csum), pos + 16

    def entries(self) -> Iterator[IndexEntry]:
        """Stream every index entry in id order without materializing
        the index (repair/verify tooling path)."""
        raw = self._index_raw()
        if not len(raw):
            return
        (n,) = struct.unpack_from("<Q", raw, 4)
        pos = INDEX_HEADER_LEN
        for _ in range(n):
            e, pos = self._entry_at(raw, pos)
            yield e

    def _lookup(self, sid: bytes) -> IndexEntry | None:
        """Summaries-guided probe: binary-search the in-memory summary
        ids, then scan forward over raw index bytes — at most
        SUMMARY_EVERY entries parsed per miss (index_lookup.go)."""
        j = bisect_right(self._sum_ids, sid) - 1
        if j < 0:
            return None
        raw = self._index_raw()
        pos = self._sum_offs[j]
        end = (self._sum_offs[j + 1] if j + 1 < len(self._sum_offs)
               else len(raw))
        while pos < end:
            e, pos = self._entry_at(raw, pos)
            if e.id == sid:
                return e
            if e.id > sid:  # sorted: gone past
                return None
        return None

    def read(self, sid: bytes) -> bytes | None:
        if not self.bloom.contains(sid):
            return None
        e = self._lookup(sid)
        if e is None:
            return None
        seg = bytes(self._data()[e.offset : e.offset + e.length])
        # ``fileset.read`` faultpoint: corrupt mode flips one byte of
        # the segment BEFORE the checksum verify, so dtest can exercise
        # the detect→quarantine→repair loop without touching disk.
        _, seg = fault.mangle("fileset.read", seg)
        if digest(seg) != e.checksum:
            raise ChecksumMismatch(
                f"segment checksum mismatch for {sid!r}",
                path=self._data_path, component="fileset",
                check="segment-checksum")
        return seg

    def read_all(self) -> Iterator[tuple[bytes, bytes]]:
        mm = self._data()
        for e in self.entries():  # index entries are offset-ordered
            seg = bytes(mm[e.offset : e.offset + e.length])
            _, seg = fault.mangle("fileset.read", seg)
            if digest(seg) != e.checksum:
                raise ChecksumMismatch(
                    f"segment checksum mismatch for {e.id!r}",
                    path=self._data_path, component="fileset",
                    check="segment-checksum")
            yield e.id, seg

    def __len__(self) -> int:
        return self.info.num_series


def list_fileset_volumes(root, namespace: str, shard: int) -> list[tuple[int, int]]:
    """EVERY checkpointed (block_start, volume) pair, including superseded
    volumes — the cleanup path's view (reference files.go enumerates all
    volumes; cleanup.go deletes out-of-retention and past-volume sets)."""
    d = fileset_dir(root, namespace, shard)
    if not d.exists():
        return []
    out = []
    for f in d.glob("fileset-*-checkpoint.db"):
        parts = f.stem.split("-")
        out.append((int(parts[1]), int(parts[2])))
    return sorted(out)


def remove_fileset(root, namespace: str, shard: int, block_start: int, volume: int) -> None:
    """Delete one fileset volume, checkpoint FIRST so a crash mid-delete
    leaves an invisible (not half-readable) fileset."""
    for t in ("checkpoint", "digest") + FILE_TYPES:
        fileset_path(root, namespace, shard, block_start, volume, t).unlink(
            missing_ok=True
        )


def list_filesets(root, namespace: str, shard: int) -> list[tuple[int, int]]:
    """(block_start, volume) pairs with a checkpoint present, sorted;
    only the max volume per block is returned (reference files.go
    volume semantics: higher volume supersedes)."""
    d = fileset_dir(root, namespace, shard)
    if not d.exists():
        return []
    best: dict[int, int] = {}
    for f in d.glob("fileset-*-checkpoint.db"):
        parts = f.stem.split("-")
        bs, vol = int(parts[1]), int(parts[2])
        best[bs] = max(best.get(bs, -1), vol)
    return sorted(best.items())
