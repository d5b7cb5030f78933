"""Index segments: mutable (ingest) and sealed immutable (query).

Equivalents of `src/m3ninx/index/segment/mem` (concurrent mutable segment:
terms dict → postings), `segment/builder` (batch builder + merge), and
`segment/fst` (immutable mmap-able segment with vellum FSTs and pilosa
bitset postings, layout in `fst/README.md:1-40`).

The TPU-frame design splits responsibilities: the **host** owns the string
dictionaries (pointer-chasing FSTs are not TPU-shaped — SURVEY.md §7
phase 4), stored as sorted term tables with binary search (the FST's
ordered-map role); **device** sees postings as dense bitsets for query-
time set algebra (`postings.py`).  The sealed byte layout keeps the
reference's section structure (fields table → per-field terms table →
postings + docs store) so segment files serve the same
write-once/mmap-many role as FST filesets.

The port's copy of ``m3_tpu/index/segment.py`` (it imports nothing of ``m3_tpu``).
"""

from __future__ import annotations

import re
import struct
from bisect import bisect_left
from dataclasses import dataclass

import numpy as np

from m3_tpu_torch.index.doc import Document, Field

SEG_MAGIC = b"M3SG"
SEG_VERSION = 1


class MutableSegment:
    """Ingest-side inverted index (reference segment/mem): doc insert
    appends postings per (field, term); seal() -> SealedSegment."""

    def __init__(self):
        self._docs: list[Document] = []
        self._ids: dict[bytes, int] = {}
        self._fields: dict[bytes, dict[bytes, list[int]]] = {}
        self.generation = 0  # bumps on insert; callers cache seals by it

    def __len__(self) -> int:
        return len(self._docs)

    def insert(self, doc: Document) -> int:
        """Insert one document; duplicate IDs return the existing doc id
        (the reference enforces ID uniqueness per segment)."""
        existing = self._ids.get(doc.id)
        if existing is not None:
            return existing
        did = len(self._docs)
        self._docs.append(doc)
        self._ids[doc.id] = did
        for f in doc.fields:
            self._fields.setdefault(f.name, {}).setdefault(f.value, []).append(did)
        self.generation += 1
        return did

    def insert_batch(self, docs: list[Document]) -> list[int]:
        return [self.insert(d) for d in docs]

    def seal(self) -> "SealedSegment":
        return SealedSegment.build(self._docs, self._fields)


@dataclass
class _FieldEntry:
    terms: list[bytes]
    postings: list[np.ndarray]


class SealedSegment:
    """Immutable segment: sorted field/term tables + postings arrays +
    docs store (reference segment/fst's role, host-table form)."""

    def __init__(self, docs: list[Document], fields: dict[bytes, _FieldEntry]):
        self._docs = docs
        self._fields = fields

    @classmethod
    def build(cls, docs, fields_raw) -> "SealedSegment":
        fields: dict[bytes, _FieldEntry] = {}
        for name in sorted(fields_raw):
            terms = sorted(fields_raw[name])
            fields[name] = _FieldEntry(
                terms=terms,
                postings=[
                    np.asarray(sorted(fields_raw[name][t]), np.int32) for t in terms
                ],
            )
        return cls(list(docs), fields)

    # -- reads -------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._docs)

    @property
    def num_docs(self) -> int:
        return len(self._docs)

    def doc(self, did: int) -> Document:
        return self._docs[did]

    def fields(self) -> list[bytes]:
        return list(self._fields)

    def terms(self, field: bytes) -> list[bytes]:
        e = self._fields.get(field)
        return list(e.terms) if e else []

    def postings_term(self, field: bytes, value: bytes) -> np.ndarray:
        e = self._fields.get(field)
        if e is None:
            return np.empty(0, np.int32)
        i = bisect_left(e.terms, value)
        if i < len(e.terms) and e.terms[i] == value:
            return e.postings[i]
        return np.empty(0, np.int32)

    def postings_regexp(self, field: bytes, pattern: bytes) -> np.ndarray:
        """Union of postings for terms matching the (anchored) regexp —
        the FST range-scan equivalent (reference search/searcher/regexp)."""
        e = self._fields.get(field)
        if e is None:
            return np.empty(0, np.int32)
        # Fully anchored, like Prometheus matchers: ^(?:pattern)$ —
        # grouping keeps alternations from escaping the anchors.
        rx = re.compile(b"(?:" + pattern + b")")
        hits = [p for t, p in zip(e.terms, e.postings) if rx.fullmatch(t)]
        if not hits:
            return np.empty(0, np.int32)
        return np.unique(np.concatenate(hits))

    def postings_field(self, field: bytes) -> np.ndarray:
        e = self._fields.get(field)
        if e is None:
            return np.empty(0, np.int32)
        return np.unique(np.concatenate(e.postings))

    def postings_all(self) -> np.ndarray:
        return np.arange(len(self._docs), dtype=np.int32)

    # -- serialization -----------------------------------------------------

    def to_bytes(self) -> bytes:
        parts = [SEG_MAGIC, struct.pack("<IQ", SEG_VERSION, len(self._docs))]
        for d in self._docs:
            parts.append(struct.pack("<H", len(d.id)))
            parts.append(d.id)
            parts.append(struct.pack("<H", len(d.fields)))
            for f in d.fields:
                parts.append(struct.pack("<H", len(f.name)))
                parts.append(f.name)
                parts.append(struct.pack("<H", len(f.value)))
                parts.append(f.value)
        parts.append(struct.pack("<I", len(self._fields)))
        for name, e in self._fields.items():
            parts.append(struct.pack("<H", len(name)))
            parts.append(name)
            parts.append(struct.pack("<I", len(e.terms)))
            for t, p in zip(e.terms, e.postings):
                parts.append(struct.pack("<H", len(t)))
                parts.append(t)
                parts.append(struct.pack("<I", len(p)))
                parts.append(p.tobytes())
        return b"".join(parts)

    @classmethod
    def from_bytes(cls, raw: bytes) -> "SealedSegment":
        if raw[:4] != SEG_MAGIC:
            raise ValueError("bad segment magic")
        ver, ndocs = struct.unpack_from("<IQ", raw, 4)
        if ver != SEG_VERSION:
            raise ValueError(f"unsupported segment version {ver}")
        pos = 16
        docs: list[Document] = []
        for _ in range(ndocs):
            (idlen,) = struct.unpack_from("<H", raw, pos)
            pos += 2
            did = raw[pos : pos + idlen]
            pos += idlen
            (nf,) = struct.unpack_from("<H", raw, pos)
            pos += 2
            fields = []
            for _ in range(nf):
                (nl,) = struct.unpack_from("<H", raw, pos)
                pos += 2
                name = raw[pos : pos + nl]
                pos += nl
                (vl,) = struct.unpack_from("<H", raw, pos)
                pos += 2
                value = raw[pos : pos + vl]
                pos += vl
                fields.append(Field(name, value))
            docs.append(Document(did, tuple(fields)))
        (nfields,) = struct.unpack_from("<I", raw, pos)
        pos += 4
        fdict: dict[bytes, _FieldEntry] = {}
        for _ in range(nfields):
            (nl,) = struct.unpack_from("<H", raw, pos)
            pos += 2
            name = raw[pos : pos + nl]
            pos += nl
            (nterms,) = struct.unpack_from("<I", raw, pos)
            pos += 4
            terms, plists = [], []
            for _ in range(nterms):
                (tl,) = struct.unpack_from("<H", raw, pos)
                pos += 2
                terms.append(raw[pos : pos + tl])
                pos += tl
                (np_,) = struct.unpack_from("<I", raw, pos)
                pos += 4
                plists.append(
                    np.frombuffer(raw, np.int32, np_, pos).copy()
                )
                pos += np_ * 4
            fdict[name] = _FieldEntry(terms, plists)
        return cls(docs, fdict)


def merge_segments(segments: list[SealedSegment]) -> SealedSegment:
    """Compaction merge (reference segment/builder multi_segments_*):
    re-inserts docs with deduplication by ID, rebuilding postings."""
    m = MutableSegment()
    for seg in segments:
        for did in range(len(seg)):
            m.insert(seg.doc(did))
    return m.seal()
