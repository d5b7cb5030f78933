"""Document model for the inverted index.

Equivalent of `src/m3ninx/doc`: a document is a series ID plus (name,
value) field pairs — i.e. the tag set of a time series.  The wire form
(`encode_tags`/`decode_tags`) is the analogue of the reference's
length-prefixed tag serialization (`src/x/serialize/encoder.go` — header
+ pair count + len-prefixed name/value), carried in commitlog entry
annotations so index recovery can rebuild documents from the WAL.

The port's copy of ``m3_tpu/index/doc.py`` (it imports nothing of ``m3_tpu``).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

_TAG_MAGIC = 0x7A52  # header distinguishing tag payloads from raw annotations


@dataclass(frozen=True)
class Field:
    name: bytes
    value: bytes


@dataclass(frozen=True)
class Document:
    id: bytes
    fields: tuple[Field, ...] = ()

    @classmethod
    def from_tags(cls, sid: bytes, tags: dict[bytes, bytes]) -> "Document":
        return cls(sid, tuple(Field(n, v) for n, v in sorted(tags.items())))

    def tags(self) -> dict[bytes, bytes]:
        return {f.name: f.value for f in self.fields}


def encode_tags(doc: Document) -> bytes:
    """[magic u16][npairs u16] then per pair [len u16][name][len u16][value]."""
    parts = [struct.pack("<HH", _TAG_MAGIC, len(doc.fields))]
    for f in doc.fields:
        parts.append(struct.pack("<H", len(f.name)) + f.name)
        parts.append(struct.pack("<H", len(f.value)) + f.value)
    return b"".join(parts)


def decode_tags(sid: bytes, raw: bytes) -> Document | None:
    """Rebuild a Document from an encoded tag payload; None if `raw`
    isn't one (plain annotation bytes pass through unharmed)."""
    if len(raw) < 4:
        return None
    magic, n = struct.unpack_from("<HH", raw, 0)
    if magic != _TAG_MAGIC:
        return None
    pos, fields = 4, []
    try:
        for _ in range(n):
            (ln,) = struct.unpack_from("<H", raw, pos)
            pos += 2
            name = raw[pos : pos + ln]
            pos += ln
            (lv,) = struct.unpack_from("<H", raw, pos)
            pos += 2
            value = raw[pos : pos + lv]
            pos += lv
            if len(name) != ln or len(value) != lv:
                return None
            fields.append(Field(name, value))
    except struct.error:
        return None
    return Document(sid, tuple(fields))
