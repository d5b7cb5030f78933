"""Adler32 digests guarding every persisted file.

The reference stamps each fileset file with an adler32 digest collected in
a digests file, and writes a checkpoint file (digest of the digests file)
last to gate fileset visibility (`src/dbnode/digest/digest.go:24-37`,
`src/dbnode/persist/fs/files.go:618-624`).  Same scheme here.

The port's copy of ``m3_tpu/persist/digest.py`` (it imports nothing of ``m3_tpu``).
"""

from __future__ import annotations

import struct
import zlib


def digest(data: bytes) -> int:
    return zlib.adler32(data) & 0xFFFFFFFF


def digest_file(path) -> int:
    with open(path, "rb") as f:
        return digest(f.read())


def pack_digest(d: int) -> bytes:
    return struct.pack("<I", d)


def unpack_digest(b: bytes) -> int:
    return struct.unpack("<I", b[:4])[0]
