"""ctypes binding for the native ID->slot resolver (``csrc/idmap.cc``):
the port's copy of ``m3_tpu/native/idmap.py``.

The aggregator ingest hot path's host half (reference metricMap
find-or-create, `map.go:149`): batches of metric IDs resolve to dense
arena slots in one native call instead of one Python dict probe per
sample.  Same build-on-demand pattern as the other native modules;
``available()`` gates callers so a missing toolchain falls back to the
pure-Python MetricMap path.
"""

from __future__ import annotations

import ctypes

import numpy as np

from m3_tpu_torch.native._build import load_native

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    lib = load_native("idmap.cc", ("-std=c++20",))
    if lib is None:
        return None
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")

    lib.idmap_new.restype = ctypes.c_void_p
    lib.idmap_new.argtypes = [ctypes.c_int64]
    lib.idmap_del.argtypes = [ctypes.c_void_p]
    lib.idmap_len.restype = ctypes.c_int64
    lib.idmap_len.argtypes = [ctypes.c_void_p]
    lib.idmap_resolve_batch.restype = ctypes.c_int64
    lib.idmap_resolve_batch.argtypes = [
        ctypes.c_void_p, u8p, u64p, ctypes.c_int64, ctypes.c_uint64,
        i32p, i64p,
    ]
    lib.idmap_release.restype = ctypes.c_int32
    lib.idmap_release.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


class NativeIdMap:
    """Find-or-create slot resolution over packed ID batches."""

    def __init__(self, capacity: int):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native idmap unavailable")
        self._h = self._lib.idmap_new(capacity)
        self.capacity = capacity

    def __len__(self) -> int:
        return self._lib.idmap_len(self._h)

    def resolve(self, ids, mask: int):
        """(slots int32 (n,), new_positions int64 (k,)) — find-or-create
        for every id under the given aggregation mask.  Raises
        RuntimeError when capacity would be exceeded."""
        n = len(ids)
        buf = np.frombuffer(b"".join(ids), dtype=np.uint8)
        offsets = np.zeros(n + 1, np.uint64)
        lens = np.fromiter(map(len, ids), np.uint64, n)
        np.cumsum(lens, out=offsets[1:])
        slots = np.empty(n, np.int32)
        new_idx = np.empty(n, np.int64)
        n_new = self._lib.idmap_resolve_batch(
            self._h, buf if buf.size else np.zeros(1, np.uint8),
            offsets, n, mask, slots, new_idx,
        )
        if n_new < 0:
            raise RuntimeError(f"idmap capacity {self.capacity} exhausted")
        return slots, new_idx[:n_new]

    def release(self, sid: bytes, mask: int) -> bool:
        return bool(self._lib.idmap_release(self._h, sid, len(sid), mask))

    def __del__(self):
        try:
            if self._lib is not None:
                self._lib.idmap_del(self._h)
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
