"""Native host codec bindings (ctypes over ``csrc/m3tsz.cc``), and the
package of the port's other host C++ helpers: the ID->slot resolver
(``idmap``) and the aggregator baseline (``aggproxy``), each built with
g++ at first use (``_build``).  The counterpart of ``m3_tpu/native``.

`m3tsz_encode`/`m3tsz_decode` are the C++ fast path for single-series
encode/decode (the role of the reference's Go codec in
`src/dbnode/encoding/m3tsz`), with the Python scalar codec
(``encoding/m3tsz.py``) as oracle for stream features the native path
rejects (annotations, mid-stream time-unit changes): those come back as
``None`` or a ``fallback`` flag, and the caller decides.  The batch forms
run on a host thread pool.  Host numpy arrays go in and out; nothing here
touches a device, so this codec is the host yardstick the card's codec
(``encoding/m3tsz_torch.py``, kernels #1 and #2) is held against.

The shared object builds on demand into ``build/m3_tpu_torch/`` with
``-O3 -ffp-contract=off -pthread`` (FMA contraction would change the
rounding of the decoder's int_val accumulation; the batch pool needs
threads); `available()` is False when it cannot be built.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from m3_tpu_torch.native._build import load_native

# -O3 comes after _build's -O2, and the last -O wins.
FLAGS = ("-O3", "-ffp-contract=off", "-pthread")

_lib = None


def _load():
    """The typed library, or None when it cannot be built (``load_native``
    caches either outcome per process)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = load_native("m3tsz.cc", FLAGS)
    if lib is None:
        return None
    lib.m3tsz_encode.restype = ctypes.c_long
    lib.m3tsz_encode.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
        ctypes.c_long, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
    ]
    lib.m3tsz_decode.restype = ctypes.c_long
    lib.m3tsz_decode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
        ctypes.c_long,
    ]
    lib.m3tsz_decode_batch.restype = ctypes.c_long
    lib.m3tsz_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_long, ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
    ]
    lib.m3tsz_encode_batch.restype = ctypes.c_long
    lib.m3tsz_encode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
    ]
    _lib = lib
    return lib


def _nthreads(requested: int | None) -> int:
    if requested is not None:
        return max(1, requested)
    return os.cpu_count() or 1


def _encode_cap(n: int) -> int:
    """Worst-case output bytes for ``n`` datapoints (~18.5 bytes/point
    true worst case: 68-bit dod + 78-bit uncontained XOR, plus stream
    head/tail)."""
    return max(64, n * 20 + 16)


def available() -> bool:
    return _load() is not None


def encode_series(timestamps: np.ndarray, values: np.ndarray, start: int,
                  unit: int = 1) -> bytes | None:
    """Encode one series; None means unsupported input (use the Python
    codec)."""
    lib = _load()
    if lib is None:
        return None
    ts = np.ascontiguousarray(timestamps, np.int64)
    vals = np.ascontiguousarray(values, np.float64)
    n = len(ts)
    cap = _encode_cap(n)
    while True:
        out = np.empty(cap, np.uint8)
        r = lib.m3tsz_encode(
            ts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n, start, unit,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
        )
        if r == -1:
            cap *= 2
            continue
        if r < 0:
            return None
        return out[:r].tobytes()


def decode_series(data: bytes, default_unit: int = 1,
                  max_points: int | None = None):
    """Decode one stream -> (ts, values) arrays; None = unsupported
    stream feature (use the Python codec).  Raises ValueError on
    corruption."""
    lib = _load()
    if lib is None:
        return None
    if not data:
        return np.empty(0, np.int64), np.empty(0)
    buf = np.frombuffer(data, np.uint8)
    cap = max_points or max(16, len(data) * 2)
    while True:
        ts = np.empty(cap, np.int64)
        vals = np.empty(cap, np.float64)
        r = lib.m3tsz_decode(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data),
            default_unit,
            ts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), cap,
        )
        if r == -1:
            cap *= 2
            continue
        if r == -2:
            return None
        if r < 0:
            raise ValueError("corrupt m3tsz stream")
        return ts[:r].copy(), vals[:r].copy()


def decode_batch(streams: list[bytes], max_points: int, default_unit: int = 1,
                 nthreads: int | None = None):
    """Decode a batch of streams with the threaded native decoder.

    Returns (ts (B, max_points) int64, vals (B, max_points) float64,
    counts (B,) int64, fallback (B,) bool) or None when the native
    library is unavailable.  ``fallback`` marks streams the native path
    rejects (annotations, time-unit changes, corruption, cap overflow) —
    callers route those through the scalar path.  Unset output slots
    are zero-filled.
    """
    lib = _load()
    if lib is None:
        return None
    B = len(streams)
    offsets = np.zeros(B + 1, np.int64)
    for i, s in enumerate(streams):
        offsets[i + 1] = offsets[i] + len(s)
    # FastIStream loads 9 bytes at a time: pad the concatenated buffer.
    data = np.frombuffer(b"".join(streams) + b"\x00" * 16, np.uint8)
    ts = np.zeros((B, max_points), np.int64)
    vals = np.zeros((B, max_points), np.float64)
    counts = np.zeros(B, np.int64)
    lib.m3tsz_decode_batch(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        B, default_unit,
        ts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        max_points,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _nthreads(nthreads),
    )
    fallback = counts < 0
    counts = np.where(fallback, 0, counts)
    return ts, vals, counts, fallback


def encode_batch(timestamps, values, starts, counts=None, unit: int = 1,
                 nthreads: int | None = None):
    """Encode (B, T) series with the threaded native encoder.

    Returns (streams list[bytes], fallback (B,) bool) or None when the
    native library is unavailable; fallback series carry b"" and must go
    through the scalar codec.
    """
    lib = _load()
    if lib is None:
        return None
    ts = np.ascontiguousarray(timestamps, np.int64)
    vals = np.ascontiguousarray(values, np.float64)
    B, T = ts.shape
    ns = (np.full(B, T, np.int64) if counts is None
          else np.ascontiguousarray(counts, np.int64))
    if ns.shape != (B,) or (ns < 0).any() or (ns > T).any():
        raise ValueError(f"counts must be (B,) ints in [0, {T}]")
    starts_arr = np.ascontiguousarray(starts, np.int64)
    if starts_arr.shape != (B,):
        raise ValueError(f"starts must have shape ({B},)")
    stride = _encode_cap(T)
    out = np.empty((B, stride), np.uint8)
    lens = np.zeros(B, np.int64)
    lib.m3tsz_encode_batch(
        ts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ns.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        B, T,
        starts_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        unit,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        stride,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _nthreads(nthreads),
    )
    fallback = lens < 0
    streams = [b"" if lens[i] < 0 else out[i, :lens[i]].tobytes()
               for i in range(B)]
    return streams, fallback
