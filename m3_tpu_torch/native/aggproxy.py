"""ctypes bindings for the single-core Go-aggregator proxy
(``csrc/agg_bench.cc``, the port's copy of ``native/agg_bench.cc``): the
counterpart of ``m3_tpu/native/aggproxy.py``, the measured HOST baseline
for BASELINE configs #3/#4 (the 1M-series counter/gauge rollup, timer
quantiles).

Host C++ on one core, built on first use by ``native/_build.load_native``
into ``build/m3_tpu_torch/``; no device kernel.  ``available()`` says
whether the library builds and loads; the timed entry points raise when
it does not (there is nothing to fall back to).
"""

from __future__ import annotations

import ctypes
import time

import numpy as np

from m3_tpu_torch.native._build import load_native

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    lib = load_native("agg_bench.cc")
    if lib is None:
        return None
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")

    lib.agg_counter_new.restype = ctypes.c_void_p
    lib.agg_counter_new.argtypes = [ctypes.c_int64]
    lib.agg_counter_free.argtypes = [ctypes.c_void_p]
    lib.agg_counter_ingest.restype = ctypes.c_int64
    lib.agg_counter_ingest.argtypes = [u32p, i64p, ctypes.c_int64,
                                       ctypes.c_int64, ctypes.c_void_p]

    lib.agg_gauge_new.restype = ctypes.c_void_p
    lib.agg_gauge_new.argtypes = [ctypes.c_int64]
    lib.agg_gauge_free.argtypes = [ctypes.c_void_p]
    lib.agg_gauge_ingest.restype = ctypes.c_double
    lib.agg_gauge_ingest.argtypes = [u32p, f64p, i64p, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_void_p]

    lib.agg_timer_new.restype = ctypes.c_void_p
    lib.agg_timer_new.argtypes = [ctypes.c_int64]
    lib.agg_timer_free.argtypes = [ctypes.c_void_p]
    lib.agg_timer_ingest.argtypes = [u32p, f64p, ctypes.c_int64,
                                     ctypes.c_void_p]
    lib.agg_timer_flush.restype = ctypes.c_int64
    lib.agg_timer_flush.argtypes = [ctypes.c_void_p, f64p, ctypes.c_int64,
                                    f64p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _need():
    lib = _load()
    if lib is None:
        raise RuntimeError("aggproxy: csrc/agg_bench.cc did not build or load (g++)")
    return lib


def counter_rollup_ns(ids: np.ndarray, values: np.ndarray,
                      capacity: int) -> float:
    """Time (seconds) to ingest all samples into a dense counter arena and
    checksum-flush it, single core."""
    lib = _need()
    cells = lib.agg_counter_new(capacity)
    try:
        t0 = time.perf_counter()
        lib.agg_counter_ingest(ids, values, len(ids), capacity, cells)
        return time.perf_counter() - t0
    finally:
        lib.agg_counter_free(cells)


def gauge_rollup_ns(ids: np.ndarray, values: np.ndarray, times: np.ndarray,
                    capacity: int) -> float:
    """Time (seconds) to ingest all samples into a dense gauge arena,
    single core."""
    lib = _need()
    cells = lib.agg_gauge_new(capacity)
    try:
        t0 = time.perf_counter()
        lib.agg_gauge_ingest(ids, values, times, len(ids), capacity, cells)
        return time.perf_counter() - t0
    finally:
        lib.agg_gauge_free(cells)


def timer_quantiles(ids: np.ndarray, values: np.ndarray, capacity: int,
                    quantiles=(0.5, 0.95, 0.99)):
    """Ingest + flush; returns (seconds, out matrix (capacity, nq+1))."""
    lib = _need()
    arena = lib.agg_timer_new(capacity)
    qs = np.asarray(quantiles, np.float64)
    out = np.zeros((capacity, len(quantiles) + 1), np.float64)
    try:
        t0 = time.perf_counter()
        lib.agg_timer_ingest(ids, values, len(ids), arena)
        lib.agg_timer_flush(arena, qs, len(qs), out)
        return time.perf_counter() - t0, out
    finally:
        lib.agg_timer_free(arena)
