"""Encode phase 1, the per-series lane-emission scan: the port's form of
the reference's ``lax.scan(scan_fn, carry0, xs)`` over
``jax.vmap(_encode_step)`` (``m3_tpu/encoding/m3tsz_jax.py``,
``_encode_batch_device``).

``encode_scan`` walks every series through its T datapoints and returns
the four (value, width) lanes of each datapoint in the scan-major
(T, 4, S) tables that phase 2 places (t0, t1, v0, v1), with the final
carry in ``m3tsz_torch._encode_carry0``'s order.  The initial carry is
the caller's, so the rule that decides the stream's initial unit stays
in ``_encode_carry0``.

A CPU tensor takes ``encode_scan_plain``: the Python loop of
``m3tsz_torch._encode_step``, one step (~1,326 tensor ops) a datapoint.
A CUDA tensor launches the hand-written kernel ``csrc/encode_scan.cu``
(one thread a series, every datapoint in one launch) or raises.  The
kernel's per-step logic lives in ``csrc/encode_scan.cuh``; the CPU tests
build it for the host with g++ and hold it against the plain loop.
"""

from __future__ import annotations

import ctypes

import torch

from m3_tpu_torch.core.xtime import Unit
from m3_tpu_torch.parallel import _cuda
from m3_tpu_torch.x import devseams

KERNEL = "encode_scan"
launches = 0  # kernel launches since the last reset (the wrappers' count)

CARRY_ROWS = 13  # ``m3tsz_torch._encode_carry0``'s rows
# the carry's rows that are flags: tu_none, is_float, is_first, fallback
_FLAG_ROWS = frozenset((2, 5, 11, 12))


def _check(ts_t, vb_t, valid_t, carry0, unit):
    if ts_t.dtype != torch.int64 or vb_t.dtype != torch.int64 \
            or valid_t.dtype != torch.bool:
        raise TypeError("encode_scan wants int64 timestamps and value bits and a bool "
                        f"mask, got {ts_t.dtype}, {vb_t.dtype} and {valid_t.dtype}")
    if ts_t.dim() != 2 or vb_t.shape != ts_t.shape or valid_t.shape != ts_t.shape:
        raise ValueError("encode_scan wants (T, S) timestamps, value bits and mask, got "
                         f"{tuple(ts_t.shape)}, {tuple(vb_t.shape)} and {tuple(valid_t.shape)}")
    S = ts_t.shape[1]
    if len(carry0) != CARRY_ROWS or any(c.shape != (S,) for c in carry0):
        raise ValueError(f"encode_scan wants a carry of {CARRY_ROWS} (S,) rows with S = {S}, "
                         f"got {[tuple(c.shape) for c in carry0]}")
    flags = [c.dtype == torch.bool for c in carry0]
    if flags != [k in _FLAG_ROWS for k in range(CARRY_ROWS)] or any(
            c.dtype != torch.int64 for k, c in enumerate(carry0) if k not in _FLAG_ROWS):
        raise TypeError("encode_scan wants _encode_carry0's row types (bool flags in rows "
                        f"{sorted(_FLAG_ROWS)}, int64 elsewhere), got "
                        f"{[c.dtype for c in carry0]}")
    if int(unit) not in {int(u) for u in Unit if u != Unit.NONE}:
        raise ValueError(f"encode_scan: unit must be a time unit's wire byte, got {unit!r}")
    if not all(x.device == ts_t.device for x in (vb_t, valid_t, *carry0)):
        raise ValueError("encode_scan: inputs on different devices")


def encode_scan_plain(ts_t, vb_t, valid_t, carry0, unit: int, default_unit_is_32bit: bool):
    """Plain PyTorch version: the loop ``_encode_batch_device`` ran, one
    ``_encode_step`` a datapoint.  The wrapper hands it CPU tensors only."""
    from m3_tpu_torch.encoding import m3tsz_torch as mt

    T, S = ts_t.shape
    dev = ts_t.device
    lv = torch.empty((T, 4, S), dtype=torch.int64, device=dev)
    lw = torch.empty((T, 4, S), dtype=torch.int32, device=dev)
    carry = tuple(carry0)
    for i in range(T):
        carry, lanes = mt._encode_step(carry, ts_t[i], vb_t[i], valid_t[i],
                                       unit=unit, default_unit_is_32bit=default_unit_is_32bit)
        lv[i] = torch.stack(lanes[:4])
        lw[i] = torch.stack(lanes[4:])
    return lv, lw, carry


def _lib():
    lib = _cuda.load(KERNEL)
    fn = lib.m3_encode_scan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def encode_scan(ts_t, vb_t, valid_t, carry0, unit: int, default_unit_is_32bit: bool):
    """(T, S) int64 timestamps, int64 value bits and bool mask, the
    13-row initial carry of ``_encode_carry0``, the time unit's wire byte
    and whether its default dod bucket is 36 bits -> (lv, lw, carry).

    lv: (T, 4, S) int64 lane values (t0, t1, v0, v1); lw: (T, 4, S)
    int32 widths; carry: the final 13 rows, flags as bool.  CPU tensors:
    the plain version; CUDA tensors: the kernel (one thread a series, one
    launch)."""
    global launches
    _check(ts_t, vb_t, valid_t, carry0, unit)
    if ts_t.device.type == "cpu":
        return encode_scan_plain(ts_t, vb_t, valid_t, carry0, unit, default_unit_is_32bit)
    if ts_t.device.type != "cuda":
        raise ValueError(f"encode_scan: no kernel for device {ts_t.device}")
    if not (ts_t.is_contiguous() and vb_t.is_contiguous() and valid_t.is_contiguous()):
        raise ValueError("encode_scan: inputs must be contiguous")
    T, S = ts_t.shape
    dev = ts_t.device
    lv = torch.empty((T, 4, S), dtype=torch.int64, device=dev)
    lw = torch.empty((T, 4, S), dtype=torch.int32, device=dev)
    if S * T == 0:
        return lv, lw, tuple(carry0)
    c0 = torch.stack([c.to(torch.int64) for c in carry0])
    carry = torch.empty((CARRY_ROWS, S), dtype=torch.int64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):  # the runtime launches on the current device
        rc = lib.m3_encode_scan(
            ts_t.data_ptr(), vb_t.data_ptr(), valid_t.data_ptr(), c0.data_ptr(), T, S,
            int(unit), Unit(unit).nanos(), int(bool(default_unit_is_32bit)),
            lv.data_ptr(), lw.data_ptr(), carry.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(lib, rc, "encode_scan")
    launches += 1
    devseams.launched(KERNEL, 1)
    rows = carry.unbind(0)
    return lv, lw, tuple(r != 0 if k in _FLAG_ROWS else r for k, r in enumerate(rows))
