"""Decode phase 1, the per-series bit-boundary scan: the port's form of
the reference's ``lax.scan(_decode_step, ..., length=max_points)``
(``m3_tpu/encoding/m3tsz_jax.py``, ``_decode_batch_device``).

``decode_scan`` walks every series' padded stream words through
``max_points`` datapoint slots and returns the per-slot lanes and the
final carry, with the EOS peek after the last slot folded into ``done``.
Both tails of ``m3tsz_torch._decode_batch_device`` have a form:
``gather`` gives the four (P, S) int32 lane tables (ts_off, p1, val_off,
p2) for phase 2's field extraction, and ``fused`` the decoded (P, S)
ts, payload (int64) and meta (uint8) with the chains in the carry.

A CPU tensor takes ``decode_scan_plain``: the Python loop of
``m3tsz_torch._decode_step``, one step (~444 tensor ops) a slot.  A CUDA
tensor launches the hand-written kernel ``csrc/decode_scan.cu`` (one
thread a series, every slot in one launch) or raises.  The kernel's
per-step logic lives in ``csrc/decode_scan.cuh``; the CPU tests build it
for the host with g++ and hold it against the plain loop.
"""

from __future__ import annotations

import ctypes

import torch

from m3_tpu_torch.parallel import _cuda
from m3_tpu_torch.x import devseams

KERNEL = "decode_scan"
launches = 0  # kernel launches since the last reset (the wrappers' count)

CTRL_ENTRIES = 1 << 18  # the value-control table's rows
# the carry's rows that are flags (``m3tsz_torch._decode_carry0``'s order):
# done, err, need_start, first_val, saw_ann, is_float; prec, err2 (fused)
_FLAG_ROWS = frozenset((1, 2, 3, 4, 5, 9, 17, 18))
CARRY_ROWS = {False: 12, True: 19}  # gather, fused


def _check(wpad, nbits, unit0, ctrl_tbl, max_points):
    if wpad.dtype != torch.int64 or nbits.dtype != torch.int64 \
            or unit0.dtype != torch.int64:
        raise TypeError("decode_scan wants int64 words, bit lengths and units, got "
                        f"{wpad.dtype}, {nbits.dtype} and {unit0.dtype}")
    if ctrl_tbl.dtype != torch.int32:
        raise TypeError(f"decode_scan wants an int32 control table, got {ctrl_tbl.dtype}")
    if (wpad.dim() != 2 or nbits.shape != (wpad.shape[0],)
            or unit0.shape != (wpad.shape[0],) or ctrl_tbl.shape != (CTRL_ENTRIES,)):
        raise ValueError(
            f"decode_scan wants (S, W) words, (S,) bit lengths and units and a "
            f"({CTRL_ENTRIES},) table, got {tuple(wpad.shape)}, {tuple(nbits.shape)}, "
            f"{tuple(unit0.shape)} and {tuple(ctrl_tbl.shape)}")
    if wpad.shape[1] < 2:
        raise ValueError("decode_scan needs >= 2 words a series (zero padded)")
    if int(max_points) != max_points or max_points < 0:
        raise ValueError(f"decode_scan: max_points must be an int >= 0, got {max_points!r}")
    if not (wpad.device == nbits.device == unit0.device == ctrl_tbl.device):
        raise ValueError("decode_scan: inputs on different devices")


def decode_scan_plain(wpad, nbits, unit0, ctrl_tbl, max_points: int, fused: bool = False):
    """Plain PyTorch version: the loop ``_decode_batch_device`` ran, one
    ``_decode_step`` a slot.  The wrapper hands it CPU tensors only."""
    from m3_tpu_torch.encoding import m3tsz_torch as mt

    S = wpad.shape[0]
    dev = wpad.device
    P = max_points
    if fused:
        unit_tbl = torch.from_numpy(mt._UNIT_NANOS).to(dev)
        lanes = [torch.empty((P, S), dtype=dt, device=dev)
                 for dt in (torch.int64, torch.int64, torch.uint8)]
        carry = mt._decode_carry0(S, dev, base_time=wpad[:, 0])
    else:
        unit_tbl = None
        lanes = [torch.empty((P, S), dtype=torch.int32, device=dev) for _ in range(4)]
        carry = mt._decode_carry0(S, dev)
    for i in range(P):
        carry, out = mt._decode_step(carry, wpad, nbits, unit0, ctrl_tbl, unit_tbl)
        for tbl, o in zip(lanes, out):
            tbl[i] = o

    # A stream whose EOS marker sits exactly after max_points datapoints
    # never sets done inside the scan; peek once more for it.
    cursor, done = carry[0], carry[1]
    peek11 = mt._peek(wpad, cursor, 11)
    done = done | (((cursor + 11) <= nbits) & ((peek11 >> 2) == 0x100)
                   & ((peek11 & 3) == 0))
    return tuple(lanes), (cursor, done) + tuple(carry[2:])


def _lib():
    lib = _cuda.load(KERNEL)
    fn = lib.m3_decode_scan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def decode_scan(wpad, nbits, unit0, ctrl_tbl, max_points: int, fused: bool = False):
    """(S, W) int64 padded words, (S,) int64 bit lengths and initial
    units, the (2^18,) int32 value-control table -> (lanes, carry).

    lanes: gather, four (P, S) int32 tables (ts_off, p1, val_off, p2);
    fused, (P, S) int64 ts, int64 payload and uint8 meta.  carry: the
    final ``_decode_carry0``-shaped tuple (12 lanes, 19 fused), ``done``
    including the EOS peek.  CPU tensors: the plain version; CUDA
    tensors: the kernel (one thread a series, one launch)."""
    global launches
    _check(wpad, nbits, unit0, ctrl_tbl, max_points)
    if wpad.device.type == "cpu":
        return decode_scan_plain(wpad, nbits, unit0, ctrl_tbl, max_points, fused)
    if wpad.device.type != "cuda":
        raise ValueError(f"decode_scan: no kernel for device {wpad.device}")
    if not (wpad.is_contiguous() and nbits.is_contiguous() and unit0.is_contiguous()
            and ctrl_tbl.is_contiguous()):
        raise ValueError("decode_scan: inputs must be contiguous")
    S, Wp = wpad.shape
    P = int(max_points)
    dev = wpad.device
    dts = (torch.int64, torch.int64, torch.uint8) if fused else (torch.int32,) * 4
    lanes = tuple(torch.empty((P, S), dtype=dt, device=dev) for dt in dts)
    carry = torch.empty((CARRY_ROWS[fused], S), dtype=torch.int64, device=dev)
    if S > 0:
        ptrs = [t.data_ptr() for t in lanes] + [0] * (4 - len(lanes))
        lib = _lib()
        with torch.cuda.device(dev):  # the runtime launches on the current device
            rc = lib.m3_decode_scan(
                wpad.data_ptr(), Wp, nbits.data_ptr(), unit0.data_ptr(),
                ctrl_tbl.data_ptr(), P, S, int(fused), *ptrs, carry.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        _cuda.check(lib, rc, "decode_scan")
        launches += 1
        devseams.launched(KERNEL, 1)
    rows = carry.unbind(0)
    return lanes, tuple(r != 0 if k in _FLAG_ROWS else r for k, r in enumerate(rows))
