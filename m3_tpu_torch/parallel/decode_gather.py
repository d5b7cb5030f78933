"""Decode phase-2 field extraction: the counterpart of
``m3_tpu/parallel/pallas_decode.py`` (``extract_fields64_t``).

``extract_fields64_t`` reads, for every (field, series) lane, the
``widths``-bit field at bit offset ``offs`` of that series' stream,
right-aligned.  Words arrive scan-major, (W, S) with the series axis
minor.  A CPU tensor takes ``extract_fields64_t_plain`` (two ``gather``s
and a funnel shift); a CUDA tensor launches the hand-written kernel
``csrc/extract_fields.cu`` or raises.  The clipping matches the
reference exactly: word index ``clamp(off >> 6, 0, W - 2)``, width 0
gives 0, widths of 64 (or outside [0, 64]) the whole 64-bit window, and
offsets past a stream read its zero padding.
"""

from __future__ import annotations

import ctypes

import torch

from m3_tpu_torch._bits import funnel, shr
from m3_tpu_torch.parallel import _cuda
from m3_tpu_torch.x import devseams

KERNEL = "extract_fields"
launches = 0  # kernel launches since the last reset (the wrappers' count)


def _check(words_t, offs_t, widths_t):
    if words_t.dtype != torch.int64:
        raise TypeError(f"extract_fields64_t wants int64 words, got {words_t.dtype}")
    if offs_t.dtype != torch.int32 or widths_t.dtype != torch.int32:
        raise TypeError("extract_fields64_t wants int32 offsets and widths, got "
                        f"{offs_t.dtype} and {widths_t.dtype}")
    if (words_t.dim() != 2 or offs_t.dim() != 2 or offs_t.shape != widths_t.shape
            or offs_t.shape[1] != words_t.shape[1]):
        raise ValueError(
            f"extract_fields64_t wants (W, S) words and (F, S) offsets/widths, "
            f"got {tuple(words_t.shape)}, {tuple(offs_t.shape)}, "
            f"{tuple(widths_t.shape)}")
    if words_t.shape[0] < 2:
        raise ValueError("extract_fields64_t needs >= 2 words (zero padded)")
    if not (words_t.device == offs_t.device == widths_t.device):
        raise ValueError("extract_fields64_t: inputs on different devices")


def extract_fields64_t_plain(words_t, offs_t, widths_t):
    """Plain PyTorch version of ``pallas_decode.extract_fields64_t``."""
    W = words_t.shape[0]
    w = (offs_t >> 6).clamp(0, W - 2).long()
    wa = torch.gather(words_t, 0, w)
    wb = torch.gather(words_t, 0, w + 1)
    big = funnel(wa, wb, (offs_t & 63).long())
    wu = widths_t.long()
    wu = torch.where((wu < 0) | (wu > 64), 64, wu)
    return shr(big, 64 - wu)


def _lib():
    lib = _cuda.load(KERNEL)
    fn = lib.m3_extract_fields64_t
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def extract_fields64_t(words_t, offs_t, widths_t):
    """(W, S) int64 words, (F, S) int32 offsets and widths -> (F, S)
    int64 fields.  CPU tensors: the plain version; CUDA tensors: the
    kernel (one thread per lane)."""
    global launches
    _check(words_t, offs_t, widths_t)
    if words_t.device.type == "cpu":
        return extract_fields64_t_plain(words_t, offs_t, widths_t)
    if words_t.device.type != "cuda":
        raise ValueError(f"extract_fields64_t: no kernel for device {words_t.device}")
    if not (words_t.is_contiguous() and offs_t.is_contiguous()
            and widths_t.is_contiguous()):
        raise ValueError("extract_fields64_t: inputs must be contiguous")
    W, S = words_t.shape
    F = offs_t.shape[0]
    out = torch.empty((F, S), dtype=torch.int64, device=words_t.device)
    if F * S == 0:
        return out
    lib = _lib()
    with torch.cuda.device(words_t.device):  # the runtime launches on the current device
        rc = lib.m3_extract_fields64_t(
            words_t.data_ptr(), offs_t.data_ptr(), widths_t.data_ptr(),
            out.data_ptr(), W, F, S,
            torch.cuda.current_stream(words_t.device).cuda_stream)
    _cuda.check(lib, rc, "extract_fields64_t")
    launches += 1
    devseams.launched(KERNEL, 1)
    return out
