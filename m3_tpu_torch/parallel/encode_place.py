"""Encode phase-2 word placement: the counterpart of
``m3_tpu/parallel/pallas_encode.py`` (``place_words``).

``place_words`` assembles (S, W) stream words from (S, F) u64 fragments
at per-series word keys.  A CPU tensor takes ``place_words_plain`` (a
masked ``scatter_add_``); a CUDA tensor launches the hand-written kernel
``csrc/place_words.cu`` or raises.  Fragments of one series occupy
disjoint bit ranges (the M3TSZ lane contract), so sum, OR and the TPU
kernel's carry-free u32 sums all agree; keys outside [0, W) are dropped.
"""

from __future__ import annotations

import ctypes

import torch

from m3_tpu_torch.parallel import _cuda
from m3_tpu_torch.x import devseams

KERNEL = "place_words"
launches = 0  # kernel launches since the last reset (the wrappers' count)


def _check(frags, keys, out_words):
    if frags.dtype != torch.int64 or keys.dtype != torch.int32:
        raise TypeError(f"place_words wants int64 frags and int32 keys, got "
                        f"{frags.dtype} and {keys.dtype}")
    if frags.dim() != 2 or frags.shape != keys.shape:
        raise ValueError(f"place_words wants matching (S, F) frags and keys, "
                         f"got {tuple(frags.shape)} and {tuple(keys.shape)}")
    if frags.device != keys.device:
        raise ValueError("place_words: frags and keys on different devices")
    if out_words < 1:
        raise ValueError(f"place_words: out_words={out_words} < 1")


def place_words_plain(frags, keys, out_words: int):
    """Plain PyTorch version: mask out-of-range keys, then scatter-add
    (bit-disjoint fragments never carry, so add == OR)."""
    ok = (keys >= 0) & (keys < out_words)
    out = torch.zeros((frags.shape[0], out_words), dtype=torch.int64,
                      device=frags.device)
    return out.scatter_add_(1, keys.clamp(0, out_words - 1).long(),
                            torch.where(ok, frags, 0))


def _lib():
    lib = _cuda.load(KERNEL)
    fn = lib.m3_place_words
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def place_words(frags, keys, out_words: int):
    """(S, F) int64 fragments at (S, F) int32 word keys -> (S, out_words)
    int64 words.  CPU tensors: the plain version; CUDA tensors: the
    kernel (one 64-bit ``atomicOr`` per in-range nonzero fragment)."""
    global launches
    _check(frags, keys, out_words)
    if frags.device.type == "cpu":
        return place_words_plain(frags, keys, out_words)
    if frags.device.type != "cuda":
        raise ValueError(f"place_words: no kernel for device {frags.device}")
    if not (frags.is_contiguous() and keys.is_contiguous()):
        raise ValueError("place_words: frags and keys must be contiguous")
    S, F = frags.shape
    out = torch.zeros((S, out_words), dtype=torch.int64, device=frags.device)
    if S * F == 0:
        return out
    lib = _lib()
    with torch.cuda.device(frags.device):  # the runtime launches on the current device
        rc = lib.m3_place_words(frags.data_ptr(), keys.data_ptr(), out.data_ptr(),
                                S, F, out_words,
                                torch.cuda.current_stream(frags.device).cuda_stream)
    _cuda.check(lib, rc, "place_words")
    launches += 1
    devseams.launched(KERNEL, 1)
    return out
