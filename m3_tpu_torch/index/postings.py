"""Postings lists: sorted doc-ID arrays on host, bitset algebra on the
device.  The counterpart of ``m3_tpu/index/postings.py``.

A postings list is a sorted int32 numpy array (built and serialized on
the host); query-time set algebra runs on the device as dense bitset ops
over word tensors.  The u64 words travel as ``int64`` tensors holding the
same 64 bits (``m3_tpu_torch/_bits.py``): ``&``, ``|`` and ``~`` are the
same on both carriers, the all-ones word is -1, and the popcount shifts
logically.
"""

from __future__ import annotations

import numpy as np
import torch

from m3_tpu_torch._bits import shr


def to_bitset(postings: np.ndarray, num_docs: int) -> np.ndarray:
    """Sorted doc-id array -> uint64 bitset words."""
    nwords = (num_docs + 63) // 64
    words = np.zeros(nwords, np.uint64)
    if len(postings):
        np.bitwise_or.at(
            words,
            postings // 64,
            np.uint64(1) << (postings % 64).astype(np.uint64),
        )
    return words


def from_bitset(words: np.ndarray, num_docs: int | None = None) -> np.ndarray:
    """Bitset words -> sorted doc-id array."""
    words = np.asarray(words, np.uint64)
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    ids = np.nonzero(bits)[0]
    if num_docs is not None:
        ids = ids[ids < num_docs]
    return ids.astype(np.int32)


def bs_and(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a & b


def bs_or(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a | b


def bs_andnot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a & ~b


def bs_not(a: torch.Tensor, num_docs: int) -> torch.Tensor:
    """Complement within ``num_docs``: full words below the tail word,
    the tail word's low ``num_docs % 64`` bits, nothing past it."""
    nwords = a.shape[-1]
    w = torch.arange(nwords, device=a.device)
    tail_bits = num_docs % 64
    tail = (1 << tail_bits) - 1 if tail_bits else 0
    mask = torch.where(
        w < num_docs // 64, -1,
        torch.where(w == num_docs // 64, tail, 0)).to(a.dtype)
    return (~a) & mask


def bs_any_and(queries: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """(Q, W) & (W,) -> (Q,) does-intersect flags: batched pre-filter for
    multi-clause queries."""
    return ((queries & target[None, :]) != 0).any(dim=1)


def _popcount64(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each u64 word (SWAR; logical shifts, so the sign bit
    counts as any other)."""
    x = x - (shr(x, 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + (shr(x, 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F  # each byte <= 8: non-negative
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return x & 0x7F


def bs_count(a: torch.Tensor) -> torch.Tensor:
    """Population count per bitset (row-wise if 2-D), int64."""
    return _popcount64(a).sum(dim=-1)


def intersect_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.intersect1d(a, b, assume_unique=True)


def union_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.union1d(a, b)


def difference_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.setdiff1d(a, b, assume_unique=True)
