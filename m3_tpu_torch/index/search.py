"""Boolean query AST + executor over segments.  The counterpart of
``m3_tpu/index/search.py``.

Equivalent of `src/m3ninx/search` (query AST term/regexp/conjunction/
disjunction/negation/field/all in `search/query/`, searchers in
`search/searcher/`, executor over segments).  Leaf queries resolve
postings from each segment's term tables; interior nodes combine them —
on device as dense bitset AND/OR/ANDNOT (`postings.py`) when the doc
space is large, plain sorted-array ops otherwise.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from m3_tpu_torch import resolve_device
from m3_tpu_torch._bits import torch_to_u64, u64_to_torch
from m3_tpu_torch.index import postings as ps
from m3_tpu_torch.index.segment import SealedSegment

# Above this many docs the executor switches to device bitsets.
DEVICE_BITSET_THRESHOLD = 1 << 16


class Query:
    pass


@dataclass(frozen=True)
class All(Query):
    pass


@dataclass(frozen=True)
class Term(Query):
    field: bytes
    value: bytes


@dataclass(frozen=True)
class Regexp(Query):
    field: bytes
    pattern: bytes


@dataclass(frozen=True)
class FieldExists(Query):
    field: bytes


@dataclass(frozen=True)
class Conjunction(Query):
    queries: tuple

    def __init__(self, *queries: Query):
        object.__setattr__(self, "queries", tuple(queries))


@dataclass(frozen=True)
class Disjunction(Query):
    queries: tuple

    def __init__(self, *queries: Query):
        object.__setattr__(self, "queries", tuple(queries))


@dataclass(frozen=True)
class Negation(Query):
    query: Query


def _leaf_postings(seg: SealedSegment, q: Query) -> np.ndarray:
    if isinstance(q, All):
        return seg.postings_all()
    if isinstance(q, Term):
        return seg.postings_term(q.field, q.value)
    if isinstance(q, Regexp):
        return seg.postings_regexp(q.field, q.pattern)
    if isinstance(q, FieldExists):
        return seg.postings_field(q.field)
    raise TypeError(f"not a leaf query: {q}")


def execute_segment(seg: SealedSegment, q: Query, device=None) -> np.ndarray:
    """Postings (sorted doc ids) matching q within one segment.  A
    segment of ``DEVICE_BITSET_THRESHOLD`` docs or more is evaluated as
    bitsets on ``device`` (None means CUDA, which raises without one);
    a smaller one on the host."""
    n = seg.num_docs
    if n >= DEVICE_BITSET_THRESHOLD:
        words = _exec_bitset(seg, q, n, resolve_device(device))
        return ps.from_bitset(torch_to_u64(words), n)
    return _exec_host(seg, q)


def _exec_host(seg: SealedSegment, q: Query) -> np.ndarray:
    if isinstance(q, Conjunction):
        if not q.queries:
            return seg.postings_all()
        out = _exec_host(seg, q.queries[0])
        for sub in q.queries[1:]:
            if isinstance(sub, Negation):
                out = ps.difference_sorted(out, _exec_host(seg, sub.query))
            else:
                out = ps.intersect_sorted(out, _exec_host(seg, sub))
        return out
    if isinstance(q, Disjunction):
        out = np.empty(0, np.int32)
        for sub in q.queries:
            out = ps.union_sorted(out, _exec_host(seg, sub))
        return out.astype(np.int32)
    if isinstance(q, Negation):
        return ps.difference_sorted(seg.postings_all(), _exec_host(seg, q.query))
    return _leaf_postings(seg, q)


def _exec_bitset(seg: SealedSegment, q: Query, num_docs: int,
                 device: torch.device) -> torch.Tensor:
    """Device bitset evaluation: leaves materialize as word tensors
    (u64 bits on int64), and interior nodes are elementwise word ops."""
    if isinstance(q, Conjunction):
        out = None
        for sub in q.queries:
            w = _exec_bitset(seg, sub, num_docs, device)
            out = w if out is None else ps.bs_and(out, w)
        if out is None:
            return u64_to_torch(ps.to_bitset(seg.postings_all(), num_docs), device)
        return out
    if isinstance(q, Disjunction):
        out = None
        for sub in q.queries:
            w = _exec_bitset(seg, sub, num_docs, device)
            out = w if out is None else ps.bs_or(out, w)
        if out is None:
            return torch.zeros((num_docs + 63) // 64, dtype=torch.int64,
                               device=device)
        return out
    if isinstance(q, Negation):
        return ps.bs_not(_exec_bitset(seg, q.query, num_docs, device), num_docs)
    return u64_to_torch(ps.to_bitset(_leaf_postings(seg, q), num_docs), device)


def execute(segments: list[SealedSegment], q: Query,
            device=None) -> list[tuple[int, np.ndarray]]:
    """(segment index, postings) per segment — doc spaces are per-segment,
    as in the reference's multi-segment executor."""
    return [(i, execute_segment(s, q, device)) for i, s in enumerate(segments)]
