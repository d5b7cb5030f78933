"""Segmented scans over sorted batches.  The counterpart of
``m3_tpu/parallel/segmented.py``, plus the scan itself.

``associative_scan`` mirrors ``jax.lax.associative_scan`` step for step,
so a float lane rounds exactly as the reference's does: the same tree of
``combine`` calls (pair ``e[0:-1:2]`` with ``e[1::2]``, recurse, combine
the odd results with ``e[2::2]``, prepend ``e[0]``, interleave).  jax
interleaves by adding two zero-padded arrays, so every float element of
the result has had ``+ 0.0`` applied: a ``-0.0`` comes out as ``+0.0``.
The mirror does the same (``_interleave``).  A combine that contracts a
product into an FMA under XLA (a lane of squares computed inside the
same jit) rounds differently from the separate multiply here; callers
that need bit-equality pass such lanes in materialised.

``head_flag_scan`` and ``last_occurrence`` are the reference's
segmented reduction and its gather side; the query functions build
their grouped aggregations on them.
"""

from __future__ import annotations

import torch


def _interleave(first, even, odd):
    """``[first, odd[0], even[0], odd[1], even[1], ...]``: the scan's
    result from its first element, its even results (positions 2, 4,
    ...) and its odd results (positions 1, 3, ...).  Three writes into
    one allocation.  Float lanes take ``+ 0.0`` on the way, as jax's
    pad-and-add interleave does."""
    n = 1 + even.shape[0] + odd.shape[0]
    out = torch.empty((n,) + tuple(first.shape[1:]), dtype=first.dtype,
                      device=first.device)
    if first.dtype.is_floating_point:
        torch.add(first, 0.0, out=out[0:1])
        torch.add(even, 0.0, out=out[2::2])
        torch.add(odd, 0.0, out=out[1::2])
    else:
        out[0:1] = first
        out[2::2] = even
        out[1::2] = odd
    return out


def associative_scan(combine, elems):
    """Inclusive scan of the tuple of tensors ``elems`` along dim 0 with
    the associative ``combine(a, b) -> tuple``, in jax's tree order (see
    the module docstring).  About log2(n) levels, each two combines and
    one interleave per lane."""
    elems = tuple(elems)

    def scan(e):
        n = e[0].shape[0]
        if n < 2:
            return e
        odd = scan(tuple(combine(tuple(x[0:-1:2] for x in e),
                                 tuple(x[1::2] for x in e))))
        rest = tuple(x[2::2] for x in e)
        if n % 2 == 0:
            even = combine(tuple(x[:-1] for x in odd), rest)
        else:
            even = combine(odd, rest)
        return tuple(_interleave(x[:1], ev, od) for x, ev, od in zip(e, even, odd))

    return scan(elems)


def head_flag_scan(is_start, adds=(), mins=(), maxs=()):
    """Inclusive segmented reduction via one associative scan.

    ``is_start`` (N,) bool marks segment heads of the already-sorted
    batch.  Each tensor in ``adds``/``mins``/``maxs`` — shape (N,) or
    (N, ...) — is reduced with +/min/max within segments; position i of
    a result holds the reduction of its segment's prefix up to i, so the
    LAST position of a segment holds the segment total.  Returns (adds,
    mins, maxs) tuples in the caller's order.  min/max propagate NaN, as
    ``jnp.minimum`` / ``jnp.maximum`` do; which zero wins a -0/+0 tie
    cannot show, since the scan returns +0 for every zero."""
    n_adds, n_mins = len(adds), len(mins)

    def comb(a, b):
        fa, fb = a[0], b[0]
        out = [fa | fb]

        def sel(yes, no):
            return torch.where(fb.reshape(fb.shape + (1,) * (yes.dim() - 1)), yes, no)

        for j in range(1, len(a)):
            if j <= n_adds:
                r = a[j] + b[j]
            elif j <= n_adds + n_mins:
                r = torch.minimum(a[j], b[j])
            else:
                r = torch.maximum(a[j], b[j])
            out.append(sel(b[j], r))
        return tuple(out)

    res = associative_scan(comb, (is_start,) + tuple(adds) + tuple(mins) + tuple(maxs))
    return (res[1:1 + n_adds], res[1 + n_adds:1 + n_adds + n_mins],
            res[1 + n_adds + n_mins:])


def last_occurrence(sorted_keys, queries):
    """(position, found) of the last occurrence of each query in
    ``sorted_keys`` — the gather side of the merge.  Positions are
    clamped valid so callers can gather unconditionally and mask with
    ``found``."""
    n = sorted_keys.shape[0]
    pos = torch.searchsorted(sorted_keys, queries, right=True) - 1
    pos_c = pos.clamp(0, max(n - 1, 0))
    if n == 0:
        return pos_c, torch.zeros_like(queries, dtype=torch.bool)
    found = (pos >= 0) & (sorted_keys[pos_c] == queries)
    return pos_c, found
