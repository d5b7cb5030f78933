"""Device programs for the query engine's per-step functions.  The
counterpart of ``m3_tpu/query/device_fns.py``.

Grouped quantile, topk/bottomk masks, histogram_quantile and vector
matching, each one array program over the whole (series x step) block.
Ragged group structure is handled with padded gather plans: the host
builds (G, R_max) index matrices once (tag work it owns anyway) and the
device runs on dense (G, R_max, T) tensors with masks.

Every function takes ``values`` as a tensor on the caller's device; the
plans travel to that device with it.
"""

from __future__ import annotations

import numpy as np
import torch

from m3_tpu_torch.query import precision

NAN = float("nan")
INF = float("inf")


# ---------------------------------------------------------------------------
# Padded group gather plans (host)
# ---------------------------------------------------------------------------


def group_plan(gids: np.ndarray, num_groups: int):
    """(row_idx (G, R_max), mask (G, R_max)) gathering each group's rows."""
    order = np.argsort(gids, kind="stable")
    sorted_g = gids[order]
    starts = np.searchsorted(sorted_g, np.arange(num_groups))
    ends = np.searchsorted(sorted_g, np.arange(num_groups), side="right")
    counts = ends - starts
    r_max = max(1, int(counts.max(initial=0)))
    idx = np.zeros((num_groups, r_max), np.int32)
    mask = np.zeros((num_groups, r_max), bool)
    for g in range(num_groups):
        c = counts[g]
        idx[g, :c] = order[starts[g] : ends[g]]
        mask[g, :c] = True
    return idx, mask


def _dev(x, device, dtype=None):
    return torch.as_tensor(np.asarray(x), device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# Grouped quantile  (quantile(0.9, x) by (...))
# ---------------------------------------------------------------------------


def _group_quantile_kernel(values, idx, mask, q):
    """(S, T), (G, R), (G, R) -> (G, T) linear-interpolated quantile over
    the present (non-NaN) rows, as numpy's nanquantile 'linear'."""
    rows = values[idx]  # (G, R, T)
    present = mask[:, :, None] & ~torch.isnan(rows)
    s = torch.sort(torch.where(present, rows, INF), dim=1).values
    del rows
    n = present.sum(dim=1)  # (G, T)
    h = q * (n - 1).to(values.dtype)
    R = s.shape[1]
    lo = torch.floor(h).long().clamp(0, R - 1)
    hi = torch.ceil(h).long().clamp(0, R - 1)
    v_lo = torch.gather(s, 1, lo[:, None, :])[:, 0, :]
    v_hi = torch.gather(s, 1, hi[:, None, :])[:, 0, :]
    frac = h - torch.floor(h)
    out = v_lo + (v_hi - v_lo) * frac
    return torch.where(n > 0, out, NAN)


def group_quantile(values, gids: np.ndarray, num_groups: int, q: float):
    dt = precision.compute_torch_dtype()
    idx, mask = group_plan(gids, num_groups)
    dev = values.device
    return _group_quantile_kernel(
        values.to(dt), _dev(idx, dev, torch.int64), _dev(mask, dev),
        torch.tensor(q, dtype=dt, device=dev),
    ).to(torch.float64)


# ---------------------------------------------------------------------------
# topk / bottomk
# ---------------------------------------------------------------------------


def _topk_mask_kernel(values, idx, mask, inv_g, inv_r, k: int, top: bool):
    """Keep-mask (S, T): True where the row is among the k extreme of its
    group at that step."""
    rows = values[idx]  # (G, R, T)
    # Present = in the group and not NaN; +-Inf are real sample values
    # and compete for rank slots (Prometheus topk keeps Inf).
    present = mask[:, :, None] & ~torch.isnan(rows)
    key = torch.where(present, rows, -INF if top else INF)
    del rows
    s = torch.sort(key, dim=1).values
    R = s.shape[1]
    # kth extreme per (group, step); groups with < k present rows keep all
    kth = s[:, max(R - k, 0), :] if top else s[:, min(k - 1, R - 1), :]
    keep_g = (key >= kth[:, None, :]) if top else (key <= kth[:, None, :])
    keep_g &= present
    # (G, R, T) back to (S, T) by a gather through the inverse mapping
    return keep_g[inv_g, inv_r, :]


def topk_mask(values, gids: np.ndarray, num_groups: int, k: int, top: bool):
    idx, mask = group_plan(gids, num_groups)
    # the inverse of group_plan, derived from its own output: series
    # idx[g, r] sits at rank r of group g
    S = len(gids)
    rows, cols = np.nonzero(mask)
    inv_r = np.empty(S, np.int64)
    inv_r[idx[rows, cols]] = cols
    dev = values.device
    return _topk_mask_kernel(values, _dev(idx, dev, torch.int64), _dev(mask, dev),
                             _dev(gids, dev, torch.int64), _dev(inv_r, dev),
                             k=int(k), top=bool(top))


# ---------------------------------------------------------------------------
# histogram_quantile
# ---------------------------------------------------------------------------


def _histogram_quantile_kernel(values, idx, nbuckets, ubs, q):
    """values (S, T); idx (G, B) int64 row index per bucket rank
    (le-ascending, +Inf last when present); nbuckets (G,); ubs (G, B)
    upper bounds (inf-padded).  Returns (G, T).

    The reference math (``linear/histogram_quantile.go``): cumulative
    counts clamped monotone, rank = q * total, linear interpolation
    inside the first bucket reaching the rank, the +Inf bucket answered
    by the highest finite bound."""
    G, B = idx.shape
    rows = values[idx]  # (G, B, T)
    bpos = torch.arange(B, device=values.device)[None, :]
    valid = bpos < nbuckets[:, None]  # (G, B)
    counts = torch.where(valid[:, :, None], torch.nan_to_num(rows), 0.0)
    counts = torch.cummax(counts, dim=1).values
    # total comes from the raw +Inf-bucket sample: a NaN there must
    # propagate to a NaN result
    last = (nbuckets - 1).clamp(0, B - 1).long()
    total = torch.gather(rows, 1, last[:, None, None].expand(G, 1, rows.shape[2]))[:, 0, :]
    del rows
    rank = q * total
    ge = (counts >= rank[:, None, :]) & valid[:, :, None]
    first = torch.argmax(ge.to(torch.uint8), dim=1)  # (G, T): first True
    del ge

    def take(a, i):
        return torch.gather(a, 1, i[:, None, :])[:, 0, :]

    b_hi = torch.gather(ubs, 1, first)
    prev = (first - 1).clamp_min(0)
    b_lo = torch.where(first > 0, torch.gather(ubs, 1, prev), 0.0)
    c_hi = take(counts, first)
    c_lo = torch.where(first > 0, take(counts, prev), 0.0)
    frac = torch.where(c_hi > c_lo, (rank - c_lo) / (c_hi - c_lo), 0.0)
    val = b_lo + (b_hi - b_lo) * frac
    # the +Inf bucket -> highest finite bound; a group with only the
    # +Inf bucket has no finite bound and answers 0.0
    hf_idx = (nbuckets - 2).clamp(0, B - 1).long()
    highest_finite = torch.where((nbuckets >= 2)[:, None],
                                 torch.gather(ubs, 1, hf_idx[:, None]), 0.0)
    val = torch.where(torch.isinf(b_hi), highest_finite, val)
    bad = (total == 0) | torch.isnan(total)
    return torch.where(bad, NAN, val)


def histogram_quantile_groups(values, group_rows: list, group_ubs: list,
                              q: float):
    """group_rows[g] = row indices le-ascending (+Inf last); group_ubs[g]
    the matching upper bounds.  Returns (G, T) float64."""
    G = len(group_rows)
    B = max(len(r) for r in group_rows)
    idx = np.zeros((G, B), np.int64)
    ubs = np.full((G, B), np.inf)
    nb = np.zeros(G, np.int64)
    for g, (rows, u) in enumerate(zip(group_rows, group_ubs)):
        idx[g, : len(rows)] = rows
        ubs[g, : len(u)] = u
        nb[g] = len(rows)
    dt = precision.compute_torch_dtype()
    dev = values.device
    return _histogram_quantile_kernel(
        values.to(dt), _dev(idx, dev), _dev(nb, dev), _dev(ubs, dev, dt),
        torch.tensor(q, dtype=dt, device=dev),
    ).to(torch.float64)


# ---------------------------------------------------------------------------
# Binary ops with vector matching
# ---------------------------------------------------------------------------

COMPARISONS = {"==", "!=", ">", "<", ">=", "<="}

# ``%`` is floored, as jnp.mod and numpy's mod are: torch.remainder.
BINOPS = {
    "+": torch.add, "-": torch.sub, "*": torch.mul,
    "/": torch.div, "%": torch.remainder, "^": torch.pow,
    "==": torch.eq, "!=": torch.ne, ">": torch.gt,
    "<": torch.lt, ">=": torch.ge, "<=": torch.le,
}


def _vector_binary_kernel(lv, rv, op: str, bool_mode: bool):
    out = BINOPS[op](lv, rv).to(lv.dtype)
    if op in COMPARISONS and not bool_mode:
        out = torch.where(out != 0, lv, NAN)
    miss = torch.isnan(lv) | torch.isnan(rv)
    return torch.where(miss, NAN, out)


def vector_binary_matched(l_values, r_values, rows_l, rows_r, op: str,
                          bool_mode: bool):
    """Gather the matched rows on the device and apply the op.

    Comparisons are exempt from the f32 policy: narrowing before ==/>/<
    flips results for float64-distinct operands (16777217.0 and
    16777216.0 collide in f32).  Only the arithmetic ops narrow."""
    dt = torch.float64 if op in COMPARISONS else precision.compute_torch_dtype()
    dev = l_values.device
    lv = l_values.to(dt)[_dev(rows_l, dev, torch.int64)]
    rv = r_values.to(dt)[_dev(rows_r, dev, torch.int64)]
    return _vector_binary_kernel(lv, rv, op=op, bool_mode=bool_mode).to(torch.float64)
