"""Instant-vector functions over step-aligned blocks.  The counterpart of
``m3_tpu/query/functions.py``.

Label-grouped aggregations, topk/bottomk, histogram_quantile, scalar
math, date parts, round/clamp and binary arithmetic/comparison with
vector matching, each over the (S, T) matrix.  Grouping is a host
partition of series rows (tag work stays on the host) followed by one
device reduction over the group axis.

Block values are torch tensors here; each function computes on the
device its block's values are on.
"""

from __future__ import annotations

import math
from collections import defaultdict

import numpy as np
import torch

from m3_tpu_torch.parallel import segmented as so
from m3_tpu_torch.query import device_fns
from m3_tpu_torch.query.block import Block, SeriesMeta, to_host
from m3_tpu_torch.query.temporal import true_div
from m3_tpu_torch.query.device_fns import COMPARISONS as _COMPARISONS

NAN = float("nan")
INF = float("inf")
F64 = torch.float64


# ---------------------------------------------------------------------------
# Label grouping (host): series rows -> group ids
# ---------------------------------------------------------------------------


def group_series(series: list[SeriesMeta], by: set[bytes] | None,
                 without: set[bytes] | None) -> tuple[np.ndarray, list[SeriesMeta]]:
    """Group assignment per series row + the output group metas.

    by=None, without=None -> one global group (Prometheus ``sum(x)``).
    """
    groups: dict[tuple, int] = {}
    metas: list[SeriesMeta] = []
    gids = np.zeros(len(series), np.int32)
    for i, m in enumerate(series):
        if by is not None:
            key_meta = m.keep(by)
        elif without is not None:
            key_meta = m.drop(without | {b"__name__"})
        else:
            key_meta = SeriesMeta(())
        k = key_meta.tags
        g = groups.get(k)
        if g is None:
            g = groups[k] = len(metas)
            metas.append(key_meta)
        gids[i] = g
    return gids, metas


def _segment_reduce(values, gids: np.ndarray, num_groups: int, func: str,
                    q: float = 0.0):
    """(S, T) tensor + group ids -> (G, T) float64.

    The reference's sort / segmented scan / gather form on every device:
    rows sorted by group (stable), one ``head_flag_scan`` over the
    sorted rows, the group totals gathered at each group's last row.  No
    float atomics, so the sums are the same on every run and device
    (the scatter form, ``index_add_`` on the card, is not)."""
    if func == "quantile":
        return device_fns.group_quantile(values, gids, num_groups, q)
    if func not in ("sum", "count", "avg", "stddev", "stdvar", "min", "max"):
        raise ValueError(f"unknown aggregation {func}")
    v = values.to(F64)
    dev = v.device
    if v.shape[0] == 0:
        return torch.full((num_groups, v.shape[1]), NAN, dtype=F64, device=dev)
    g = torch.as_tensor(np.asarray(gids, np.int64), device=dev)
    nan = torch.isnan(v)
    zero = torch.where(nan, 0.0, v)
    ones = (~nan).to(F64)

    order = torch.argsort(g, stable=True)
    gs = g[order]
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          gs[1:] != gs[:-1]])
    adds, mins, maxs = [], [], []
    if func in ("sum", "avg", "stddev", "stdvar"):
        adds.append(zero[order])
    if func in ("stddev", "stdvar"):
        adds.append((zero * zero)[order])
    if func == "min":
        mins.append(torch.where(nan, INF, v)[order])
    if func == "max":
        maxs.append(torch.where(nan, -INF, v)[order])
    adds.append(ones[order])  # count rides every form
    r_adds, r_mins, r_maxs = so.head_flag_scan(
        is_start, adds=tuple(adds), mins=tuple(mins), maxs=tuple(maxs))
    pos, found = so.last_occurrence(
        gs, torch.arange(num_groups, dtype=gs.dtype, device=dev))
    fm = found[:, None]

    def at_ends(seg):
        return torch.where(fm, seg[pos], 0.0)

    cnt = at_ends(r_adds[-1])
    empty = cnt == 0
    if func == "sum":
        out = at_ends(r_adds[0])
    elif func == "count":
        out = cnt
    elif func == "avg":
        out = at_ends(r_adds[0]) / torch.where(empty, 1.0, cnt)
    elif func in ("stddev", "stdvar"):
        s1, s2 = at_ends(r_adds[0]), at_ends(r_adds[1])
        mean = s1 / torch.where(empty, 1.0, cnt)
        var = torch.clamp_min(s2 / torch.where(empty, 1.0, cnt) - mean * mean, 0.0)
        out = torch.sqrt(var) if func == "stddev" else var
    elif func == "min":
        out = torch.where(fm, r_mins[0][pos], INF)
        out = torch.where(torch.isposinf(out), NAN, out)
    else:  # max
        out = torch.where(fm, r_maxs[0][pos], -INF)
        out = torch.where(torch.isneginf(out), NAN, out)
    return torch.where(empty, NAN, out)


def aggregate(block: Block, func: str, by: set[bytes] | None = None,
              without: set[bytes] | None = None, param: float = 0.0) -> Block:
    gids, metas = group_series(block.series, by, without)
    vals = _segment_reduce(block.values, gids, len(metas), func, param)
    return Block(block.step_times, vals, metas)


def topk_bottomk(block: Block, k: int, func: str,
                 by: set[bytes] | None = None,
                 without: set[bytes] | None = None) -> Block:
    """topk/bottomk keep the original series, masking all but the k
    extreme per (group, step)."""
    gids, metas = group_series(block.series, by, without)
    v = block.values
    keep = device_fns.topk_mask(v, gids, len(metas), int(k), func == "topk")
    return block.with_values(torch.where(keep, v, NAN))


# ---------------------------------------------------------------------------
# histogram_quantile
# ---------------------------------------------------------------------------


def histogram_quantile(block: Block, q: float) -> Block:
    """Per-step quantile from cumulative ``le`` buckets (reference
    linear/histogram_quantile.go: group series by tags minus le, sort the
    buckets by upper bound, interpolate linearly within the bucket)."""
    groups: dict[tuple, list[tuple[float, int]]] = defaultdict(list)
    for i, m in enumerate(block.series):
        tags = m.as_dict()
        le = tags.get(b"le")
        if le is None:
            continue
        try:
            ub = float(le)
        except ValueError:
            continue
        key = m.drop({b"le", b"__name__"}).tags
        groups[key].append((ub, i))

    T = block.num_steps
    dev = block.values.device
    metas: list[SeriesMeta] = []
    group_rows: list[list[int]] = []
    group_ubs: list[np.ndarray] = []
    nan_metas: list[SeriesMeta] = []
    for key, buckets in groups.items():
        buckets.sort()
        ubs = np.array([b[0] for b in buckets])
        if not np.isinf(ubs[-1]):
            # no +Inf bucket -> undefined (Prometheus returns NaN)
            nan_metas.append(SeriesMeta(key))
            continue
        metas.append(SeriesMeta(key))
        group_rows.append([b[1] for b in buckets])
        group_ubs.append(ubs)
    vals = None
    if group_rows:
        vals = device_fns.histogram_quantile_groups(block.values, group_rows,
                                                    group_ubs, q)
    metas += nan_metas
    if vals is None and not nan_metas:
        return Block(block.step_times, torch.zeros((0, T), dtype=F64, device=dev), [])
    if nan_metas:
        nan_blk = torch.full((len(nan_metas), T), NAN, dtype=F64, device=dev)
        vals = nan_blk if vals is None else torch.cat([vals, nan_blk])
    return Block(block.step_times, vals, metas)


# ---------------------------------------------------------------------------
# Scalar math + binary ops
# ---------------------------------------------------------------------------

def _sgn(x):
    # jnp.sign: NaN stays NaN and a zero keeps its sign (torch.sign maps
    # both to +0)
    return torch.where((x == 0) | torch.isnan(x), x, torch.sign(x))


# The engine dispatches on these keys (``f in _UNARY``).
_UNARY = {
    "abs": torch.abs,
    "ceil": torch.ceil,
    "floor": torch.floor,
    "exp": torch.exp,
    "ln": torch.log,
    "log2": torch.log2,
    "log10": torch.log10,
    "sqrt": torch.sqrt,
    "sgn": _sgn,
    # trigonometric family (Prometheus 2.31+)
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "asinh": torch.asinh, "acosh": torch.acosh, "atanh": torch.atanh,
    "deg": torch.rad2deg, "rad": torch.deg2rad,
}

# Date parts of a unix-seconds vector (Prometheus functions.go
# funcDaysInMonth..funcYear; UTC), host numpy as in the reference.  Each
# function receives the precomputed (dt, Y, M, D) datetime64 casts once.
_DATE_FNS = {
    "minute": lambda dt, Y, M, D: (dt.astype("datetime64[m]")
                                   - dt.astype("datetime64[h]")
                                   ).astype("int64"),
    "hour": lambda dt, Y, M, D: (dt.astype("datetime64[h]") - D
                                 ).astype("int64"),
    "day_of_week": lambda dt, Y, M, D: (D.astype("int64") + 4) % 7,
    "day_of_month": lambda dt, Y, M, D: (D - M).astype("int64") + 1,
    "day_of_year": lambda dt, Y, M, D: (D - Y).astype("int64") + 1,
    "days_in_month": lambda dt, Y, M, D: (
        (M + 1).astype("datetime64[D]") - M.astype("datetime64[D]")
    ).astype("int64"),
    "month": lambda dt, Y, M, D: (M - Y).astype("int64") + 1,
    "year": lambda dt, Y, M, D: Y.astype("int64") + 1970,
}


def date_fn(block: Block, func: str) -> Block:
    """Date parts on the host (one copy of the block each way)."""
    v = to_host(block.values)
    finite = np.isfinite(v)
    secs = np.where(finite, v, 0.0).astype("int64")
    dt = secs.astype("datetime64[s]")
    Y = dt.astype("datetime64[Y]")
    M = dt.astype("datetime64[M]")
    D = dt.astype("datetime64[D]")
    with np.errstate(all="ignore"):
        out = _DATE_FNS[func](dt, Y, M, D).astype(np.float64)
    # non-finite inputs (NaN gaps and +/-Inf) stay NaN
    out = np.where(finite, out, np.nan)
    return block.with_values(torch.from_numpy(out).to(block.values.device),
                             [m.drop_name() for m in block.series])


def unary_math(block: Block, func: str) -> Block:
    out = _UNARY[func](block.values.to(F64))
    return block.with_values(out, [m.drop_name() for m in block.series])


def round_fn(block: Block, to_nearest: float = 1.0) -> Block:
    # Prometheus round(): half up (floor(v + 0.5))
    v = block.values.to(F64)
    out = torch.floor(true_div(v, to_nearest) + 0.5) * to_nearest
    return block.with_values(out, [m.drop_name() for m in block.series])


def clamp(block: Block, lo: float = -math.inf, hi: float = math.inf) -> Block:
    # jnp.clip's order: the lower bound first, then the upper
    v = torch.minimum(torch.maximum(block.values.to(F64), _scalar(lo, block)),
                      _scalar(hi, block))
    return block.with_values(v, [m.drop_name() for m in block.series])


def _scalar(x, block: Block):
    """A float or a per-step (T,) array/tensor as a float64 tensor on the
    block's device."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x, np.float64)
    return torch.as_tensor(x, dtype=F64, device=block.values.device)


# The host forms (scalar op scalar in the engine), numpy's semantics;
# the device forms are ``device_fns.BINOPS`` under the same keys.
_BINOPS = {
    "+": np.add,
    "-": np.subtract,
    "*": np.multiply,
    "/": np.divide,
    "%": np.mod,
    "^": np.power,
    "==": np.equal,
    "!=": np.not_equal,
    ">": np.greater,
    "<": np.less,
    ">=": np.greater_equal,
    "<=": np.less_equal,
}


def scalar_binary(block: Block, op: str, scalar, scalar_left: bool = False,
                  bool_mode: bool = False) -> Block:
    f = device_fns.BINOPS[op]
    v = block.values.to(F64)  # comparisons stay f64
    s = _scalar(scalar, block)
    out = (f(s, v) if scalar_left else f(v, s)).to(F64)
    if op in _COMPARISONS:
        if bool_mode:
            out = torch.where(torch.isnan(v), NAN, out)  # NaN stays missing
        else:
            out = torch.where(out != 0, v, NAN)  # filter semantics
    series = block.series if op in _COMPARISONS and not bool_mode else [
        m.drop_name() for m in block.series
    ]
    return block.with_values(out, series)


def _match_key(meta: SeriesMeta, on: set[bytes] | None,
               ignoring: set[bytes] | None) -> tuple:
    if on is not None:
        return meta.keep(on).tags
    drop = {b"__name__"} | (ignoring or set())
    return meta.drop(drop).tags


def vector_binary(lhs: Block, rhs: Block, op: str,
                  on: set[bytes] | None = None,
                  ignoring: set[bytes] | None = None,
                  bool_mode: bool = False) -> Block:
    """One-to-one vector matching (reference binary/binary.go)."""
    rindex = {_match_key(m, on, ignoring): i for i, m in enumerate(rhs.series)}
    rows_l, rows_r, metas = [], [], []
    for i, m in enumerate(lhs.series):
        k = _match_key(m, on, ignoring)
        j = rindex.get(k)
        if j is None:
            continue
        rows_l.append(i)
        rows_r.append(j)
        metas.append(m.drop_name() if not (op in _COMPARISONS and not bool_mode) else m)
    if not rows_l:
        return Block(lhs.step_times,
                     torch.zeros((0, lhs.num_steps), dtype=F64,
                                 device=lhs.values.device), [])
    out = device_fns.vector_binary_matched(
        lhs.values, rhs.values, rows_l, rows_r, op, bool_mode)
    return Block(lhs.step_times, out, metas)
