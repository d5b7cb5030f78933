"""Independent naive PromQL evaluator: the comparator's oracle, the
counterpart of ``m3_tpu/comparator/naive_promql.py``.

The reference cross-validates its query engine against a real
Prometheus (`src/cmd/services/m3comparator` + `scripts/comparator`
diff identical queries).  With no Prometheus binary at hand, the oracle
is an INDEPENDENT reimplementation of PromQL semantics: straight-line
Python over point lists, sharing no code with the port's engine
(`m3_tpu_torch/query/engine.py` — tensor programs over blocks).  Two
implementations built from the spec disagreeing = a bug in one of
them; that is the comparator's signal.  Pure Python: no torch, no
numpy, and nothing of the engine (its parser, its values).

Supported subset (matches the corpus in ``harness.py``): instant
selectors with equality matchers, rate/increase/delta over range
selectors (Prometheus extrapolated-rate semantics), avg/min/max/sum/
count_over_time, sum/avg/min/max/count aggregation with by(), scalar
arithmetic, and lookback staleness for instant selectors.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass

LOOKBACK_NANOS = 5 * 60 * 10**9
NAN = float("nan")


@dataclass(frozen=True)
class NaiveSeries:
    tags: tuple  # sorted ((k, v), ...)
    points: tuple  # ((t_nanos, value), ...) time-sorted


def _tags_dict(tags: tuple) -> dict:
    return dict(tags)


# -- selector evaluation -----------------------------------------------------


def _instant_value(points, t: int) -> float:
    """Most recent sample at or before t within lookback (staleness)."""
    best = None
    for pt, pv in points:
        if pt <= t:
            best = (pt, pv)
        else:
            break
    if best is None or t - best[0] > LOOKBACK_NANOS:
        return NAN
    return best[1]


def _window_points(points, t: int, window: int):
    """Samples in (t-window, t] — Prometheus range selector."""
    return [(pt, pv) for pt, pv in points if t - window < pt <= t]


def _extrapolated(points, t: int, window: int, counter: bool,
                  as_rate: bool) -> float:
    """Prometheus extrapolated rate/increase/delta
    (promql/functions.go extrapolatedRate), written independently:
    cumulative counter-reset correction, extrapolation to the window
    edges unless the gap exceeds 1.1x the average sample spacing (then
    half an interval), counter zero-crossing cap using the RAW first
    sample.  All durations in nanos until the final division."""
    w = _window_points(points, t, window)
    if len(w) < 2:
        return NAN
    first_t, first_v_raw = w[0]
    last_t = w[-1][0]
    if counter:
        correction = 0.0
        prev = first_v_raw
        for _, v in w[1:]:
            if v < prev:
                correction += prev
            prev = v
        delta_v = (w[-1][1] + correction) - first_v_raw
    else:
        delta_v = w[-1][1] - w[0][1]
    sampled = last_t - first_t  # nanos
    if sampled <= 0:
        return NAN
    avg_dur = sampled / (len(w) - 1)
    dur_start = first_t - (t - window)
    dur_end = t - last_t
    extrap_start = dur_start if dur_start < avg_dur * 1.1 else avg_dur / 2
    extrap_end = dur_end if dur_end < avg_dur * 1.1 else avg_dur / 2
    if counter and delta_v > 0 and first_v_raw >= 0:
        zero_dur = sampled * (first_v_raw / delta_v)
        extrap_start = min(extrap_start, zero_dur)
    result = delta_v * (sampled + extrap_start + extrap_end) / sampled
    if as_rate:
        result /= window / 1e9
    return result


_OVER_TIME = {
    "avg_over_time": lambda vs: sum(vs) / len(vs),
    "min_over_time": min,
    "max_over_time": max,
    "sum_over_time": sum,
    "count_over_time": len,
    "last_over_time": lambda vs: vs[-1],
}


# -- tiny query parser (independent of the engine's query/promql.py) -------


_SEL_RE = re.compile(
    r"^(?P<fn>[a-z_0-9]+\()?\s*(?P<name>[A-Za-z_:][A-Za-z0-9_:]*)"
    r"(?:\{(?P<matchers>[^}]*)\})?"
    r"(?:\[(?P<window>\d+)(?P<wunit>[smh])\])?\s*\)?"
)


@dataclass
class NaiveQuery:
    func: str | None          # rate/increase/delta/*_over_time or None
    name: str
    matchers: dict            # {tag: value} equality only
    window_nanos: int
    agg: str | None = None    # sum/avg/min/max/count
    by: tuple = ()
    scalar_op: str | None = None
    scalar: float = 0.0


_UNIT = {"s": 10**9, "m": 60 * 10**9, "h": 3600 * 10**9}


def parse_naive(q: str) -> NaiveQuery:
    """Parses the comparator corpus's shapes:
    [agg by (labels)] ([fn(] name{matchers}[window] [)]) [op scalar]"""
    q = q.strip()
    agg = None
    by: tuple = ()
    m = re.match(r"^(sum|avg|min|max|count)(?:\s+by\s*\(([^)]*)\))?\s*\(", q)
    inner = q
    tail = ""
    if m:
        agg = m.group(1)
        if m.group(2):
            by = tuple(s.strip() for s in m.group(2).split(",") if s.strip())
        inner = q[m.end() - 1 :].strip()
        # strip the outer parens
        assert inner.startswith("(")
        depth = 0
        closed = False
        for i, c in enumerate(inner):
            depth += c == "("
            depth -= c == ")"
            if depth == 0:
                tail = inner[i + 1 :].strip()
                inner = inner[1:i].strip()
                closed = True
                break
        if not closed:
            raise ValueError(f"naive parser cannot handle {q!r} (unbalanced)")
    else:
        tail = ""
        # scalar op at top level: name{...} / 2 etc
        sm = re.search(r"([+\-*/])\s*([\d.]+)\s*$", q)
        if sm and "(" not in q[sm.start():]:
            tail = q[sm.start():]
            inner = q[: sm.start()].strip()

    scalar_op = None
    scalar = 0.0
    if tail:
        sm = re.match(r"^([+\-*/])\s*([\d.]+)$", tail.strip())
        if sm:
            scalar_op = sm.group(1)
            scalar = float(sm.group(2))

    func = None
    fm = re.match(r"^([a-z_0-9]+)\(\s*(.*)\s*\)$", inner)
    if fm and fm.group(1) in (
        "rate", "increase", "delta", *_OVER_TIME
    ):
        func = fm.group(1)
        inner = fm.group(2)
    sm = _SEL_RE.match(inner)
    if not sm:
        raise ValueError(f"naive parser cannot handle {q!r}")
    matchers = {}
    if sm.group("matchers"):
        for part in sm.group("matchers").split(","):
            k, _, v = part.partition("=")
            matchers[k.strip()] = v.strip().strip('"')
    window = 0
    if sm.group("window"):
        window = int(sm.group("window")) * _UNIT[sm.group("wunit")]
    return NaiveQuery(func, sm.group("name"), matchers, window, agg, by,
                      scalar_op, scalar)


# -- evaluation -------------------------------------------------------------


def evaluate(query: str, series: list[NaiveSeries], start: int, end: int,
             step: int) -> dict[tuple, list[float]]:
    """{output_tags: [value per step]} over [start, end] inclusive."""
    nq = parse_naive(query)
    steps = list(range(start, end + 1, step))

    selected = []
    for s in series:
        tags = _tags_dict(s.tags)
        if tags.get(b"__name__", b"").decode() != nq.name:
            continue
        if any(tags.get(k.encode(), b"").decode() != v
               for k, v in nq.matchers.items()):
            continue
        selected.append(s)

    per_series: list[tuple[tuple, list[float]]] = []
    for s in selected:
        vals = []
        for t in steps:
            if nq.func in ("rate", "increase"):
                v = _extrapolated(s.points, t, nq.window_nanos, True,
                                  nq.func == "rate")
            elif nq.func == "delta":
                v = _extrapolated(s.points, t, nq.window_nanos, False, False)
            elif nq.func in _OVER_TIME:
                w = [pv for _, pv in
                     _window_points(s.points, t, nq.window_nanos)]
                v = _OVER_TIME[nq.func](w) if w else NAN
            else:
                v = _instant_value(s.points, t)
            vals.append(v)
        out_tags = tuple(
            (k, v) for k, v in s.tags
            if nq.func is None and nq.agg is None or k != b"__name__"
        )
        per_series.append((out_tags, vals))

    if nq.agg is not None:
        groups: dict[tuple, list[list[float]]] = {}
        for tags, vals in per_series:
            td = _tags_dict(tags)
            key = tuple((b, td[b]) for b in
                        (k.encode() for k in sorted(nq.by)) if b in td)
            groups.setdefault(key, []).append(vals)
        out: dict[tuple, list[float]] = {}
        for key, rows in groups.items():
            agg_vals = []
            for i in range(len(steps)):
                col = [r[i] for r in rows if not math.isnan(r[i])]
                if not col:
                    agg_vals.append(NAN)
                elif nq.agg == "sum":
                    agg_vals.append(sum(col))
                elif nq.agg == "avg":
                    agg_vals.append(sum(col) / len(col))
                elif nq.agg == "min":
                    agg_vals.append(min(col))
                elif nq.agg == "max":
                    agg_vals.append(max(col))
                else:
                    agg_vals.append(float(len(col)))
            out[key] = agg_vals
        result = out
    else:
        result = dict(per_series)

    if nq.scalar_op:
        op = nq.scalar_op
        f = {"+": lambda a: a + nq.scalar, "-": lambda a: a - nq.scalar,
             "*": lambda a: a * nq.scalar, "/": lambda a: a / nq.scalar}[op]
        result = {
            k: [f(v) if not math.isnan(v) else NAN for v in vs]
            for k, vs in result.items()
        }
    return result
