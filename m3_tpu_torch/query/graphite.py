"""Graphite query engine: path expressions, function pipeline, render.

Equivalent of the reference's Graphite engine (`src/query/graphite` —
lexer/parser under `graphite/lexer`+`native`, ~100 render functions,
and the storage adapter translating dotted paths to tags
`graphite/storage`).  This is the working core of that surface: a
recursive-descent parser for nested function expressions, glob path
resolution against the inverted index via the carbon `__g{i}__` tag
convention (metrics/carbon.py), and the most-used render functions
evaluated over (series × step) arrays.

Series model: values aligned to a fixed step grid over [from, until);
each bucket takes the LAST datapoint falling in it (Graphite's
consolidation default), missing buckets are NaN.

The port's counterpart of ``m3_tpu/query/graphite.py``.  Render
functions evaluate with numpy float64 on the host in the reference's
operation order, so answers are bit-equal to the JAX engine's on the
same fetched points; the points reach the engine through the port's
``Database.query_ids`` and ``Database.read``, which run on the node's
device.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field, replace

import numpy as np

from m3_tpu_torch.index.search import (
    All, Conjunction, FieldExists, Negation, Regexp, Term,
)
from m3_tpu_torch.storage.database import ShardNotOwnedError
from m3_tpu_torch.x import deadline as xdeadline

NAN = float("nan")


# ---------------------------------------------------------------------------
# Series model
# ---------------------------------------------------------------------------


@dataclass
class GraphiteSeries:
    name: str           # display name (mutated by alias*)
    path: str           # the real metric path
    values: np.ndarray  # (T,) float64, NaN = missing
    step_nanos: int
    start_nanos: int

    def with_values(self, values, name: str | None = None) -> "GraphiteSeries":
        return replace(self, values=np.asarray(values, np.float64),
                       name=name if name is not None else self.name)


# ---------------------------------------------------------------------------
# Expression parser (reference graphite/lexer + native/parser)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PathExpr:
    path: str


@dataclass(frozen=True)
class Call:
    name: str
    args: tuple
    kwargs: tuple = ()


_NUM_RE = re.compile(r"-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?")
_IDENT_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
_PATH_CHARS = set(
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789"
    "_.-*?[]:$%+#"
)


def _scan_path(s: str, i: int) -> int:
    """End index of a path starting at i; ',' belongs to the path only
    inside {...} alternations (it separates args at depth 0)."""
    depth = 0
    j = i
    while j < len(s):
        c = s[j]
        if c == "{":
            depth += 1
        elif c == "}":
            if depth == 0:
                break
            depth -= 1
        elif c == ",":
            if depth == 0:
                break
        elif c not in _PATH_CHARS:
            break
        j += 1
    return j


class ParseError(ValueError):
    pass


class _Parser:
    def __init__(self, s: str):
        self.s = s
        self.i = 0

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i].isspace():
            self.i += 1

    def _peek(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else ""

    def parse(self):
        self._ws()
        out = self._expr()
        self._ws()
        if self.i != len(self.s):
            raise ParseError(f"trailing input at {self.i}: {self.s[self.i:]!r}")
        return out

    def _expr(self):
        self._ws()
        c = self._peek()
        if c and c in "'\"":  # NB: `"" in str` is always True
            return self._string()
        if c.isdigit() or (c == "-" and self.i + 1 < len(self.s)
                           and self.s[self.i + 1].isdigit()):
            m = _NUM_RE.match(self.s, self.i)
            # "404.count" / "1min.load" are legal paths: only a token
            # that ends where the path-scan ends is a number literal
            if m.end() == _scan_path(self.s, self.i):
                self.i = m.end()
                text = m.group()
                return float(text) if ("." in text or "e" in text.lower()) else int(text)
        # identifier: function call or path
        m = _IDENT_RE.match(self.s, self.i)
        if m:
            j = m.end()
            k = j
            while k < len(self.s) and self.s[k].isspace():
                k += 1
            if k < len(self.s) and self.s[k] == "(":
                name = m.group()
                self.i = k + 1
                args, kwargs = self._args()
                return Call(name, tuple(args), tuple(kwargs))
        j = _scan_path(self.s, self.i)
        if j == self.i:
            raise ParseError(f"unexpected input at {self.i}: {self.s[self.i:]!r}")
        text = self.s[self.i : j]
        self.i = j
        if text in ("true", "false"):
            return text == "true"
        return PathExpr(text)

    def _args(self):
        args: list = []
        kwargs: list = []
        self._ws()
        if self._peek() == ")":
            self.i += 1
            return args, kwargs
        while True:
            self._ws()
            # keyword argument?
            m = _IDENT_RE.match(self.s, self.i)
            if m:
                k = m.end()
                while k < len(self.s) and self.s[k].isspace():
                    k += 1
                if k < len(self.s) and self.s[k] == "=" and (
                    k + 1 >= len(self.s) or self.s[k + 1] != "="
                ):
                    self.i = k + 1
                    kwargs.append((m.group(), self._expr()))
                    self._ws()
                    if self._peek() == ",":
                        self.i += 1
                        continue
                    if self._peek() == ")":
                        self.i += 1
                        return args, kwargs
                    raise ParseError(f"bad arg list at {self.i}")
            args.append(self._expr())
            self._ws()
            if self._peek() == ",":
                self.i += 1
                continue
            if self._peek() == ")":
                self.i += 1
                return args, kwargs
            raise ParseError(f"bad arg list at {self.i}")

    def _string(self):
        q = self.s[self.i]
        self.i += 1
        j = self.s.find(q, self.i)
        if j < 0:
            raise ParseError("unterminated string")
        out = self.s[self.i : j]
        self.i = j + 1
        return out


def parse_target(s: str):
    return _Parser(s).parse()


# ---------------------------------------------------------------------------
# Path → index query (glob translation; reference graphite/storage)
# ---------------------------------------------------------------------------


def _component_to_query(i: int, comp: str):
    tag = b"__g%d__" % i
    if comp == "*":
        return FieldExists(tag)
    if not re.search(r"[*?{\[]", comp):
        return Term(tag, comp.encode())
    return Regexp(tag, glob_component_regex(comp).encode())


def glob_component_regex(comp: str) -> str:
    """Graphite glob → regexp: `*` any, `?` one, `{a,b}` alternation,
    `[0-9]` char class (reference graphite/graphite.go GlobToRegexPattern)."""
    out = []
    i = 0
    while i < len(comp):
        c = comp[i]
        if c == "*":
            out.append("[^.]*")
        elif c == "?":
            out.append("[^.]")
        elif c == "{":
            j = comp.find("}", i)
            if j < 0:
                raise ParseError(f"unbalanced {{ in {comp!r}")
            alts = comp[i + 1 : j].split(",")
            out.append("(?:" + "|".join(re.escape(a) for a in alts) + ")")
            i = j
        elif c == "[":
            j = comp.find("]", i)
            if j < 0:
                raise ParseError(f"unbalanced [ in {comp!r}")
            out.append(comp[i : j + 1])
            i = j
        else:
            out.append(re.escape(c))
        i += 1
    return "".join(out)


def path_to_index_query(path: str):
    comps = path.split(".")
    qs = [_component_to_query(i, c) for i, c in enumerate(comps)]
    # exactly-N-components: component N must not exist
    qs.append(Negation(FieldExists(b"__g%d__" % len(comps))))
    return Conjunction(*qs)


# ---------------------------------------------------------------------------
# Storage bridge
# ---------------------------------------------------------------------------


MAX_RENDER_POINTS = 100_000  # per-series grid cap: one request must not OOM


class GraphiteStorage:
    """Fetch graphite-shaped series from a Database namespace."""

    def __init__(self, db, namespace: str = "default",
                 max_points: int = MAX_RENDER_POINTS):
        self.db = db
        self.namespace = namespace
        self.max_points = max_points

    def fetch(self, path: str, start: int, end: int,
              step: int) -> list[GraphiteSeries]:
        from m3_tpu_torch.metrics.carbon import document_to_path

        if step <= 0:
            raise ParseError("step must be positive")
        T = max(0, (end - start) // step)
        if T > self.max_points:
            # an unauthenticated /render must not drive the node to OOM
            # (query limits never see numpy grid allocations)
            raise ParseError(
                f"render grid too large: {T} points > {self.max_points}; "
                "increase step or narrow the range"
            )
        docs = self.db.query_ids(self.namespace, path_to_index_query(path),
                                 start, end)
        out = []
        for i, d in enumerate(sorted(docs, key=lambda d: d.id)):
            if i % 64 == 0:  # per-series read loop: cancellable
                xdeadline.check_current("render fetch")
            p = document_to_path(d)
            if p is None:
                continue
            try:
                pts = self.db.read(self.namespace, d.id, start, end)
            except ShardNotOwnedError:
                continue  # unowned shard: replicas answer it
            vals = np.full(T, NAN)
            for t, v in pts:  # last point per bucket wins (consolidation)
                b = (t - start) // step
                if 0 <= b < T:
                    vals[b] = v
            out.append(GraphiteSeries(p.decode(), p.decode(), vals, step, start))
        return out

    def find(self, pattern: str) -> list[tuple[str, bool, bool]]:
        """(name, is_leaf, expandable) children matching the pattern's
        last component.  A node can be BOTH (metric `a.b` and branch of
        `a.b.c`) — Graphite reports leaf=1 + expandable=1 then."""
        comps = pattern.split(".")
        n = len(comps)
        qs = [_component_to_query(i, c) for i, c in enumerate(comps)]
        docs = self.db.query_ids(self.namespace, Conjunction(*qs),
                                 -(2**62), 2**62)
        seen: dict[str, list] = {}
        for d in docs:
            tags = d.tags()
            comp = tags.get(b"__g%d__" % (n - 1))
            if comp is None:
                continue
            leaf = (b"__g%d__" % n) not in tags
            flags = seen.setdefault(comp.decode(), [False, False])
            flags[0] |= leaf
            flags[1] |= not leaf
        return sorted((k, v[0], v[1]) for k, v in seen.items())


# ---------------------------------------------------------------------------
# Render functions (reference src/query/graphite/native)
# ---------------------------------------------------------------------------

_FUNCS: dict = {}


def _func(*names):
    def deco(fn):
        for n in names:
            _FUNCS[n] = fn
        return fn
    return deco


def _combine(series: list[GraphiteSeries], op, name: str):
    if not series:
        return []
    vals = np.stack([s.values for s in series])
    with np.errstate(all="ignore"):
        out = op(vals)
    paths = ",".join(s.name for s in series[:3])
    return [series[0].with_values(out, f"{name}({paths})")]


def _nan_agg(fn):
    """Run a nan-aggregate with all-NaN-slice warnings silenced (the
    result is correctly NaN; the warning is just noise)."""
    import warnings

    def run(v, *a, **kw):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return fn(v, *a, **kw)
    return run


@_func("sumSeries", "sum")
def _sum(ctx, series):
    return _combine(series, lambda v: np.nansum(v, 0), "sumSeries")


@_func("averageSeries", "avg")
def _avg(ctx, series):
    return _combine(series, _nan_agg(lambda v: np.nanmean(v, 0)), "averageSeries")


@_func("maxSeries")
def _max(ctx, series):
    return _combine(series, _nan_agg(lambda v: np.nanmax(v, 0)), "maxSeries")


@_func("minSeries")
def _min(ctx, series):
    return _combine(series, _nan_agg(lambda v: np.nanmin(v, 0)), "minSeries")


@_func("diffSeries")
def _diff(ctx, series):
    def d(v):
        out = v[0].copy()
        out -= np.nansum(v[1:], 0)
        return out
    return _combine(series, d, "diffSeries")


@_func("multiplySeries")
def _mul(ctx, series):
    return _combine(series, lambda v: np.nanprod(v, 0), "multiplySeries")


@_func("scale")
def _scale(ctx, series, factor):
    return [s.with_values(s.values * factor, f"scale({s.name},{factor:g})")
            for s in series]


@_func("offset")
def _offset(ctx, series, amount):
    return [s.with_values(s.values + amount, f"offset({s.name},{amount:g})")
            for s in series]


@_func("absolute")
def _absolute(ctx, series):
    return [s.with_values(np.abs(s.values), f"absolute({s.name})")
            for s in series]


@_func("invert")
def _invert(ctx, series):
    with np.errstate(all="ignore"):
        return [s.with_values(1.0 / s.values, f"invert({s.name})")
                for s in series]


@_func("derivative")
def _derivative(ctx, series):
    out = []
    for s in series:
        d = np.diff(s.values, prepend=NAN)
        out.append(s.with_values(d, f"derivative({s.name})"))
    return out


@_func("nonNegativeDerivative")
def _nnderivative(ctx, series):
    out = []
    for s in series:
        d = np.diff(s.values, prepend=NAN)
        d = np.where(d < 0, NAN, d)
        out.append(s.with_values(d, f"nonNegativeDerivative({s.name})"))
    return out


@_func("perSecond")
def _per_second(ctx, series):
    out = []
    for s in series:
        d = np.diff(s.values, prepend=NAN) / (s.step_nanos / 1e9)
        d = np.where(d < 0, NAN, d)
        out.append(s.with_values(d, f"perSecond({s.name})"))
    return out


@_func("integral")
def _integral(ctx, series):
    out = []
    for s in series:
        v = np.nan_to_num(s.values)
        out.append(s.with_values(np.cumsum(v), f"integral({s.name})"))
    return out


@_func("keepLastValue")
def _keep_last(ctx, series, limit=-1):
    out = []
    for s in series:
        v = s.values.copy()
        run = 0
        last = NAN
        for i in range(len(v)):
            if math.isnan(v[i]):
                run += 1
                if not math.isnan(last) and (limit < 0 or run <= limit):
                    v[i] = last
            else:
                last = v[i]
                run = 0
        out.append(s.with_values(v, f"keepLastValue({s.name})"))
    return out


def _moving(series, window: int, fn, name, min_fraction: float = 0.0):
    """Trailing-window aggregate over non-null points.  ``min_fraction``
    (stdev's windowTolerance) nulls windows whose valid fraction falls
    below it; 0 keeps any non-empty window."""
    out = []
    for s in series:
        v = s.values
        res = np.full_like(v, NAN)
        for i in range(len(v)):
            lo = max(0, i - window + 1)
            w = v[lo : i + 1]
            w = w[~np.isnan(w)]
            if len(w) and (not min_fraction
                           or len(w) / window >= min_fraction):
                res[i] = fn(w)
        out.append(s.with_values(res, f"{name}({s.name},{window})"))
    return out


@_func("movingAverage")
def _moving_avg(ctx, series, window):
    return _moving(series, int(window), np.mean, "movingAverage")


@_func("movingSum")
def _moving_sum(ctx, series, window):
    return _moving(series, int(window), np.sum, "movingSum")


@_func("movingMax")
def _moving_max(ctx, series, window):
    return _moving(series, int(window), np.max, "movingMax")


@_func("movingMin")
def _moving_min(ctx, series, window):
    return _moving(series, int(window), np.min, "movingMin")


@_func("alias")
def _alias(ctx, series, name):
    return [s.with_values(s.values, str(name)) for s in series]


@_func("aliasByNode")
def _alias_by_node(ctx, series, *nodes):
    out = []
    for s in series:
        comps = s.path.split(".")
        try:
            parts = [comps[int(n)] for n in nodes]
        except IndexError:
            parts = [s.path]
        out.append(s.with_values(s.values, ".".join(parts)))
    return out


@_func("timeShift")
def _time_shift(ctx, series, shift):
    """Placeholder: the evaluator intercepts timeShift and evaluates
    the INNER expression against a shifted window (so nested functions
    like scale/sumSeries apply to the shifted data, Graphite semantics).
    Reaching this body means a caller bypassed the evaluator."""
    raise ParseError("timeShift must be evaluated by GraphiteEngine")


@_func("summarize")
def _summarize(ctx, series, interval, func="sum"):
    nanos = _duration_nanos(str(interval))
    out = []
    agg = _nan_agg({"sum": np.nansum, "avg": np.nanmean, "max": np.nanmax,
                    "min": np.nanmin,
                    "last": lambda w: w[~np.isnan(w)][-1] if
                    (~np.isnan(w)).any() else NAN}[func])
    for s in series:
        k = max(1, nanos // s.step_nanos)
        T = len(s.values)
        nb = (T + k - 1) // k
        res = np.full(nb, NAN)
        for b in range(nb):
            w = s.values[b * k : (b + 1) * k]
            if (~np.isnan(w)).any():
                res[b] = agg(w)
        out.append(GraphiteSeries(
            f'summarize({s.name},"{interval}","{func}")', s.path, res,
            s.step_nanos * k, s.start_nanos,
        ))
    return out


# selection / filtering ------------------------------------------------------


# Canonical aggregation-name aliases for the per-series stat used by
# selection/sorting/filter builtins; one map so every function accepts
# the same spellings (and unknown names fail loudly everywhere).
_STAT_ALIASES = {
    "average": "avg", "avg": "avg", "max": "max", "min": "min",
    "current": "current", "last": "current", "sum": "sum",
    "total": "sum", "median": "median", "stddev": "stddev",
}


def _stat_name(func) -> str:
    what = _STAT_ALIASES.get(str(func))
    if what is None:
        raise ParseError(f"unknown aggregation func {func!r}")
    return what


def _series_stat(s: GraphiteSeries, what: str) -> float | None:
    """None when the series has no datapoints — empty series never win
    a lowest/below selection (and always lose highest/above)."""
    v = s.values[~np.isnan(s.values)]
    if not len(v):
        return None
    if what == "max":
        return float(v.max())
    if what == "avg":
        return float(v.mean())
    if what == "current":
        return float(v[-1])
    if what == "min":
        return float(v.min())
    if what == "sum":
        return float(v.sum())
    if what == "median":
        return float(np.median(v))
    if what == "stddev":
        return float(v.std())
    raise ValueError(what)


def _select(series, what: str, n: int, largest: bool):
    scored = [(s, _series_stat(s, what)) for s in series]
    scored = [(s, v) for s, v in scored if v is not None]
    scored.sort(key=lambda sv: -sv[1] if largest else sv[1])
    return [s for s, _ in scored[:n]]


@_func("highestMax")
def _highest_max(ctx, series, n=1):
    return _select(series, "max", int(n), True)


@_func("highestAverage")
def _highest_avg(ctx, series, n=1):
    return _select(series, "avg", int(n), True)


@_func("highestCurrent")
def _highest_cur(ctx, series, n=1):
    return _select(series, "current", int(n), True)


@_func("lowestAverage")
def _lowest_avg(ctx, series, n=1):
    return _select(series, "avg", int(n), False)


@_func("limit")
def _limit(ctx, series, n):
    return series[: int(n)]


@_func("sortByName")
def _sort_by_name(ctx, series):
    return sorted(series, key=lambda s: s.name)


@_func("sortByMaxima")
def _sort_by_maxima(ctx, series):
    # empty (all-NaN) series sort last instead of crashing on None
    return sorted(
        series,
        key=lambda s: -(v if (v := _series_stat(s, "max")) is not None
                        else -math.inf),
    )


def _filter_stat(series, what: str, pred):
    out = []
    for s in series:
        v = _series_stat(s, what)
        if v is not None and pred(v):
            out.append(s)
    return out


@_func("averageAbove")
def _avg_above(ctx, series, n):
    return _filter_stat(series, "avg", lambda v: v > n)


@_func("averageBelow")
def _avg_below(ctx, series, n):
    return _filter_stat(series, "avg", lambda v: v < n)


@_func("maximumAbove")
def _max_above(ctx, series, n):
    return _filter_stat(series, "max", lambda v: v > n)


@_func("currentAbove")
def _cur_above(ctx, series, n):
    return _filter_stat(series, "current", lambda v: v > n)


@_func("groupByNode")
def _group_by_node(ctx, series, node, func="sum"):
    groups: dict[str, list] = {}
    for s in series:
        comps = s.path.split(".")
        key = comps[int(node)] if int(node) < len(comps) else s.path
        groups.setdefault(key, []).append(s)
    agg = _FUNCS[{"sum": "sumSeries", "avg": "averageSeries",
                  "max": "maxSeries", "min": "minSeries"}[func]]
    out = []
    for key in sorted(groups):
        combined = agg(ctx, groups[key])
        if combined:
            out.append(combined[0].with_values(combined[0].values, key))
    return out


# Breadth tier: the rest of the reference's ~107 builtins
# (`src/query/graphite/native/builtin_functions.go`), implemented over
# the same GraphiteSeries model.
# ---------------------------------------------------------------------------


def _percentile(values: np.ndarray, n: float, interpolate: bool = False):
    """Graphite's _getPercentile: rank = (n/100)*(count+1) over sorted
    non-null values, optionally linearly interpolated."""
    pts = np.sort(values[~np.isnan(values)])
    if not len(pts):
        return None
    frac_rank = (n / 100.0) * (len(pts) + 1)
    rank = int(frac_rank)
    rank_frac = frac_rank - rank
    if not interpolate:
        rank += int(math.ceil(rank_frac))
    if rank == 0:
        out = float(pts[0])
    elif rank - 1 >= len(pts):
        out = float(pts[-1])
    else:
        out = float(pts[rank - 1])
    if interpolate and 0 < rank < len(pts):
        out += rank_frac * (float(pts[rank]) - float(pts[rank - 1]))
    return out


_AGG_OPS = {
    "sum": lambda v: np.nansum(v, 0),
    "total": lambda v: np.nansum(v, 0),
    "avg": _nan_agg(lambda v: np.nanmean(v, 0)),
    "average": _nan_agg(lambda v: np.nanmean(v, 0)),
    "max": _nan_agg(lambda v: np.nanmax(v, 0)),
    "min": _nan_agg(lambda v: np.nanmin(v, 0)),
    "median": _nan_agg(lambda v: np.nanmedian(v, 0)),
    "range": _nan_agg(lambda v: np.nanmax(v, 0) - np.nanmin(v, 0)),
    "rangeOf": _nan_agg(lambda v: np.nanmax(v, 0) - np.nanmin(v, 0)),
    "stddev": _nan_agg(lambda v: np.nanstd(v, 0)),
    "count": lambda v: np.sum(~np.isnan(v), 0).astype(np.float64),
    "last": _nan_agg(lambda v: _last_non_nan(v)),
    "multiply": lambda v: np.nanprod(v, 0),
    "diff": lambda v: v[0] - np.nansum(v[1:], 0),
}


def _last_non_nan(v: np.ndarray) -> np.ndarray:
    out = np.full(v.shape[1], NAN)
    for row in v:
        out = np.where(np.isnan(row), out, row)
    return out


@_func("aggregate")
def _aggregate(ctx, series, func):
    op = _AGG_OPS.get(str(func).removesuffix("Series"))
    if op is None:
        raise ParseError(f"aggregate: unknown func {func!r}")
    return _combine(series, op, f"aggregate:{func}")


@_func("group")
def _group(ctx, *series_lists):
    out = []
    for sl in series_lists:
        out.extend(sl)
    return out


@_func("aliasByMetric")
def _alias_by_metric(ctx, series):
    return [s.with_values(s.values, s.path.split(".")[-1]) for s in series]


@_func("aliasSub")
def _alias_sub(ctx, series, search, rep):
    rx = re.compile(str(search))
    return [s.with_values(s.values, rx.sub(str(rep), s.name)) for s in series]


@_func("aliasByTags")
def _alias_by_tags(ctx, series, *tags):
    """Graphite-on-tags naming: M3 maps path component i to tag __gi__
    (reference graphite storage adapter); 'name' is the full path."""
    out = []
    for s in series:
        comps = s.path.split(".")
        parts = []
        for t in tags:
            t = str(t)
            if t == "name":
                parts.append(s.path)
            elif t.startswith("__g") and t.endswith("__"):
                i = int(t[3:-2])
                parts.append(comps[i] if i < len(comps) else "")
            elif t.isdigit():
                i = int(t)
                parts.append(comps[i] if i < len(comps) else "")
            else:
                parts.append("")
        out.append(s.with_values(s.values, ".".join(p for p in parts if p)))
    return out


@_func("asPercent")
def _as_percent(ctx, series, total=None):
    if not series:
        return []
    with np.errstate(all="ignore"):
        if total is None:
            denom = np.nansum(np.stack([s.values for s in series]), 0)
            return [s.with_values(100.0 * s.values / denom,
                                  f"asPercent({s.name})") for s in series]
        if isinstance(total, (int, float)):
            return [s.with_values(100.0 * s.values / float(total),
                                  f"asPercent({s.name},{total:g})")
                    for s in series]
        if len(total) == 1:
            d = total[0].values
            return [s.with_values(100.0 * s.values / d,
                                  f"asPercent({s.name},{total[0].name})")
                    for s in series]
        if len(total) == len(series):
            return [s.with_values(100.0 * s.values / t.values,
                                  f"asPercent({s.name},{t.name})")
                    for s, t in zip(series, total)]
    raise ParseError("asPercent: total must be scalar, 1 series, or match")


@_func("changed")
def _changed(ctx, series):
    out = []
    for s in series:
        v = s.values
        prev = np.concatenate([[NAN], v[:-1]])
        ch = ((~np.isnan(v)) & (~np.isnan(prev)) & (v != prev)).astype(np.float64)
        out.append(s.with_values(ch, f"changed({s.name})"))
    return out


@_func("consolidateBy", "cumulative")
def _consolidate_by(ctx, series, func="sum"):
    # graphite-web's consolidationFunc only changes how the RENDERER
    # reduces points when maxDataPoints forces downsampling; this
    # engine always returns full-resolution data (no maxDataPoints
    # reduction exists), so pass-through is exact — there is no code
    # path where the chosen func could alter returned values.
    return [s.with_values(s.values, f'consolidateBy({s.name},"{func}")')
            for s in series]


def _grid(ctx):
    n = max(1, (ctx.end - ctx.start) // ctx.step)
    return n


@_func("constantLine")
def _constant_line(ctx, value):
    n = _grid(ctx)
    return [GraphiteSeries(f"{float(value):g}", f"{float(value):g}",
                           np.full(n, float(value)), ctx.step, ctx.start)]


@_func("threshold")
def _threshold(ctx, value, label=None):
    (line,) = _constant_line(ctx, value)
    return [line.with_values(line.values,
                             str(label) if label is not None else line.name)]


@_func("identity")
def _identity(ctx, name="identity"):
    n = _grid(ctx)
    secs = (ctx.start + np.arange(n) * ctx.step) / 1e9
    return [GraphiteSeries(str(name), str(name), secs.astype(np.float64),
                           ctx.step, ctx.start)]


@_func("timeFunction", "time")
def _time_function(ctx, name="time", step=None):
    return _identity(ctx, name)


@_func("countSeries")
def _count_series(ctx, *series_lists):
    series = [s for sl in series_lists for s in sl]
    if not series:
        return []
    n = len(series[0].values)
    return [series[0].with_values(np.full(n, float(len(series))),
                                  "countSeries()")]


@_func("currentBelow")
def _cur_below(ctx, series, n):
    return _filter_stat(series, "current", lambda v: v < n)


@_func("maximumBelow")
def _max_below(ctx, series, n):
    return _filter_stat(series, "max", lambda v: v < n)


@_func("minimumAbove")
def _min_above(ctx, series, n):
    return _filter_stat(series, "min", lambda v: v > n)


@_func("minimumBelow")
def _min_below(ctx, series, n):
    return _filter_stat(series, "min", lambda v: v < n)


@_func("lowestCurrent")
def _lowest_cur(ctx, series, n=1):
    return _select(series, "current", int(n), False)


@_func("highest")
def _highest(ctx, series, n=1, func="average"):
    return _select(series, _stat_name(func), int(n), True)


@_func("lowest")
def _lowest(ctx, series, n=1, func="average"):
    return _select(series, _stat_name(func), int(n), False)


@_func("delay")
def _delay(ctx, series, steps):
    k = int(steps)
    out = []
    for s in series:
        v = np.full_like(s.values, NAN)
        if k >= 0:
            if k < len(v):
                v[k:] = s.values[: len(v) - k]
        else:
            if -k < len(v):
                v[:k] = s.values[-k:]
        out.append(s.with_values(v, f"delay({s.name},{k})"))
    return out


@_func("divideSeries")
def _divide_series(ctx, dividends, divisor):
    if len(divisor) != 1:
        raise ParseError("divideSeries: divisor must be exactly one series")
    d = divisor[0].values
    with np.errstate(all="ignore"):
        return [
            s.with_values(np.where(d == 0, NAN, s.values / d),
                          f"divideSeries({s.name},{divisor[0].name})")
            for s in dividends
        ]


@_func("divideSeriesLists")
def _divide_series_lists(ctx, dividends, divisors):
    if len(dividends) != len(divisors):
        raise ParseError("divideSeriesLists: length mismatch")
    with np.errstate(all="ignore"):
        return [
            s.with_values(np.where(t.values == 0, NAN, s.values / t.values),
                          f"divideSeries({s.name},{t.name})")
            for s, t in zip(dividends, divisors)
        ]


@_func("exclude")
def _exclude(ctx, series, pattern):
    rx = re.compile(str(pattern))
    return [s for s in series if not rx.search(s.name)]


@_func("grep")
def _grep(ctx, series, pattern):
    rx = re.compile(str(pattern))
    return [s for s in series if rx.search(s.name)]


@_func("fallbackSeries")
def _fallback_series(ctx, series, fallback):
    return series if series else fallback


@_func("filterSeries")
def _filter_series(ctx, series, func, op, threshold):
    what = _stat_name(func)
    ops = {
        "=": lambda v: v == threshold, "!=": lambda v: v != threshold,
        ">": lambda v: v > threshold, ">=": lambda v: v >= threshold,
        "<": lambda v: v < threshold, "<=": lambda v: v <= threshold,
    }
    pred = ops.get(str(op))
    if pred is None:
        raise ParseError(f"filterSeries: unknown op {op!r}")
    return _filter_stat(series, what, pred)


_MINUTE_NANOS = 60 * 10**9
_HOUR_NANOS = 3600 * 10**9
_DAY_NANOS = 86400 * 10**9


@_func("hitcount")
def _hitcount(ctx, series, interval, align_to_interval=False):
    """Per-bucket hit totals (value x step-seconds summed per interval),
    graphite-web functions.py hitcount semantics:

    * default — buckets are anchored at the series END
      (``newStart = end - bucket_count*interval``), so any partial
      bucket is the FIRST one;
    * ``alignToInterval=True`` — the start truncates to the interval's
      leading calendar unit (day/hour/minute) and buckets run forward
      from there.  (graphite-web re-fetches from the truncated start;
      without a re-fetch the pre-start remainder of that first bucket
      is simply empty here.)"""
    nanos = max(_duration_nanos(str(interval)),
                1)
    out = []
    for s in series:
        T = len(s.values)
        # A bucket can't be finer than the data's step: an interval
        # below the step would time-stretch the output.
        eff = max(nanos, s.step_nanos)
        end = s.start_nanos + T * s.step_nanos
        if align_to_interval:
            unit = (_DAY_NANOS if eff >= _DAY_NANOS
                    else _HOUR_NANOS if eff >= _HOUR_NANOS
                    else _MINUTE_NANOS if eff >= _MINUTE_NANOS
                    else 10**9)
            base = (s.start_nanos // unit) * unit
        else:
            nb0 = max(0, -(-(end - s.start_nanos) // eff))
            base = end - nb0 * eff
        t = s.start_nanos + np.arange(T, dtype=np.int64) * s.step_nanos
        bidx = (t - base) // eff
        nb = int(bidx[-1]) + 1 if T else 0
        res = np.full(nb, NAN)
        secs = s.step_nanos / 1e9
        # bidx is non-decreasing: bucket b is the slice between edges.
        edges = np.searchsorted(bidx, np.arange(nb + 1))
        for b in range(nb):
            w = s.values[edges[b]:edges[b + 1]]
            if w.size and (~np.isnan(w)).any():
                res[b] = np.nansum(w) * secs
        suffix = ",true" if align_to_interval else ""
        out.append(GraphiteSeries(
            f'hitcount({s.name},"{interval}"{suffix})', s.path, res,
            eff, base,
        ))
    return out


@_func("integralByInterval")
def _integral_by_interval(ctx, series, interval):
    nanos = _duration_nanos(str(interval))
    out = []
    for s in series:
        k = max(1, nanos // s.step_nanos)
        v = np.nan_to_num(s.values)
        res = np.empty_like(v)
        for b in range(0, len(v), k):
            res[b: b + k] = np.cumsum(v[b: b + k])
        out.append(s.with_values(res, f"integralByInterval({s.name})"))
    return out


@_func("interpolate")
def _interpolate(ctx, series, limit=-1):
    """Fill interior NaN gaps linearly; a gap is filled only when its
    ENTIRE run length is <= limit (graphite-web leaves longer gaps
    untouched rather than partially filling them)."""
    out = []
    for s in series:
        v = s.values.copy()
        idx = np.arange(len(v))
        good = ~np.isnan(v)
        if good.sum() >= 2:
            filled = np.interp(idx, idx[good], v[good])
            first, last = idx[good][0], idx[good][-1]
            i = 0
            while i < len(v):
                if np.isnan(v[i]):
                    j = i
                    while j < len(v) and np.isnan(v[j]):
                        j += 1
                    interior = first < i and j - 1 < last
                    if interior and (limit < 0 or (j - i) <= limit):
                        v[i:j] = filled[i:j]
                    i = j
                else:
                    i += 1
        out.append(s.with_values(v, f"interpolate({s.name})"))
    return out


@_func("isNonNull")
def _is_non_null(ctx, series):
    return [s.with_values((~np.isnan(s.values)).astype(np.float64),
                          f"isNonNull({s.name})") for s in series]


@_func("logarithm", "log")
def _logarithm(ctx, series, base=10):
    with np.errstate(all="ignore"):
        return [
            s.with_values(
                np.where(s.values > 0,
                         np.log(s.values) / math.log(float(base)), NAN),
                f"log({s.name},{float(base):g})")
            for s in series
        ]


@_func("mostDeviant")
def _most_deviant(ctx, series, n):
    def sigma(s):
        v = s.values[~np.isnan(s.values)]
        return float(v.std()) if len(v) else -math.inf
    return sorted(series, key=sigma, reverse=True)[: int(n)]


@_func("movingMedian")
def _moving_median(ctx, series, window):
    return _moving(series, int(window), np.median, "movingMedian")


@_func("movingWindow")
def _moving_window(ctx, series, window, func="average"):
    fn = {"average": np.mean, "avg": np.mean, "sum": np.sum,
          "max": np.max, "min": np.min, "median": np.median,
          "stddev": np.std}.get(str(func))
    if fn is None:
        raise ParseError(f"movingWindow: unknown func {func!r}")
    return _moving(series, int(window), fn, f"movingWindow:{func}")


@_func("exponentialMovingAverage")
def _ema(ctx, series, window):
    """graphite-web semantics: the EMA seeds with the simple average of
    the first ``window`` points (emitted at that index; earlier points
    are null), then decays with alpha = 2/(window+1)."""
    n = int(window)
    alpha = 2.0 / (n + 1)
    out = []
    for s in series:
        v = s.values
        res = np.full_like(v, NAN)
        if len(v) >= n:
            seed_w = v[:n]
            seed = float(np.nanmean(seed_w)) if (~np.isnan(seed_w)).any() else NAN
            ema = seed
            res[n - 1] = ema
            for i in range(n, len(v)):
                x = v[i]
                if not math.isnan(x) and not math.isnan(ema):
                    ema = alpha * x + (1 - alpha) * ema
                elif not math.isnan(x):
                    ema = x
                res[i] = ema
        out.append(s.with_values(res, f"exponentialMovingAverage({s.name},{n})"))
    return out


@_func("stdev")
def _stdev_moving(ctx, series, points, window_tolerance=0.1):
    """Trailing-window population stddev over non-null points; a window
    whose valid fraction falls below ``windowTolerance`` yields null
    (graphite-web functions.py stdev: validPoints/points >=
    windowTolerance gates the calculation)."""
    return _moving(series, int(points), np.std, "stdev",
                   min_fraction=float(window_tolerance))


@_func("stddevSeries")
def _stddev_series(ctx, series):
    return _combine(series, _nan_agg(lambda v: np.nanstd(v, 0)), "stddevSeries")


@_func("rangeOfSeries")
def _range_of_series(ctx, series):
    return _combine(
        series,
        _nan_agg(lambda v: np.nanmax(v, 0) - np.nanmin(v, 0)),
        "rangeOfSeries",
    )


@_func("nPercentile")
def _n_percentile(ctx, series, n):
    out = []
    for s in series:
        p = _percentile(s.values, float(n))
        if p is None:
            continue
        out.append(s.with_values(np.full_like(s.values, p),
                                 f"nPercentile({s.name},{float(n):g})"))
    return out


@_func("percentileOfSeries")
def _percentile_of_series(ctx, series, n, interpolate=False):
    if not series:
        return []
    vals = np.stack([s.values for s in series])
    T = vals.shape[1]
    res = np.full(T, NAN)
    for t in range(T):
        p = _percentile(vals[:, t], float(n), bool(interpolate))
        if p is not None:
            res[t] = p
    return [series[0].with_values(res, f"percentileOfSeries({series[0].name},{float(n):g})")]


@_func("pow")
def _pow(ctx, series, factor):
    with np.errstate(all="ignore"):
        return [s.with_values(np.power(s.values, float(factor)),
                              f"pow({s.name},{float(factor):g})")
                for s in series]


@_func("powSeries")
def _pow_series(ctx, *series_lists):
    series = [s for sl in series_lists for s in sl]
    if not series:
        return []
    with np.errstate(all="ignore"):
        acc = series[0].values.copy()
        for s in series[1:]:
            acc = np.power(acc, s.values)
    return [series[0].with_values(acc, "powSeries()")]


@_func("offsetToZero")
def _offset_to_zero(ctx, series):
    out = []
    for s in series:
        v = s.values[~np.isnan(s.values)]
        base = float(v.min()) if len(v) else 0.0
        out.append(s.with_values(s.values - base, f"offsetToZero({s.name})"))
    return out


def _remove_by(series, pred, name):
    out = []
    for s in series:
        v = s.values.copy()
        v[pred(s, v)] = NAN
        out.append(s.with_values(v, f"{name}({s.name})"))
    return out


@_func("removeAboveValue")
def _remove_above_value(ctx, series, n):
    return _remove_by(series, lambda s, v: v > n, "removeAboveValue")


@_func("removeBelowValue")
def _remove_below_value(ctx, series, n):
    return _remove_by(series, lambda s, v: v < n, "removeBelowValue")


@_func("removeAbovePercentile")
def _remove_above_pct(ctx, series, n):
    def pred(s, v):
        p = _percentile(v, float(n))
        return v > p if p is not None else np.zeros(len(v), bool)
    return _remove_by(series, pred, "removeAbovePercentile")


@_func("removeBelowPercentile")
def _remove_below_pct(ctx, series, n):
    def pred(s, v):
        p = _percentile(v, float(n))
        return v < p if p is not None else np.zeros(len(v), bool)
    return _remove_by(series, pred, "removeBelowPercentile")


@_func("removeEmptySeries")
def _remove_empty(ctx, series, xFilesFactor=0):
    out = []
    for s in series:
        frac = float((~np.isnan(s.values)).mean()) if len(s.values) else 0.0
        if frac > 0 and frac >= float(xFilesFactor):
            out.append(s)
    return out


@_func("round")
def _round(ctx, series, precision=0):
    p = int(precision)
    return [s.with_values(np.round(s.values, p),
                          f"round({s.name},{p})") for s in series]


@_func("scaleToSeconds")
def _scale_to_seconds(ctx, series, seconds):
    return [
        s.with_values(s.values * (float(seconds) / (s.step_nanos / 1e9)),
                      f"scaleToSeconds({s.name},{float(seconds):g})")
        for s in series
    ]


@_func("smartSummarize")
def _smart_summarize(ctx, series, interval, func="sum"):
    # summarize with buckets aligned to the interval epoch boundary:
    # the leading partial bucket is trimmed so every bucket starts on a
    # multiple of the interval.
    nanos = _duration_nanos(str(interval))
    out = []
    for s in series:
        off = s.start_nanos % nanos
        lead = 0 if off == 0 else int((nanos - off) // s.step_nanos)
        trimmed = replace(s, values=s.values[lead:],
                          start_nanos=s.start_nanos + lead * s.step_nanos)
        summ = _summarize(ctx, [trimmed], interval, func)
        if summ:
            out.append(replace(
                summ[0],
                name=f'smartSummarize({s.name},"{interval}","{func}")'))
    return out


@_func("sortBy")
def _sort_by(ctx, series, func="average", reverse=False):
    what = _stat_name(func)
    scored = [(s, _series_stat(s, what)) for s in series]
    scored = [(s, v if v is not None else -math.inf) for s, v in scored]
    scored.sort(key=lambda sv: sv[1], reverse=bool(reverse))
    return [s for s, _ in scored]


@_func("sortByMinima")
def _sort_by_minima(ctx, series):
    return sorted(
        series,
        key=lambda s: (v if (v := _series_stat(s, "min")) is not None
                       else math.inf),
    )


@_func("sortByTotal")
def _sort_by_total(ctx, series):
    def total(s):
        v = s.values[~np.isnan(s.values)]
        return float(v.sum()) if len(v) else -math.inf
    return sorted(series, key=total, reverse=True)


@_func("squareRoot")
def _square_root(ctx, series):
    with np.errstate(all="ignore"):
        return [s.with_values(np.where(s.values >= 0, np.sqrt(s.values), NAN),
                              f"squareRoot({s.name})") for s in series]


@_func("substr")
def _substr(ctx, series, start=0, stop=0):
    out = []
    for s in series:
        comps = s.name.split(".")
        sl = comps[int(start): int(stop)] if int(stop) != 0 else comps[int(start):]
        out.append(s.with_values(s.values, ".".join(sl)))
    return out


def _sustained(series, duration, pred, name):
    """Keep values only inside runs satisfying ``pred`` for at least
    ``duration`` (shared body of sustainedAbove/Below)."""
    nanos = _duration_nanos(str(duration))
    out = []
    for s in series:
        k = max(1, int(nanos // s.step_nanos))
        v = s.values
        ok = pred(v)
        res = np.full_like(v, NAN)
        run = 0
        for i in range(len(v)):
            run = run + 1 if ok[i] else 0
            if run >= k:
                res[i - run + 1: i + 1] = v[i - run + 1: i + 1]
        out.append(s.with_values(res, f"{name}({s.name})"))
    return out


@_func("sustainedAbove")
def _sustained_above(ctx, series, value, duration):
    return _sustained(series, duration, lambda v: v >= value,
                      "sustainedAbove")


@_func("sustainedBelow")
def _sustained_below(ctx, series, value, duration):
    return _sustained(series, duration, lambda v: v <= value,
                      "sustainedBelow")


@_func("transformNull")
def _transform_null(ctx, series, default=0):
    return [
        s.with_values(np.where(np.isnan(s.values), float(default), s.values),
                      f"transformNull({s.name},{float(default):g})")
        for s in series
    ]


@_func("groupByNodes")
def _group_by_nodes(ctx, series, func, *nodes):
    groups: dict[str, list] = {}
    for s in series:
        comps = s.path.split(".")
        key = ".".join(
            comps[int(n)] if int(n) < len(comps) else "" for n in nodes
        )
        groups.setdefault(key, []).append(s)
    op = _AGG_OPS.get(str(func).removesuffix("Series"))
    if op is None:
        raise ParseError(f"groupByNodes: unknown func {func!r}")
    out = []
    for key in sorted(groups):
        combined = _combine(groups[key], op, key)
        if combined:
            out.append(combined[0].with_values(combined[0].values, key))
    return out


def _with_wildcards(series, positions):
    groups: dict[str, list] = {}
    for s in series:
        comps = s.path.split(".")
        key = ".".join(
            c for i, c in enumerate(comps) if i not in positions
        )
        groups.setdefault(key, []).append(s)
    return groups


@_func("aggregateWithWildcards")
def _aggregate_with_wildcards(ctx, series, func, *positions):
    op = _AGG_OPS.get(str(func).removesuffix("Series"))
    if op is None:
        raise ParseError(f"aggregateWithWildcards: unknown func {func!r}")
    pos = {int(p) for p in positions}
    out = []
    for key in sorted(groups := _with_wildcards(series, pos)):
        combined = _combine(groups[key], op, key)
        if combined:
            out.append(combined[0].with_values(combined[0].values, key))
    return out


@_func("sumSeriesWithWildcards")
def _sum_with_wildcards(ctx, series, *positions):
    return _aggregate_with_wildcards(ctx, series, "sum", *positions)


@_func("averageSeriesWithWildcards")
def _avg_with_wildcards(ctx, series, *positions):
    return _aggregate_with_wildcards(ctx, series, "average", *positions)


@_func("multiplySeriesWithWildcards")
def _mul_with_wildcards(ctx, series, *positions):
    return _aggregate_with_wildcards(ctx, series, "multiply", *positions)


@_func("weightedAverage")
def _weighted_average(ctx, avg_series, weight_series, *nodes):
    def key_of(s):
        comps = s.path.split(".")
        return ".".join(
            comps[int(n)] if int(n) < len(comps) else "" for n in nodes
        )
    weights = {key_of(s): s for s in weight_series}
    num = None
    den = None
    for s in avg_series:
        w = weights.get(key_of(s))
        if w is None:
            continue
        prod = np.where(np.isnan(s.values) | np.isnan(w.values), 0.0,
                        s.values * w.values)
        wv = np.where(np.isnan(s.values) | np.isnan(w.values), 0.0, w.values)
        num = prod if num is None else num + prod
        den = wv if den is None else den + wv
    if num is None:
        return []
    with np.errstate(all="ignore"):
        res = np.where(den == 0, NAN, num / den)
    return [avg_series[0].with_values(res, "weightedAverage()")]


@_func("aggregateLine")
def _aggregate_line(ctx, series, func="average"):
    what = _stat_name(func)
    out = []
    for s in series:
        stat = _series_stat(s, what)
        if stat is None:
            continue
        out.append(s.with_values(np.full_like(s.values, stat),
                                 f"aggregateLine({s.name},{stat:g})"))
    return out


# ---------------------------------------------------------------------------
# Evaluator + render entry points
# ---------------------------------------------------------------------------


_DUR_RE = re.compile(r"^-?(\d+)(s|min|h|d|w|y|mon)$")
_DUR_NANOS = {"s": 10**9, "min": 60 * 10**9, "h": 3600 * 10**9,
              "d": 86400 * 10**9, "w": 7 * 86400 * 10**9,
              "mon": 30 * 86400 * 10**9, "y": 365 * 86400 * 10**9}


def _duration_nanos(s: str) -> int:
    s = s.strip()
    m = _DUR_RE.match(s)
    if not m:
        raise ParseError(f"bad duration {s!r}")
    nanos = int(m.group(1)) * _DUR_NANOS[m.group(2)]
    # the sign matters: timeShift(x, "-1h") shifts forward, "1h" back
    return -nanos if s.startswith("-") else nanos


def parse_graphite_time(s: str, now_nanos: int) -> int:
    """Epoch seconds, 'now', or relative '-1h' (reference
    graphite/ts parsing, minimal form)."""
    s = s.strip()
    if s == "now" or s == "":
        return now_nanos
    if s.startswith("-"):
        return now_nanos - _duration_nanos(s[1:])
    return int(float(s) * 1e9)


@dataclass
class _Ctx:
    storage: GraphiteStorage
    start: int
    end: int
    step: int
    engine: "GraphiteEngine | None" = None  # re-entrant evaluation


class GraphiteEngine:
    """Parse + evaluate render targets (reference native/engine.go)."""

    def __init__(self, storage: GraphiteStorage):
        self.storage = storage

    def render(self, target: str, start_nanos: int, end_nanos: int,
               step_nanos: int) -> list[GraphiteSeries]:
        ast = parse_target(target)
        ctx = _Ctx(self.storage, start_nanos, end_nanos, step_nanos, self)
        out = self._eval(ast, ctx)
        if not isinstance(out, list):
            raise ParseError(f"target does not evaluate to series: {target!r}")
        return out

    def _eval(self, node, ctx: _Ctx):
        # cancellation point between render-pipeline nodes (the
        # graphite entry rides the same deadline as PromQL queries)
        xdeadline.check_current("render eval")
        if isinstance(node, PathExpr):
            return ctx.storage.fetch(node.path, ctx.start, ctx.end, ctx.step)
        if isinstance(node, Call):
            if node.name == "timeShift":
                if len(node.args) != 2:
                    raise ParseError("timeShift(expr, shift) takes 2 args")
                shift = node.args[1]
                nanos = _duration_nanos(str(shift))
                shifted = replace(ctx, start=ctx.start - nanos,
                                  end=ctx.end - nanos)
                inner = self._eval(node.args[0], shifted)
                return [
                    replace(s, start_nanos=ctx.start,
                            name=f'timeShift({s.name},"{shift}")')
                    for s in inner
                ]
            fn = _FUNCS.get(node.name)
            if fn is None:
                raise ParseError(f"unsupported function {node.name!r}")
            args = [self._eval(a, ctx) for a in node.args]
            kwargs = {k: self._eval(v, ctx) for k, v in node.kwargs}
            # series-list args may come from nested calls/paths; scalars
            # pass through
            return fn(ctx, *args, **kwargs)
        return node  # number / string / bool


def supported_functions() -> list[str]:
    return sorted(_FUNCS)


# ---------------------------------------------------------------------------
# Synthetic, presentational, substitution and forecasting functions.
# ---------------------------------------------------------------------------


@_func("randomWalkFunction", "randomWalk")
def _random_walk(ctx, name, step=None):
    """Synthetic random-walk series over the render window (graphite-web
    functions.py randomWalkFunction).  Seeded from the name so repeated
    renders of one target are stable — a test-friendly divergence from
    graphite's unseeded random.random().  ``step`` defaults to the
    RENDER step so the series stays grid-compatible with fetched ones
    (this engine does not LCM-normalize mixed grids), and the point
    count honors the same OOM cap as every fetch path."""
    import zlib

    step_nanos = (ctx.step if step is None
                  else max(1, int(step)) * 10**9)
    n = max(1, int((ctx.end - ctx.start) // step_nanos))
    cap = (ctx.storage.max_points if ctx.storage is not None
           else 100_000)
    if n > cap:
        raise ParseError(f"render grid too large: {n} > {cap} points")
    rng = np.random.default_rng(zlib.crc32(str(name).encode()))
    vals = np.cumsum(rng.random(n) - 0.5)
    return [GraphiteSeries(str(name), str(name), vals, step_nanos, ctx.start)]


@_func("timeSlice")
def _time_slice(ctx, series, start_str, end_str="now"):
    """Null out values outside [startSliceAt, endSliceAt] (graphite-web
    timeSlice); the window parses with graphite's relative time syntax
    against the render end (render() always sets it — no wall-clock
    fallback, which would make epoch-0 test windows nondeterministic)."""
    now = ctx.end
    lo = parse_graphite_time(str(start_str), now)
    hi = parse_graphite_time(str(end_str), now)
    out = []
    for s in series:
        t = s.start_nanos + np.arange(len(s.values), dtype=np.int64) * s.step_nanos
        v = np.where((t >= lo) & (t <= hi), s.values, NAN)
        out.append(s.with_values(
            v, f'timeSlice({s.name},"{start_str}","{end_str}")'))
    return out


def _fmt_legend(v: float) -> str:
    return "None" if np.isnan(v) else f"{v:g}"


# Per-series legend statistics (shared by cactiStyle/legendValue):
# _nan_agg silences the all-NaN-slice warning; the NaN result is right.
_LEGEND_FNS = {
    "avg": _nan_agg(np.nanmean),
    "average": _nan_agg(np.nanmean),
    "min": _nan_agg(np.nanmin),
    "max": _nan_agg(np.nanmax),
    "last": lambda v: (v[~np.isnan(v)][-1] if (~np.isnan(v)).any()
                       else np.nan),
    "total": _nan_agg(np.nansum),
}


@_func("cactiStyle")
def _cacti_style(ctx, series, system=None, units=None):
    """Append Current/Max/Min to each alias (graphite-web cactiStyle;
    the si-system scaling of the reference renderer is presentational
    and out of scope — raw values render instead)."""
    suffix_units = f" {units}" if units else ""
    out = []
    for s in series:
        cur = _LEGEND_FNS["last"](s.values)
        name = (f"{s.name} Current:{_fmt_legend(cur)}{suffix_units} "
                f"Max:{_fmt_legend(_LEGEND_FNS['max'](s.values))}"
                f"{suffix_units} "
                f"Min:{_fmt_legend(_LEGEND_FNS['min'](s.values))}"
                f"{suffix_units}")
        out.append(s.with_values(s.values, name))
    return out


@_func("legendValue")
def _legend_value(ctx, series, *value_types):
    """Append requested statistics to each alias (graphite-web
    legendValue).  A trailing "si"/"binary" system argument is accepted
    (graphite-web uses it to pick unit formatting; values render
    unscaled here)."""
    value_types = list(value_types)
    if value_types and str(value_types[-1]) in ("si", "binary"):
        value_types.pop()  # formatting-system hint, not a value type
    out = []
    for s in series:
        name = s.name
        for vt in value_types:
            fn_ = _LEGEND_FNS.get(str(vt))
            if fn_ is None:
                name += " (?)"  # graphite-web degrades, never errors
                continue
            name += f" ({vt}: {_fmt_legend(fn_(s.values))})"
        out.append(s.with_values(s.values, name))
    return out


@_func("dashed")
def _dashed(ctx, series, dash_length=5):
    # A render-style hint: data passes through under the dashed() alias
    # (the drawing itself belongs to a renderer this API does not have).
    return [s.with_values(s.values, f"dashed({s.name},{dash_length})")
            for s in series]


@_func("useSeriesAbove")
def _use_series_above(ctx, series, value, search, replace):
    """For every series whose max exceeds ``value``, fetch the series
    whose path substitutes search->replace (graphite-web useSeriesAbove
    applies ``re.sub`` — regex patterns work; a series whose
    substitution leaves the path unchanged is skipped rather than
    re-fetched as itself)."""
    rx = re.compile(str(search))
    out = []
    for s in series:
        if (~np.isnan(s.values)).any() and np.nanmax(s.values) > value:
            newpath = rx.sub(str(replace), s.path)
            if newpath == s.path:
                continue
            for hit in ctx.storage.fetch(newpath, ctx.start, ctx.end,
                                         ctx.step):
                out.append(hit)
    return out


@_func("applyByNode")
def _apply_by_node(ctx, series, node_num, template, new_name=None):
    """Re-evaluate a template per distinct node prefix (graphite-web
    applyByNode): for each unique first-(node+1)-components prefix of
    the input paths, render ``template`` with '%' replaced by the
    prefix; ``newName`` (also %-substituted) renames the results."""
    if ctx.engine is None:
        raise ParseError("applyByNode needs an engine-bound context")
    n = int(node_num)
    prefixes = []
    for s in series:
        parts = s.path.split(".")
        if len(parts) <= n:
            continue
        pre = ".".join(parts[: n + 1])
        if pre not in prefixes:
            prefixes.append(pre)
    out = []
    for pre in prefixes:
        target = str(template).replace("%", pre)
        for r in ctx.engine._eval(parse_target(target), ctx):
            if new_name is not None:
                r = r.with_values(r.values,
                                  str(new_name).replace("%", pre))
            out.append(r)
    return out


# ---------------------------------------------------------------------------
# Holt-Winters forecasting (graphite-web functions.py holtWintersAnalysis:
# triple exponential smoothing, one-day season, alpha=gamma=0.1,
# beta=0.0035).  The sequential reference loop is mirrored exactly —
# including its None-breaks-the-math restart behavior (NaN here).
# ---------------------------------------------------------------------------

_HW_ALPHA = 0.1
_HW_GAMMA = 0.1
_HW_BETA = 0.0035


def _holt_winters_analysis(values: np.ndarray, step_nanos: int):
    """Returns (predictions, deviations) float64 arrays (NaN = None)."""
    season = max(1, int((24 * 3600 * 10**9) // max(1, step_nanos)))
    n = len(values)
    intercepts: list = []
    slopes: list = []
    seasonals: list = []
    predictions = np.full(n, NAN)
    deviations = np.full(n, NAN)

    def last_seasonal(i):
        # bounds-checked both ways: at season=1 (steps >= 1 day) the
        # lookahead last_seasonal(i+1) would otherwise index a slot not
        # yet appended (a latent IndexError in the graphite-web loop)
        j = i - season
        return seasonals[j] if 0 <= j < len(seasonals) else 0.0

    def last_deviation(i):
        j = i - season
        return deviations[j] if j >= 0 and not math.isnan(deviations[j]) else 0.0

    next_pred = NAN
    for i in range(n):
        actual = values[i]
        if math.isnan(actual):
            # missing input values break all the math: restart
            intercepts.append(None)
            slopes.append(0.0)
            seasonals.append(0.0)
            predictions[i] = next_pred
            deviations[i] = 0.0
            next_pred = NAN
            continue
        if i == 0:
            last_intercept = actual
            last_slope = 0.0
            prediction = actual  # seed: first prediction = first actual
        else:
            last_intercept = intercepts[-1]
            last_slope = slopes[-1]
            if last_intercept is None:
                last_intercept = actual
            prediction = next_pred
        ls = last_seasonal(i)
        next_ls = last_seasonal(i + 1)
        lsd = last_deviation(i)
        intercept = (_HW_ALPHA * (actual - ls)
                     + (1 - _HW_ALPHA) * (last_intercept + last_slope))
        slope = (_HW_BETA * (intercept - last_intercept)
                 + (1 - _HW_BETA) * last_slope)
        seasonal = (_HW_GAMMA * (actual - intercept)
                    + (1 - _HW_GAMMA) * ls)
        next_pred = intercept + slope + next_ls
        pred_for_dev = 0.0 if math.isnan(prediction) else prediction
        deviation = (_HW_GAMMA * abs(actual - pred_for_dev)
                     + (1 - _HW_GAMMA) * lsd)
        intercepts.append(intercept)
        slopes.append(slope)
        seasonals.append(seasonal)
        predictions[i] = prediction
        deviations[i] = deviation
    return predictions, deviations


def _hw_bootstrapped(ctx, series, bootstrap_interval):
    """(bootstrapped GraphiteSeries, trim point count) per input: the
    series re-fetched with `bootstrapInterval` of leading history
    (graphite-web previewSeconds) so the seasonal state is warm when
    the render window starts.  Computed series that cannot re-fetch
    (path no longer a plain metric) analyze the window alone."""
    nanos = _duration_nanos(str(bootstrap_interval))
    out = []
    for s in series:
        try:
            fetched = ctx.storage.fetch(
                s.path, ctx.start - nanos, ctx.end, ctx.step
            ) if ctx.storage is not None else []
        except ParseError:
            # e.g. the extended grid exceeds the render cap: analyze
            # the window alone rather than failing the whole render
            fetched = []
        if len(fetched) == 1:
            boot = fetched[0]
            # round UP: a bootstrap interval that is not a step
            # multiple must not leave the forecast shifted off the
            # render grid (the first on-grid point is the one at or
            # after ctx.start)
            trim = int(-(-(ctx.start - boot.start_nanos)
                         // boot.step_nanos))
            out.append((boot, max(0, trim), s))
        else:
            out.append((s, 0, s))
    return out


def _hw_forecast_parts(ctx, series, bootstrap_interval):
    for boot, trim, orig in _hw_bootstrapped(ctx, series, bootstrap_interval):
        pred, dev = _holt_winters_analysis(boot.values, boot.step_nanos)
        start = boot.start_nanos + trim * boot.step_nanos
        yield orig, boot, trim, start, pred, dev


@_func("holtWintersForecast")
def _holt_winters_forecast(ctx, series, bootstrap_interval="7d"):
    out = []
    for orig, boot, trim, start, pred, dev in _hw_forecast_parts(
            ctx, series, bootstrap_interval):
        out.append(GraphiteSeries(
            f"holtWintersForecast({orig.name})", orig.path,
            pred[trim:], boot.step_nanos, start))
    return out


@_func("holtWintersConfidenceBands")
def _holt_winters_confidence_bands(ctx, series, delta=3,
                                   bootstrap_interval="7d"):
    out = []
    for orig, boot, trim, start, pred, dev in _hw_forecast_parts(
            ctx, series, bootstrap_interval):
        upper = pred[trim:] + delta * dev[trim:]
        lower = pred[trim:] - delta * dev[trim:]
        out.append(GraphiteSeries(
            f"holtWintersConfidenceUpper({orig.name})", orig.path,
            upper, boot.step_nanos, start))
        out.append(GraphiteSeries(
            f"holtWintersConfidenceLower({orig.name})", orig.path,
            lower, boot.step_nanos, start))
    return out


@_func("holtWintersAberration")
def _holt_winters_aberration(ctx, series, delta=3, bootstrap_interval="7d"):
    out = []
    for orig, boot, trim, start, pred, dev in _hw_forecast_parts(
            ctx, series, bootstrap_interval):
        upper = pred[trim:] + delta * dev[trim:]
        lower = pred[trim:] - delta * dev[trim:]
        actual = boot.values[trim:]
        ab = np.where(
            np.isnan(actual), 0.0,
            np.where(actual > upper, actual - upper,
                     np.where(actual < lower, actual - lower, 0.0)))
        ab = np.where(np.isnan(upper) | np.isnan(lower), 0.0, ab)
        out.append(GraphiteSeries(
            f"holtWintersAberration({orig.name})", orig.path,
            ab, boot.step_nanos, start))
    return out
