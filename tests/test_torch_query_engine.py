"""The port's PromQL engine (m3_tpu_torch.query) against the JAX
package's (m3_tpu.query), on the CPU.

* the parser (a copy): the same ASTs and the same errors;
* both engines over one in-memory storage that applies the selectors'
  matchers, ~110 queries covering every ``_eval`` branch: subqueries, @,
  offset, every temporal function, aggregations, binary operators with
  vector matching, set operators, math, date and label functions.
  Tolerance: the same series in the same order, NaN where the reference
  has NaN, and values within ``rtol`` 1e-9 plus 1e-9 of the row's
  largest |value|: the per-family bounds of ``test_torch_temporal.py``
  on this data (counters below 1e5, gauges near 50) lie well inside;
* ``_segment_reduce`` (the sort / scan / gather form on every device)
  against both of the reference's forms, the scatter form at ``rtol``
  1e-12 and its own sort form at 1e-15;
* the 15 hand-derived fixtures of ``tests/data/promql_semantics.json``
  through the port's engine at the fixture test's ``rel=1e-12``, with
  the known divergence still an expected failure;
* a spent deadline, the device rule, and the precision policy's cases
  (``tests/test_query_precision.py``) on the port's engine.
"""

import json
import math
import pathlib
import re

import numpy as np
import pytest
import torch

from m3_tpu.query import block as jblock
from m3_tpu.query import engine as jengine
from m3_tpu.query import functions as jfn
from m3_tpu.query import precision as jprec
from m3_tpu.query import promql as jpromql
from m3_tpu_torch.query import block as tblock
from m3_tpu_torch.query import engine as tengine
from m3_tpu_torch.query import functions as tfn
from m3_tpu_torch.query import precision as tprec
from m3_tpu_torch.query import promql as tpromql
from m3_tpu_torch.x import deadline as tdeadline

SEC = 10**9
START = 1_700_000_000 * SEC
STEP = 60 * SEC
QSTART = START + 10 * 60 * SEC
QEND = START + 38 * 60 * SEC


def _matches(m, tags) -> bool:
    val = tags.get(m.name, b"")
    if m.op == "=":
        return val == m.value
    if m.op == "!=":
        return val != m.value
    hit = re.fullmatch(m.value.decode(), val.decode()) is not None
    return hit if m.op == "=~" else not hit


class _ListStorage:
    """Series held in memory; ``fetch_raw`` applies the name and the
    matchers and keeps the points in [start, end), series in id order,
    series with no point in range left out."""

    def __init__(self, series, block_mod):
        self.series = sorted(series, key=lambda s: sorted(s[0].items()))
        self.block = block_mod

    def fetch_raw(self, name, matchers, start_nanos, end_nanos):
        pts, metas = [], []
        for tags, ts, vals in self.series:
            if name is not None and tags.get(b"__name__") != name:
                continue
            if not all(_matches(m, tags) for m in matchers):
                continue
            keep = (ts >= start_nanos) & (ts < end_nanos)
            if not keep.any():
                continue
            pts.append(list(zip(ts[keep].tolist(), vals[keep].tolist())))
            metas.append(self.block.SeriesMeta(tuple(sorted(tags.items()))))
        return self.block.RawBlock.from_lists(pts, metas)


def _corpus(seed=21):
    rng = np.random.default_rng(seed)
    N = 160
    out = []
    for host in range(4):
        for job in (b"api", b"db"):
            ts = START + np.cumsum(rng.integers(10, 20, N)) * SEC
            v = np.cumsum(rng.integers(0, 40, N) * (host + 1)).astype(float)
            if host == 2 and job == b"db":
                v[90:] -= v[90] - 3.0  # a counter reset
            out.append(({b"__name__": b"http_requests_total",
                         b"host": b"h%d" % host, b"job": job}, ts, v))
            g = np.round(rng.normal(50, 8, N), 2)
            g[rng.random(N) < 0.05] = np.nan
            out.append(({b"__name__": b"temp", b"host": b"h%d" % host, b"job": job},
                        ts, g))
    ts = START + np.arange(1, N + 1) * 15 * SEC
    for job in (b"api", b"db"):
        base = np.cumsum(rng.poisson(20, (4, N)), axis=1).cumsum(axis=0)
        for b, le in enumerate((b"0.1", b"0.5", b"1", b"+Inf")):
            out.append(({b"__name__": b"latency_bucket", b"job": job, b"le": le},
                        ts, base[b].astype(float)))
    return out


CORPUS = _corpus()

QUERIES = [
    # selectors, offset, @
    'http_requests_total{job="api"}',
    'temp{host=~"h[01]"}',
    'http_requests_total{job!="api", host!~"h3"} offset 2m',
    'http_requests_total{host="h0", job="api"} @ end()',
    'temp{job="db"} @ start()',
    f'rate(http_requests_total{{host="h0"}}[5m] @ {(QSTART + 6 * 60 * SEC) // SEC})',
    # temporal functions
    "rate(http_requests_total[5m])",
    "irate(http_requests_total[2m])",
    "increase(http_requests_total[5m])",
    "delta(temp[5m])",
    "idelta(temp[3m])",
    "sum_over_time(temp[5m])",
    "count_over_time(temp[5m])",
    "avg_over_time(temp[5m])",
    "stddev_over_time(temp[5m])",
    "stdvar_over_time(temp[5m])",
    "min_over_time(temp[5m])",
    "max_over_time(temp[5m])",
    "quantile_over_time(0.75, temp[5m])",
    "last_over_time(temp[2m])",
    "present_over_time(temp[5m])",
    "absent_over_time(temp[5m])",
    "absent_over_time(no_such_metric[5m])",
    "deriv(http_requests_total[10m])",
    "predict_linear(http_requests_total[10m], 600)",
    "resets(http_requests_total[10m])",
    "changes(temp[5m])",
    "holt_winters(temp[5m], 0.3, 0.6)",
    "rate(no_such_metric[5m])",
    # subqueries
    'max_over_time(rate(http_requests_total{job="api"}[5m])[10m:1m])',
    'avg_over_time(temp{host="h1"}[10m:])',
    "min_over_time(time()[10m:1m])",
    'last_over_time((http_requests_total{host="h0", job="api"} @ start())[10m:1m])',
    'sum_over_time(temp{job="api"}[10m:2m] offset 1m)',
    # histogram_quantile, aggregations
    "histogram_quantile(0.9, rate(latency_bucket[5m]))",
    "histogram_quantile(0.5, sum by (le) (rate(latency_bucket[5m])))",
    "sum by (job) (rate(http_requests_total[5m]))",
    "avg without (host) (temp)",
    "min(temp)", "max by (host) (temp)", "count(temp)",
    "stddev by (job) (temp)", "stdvar(temp)",
    "quantile by (job) (0.3, temp)",
    "topk(2, rate(http_requests_total[5m]))",
    "bottomk by (job) (1, temp)",
    "group by (job) (temp)",
    "topk(scalar(count(http_requests_total) > bool 0), http_requests_total)",
    # binary operators, vector matching, set operators
    'rate(http_requests_total{job="api"}[5m]) / on (host) rate(http_requests_total{job="db"}[5m])',
    'temp{job="api"} - ignoring (job) temp{job="db"}',
    "temp > 52", "temp > bool 52", "60 < temp", "2 ^ (temp / 20)",
    "temp % 7", "-temp * 3 + 1", "(1 + 2) * 3 > bool 8", "- (2 ^ 3)",
    'temp{job="api"} and temp{host="h1"}',
    'temp{host="h0"} or temp{job="db"}',
    'temp unless temp{host="h2"}',
    'http_requests_total > bool on (host, job) http_requests_total',
    # math, date, label and misc functions
    "abs(-temp)", "ceil(temp)", "floor(temp)", "exp(temp / 50)", "ln(temp)",
    "log2(temp)", "log10(temp)", "sqrt(temp)", "sgn(temp - 50)",
    "sin(temp)", "cos(temp)", "tan(temp / 100)", "asin(temp / 100)",
    "acos(temp / 100)", "atan(temp)", "sinh(temp / 50)", "cosh(temp / 50)",
    "tanh(temp / 50)", "asinh(temp)", "acosh(temp)", "atanh(temp / 100)",
    "deg(temp)", "rad(temp)", "pi()",
    "round(temp)", "round(temp, 5)",
    "clamp(temp, 45, 55)", "clamp_min(temp, 50)", "clamp_max(temp, 50)",
    "scalar(sum(temp))", "vector(time())", "vector(3)", "time()",
    "absent(no_such_metric)", "absent(temp)",
    'label_replace(temp, "node", "$1", "host", "h(.*)")',
    'label_join(temp, "hj", "-", "host", "job")',
    "timestamp(temp)",
    "sort(temp)", "sort_desc(temp)",
    "day_of_week()", "hour()", "minute(vector(1700000000))", "month()", "year()",
    "days_in_month()", "day_of_month()", "day_of_year(vector(1703980800))",
]

_ENGINES = {}


def _engines():
    if not _ENGINES:
        _ENGINES["jax"] = jengine.Engine(_ListStorage(CORPUS, jblock))
        _ENGINES["torch"] = tengine.Engine(_ListStorage(CORPUS, tblock), device="cpu")
    return _ENGINES["jax"], _ENGINES["torch"]


def _same_block(t, j, rtol=1e-9):
    assert [m.tags for m in t.series] == [m.tags for m in j.series]
    tv, jv = np.asarray(t.values), np.asarray(j.values)
    assert isinstance(t.values, np.ndarray) and tv.dtype == np.float64
    assert tv.shape == jv.shape
    np.testing.assert_array_equal(np.isnan(tv), np.isnan(jv))
    fin = np.isfinite(jv)
    np.testing.assert_array_equal(tv[~fin], jv[~fin])  # +-inf in place
    # each row's own largest |value| scales its absolute allowance
    scale = np.where(fin, np.abs(jv), 0.0).max(axis=-1, keepdims=True, initial=0.0)
    atol = np.broadcast_to(rtol * scale, jv.shape)
    assert (np.abs(tv[fin] - jv[fin]) <= atol[fin] + rtol * np.abs(jv[fin])).all(), (
        np.abs(tv - jv)[fin].max())


class TestParser:
    @pytest.mark.parametrize("q", QUERIES + [
        'sum(rate(x[1m])) by (job)', "a + b * c", "2 ^ 3 ^ 2",
        'x{a="b", c!~"d"}[5m] offset 1m', "a / on (host) group_left b",
        "max_over_time(rate(x[5m])[30m:1m])", "avg_over_time(y[1h:] offset 5m)"])
    def test_same_ast(self, q):
        try:
            want = repr(jpromql.parse(q))
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                tpromql.parse(q)
            return
        assert repr(tpromql.parse(q)) == want

    @pytest.mark.parametrize("q", ["rate(x[5m", "sum(", "x{a=b}", "1 +", ")"])
    def test_same_errors(self, q):
        with pytest.raises(ValueError) as je:
            jpromql.parse(q)
        with pytest.raises(ValueError, match=re.escape(str(je.value))):
            tpromql.parse(q)


@pytest.mark.parametrize("q", QUERIES)
def test_engine_matches_reference(q):
    je, te = _engines()
    with np.errstate(all="ignore"):
        j = je.execute_range(q, QSTART, QEND, STEP)
    t = te.execute_range(q, QSTART, QEND, STEP)
    _same_block(t, j)


def test_instant_query_matches_reference():
    je, te = _engines()
    for q in ("rate(http_requests_total[5m])", "sum(temp)", "temp"):
        _same_block(te.execute_instant(q, QEND), je.execute_instant(q, QEND))


def test_queries_reach_every_branch():
    """Every function of the reference's temporal set and every AST node
    kind appears in QUERIES."""
    text = " ".join(QUERIES)
    for f in sorted(jengine._TEMPORAL_ALL):
        assert f + "(" in text, f
    assert tengine._TEMPORAL_ALL == jengine._TEMPORAL_ALL
    assert set(tfn._UNARY) == set(jfn._UNARY)
    assert set(tfn._DATE_FNS) == set(jfn._DATE_FNS)
    for word in ("@", "offset", ":", " by ", " without ", " on ", " ignoring ",
                 " and ", " or ", " unless ", " bool "):
        assert word in text, word


@pytest.mark.parametrize("func", ["sum", "count", "avg", "stddev", "stdvar", "min", "max"])
def test_segment_reduce_matches_both_reference_forms(monkeypatch, func):
    import jax

    rng = np.random.default_rng(17)
    S, T, G = 200, 13, 23
    vals = np.round(rng.normal(0, 10, (S, T)), 5)
    vals[rng.random((S, T)) < 0.15] = np.nan
    vals[0, :] = np.nan  # one fully missing row
    gids = rng.integers(0, G, S).astype(np.int32)
    gids[gids == G - 1] = 0  # group G-1 is empty
    got = tfn._segment_reduce(torch.from_numpy(vals), gids, G, func).numpy()
    scatter = np.asarray(jfn._segment_reduce(vals, gids, G, func))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    sorted_form = np.asarray(jfn._segment_reduce(vals, gids, G, func))
    assert np.isnan(got[G - 1]).all()
    np.testing.assert_allclose(got, scatter, rtol=1e-12, atol=1e-12, equal_nan=True)
    np.testing.assert_allclose(got, sorted_form, rtol=1e-15, atol=0, equal_nan=True)


def test_segment_reduce_empty_block():
    got = tfn._segment_reduce(torch.zeros((0, 4), dtype=torch.float64),
                              np.zeros(0, np.int32), 2, "sum")
    assert got.shape == (2, 4) and torch.isnan(got).all()


# -- the hand-derived semantics fixtures ---------------------------------

BLOCK = 2 * 3600 * SEC
BASE = (1_600_000_000 * SEC) // BLOCK * BLOCK
FIXTURES = json.loads(
    (pathlib.Path(__file__).parent / "data" / "promql_semantics.json").read_text()
)["fixtures"]


def _val(x):
    return float("nan") if x == "NaN" else float(x)


@pytest.mark.parametrize("fixture", FIXTURES, ids=lambda f: f["name"])
def test_semantics_fixture(fixture):
    if "known_divergence" in fixture:
        pytest.xfail(fixture["known_divergence"])
    series = []
    for s in fixture["series"]:
        tags = {k.encode(): v.encode() for k, v in s["tags"].items()}
        ts = np.asarray([BASE + int(t) * SEC for t, _ in s["points"]], np.int64)
        series.append((tags, ts, np.asarray([_val(v) for _, v in s["points"]])))
    eng = tengine.Engine(_ListStorage(series, tblock), device="cpu")
    block = eng.execute_range(fixture["query"], BASE + fixture["start"] * SEC,
                              BASE + fixture["end"] * SEC, fixture["step"] * SEC)
    got = {}
    for i, meta in enumerate(block.series):
        key = tuple(sorted((k.decode(), v.decode()) for k, v in meta.tags))
        got[key] = block.values[i]
    assert len(got) == len(fixture["expect"]), sorted(got)
    for exp in fixture["expect"]:
        have = got[tuple(sorted(exp["tags"].items()))]
        want = np.asarray([_val(v) for v in exp["values"]])
        assert have.shape == want.shape
        for w, h in zip(want, have):
            if math.isnan(w):
                assert math.isnan(h)
            else:
                assert h == pytest.approx(w, rel=1e-12)


# -- deadline, device rule, precision policy ------------------------------


def test_spent_deadline_raises():
    _, te = _engines()
    dl = tdeadline.Deadline(0.0)
    with pytest.raises(tdeadline.DeadlineExceeded, match="deadline exceeded"):
        te.execute_range("sum(rate(http_requests_total[5m]))", QSTART, QEND, STEP,
                         deadline=dl)
    dl = tdeadline.Deadline(60.0)
    dl.cancel()
    with pytest.raises(tdeadline.QueryCancelled):
        te.execute_range("temp", QSTART, QEND, STEP, deadline=dl)


def test_engine_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.Engine(_ListStorage(CORPUS, tblock))
    assert tengine.Engine(_ListStorage(CORPUS, tblock), device="cpu").device.type == "cpu"


def test_tracer_records_the_execute_span():
    from m3_tpu_torch.instrument.tracing import Tracepoint, Tracer

    tr = Tracer()
    eng = tengine.Engine(_ListStorage(CORPUS, tblock), tracer=tr, device="cpu")
    eng.execute_range("temp", QSTART, QEND, STEP)
    spans = tr.finished(Tracepoint.ENGINE_EXECUTE)
    assert len(spans) == 1 and spans[0].tags == {"query": "temp"}


T0 = 1_700_000_000 * SEC


def _bucket_block(block_mod, G=40, B=4, P=261, seed=5, resets=False):
    """tests/test_query_precision.py's histogram series."""
    rng = np.random.default_rng(seed)
    ubs = [b"0.1", b"1", b"5", b"+Inf"]
    ts = np.tile(T0 + np.arange(P, dtype=np.int64) * 15 * SEC, (G * B, 1))
    incr = rng.poisson(3.0, (G, B, P)).astype(np.float64)
    if resets:
        r = rng.random((G, 1, P)) < 0.01
        incr = np.where(r, 0.0, incr)
    cum_t = np.cumsum(incr, axis=2)
    if resets:
        keep = np.maximum.accumulate(np.where(r, np.arange(P)[None, None, :], 0), axis=2)
        base = np.take_along_axis(cum_t, np.maximum(keep - 1, 0), axis=2)
        cum_t = np.where(keep > 0, cum_t - base, cum_t)
    vals = np.cumsum(cum_t, axis=1).reshape(G * B, P)
    series = [block_mod.SeriesMeta(((b"__name__", b"m"), (b"g", b"g%03d" % g),
                                    (b"le", ubs[b])))
              for g in range(G) for b in range(B)]
    return block_mod.RawBlock(np.ascontiguousarray(ts), vals,
                              np.full(G * B, P, np.int64), series)


class _RawStorage:
    def __init__(self, raw):
        self.raw = raw

    def fetch_raw(self, name, matchers, start_nanos, end_nanos):
        return self.raw


@pytest.fixture
def policy():
    def set_both(name):
        jprec.set_compute_dtype(name)
        tprec.set_compute_dtype(name)
    yield set_both
    set_both("f64")


def _two_policies(set_policy, eng, q, start, end, step):
    set_policy("f64")
    b64 = eng.execute_range(q, start, end, step)
    set_policy("f32")
    b32 = eng.execute_range(q, start, end, step)
    assert b32.values.dtype == np.float64
    np.testing.assert_array_equal(np.isnan(b64.values), np.isnan(b32.values))
    return b64.values, b32.values


class TestPrecisionPolicy:
    def test_invalid_dtype_rejected(self):
        with pytest.raises(ValueError, match="f32"):
            tprec.set_compute_dtype("f16")

    @pytest.mark.parametrize("q,resets,rel", [
        ("histogram_quantile(0.9, rate(m[5m]))", False, 1e-4),
        ("rate(m[5m])", True, 1e-4)])
    def test_f32_envelope_and_reference(self, policy, q, resets, rel):
        """The reference's envelope (f32 within ``rel`` of f64), and each
        policy against the reference's engine under the same policy."""
        start, end = T0 + 3600 * SEC, T0 + 2 * 3600 * SEC
        te = tengine.Engine(_RawStorage(_bucket_block(tblock, resets=resets)), device="cpu")
        je = jengine.Engine(_RawStorage(_bucket_block(jblock, resets=resets)))
        t64, t32 = _two_policies(policy, te, q, start, end, 15 * SEC)
        j64, j32 = _two_policies(policy, je, q, start, end, 15 * SEC)
        both = ~np.isnan(t64)
        assert np.max(np.abs(t64[both] - t32[both])
                      / np.maximum(np.abs(t64[both]), 1e-6)) < rel
        np.testing.assert_allclose(t64[both], j64[both], rtol=1e-12)
        np.testing.assert_allclose(t32[both], j32[both], rtol=4e-6)

    def test_f32_rate_long_span_large_counters(self, policy):
        rng = np.random.default_rng(9)
        P = 30 * 24 * 12
        ts = np.tile(T0 + np.arange(P, dtype=np.int64) * 300 * SEC, (4, 1))
        vals = np.cumsum(rng.gamma(2.0, 5.0, (4, P)), axis=1)
        raw = tblock.RawBlock(np.ascontiguousarray(ts), vals, np.full(4, P, np.int64),
                              [tblock.SeriesMeta(((b"__name__", b"c"), (b"i", b"%d" % i)))
                               for i in range(4)])
        eng = tengine.Engine(_RawStorage(raw), device="cpu")
        v64, v32 = _two_policies(policy, eng, "rate(c[15m])", T0 + 3600 * SEC,
                                 T0 + 30 * 24 * 3600 * SEC - 3600 * SEC, 3600 * SEC)
        both = ~np.isnan(v64)
        assert np.max(np.abs(v64[both] - v32[both])
                      / np.maximum(np.abs(v64[both]), 1e-9)) < 1e-5

    def test_comparison_ops_exempt_from_f32(self, policy):
        P = 8
        ts = np.tile(T0 + np.arange(P, dtype=np.int64) * 15 * SEC, (1, 1))
        raw = tblock.RawBlock(np.ascontiguousarray(ts), np.full((1, P), 16777217.0),
                              np.full(1, P, np.int64), [tblock.SeriesMeta(((b"__name__", b"a"),))])
        eng = tengine.Engine(_RawStorage(raw), device="cpu")
        policy("f32")
        blk = eng.execute_range("a > 16777216.5", T0 + 15 * SEC, T0 + 90 * SEC, 15 * SEC)
        assert len(blk.series) == 1 and not np.isnan(blk.values).all()

    def test_regression_family_stays_f64(self, policy):
        eng = tengine.Engine(_RawStorage(_bucket_block(tblock, G=4)), device="cpu")
        v64, v32 = _two_policies(policy, eng, "deriv(m[10m])", T0 + 3600 * SEC,
                                 T0 + 2 * 3600 * SEC, 15 * SEC)
        both = ~np.isnan(v64)
        np.testing.assert_array_equal(v64[both], v32[both])

    @pytest.mark.parametrize("q", ["max_over_time(x[5m])", "min_over_time(x[5m])",
                                   "last_over_time(x[5m])"])
    def test_inf_survives_the_f32_cast(self, policy, q):
        """nan_to_num before the policy cast: +-inf becomes +-f64 max, then
        +-inf again in f32 (not +-f32 max), as in the reference."""
        P = 40
        ts = np.tile(T0 + np.arange(P, dtype=np.int64) * 15 * SEC, (2, 1))
        vals = np.tile(np.linspace(1.0, 4.0, P), (2, 1))
        vals[0, 10], vals[1, 20], vals[0, 30] = np.inf, -np.inf, np.nan
        metas = [((b"__name__", b"x"), (b"i", b"%d" % i)) for i in range(2)]
        te = tengine.Engine(_RawStorage(tblock.RawBlock(
            ts, vals, np.full(2, P, np.int64), [tblock.SeriesMeta(m) for m in metas])),
            device="cpu")
        je = jengine.Engine(_RawStorage(jblock.RawBlock(
            ts, vals, np.full(2, P, np.int64), [jblock.SeriesMeta(m) for m in metas])))
        policy("f32")
        t = te.execute_range(q, T0 + 60 * SEC, T0 + 570 * SEC, 15 * SEC).values
        with np.errstate(over="ignore"):  # the reference casts f64 max on the host
            j = je.execute_range(q, T0 + 60 * SEC, T0 + 570 * SEC, 15 * SEC).values
        assert np.isinf(t).any()
        np.testing.assert_array_equal(t, j)
