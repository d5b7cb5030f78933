"""The port's Graphite engine (``m3_tpu_torch.query.graphite``) against the
JAX package's (``m3_tpu.query.graphite``) on the CPU.

Parse trees and ``ParseError`` messages are equal; glob paths translate
to the same index queries; ``GraphiteStorage.fetch``/``find`` answer the
same over a port ``Database`` on ``device="cpu"`` and a JAX ``Database``
fed the same seeded points (with the grid cap, the deadline check and
``ShardNotOwnedError`` skipping); and every one of the registered render
names renders the same series: names, paths, steps and starts exact,
values ``np.testing.assert_array_equal`` (NaN positions equal).
"""

import dataclasses

import numpy as np
import pytest

import m3_tpu.metrics.carbon as jcarbon
import m3_tpu.query.graphite as jg
import m3_tpu.storage.database as jdb
import m3_tpu.x.deadline as jdl
import m3_tpu_torch.metrics.carbon as tcarbon
import m3_tpu_torch.query.graphite as tg
import m3_tpu_torch.storage.database as tdb
import m3_tpu_torch.x.deadline as tdl

BLOCK = 2 * 3600 * 10**9
START = (1_700_000_000 * 10**9) // BLOCK * BLOCK
STEP = 10 * 10**9
T = 60
END = START + T * STEP

PATHS = [b"servers.web01.cpu", b"servers.web02.cpu", b"servers.db01.cpu",
         b"servers.web01.mem", b"servers.web02.mem", b"servers.db01.mem",
         b"a.b", b"a.b.c"]


def _points(seed=11):
    """Seeded points per path: cpu ~ N(50, 20) (negatives and drops
    included), mem small integers (repeats and zeros), ~15 % of the
    points missing."""
    rng = np.random.default_rng(seed)
    out = {}
    for p in PATHS:
        if p.endswith(b"mem"):
            vals = rng.integers(0, 4, T).astype(np.float64)
        else:
            vals = rng.normal(50.0, 20.0, T)
        keep = rng.random(T) >= 0.15
        ts = START + np.arange(T, dtype=np.int64) * STEP
        out[p] = (ts[keep], vals[keep])
    return out


def _db(mod, carbon, root):
    db = mod.Database(mod.DatabaseOptions(root=str(root)),
                      namespaces={"default": mod.NamespaceOptions(
                          num_shards=2, slot_capacity=1 << 10,
                          sample_capacity=1 << 12)},
                      **({"device": "cpu"} if mod is tdb else {}))
    for p, (ts, vals) in _points().items():
        db.write_tagged_batch("default", [carbon.path_to_document(p)] * len(ts),
                              ts, vals)
    return db


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    t = _db(tdb, tcarbon, tmp_path_factory.mktemp("torch"))
    j = _db(jdb, jcarbon, tmp_path_factory.mktemp("jax"))
    yield t, j
    t.close()
    j.close()


@pytest.fixture(scope="module")
def engines(dbs):
    t, j = dbs
    return (tg.GraphiteEngine(tg.GraphiteStorage(t)),
            jg.GraphiteEngine(jg.GraphiteStorage(j)))


def _tree(x):
    """A parse tree or index query as plain nested tuples."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(
            _tree(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, (tuple, list)):
        return tuple(_tree(v) for v in x)
    if hasattr(x, "__dict__") and type(x).__module__.startswith("m3_tpu"):
        return (type(x).__name__,) + tuple(
            (k, _tree(v)) for k, v in sorted(vars(x).items()))
    return x


def _same_series(t_out, j_out):
    assert len(t_out) == len(j_out)
    for a, b in zip(t_out, j_out):
        assert (a.name, a.path, a.step_nanos, a.start_nanos) == \
               (b.name, b.path, b.step_nanos, b.start_nanos)
        assert a.values.dtype == b.values.dtype == np.float64
        np.testing.assert_array_equal(a.values, b.values)


# -- parser ----------------------------------------------------------------

GOOD = [
    "sumSeries(servers.*.cpu)",
    "scale(sumSeries(servers.{web01,db01}.cpu), 0.5)",
    'alias(servers.web01.cpu, "x y")',
    "summarize(a.b, '1min', 'sum')",
    "f(a, key=1.5e3, other=true)",
    "404.count",
    "1min.load",
    "-3",
    "2.5",
    "movingAverage( servers.web[0-9]*.cpu , 5 )",
    "timeShift(sum(a.*), \"-1h\")",
    "group(a.b, a.b.c, servers.?eb01.mem)",
    "f()",
    "false",
]
BAD = [
    "sumSeries(a.b",
    "sumSeries(a.b))",
    "f(a, k=)",
    "'unterminated",
    "f(a b)",
    "",
    "(a)",
    "f(x=1 2)",
]


@pytest.mark.parametrize("text", GOOD)
def test_parse_trees_equal(text):
    assert _tree(tg.parse_target(text)) == _tree(jg.parse_target(text))


@pytest.mark.parametrize("text", BAD)
def test_parse_errors_equal(text):
    with pytest.raises(jg.ParseError) as je:
        jg.parse_target(text)
    with pytest.raises(tg.ParseError) as te:
        tg.parse_target(text)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("path", [
    "servers.*.cpu", "servers.web01.cpu", "servers.web0?.cpu",
    "servers.{web01,db01}.*", "servers.web[0-9]*.mem", "a.b", "*"])
def test_glob_translation_equal(path):
    assert _tree(tg.path_to_index_query(path)) == \
        _tree(jg.path_to_index_query(path))
    for comp in path.split("."):
        assert tg.glob_component_regex(comp) == jg.glob_component_regex(comp)


@pytest.mark.parametrize("comp", ["{a,b", "x[0-9"])
def test_glob_errors_equal(comp):
    with pytest.raises(jg.ParseError) as je:
        jg.glob_component_regex(comp)
    with pytest.raises(tg.ParseError) as te:
        tg.glob_component_regex(comp)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("text", ["now", "", "-1h", "-90s", "1700000000",
                                  "1700000000.5"])
def test_time_parsing_equal(text):
    now = START + 12345 * 10**9
    assert tg.parse_graphite_time(text, now) == jg.parse_graphite_time(text, now)


# -- storage bridge --------------------------------------------------------


@pytest.mark.parametrize("path", ["servers.*.cpu", "servers.{web01,db01}.*",
                                  "servers.*", "a.b", "a.*.c", "nope.*"])
def test_fetch_equal(dbs, path):
    t, j = dbs
    _same_series(tg.GraphiteStorage(t).fetch(path, START, END, STEP),
                 jg.GraphiteStorage(j).fetch(path, START, END, STEP))


@pytest.mark.parametrize("pattern", ["servers.*", "servers.web01.*", "a.*",
                                     "*", "servers.w*.*"])
def test_find_equal(dbs, pattern):
    t, j = dbs
    assert tg.GraphiteStorage(t).find(pattern) == \
        jg.GraphiteStorage(j).find(pattern)


def test_fetch_limits_and_errors_equal(dbs):
    t, j = dbs
    for args in ((START, START + 200 * STEP, STEP), (START, END, 0)):
        with pytest.raises(jg.ParseError) as je:
            jg.GraphiteStorage(j, max_points=100).fetch("a.b", *args)
        with pytest.raises(tg.ParseError) as te:
            tg.GraphiteStorage(t, max_points=100).fetch("a.b", *args)
        assert str(te.value) == str(je.value)
    assert tg.MAX_RENDER_POINTS == jg.MAX_RENDER_POINTS


def test_fetch_checks_the_deadline(dbs):
    t, j = dbs
    msgs = []
    for mod, dl_mod, db in ((tg, tdl, t), (jg, jdl, j)):
        dl = dl_mod.Deadline(0.0)
        with dl_mod.bind(dl), pytest.raises(dl_mod.DeadlineExceeded) as e:
            mod.GraphiteStorage(db).fetch("servers.*.cpu", START, END, STEP)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


class _Unowned:
    """A Database view whose reads of one series id raise the package's
    ShardNotOwnedError (a placement-scoped node's unowned shard)."""

    def __init__(self, db, err, sid):
        self.db, self.err, self.sid = db, err, sid

    def query_ids(self, *a):
        return self.db.query_ids(*a)

    def read(self, ns, sid, start, end):
        if sid == self.sid:
            raise self.err("default", 0)
        return self.db.read(ns, sid, start, end)


def test_fetch_skips_unowned_shards(dbs):
    t, j = dbs
    sid = b"servers.web02.cpu"
    got_t = tg.GraphiteStorage(_Unowned(t, tdb.ShardNotOwnedError, sid)).fetch(
        "servers.*.cpu", START, END, STEP)
    got_j = jg.GraphiteStorage(_Unowned(j, jdb.ShardNotOwnedError, sid)).fetch(
        "servers.*.cpu", START, END, STEP)
    _same_series(got_t, got_j)
    assert [s.path for s in got_t] == ["servers.db01.cpu", "servers.web01.cpu"]


# -- render functions: every registered name -------------------------------

TARGETS = {
    "sumSeries": "sumSeries(servers.*.cpu)",
    "sum": "sum(servers.*.mem)",
    "averageSeries": "averageSeries(servers.*.cpu)",
    "avg": "avg(servers.*.mem)",
    "maxSeries": "maxSeries(servers.*.cpu)",
    "minSeries": "minSeries(servers.*.cpu)",
    "diffSeries": "diffSeries(servers.*.cpu)",
    "multiplySeries": "multiplySeries(servers.*.mem)",
    "scale": "scale(servers.*.cpu, 0.5)",
    "offset": "offset(servers.*.cpu, -3)",
    "absolute": "absolute(offset(servers.*.cpu, -50))",
    "invert": "invert(servers.*.mem)",
    "derivative": "derivative(servers.*.cpu)",
    "nonNegativeDerivative": "nonNegativeDerivative(servers.*.cpu)",
    "perSecond": "perSecond(servers.*.cpu)",
    "integral": "integral(servers.*.cpu)",
    "keepLastValue": "keepLastValue(servers.*.cpu, 1)",
    "movingAverage": "movingAverage(servers.*.cpu, 5)",
    "movingSum": "movingSum(servers.*.cpu, 5)",
    "movingMax": "movingMax(servers.*.cpu, 5)",
    "movingMin": "movingMin(servers.*.cpu, 5)",
    "alias": 'alias(servers.web01.cpu, "x")',
    "aliasByNode": "aliasByNode(servers.*.cpu, 1, 2)",
    "timeShift": 'timeShift(sumSeries(servers.*.cpu), "-1min")',
    "summarize": 'summarize(servers.*.cpu, "1min", "avg")',
    "highestMax": "highestMax(servers.*.*, 2)",
    "highestAverage": "highestAverage(servers.*.*, 2)",
    "highestCurrent": "highestCurrent(servers.*.*, 2)",
    "lowestAverage": "lowestAverage(servers.*.*, 2)",
    "limit": "limit(servers.*.*, 3)",
    "sortByName": "sortByName(servers.*.*)",
    "sortByMaxima": "sortByMaxima(servers.*.*)",
    "averageAbove": "averageAbove(servers.*.*, 40)",
    "averageBelow": "averageBelow(servers.*.*, 40)",
    "maximumAbove": "maximumAbove(servers.*.*, 80)",
    "currentAbove": "currentAbove(servers.*.*, 30)",
    "groupByNode": 'groupByNode(servers.*.*, 2, "avg")',
    "aggregate": 'aggregate(servers.*.cpu, "median")',
    "group": "group(servers.web01.cpu, servers.db01.mem)",
    "aliasByMetric": "aliasByMetric(servers.*.*)",
    "aliasSub": r'aliasSub(servers.*.cpu, "web(\d+)", "w\1")',
    "aliasByTags": 'aliasByTags(servers.*.cpu, "__g1__", 2, "name")',
    "asPercent": "asPercent(servers.*.cpu, sumSeries(servers.*.cpu))",
    "changed": "changed(servers.*.mem)",
    "consolidateBy": 'consolidateBy(servers.*.cpu, "max")',
    "cumulative": "cumulative(servers.*.cpu)",
    "constantLine": "constantLine(42.5)",
    "threshold": 'threshold(10, "ten")',
    "identity": 'identity("t")',
    "timeFunction": 'timeFunction("t")',
    "time": 'time("t2")',
    "countSeries": "countSeries(servers.*.cpu, servers.*.mem)",
    "currentBelow": "currentBelow(servers.*.*, 30)",
    "maximumBelow": "maximumBelow(servers.*.*, 90)",
    "minimumAbove": "minimumAbove(servers.*.*, 0)",
    "minimumBelow": "minimumBelow(servers.*.*, 10)",
    "lowestCurrent": "lowestCurrent(servers.*.*, 2)",
    "highest": 'highest(servers.*.*, 2, "max")',
    "lowest": 'lowest(servers.*.*, 2, "current")',
    "delay": "delay(servers.*.cpu, 3)",
    "divideSeries": "divideSeries(servers.*.cpu, servers.db01.mem)",
    "divideSeriesLists": "divideSeriesLists(servers.*.cpu, servers.*.mem)",
    "exclude": 'exclude(servers.*.*, "web")',
    "grep": 'grep(servers.*.*, "web0[12]")',
    "fallbackSeries": "fallbackSeries(servers.nope.cpu, servers.web01.cpu)",
    "filterSeries": 'filterSeries(servers.*.*, "max", ">", 60)',
    "hitcount": 'hitcount(servers.*.cpu, "70s")',
    "integralByInterval": 'integralByInterval(servers.*.cpu, "2min")',
    "interpolate": "interpolate(servers.*.cpu, 1)",
    "isNonNull": "isNonNull(servers.*.cpu)",
    "logarithm": "logarithm(servers.*.cpu, 2)",
    "log": "log(servers.*.mem)",
    "mostDeviant": "mostDeviant(servers.*.*, 2)",
    "movingMedian": "movingMedian(servers.*.cpu, 4)",
    "movingWindow": 'movingWindow(servers.*.cpu, 4, "stddev")',
    "exponentialMovingAverage": "exponentialMovingAverage(servers.*.cpu, 5)",
    "stdev": "stdev(servers.*.cpu, 5, 0.5)",
    "stddevSeries": "stddevSeries(servers.*.cpu)",
    "rangeOfSeries": "rangeOfSeries(servers.*.cpu)",
    "nPercentile": "nPercentile(servers.*.cpu, 90)",
    "percentileOfSeries": "percentileOfSeries(servers.*.cpu, 50, true)",
    "pow": "pow(servers.*.cpu, 2)",
    "powSeries": "powSeries(servers.web01.mem, servers.web02.mem)",
    "offsetToZero": "offsetToZero(servers.*.cpu)",
    "removeAboveValue": "removeAboveValue(servers.*.cpu, 60)",
    "removeBelowValue": "removeBelowValue(servers.*.cpu, 40)",
    "removeAbovePercentile": "removeAbovePercentile(servers.*.cpu, 80)",
    "removeBelowPercentile": "removeBelowPercentile(servers.*.cpu, 20)",
    "removeEmptySeries": ('removeEmptySeries(group(servers.*.cpu, '
                          'timeShift(servers.web01.cpu, "1d")), 0.5)'),
    "round": "round(servers.*.cpu, 1)",
    "scaleToSeconds": "scaleToSeconds(servers.*.cpu, 60)",
    "smartSummarize": 'smartSummarize(servers.*.cpu, "1min", "max")',
    "sortBy": 'sortBy(servers.*.*, "max", true)',
    "sortByMinima": "sortByMinima(servers.*.*)",
    "sortByTotal": "sortByTotal(servers.*.*)",
    "squareRoot": "squareRoot(servers.*.cpu)",
    "substr": "substr(servers.*.cpu, 1, 2)",
    "sustainedAbove": 'sustainedAbove(servers.*.cpu, 40, "30s")',
    "sustainedBelow": 'sustainedBelow(servers.*.cpu, 60, "30s")',
    "transformNull": "transformNull(servers.*.cpu, -1)",
    "groupByNodes": 'groupByNodes(servers.*.*, "sum", 1)',
    "aggregateWithWildcards": 'aggregateWithWildcards(servers.*.*, "max", 1)',
    "sumSeriesWithWildcards": "sumSeriesWithWildcards(servers.*.*, 1)",
    "averageSeriesWithWildcards": "averageSeriesWithWildcards(servers.*.*, 1)",
    "multiplySeriesWithWildcards": "multiplySeriesWithWildcards(servers.*.mem, 1)",
    "weightedAverage": "weightedAverage(servers.*.cpu, servers.*.mem, 1)",
    "aggregateLine": 'aggregateLine(servers.*.cpu, "max")',
    "randomWalkFunction": 'randomWalkFunction("rw")',
    "randomWalk": 'randomWalk("rw2", 20)',
    "timeSlice": 'timeSlice(servers.*.cpu, "-8min", "-3min")',
    "cactiStyle": 'cactiStyle(servers.*.cpu, "si", "b")',
    "legendValue": 'legendValue(servers.*.cpu, "avg", "last", "nope", "si")',
    "dashed": "dashed(servers.*.cpu, 3)",
    "useSeriesAbove": 'useSeriesAbove(servers.*.cpu, 80, "cpu", "mem")',
    "applyByNode": 'applyByNode(servers.*.cpu, 1, "sumSeries(%.*)", "%.total")',
    "holtWintersForecast": 'holtWintersForecast(servers.*.cpu, "5min")',
    "holtWintersConfidenceBands": (
        'holtWintersConfidenceBands(servers.*.cpu, 2, "5min")'),
    "holtWintersAberration": 'holtWintersAberration(servers.*.cpu, 2, "5min")',
}


def test_targets_cover_every_registered_name():
    assert sorted(TARGETS) == tg.supported_functions() == jg.supported_functions()
    assert len(TARGETS) == 118


@pytest.mark.parametrize("name", sorted(TARGETS))
def test_every_function_renders_equal(engines, name):
    te, je = engines
    target = TARGETS[name]
    assert tg.parse_target(target).name == name
    t_out = te.render(target, START, END, STEP)
    j_out = je.render(target, START, END, STEP)
    assert t_out, target  # each target yields series
    _same_series(t_out, j_out)


@pytest.mark.parametrize("target", [
    "nosuch(a.b)", "timeShift(a.b)", 'aggregate(servers.*.cpu, "nope")',
    'highest(servers.*.*, 1, "nope")', "a.b 1"])
def test_render_errors_equal(engines, target):
    te, je = engines
    with pytest.raises(Exception) as jerr:
        je.render(target, START, END, STEP)
    with pytest.raises(Exception) as terr:
        te.render(target, START, END, STEP)
    assert type(terr.value).__name__ == type(jerr.value).__name__
    assert str(terr.value) == str(jerr.value)


def test_timeshift_placeholder_body_refuses_in_both():
    for mod in (tg, jg):
        with pytest.raises(mod.ParseError, match="GraphiteEngine"):
            mod._FUNCS["timeShift"](None, [], "1h")
