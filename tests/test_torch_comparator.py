"""comparator: the port's naive PromQL oracle and harness, held against
the JAX package's.  The oracle equals ``m3_tpu.comparator.naive_promql``
bit for bit (every value, NaN where NaN) on the default corpus and on the
spot cases of tests/test_comparator.py; both packages' ``run_comparator``
find no mismatch (rtol 1e-9, atol 1e-9, the harness's) over the same
query count; and the port's comparator catches an injected bug."""

from __future__ import annotations

import math
import struct

import pytest

from m3_tpu.comparator import harness as ref_harness
from m3_tpu.comparator import naive_promql as ref_naive
from m3_tpu_torch.comparator import harness, naive_promql
from m3_tpu_torch.comparator.naive_promql import NaiveSeries

BLOCK = 2 * 3600 * 10**9
START = (1_700_000_000 * 10**9) // BLOCK * BLOCK
STEP = 10 * 10**9


def _bits(out: dict) -> dict:
    return {k: [struct.pack("<d", v) for v in vs] for k, vs in out.items()}


def test_corpus_and_series_are_the_references():
    assert harness.DEFAULT_CORPUS == ref_harness.DEFAULT_CORPUS
    ours = harness.generate_series(start=START, step=STEP, seed=5)
    theirs = ref_harness.generate_series(start=START, step=STEP, seed=5)
    assert [(s.tags, s.points) for s in ours] == [(s.tags, s.points) for s in theirs]


@pytest.mark.parametrize("query", harness.DEFAULT_CORPUS)
def test_oracle_equals_the_references_on_the_corpus(query):
    series = harness.generate_series(start=START, step=STEP)
    ref_series = [ref_naive.NaiveSeries(s.tags, s.points) for s in series]
    args = (START + 30 * STEP, START + 110 * STEP, 3 * STEP)
    ours = naive_promql.evaluate(query, series, *args)
    assert ours
    assert _bits(ours) == _bits(ref_naive.evaluate(query, ref_series, *args))


def _spot_cases():
    s1 = ((b"__name__", b"m"),), ((START, 5.0), (START + 10**9, 7.0))
    counter = ((b"__name__", b"c"),), tuple((START + k * 10 * 10**9, 10.0 * k)
                                           for k in range(20))
    mk = lambda job, v: (((b"__name__", b"m"), (b"job", job)), ((START, v),))
    return {
        "instant_and_staleness": ("m", [s1], START, START + 10 * 60 * 10**9, 60 * 10**9),
        "rate_constant_counter": ("rate(c[2m])", [counter], START + 150 * 10**9,
                                  START + 180 * 10**9, 30 * 10**9),
        "sum_by": ("sum by (job) (m)", [mk(b"a", 1.0), mk(b"a", 2.0), mk(b"b", 5.0)],
                   START, START, STEP),
    }


@pytest.mark.parametrize("case", sorted(_spot_cases()))
def test_oracle_equals_the_references_on_the_spot_cases(case):
    q, raw, start, end, step = _spot_cases()[case]
    ours = naive_promql.evaluate(q, [NaiveSeries(*r) for r in raw], start, end, step)
    theirs = ref_naive.evaluate(q, [ref_naive.NaiveSeries(*r) for r in raw], start, end, step)
    assert _bits(ours) == _bits(theirs)
    if case == "instant_and_staleness":
        vals = list(ours.values())[0]
        assert vals[0] == 5.0 and math.isnan(vals[-1])
    elif case == "rate_constant_counter":
        assert all(math.isclose(v, 1.0, rel_tol=1e-9) for v in list(ours.values())[0])
    else:
        assert ours[((b"job", b"a"),)] == [3.0] and ours[((b"job", b"b"),)] == [5.0]


def test_both_comparators_agree_with_their_oracle(tmp_path):
    ours = harness.run_comparator(str(tmp_path / "port"), device="cpu")
    theirs = ref_harness.run_comparator(str(tmp_path / "ref"))
    assert ours.mismatches == [] and theirs.mismatches == []
    assert ours.queries_run == theirs.queries_run == len(harness.DEFAULT_CORPUS)
    assert ours.values_compared == theirs.values_compared > 500


def test_detects_an_injected_bug(tmp_path):
    series = harness.generate_series(start=START, step=STEP, seed=3)
    db = harness.load_into_database(series, str(tmp_path), device="cpu")
    try:
        bad = series[0]
        series[0] = NaiveSeries(bad.tags, tuple((t, v + 100.0) for t, v in bad.points))
        report = harness.compare(db, series, ("sum(http_requests)",), START + 30 * STEP,
                                 START + 100 * STEP, 3 * STEP, device="cpu")
        assert not report.ok
    finally:
        db.close()
