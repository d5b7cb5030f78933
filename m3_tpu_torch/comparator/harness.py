"""Comparator harness: deterministic data + engine-vs-oracle diffing, the
counterpart of ``m3_tpu/comparator/harness.py``.

The reference's m3comparator service + comparator scripts
(`src/cmd/services/m3comparator/main/querier.go` serves deterministic
series; `scripts/comparator` runs identical PromQL against M3 and
Prometheus and diffs).  Here the deterministic generator seeds the
port's ``Database`` on a device, the port's ``Engine`` answers through
the full storage path (``DatabaseStorage``), and the naive evaluator
answers from the raw point lists — any disagreement beyond float
tolerance is a correctness finding in one of the two implementations.
Every entry point takes ``device=None``, which means CUDA.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from m3_tpu_torch.comparator.naive_promql import NaiveSeries, evaluate
from m3_tpu_torch.index.doc import Document
from m3_tpu_torch.query.engine import Engine
from m3_tpu_torch.query.storage_adapter import DatabaseStorage
from m3_tpu_torch.storage.database import Database, DatabaseOptions, NamespaceOptions

# the standard comparator query corpus (reference scripts/comparator
# queries.json role): every supported shape appears at least once
DEFAULT_CORPUS = (
    "http_requests",
    'http_requests{instance="i0"}',
    "rate(http_requests[2m])",
    "increase(http_requests[2m])",
    "delta(mem_usage[2m])",
    "avg_over_time(mem_usage[1m])",
    "max_over_time(mem_usage[2m])",
    "sum_over_time(http_requests[1m])",
    "count_over_time(http_requests[2m])",
    "sum(http_requests)",
    "sum by (job) (http_requests)",
    "avg by (instance) (mem_usage)",
    "max(mem_usage)",
    "count(http_requests)",
    "sum by (job) (rate(http_requests[2m]))",
    "mem_usage * 2",
    "mem_usage / 4",
)

DEFAULT_START = (1_700_000_000 * 10**9 // (2 * 3600 * 10**9)) * (2 * 3600 * 10**9)


def generate_series(num_series: int = 12, num_points: int = 120,
                    start: int = 0, step: int = 10 * 10**9,
                    seed: int = 42) -> list[NaiveSeries]:
    """Deterministic mixed counter/gauge corpus (querier.go generates
    seeded series the same way).  Counters reset occasionally; gauges
    follow a random walk; some series have gaps.  The same draws as the
    reference's, so a seed gives both packages the same series."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(num_series):
        is_counter = i % 2 == 0
        name = b"http_requests" if is_counter else b"mem_usage"
        tags = (
            (b"__name__", name),
            (b"instance", b"i%d" % (i % 4)),
            (b"job", b"job%d" % (i % 3)),
            (b"series", b"s%d" % i),
        )
        pts = []
        value = float(rng.uniform(10, 100))
        for k in range(num_points):
            if rng.random() < 0.05:
                continue  # gap
            t = start + k * step
            if is_counter:
                if rng.random() < 0.02:
                    value = 0.0  # counter reset
                value += float(rng.uniform(0, 10))
            else:
                value += float(rng.normal(0, 5))
            pts.append((t, round(value, 3)))
        out.append(NaiveSeries(tags, tuple(pts)))
    return out


def load_into_database(series: list[NaiveSeries], root: str, device=None) -> Database:
    """A fresh ``Database`` at ``root`` on ``device`` holding ``series``."""
    db = Database(
        DatabaseOptions(root=root),
        namespaces={"default": NamespaceOptions(
            num_shards=2, slot_capacity=1 << 12, sample_capacity=1 << 15
        )},
        device=device,
    )
    for s in series:
        tags = dict(s.tags)
        name = tags[b"__name__"]
        sid = name + b"{" + b",".join(
            k + b"=" + v for k, v in sorted(tags.items()) if k != b"__name__"
        ) + b"}"
        doc = Document.from_tags(sid, tags)
        ts = np.asarray([p[0] for p in s.points], np.int64)
        vals = np.asarray([p[1] for p in s.points], np.float64)
        db.write_tagged_batch("default", [doc] * len(ts), ts, vals)
    return db


@dataclass
class Mismatch:
    query: str
    tags: tuple
    step_index: int
    engine_value: float
    naive_value: float


@dataclass
class ComparisonReport:
    queries_run: int = 0
    series_compared: int = 0
    values_compared: int = 0
    mismatches: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.mismatches


NAN_SENTINEL = float("nan")


def compare(db: Database, series: list[NaiveSeries], queries,
            start: int, end: int, step: int,
            rtol: float = 1e-9, atol: float = 1e-9, device=None) -> ComparisonReport:
    """Run every query through BOTH implementations and diff (the engine
    on ``device``, None = CUDA)."""
    engine = Engine(DatabaseStorage(db, "default"), device=device)
    report = ComparisonReport()
    for q in queries:
        blk = engine.execute_range(q, start, end, step)
        got: dict[tuple, list[float]] = {}
        for i, meta in enumerate(blk.series):
            key = tuple((k, v) for k, v in meta.tags if k != b"__name__")
            got[key] = [float(v) for v in blk.values[i]]
        want = evaluate(q, series, start, end, step)
        want_keyed = {
            tuple((k, v) for k, v in key if k != b"__name__"): vals
            for key, vals in want.items()
        }
        report.queries_run += 1
        for key in set(got) | set(want_keyed):
            g = got.get(key)
            w = want_keyed.get(key)
            if g is None or w is None:
                # a series one side produced and the other didn't: every
                # non-NaN value is a mismatch
                vals = g if g is not None else w
                for i, v in enumerate(vals):
                    if not math.isnan(v):
                        report.mismatches.append(Mismatch(
                            q, key, i,
                            v if g is not None else NAN_SENTINEL,
                            v if w is not None else NAN_SENTINEL,
                        ))
                continue
            report.series_compared += 1
            for i, (gv, wv) in enumerate(zip(g, w)):
                report.values_compared += 1
                if math.isnan(gv) and math.isnan(wv):
                    continue
                if math.isnan(gv) != math.isnan(wv):
                    report.mismatches.append(Mismatch(q, key, i, gv, wv))
                    continue
                if not math.isclose(gv, wv, rel_tol=rtol, abs_tol=atol):
                    report.mismatches.append(Mismatch(q, key, i, gv, wv))
    return report


def run_comparator(root: str, queries=DEFAULT_CORPUS, seed: int = 42,
                   start: int = DEFAULT_START, device=None, num_series: int = 12,
                   num_points: int = 120) -> ComparisonReport:
    """One-call entry: generate, load, compare (the m3comparator run) on
    ``device`` (None = CUDA); the query range is points 30-110 of the
    reference's 120, scaled with ``num_points``."""
    step = 10 * 10**9
    series = generate_series(num_series, num_points, start=start, step=step, seed=seed)
    db = load_into_database(series, root, device=device)
    try:
        q_start = start + (30 * num_points // 120) * step
        q_end = start + (110 * num_points // 120) * step
        return compare(db, series, queries, q_start, q_end, 3 * step, device=device)
    finally:
        db.close()
