"""The port's query fanout (``m3_tpu_torch.query.fanout``) against the JAX
package's (``m3_tpu.query.fanout``) on the CPU.

Each scenario runs once through each package, over the same seeded
sources, and what each observed is compared: which source was asked for
which time band, the merged ``RawBlock`` (tags, timestamps, values and
counts exact), the warnings left on the bound deadline, and the type and
message of every error (``PartialResultError`` and its per-source
causes, a lone ``DeadlineExceeded`` or ``QueryLimitExceeded``).  The
fan-out's concurrency is shown with a barrier the sources must all reach
together, not with a wall-clock bound.
"""

import threading
import types

import numpy as np
import pytest

import m3_tpu.query.block as jblock
import m3_tpu.query.fanout as jfan
import m3_tpu.storage.limits as jlim
import m3_tpu.x.deadline as jdl
import m3_tpu_torch.query.block as tblock
import m3_tpu_torch.query.fanout as tfan
import m3_tpu_torch.storage.limits as tlim
import m3_tpu_torch.x.deadline as tdl

SEC = 10**9
MIN = 60 * SEC
HOUR = 3600 * SEC
DAY = 24 * HOUR
T0 = 1_700_000_000 * SEC

SIDES = {
    "torch": types.SimpleNamespace(fan=tfan, block=tblock, dl=tdl, lim=tlim),
    "jax": types.SimpleNamespace(fan=jfan, block=jblock, dl=jdl, lim=jlim),
}


def both(run):
    """Run ``run(pkg)`` through each package; assert they observed the
    same and return it."""
    got = {side: run(pkg) for side, pkg in SIDES.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _block_tuple(blk):
    return ([m.tags for m in blk.series], blk.ts.tolist(),
            [float(v).hex() for v in blk.values.ravel()], blk.counts.tolist())


class _Store:
    """A source over fixed per-series points; records the bands it was
    asked for.  ``error`` is raised (after ``delay_s``) instead."""

    def __init__(self, pkg, pts_by_tags, error=None, delay_s=0.0,
                 barrier=None, peer=None):
        self.pkg, self.pts_by_tags = pkg, pts_by_tags
        self.error, self.delay_s, self.barrier = error, delay_s, barrier
        self.calls = []
        if peer is not None:
            self.peer = peer

    def fetch_raw(self, name, matchers, start, end):
        self.calls.append((start, end))
        if self.barrier is not None:
            self.barrier.wait()
        if self.delay_s:
            threading.Event().wait(self.delay_s)
        if self.error is not None:
            raise self.error
        metas = [self.pkg.block.SeriesMeta(k) for k in sorted(self.pts_by_tags)]
        pts = [[(t, v) for t, v in self.pts_by_tags[m.tags] if start <= t < end]
               for m in metas]
        return self.pkg.block.RawBlock.from_lists(pts, metas)


def _random_points(rng, tags_list, lo, hi, n):
    """Seeded points per series in [lo, hi): some timestamps repeated
    across sources so the merge's later-wins rule shows."""
    grid = lo + (np.sort(rng.choice((hi - lo) // MIN, n, replace=False))
                 * MIN).astype(np.int64)
    return {tags: [(int(t), float(v)) for t, v in
                   zip(grid, rng.normal(0, 10, n).round(3))]
            for tags in tags_list}


# -- resolution-aware band selection ---------------------------------------


@pytest.mark.parametrize("case", range(24))
def test_band_selection_and_merge_equal(case):
    rng = np.random.default_rng(case)
    n_src = int(rng.integers(1, 5))
    res = sorted(rng.choice([10 * SEC, MIN, 5 * MIN, HOUR], n_src,
                            replace=False).tolist())
    ret = sorted(rng.choice([DAY, 2 * DAY, 7 * DAY, 30 * DAY, 365 * DAY],
                            n_src, replace=False).tolist())
    now = T0 + 400 * DAY
    tags = [((b"__name__", b"m"), (b"host", b"h%d" % i)) for i in range(3)]
    start = now - int(rng.choice([HOUR, 3 * DAY, 20 * DAY, 100 * DAY]))
    end = now - int(rng.choice([0, HOUR, 2 * DAY]))
    pts = [_random_points(np.random.default_rng([case, k]), tags,
                          now - 400 * DAY, now, 200) for k in range(n_src)]
    order = rng.permutation(n_src)  # construction order must not matter
    required = rng.random(n_src) < 0.7

    def run(pkg):
        stores = [_Store(pkg, pts[k]) for k in range(n_src)]
        fo = pkg.fan.FanoutStorage([
            pkg.fan.FanoutSource(stores[k], res[k], ret[k],
                                 required=bool(required[k]), name=f"s{k}")
            for k in order], now_fn=lambda: now)
        blk = fo.fetch_raw(b"m", (), start, end)
        return [s.calls for s in stores], _block_tuple(blk)

    calls, _ = both(run)
    assert any(calls)


def test_explicit_now_and_fast_path_equal():
    tags = ((b"__name__", b"m"),)

    def run(pkg):
        fine = _Store(pkg, {tags: [(T0 + MIN, 1.0)]})
        coarse = _Store(pkg, {tags: [(T0 + MIN, 9.0)]})
        fo = pkg.fan.FanoutStorage([
            pkg.fan.FanoutSource(coarse, MIN, 30 * DAY),
            pkg.fan.FanoutSource(fine, 10 * SEC, 2 * DAY)])
        blk = fo.fetch_raw(b"m", (), T0, T0 + HOUR, now_nanos=T0 + HOUR)
        return fine.calls, coarse.calls, _block_tuple(blk)

    fine_calls, coarse_calls, _ = both(run)
    assert fine_calls and not coarse_calls


def test_empty_sources_refused_equal():
    def run(pkg):
        out = []
        for cls in (pkg.fan.FanoutStorage, pkg.fan.FederatedStorage):
            with pytest.raises(ValueError) as e:
                cls([])
            out.append(str(e.value))
        return out

    both(run)


# -- federation ------------------------------------------------------------


@pytest.mark.parametrize("case", range(8))
def test_federated_merge_equal(case):
    rng = np.random.default_rng(100 + case)
    n = int(rng.integers(2, 5))
    tags = [((b"__name__", b"m"), (b"host", b"h%d" % i)) for i in range(5)]
    pts = [_random_points(np.random.default_rng([case, k]),
                          [tags[i] for i in rng.choice(5, 3, replace=False)],
                          T0, T0 + DAY, 50) for k in range(n)]

    def run(pkg):
        fed = pkg.fan.FederatedStorage(
            [_Store(pkg, p, peer=f"127.0.0.1:{9000 + k}") for k, p in enumerate(pts)])
        return _block_tuple(fed.fetch_raw(b"m", (), T0, T0 + DAY))

    both(run)


def test_stores_fetch_concurrently_in_both():
    def run(pkg):
        barrier = threading.Barrier(3, timeout=20)
        fed = pkg.fan.FederatedStorage(
            [_Store(pkg, {((b"r", b"%d" % i),): [(T0, float(i))]},
                    barrier=barrier) for i in range(3)])
        return _block_tuple(fed.fetch_raw(b"x", (), T0, T0 + HOUR))

    assert len(both(run)[0]) == 3


def _fail_scenarios(pkg):
    """Every failure shape, observed as (result or error type + message,
    per-source failure types + messages, warnings)."""
    tags = ((b"r", b"a"),)
    ok = lambda: _Store(pkg, {tags: [(T0, 1.0)]})  # noqa: E731
    lim = pkg.lim.QueryLimitExceeded("docs-matched", 10, 11)
    scen = {
        "fed_required_transport": pkg.fan.FederatedStorage(
            [ok(), _Store(pkg, {}, error=ConnectionError("down"))],
            required=[0, 1]),
        "fed_required_deadline": pkg.fan.FederatedStorage(
            [ok(), _Store(pkg, {}, error=pkg.dl.DeadlineExceeded("spent"))],
            required=[0, 1]),
        "fed_required_limit": pkg.fan.FederatedStorage(
            [ok(), _Store(pkg, {}, error=lim)], required=[1]),
        "fed_two_required": pkg.fan.FederatedStorage(
            [_Store(pkg, {}, error=ConnectionError("down a")),
             _Store(pkg, {}, error=ConnectionError("down b"))],
            required=[0, 1]),
        "fed_all_best_effort_fail": pkg.fan.FederatedStorage(
            [_Store(pkg, {}, error=ConnectionError("x"), peer="h:1"),
             _Store(pkg, {}, error=RuntimeError("y"))]),
        "fed_best_effort_warning": pkg.fan.FederatedStorage(
            [ok(), _Store(pkg, {}, error=ConnectionError("gone"), peer="h:2")]),
        "fan_single_best_effort": pkg.fan.FanoutStorage(
            [pkg.fan.FanoutSource(_Store(pkg, {}, error=ConnectionError("down")),
                                  SEC, 20 * DAY, required=False, name="remote")],
            now_fn=lambda: T0 + DAY),
        "fan_single_required": pkg.fan.FanoutStorage(
            [pkg.fan.FanoutSource(_Store(pkg, {}, error=ConnectionError("down")),
                                  SEC, 20 * DAY)], now_fn=lambda: T0 + DAY),
        "fan_single_overload": pkg.fan.FanoutStorage(
            [pkg.fan.FanoutSource(
                _Store(pkg, {}, error=pkg.dl.DeadlineExceeded("spent")),
                SEC, 20 * DAY, name="over")], now_fn=lambda: T0 + DAY),
        "fan_band_best_effort": pkg.fan.FanoutStorage(
            [pkg.fan.FanoutSource(ok(), SEC, 2 * HOUR, name="fine"),
             pkg.fan.FanoutSource(_Store(pkg, {}, error=OSError("disk")),
                                  MIN, 20 * DAY, required=False, name="coarse")],
            now_fn=lambda: T0 + DAY),
        "fan_band_required": pkg.fan.FanoutStorage(
            [pkg.fan.FanoutSource(ok(), SEC, 2 * HOUR, name="fine"),
             pkg.fan.FanoutSource(_Store(pkg, {}, error=OSError("disk")),
                                  MIN, 20 * DAY, name="coarse")],
            now_fn=lambda: T0 + DAY),
    }
    out = {}
    for name, st in scen.items():
        dl = pkg.dl.Deadline(30.0)
        with pkg.dl.bind(dl):
            try:
                res = ("ok", _block_tuple(st.fetch_raw(b"x", (), T0 - DAY,
                                                       T0 + DAY)))
            except Exception as e:  # noqa: BLE001 — the observation
                fails = getattr(e, "failures", None)
                res = (type(e).__name__, str(e), None if fails is None else
                       sorted((k, type(v).__name__, str(v))
                              for k, v in fails.items()))
        out[name] = (res, list(dl.warnings))
    return out


def test_failure_policy_equal():
    got = both(_fail_scenarios)
    assert got["fed_required_transport"][0][0] == "PartialResultError"
    assert got["fed_required_deadline"][0][0] == "DeadlineExceeded"
    assert got["fed_required_limit"][0][0] == "QueryLimitExceeded"
    assert got["fed_best_effort_warning"][0][0] == "ok"
    assert got["fed_best_effort_warning"][1]
    assert got["fan_single_best_effort"][1]


@pytest.mark.parametrize("late", ["fine", "coarse"])
def test_deadline_claims_a_straggler_band_equal(late):
    def run(pkg):
        tags = ((b"r", b"a"),)
        srcs = {
            name: _Store(pkg, {tags: [(T0 + DAY - HOUR if name == "fine"
                                       else T0 - DAY + HOUR, 1.0)]},
                         delay_s=2.0 if name == late else 0.0)
            for name in ("fine", "coarse")}
        fo = pkg.fan.FanoutStorage(
            [pkg.fan.FanoutSource(srcs["fine"], SEC, 2 * HOUR, name="fine"),
             pkg.fan.FanoutSource(srcs["coarse"], MIN, 20 * DAY,
                                  required=(late == "fine"), name="coarse")],
            now_fn=lambda: T0 + DAY)
        dl = pkg.dl.Deadline(0.3)
        with pkg.dl.bind(dl):
            try:
                res = ("ok", _block_tuple(fo.fetch_raw(b"x", (), T0 - DAY,
                                                       T0 + DAY)))
            except Exception as e:  # noqa: BLE001 — the observation
                res = (type(e).__name__, str(e))
        return res, list(dl.warnings)

    res, warnings = both(run)
    if late == "fine":
        assert res[0] == "DeadlineExceeded"
    else:
        assert res[0] == "ok" and any("coarse" in w for w in warnings)


def test_failure_error_mapping_equal():
    def run(pkg):
        out = []
        lim = pkg.lim.QueryLimitExceeded("series-read", 1, 2)
        for failures in ({"a": pkg.dl.DeadlineExceeded("x")}, {"a": lim},
                         {"a": ConnectionError("c")},
                         {"a": pkg.dl.DeadlineExceeded("x"), "b": lim}):
            e = pkg.fan._failure_error(failures)
            out.append((type(e).__name__, str(e),
                        e is next(iter(failures.values()))))
        return out

    both(run)


def test_workers_rebind_the_shared_deadline_in_both():
    def run(pkg):
        seen = []

        def job():
            seen.append(pkg.dl.current())
            return "r"

        dl = pkg.dl.Deadline(30.0)
        with pkg.dl.bind(dl):
            out = pkg.fan._fetch_concurrent([("a", job), ("b", job)])
        return out, all(s is dl for s in seen) and len(seen) == 2

    assert both(run) == (["r", "r"], True)


def test_straggler_cannot_overwrite_claimed_slot_in_both():
    def run(pkg):
        go = threading.Event()
        done = threading.Event()

        def slow():
            go.wait(5)
            done.set()
            return "late"

        with pkg.dl.bind(pkg.dl.Deadline(0.15)):
            out = pkg.fan._fetch_concurrent([("fast", lambda: "r"),
                                             ("slow", slow)])
        go.set()
        done.wait(5)
        threading.Event().wait(0.05)
        return out[0], type(out[1]).__name__, str(out[1])

    assert both(run)[1] == "DeadlineExceeded"
