"""native/aggproxy: the port's copy of the single-core Go-aggregator
proxy (host C++, no device), held against the JAX package's
``m3_tpu.native.aggproxy`` on the same seeded samples: the timer
quantile matrix equal bit for bit (the same source, built the same
way), its quantiles the samples' own order statistics (exact) and its
means within rel 1e-12; the two timed rollups return positive seconds."""

from __future__ import annotations

import numpy as np
import pytest

from m3_tpu.native import aggproxy as ref
from m3_tpu_torch.native import aggproxy

N, CAP = 200_000, 4096


@pytest.fixture(scope="module")
def samples():
    rng = np.random.default_rng(7)
    ids = rng.integers(0, CAP, N).astype(np.uint32)
    return (ids, rng.integers(0, 1000, N).astype(np.int64), rng.gamma(2.0, 50.0, N),
            1_700_000_000 * 10**9 + rng.integers(0, 60, N).astype(np.int64) * 10**9)


def test_both_build():
    assert aggproxy.available() and ref.available()


@pytest.mark.parametrize("quantiles", [(0.5, 0.95, 0.99), (0.25, 0.5, 0.75, 0.999)])
def test_timer_quantiles_equal_the_references(samples, quantiles):
    ids, _, vals, _ = samples
    secs, got = aggproxy.timer_quantiles(ids, vals, CAP, quantiles)
    _, want = ref.timer_quantiles(ids, vals, CAP, quantiles)
    assert secs > 0
    assert got.shape == (CAP, len(quantiles) + 1)
    assert np.array_equal(got.view(np.uint64), want.view(np.uint64))
    # each id's quantiles are its own samples' order statistics; the last
    # column is its mean (the single-core Go path's work, not an estimate)
    mine = np.sort(vals[ids == 3])
    ranks = [min(max(int(np.ceil(q * mine.size)) - 1, 0), mine.size - 1) for q in quantiles]
    assert np.array_equal(got[3, :-1], mine[ranks])
    assert got[3, -1] == pytest.approx(mine.mean(), rel=1e-12)


def test_rollups_time_the_work(samples):
    ids, ivals, fvals, times = samples
    assert aggproxy.counter_rollup_ns(ids, ivals, CAP) > 0
    assert aggproxy.gauge_rollup_ns(ids, fvals, times, CAP) > 0
