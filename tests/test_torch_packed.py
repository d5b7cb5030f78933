"""The port's packed arenas (``m3_tpu_torch/aggregator/packed.py``) on the
CPU against ``m3_tpu.aggregator.packed``: each test of
tests/test_arena_packed.py, run as a comparison of the two packages on
the same inputs, every state field after every op (the JAX state read
through ``state_to_numpy``'s dtypes), plus a negative-slot clear for each
arena and the layout's place in the engine.

Tolerances.  Exact, bit for bit (NaN as one NaN): every counter field,
the overflow pool included; gauge count/min/max/last/last_time/last_at
and sum; the timer's sample words and every drained lane but the
moments of squares.  Gauge ``sum_sq`` and the timer's sum-of-squares
lane: ``rtol=SQ_RTOL`` (the lanes hold sums of non-negative terms, so
this is a few ulps of the segment's sum of v²).  XLA contracts the
square computed inside the same jit into an FMA with the scan's first
add; the port rounds the product first.  Measured on 2^20 points:
≤ 4.2e-16.  Stdev, derived from those moments: ``rtol=1e-12``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from m3_tpu.aggregator import arena as ja
from m3_tpu.aggregator import engine as je
from m3_tpu.aggregator import packed as jp
from m3_tpu.metrics.policy import StoragePolicy as JSP
from m3_tpu.metrics.types import MetricType as JMT
from m3_tpu_torch.aggregator import arena as ta
from m3_tpu_torch.aggregator import engine as te
from m3_tpu_torch.aggregator import packed as tp
from m3_tpu_torch.metrics.policy import StoragePolicy as TSP
from m3_tpu_torch.metrics.types import MetricType as TMT

SEC = 10**9
T0 = 1_700_000_000 * SEC
SQ_RTOL = 2e-15
TOL_FIELDS = {"sum_sq"}  # gauge state fields compared within SQ_RTOL
STDEV, SUM_SQ = 7, 6  # lane indices (arena.SCALAR_LANES)


def _batches(rng, n_batches, n, W, C, nonfinite=False):
    for _ in range(n_batches):
        windows = rng.integers(-1, W + 1, n).astype(np.int32)
        slots = rng.integers(-2, C + 3, n).astype(np.int32)
        cvals = rng.integers(-2000, 2000, n).astype(np.int64)
        gvals = np.round(rng.uniform(-50, 50, n), 3)
        gvals[rng.integers(0, n, max(n // 40, 1))] = 0.0
        gvals[rng.integers(0, n, max(n // 40, 1))] = -0.0
        if nonfinite:
            gvals[rng.integers(0, n, max(n // 50, 1))] = np.nan
            gvals[rng.integers(0, n, max(n // 100, 1))] = np.inf
            gvals[rng.integers(0, n, max(n // 100, 1))] = -np.inf
        times = T0 + rng.integers(0, SEC, n)
        yield windows, slots, cvals, gvals, times


def _np(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def _same_floats(g, w, what, rtol=None):
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=what)
    ok = ~np.isnan(w)
    if rtol is None:
        np.testing.assert_array_equal(g[ok].view(np.uint64), w[ok].view(np.uint64),
                                      err_msg=what)
    else:
        inf = ok & np.isinf(w)
        np.testing.assert_array_equal(g[inf], w[inf], err_msg=what)
        fin = ok & ~inf
        np.testing.assert_allclose(g[fin], w[fin], rtol=rtol, atol=0, err_msg=what)


def _assert_state(port, ref, what):
    """Every field of the port's state against the JAX state: same
    dtypes, same bits (gauge ``sum_sq`` within SQ_RTOL)."""
    got = ta.state_to_numpy(port)
    want = _np(ref)
    assert set(got) == set(want), what
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, (what, name, g.dtype, w.dtype)
        if w.dtype == np.float64:
            _same_floats(g, w, f"{what}.{name}", SQ_RTOL if name in TOL_FIELDS else None)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}.{name}")


def _assert_lanes(port, ref, what, tol_lanes=(SUM_SQ,)):
    """Consume outputs: counts exact; lanes bit-equal but stdev
    (rtol 1e-12) and ``tol_lanes`` (SQ_RTOL)."""
    (pl, pc), (jl, jc) = port, ref
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc), err_msg=what)
    pl, jl = pl.numpy(), np.asarray(jl)
    assert pl.shape == jl.shape, what
    for i in range(jl.shape[1]):
        if i == STDEV:
            np.testing.assert_allclose(pl[:, i], jl[:, i], rtol=1e-12, err_msg=f"{what} stdev")
        else:
            _same_floats(pl[:, i], jl[:, i], f"{what} lane {i}",
                         SQ_RTOL if i in tol_lanes else None)


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _copy(st):
    """The JAX ingests donate their state: hand them copies."""
    return type(st)(*[jnp.array(x) for x in st])


def _as_port(kind, ref_state):
    return ta.state_from_numpy(kind, _np(ref_state), "cpu")


class TestCounterGaugeParity:
    W, C = 2, 257  # odd capacity: no accidental alignment

    def test_multi_batch_parity_with_oob_and_nonfinite(self):
        rng = np.random.default_rng(11)
        jc, jg = jp.PackedCounterArena(self.W, self.C), jp.PackedGaugeArena(self.W, self.C)
        tc = tp.PackedCounterArena(self.W, self.C, device="cpu")
        tg = tp.PackedGaugeArena(self.W, self.C, device="cpu")
        for i, (windows, slots, cvals, gvals, times) in enumerate(_batches(
                rng, 5, 1500, self.W, self.C, nonfinite=True)):
            jc.ingest(*_j(windows, slots, cvals, times))
            tc.ingest(windows, slots, cvals, times)
            jg.ingest(*_j(windows, slots, gvals, times))
            tg.ingest(windows, slots, gvals, times)
            _assert_state(tc.state, jc.state, f"counter batch {i}")
            _assert_state(tg.state, jg.state, f"gauge batch {i}")
        for w in range(self.W):
            _assert_lanes(tc.consume(w), jc.consume(w), f"counter w{w}", tol_lanes=())
            _assert_lanes(tg.consume(w), jg.consume(w), f"gauge w{w}")
        # window-dropped samples with a valid slot bumped last_at (ghosts)
        assert int(tc.state.last_at.max()) > 0

    def test_gauge_last_tie_first_arrival_wins(self):
        ja_, ta_ = jp.PackedGaugeArena(1, 8), tp.PackedGaugeArena(1, 8, device="cpu")
        args = (np.zeros(3, np.int32), np.zeros(3, np.int32), np.asarray([1.25, 2.5, 9.0]),
                np.asarray([T0, T0, T0 - 1], np.int64))  # two tied, one older
        ja_.ingest(*_j(*args))
        ta_.ingest(*args)
        _assert_state(ta_.state, ja_.state, "gauge tie")
        assert float(ta_.consume(0)[0][0, 0]) == 1.25  # first arrival of max time

    def test_gauge_signed_zeros_and_infinities(self):
        """min/max as ``jnp.minimum`` / ``jnp.maximum``: -0 below +0, in
        the scan (a segment holding both) and in the merge (one-point
        batches, which skip the scan and keep their -0), and ±inf."""
        jga, tga = jp.PackedGaugeArena(1, 8), tp.PackedGaugeArena(1, 8, device="cpu")
        batches = [
            ([0, 1], [-0.0, 0.0]),
            ([0], [0.0]),
            ([1], [-0.0]),
            ([0, 0, 0, 1, 1, 2, 2, 2], [0.0, -0.0, 0.0, -0.0, -0.0, np.inf, -np.inf, -0.0]),
            ([2], [np.nan]),
            ([3, 3, 3], [-np.inf, np.inf, np.nan]),
        ]
        for i, (slots, vals) in enumerate(batches):
            n = len(slots)
            args = (np.zeros(n, np.int32), np.asarray(slots, np.int32), np.asarray(vals),
                    np.full(n, T0 + i, np.int64))
            jga.ingest(*_j(*args))
            tga.ingest(*args)
            _assert_state(tga.state, jga.state, f"batch {i}")
        _assert_lanes(tga.consume(0), jga.consume(0), "signed zeros")
        # slot 1's -0 came in a one-point batch; slot 0's zeros all went
        # through the scan, which returns +0
        assert np.signbit(tga.state.min[:2].numpy()).tolist() == [False, True]

    def test_reset_and_clear_parity(self):
        rng = np.random.default_rng(13)
        jc = jp.PackedCounterArena(self.W, self.C)
        tc = tp.PackedCounterArena(self.W, self.C, device="cpu")
        for windows, slots, cvals, _g, times in _batches(rng, 3, 1000, self.W, self.C):
            cvals[:5] = 1 << 40  # a few promotions into the pool
            jc.ingest(*_j(windows, slots, cvals, times))
            tc.ingest(windows, slots, cvals, times)
            _assert_state(tc.state, jc.state, "counter ingest")
        assert int(tc.state.pool_n) > 0
        # two promoted slots among them: their pool rows are released
        drop = np.asarray([int(o) % self.C for o in np.asarray(jc.state.pool_owner)
                           if o >= 0][:2] + [3, 17, 100, 256], np.int32)
        jc.clear_slots(drop)
        tc.clear_slots(drop)
        _assert_state(tc.state, jc.state, "counter clear")
        assert int(tc.consume(0)[1][drop].sum()) == 0
        for w in range(self.W):
            _assert_lanes(tc.consume(w), jc.consume(w), f"after clear w{w}", tol_lanes=())
        jc.reset_window(0)
        tc.reset_window(0)
        _assert_state(tc.state, jc.state, "counter reset")
        assert int(tc.consume(0)[1].sum()) == 0

    def test_fused_rollup_matches_separate_ops(self):
        rng = np.random.default_rng(17)
        tc = tp.PackedCounterArena(self.W, self.C, device="cpu")
        tg = tp.PackedGaugeArena(self.W, self.C, device="cpu")
        cs, gs = jp.counter_init(self.W, self.C), jp.gauge_init(self.W, self.C)
        pcs, pgs = tp.counter_init(self.W, self.C, device="cpu"), tp.gauge_init(
            self.W, self.C, device="cpu")
        for windows, slots, cvals, gvals, times in _batches(
                rng, 3, 1200, self.W, self.C, nonfinite=True):
            tc.ingest(windows, slots, cvals, times)
            tg.ingest(windows, slots, gvals, times)
            jidx = jp.packed_flat_index(*_j(windows, slots), self.W, self.C)
            cs, gs = jp.rollup_ingest(cs, gs, jidx, *_j(cvals, gvals, times), self.W, self.C)
            tidx = tp.packed_flat_index(*_t(windows, slots), self.W, self.C)
            np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
            pcs, pgs = tp.rollup_ingest(pcs, pgs, tidx, *_t(cvals, gvals, times),
                                        self.W, self.C)
            _assert_state(pcs, cs, "rollup counter")
            _assert_state(pgs, gs, "rollup gauge")
        for w in range(self.W):
            for (a, _), (b, _b) in ((tc.consume(w), tp.counter_consume(pcs, w, self.C)),
                                    (tg.consume(w), tp.gauge_consume(pgs, w, self.C))):
                _same_floats(b.numpy(), a.numpy(), f"rollup vs separate w{w}")


def _counter_pair(W, C, pool, widths=jp.DEFAULT_WIDTHS):
    return (jp.counter_init(W, C, pool_capacity=pool, widths=widths),
            tp.counter_init(W, C, pool_capacity=pool, widths=widths, device="cpu"))


def _counter_step(pair, win, slots, vals, times, W, C, widths=jp.DEFAULT_WIDTHS, what=""):
    js, ts = pair
    jidx = jp.packed_flat_index(*_j(win, slots), W, C)
    js = jp.counter_ingest(js, jidx, *_j(vals, times), W, C, widths=widths)
    tidx = tp.packed_flat_index(*_t(win, slots), W, C)
    ts = tp.counter_ingest(ts, tidx, *_t(vals, times), W, C, widths=widths)
    _assert_state(ts, js, what or "counter ingest")
    return js, ts


def _counter_consume(pair, w, C, widths=jp.DEFAULT_WIDTHS):
    js, ts = pair
    port = tp.counter_consume(ts, w, C, widths)
    _assert_lanes(port, jp.counter_consume(js, jnp.int32(w), C, widths=widths),
                  "counter consume", tol_lanes=())
    return port[0].numpy(), port[1].numpy()


class TestOverflowPool:
    """SALSA/Counter-Pools promotion boundaries with narrow widths."""

    def test_promotion_preserves_exact_stats(self):
        W, C, widths = 1, 64, (4, 6)  # count saturates at 15, |sum| at 32
        pair = _counter_pair(W, C, 16, widths)
        f64 = ta.CounterArena(W, C, device="cpu")
        rng = np.random.default_rng(5)
        for _ in range(4):
            slots = rng.integers(0, 8, 50).astype(np.int32)  # hot slots
            vals = rng.integers(-5, 6, 50).astype(np.int64)
            times = np.full(50, T0, np.int64)
            win = np.zeros(50, np.int32)
            pair = _counter_step(pair, win, slots, vals, times, W, C, widths)
            f64.ingest(win, slots, vals, times)
        assert int(pair[1].pool_n) > 0 and int(pair[1].err) == 0
        lanes, cnt = _counter_consume(pair, 0, C, widths)
        want, wcnt = (x.numpy() for x in f64.consume(0))
        np.testing.assert_array_equal(cnt, wcnt)
        _same_floats(lanes[:, :7], want[:, :7], "packed vs f64")

    def test_wide_value_promotes_immediately(self):
        W, C, big = 1, 16, 1 << 40
        pair = _counter_pair(W, C, 8)
        pair = _counter_step(pair, np.zeros(2, np.int32), np.asarray([3, 3], np.int32),
                             np.asarray([big, -big]), np.asarray([T0, T0]), W, C)
        assert int(pair[1].pool_n) == 1 and int(pair[1].err) == 0
        lanes, cnt = _counter_consume(pair, 0, C)
        assert cnt[3] == 2 and lanes[3, 1] == float(-big) and lanes[3, 2] == float(big)
        assert lanes[3, 5] == 0.0

    @pytest.mark.parametrize("sign", [1, -1])
    def test_virgin_slot_all_wide_batch_no_sentinel_minmax(self, sign):
        W, C = 1, 16
        vals = np.asarray([1 << 40, (1 << 40) + 5], np.int64) * sign
        pair = _counter_step(_counter_pair(W, C, 8), np.zeros(2, np.int32),
                             np.asarray([7, 7], np.int32), vals, np.asarray([T0, T0]), W, C)
        lanes, cnt = _counter_consume(pair, 0, C)
        assert cnt[7] == 2 and lanes[7, 1] == float(vals.min())
        assert lanes[7, 2] == float(vals.max())

    def test_promoted_slot_accumulates_across_batches(self):
        W, C, widths = 1, 16, (4, 6)
        pair = _counter_pair(W, C, 8, widths)
        for i in range(6):
            pair = _counter_step(pair, np.zeros(20, np.int32), np.full(20, 5, np.int32),
                                 np.full(20, 3, np.int64), np.full(20, T0 + i), W, C, widths)
        assert int(pair[1].err) == 0
        lanes, cnt = _counter_consume(pair, 0, C, widths)
        assert cnt[5] == 120 and lanes[5, 5] == 360.0 and lanes[5, 6] == 1080.0

    def test_pool_exhaustion_sets_err_and_consume_raises(self):
        W, C, widths = 1, 64, (4, 6)
        jpa = jp.PackedCounterArena(W, C, pool_capacity=2, widths=widths)
        tpa = tp.PackedCounterArena(W, C, pool_capacity=2, widths=widths, device="cpu")
        rng = np.random.default_rng(7)
        for _ in range(6):
            args = (np.zeros(200, np.int32), rng.integers(0, 32, 200).astype(np.int32),
                    rng.integers(-5, 6, 200), np.full(200, T0, np.int64))
            jpa.ingest(*_j(*args))
            tpa.ingest(*args)
            _assert_state(tpa.state, jpa.state, "exhaustion ingest")
        assert int(tpa.state.err) != 0
        with pytest.raises(RuntimeError, match="overflow-pool") as port_err:
            tpa.consume(0)
        assert isinstance(port_err.value, tp.DeviceStateError)
        with pytest.raises(RuntimeError, match="overflow-pool") as ref_err:
            jpa.consume(0)
        head = lambda e: str(e.value).split(" — ")[0]
        assert head(port_err) == head(ref_err)
        # raise once, then clear: the next consume proceeds
        _assert_state(tpa.state, jpa.state, "after the raise")
        _assert_lanes(tpa.consume(0), jpa.consume(0), "after the raise", tol_lanes=())

    def test_clear_slots_releases_pool_rows_for_reuse(self):
        W, C, widths = 1, 32, (4, 6)
        jpa = jp.PackedCounterArena(W, C, pool_capacity=4, widths=widths)
        tpa = tp.PackedCounterArena(W, C, pool_capacity=4, widths=widths, device="cpu")
        for cycle in range(12):  # 12 promotions through a 4-row pool
            slot = cycle % 8
            args = (np.zeros(40, np.int32), np.full(40, slot, np.int32),
                    np.ones(40, np.int64), np.full(40, T0, np.int64))
            jpa.ingest(*_j(*args))
            tpa.ingest(*args)
            _assert_state(tpa.state, jpa.state, f"cycle {cycle} ingest")
            assert int(tpa.state.err) == 0 and int(tpa.state.pool_n) == 1
            assert int(tpa.consume(0)[1][slot]) == 40
            jpa.clear_slots(np.asarray([slot], np.int32))
            tpa.clear_slots(np.asarray([slot], np.int32))
            _assert_state(tpa.state, jpa.state, f"cycle {cycle} clear")
            assert int(tpa.state.pool_n) == 0

    def test_pool_full_never_aliases_other_rows(self):
        W, C, widths = 1, 32, (4, 6)
        pair = _counter_pair(W, C, 1, widths)
        for _ in range(2):  # two hot slots, one pool row
            pair = _counter_step(pair, np.zeros(40, np.int32),
                                 np.asarray([2] * 20 + [9] * 20, np.int32),
                                 np.ones(40, np.int64), np.full(40, T0), W, C, widths)
        st = pair[1]
        assert int(st.err) & 2
        lanes, cnt = _counter_consume(pair, 0, C, widths)
        assert int(st.pool_idx[2] >= 0) + int(st.pool_idx[9] >= 0) == 1
        loser = 9 if int(st.pool_idx[2]) >= 0 else 2
        winner = 2 if loser == 9 else 9
        assert cnt[winner] == 40 and cnt[loser] <= 15 and int(st.pool_idx[loser]) == -1

    def test_layout_arg_validation(self):
        with pytest.raises(ValueError, match="unknown arena layout"):
            ta.make_arenas(1, 8, 32, (0.5,), layout="packd", device="cpu")
        for layout in (None, "", "auto", "packed"):
            c, g, t = ta.make_arenas(1, 8, 32, (0.5,), layout=layout, device="cpu")
            assert isinstance(c, tp.PackedCounterArena)
            assert isinstance(g, tp.PackedGaugeArena) and isinstance(t, tp.PackedTimerArena)
        assert ta.resolve_layout_arg("auto") == ja.resolve_layout_arg("auto") == "packed"

    def test_reset_window_zeroes_promoted_rows(self):
        W, C, widths = 2, 16, (4, 6)
        pair = _counter_step(_counter_pair(W, C, 8, widths), np.zeros(100, np.int32),
                             np.full(100, 2, np.int32), np.ones(100, np.int64),
                             np.full(100, T0), W, C, widths)
        assert int(pair[1].pool_n) == 1
        pair = (jp.counter_reset_window(pair[0], jnp.int32(0), W, C, widths=widths),
                tp.counter_reset_window(pair[1], 0, W, C, widths))
        _assert_state(pair[1], pair[0], "reset")
        assert int(_counter_consume(pair, 0, C, widths)[1].sum()) == 0
        # the slot stays promoted; new data accumulates in the pool row
        pair = _counter_step(pair, np.zeros(3, np.int32), np.full(3, 2, np.int32),
                             np.full(3, 7, np.int64), np.full(3, T0), W, C, widths)
        lanes, cnt = _counter_consume(pair, 0, C, widths)
        assert cnt[2] == 3 and lanes[2, 5] == 21.0


class TestPackedTimer:
    Q = (0.5, 0.95, 0.99)

    def _pair(self, W, C, scap):
        return jp.PackedTimerArena(W, C, scap), tp.PackedTimerArena(W, C, scap, device="cpu")

    def test_timer_parity_vs_packed32_oracle(self):
        W, C = 1, 97
        rng = np.random.default_rng(23)
        jpa, tpa = self._pair(W, C, 4096)
        f64 = ta.TimerArena(W, C, 4096, packed32=True, device="cpu")
        for _ in range(3):
            n = 1000
            args = (np.zeros(n, np.int32), rng.integers(-2, C + 2, n).astype(np.int32),
                    np.round(rng.gamma(2.0, 50.0, n), 3), T0 + rng.integers(0, SEC, n))
            args[2][:20] = [-0.0, 0.0] * 10
            jpa.ingest(*_j(*args))
            tpa.ingest(*args)
            f64.ingest(*args)
            _assert_state(tpa.state, jpa.state, "timer ingest")
        port = tpa.consume(0)
        _assert_lanes(port, jpa.consume(0), "timer consume")
        # against the port's f64 timer with the packed32 drain: the same
        # f32 words, so min/max/quantiles identical, moments within 1e-6
        tl, tc = (x.numpy() for x in f64.consume(0))
        pl, pc = (x.numpy() for x in port)
        np.testing.assert_array_equal(tc, pc)
        for lane in (1, 2, 8, 9, 10):
            np.testing.assert_array_equal(tl[:, lane], pl[:, lane])
        for lane in (3, 4, 5, 6):
            fin = np.abs(tl[:, lane]) > 0
            np.testing.assert_allclose(pl[fin, lane], tl[fin, lane], rtol=1e-6)

    def test_timer_exact_vs_f64_quantiles_within_f32(self):
        W, C = 1, 31
        rng = np.random.default_rng(29)
        jpa, tpa = self._pair(W, C, 2048)
        f64 = ta.TimerArena(W, C, 2048, device="cpu")
        n = 800
        args = (np.zeros(n, np.int32), rng.integers(0, C, n).astype(np.int32),
                np.round(rng.gamma(2.0, 50.0, n), 3), np.full(n, T0, np.int64))
        for a in (f64, tpa):
            a.ingest(*args)
        jpa.ingest(*_j(*args))
        _assert_state(tpa.state, jpa.state, "timer ingest")
        port = tpa.consume(0)
        _assert_lanes(port, jpa.consume(0), "timer consume")
        tl = f64.consume(0)[0].numpy()[:, 8:]
        pl = port[0].numpy()[:, 8:]
        nz = np.abs(tl) > 0
        assert float((np.abs(tl - pl)[nz] / np.abs(tl[nz])).max()) < 1e-6

    def test_timer_grow_and_clear(self):
        jpa, tpa = self._pair(1, 8, 4)
        for i in range(4):
            args = (np.zeros(4, np.int32), np.asarray([1, 1, 2, 3], np.int32),
                    np.asarray([1.0 + i, 2.0, 3.0, 4.0]), np.full(4, T0, np.int64))
            jpa.ingest(*_j(*args))
            tpa.ingest(*args)
            assert tpa.sample_capacity == jpa.sample_capacity
            _assert_state(tpa.state, jpa.state, f"grow {i}")
        assert tpa.sample_capacity >= 8  # grew, no drops
        _assert_lanes(tpa.consume(0), jpa.consume(0), "grown")
        jpa.clear_slots(np.asarray([1], np.int32))
        tpa.clear_slots(np.asarray([1], np.int32))
        _assert_state(tpa.state, jpa.state, "clear")
        lanes, cnt = tpa.consume(0)
        assert cnt[1] == 0 and cnt[2] == 4  # slot 1 retargeted
        jpa.reset_window(0)
        tpa.reset_window(0)
        _assert_state(tpa.state, jpa.state, "reset")
        assert list(tpa._sample_n_host) == list(jpa._sample_n_host) == [0]


@pytest.fixture(scope="module")
def ingested_states():
    """One JAX state per packed arena, after two batches with promotions."""
    W, C = 2, 64
    rng = np.random.default_rng(41)
    c = jp.PackedCounterArena(W, C, pool_capacity=16)
    g = jp.PackedGaugeArena(W, C)
    t = jp.PackedTimerArena(W, C, 512)
    for windows, slots, cvals, gvals, times in _batches(rng, 2, 300, W, C, nonfinite=True):
        cvals[slots == C - 1] = 1 << 33  # slot C-1 promotes
        c.ingest(*_j(windows, slots, cvals, times))
        g.ingest(*_j(windows, slots, gvals, times))
        t.ingest(*_j(windows, slots, np.abs(np.nan_to_num(gvals)), times))
    assert int(c.state.pool_n) > 0
    return W, C, {"packed_counter": c.state, "packed_gauge": g.state, "packed_timer": t.state}


@pytest.mark.parametrize("kind", ["packed_counter", "packed_gauge", "packed_timer"])
def test_clear_slots_negative_slots_match_jax(ingested_states, kind):
    """A negative slot wraps as in the reference: the flat index w*C + s
    wraps once by W*C (dropped if still negative), last_at's by C; a
    pool row and a timer word are matched on the slot as given, so the
    wrapped slot C-1 keeps its pool row and its buffered samples."""
    W, C, states = ingested_states
    st = states[kind]
    slots = np.asarray([-1, -C - 3, -2 * C + 1, -2 * C - 1, -3 * C, 6, C, C + 4], np.int32)
    name = kind.split("_")[1]
    jfn, tfn = getattr(jp, f"{name}_clear_slots"), getattr(tp, f"{name}_clear_slots")
    ref = jfn(_copy(st), jnp.asarray(slots), W, C)
    port = tfn(_as_port(kind, st), torch.from_numpy(slots), W, C)
    _assert_state(port, ref, f"{kind} clear negative")


@pytest.mark.parametrize("kind", ["packed_counter", "packed_gauge", "packed_timer"])
def test_state_round_trip_is_lossless(ingested_states, kind):
    """uint64 and uint32 lanes and the 0-d pool_n / err come back with
    their dtypes and bytes."""
    arrays = _np(ingested_states[2][kind])
    back = ta.state_to_numpy(ta.state_from_numpy(kind, arrays, "cpu"))
    for name, a in arrays.items():
        assert back[name].dtype == a.dtype and back[name].shape == a.shape, (kind, name)
        assert back[name].tobytes() == a.tobytes(), (kind, name)
    with pytest.raises(TypeError):
        name = next(iter(arrays))
        ta.state_from_numpy(kind, dict(arrays, **{name: arrays[name].astype(np.float32)}),
                            "cpu")


def _engine_rows(eng, pol, mt_cls, layout, device=None):
    opts = eng.AggregatorOptions(capacity=64, num_windows=2, timer_sample_capacity=256,
                                 storage_policies=(pol.parse("10s:2d"),), layout=layout)
    kw = {} if device is None else {"device": device}
    ml = eng.MetricList(opts.storage_policies[0], opts, **kw)
    ids = [b"m%d" % (i % 7) for i in range(40)]
    vals = np.round(np.arange(40) * 0.25, 3)
    times = np.full(40, T0, np.int64)
    ml.add_batch(mt_cls.GAUGE, ids, vals, times)
    ml.add_batch(mt_cls.COUNTER, ids, np.arange(40, dtype=np.float64), times)
    ml.add_batch(mt_cls.TIMER, ids, vals + 1.0, times)
    rows = {}
    for fm in ml.consume((T0 // (10 * SEC) + 1) * 10 * SEC):
        for s, t, v in zip(fm.slots, fm.types, fm.values):
            rows[(int(fm.metric_type), int(s), int(t))] = float(v)
    return rows


class TestPackedEngine:
    """The engine on the packed layout, the default."""

    def test_engine_flush_packed_vs_f64(self):
        port = _engine_rows(te, TSP, TMT, "packed", "cpu")
        ref = _engine_rows(je, JSP, JMT, "packed")
        f64 = _engine_rows(te, TSP, TMT, "f64", "cpu")
        assert port.keys() == ref.keys() == f64.keys()
        for k, v in ref.items():
            if k[2] in (6, 7):  # SUM_SQ, STDEV
                np.testing.assert_allclose(port[k], v, rtol=1e-12)
            else:
                assert port[k] == v or (np.isnan(v) and np.isnan(port[k])), k
            w = f64[k]
            assert np.isnan(w) == np.isnan(port[k]), k
            if not np.isnan(w):
                np.testing.assert_allclose(port[k], w, rtol=1e-6, atol=1e-12)

    def test_default_layout_resolves_packed(self):
        opts = te.AggregatorOptions(capacity=8, num_windows=2, timer_sample_capacity=32)
        assert opts.layout is None
        ml = te.MetricList(opts.storage_policies[0], opts, device="cpu")
        assert isinstance(ml.counters, tp.PackedCounterArena)
        assert isinstance(ml.gauges, tp.PackedGaugeArena)
        assert isinstance(ml.timers, tp.PackedTimerArena)
        jml = je.MetricList(opts.storage_policies[0], je.AggregatorOptions(
            capacity=8, num_windows=2, timer_sample_capacity=32))
        assert ml.timers.lane_types == jml.timers.lane_types

    def test_expire_recycles_packed_slots(self):
        opts = te.AggregatorOptions(capacity=16, num_windows=2, timer_sample_capacity=64,
                                    layout="packed")
        ml = te.MetricList(opts.storage_policies[0], opts, device="cpu")
        ml.add_batch(TMT.COUNTER, [b"a", b"b"], np.asarray([1.0, 2.0]),
                     np.asarray([T0, T0], np.int64))
        assert ml.expire(T0 + 3600 * SEC, ttl_nanos=60 * SEC) == 2
        assert ml.maps[TMT.COUNTER]._slots == {}
        assert int(ml.counters.state.last_at.sum()) == 0


class TestStdevClamp:
    """Catastrophic cancellation clamps at 0, on both sides."""

    def test_large_mean_small_variance(self):
        rng = np.random.default_rng(37)
        vals = 1e9 + rng.normal(0.0, 1.0, 1000)
        args = (1000.0, float((vals * vals).sum()), float(vals.sum()))
        port = float(ta._stdev(*(torch.tensor(a, dtype=torch.float64) for a in args)))
        ref = float(ja._stdev(*(jnp.float64(a) for a in args)))
        assert port == ref and 0.0 <= port < 100.0
        neg = (2.0, 1e18 * (1 - 1e-16), 2e9 * (1 + 1e-13))
        assert float(ta._stdev(*(torch.tensor(a, dtype=torch.float64) for a in neg))) == 0.0

    def test_stdev_bit_equal_to_jax(self):
        """The square root is correctly rounded on the CPU too (PyTorch's
        own CPU kernel is within 1 ulp only: sqrt(2.0) is one ulp low)."""
        rng = np.random.default_rng(43)
        cnt = rng.integers(0, 50, 1 << 16).astype(np.float64)
        s = rng.normal(0, 100, cnt.size) * cnt
        sq = s * s / np.maximum(cnt, 1) + rng.random(cnt.size) * 1e4
        port = ta._stdev(*(torch.from_numpy(x) for x in (cnt, sq, s))).numpy()
        ref = np.asarray(ja._stdev(*(jnp.asarray(x) for x in (cnt, sq, s))))
        np.testing.assert_array_equal(port.view(np.uint64), ref.view(np.uint64))
        two = torch.tensor([2.0], dtype=torch.float64)
        assert ta._sqrt(two).numpy().view(np.uint64)[0] == np.sqrt(np.float64(2.0)).view(np.uint64)

    def test_gauge_consume_stdev_no_nan_large_mean(self):
        args = (np.zeros(4, np.int32), np.zeros(4, np.int32),
                1e9 + np.asarray([0.25, -0.25, 0.5, -0.5]), np.full(4, T0, np.int64))
        jga, tga = jp.PackedGaugeArena(1, 4), tp.PackedGaugeArena(1, 4, device="cpu")
        jga.ingest(*_j(*args))
        tga.ingest(*args)
        _assert_state(tga.state, jga.state, "gauge")
        lanes = tga.consume(0)[0].numpy()
        _assert_lanes(tga.consume(0), jga.consume(0), "gauge")
        assert np.isfinite(lanes[0, STDEV]) and lanes[0, STDEV] >= 0.0
