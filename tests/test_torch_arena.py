"""The port's f64 arenas (``m3_tpu_torch/aggregator/arena.py``) on the CPU
against ``m3_tpu.aggregator.arena``, with the JAX ingest on both of its
implementations: ``impl="pallas"`` (the Pallas kernels in interpret mode)
and ``impl="scatter"``.

Tolerances: every field of the state exact, f64 sums and sums of squares
included, against ``impl="scatter"`` (the port adds each lane's points
in arrival order, as the reference's scatter does); against
``impl="pallas"``, whose Pallas path adds a fresh per-batch sum to the
state, f64 sums and sums of squares ``atol=1e-9``
(tests/test_pallas_ingest.py's); stdev ``rtol=1e-12``.  Sizes are
``TestArenaIngestImplFlip``'s: W = 2, C = 512, N = 4096.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from m3_tpu.aggregator import arena as ja
from m3_tpu_torch.aggregator import arena as ta

W, C, N = 2, 512, 4096
SCAP = 1 << 13
FLOAT_SUMS = {"sum", "sum_sq"}


def _batch(seed, n=N):
    """Windows and slots with out-of-range and negative entries, times
    with heavy ties, NaN gauges, +-0 timer values."""
    rng = np.random.default_rng(seed)
    windows = rng.integers(-1, W + 1, n).astype(np.int32)
    slots = rng.integers(-3, C + 3, n).astype(np.int32)
    times = (1000 + rng.integers(0, 40, n)).astype(np.int64)
    cvals = rng.integers(-50, 1000, n).astype(np.int64)
    gvals = np.round(rng.normal(0, 10, n), 4)
    gvals[rng.random(n) < 0.05] = np.nan
    gvals[:9] = np.asarray([0.0, -0.0] * 4 + [0.0])
    slots[:9] = 5
    windows[:9] = 0
    tvals = np.round(rng.gamma(2.0, 5.0, n), 4)
    tvals[10:40:3] = -0.0
    tvals[11:40:3] = 0.0
    slots[10:40] = 7
    windows[10:40] = 1
    return dict(windows=windows, slots=slots, times=times, cvals=cvals,
                gvals=gvals, tvals=tvals)


def _np(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def _assert_state(port, ref, what, sums_atol=None):
    """Every field bit for bit (NaN as one NaN), or the float sums within
    ``sums_atol`` where one is given."""
    got = ta.state_to_numpy(port)
    for name, want in _np(ref).items():
        g = got[name]
        assert g.dtype == want.dtype, (what, name)
        if name in FLOAT_SUMS and sums_atol is not None:
            np.testing.assert_allclose(g, want, atol=sums_atol, err_msg=f"{what}.{name}")
        elif g.dtype == np.float64:
            np.testing.assert_array_equal(np.isnan(g), np.isnan(want), err_msg=f"{what}.{name}")
            ok = ~np.isnan(want)
            np.testing.assert_array_equal(g[ok].view(np.uint64), want[ok].view(np.uint64),
                                          err_msg=f"{what}.{name}")
        else:
            np.testing.assert_array_equal(g, want, err_msg=f"{what}.{name}")


def _assert_lanes(port, ref, what):
    (pl, pc), (jl, jc) = port, ref
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc), err_msg=what)
    pl, jl = pl.numpy(), np.asarray(jl)
    stdev = ta.SCALAR_LANES.index(ta.AggregationType.STDEV)
    for i in range(jl.shape[1]):
        if i == stdev:
            np.testing.assert_allclose(pl[:, i], jl[:, i], rtol=1e-12, err_msg=what)
        else:
            np.testing.assert_array_equal(pl[:, i], jl[:, i], err_msg=f"{what} lane {i}")


def _ingest_all(b, impl=None):
    """Ingest one batch into fresh arenas of both packages."""
    jw, js, jt = (jnp.asarray(b[k]) for k in ("windows", "slots", "times"))
    jidx = ja.flat_window_index(jw, js, W, C)
    tw, tsl, tt = (torch.from_numpy(b[k]) for k in ("windows", "slots", "times"))
    tidx = ta.flat_window_index(tw, tsl, W, C)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    ref = (
        ja.counter_ingest(ja.counter_init(W, C), jidx, js, jnp.asarray(b["cvals"]), jt,
                          impl=impl),
        ja.gauge_ingest(ja.gauge_init(W, C), jidx, js, jnp.asarray(b["gvals"]), jt,
                        impl=impl),
        ja.timer_ingest(ja.timer_init(W, C, SCAP), jw, js, jnp.asarray(b["tvals"]), jt,
                        C, impl=impl),
    )
    port = (
        ta.counter_ingest(ta.counter_init(W, C, "cpu"), tidx, tsl,
                          torch.from_numpy(b["cvals"]), tt),
        ta.gauge_ingest(ta.gauge_init(W, C, "cpu"), tidx, tsl,
                        torch.from_numpy(b["gvals"]), tt),
        ta.timer_ingest(ta.timer_init(W, C, SCAP, "cpu"), tw, tsl,
                        torch.from_numpy(b["tvals"]), tt, C),
    )
    return port, ref


@pytest.fixture(scope="module")
def batch():
    return _batch(4)


@pytest.fixture(scope="module", params=["pallas", "scatter"])
def ingested(request, batch):
    return _ingest_all(batch, impl=request.param), request.param


def test_ingest_matches_jax(ingested):
    (port, ref), impl = ingested
    atol = 1e-9 if impl == "pallas" else None
    for p, r, kind in zip(port, ref, ("counter", "gauge", "timer")):
        _assert_state(p, r, f"{kind}[{impl}]", sums_atol=atol)


def _as_port(kind, ref_state):
    return ta.state_from_numpy(kind, _np(ref_state), "cpu")


@pytest.mark.parametrize("window", [0, 1])
def test_consume_matches_jax(ingested, window):
    """Both consumes read the same state (the JAX one, carried across)."""
    (_, (cs, gs, ts)), impl = ingested
    _assert_lanes(ta.counter_consume(_as_port("counter", cs), window, C),
                  ja.counter_consume(cs, jnp.int32(window), C), f"counter[{impl}]")
    _assert_lanes(ta.gauge_consume(_as_port("gauge", gs), window, C),
                  ja.gauge_consume(gs, jnp.int32(window), C), f"gauge[{impl}]")
    q = (0.5, 0.95, 0.99)
    _assert_lanes(ta.timer_consume(_as_port("timer", ts), window, C, q),
                  ja.timer_consume(ts, jnp.int32(window), C, q), f"timer[{impl}]")


@pytest.mark.parametrize("window", [0, 1])
def test_timer_packed32_drain_matches_jax(ingested, window):
    (_, (_, _, ts)), _ = ingested
    q = (0.1, 0.5, 0.99, 0.9999)
    _assert_lanes(ta.timer_consume(_as_port("timer", ts), window, C, q, packed32=True),
                  ja.timer_consume(ts, jnp.int32(window), C, q, packed32=True),
                  "timer packed32")


def test_reset_window_and_clear_slots_match_jax(ingested):
    (_, (cs, gs, ts)), _ = ingested
    clear = ja.pad_slots(np.asarray([5, 7, 0, C - 1, 300], np.int32), C)
    assert (clear[5:] == C).all()
    cases = [
        ("counter", cs, ja.counter_reset_window, ta.counter_reset_window,
         ja.counter_clear_slots, ta.counter_clear_slots),
        ("gauge", gs, ja.gauge_reset_window, ta.gauge_reset_window,
         ja.gauge_clear_slots, ta.gauge_clear_slots),
        ("timer", ts, ja.timer_reset_window, ta.timer_reset_window,
         ja.timer_clear_slots, ta.timer_clear_slots),
    ]
    for kind, st, j_reset, t_reset, j_clear, t_clear in cases:
        # the JAX functions donate their state: hand them copies
        ref = j_reset(type(st)(*[jnp.array(x) for x in st]), jnp.int32(1), C)
        port = t_reset(_as_port(kind, st), 1, C)
        _assert_state(port, ref, f"{kind} reset")
        ref = j_clear(type(st)(*[jnp.array(x) for x in st]), jnp.asarray(clear), W, C)
        port = t_clear(_as_port(kind, st), torch.from_numpy(clear), W, C)
        _assert_state(port, ref, f"{kind} clear")


@pytest.mark.parametrize("kind", ["counter", "gauge", "timer"])
def test_clear_slots_negative_slots_match_jax(ingested, kind):
    """A negative slot wraps as in the reference: the flat index w*C + s
    wraps once by W*C (dropped if still negative), last_at's by C."""
    (_, refs), _ = ingested
    st = refs[("counter", "gauge", "timer").index(kind)]
    slots = np.asarray([-1, -C - 3, -2 * C + 1, -2 * C - 1, -3 * C, 6, C, C + 4], np.int32)
    j_clear = getattr(ja, f"{kind}_clear_slots")
    t_clear = getattr(ta, f"{kind}_clear_slots")
    ref = j_clear(type(st)(*[jnp.array(x) for x in st]), jnp.asarray(slots), W, C)
    port = t_clear(_as_port(kind, st), torch.from_numpy(slots), W, C)
    _assert_state(port, ref, f"{kind} clear negative")


def test_clear_slots_negative_slot_semantics():
    """W = 3, C = 4: slot -5 clears slot 3 of every window and leaves
    last_at alone; slot -13 clears slot 3 of windows 0 and 1 only."""
    for slot, windows in ((-5, [0, 1, 2]), (-13, [0, 1])):
        st = ta.counter_init(3, 4, "cpu")
        st.count.fill_(7)
        st.last_at.fill_(9)
        st = ta.counter_clear_slots(st, torch.tensor([slot], dtype=torch.int32), 3, 4)
        cleared = (st.count.view(3, 4) == 0).nonzero().tolist()
        assert cleared == [[w, 3] for w in windows], (slot, cleared)
        assert (st.last_at == 9).all()


def test_state_round_trip_is_lossless(ingested):
    (_, refs), _ = ingested
    for kind, st in zip(("counter", "gauge", "timer"), refs):
        arrays = _np(st)
        back = ta.state_to_numpy(ta.state_from_numpy(kind, arrays, "cpu"))
        for name, a in arrays.items():
            assert back[name].dtype == a.dtype
            assert back[name].tobytes() == a.tobytes(), (kind, name)
    with pytest.raises(TypeError):
        bad = dict(_np(refs[0]), sum=np.zeros(W * C, np.float64))
        ta.state_from_numpy("counter", bad, "cpu")


def test_gauge_last_ties_go_to_first_arrival():
    """Same slot and time three times: the first arrival wins; a later,
    strictly newer batch replaces it, an equal-time one does not."""
    idx = torch.tensor([3, 3, 3, 9], dtype=torch.int64)
    slots = torch.tensor([3, 3, 3, 9], dtype=torch.int32)
    vals = torch.tensor([1.0, 2.0, np.nan, 4.0], dtype=torch.float64)
    times = torch.tensor([50, 50, 50, 10], dtype=torch.int64)
    st = ta.gauge_ingest(ta.gauge_init(1, 16, "cpu"), idx, slots, vals, times)
    assert float(st.last[3]) == 1.0 and int(st.last_time[3]) == 50
    st = ta.gauge_ingest(st, idx[:1], slots[:1], torch.tensor([7.0], dtype=torch.float64),
                         torch.tensor([50]))
    assert float(st.last[3]) == 1.0
    st = ta.gauge_ingest(st, idx[:1], slots[:1], torch.tensor([8.0], dtype=torch.float64),
                         torch.tensor([51]))
    assert float(st.last[3]) == 8.0
    assert int(st.count[3]) == 5 and float(st.sum[3]) == 1.0 + 2.0 + 7.0 + 8.0


class TestSentinels:
    """tests/test_arena_sentinels.py's cases, port against JAX."""

    def test_negative_and_oversized_slots_drop(self):
        w = np.asarray([0, 1, 0, 1], np.int32)
        s = np.asarray([-1, -2, 8, 10], np.int32)
        v = np.asarray([5, 6, 7, 8], np.int64)
        t = np.asarray([100, 200, 300, 400], np.int64)
        jidx = ja.flat_window_index(jnp.asarray(w), jnp.asarray(s), 2, 8)
        ref = ja.counter_ingest(ja.counter_init(2, 8), jidx, jnp.asarray(s),
                                jnp.asarray(v), jnp.asarray(t))
        tidx = ta.flat_window_index(torch.from_numpy(w), torch.from_numpy(s), 2, 8)
        port = ta.counter_ingest(ta.counter_init(2, 8, "cpu"), tidx, torch.from_numpy(s),
                                 torch.from_numpy(v), torch.from_numpy(t))
        _assert_state(port, ref, "counter")
        assert int(port.count.sum()) == 0 and int(port.last_at.sum()) == 0

    def test_window_dropped_still_bumps_last_at(self):
        port = ta.counter_ingest(ta.counter_init(2, 16, "cpu"), torch.tensor([32]),
                                 torch.tensor([7], dtype=torch.int32), torch.tensor([123]),
                                 torch.tensor([999_999]))
        assert int(port.count.sum()) == 0 and int(port.last_at[7]) == 999_999

    def test_empty_batch_is_noop(self):
        e64 = torch.zeros(0, dtype=torch.int64)
        e32 = torch.zeros(0, dtype=torch.int32)
        cases = [
            (ta.counter_ingest(ta.counter_init(2, 16, "cpu"), e64, e32, e64, e64),
             ja.counter_init(2, 16)),
            (ta.gauge_ingest(ta.gauge_init(2, 16, "cpu"), e64, e32,
                             torch.zeros(0, dtype=torch.float64), e64),
             ja.gauge_init(2, 16)),
            (ta.timer_ingest(ta.timer_init(2, 16, 8, "cpu"), e32, e32,
                             torch.zeros(0, dtype=torch.float64), e64, 16),
             ja.timer_init(2, 16, 8)),
        ]
        for port, ref in cases:
            _assert_state(port, ref, "empty")

    @pytest.mark.parametrize("scap", [64, 2])
    def test_timer_dropped_samples_do_not_leak(self, scap):
        """Dropped slots take no buffer room; with scap=2 the buffer
        overflows and sample_n still counts every valid sample."""
        w = np.asarray([0, 0, 0, 0, 0], np.int32)
        s = np.asarray([9, 3, -1, 5, 6], np.int32)
        v = np.asarray([9.0, 1.0, 9.0, 2.0, 4.0])
        t = np.asarray([100] * 5, np.int64)
        ref = ja.timer_ingest(ja.timer_init(2, 8, scap), jnp.asarray(w), jnp.asarray(s),
                              jnp.asarray(v), jnp.asarray(t), 8)
        port = ta.timer_ingest(ta.timer_init(2, 8, scap, "cpu"), torch.from_numpy(w),
                               torch.from_numpy(s), torch.from_numpy(v),
                               torch.from_numpy(t), 8)
        _assert_state(port, ref, "timer")
        assert int(port.sample_n[0]) == 3


def test_orderable_f32_round_trip_matches_jax():
    v = np.asarray([0.0, -0.0, 1.5, -1.5, np.inf, -np.inf, np.nan, 1e-45, -1e-45,
                    3.4e38, -3.4e38, 1e300, 123.456, -7e-3])
    port = ta.orderable_f32(torch.from_numpy(v))
    ref = np.asarray(ja.orderable_f32(jnp.asarray(v)))
    np.testing.assert_array_equal(port.numpy().view(np.uint64), ref)
    back = ta.decode_orderable_f32(port).numpy()
    want = np.asarray(ja.decode_orderable_f32(jnp.asarray(ref)))
    np.testing.assert_array_equal(back.view(np.uint64), want.view(np.uint64))
    normal = np.isfinite(v) & (np.abs(v) < 3e38) & (np.abs(v) > 1e-37)
    np.testing.assert_array_equal(back[normal], v[normal].astype(np.float32))
    assert (back[7:9] == 0).all() and np.signbit(back[7:9]).tolist() == [False, True]


def test_stdev_cancellation_clamp_matches_jax():
    """mean ~1e9, spread ~1: count*sum_sq - sum^2 can round negative; both
    clamp to 0 (no NaN, no fabricated spread)."""
    vals = 1e9 + np.asarray([0.0, 1e-7, 2e-7])
    cnt = np.asarray([3.0, 1.0, 0.0, 3.0])
    s = np.asarray([vals.sum(), 5.0, 0.0, 6.0])
    sq = np.asarray([(vals ** 2).sum(), 25.0, 0.0, 14.0])
    port = ta._stdev(*(torch.from_numpy(x) for x in (cnt, sq, s))).numpy()
    ref = np.asarray(ja._stdev(*(jnp.asarray(x) for x in (cnt, sq, s))))
    np.testing.assert_allclose(port, ref, rtol=1e-12)
    assert np.isfinite(port).all() and port[1] == 0.0 and port[2] == 0.0
    assert port[3] == pytest.approx(np.std([1.0, 2.0, 3.0], ddof=1), rel=1e-12)


def test_timer_arena_grow_matches_jax():
    """A batch past the sample capacity grows the buffer geometrically
    (8 -> 32) on both sides, and the drains agree."""
    rng = np.random.default_rng(11)
    n = 20
    w = np.zeros(n, np.int32)
    s = rng.integers(0, 4, n).astype(np.int32)
    v = np.round(rng.gamma(2.0, 5.0, n), 3)
    t = np.full(n, 100, np.int64)
    port = ta.TimerArena(2, 4, 8, device="cpu")
    ref = ja.TimerArena(2, 4, 8)
    port.ingest(w, s, v, t)
    ref.ingest(jnp.asarray(w), jnp.asarray(s), jnp.asarray(v), jnp.asarray(t))
    assert port.sample_capacity == ref.sample_capacity == 32
    _assert_state(port.state, ref.state, "timer grown")
    _assert_lanes(port.consume(0), ref.consume(0), "timer grown")
    port.reset_window(0)
    ref.reset_window(0)
    assert list(port._sample_n_host) == list(ref._sample_n_host) == [0, 0]


def test_arena_classes_and_layouts():
    from m3_tpu_torch.aggregator import packed as tp

    for layout in (None, "auto", "packed"):
        c, g, t = ta.make_arenas(2, 8, 8, (0.5, 0.99), layout=layout, device="cpu")
        jc, jg, jt = ja.make_arenas(2, 8, 8, (0.5, 0.99), layout="packed")
        assert type(c) is tp.PackedCounterArena and type(jc).__name__ == "PackedCounterArena"
        assert type(g) is tp.PackedGaugeArena and type(t) is tp.PackedTimerArena
        assert t.lane_types == jt.lane_types and c.lane_types == jc.lane_types
    with pytest.raises(ValueError):
        ta.make_arenas(2, 8, 8, (0.5,), layout="magic", device="cpu")
    c, g, t = ta.make_arenas(2, 8, 8, (0.5, 0.99), layout="f64", device="cpu")
    jc, jg, jt = ja.make_arenas(2, 8, 8, (0.5, 0.99), layout="f64")
    assert c.lane_types == jc.lane_types and g.lane_types == jg.lane_types
    assert t.lane_types == jt.lane_types
    for at in ta.AggregationType:
        assert t.lane_for_type(at) == jt.lane_for_type(at)
        assert c.lane_for_type(at) == jc.lane_for_type(at)


def test_state_from_numpy_gives_min_max_nans_their_side():
    """The segment_minmax kernel keeps a stored NaN sticky only with its
    side's sign: clear in max, set in min."""
    arrays = _np(ja.gauge_init(1, 4))
    nan_pos, nan_neg = np.float64(np.nan), -np.float64(np.nan)
    arrays["max"] = np.asarray([nan_neg, nan_pos, 1.0, -np.inf])
    arrays["min"] = np.asarray([nan_pos, nan_neg, 1.0, np.inf])
    st = ta.state_from_numpy("gauge", arrays, "cpu")
    assert not np.signbit(st.max[:2].numpy()).any() and np.isnan(st.max[:2].numpy()).all()
    assert np.signbit(st.min[:2].numpy()).all() and np.isnan(st.min[:2].numpy()).all()
    assert st.max[2:].tolist() == [1.0, -np.inf] and st.min[2:].tolist() == [1.0, np.inf]
