"""m3_tpu_torch.x.membudget against the port's own tensors and against
m3_tpu.x.membudget on the CPU.

* Footprints: each arena (both layouts, three types), the series buffer
  and the decoder's control table reserve exactly the bytes of their
  state tensors, each tensor at the CUDA caching allocator's 512-byte
  block (``block_bytes``); at shapes whose big tensors fill whole blocks
  that is the plain sum of ``numel * element_size`` but for the tensors
  under one block (the packed counter's two i32 scalars, the timers'
  and the buffer's per-window write heads: a block each).
* Against the JAX package: field by field the JAX state arrays have the
  port tensors' bytes, except the packed counter's ``minmax`` (u32 in
  JAX, int64 in the port: +4 B a slot); the reference's formulas equal
  the port's plus its 512-byte XLA overhead a state, less that
  difference.  The ledger, its parser and its typed reject are the
  reference's.
* ``DeviceBudgetExceeded`` is raised before any tensor is allocated, at
  one byte below a footprint; at the footprint the structure builds.
* Owner finalizers release a collected structure's bytes; a grow over
  budget raises typed and leaves the state as it was.

Exact comparisons.
"""

import gc

import numpy as np
import pytest
import torch

from m3_tpu.aggregator import arena as jarena
from m3_tpu.aggregator import packed as jpacked
from m3_tpu.x import membudget as jmb
from m3_tpu_torch.aggregator import arena as tarena
from m3_tpu_torch.aggregator import packed as tpacked
from m3_tpu_torch.encoding import m3tsz_torch as mt
from m3_tpu_torch.storage.buffer import ShardBuffer
from m3_tpu_torch.x import devguard as tdg
from m3_tpu_torch.x import membudget as tmb

XLA_OVERHEAD = 512  # the reference's per-state allowance


@pytest.fixture(autouse=True)
def clean_ledger():
    gc.collect()
    tmb.reset()
    tmb.set_budget(0)
    yield
    tmb.set_budget(0)
    gc.collect()
    tmb.reset()


def _tensor_bytes(state, block: bool) -> int:
    f = tmb.block_bytes if block else (lambda n: n)
    return sum(f(t.numel() * t.element_size()) for t in state)


def _arenas(layout, W, C, S):
    if layout == "packed":
        return {"counter": tpacked.PackedCounterArena(W, C, device="cpu"),
                "gauge": tpacked.PackedGaugeArena(W, C, device="cpu"),
                "timer": tpacked.PackedTimerArena(W, C, S, device="cpu")}
    return {"counter": tarena.CounterArena(W, C, device="cpu"),
            "gauge": tarena.GaugeArena(W, C, device="cpu"),
            "timer": tarena.TimerArena(W, C, S, device="cpu")}


def _formula(kind, layout, W, C, S):
    if kind == "timer":
        return tmb.timer_arena_bytes(layout, W, C, S)
    return getattr(tmb, f"{kind}_arena_bytes")(layout, W, C)


# (W, C, S): unaligned, and whole 512-byte blocks in every big tensor
SHAPES = [(2, 1000, 3000), (3, 333, 17), (2, 4096, 8192)]


@pytest.mark.parametrize("layout", ["packed", "f64"])
@pytest.mark.parametrize("W,C,S", SHAPES)
def test_arena_footprints_equal_their_tensors(layout, W, C, S):
    arenas = _arenas(layout, W, C, S)
    for kind, a in arenas.items():
        want = _formula(kind, layout, W, C, S)
        assert a._mem.nbytes == want == _tensor_bytes(a.state, block=True), kind
    assert tmb.used() == sum(a._mem.nbytes for a in arenas.values()) == \
        tmb.arena_bytes(layout, W, C, S)
    comps = tmb.snapshot()["components"]
    assert set(comps) == {"aggregator.counter", "aggregator.gauge", "aggregator.timer"}
    if (W, C, S) == (2, 4096, 8192):
        for kind, a in arenas.items():
            raw = _tensor_bytes(a.state, block=False)
            # the tensors under one block: the packed counter's pool_n and
            # err (4 bytes each), the timers' W write heads (8 bytes each)
            small = {"counter": 2 * (512 - 4) if layout == "packed" else 0,
                     "gauge": 0, "timer": 512 - 8 * W}[kind]
            assert a._mem.nbytes == raw + small, kind


def _jax_states(layout, W, C, S):
    mod = jpacked if layout == "packed" else jarena
    return {"counter": mod.counter_init(W, C), "gauge": mod.gauge_init(W, C),
            "timer": mod.timer_init(W, C, S)}


@pytest.mark.parametrize("layout", ["packed", "f64"])
def test_port_tensors_match_the_jax_arrays_but_minmax(layout):
    W, C, S = 2, 4096, 8192
    port = {k: a.state for k, a in _arenas(layout, W, C, S).items()}
    jax = _jax_states(layout, W, C, S)
    for kind in port:
        tj = {f: np.asarray(v).nbytes for f, v in jax[kind]._asdict().items()}
        tt = {f: v.numel() * v.element_size() for f, v in port[kind]._asdict().items()}
        assert set(tj) == set(tt), kind
        differ = {f for f in tt if tt[f] != tj[f]}
        if (layout, kind) == ("packed", "counter"):
            # the u32 minmax word rides an int64 (torch has no uint32 math)
            assert differ == {"minmax"}
            assert str(np.asarray(jax[kind].minmax).dtype) == "uint32"
            assert port[kind].minmax.dtype == torch.int64
        else:
            assert differ == set(), (kind, differ)
        jf = (jmb.timer_arena_bytes(layout, W, C, S) if kind == "timer"
              else getattr(jmb, f"{kind}_arena_bytes")(layout, W, C))
        tf = _formula(kind, layout, W, C, S)
        # the port's blocks under the small tensors (see above), and the
        # packed counter's wider minmax
        extra = {"counter": (4 * W * C + 2 * 512 - 8) if layout == "packed" else 0,
                 "gauge": 0, "timer": 512 - 8 * W}[kind]
        assert tf == jf - XLA_OVERHEAD + extra, kind


@pytest.mark.parametrize("W,S", [(2, 1 << 12), (3, 1000)])
def test_buffer_footprint(W, S):
    buf = ShardBuffer(3600 * 10**9, W, S, 4096, device="cpu")
    assert buf._mem.nbytes == tmb.buffer_bytes(W, S) == _tensor_bytes(buf.state, True)
    if S % 128 == 0:
        # whole blocks: the reference's formula (the same tensors) but
        # for the write heads' block
        assert buf._mem.nbytes == jmb.buffer_bytes(W, S) - 8 * W + 512
    assert tmb.snapshot()["components"] == {"storage.buffer": buf._mem.nbytes}


def test_ctrl_table_reservation():
    mt.value_ctrl_table(torch.device("cpu"))
    res = mt._CTRL_TBL_RESERVED[torch.device("cpu")]
    assert res.component == "decode.ctrl_table"
    assert res.nbytes == mt._VALUE_CTRL_TBL.size * 4 == jmb.parse_bytes("1M")


def test_parse_bytes_and_reject_equal_the_reference():
    for v in ("512M", "2GiB", "1.5K", 1048576, "0", "7 T", "64B"):
        assert tmb.parse_bytes(v) == jmb.parse_bytes(v)
    for bad in ("12X", "lots", "-1M"):
        with pytest.raises(ValueError) as te:
            tmb.parse_bytes(bad)
        with pytest.raises(ValueError) as je:
            jmb.parse_bytes(bad)
        assert str(te.value) == str(je.value)
    assert issubclass(tmb.DeviceBudgetExceeded, tdg.DeviceOOM)
    assert tmb.DeviceBudgetExceeded.kind == jmb.DeviceBudgetExceeded.kind == "budget"


def _guarded_inits(monkeypatch):
    """Record every state constructor the arenas and the buffer call."""
    calls = []
    import m3_tpu_torch.storage.buffer as tbuf

    for mod, name in ((tarena, "counter_init"), (tarena, "gauge_init"),
                      (tarena, "timer_init"), (tpacked, "counter_init"),
                      (tpacked, "gauge_init"), (tpacked, "timer_init"),
                      (tbuf, "buffer_init")):
        orig = getattr(mod, name)

        def rec(*a, _orig=orig, _name=f"{mod.__name__}.{name}", **kw):
            calls.append(_name)
            return _orig(*a, **kw)

        monkeypatch.setattr(mod, name, rec)
    return calls


BUILDS = [
    ("packed counter", lambda: tpacked.PackedCounterArena(2, 1000, device="cpu"),
     lambda: tmb.counter_arena_bytes("packed", 2, 1000)),
    ("f64 gauge", lambda: tarena.GaugeArena(2, 1000, device="cpu"),
     lambda: tmb.gauge_arena_bytes("f64", 2, 1000)),
    ("packed timer", lambda: tpacked.PackedTimerArena(2, 100, 500, device="cpu"),
     lambda: tmb.timer_arena_bytes("packed", 2, 100, 500)),
    ("buffer", lambda: ShardBuffer(3600 * 10**9, 2, 1000, 128, device="cpu"),
     lambda: tmb.buffer_bytes(2, 1000)),
]


@pytest.mark.parametrize("what,build,footprint", BUILDS)
def test_budget_rejects_before_any_allocation(monkeypatch, what, build, footprint):
    calls = _guarded_inits(monkeypatch)
    need = footprint()
    tmb.set_budget(need - 1)
    with pytest.raises(tmb.DeviceBudgetExceeded) as e:
        build()
    assert calls == [] and tmb.used() == 0
    assert tmb.snapshot()["rejected_total"] == 1
    assert f"reserving {need} bytes would exceed" in str(e.value)
    assert tdg.classify(e.value) is tmb.DeviceBudgetExceeded
    tmb.set_budget(need)
    obj = build()
    assert len(calls) == 1 and tmb.used() == need
    del obj


def test_owner_finalizer_releases():
    a = tarena.CounterArena(2, 1000, device="cpu")
    b = ShardBuffer(3600 * 10**9, 2, 1000, 128, device="cpu")
    assert tmb.used() == a._mem.nbytes + b._mem.nbytes
    del a
    gc.collect()
    assert tmb.used() == b._mem.nbytes
    del b
    gc.collect()
    assert tmb.used() == 0 and tmb.snapshot()["components"] == {}
    assert tmb.snapshot()["peak_bytes"] > 0


def test_grow_over_budget_raises_typed_and_keeps_the_state():
    arena = tpacked.PackedTimerArena(1, 128, 64, device="cpu")
    tmb.set_budget(tmb.used())  # no room to grow
    before = arena.state.sample.clone()
    batch = (np.zeros(100, np.int32), np.arange(100, dtype=np.int32),
             np.ones(100), np.zeros(100, np.int64))
    with pytest.raises(tmb.DeviceBudgetExceeded):
        arena.ingest(*batch)
    assert arena.sample_capacity == 64 and torch.equal(arena.state.sample, before)
    assert not arena._sample_n_host.any()
    tmb.set_budget(0)
    arena.ingest(*batch)
    assert arena.sample_capacity == 128
    assert arena._mem.nbytes == tmb.timer_arena_bytes("packed", 1, 128, 128)


def test_codec_transients_reserve_and_release():
    S, T = 4, 6
    ts = (1_600_000_000 + 10 * np.arange(T))[None, :].repeat(S, 0) * 10**9
    vals = np.arange(S * T, dtype=np.float64).reshape(S, T)
    need = tmb.encode_lane_bytes(S, T, (T * 16) // 64 + 4)
    tmb.set_budget(need - 1)
    with pytest.raises(tmb.DeviceBudgetExceeded) as e:
        mt.encode_batch(ts, vals, ts[:, 0], device="cpu")
    assert e.value.component == "encode.lanes"
    tmb.set_budget(0)
    streams, fb = mt.encode_batch(ts, vals, ts[:, 0], device="cpu")
    assert not fb.any() and tmb.used() == 0
    mt.value_ctrl_table(torch.device("cpu"))
    words, _ = mt.pack_streams(streams)
    dneed = tmb.decode_lane_bytes(S, words.shape[1], T)
    tmb.set_budget(dneed - 1)
    with pytest.raises(tmb.DeviceBudgetExceeded):
        mt.decode_batch(streams, T, device="cpu")
    tmb.set_budget(0)
    dts, dvals, counts, dfb = mt.decode_batch(streams, T, device="cpu")
    assert np.array_equal(dts, ts) and np.array_equal(dvals, vals)
    assert tmb.snapshot()["peak_bytes"] >= dneed
