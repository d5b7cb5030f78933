"""m3_tpu_torch.storage.buffer against m3_tpu.storage.buffer on the CPU.

The same batches, made from a numpy seed, go through the JAX functions
and their port twins (``device="cpu"``).  Everything is compared
exactly: the ring's slot / ts / n lanes as integers, its f64 lanes as
their bits, and ``buffer_drain``'s (slot, ts, val, first) lane for lane
over the whole row, sentinels included.  ``ShardBuffer`` sequences are
held against JAX's ``ShardBuffer`` (which takes its device path on the
CPU) and against a dict model.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from m3_tpu.storage import buffer as jbuf
from m3_tpu_torch.storage import buffer as tbuf

BLOCK = 2 * 3600 * 10**9
START = (1_700_000_000 * 10**9) // BLOCK * BLOCK
I64_MAX = np.iinfo(np.int64).max


def _batch(rng, n, windows, n_slots=64, ts_span=10**6, dup=False):
    slots = rng.integers(0, n_slots, n).astype(np.int32)
    ts = (1000 + rng.integers(0, ts_span, n)).astype(np.int64)
    vals = np.round(rng.normal(0, 5, n), 4)
    if dup and n > 1:  # repeat (slot, ts) pairs with new values
        k = n // 3
        src = rng.integers(0, n, k)
        dst = rng.integers(0, n, k)
        slots[dst], ts[dst] = slots[src], ts[src]
    return (np.asarray(windows, np.int32), slots, ts, vals)


def _cases():
    """name -> (W, S, [batches]): the cases the JAX function branches on."""
    rng = np.random.default_rng(11)
    out = {}
    out["one_window_fits"] = (3, 256, [
        _batch(rng, 60, np.full(60, 1)), _batch(rng, 70, np.full(70, 1))])
    out["one_window_fits_single_row"] = (1, 128, [
        _batch(rng, 40, np.zeros(40)) for _ in range(3)])
    out["scattered"] = (4, 128, [
        _batch(rng, 90, rng.integers(0, 4, 90)) for _ in range(2)])
    out["out_of_range"] = (3, 64, [
        _batch(rng, 50, rng.integers(-3, 6, 50)),
        _batch(rng, 5, [0, 3, 0, -1, 0])])
    out["all_out_of_range"] = (2, 16, [
        _batch(rng, 8, [-1, 2, 5, -7, 2, 3, -2, 9])])
    out["overflow"] = (2, 16, [
        _batch(rng, 12, np.zeros(12)), _batch(rng, 30, rng.integers(0, 2, 30)),
        _batch(rng, 5, np.ones(5))])
    out["overflow_one_batch"] = (1, 16, [_batch(rng, 32, np.zeros(32))])
    out["duplicates"] = (2, 256, [
        _batch(rng, 80, rng.integers(0, 2, 80), n_slots=6, ts_span=20, dup=True),
        _batch(rng, 80, np.zeros(80), n_slots=6, ts_span=20, dup=True)])
    out["empty"] = (2, 32, [
        _batch(rng, 0, np.zeros(0)), _batch(rng, 10, np.ones(10)),
        _batch(rng, 0, np.zeros(0))])
    return out


CASES = _cases()


def _jax_drive(W, S, batches, slot_cap=64):
    st = jbuf.buffer_init(W, S, slot_cap)
    for w, sl, ts, vl in batches:
        st = jbuf.buffer_append(st, jnp.asarray(w), jnp.asarray(sl),
                                jnp.asarray(ts), jnp.asarray(vl))
    return st


def _port_drive(W, S, batches, slot_cap=64):
    st = tbuf.buffer_init(W, S, slot_cap, "cpu")
    for w, sl, ts, vl in batches:
        st = tbuf.buffer_append(st, *(torch.from_numpy(a) for a in (w, sl, ts, vl)))
    return st


def _np(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.uint64) if a.dtype == np.float64 else a


def _assert_states_equal(js, ts_):
    for f in ("slot", "ts", "val", "n"):
        a, b = _np(getattr(js, f)), _np(getattr(ts_, f))
        assert a.dtype.itemsize == b.dtype.itemsize, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("case", sorted(CASES))
def test_append_and_drain_match_jax(case):
    W, S, batches = CASES[case]
    js = _jax_drive(W, S, batches)
    ps = _port_drive(W, S, batches)
    _assert_states_equal(js, ps)
    for w in range(W):
        jd = jbuf.buffer_drain(js, jnp.int32(w))
        pd = tbuf.buffer_drain(ps, w)
        for name, a, b in zip(("slot", "ts", "val", "first"), jd, pd):
            np.testing.assert_array_equal(_np(a), _np(b), err_msg=f"{name} w={w}")


def test_overflow_counts_past_capacity():
    """``n`` grows by the whole batch while the lanes past
    ``sample_capacity`` are dropped, as the reference's drop-mode
    scatter leaves it."""
    W, S, batches = CASES["overflow_one_batch"]
    ps = _port_drive(W, S, batches)
    assert int(ps.n[0]) == 32
    np.testing.assert_array_equal(ps.val[0].numpy(), batches[0][3][:16])


@pytest.mark.parametrize("seed", range(5))
def test_randomized_rings_match_jax(seed):
    """Random rings x random batch mixes (uniform/mixed windows, drops,
    overflow): the cases of ``test_storage.py``'s fuzz, held against
    JAX and against a pure-Python append oracle."""
    rng = np.random.default_rng(77 + seed)
    W = int(rng.integers(1, 4))
    S = int(rng.integers(8, 200))
    batches = []
    for _ in range(int(rng.integers(1, 4))):
        N = int(rng.integers(1, S + 20))
        if rng.random() < 0.5:
            windows = np.full(N, int(rng.integers(0, W)), np.int32)
        else:
            windows = rng.integers(-1, W + 1, N).astype(np.int32)
        batches.append(_batch(rng, N, windows))
    ps = _port_drive(W, S, batches)
    _assert_states_equal(_jax_drive(W, S, batches), ps)
    o_slot = np.full((W, S), 64, np.int32)
    o_ts = np.full((W, S), I64_MAX, np.int64)
    o_val = np.zeros((W, S))
    o_n = np.zeros(W, np.int64)
    for wd, sl, ts, vl in batches:
        for k in range(len(wd)):
            w = wd[k]
            if 0 <= w < W:
                d = o_n[w]
                if d < S:
                    o_slot[w, d], o_ts[w, d], o_val[w, d] = sl[k], ts[k], vl[k]
                o_n[w] += 1
    np.testing.assert_array_equal(ps.slot.numpy(), o_slot)
    np.testing.assert_array_equal(ps.ts.numpy(), o_ts)
    np.testing.assert_array_equal(ps.val.numpy(), o_val)
    np.testing.assert_array_equal(ps.n.numpy(), o_n)


def test_dedupe_last_write_wins_matches_jax():
    rng = np.random.default_rng(5)
    slots = rng.integers(0, 5, 300).astype(np.int32)
    ts = rng.integers(0, 30, 300).astype(np.int64)
    vals = rng.normal(size=300)
    for a, b in zip(jbuf.dedupe_last_write_wins(slots, ts, vals),
                    tbuf.dedupe_last_write_wins(slots, ts, vals)):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_shard_buffer_sorts_only_written_lanes():
    """``ShardBuffer`` sorts only the first ``n[row]`` lanes of a window;
    what it returns equals the whole row's ``buffer_drain`` after the
    keep mask (first of each (slot, ts), no sentinel)."""
    rng = np.random.default_rng(3)
    buf = tbuf.ShardBuffer(BLOCK, 2, 1 << 8, 40, device="cpu")
    for _ in range(4):
        n = 50
        slots = rng.integers(0, 40, n).astype(np.int32)
        ts = START + rng.integers(0, 30, n).astype(np.int64)
        buf.write(slots, ts, rng.normal(size=n), {START})
    row = buf.open_blocks[START]
    s, t, v, first = tbuf.buffer_drain(buf.state, row)
    keep = first & (s < 40)
    got = buf.peek(START)
    for a, b in zip((s[keep], t[keep], v[keep]), got):
        np.testing.assert_array_equal(_np(a), _np(b))
    assert int(buf._n_host[row]) == 200 < buf.sample_capacity


def _drive_shard_buffers(ops):
    """Apply one op list to JAX's and the port's ShardBuffer; return both
    op-by-op outputs."""
    outs = []
    for mod, kw in ((jbuf, {}), (tbuf, {"device": "cpu"})):
        buf = mod.ShardBuffer(BLOCK, 2, 1 << 6, 32, **kw)
        res = []
        for op, args in ops:
            r = getattr(buf, op)(*args)
            if op == "read_window_many":
                r = [x for pair in r for x in pair]
            res.append((op, r))
        res.append(("n", np.asarray(buf.state.n) if mod is jbuf else buf.state.n.numpy()))
        res.append(("cap", buf.sample_capacity))
        outs.append(res)
    return outs


def test_shard_buffer_sequence_matches_jax():
    """write (warm and cold), grow, peek, read_window_many, drain,
    discard and drain_cold: every output equal to JAX's ShardBuffer."""
    rng = np.random.default_rng(17)
    opens = {START, START + BLOCK}

    def w(n, lo, hi, span=BLOCK):
        slots = rng.integers(0, 32, n).astype(np.int32)
        ts = (rng.integers(lo, hi, n) // 10**9 * 10**9).astype(np.int64)
        return ("write", (slots, ts, np.round(rng.normal(size=n), 3), opens))

    ops = [
        w(40, START, START + BLOCK),
        w(30, START - BLOCK, START + 2 * BLOCK),          # cold both sides
        w(120, START, START + 2 * BLOCK),                 # grows past 64
        ("peek", (START,)),
        ("read_window_many", (START, np.array([0, 5, 31, -1, 7]),)),
        ("read_window", (START + BLOCK, 3)),
        w(20, START, START + 10**10),                     # staleness of the cache
        ("read_window_many", (START, np.arange(32),)),
        ("drain", (START,)),
        ("drain", (START,)),                              # drained: empty
        ("discard", (START + BLOCK,)),
        ("peek", (START + BLOCK,)),
        ("drain_cold", (START - BLOCK,)),
        ("peek_cold", (START + 2 * BLOCK,)),
        ("discard_cold", (START + 2 * BLOCK,)),
        ("drain_cold", (START + 2 * BLOCK,)),
        w(10, START, START + BLOCK),                      # reuse of a reset row
        ("peek", (START,)),
    ]
    jres, pres = _drive_shard_buffers(ops)
    assert len(jres) == len(pres)
    for (op, a), (_, b) in zip(jres, pres):
        if isinstance(a, tuple) or isinstance(a, list):
            assert len(a) == len(b), op
            for x, y in zip(a, b):
                np.testing.assert_array_equal(_np(x), _np(y), err_msg=op)
                assert np.asarray(x).dtype == np.asarray(y).dtype, op
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=op)


@pytest.mark.parametrize("seed", range(6))
def test_write_seal_dedupe_matches_model(seed):
    """``test_property.py``'s ShardBuffer case: last write wins per
    (slot, ts); the drain returns exactly the model's content, sorted,
    and equals JAX's drain."""
    rng = np.random.default_rng(200 + seed)
    bufs = [jbuf.ShardBuffer(BLOCK, num_windows=2, sample_capacity=1 << 12,
                             slot_capacity=64),
            tbuf.ShardBuffer(BLOCK, num_windows=2, sample_capacity=1 << 12,
                             slot_capacity=64, device="cpu")]
    model: dict[tuple[int, int], float] = {}
    for _ in range(rng.integers(2, 8)):
        n = int(rng.integers(1, 64))
        slots = rng.integers(0, 8, n).astype(np.int32)
        ts = START + rng.integers(0, 50, n).astype(np.int64)
        vals = np.round(rng.random(n), 6)
        for b in bufs:
            b.write(slots, ts, vals, {START})
        for s, t, v in zip(slots, ts, vals):
            model[(int(s), int(t))] = float(v)
    jd, pd = (b.drain(START) for b in bufs)
    for a, b in zip(jd, pd):
        np.testing.assert_array_equal(_np(a), _np(b))
    slots, ts, vals = pd
    assert {(int(s), int(t)): float(v) for s, t, v in zip(slots, ts, vals)} == model
    assert (np.lexsort((ts, slots)) == np.arange(len(slots))).all()


@pytest.mark.parametrize("seed", range(4))
def test_cold_routing_partitions_exactly(seed):
    """Every sample lands in exactly one of: warm window, cold list."""
    rng = np.random.default_rng(300 + seed)
    buf = tbuf.ShardBuffer(BLOCK, num_windows=2, sample_capacity=1 << 12,
                           slot_capacity=64, device="cpu")
    n = 200
    slots = rng.integers(0, 8, n).astype(np.int32)
    ts = np.where(rng.random(n) < 0.5, START + rng.integers(0, 100, n),
                  START - BLOCK + rng.integers(0, 100, n)).astype(np.int64)
    ncold = buf.write(slots, ts, rng.random(n), {START})
    assert ncold == int((ts < START).sum())
    wslots, wts, _ = buf.drain(START)
    cslots, cts, _ = buf.drain_cold(START - BLOCK)
    in_keys = {(int(s), int(t)) for s, t in zip(slots, ts)}
    out_keys = ({(int(s), int(t)) for s, t in zip(wslots, wts)}
                | {(int(s), int(t)) for s, t in zip(cslots, cts)})
    assert out_keys == in_keys


def test_drain_copies_to_host_once(monkeypatch):
    """A drain (and a cache refill) makes exactly one device -> host
    copy."""
    calls = []
    real = torch.Tensor.cpu

    def counting(self, *a, **kw):
        calls.append(self.shape)
        return real(self, *a, **kw)

    buf = tbuf.ShardBuffer(BLOCK, 2, 64, 16, device="cpu")
    rng = np.random.default_rng(1)
    buf.write(rng.integers(0, 16, 30).astype(np.int32),
              START + rng.integers(0, 99, 30).astype(np.int64),
              rng.normal(size=30), {START})
    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    buf.read_window_many(START, np.arange(16))
    buf.read_window(START, 3)
    assert len(calls) == 1
    buf.drain(START)
    assert len(calls) == 2
