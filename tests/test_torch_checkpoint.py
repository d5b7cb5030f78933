"""The port's aggregator checkpoint (``m3_tpu_torch/aggregator/checkpoint.py``)
on the CPU, against ``m3_tpu.aggregator.checkpoint``'s format.

* A port save → restore → consume equals the uninterrupted port run:
  sha256 over every drained lane (timestamps, metric types, slots,
  aggregation types, value bits), under both layouts, with transform
  tails and their state, a two-stage forward pending in the next stage's
  window, and a forward buffer entry.
* A JAX checkpoint restored by the port consumes the remaining batches
  to the same lanes as the JAX package's uninterrupted run, both layouts;
  the restore runs in a subprocess where ``m3_tpu`` and ``jax`` cannot be
  imported.
* A checkpoint taken under the native resolver restores under the Python
  one and the other way round, with the same slots for later ids.
* Corruption is typed: bad magic, truncation or schema give
  ``FormatCorruption``, a flipped header or lane byte
  ``ChecksumMismatch``; the checkpointer sets a corrupt file aside.
"""

from __future__ import annotations

import hashlib
import inspect
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import m3_tpu.aggregator.checkpoint as jck
import m3_tpu.aggregator.engine as je
import m3_tpu.metrics.aggregation as jagg
import m3_tpu.metrics.pipeline as jpipe
import m3_tpu.metrics.policy as jpol
import m3_tpu.metrics.transformation as jtf
import m3_tpu.metrics.types as jtypes
import m3_tpu_torch.aggregator.checkpoint as tck
import m3_tpu_torch.aggregator.engine as te
import m3_tpu_torch.metrics.aggregation as tagg
import m3_tpu_torch.metrics.pipeline as tpipe
import m3_tpu_torch.metrics.policy as tpol
import m3_tpu_torch.metrics.transformation as ttf
import m3_tpu_torch.metrics.types as ttypes
from m3_tpu_torch.persist.corruption import ChecksumMismatch, FormatCorruption

R = 10 * 10**9
T0 = 1_700_000_040 * 10**9
ROOT = Path(__file__).resolve().parent.parent
LAYOUTS = ("f64", "packed")


class _Pkg:
    def __init__(self, eng, ck, agg, pipe, pol, tf, types, **kw):
        self.eng, self.ck, self.agg, self.pipe = eng, ck, agg, pipe
        self.pol, self.tf, self.types, self.kw = pol, tf, types, kw

    def sp(self):
        return self.pol.StoragePolicy.parse("10s:2d")

    def mlist(self, layout, **opts):
        o = dict(capacity=64, num_windows=3, timer_sample_capacity=1 << 10,
                 quantiles=(0.5, 0.99), layout=layout, storage_policies=(self.sp(),))
        o.update(opts)
        return self.eng.MetricList(self.sp(), self.eng.AggregatorOptions(**o), **self.kw)

    def make_list(self, policy, opts):
        sp = self.pol.StoragePolicy.parse(policy)
        return self.eng.MetricList(sp, self.eng.AggregatorOptions(
            capacity=opts["capacity"], num_windows=opts["num_windows"],
            timer_sample_capacity=opts["timer_sample_capacity"],
            quantiles=tuple(opts["quantiles"]), timer_packed32=opts["timer_packed32"],
            layout=opts["layout"], storage_policies=(sp,)), **self.kw)


J = _Pkg(je, jck, jagg, jpipe, jpol, jtf, jtypes)
T = _Pkg(te, tck, tagg, tpipe, tpol, ttf, ttypes, device="cpu")


def _batch(P, ml, seed, w):
    """Counters, gauges and timers into window w, a rollup with an ADD then
    a PER_SECOND tail, and a two-stage forward."""
    rng = np.random.default_rng(seed)
    n = 40
    ids = [b"m%d" % i for i in rng.integers(0, 16, n)]
    ts = (T0 + w * R + rng.integers(1, R - 1, n)).astype(np.int64)
    MT, A = P.types.MetricType, P.agg.AggregationType
    ml.add_batch(MT.COUNTER, ids, rng.integers(-50, 50, n).astype(np.float64), ts)
    ml.add_batch(MT.GAUGE, ids, rng.normal(1e6, 1e3, n), ts)
    ml.add_batch(MT.TIMER, ids, np.abs(rng.normal(0.1, 0.05, n)), ts)
    sum_id = P.agg.AggregationID.compress([A.SUM])
    tail = P.pipe.Pipeline((P.pipe.TransformationOp(P.tf.TransformationType.ADD),
                            P.pipe.TransformationOp(P.tf.TransformationType.PER_SECOND)))
    ml.add_batch(MT.COUNTER, [b"roll.%d" % (i % 3) for i in range(n)],
                 rng.integers(0, 9, n).astype(np.float64), ts, sum_id, pipeline=tail)
    fwd = P.pipe.Pipeline((P.pipe.AppliedRollupOp(b"stage2", sum_id),
                           P.pipe.TransformationOp(P.tf.TransformationType.INCREASE)))
    ml.add_batch(MT.COUNTER, [b"s1.%d" % (i % 4) for i in range(n)],
                 rng.integers(0, 9, n).astype(np.float64), ts, sum_id, pipeline=fwd)


def _digest(outs) -> str:
    h = hashlib.sha256()
    for fm in outs:
        h.update(np.int64([fm.timestamp_nanos, int(fm.metric_type)]).tobytes())
        h.update(np.ascontiguousarray(fm.slots, np.int32).tobytes())
        h.update(np.ascontiguousarray(fm.types, np.int8).tobytes())
        h.update(np.ascontiguousarray(fm.values, np.float64).tobytes())
    return h.hexdigest()


def _lanes(outs) -> dict:
    """The drained rows as flat arrays (one row per slot and type)."""
    n = [fm.slots.size for fm in outs]
    return {"ts": np.repeat([fm.timestamp_nanos for fm in outs], n).astype(np.int64),
            "mt": np.repeat([int(fm.metric_type) for fm in outs], n).astype(np.int64),
            "slots": np.concatenate([fm.slots for fm in outs]).astype(np.int64),
            "types": np.concatenate([fm.types for fm in outs]).astype(np.int64),
            "values": np.concatenate([fm.values for fm in outs]).astype(np.float64)}


def _pending_forward(P, ml):
    """A forward buffer entry saved with the list (delivered at the next
    consume)."""
    sum_id = P.agg.AggregationID.compress([P.agg.AggregationType.SUM])
    ml._forward_buffer.append((P.eng.ForwardSpec(b"late.fwd", sum_id, ()), 4.5,
                               T0 + 3 * R))


def _first_half(P, layout):
    ml = P.mlist(layout)
    for w in range(3):
        _batch(P, ml, 10 + w, w)
        if w:
            ml.consume(T0 + w * R)
    _pending_forward(P, ml)
    return ml


def _second_half(P, ml):
    outs = []
    for w in range(3, 6):
        _batch(P, ml, 10 + w, w)
        outs += ml.consume(T0 + w * R)
    outs += ml.consume(T0 + 9 * R)
    return outs


def _save(P, ml, path):
    return P.ck.save_lists({ml.policy: ml}, path, extra_meta={"series_tags": {b"x": {b"k": b"v"}}})


def _restore(P, path):
    lists, extra = P.ck.restore_lists(path, P.make_list)
    assert extra == {"series_tags": {b"x": {b"k": b"v"}}}
    (ml,) = lists.values()
    return ml


@pytest.mark.parametrize("layout", LAYOUTS)
def test_port_save_restore_consume_equals_uninterrupted(layout, tmp_path):
    want = _digest(_second_half(T, _first_half(T, layout)))
    ml = _first_half(T, layout)
    n = _save(T, ml, tmp_path / "a.ckpt")
    assert n == (tmp_path / "a.ckpt").stat().st_size
    got = _restore(T, tmp_path / "a.ckpt")
    assert got.device.type == "cpu"
    assert got._pipelines and got._tf_state and got._forward_buffer
    assert _digest(_second_half(T, got)) == want


@pytest.mark.parametrize("layout", LAYOUTS)
def test_port_lanes_match_jax_lanes_byte_for_byte(layout, tmp_path):
    """The two packages' checkpoints of the same traffic hold the same
    lanes (names, dtypes, shapes, bytes) and the same host maps."""
    _save(J, _first_half(J, layout), tmp_path / "j.ckpt")
    _save(T, _first_half(T, layout), tmp_path / "t.ckpt")
    jh, ja = jck.load_lists(tmp_path / "j.ckpt")
    th, ta = tck.load_lists(tmp_path / "t.ckpt")
    for name, arr in ja[0].items():
        assert ta[0][name].dtype == arr.dtype and ta[0][name].shape == arr.shape, name
        tol_lane = name in ("gauge.sum_sq", "timer.sum_sq")
        if not tol_lane:
            assert ta[0][name].tobytes() == arr.tobytes(), name
        else:
            np.testing.assert_allclose(ta[0][name], arr, rtol=2e-15)
    for key in ("maps", "consumed_until", "drops", "timed_rejects", "opts", "layout"):
        assert th["lists"][0][key] == jh["lists"][0][key], key


@pytest.mark.parametrize("layout", LAYOUTS)
def test_jax_checkpoint_restored_by_port(layout, tmp_path):
    """The JAX package saves after three windows; the port restores the
    file in a process that cannot import m3_tpu or jax and consumes the
    remaining batches: the drained lanes equal the JAX package's
    uninterrupted run, bit for bit but the sum-of-squares and stdev lanes
    (``rtol`` 2e-15 and 1e-12: XLA contracts the square into an FMA)."""
    want = _lanes(_second_half(J, _first_half(J, layout)))
    _save(J, _first_half(J, layout), tmp_path / "j.ckpt")
    helpers = "".join(inspect.getsource(f) + "\n" for f in (
        _Pkg, _batch, _lanes, _second_half, _restore))
    code = textwrap.dedent(f"""
        import sys
        sys.modules['jax'] = None
        sys.modules['m3_tpu'] = None
        import hashlib
        import numpy as np
        import m3_tpu_torch.aggregator.checkpoint as tck
        import m3_tpu_torch.aggregator.engine as te
        import m3_tpu_torch.metrics.aggregation as tagg
        import m3_tpu_torch.metrics.pipeline as tpipe
        import m3_tpu_torch.metrics.policy as tpol
        import m3_tpu_torch.metrics.transformation as ttf
        import m3_tpu_torch.metrics.types as ttypes
        R, T0 = {R}, {T0}
        """) + helpers + textwrap.dedent(f"""
        T = _Pkg(te, tck, tagg, tpipe, tpol, ttf, ttypes, device="cpu")
        ml = _restore(T, {str(tmp_path / 'j.ckpt')!r})
        assert type(ml._forward_buffer[0][0]).__module__ == 'm3_tpu_torch.aggregator.engine'
        np.savez({str(tmp_path / 'port.npz')!r}, **_lanes(_second_half(T, ml)))
        assert not any(k == 'jax' or k.startswith(('jax.', 'm3_tpu.'))
                       for k, v in sys.modules.items() if v is not None)
        """)
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    got = dict(np.load(tmp_path / "port.npz"))
    for k in ("ts", "mt", "slots", "types"):
        assert np.array_equal(got[k], want[k]), k
    names = [tagg.AggregationType(int(t)).name for t in want["types"]]
    tol = np.asarray([n in ("SUM_SQ", "STDEV") for n in names])
    assert np.array_equal(got["values"][~tol].view(np.uint64),
                          want["values"][~tol].view(np.uint64))
    sq = np.asarray([n == "SUM_SQ" for n in names])
    np.testing.assert_allclose(got["values"][sq], want["values"][sq], rtol=2e-15)
    np.testing.assert_allclose(got["values"][tol & ~sq], want["values"][tol & ~sq],
                               rtol=1e-12)


@pytest.mark.parametrize("saved_native", [True, False])
def test_checkpoint_across_resolvers(saved_native, tmp_path):
    """Saved under one resolver, restored under the other: same ids by
    slot, and later new ids take the same slots as the uninterrupted run
    (holes from expired slots included)."""
    def mlist(native):
        ml = T.mlist("packed")
        for mt in list(ml.maps):
            ml.maps[mt] = te.MetricMap(ml.opts.capacity, use_native=native)
        return ml

    MT = ttypes.MetricType
    ml = mlist(saved_native)
    ml.add_batch(MT.COUNTER, [b"a%d" % i for i in range(20)], np.ones(20),
                 np.full(20, T0, np.int64))
    ml.add_batch(MT.COUNTER, [b"b%d" % i for i in range(5)], np.ones(5),
                 np.full(5, T0 + 2 * R, np.int64))
    assert ml.expire(T0 + 2 * R, ttl_nanos=R) == 20  # every a-slot is a hole
    tck.save_lists({ml.policy: ml}, tmp_path / "c.ckpt")
    saved_ids = [ml.maps[MT.COUNTER].id_of(s) for s in range(25)]
    uninterrupted = ml.maps[MT.COUNTER].resolve([b"c%d" % i for i in range(30)],
                                                tagg.AggregationID.DEFAULT, MT.COUNTER)

    restored = mlist(not saved_native)
    header, arrays = tck.load_lists(tmp_path / "c.ckpt")
    tck.restore_list_state(restored, header["lists"][0], arrays[0])
    m = restored.maps[MT.COUNTER]
    assert m.native == (not saved_native)
    assert [m.id_of(s) for s in range(25)] == saved_ids
    got = m.resolve([b"c%d" % i for i in range(30)], tagg.AggregationID.DEFAULT, MT.COUNTER)
    # a native save reports no free list: the Python restore refills holes
    # from the top, the native restore in slot order (the reference's
    # behaviour); both give each of the 30 new ids a distinct free slot
    assert len(set(got.tolist())) == 30
    assert set(got.tolist()).isdisjoint(range(20, 25))
    if not saved_native:
        assert np.array_equal(got, uninterrupted)


def _saved(tmp_path):
    ml = _first_half(T, "packed")
    path = tmp_path / "c.ckpt"
    _save(T, ml, path)
    return path


def _flip(path, offset):
    data = bytearray(path.read_bytes())
    data[offset] ^= 0x40
    path.write_bytes(bytes(data))


def test_corruption_is_typed(tmp_path):
    path = _saved(tmp_path)
    raw = path.read_bytes()
    cases = {
        "magic": (lambda: path.write_bytes(b"X" + raw[1:]), FormatCorruption),
        "truncated": (lambda: path.write_bytes(raw[:12]), FormatCorruption),
        "schema": (lambda: path.write_bytes(raw[:9] + bytes([2]) + raw[10:]), FormatCorruption),
        "header": (lambda: _flip(path, 30), ChecksumMismatch),
        "lane": (lambda: _flip(path, len(raw) - 5), ChecksumMismatch),
    }
    for name, (spoil, exc) in cases.items():
        path.write_bytes(raw)
        spoil()
        with pytest.raises(exc):
            tck.load_lists(path)
        # the JAX loader classifies the same bytes the same way
        with pytest.raises(ValueError) as e:
            jck.load_lists(path)
        assert type(e.value).__name__ == exc.__name__, name


def test_geometry_mismatch_is_format_corruption(tmp_path):
    path = _saved(tmp_path)
    header, arrays = tck.load_lists(path)
    other = T.mlist("packed", capacity=128)
    with pytest.raises(FormatCorruption):
        tck.restore_list_state(other, header["lists"][0], arrays[0])


def test_checkpointer_sets_corrupt_file_aside(tmp_path):
    import m3_tpu_torch.coordinator.downsample as tds
    import m3_tpu_torch.metrics.rules as trules
    import m3_tpu_torch.storage.database as tdb

    db = tdb.Database(tdb.DatabaseOptions(root=str(tmp_path / "db")), device="cpu")
    ds = tds.Downsampler(db, trules.RuleSet(), device="cpu")
    ck = tck.AggregatorCheckpointer(ds, tmp_path / "agg.ckpt")
    assert ck.restore() is False  # nothing saved yet
    assert ck.save()["bytes"] > 0
    assert ck.restore() is True
    _flip(tmp_path / "agg.ckpt", 20)
    assert ck.restore() is False
    assert (tmp_path / "agg.ckpt.corrupt").exists() and not (tmp_path / "agg.ckpt").exists()
    assert ck.status() == {"path": str(tmp_path / "agg.ckpt"), "saves": 1,
                           "save_errors": 0, "restores": 1, "corrupt": 1}
    # instrument= counts the same events on the registry (it raised
    # before the registry was ported)
    import m3_tpu_torch.instrument as tinst

    reg = tinst.new_registry()
    ick = tck.AggregatorCheckpointer(ds, tmp_path / "y.ckpt", instrument=reg.scope("m3tpu"))
    ick.save()
    assert ick.restore() is True
    _flip(tmp_path / "y.ckpt", 20)
    assert ick.restore() is False
    text = reg.render_prometheus()
    for line in ("m3tpu_aggregator_checkpoint_saves 1",
                 "m3tpu_aggregator_checkpoint_restores 1",
                 "m3tpu_aggregator_checkpoint_corrupt 1"):
        assert line in text, line
    db.close()
