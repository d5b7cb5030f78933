"""The port's native host codec (``m3_tpu_torch.native`` over
``csrc/m3tsz.cc``) held against the JAX package's (``m3_tpu.native`` over
``native/m3tsz.cc``), the port's scalar codec and its batched codec on
the CPU: byte-identical streams, identical timestamps and value bits, the
same ``None`` / ``ValueError`` / ``fallback`` outcomes.  The library
must build here (g++ is present): nothing skips."""

from __future__ import annotations

import numpy as np
import pytest

from m3_tpu import native as ref_native
from m3_tpu_torch import native
from m3_tpu_torch.encoding import m3tsz as scalar
from m3_tpu_torch.encoding import m3tsz_torch as mt
from m3_tpu_torch.x import costwatch

START = 1_700_000_000 * 10**9


@pytest.fixture(scope="module", autouse=True)
def _reference_library():
    """The reference's loader writes its library in place and caches a
    failed load; parallel test workers that collect ``tests/test_native.py``
    build it at once, and one may have read another's half-written file.
    Once those builds are over, one more load settles it."""
    if ref_native._lib is None:
        ref_native._tried = False
        ref_native._load()


def _cases():
    """The reference's nine series shapes (``tests/test_native.py``)."""
    rng = np.random.default_rng(11)
    T = 300
    ts_reg = START + np.arange(1, T + 1) * 10 * 10**9
    out = []
    out.append(("int-ramp", ts_reg, (np.arange(T) % 97).astype(float)))
    out.append(("const", ts_reg, np.full(T, 42.0)))
    out.append(("decimal2", ts_reg, np.round(rng.normal(100, 10, T), 2)))
    out.append(("floats", ts_reg, rng.normal(0, 1, T)))
    out.append(("mixed", ts_reg, np.where(np.arange(T) % 7 == 0,
                                          rng.normal(0, 1, T),
                                          np.round(rng.uniform(0, 50, T), 1))))
    out.append(("big-counter", ts_reg, np.cumsum(rng.integers(0, 10**6, T)).astype(float)))
    out.append(("negative", ts_reg, -np.round(rng.uniform(0, 1000, T), 3)))
    # irregular timestamps crossing every dod bucket
    gaps = np.concatenate([
        np.full(50, 10), rng.integers(1, 60, 50), rng.integers(60, 2000, 30),
        rng.integers(2000, 300000, 10),
    ]) * 10**9
    ts_irr = START + np.cumsum(gaps)
    out.append(("irregular-ts", ts_irr, rng.normal(10, 1, len(ts_irr))))
    out.append(("single", ts_reg[:1], np.array([3.5])))
    return out


CASES = _cases()
IDS = [c[0] for c in CASES]


def _bits(v) -> np.ndarray:
    return np.ascontiguousarray(v, np.float64).view(np.uint64)


def _annotated() -> bytes:
    enc = scalar.Encoder(START)
    enc.encode(scalar.Datapoint(START + 10**10, 1.0, annotation=b"schema1"))
    enc.encode(scalar.Datapoint(START + 2 * 10**10, 2.0))
    return enc.stream()


def test_the_library_builds_here():
    assert native.available()
    assert ref_native.available()


@pytest.mark.parametrize("name,ts,vals", CASES, ids=IDS)
def test_encode_bytes_equal_the_reference_and_the_scalar_encoder(name, ts, vals):
    ours = native.encode_series(ts, vals, START)
    assert ours is not None
    assert ours == ref_native.encode_series(ts, vals, START), name
    assert ours == scalar.encode_series(list(zip(ts.tolist(), vals.tolist())),
                                        start=START), name


@pytest.mark.parametrize("name,ts,vals", CASES, ids=IDS)
def test_decode_equals_the_reference_and_the_scalar_decoder(name, ts, vals):
    blob = scalar.encode_series(list(zip(ts.tolist(), vals.tolist())), start=START)
    dts, dvals = native.decode_series(blob)
    rts, rvals = ref_native.decode_series(blob)
    pts = np.array([d.timestamp for d in scalar.decode_series(blob)], np.int64)
    pvals = np.array([d.value for d in scalar.decode_series(blob)], np.float64)
    for other_ts, other_vals in ((rts, rvals), (pts, pvals), (ts, vals)):
        np.testing.assert_array_equal(dts, other_ts)
        np.testing.assert_array_equal(_bits(dvals), _bits(other_vals))


def test_misaligned_start_is_none_in_both():
    ts = START + 5 + np.arange(1, 10) * 10**10
    assert native.encode_series(ts, np.ones(9), START + 5) is None
    assert ref_native.encode_series(ts, np.ones(9), START + 5) is None


def test_annotation_stream_is_none_in_both():
    blob = _annotated()
    assert native.decode_series(blob) is None
    assert ref_native.decode_series(blob) is None


def test_corrupt_stream_raises_in_both():
    blob = scalar.encode_series([(START + 10**10, 1.0)], start=START)
    for mod in (native, ref_native):
        with pytest.raises(ValueError, match="corrupt m3tsz stream"):
            mod.decode_series(blob[:6])


def test_empty_stream_and_point_cap_as_the_reference():
    for mod in (native, ref_native):
        ts, vals = mod.decode_series(b"")
        assert ts.shape == vals.shape == (0,)
    ts, vals = CASES[2][1], CASES[2][2]
    blob = native.encode_series(ts, vals, START)
    # a cap below the stream's points grows the buffer, as the reference does
    got = native.decode_series(blob, max_points=7)
    want = ref_native.decode_series(blob, max_points=7)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(_bits(got[1]), _bits(want[1]))
    assert len(got[0]) == len(ts)


def _batch_corpus():
    rng = np.random.default_rng(13)
    S, T = 64, 97
    ts = np.tile(START + np.arange(1, T + 1) * 10 * 10**9, (S, 1)).astype(np.int64)
    vals = np.empty((S, T))
    vals[0::3] = rng.integers(-(10**6), 10**6, ((S + 2) // 3, T)).astype(float)
    vals[1::3] = np.round(rng.normal(0, 100, ((S + 1) // 3, T)), 2)
    vals[2::3] = rng.normal(0, 1e9, (S // 3, T))
    return ts, vals, np.full(S, START, np.int64), rng.integers(1, T + 1, S)


def test_batch_equals_single_and_the_reference():
    ts, vals, starts, counts = _batch_corpus()
    S, T = ts.shape
    streams, fb = native.encode_batch(ts, vals, starts, counts=counts)
    ref_streams, ref_fb = ref_native.encode_batch(ts, vals, starts, counts=counts)
    assert not fb.any() and not ref_fb.any()
    assert streams == ref_streams
    for i in range(S):
        n = int(counts[i])
        assert streams[i] == native.encode_series(ts[i, :n], vals[i, :n], START)
    got = native.decode_batch(streams, T + 1)
    want = ref_native.decode_batch(streams, T + 1)
    assert not got[3].any()
    np.testing.assert_array_equal(got[2], counts)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.view(np.uint64) if a.dtype == np.float64 else a,
                                      b.view(np.uint64) if b.dtype == np.float64 else b)
    for i in range(S):
        n = int(counts[i])
        sts, svals = native.decode_series(streams[i], max_points=T + 1)
        np.testing.assert_array_equal(got[0][i, :n], sts)
        np.testing.assert_array_equal(_bits(got[1][i, :n]), _bits(svals))


@pytest.mark.parametrize("nthreads", [2, 4, 7])
def test_threaded_equals_one_thread(nthreads):
    ts, vals, starts, counts = _batch_corpus()
    s1, f1 = native.encode_batch(ts, vals, starts, counts=counts, nthreads=1)
    sn, fn = native.encode_batch(ts, vals, starts, counts=counts, nthreads=nthreads)
    assert s1 == sn and np.array_equal(f1, fn)
    out1 = native.decode_batch(s1, ts.shape[1] + 1, nthreads=1)
    outn = native.decode_batch(s1, ts.shape[1] + 1, nthreads=nthreads)
    for a, b in zip(out1, outn):
        np.testing.assert_array_equal(a, b)


def test_batch_flags_bad_streams_and_goes_on():
    ts = START + np.arange(1, 9) * 10**10
    good = native.encode_series(ts, np.arange(8.0), START)
    streams = [good, _annotated(), good[:5], good]
    for mod in (native, ref_native):
        dts, dvals, counts, fb = mod.decode_batch(streams, 16)
        assert list(fb) == [False, True, True, False]
        assert list(counts) == [8, 0, 0, 8]
        np.testing.assert_array_equal(dts[0, :8], ts)
        np.testing.assert_array_equal(dts[3, :8], ts)
        np.testing.assert_array_equal(dvals[3, :8], np.arange(8.0))
        assert not dts[1].any() and not dts[2].any()
    # an encode the native path refuses is flagged, its neighbours encoded
    bad = (np.stack([ts, ts + 5]), np.ones((2, 8)), np.array([START, START + 5]))
    streams, fb = native.encode_batch(*bad)
    ref_streams, ref_fb = ref_native.encode_batch(*bad)
    assert list(fb) == list(ref_fb) == [False, True]
    assert streams == ref_streams
    assert streams == [native.encode_series(ts, np.ones(8), START), b""]


def test_batch_argument_checks_as_the_reference():
    ts, vals, starts, _ = _batch_corpus()
    for mod in (native, ref_native):
        with pytest.raises(ValueError, match="counts must be"):
            mod.encode_batch(ts, vals, starts, counts=np.full(ts.shape[0], ts.shape[1] + 1))
        with pytest.raises(ValueError, match="starts must have shape"):
            mod.encode_batch(ts, vals, starts[:3])


def test_thread_count_and_capacity_as_the_reference():
    for n in (None, 0, 1, 5):
        assert native._nthreads(n) == ref_native._nthreads(n)
    for n in (0, 1, 2, 720, 10**6):
        assert native._encode_cap(n) == ref_native._encode_cap(n)


def test_encode_batch_equals_the_batched_codec_on_the_cpu():
    """The native batch and the port's batched codec (its plain versions
    on the CPU) write the same bytes over the bench corpus, and each
    decodes the other's streams to the corpus's timestamps and value
    bits."""
    ts, vals, starts = costwatch.bench_corpus(64, 120)
    streams, fb = native.encode_batch(ts, vals, starts)
    dev_streams, dev_fb = mt.encode_batch(ts, vals, starts, device="cpu", fit_words=True)
    assert not fb.any() and not dev_fb.any()
    assert streams == dev_streams
    dts, dvals, counts, dfb = native.decode_batch(dev_streams, 121)
    assert not dfb.any() and (counts == 120).all()
    np.testing.assert_array_equal(dts[:, :120], ts)
    np.testing.assert_array_equal(_bits(dvals[:, :120]), _bits(vals))
    mts, mvals, mcounts, mfb = mt.decode_batch(streams, 121, device="cpu")
    assert not mfb.any() and np.array_equal(mcounts, counts)
    np.testing.assert_array_equal(mts[:, :120], dts[:, :120])
    np.testing.assert_array_equal(_bits(mvals[:, :120]), _bits(dvals[:, :120]))
