"""The port's batched M3TSZ codec (m3_tpu_torch.encoding.m3tsz_torch)
against the JAX reference (m3_tpu.encoding.m3tsz_jax) on the same numpy
inputs, on the CPU.  Every comparison is exact: stream bytes, value
bits, timestamps, counts and fallback masks.
"""

import base64
import hashlib
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.conftest import DATA_DIR
from tests.test_decode_fuzz import _fuzz_batch
from m3_tpu.encoding import m3tsz_jax as mj
from m3_tpu.encoding.m3tsz import decode_series, encode_series
from m3_tpu_torch.core.xtime import Unit
from m3_tpu_torch.encoding import m3tsz_torch as mt

START = 1_600_000_000 * 10**9
SEC = 10**9
# sha256 over (packed words || nbits) of the arithmetic batch below, as
# pinned by the JAX suite (tests/test_m3tsz_jax.py)
PINNED_ENCODE_DIGEST = (
    "27ea67c4b75585a1e2bffa6cfeae5e5faeefbaca75de4d5c4c559f15d89ccc18")


def _bits(vals):
    return np.ascontiguousarray(vals).view(np.uint64)


def _assert_decodes_equal(a, b):
    ts_a, v_a, c_a, fb_a = a
    ts_b, v_b, c_b, fb_b = b
    assert np.array_equal(c_a, c_b)
    assert np.array_equal(fb_a, fb_b)
    assert np.array_equal(ts_a, ts_b)
    assert np.array_equal(_bits(v_a), _bits(v_b))


@pytest.fixture(scope="module")
def corpus():
    with open(DATA_DIR / "decode_corpus.json") as f:
        doc = json.load(f)
    return doc, [base64.b64decode(s) for s in doc["streams"]]


@pytest.fixture(scope="module")
def go_streams():
    with open(DATA_DIR / "m3tsz_sample_series.json") as f:
        return [base64.b64decode(s) for s in json.load(f)]


_EDGE_VALUES = [0.0, -0.0, 1.0, -1.5, 0.1, 0.30000000000000004, 123.45,
                -7.25, 12.015625, 9.999999e12, 1e13, 2.0**53, 2.0**53 + 2,
                2.0**62, 2.0**63, -2.0**63, 1e300, -1e-300, 5e-324, 2.2e-308,
                float("nan"), float("inf"), -float("inf"), 1.0000001, 0.001]


@pytest.mark.parametrize("mult", [0, 1, 3, 6])
def test_classify_value_edges(mult):
    v = np.array(_EDGE_VALUES, np.float64)
    m = np.full(v.shape, mult, np.int32)
    want = mj.classify_value(jnp.asarray(v.view(np.uint64)), jnp.asarray(m))
    got = mt.classify_value(torch.from_numpy(v.view(np.int64)),
                            torch.from_numpy(m.astype(np.int64)))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().astype(np.int64),
                              np.asarray(w).astype(np.int64))


def test_value_ctrl_table_equal():
    assert np.array_equal(mt._VALUE_CTRL_TBL, mj._VALUE_CTRL_TBL)
    assert mt._VALUE_CTRL_TBL.dtype == np.uint32


@pytest.mark.parametrize("seed", [0, 1])
def test_encode_decode_fuzz_batch_matches_jax(seed):
    """The whole slice on a mixed batch: identical bytes and fallback,
    identical decode outputs, and an exact round trip."""
    ts, vals, starts = _fuzz_batch(seed, 12, 120)
    got, fb = mt.encode_batch(ts, vals, starts, out_words=256, device="cpu")
    want, fb_j = mj.encode_batch(ts, vals, starts, out_words=256)
    assert got == want
    assert np.array_equal(fb, fb_j) and not fb.any()
    dec = mt.decode_batch(got, 121, device="cpu")
    _assert_decodes_equal(dec, mj.decode_batch(want, 121))
    dts, dvals, counts, dfb = dec
    assert (counts == 120).all() and not dfb.any()
    assert np.array_equal(dts[:, :120], ts)
    agree = (dvals[:, :120] == vals) | (np.isnan(dvals[:, :120]) & np.isnan(vals))
    assert agree.all()


def test_encode_fallbacks_and_counts_match_jax():
    """Precision-limit values, a delta off the unit grid, an unaligned
    start (time-unit marker), specials, variable counts and an empty
    series in one batch."""
    S, T = 6, 40
    ts = np.tile(START + np.arange(1, T + 1) * SEC, (S, 1)).astype(np.int64)
    vals = np.tile(np.arange(T, dtype=np.float64) * 0.25, (S, 1))
    vals[0] = float(2**60)                       # precision fallback
    ts[1, 5:] += 7                               # off the SECOND grid
    vals[2, ::3] = np.nan
    vals[2, 1::7] = -np.inf
    vals[3] = np.round(np.sin(np.arange(T)) * 1000, 2)
    starts = np.full(S, START, np.int64)
    starts[4] = START - 123                      # unaligned: TU marker
    counts = np.array([T, T, T, 17, 1, 0])
    got, fb = mt.encode_batch(ts, vals, starts, counts=counts, out_words=96,
                              device="cpu")
    want, fb_j = mj.encode_batch(ts, vals, starts, counts=counts, out_words=96)
    assert got == want and np.array_equal(fb, fb_j)
    assert fb[0] and fb[1] and not fb[2:].any() and got[5] == b""


def test_pinned_encode_digest():
    S, T = 8, 64
    i = np.arange(S, dtype=np.int64)[:, None]
    j = np.arange(T, dtype=np.int64)[None, :]
    ts = START + np.cumsum(((i * 37 + j * 11) % 29 + 1) * SEC, axis=1)
    vals = ((i * 131 + j * 17) % 4001 - 2000) / 8.0
    vals[2] = np.float64((j[0] * 7) % 1000)
    vals[5, 10:] = vals[5, 9]
    streams, fb = mt.encode_batch(ts, vals, np.full(S, START, np.int64),
                                  out_words=200, device="cpu")
    assert not fb.any()
    words, nbits = mt.pack_streams(streams)
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(words).tobytes())
    h.update(np.ascontiguousarray(nbits).tobytes())
    assert h.hexdigest() == PINNED_ENCODE_DIGEST


def test_reencode_pinned_corpus(corpus):
    """The verdicts of tests/test_encode_fuzz.py's corpus re-encode, with
    every stream in one batch: device-eligible streams give the exact
    original bytes, the unit-change family flags fallback (never wrong
    bytes), and mid-stream annotation streams round-trip their numeric
    content."""
    doc, streams = corpus
    pts = [decode_series(blob) for blob in streams]
    S, T = len(pts), max(len(p) for p in pts)
    ts = np.zeros((S, T), np.int64)
    vals = np.zeros((S, T), np.float64)
    for i, p in enumerate(pts):
        ts[i, :len(p)] = [d.timestamp for d in p]
        vals[i, :len(p)] = [d.value for d in p]
    counts = np.array([len(p) for p in pts])
    words, _ = mt.pack_streams(streams)
    anns = [p[0].annotation or None for p in pts]
    out, fb = mt.encode_batch(ts, vals, words[:, 0].view(np.int64),
                              counts=counts, unit=Unit.SECOND, out_words=4096,
                              annotations=anns, device="cpu")
    mid_ann = [any(d.annotation for d in p[1:]) for p in pts]
    assert all(out[i] == b"" for i in np.nonzero(fb)[0])
    exact = [i for i in range(S) if not fb[i] and not mid_ann[i]]
    assert all(out[i] == streams[i] for i in exact)
    rt = [i for i in range(S) if not fb[i] and mid_ann[i]]
    dts, dvals, dcounts, _ = mt.decode_batch(
        [out[i] for i in rt], T + 1, annotations_fallback=False, device="cpu")
    for k, i in enumerate(rt):
        n = counts[i]
        assert dcounts[k] == n
        assert np.array_equal(dts[k, :n], ts[i, :n])
        assert np.array_equal(_bits(dvals[k, :n]), _bits(vals[i, :n]))
    assert len(exact) >= 6 and int(fb.sum()) >= 2


@pytest.mark.parametrize("ann_fallback", [True, False])
def test_decode_corpus_matches_jax(corpus, ann_fallback):
    doc, streams = corpus
    got = mt.decode_batch(streams, doc["max_points"],
                          annotations_fallback=ann_fallback, device="cpu")
    want = mj.decode_batch(streams, doc["max_points"],
                           annotations_fallback=ann_fallback)
    _assert_decodes_equal(got, want)


def test_decode_go_streams_matches_jax(go_streams):
    got = mt.decode_batch(go_streams, 721, device="cpu")
    _assert_decodes_equal(got, mj.decode_batch(go_streams, 721))
    assert not got[3].any()


def test_go_streams_reencode_byte_identical(go_streams):
    """The Go encoder starts its streams in its default unit (SECOND) and
    switches to the points' unit (ms) on the first datapoint: with that
    default unit, the batched encoder reproduces every stream."""
    ts, vals, counts, fb = mt.decode_batch(go_streams, 721, device="cpu")
    T = int(counts.max())
    words, _ = mt.pack_streams(go_streams)
    out, fb2 = mt.encode_batch(ts[:, :T], vals[:, :T], words[:, 0].view(np.int64),
                               counts=counts, unit=Unit.MILLISECOND,
                               default_unit=Unit.SECOND,
                               out_words=T * 40 // 64 + 8, device="cpu")
    assert not fb2.any()
    assert out == go_streams


@pytest.mark.parametrize("scale", [1.0, 1e3, 1e-300])
def test_fit_words_sizes_to_the_longest_stream(scale):
    """Raw doubles (the XOR path) overflow a 40-bits-a-point sizing and
    fall back; ``fit_words`` sizes the output to the longest stream, so
    none falls back and every stream is the scalar encoder's."""
    rng = np.random.default_rng(int(np.log10(scale)) + 400)
    S, T = 9, 180
    ts = np.tile(START + np.arange(1, T + 1) * 10 * SEC, (S, 1)).astype(np.int64)
    vals = rng.normal(0, 1, (S, T)) * scale
    vals[0] = np.round(vals[0] / scale, 1)  # one short stream beside the long ones
    counts = np.full(S, T, np.int64)
    counts[1] = 7
    starts = np.full(S, START, np.int64)
    _, fb40 = mt.encode_batch(ts, vals, starts, counts=counts,
                              out_words=T * 40 // 64 + 8, device="cpu")
    assert fb40[2:].all()
    got, fb = mt.encode_batch(ts, vals, starts, counts=counts, fit_words=True,
                              device="cpu")
    assert not fb.any()
    want = [encode_series(list(zip(ts[i, :counts[i]].tolist(),
                                   vals[i, :counts[i]].tolist())), start=START)
            for i in range(S)]
    assert got == want


def test_first_datapoint_annotation_matches_jax():
    T = 24
    ts = np.tile(START + np.arange(1, T + 1) * SEC, (3, 1)).astype(np.int64)
    vals = np.round(np.arange(3)[:, None] + np.arange(T)[None, :] * 0.5, 1)
    anns = [b"proto-schema-A", None, b"x" * 100]
    starts = np.full(3, START, np.int64)
    got, fb = mt.encode_batch(ts, vals, starts, out_words=128,
                              annotations=anns, device="cpu")
    want, fb_j = mj.encode_batch(ts, vals, starts, out_words=128,
                                 annotations=anns)
    assert got == want and not fb.any() and not fb_j.any()
    dec = mt.decode_batch(got, T + 1, annotations_fallback=False, device="cpu")
    _assert_decodes_equal(dec, mj.decode_batch(want, T + 1,
                                               annotations_fallback=False))
    assert np.array_equal(dec[0][:, :T], ts)


def test_device_none_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ts = np.tile(START + np.arange(1, 5) * SEC, (1, 1)).astype(np.int64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mt.encode_batch(ts, np.ones((1, 4)), np.full(1, START, np.int64))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mt.decode_batch([b"\x00" * 16], 4)


def test_payload_value_bits_matches_jax():
    rng = np.random.default_rng(5)
    payload = rng.integers(0, 1 << 64, 200, dtype=np.uint64)
    payload[:100] = rng.integers(-10**9, 10**9, 100).astype(np.int64).view(np.uint64)
    meta = rng.integers(0, 32, 200).astype(np.uint8)
    got = mt.payload_value_bits(payload, meta)
    assert np.array_equal(got, mj.payload_value_bits(payload, meta))
