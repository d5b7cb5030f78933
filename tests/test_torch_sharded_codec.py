"""The port's series-sharded codec (``parallel/sharded_encode.py``,
``parallel/sharded_decode.py``) and the decode's ``fused`` chains tail,
against the JAX package on the CPU.  Every comparison is exact.

* sharded encode over D = 3 of an S that 3 does not divide, with and
  without ``prefix_bits``: words, ``total_bits`` and ``fallback`` equal
  to ``m3_tpu.parallel.sharded_encode``'s and to the port's one-device
  encode; the pinned 8 x 64 batch gives ``PINNED_ENCODE_DIGEST``;
* sharded decode, both ``scan_major`` layouts and both ``chains`` tails,
  equal to ``m3_tpu.parallel.sharded_decode``'s on every output;
* ``chains="fused"`` equal to ``"gather"`` bit for bit on the port's
  decode corpora;
* what the port lacks is refused by name.
"""

import base64
import hashlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import DATA_DIR
from tests.test_decode_fuzz import _fuzz_batch
from tests.test_torch_m3tsz import PINNED_ENCODE_DIGEST
from tests.test_torch_sharded_query import _mixed
from m3_tpu.encoding import m3tsz_jax as mj
from m3_tpu.parallel import sharded_decode as jdec
from m3_tpu.parallel import sharded_encode as jenc
from m3_tpu_torch.encoding import m3tsz_torch as mt
from m3_tpu_torch.parallel.sharded_decode import decode_batch_device_sharded
from m3_tpu_torch.parallel.sharded_encode import encode_batch_device_sharded

START = 1_600_000_000 * 10**9
SEC = 10**9
CPU3 = ["cpu"] * 3


def _np(x):
    """A JAX or torch output as numpy, u64 as its int64 bits."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int64) if a.dtype == np.uint64 else a


@pytest.mark.parametrize("with_prefix", [False, True])
def test_sharded_encode_equals_jax_and_one_device(with_prefix):
    """tests/test_encode_fuzz.py's uneven batch (S = 11 over 3 devices)."""
    S, T = 11, 40
    rng = np.random.default_rng(3)
    ts = np.tile(START + np.arange(1, T + 1) * SEC, (S, 1)).astype(np.int64)
    vals = np.round(rng.normal(50, 5, (S, T)), 2)
    starts = np.full(S, START, np.int64)
    valid = np.ones((S, T), bool)
    valid[4, 30:] = False
    prefix = rng.integers(0, 40, S).astype(np.int32) * 8 if with_prefix else None
    want = jenc.encode_batch_device_sharded(
        jnp.asarray(ts), jnp.asarray(vals.view(np.uint64)), jnp.asarray(starts),
        jnp.asarray(valid), out_words=64,
        prefix_bits=None if prefix is None else jnp.asarray(prefix), devices=3)
    got = encode_batch_device_sharded(ts, vals.view(np.int64), starts, valid, out_words=64,
                                      prefix_bits=prefix, devices=CPU3)
    one = mt.encode_batch_device(ts, vals.view(np.int64), starts, valid, out_words=64,
                                 prefix_bits=prefix, device="cpu")
    for k in ("words", "total_bits", "fallback"):
        assert got[k].shape[0] == S
        assert np.array_equal(_np(got[k]), _np(want[k])), k
        assert torch.equal(got[k], one[k]), k


def test_sharded_encode_default_width_and_one_device():
    ts, vals, starts = _fuzz_batch(1, 5, 30)
    valid = np.ones((5, 30), bool)
    got = encode_batch_device_sharded(ts, vals.view(np.int64), starts, valid, devices=CPU3)
    want = jenc.encode_batch_device_sharded(
        jnp.asarray(ts), jnp.asarray(vals.view(np.uint64)), jnp.asarray(starts),
        jnp.asarray(valid), devices=3)
    assert got["words"].shape == (5, (30 * 16) // 64 + 4)
    for k in ("words", "total_bits", "fallback"):
        assert np.array_equal(_np(got[k]), _np(want[k])), k
    single = encode_batch_device_sharded(ts, vals.view(np.int64), starts, valid,
                                         out_words=64, devices=["cpu"])
    assert not single["fallback"].any() and single["words"].shape == (5, 64)


def test_pinned_batch_over_three_devices_gives_the_pinned_digest():
    S, T = 8, 64
    i = np.arange(S, dtype=np.int64)[:, None]
    j = np.arange(T, dtype=np.int64)[None, :]
    ts = START + np.cumsum(((i * 37 + j * 11) % 29 + 1) * SEC, axis=1)
    vals = ((i * 131 + j * 17) % 4001 - 2000) / 8.0
    vals[2] = np.float64((j[0] * 7) % 1000)
    vals[5, 10:] = vals[5, 9]
    out = encode_batch_device_sharded(ts, vals.view(np.int64), np.full(S, START, np.int64),
                                      np.ones((S, T), bool), unit=int(mt.Unit.SECOND),
                                      out_words=200, devices=CPU3)
    assert not out["fallback"].any()
    streams = mt.finalize_streams(out["words"].numpy(), out["total_bits"].numpy())
    words, nbits = mt.pack_streams(streams)
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(words).tobytes())
    h.update(np.ascontiguousarray(nbits).tobytes())
    assert h.hexdigest() == PINNED_ENCODE_DIGEST


def _streams(seed=0, S=13, T=60):
    ts, vals, starts = _fuzz_batch(seed, S, T)
    streams, fb = mj.encode_batch(ts, vals, starts, out_words=256)
    assert not fb.any()
    return mj.pack_streams(streams)


@pytest.mark.parametrize("scan_major", [False, True])
@pytest.mark.parametrize("chains", ["gather", "fused"])
def test_sharded_decode_equals_jax(scan_major, chains):
    words, nbits = _streams()
    want = jdec.decode_batch_device_sharded(jnp.asarray(words), jnp.asarray(nbits), 61,
                                            chains=chains, scan_major=scan_major, devices=3)
    got = decode_batch_device_sharded(words.view(np.int64), nbits, 61, chains=chains,
                                      scan_major=scan_major, devices=CPU3)
    assert got[0].shape == ((61, 13) if scan_major else (13, 61))
    for k, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(_np(g), _np(w)), k


def _corpora():
    with open(DATA_DIR / "decode_corpus.json") as f:
        doc = json.load(f)
    corpus = [base64.b64decode(s) for s in doc["streams"]]
    ts, vals, starts, counts = _mixed()
    mixed, fb = mj.encode_batch(ts, vals, starts, counts=counts, out_words=160)
    assert not fb.any()
    with open(DATA_DIR / "m3tsz_sample_series.json") as f:
        gold = [base64.b64decode(s) for s in json.load(f)]
    return [("corpus", corpus, doc["max_points"]), ("mixed", mixed, ts.shape[1] + 2),
            ("go", gold, 721)]


@pytest.mark.parametrize("which", [0, 1, 2])
def test_fused_tail_equals_gather_tail(which):
    """Bit for bit on every output, including the error, precision and
    annotation flags; the corpus carries annotation streams, unit
    changes and errors."""
    name, streams, P = _corpora()[which]
    words, nbits = mt.pack_streams(streams)
    g = mt.decode_batch_device(words.view(np.int64), nbits, P, device="cpu", chains="gather")
    f = mt.decode_batch_device(words.view(np.int64), nbits, P, device="cpu", chains="fused")
    for k, (a, b) in enumerate(zip(g, f)):
        assert a.dtype == b.dtype and torch.equal(a, b), (name, k)
    auto = mt.decode_batch_device(words.view(np.int64), nbits, P, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(auto, g))


def test_refused_by_name():
    words, nbits = _streams(S=4, T=10)
    with pytest.raises(ValueError, match="chains='magic'"):
        decode_batch_device_sharded(words.view(np.int64), nbits, 11, chains="magic",
                                    devices=CPU3)
    with pytest.raises(ValueError, match="chains='magic'"):
        mt.decode_batch_device(words.view(np.int64), nbits, 11, device="cpu", chains="magic")
    ts, vals, starts = _fuzz_batch(0, 2, 10)
    with pytest.raises(ValueError, match="place='scatter'"):
        encode_batch_device_sharded(ts, vals.view(np.int64), starts, np.ones((2, 10), bool),
                                    place="scatter", devices=CPU3)


def test_devices_none_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    words, nbits = _streams(S=2, T=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_batch_device_sharded(words.view(np.int64), nbits, 11)
