"""m3_tpu_torch.parallel.sharded_query against m3_tpu.parallel.sharded_query
on the CPU.

* ``decode_to_step_series``: timestamps and error flags equal to the
  reference's, value bits equal to the encoded values and to the host
  decode path's, exactly (NaN in place of NaN), on a mix of counters,
  decimal gauges, raw floats and NaN-bearing series; the reference's
  own device values within 1 ulp (see the test);
* ``decode_rate_hq`` (the one-device form) against the reference's
  ``single_device_reference`` on ``tests/test_sharded_query.py``'s corpus
  shape with D = 1: rates ``rtol`` 1e-14 (elementwise f64 arithmetic,
  which XLA may contract), hq ``rtol`` 1e-12 (the bucket sum adds in
  another order), the error flags exactly;
* ``sharded_decode_rate_hq`` on a (4, 2) mesh of ``cpu`` devices
  against the reference's on ``make_mesh(4, 2)``, on
  ``tests/test_sharded_query.py``'s corpus and past 64 buckets: rates
  ``rtol`` 1e-14, hq ``rtol`` 1e-12 (XLA's all-reduce order is not
  documented), errs exactly; and against the port's own
  ``single_device_reference``: rates bit for bit (the same per-series
  program), hq ``rtol`` 1e-12 (the bucket sums add in another order).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from m3_tpu.encoding import m3tsz_jax as jcodec
from m3_tpu.parallel import make_mesh as jax_make_mesh
from m3_tpu.parallel import sharded_query as jsq
from m3_tpu_torch.encoding import m3tsz_torch as mt
from m3_tpu_torch.parallel import mesh
from m3_tpu_torch.parallel import sharded_query as tsq

SEC = 10**9
START = 1_600_000_000 * SEC
UBS = (0.1, 0.5, 1.0, float("inf"))


def _mixed(S=40, T=90, seed=4):
    rng = np.random.default_rng(seed)
    ts = START + np.cumsum(10 + rng.integers(-3, 4, (S, T)), axis=1) * SEC
    fam = np.arange(S) % 5
    vals = np.where(fam[:, None] == 0, np.cumsum(rng.integers(0, 99, (S, T)), axis=1),
           np.where(fam[:, None] == 1, np.round(rng.normal(50, 9, (S, T)), 2),
           np.where(fam[:, None] == 2, rng.normal(0, 1, (S, T)),
           np.where(fam[:, None] == 3, 7.0, np.round(rng.normal(9, 1, (S, T)), 1)))))
    vals[4::5, ::11] = np.nan
    counts = np.full(S, T, np.int64)
    counts[3] = T // 2  # a short stream: padded slots
    return ts.astype(np.int64), vals + 0.0, np.full(S, START, np.int64), counts


def _jax_decode(words, nbits, max_points):
    chains = jcodec.resolved_chains()
    fn = jax.jit(functools.partial(jsq.decode_to_step_series, max_points=max_points,
                                   chains=chains,
                                   extract=jcodec._resolved_extract(chains)))
    return [np.asarray(x) for x in fn(jnp.asarray(words), jnp.asarray(nbits),
                                      ctrl_tbl=jcodec.value_ctrl_table())]


def test_decode_to_step_series_is_exact():
    """Timestamps and error flags equal the reference's.  The value bits
    equal the encoded values and the host path's (``decode_batch``, whose
    ``payload_value_bits`` divides by exact powers of ten) bit for bit.
    The reference's device form divides ``payload / 10.0 ** mult`` under
    XLA and lands 1 ulp off on some decimal values: against it the bound
    is 1 ulp, and where the two differ the port holds the encoded value."""
    ts, vals, starts, counts = _mixed()
    streams, fb = jcodec.encode_batch(ts, vals, starts, counts=counts, out_words=160)
    assert not fb.any()
    words, nbits = jcodec.pack_streams(streams)
    P = ts.shape[1] + 2
    j_ts, j_vals, j_err = _jax_decode(words, nbits, P)
    t_ts, t_vals, t_err = tsq.decode_to_step_series(
        torch.from_numpy(words.view(np.int64)), torch.from_numpy(nbits), P)
    t_ts, tv = t_ts.numpy(), t_vals.numpy()
    np.testing.assert_array_equal(t_ts, j_ts)
    np.testing.assert_array_equal(t_err.numpy(), j_err)
    np.testing.assert_array_equal(np.isnan(tv), np.isnan(j_vals))
    ok = ~np.isnan(tv)
    bits, jbits = tv.view(np.int64), j_vals.view(np.int64)
    assert (np.abs(bits[ok] - jbits[ok]) <= 1).all()
    h_ts, h_vals, h_counts, h_fb = mt.decode_batch(streams, P, device="cpu")
    assert not h_fb.any() and (h_counts == counts).all()
    for s in range(len(ts)):
        n = counts[s]
        np.testing.assert_array_equal(t_ts[s, :n], ts[s, :n])
        np.testing.assert_array_equal(t_ts[s, :n], h_ts[s, :n])
        assert (t_ts[s, n:] == np.iinfo(np.int64).max).all()
        np.testing.assert_array_equal(tv[s, :n].view(np.uint64),
                                      h_vals[s, :n].view(np.uint64))
        np.testing.assert_array_equal(tv[s, :n].view(np.uint64),
                                      vals[s, :n].view(np.uint64))
    assert (bits[ok] != jbits[ok]).any()  # the reference's 1-ulp cases are here


def _bucket_corpus(D, S, T, seed=3):
    """tests/test_sharded_query.py's cumulative bucket counters."""
    rng = np.random.default_rng(seed)
    ts = np.tile(START + np.arange(1, T + 1) * 15 * SEC, (D * S, 1)).astype(np.int64)
    bucket_ids = rng.integers(0, len(UBS), (D, S)).astype(np.int32)
    frac = (bucket_ids.reshape(-1) + 1) / len(UBS)
    incr = np.round(10.0 * frac, 1)
    vals = np.cumsum(np.tile(incr[:, None], (1, T)), axis=1)
    return ts, vals, np.full(D * S, START, np.int64), bucket_ids


@pytest.mark.parametrize("S,T,q", [(24, 64, 0.9), (7, 40, 0.5)])
def test_decode_rate_hq_matches_reference(S, T, q):
    ts, vals, starts, bucket_ids = _bucket_corpus(1, S, T)
    streams, fb = jcodec.encode_batch(ts, vals, starts, out_words=300)
    assert not fb.any()
    words, nbits = jcodec.pack_streams(streams)
    step_times = np.asarray(START + np.arange(8, T - 8, 4) * 15 * SEC, np.int64)
    range_nanos = 5 * 60 * SEC
    ubs = np.asarray(UBS)
    r_ref, hq_ref, e_ref = jsq.single_device_reference(
        words.reshape(1, S, -1), nbits.reshape(1, S), bucket_ids, step_times, ubs,
        range_nanos, q, T + 1, len(UBS))
    rates, hq, errs = tsq.decode_rate_hq(words, nbits, bucket_ids[0], step_times, ubs,
                                         range_nanos, q, T + 1, len(UBS), device="cpu")
    np.testing.assert_array_equal(errs.numpy(), e_ref[0])
    np.testing.assert_allclose(rates.numpy(), r_ref[0], rtol=1e-14)
    np.testing.assert_allclose(hq.numpy(), hq_ref, rtol=1e-12)
    assert np.isfinite(hq.numpy()).all()


def test_many_buckets_take_the_scatter_form():
    rng = np.random.default_rng(1)
    rates = torch.from_numpy(rng.random((300, 5)))
    rates[3, 2] = float("nan")
    bid = torch.from_numpy(rng.integers(-2, 70, 300))
    want = np.zeros((66, 5))
    np.add.at(want, np.clip(bid.numpy(), 0, 65), np.nan_to_num(rates.numpy()))
    np.testing.assert_allclose(tsq._bucket_sum(rates, bid, 66).numpy(), want, rtol=1e-14)
    np.testing.assert_allclose(tsq._bucket_sum(rates, bid.clamp(0, 40), 64).numpy(),
                               np.concatenate([want[:40], want[40:].sum(0, keepdims=True),
                                               np.zeros((23, 5))]), rtol=1e-14)


def test_device_none_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = np.zeros((1, 4), np.int64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsq.decode_rate_hq(w, np.zeros(1, np.int64), np.zeros(1, np.int32),
                           np.zeros(1, np.int64), np.asarray(UBS), SEC, 0.5, 4, 4)


def _sharded_inputs(D, S, T, ubs, seed):
    ts, vals, starts, bucket_ids = _bucket_corpus(D, S, T, seed=seed)
    if len(ubs) != len(UBS):  # spread the series over every bucket
        bucket_ids = np.random.default_rng(seed).integers(-1, len(ubs) + 1, (D, S))
        bucket_ids = bucket_ids.astype(np.int32)
    streams, fb = jcodec.encode_batch(ts, vals, starts, out_words=300)
    assert not fb.any()
    words, nbits = jcodec.pack_streams(streams)
    step_times = np.asarray(START + np.arange(8, T - 8, 4) * 15 * SEC, np.int64)
    return words.reshape(D, S, -1), nbits.reshape(D, S), bucket_ids, step_times


@pytest.mark.parametrize("S,T,q,ubs", [
    (6, 64, 0.9, UBS),
    (40, 48, 0.5, tuple(float(b) for b in np.geomspace(0.01, 100.0, 65)) + (float("inf"),)),
])
def test_sharded_decode_rate_hq_matches_reference(S, T, q, ubs):
    D, B = 4, len(ubs)
    words, nbits, bid, step_times = _sharded_inputs(D, S, T, ubs, seed=3)
    range_nanos = 5 * 60 * SEC
    ubs = np.asarray(ubs)
    jt = jax_make_mesh(4, 2, devices=jax.devices()[:8])
    j_rates, j_hq, j_errs = jsq.sharded_decode_rate_hq(
        jt, jnp.asarray(words), jnp.asarray(nbits), jnp.asarray(bid),
        jnp.asarray(step_times), jnp.asarray(ubs), range_nanos, q, T + 1, B)
    topo = mesh.make_mesh(4, 2, ["cpu"] * 8)
    rates, hq, errs = tsq.sharded_decode_rate_hq(topo, words, nbits, bid, step_times, ubs,
                                                 range_nanos, q, T + 1, B)
    assert rates.shape == (D, S, len(step_times)) and hq.shape == (len(step_times),)
    np.testing.assert_array_equal(errs.numpy(), np.asarray(j_errs))
    assert not errs.any()
    np.testing.assert_allclose(rates.numpy(), np.asarray(j_rates), rtol=1e-14)
    np.testing.assert_allclose(hq.numpy(), np.asarray(j_hq), rtol=1e-12)
    assert np.isfinite(hq.numpy()).all()
    r_ref, hq_ref, e_ref = tsq.single_device_reference(words, nbits, bid, step_times, ubs,
                                                       range_nanos, q, T + 1, B, device="cpu")
    assert np.array_equal(rates.numpy(), r_ref, equal_nan=True)
    np.testing.assert_allclose(hq.numpy(), hq_ref, rtol=1e-12)
    np.testing.assert_array_equal(errs.numpy(), e_ref)
    j_ref = jsq.single_device_reference(words, nbits, bid, step_times, ubs, range_nanos, q,
                                        T + 1, B)
    np.testing.assert_allclose(hq_ref, j_ref[1], rtol=1e-12)


def test_replicas_run_their_own_copy():
    """Every (shard, replica) device computes; the replicas agree bit for
    bit and the result does not depend on the mesh's replica count."""
    D, S, T = 4, 5, 40
    words, nbits, bid, step_times = _sharded_inputs(D, S, T, UBS, seed=11)
    args = (words, nbits, bid, step_times, np.asarray(UBS), 5 * 60 * SEC, 0.5, T + 1, 4)
    one = tsq.sharded_decode_rate_hq(mesh.make_mesh(4, 1, ["cpu"] * 4), *args)
    two = tsq.sharded_decode_rate_hq(mesh.make_mesh(4, 2, ["cpu"] * 8), *args)
    for a, b in zip(one, two):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
