"""The storage -> query pipeline on one card: M3TSZ bytes to quantiles.
The counterpart of ``m3_tpu/parallel/sharded_query.py``.

``decode_rate_hq`` is the one-device form of the reference's per-shard
program for ``histogram_quantile(q, sum by (le) (rate(bucket[R])))``:
the batched decode (``encoding/m3tsz_torch.decode_batch_device``, whose
field extraction is kernel #2), ``rate`` over the decoded (series x
step) matrix, the by-bucket sum, then the histogram-quantile program;
with one device there is no collective.  The D-device form, and the
reference's ``single_device_reference`` oracle that checks it, wait for
a device mesh in the port.
"""

from __future__ import annotations

import numpy as np
import torch

from m3_tpu_torch import resolve_device
from m3_tpu_torch.encoding import m3tsz_torch as codec
from m3_tpu_torch.parallel import segment_ingest
from m3_tpu_torch.query import device_fns, temporal

_I64_MAX = np.iinfo(np.int64).max
# 10^mult for the decimal multipliers 0..7, each exact in float64: the
# int payload / 10^mult division then rounds exactly as the host path's
# ``payload_value_bits`` does (a device ``pow`` need not be exact).
_POW10 = tuple(10.0 ** k for k in range(8))


def decode_to_step_series(words, nbits, max_points: int):
    """Decode packed streams ((S, W) int64 carriers of the u64 words and
    (S,) bit counts, on the caller's device) to padded (ts, float64
    values) ready for the temporal stencils: invalid slots carry
    ts = int64 max (outside every window) and NaN.  Returns contiguous
    (S, P) ts and values and the (S,) error flags (decode error or
    precision loss)."""
    ts, payload, meta, err, prec, _ann = codec.decode_batch_device(
        words, nbits, max_points, device=words.device)
    meta = meta.to(torch.int64)
    valid = (meta & 16) != 0
    isf = (meta & 8) != 0
    pow10 = torch.tensor(_POW10, dtype=torch.float64, device=words.device)
    fvals = payload.contiguous().view(torch.float64)
    ivals = payload.to(torch.float64) / pow10[meta & 7]
    vals = torch.where(isf, fvals, ivals)
    ts_p = torch.where(valid, ts, _I64_MAX).contiguous()
    vals_p = torch.where(valid, vals, float("nan")).contiguous()
    return ts_p, vals_p, err | prec


def _bucket_sum(rates, bucket_ids, num_buckets: int):
    """(S, T) rates (NaN as 0) summed by le bucket -> (B, T) float64.
    Up to 64 buckets an unrolled masked sum (no scatter).  Above that
    each rate adds into its flat lane ``bucket * T + t`` through kernel
    #3 (``segment_ingest_into``), which adds a lane's points in arrival
    order (series order here): the same bits on every run, equal to the
    CPU's ``index_add_``.  Every lane takes S/B adds, so the kernel runs
    its collided-lane pass."""
    r0 = torch.nan_to_num(rates)
    bidc = bucket_ids.clamp(0, num_buckets - 1)
    if num_buckets <= 64:
        return torch.stack([
            torch.where((bidc == b)[:, None], r0, 0.0).sum(dim=0)
            for b in range(num_buckets)])
    S, T = r0.shape
    dev = rates.device
    lanes = (bidc.to(torch.int64)[:, None] * T
             + torch.arange(T, dtype=torch.int64, device=dev)[None, :])
    part = torch.zeros(num_buckets * T, dtype=torch.float64, device=dev)
    cnt = torch.zeros(num_buckets * T, dtype=torch.int32, device=dev)
    segment_ingest.segment_ingest_into(part, cnt, None, lanes.reshape(-1),
                                       r0.contiguous().reshape(-1))
    return part.view(num_buckets, T)


def _hq_one(total, ubs, q):
    """histogram_quantile of one (B, T) cumulative bucket matrix."""
    B = total.shape[0]
    dev = total.device
    return device_fns._histogram_quantile_kernel(
        total, torch.arange(B, device=dev)[None, :],
        torch.tensor([B], device=dev), ubs[None, :], q)[0]


def decode_rate_hq(words, nbits, bucket_ids, step_times, ubs, range_nanos: int,
                   q: float, max_points: int, num_buckets: int, device=None):
    """histogram_quantile(q, sum by (le) (rate(bucket[range]))) from
    packed streams on one device: words (S, W) int64, nbits (S,),
    bucket_ids (S,) le-bucket index per series, step_times (T,) int64,
    ubs (B,) ascending upper bounds with +Inf last.  Host arrays or
    tensors; ``device=None`` means CUDA.  Returns (rates (S, T),
    hq (T,), errs (S,)) on the device."""
    dev = resolve_device(device)

    def on_dev(x, dtype):
        if isinstance(x, np.ndarray) and x.dtype == np.uint64:
            x = x.view(np.int64)  # the codec's int64 carriers of u64 words
        return torch.as_tensor(x, dtype=dtype).to(dev)

    ts_p, vals_p, errs = decode_to_step_series(
        on_dev(words, torch.int64), on_dev(nbits, torch.int64), max_points)
    rates = temporal.rate_family(ts_p, vals_p, on_dev(step_times, torch.int64),
                                 range_nanos, "rate")
    total = _bucket_sum(rates, on_dev(bucket_ids, torch.int64), num_buckets)
    hq = _hq_one(total, on_dev(ubs, torch.float64), q)
    return rates, hq, errs

