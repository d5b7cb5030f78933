"""The storage -> query pipeline over a device mesh: M3TSZ bytes to
quantiles.  The counterpart of ``m3_tpu/parallel/sharded_query.py``.

``sharded_decode_rate_hq`` evaluates ``histogram_quantile(q, sum by
(le) (rate(bucket[R])))`` over (shard x series) streams laid out on a
mesh (``parallel/mesh.py``).  Each shard's devices run the per-shard
program on their own streams:

  1. the batched decode (``encoding/m3tsz_torch._decode_batch_device``,
     whose field extraction is kernel #2 on a card);
  2. ``rate`` over the decoded (series x step) matrix;
  3. the partial by-bucket sum (kernel #3 above 64 buckets);

then one ``psum`` over the shard axis combines the partial bucket
matrices and the histogram-quantile program runs on every device.
``single_device_reference`` is the same pipeline on one device over the
flattened series axis, the equality oracle of the sharded form, and
``decode_rate_hq`` the one-device form with no collective.
"""

from __future__ import annotations

import numpy as np
import torch

from m3_tpu_torch import resolve_device
from m3_tpu_torch.encoding import m3tsz_torch as codec
from m3_tpu_torch.parallel import mesh, segment_ingest
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
    ts, payload, meta, err, prec, _ann = codec._decode_batch_device(
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
    """(S, T) rates (NaN as 0) summed by le bucket -> (B, T) float64,
    in an order fixed by S alone, so the card and the CPU give the same
    bits.  Up to 64 buckets an unrolled masked sum (no scatter): each
    bucket's masked rates, zero-padded to a power of two of rows, fold
    in half until one row is left (``_pairwise_rows``; ``sum`` would add
    in a tree whose order differs between the devices).  Above that each
    rate adds into its flat lane ``bucket * T + t`` through kernel #3
    (``segment_ingest_into``), which adds a lane's points in arrival
    order (series order here): the same bits on every run, equal to the
    CPU's ``index_add_``.  Every lane takes S/B adds, so the kernel runs
    its collided-lane pass."""
    r0 = torch.nan_to_num(rates)
    bidc = bucket_ids.clamp(0, num_buckets - 1)
    if num_buckets <= 64:
        S, T = r0.shape
        buf = r0.new_zeros((1 << max(S - 1, 0).bit_length(), T))
        out, zero = r0.new_empty((num_buckets, T)), r0.new_zeros(())
        for b in range(num_buckets):
            torch.where((bidc == b)[:, None], r0, zero, out=buf[:S])
            out[b] = _pairwise_rows(buf)
        return out
    S, T = r0.shape
    dev = rates.device
    lanes = (bidc.to(torch.int64)[:, None] * T
             + torch.arange(T, dtype=torch.int64, device=dev)[None, :])
    part = torch.zeros(num_buckets * T, dtype=torch.float64, device=dev)
    cnt = torch.zeros(num_buckets * T, dtype=torch.int32, device=dev)
    segment_ingest.segment_ingest_into(part, cnt, None, lanes.reshape(-1),
                                       r0.contiguous().reshape(-1))
    return part.view(num_buckets, T)


def _pairwise_rows(buf):
    """Row 0 of a (2^k, T) buffer after k halving folds (``buf[:h] +=
    buf[h:2h]``): its column sums, added in the same order on every
    device.  Rows below 2^(k-1) are overwritten."""
    h = buf.shape[0]
    while h > 1:
        h //= 2
        buf[:h] += buf[h:2 * h]
    return buf[0]


def _hq_one(total, ubs, q):
    """histogram_quantile of one (B, T) cumulative bucket matrix."""
    B = total.shape[0]
    dev = total.device
    return device_fns._histogram_quantile_kernel(
        total, torch.arange(B, dtype=torch.int64, device=dev)[None, :],
        torch.tensor([B], dtype=torch.int64, device=dev), ubs[None, :], q)[0]


def _tensor(x, dtype):
    """A host array or tensor as a tensor of ``dtype`` (u64 words as the
    codec's int64 carriers), where it lies."""
    if isinstance(x, np.ndarray) and x.dtype == np.uint64:
        x = x.view(np.int64)
    return torch.as_tensor(x, dtype=dtype)


def _rates(words, nbits, step_times, range_nanos: int, max_points: int):
    """Decode, then ``rate``: ((S, T) rates, (S,) errs) where the words lie."""
    ts_p, vals_p, errs = decode_to_step_series(words, nbits, max_points)
    return temporal.rate_family(ts_p, vals_p, step_times, range_nanos, "rate"), errs


def decode_rate_hq(words, nbits, bucket_ids, step_times, ubs, range_nanos: int,
                   q: float, max_points: int, num_buckets: int, device=None):
    """histogram_quantile(q, sum by (le) (rate(bucket[range]))) from
    packed streams on one device: words (S, W) int64, nbits (S,),
    bucket_ids (S,) le-bucket index per series, step_times (T,) int64,
    ubs (B,) ascending upper bounds with +Inf last.  Host arrays or
    tensors; ``device=None`` means CUDA.  Returns (rates (S, T),
    hq (T,), errs (S,)) on the device."""
    dev = resolve_device(device)
    on_dev = lambda x, dtype: _tensor(x, dtype).to(dev)
    rates, errs = _rates(on_dev(words, torch.int64), on_dev(nbits, torch.int64),
                         on_dev(step_times, torch.int64), range_nanos, max_points)
    total = _bucket_sum(rates, on_dev(bucket_ids, torch.int64), num_buckets)
    hq = _hq_one(total, on_dev(ubs, torch.float64), q)
    return rates, hq, errs


def sharded_decode_rate_hq(topo: mesh.MeshTopology, words, nbits, bucket_ids, step_times,
                           ubs, range_nanos: int, q: float, max_points: int,
                           num_buckets: int):
    """histogram_quantile(q, sum by (le) (rate(bucket[range]))) over the
    mesh: words (D, S, W) u64 streams (int64 carriers or a numpy uint64
    array), nbits (D, S), bucket_ids (D, S) le-bucket index per series,
    step_times (T,), ubs (B,) ascending upper bounds with +Inf last; host
    arrays or tensors, shard d's going to shard d's devices.  Every
    (shard, replica) device runs its shard's program on its own copy;
    the bucket sums meet in one ``psum`` over the shard axis (added in
    shard order).  Returns (rates (D, S, T), hq (T,), errs (D, S)) on the
    mesh's first device (replica 0 of each shard)."""
    blocks = (mesh.split(topo, _tensor(words, torch.int64)),
              mesh.split(topo, _tensor(nbits, torch.int64)),
              mesh.split(topo, _tensor(bucket_ids, torch.int64)),
              mesh.replicate(topo, _tensor(step_times, torch.int64)),
              mesh.replicate(topo, _tensor(ubs, torch.float64)))

    def local(w, nb, bid, st):
        rates, errs = _rates(w, nb, st, range_nanos, max_points)
        return rates, errs, _bucket_sum(rates, bid, num_buckets)

    rates, errs, part = mesh.unzip(mesh.run(topo, local, *blocks[:4]))
    total = mesh.psum(topo, part, mesh.SHARD_AXIS)
    hq = mesh.run(topo, lambda t, u: _hq_one(t, u, q), total, blocks[4])
    return mesh.stack(topo, rates), hq[0][0], mesh.stack(topo, errs)


def single_device_reference(words, nbits, bucket_ids, step_times, ubs, range_nanos: int,
                            q: float, max_points: int, num_buckets: int, device=None):
    """The same pipeline on one device (None = CUDA) over the flattened
    series axis, the bucket sum added on the host in series order, as the
    reference's oracle adds it: the equality oracle of
    :func:`sharded_decode_rate_hq`.  Returns numpy (rates (D, S, T),
    hq (T,), errs (D, S))."""
    dev = resolve_device(device)
    D, S = np.shape(nbits)
    on_dev = lambda x, dtype: _tensor(x, dtype).to(dev)
    rates, errs = _rates(on_dev(words, torch.int64).reshape(D * S, -1),
                         on_dev(nbits, torch.int64).reshape(D * S),
                         on_dev(step_times, torch.int64), range_nanos, max_points)
    # the oracle adds the bucket sum on the host in series order, and
    # returns numpy: its reads are its contract
    r = np.nan_to_num(rates.cpu().numpy())  # m3lint: disable=transfer-hygiene
    total = np.zeros((num_buckets, r.shape[1]), dtype=np.float64)
    bid = np.clip(_tensor(bucket_ids, torch.int64).cpu().numpy().reshape(D * S), 0,  # m3lint: disable=transfer-hygiene
                  num_buckets - 1)
    np.add.at(total, bid, r)
    hq = _hq_one(torch.from_numpy(total).to(dev), on_dev(ubs, torch.float64), q)
    return (rates.cpu().numpy().reshape(D, S, -1), hq.cpu().numpy(),  # m3lint: disable=transfer-hygiene
            errs.cpu().numpy().reshape(D, S))  # m3lint: disable=transfer-hygiene

