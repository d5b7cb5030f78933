"""The aggregator's segmented ingest reductions: the counterpart of
``m3_tpu/parallel/pallas_ingest.py`` and of the arena's scatters into
its state.

Two hand-written CUDA kernels replace the two Pallas kernels there, and
accumulate in place into the columns they are given:

* ``csrc/segment_ingest.cu`` replaces ``_ingest_kernel``: per-lane sum,
  count and, when a third column is given, sum of squares, added into
  the stored values in arrival order (deterministic, equal bit for bit
  to the plain version and to the reference's scatter);
* ``csrc/segment_minmax.cu`` replaces ``_minmax_kernel``: per-lane min
  and max folded into the stored values.

``segment_ingest_into`` and ``segment_minmax_into`` are the wrappers the
arena calls: a CPU tensor takes the plain PyTorch version, a CUDA tensor
launches the kernel or raises.  Lanes outside [0, len) drop, negative
ones included; the index may be int32 or int64.  The fresh-output
functions keep the JAX package's names and contract
(``segment_ingest``, ``segment_minmax``, ``pallas_segment_*``,
``*_chunked``, ``xla_segment_ingest``): int32 slots, outputs made per
call; on the card they run the same kernels into freshly zeroed or
filled outputs.  ``MAX_BATCH`` bounds only the single-batch
``pallas_*`` functions, whose contract it is.
"""

from __future__ import annotations

import ctypes

import torch

from m3_tpu_torch.parallel import _cuda
from m3_tpu_torch.x import devseams

INGEST_KERNEL = "segment_ingest"
MINMAX_KERNEL = "segment_minmax"
KERNELS = (INGEST_KERNEL, MINMAX_KERNEL)
MAX_BATCH = 1 << 18  # the single-batch functions' limit, as in the JAX package

# grids launched since the last reset (the wrappers' counts)
launches = {INGEST_KERNEL: 0, MINMAX_KERNEL: 0}

_DTYPE_CODE = {torch.int32: 0, torch.int64: 1, torch.float32: 2, torch.float64: 3}


def _check(name, slots, values, capacity):
    if slots.dtype != torch.int32:
        raise TypeError(f"{name} wants int32 slots, got {slots.dtype}")
    if slots.dim() != 1 or values.dim() != 1 or slots.shape != values.shape:
        raise ValueError(f"{name} wants matching 1-D slots and values, got "
                         f"{tuple(slots.shape)} and {tuple(values.shape)}")
    if slots.device != values.device:
        raise ValueError(f"{name}: slots and values on different devices")
    if capacity < 1:
        raise ValueError(f"{name}: capacity={capacity} < 1")


def _identities(dtype):
    """(min identity, max identity) of a value dtype."""
    if dtype.is_floating_point:
        return float("inf"), float("-inf")
    info = torch.iinfo(dtype)
    return info.max, info.min


def _drop_index(slots, capacity: int):
    """int64 scatter index with every slot outside [0, capacity) sent to
    the sentinel ``capacity`` (the last entry of a (capacity + 1,) buffer)."""
    return torch.where((slots < 0) | (slots >= capacity), capacity, slots).long()


def xla_segment_ingest(slots, values, capacity: int):
    """The scatter oracle (``pallas_ingest.xla_segment_ingest``): sum and
    int32 count by ``index_add_`` into (C + 1,) buffers whose last entry
    is the drop sentinel."""
    idx = _drop_index(slots, capacity)
    s = torch.zeros(capacity + 1, dtype=values.dtype, device=values.device)
    c = torch.zeros(capacity + 1, dtype=torch.int32, device=values.device)
    s.index_add_(0, idx, values)
    c.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return s[:capacity], c[:capacity]


def segment_ingest_plain(slots, values, capacity: int, with_sq: bool = False):
    """Plain PyTorch version of the ``segment_ingest`` kernel: the scatter
    oracle, plus the same scatter of v*v for the moments form."""
    s, c = xla_segment_ingest(slots, values, capacity)
    if not with_sq:
        return s, c
    return s, c, xla_segment_ingest(slots, values * values, capacity)[0]


_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


def _total_order_key(v):
    """float64 -> int64 key in IEEE total order (-0 < +0); the map is its
    own inverse on int64 keys viewed back as float64."""
    b = v.view(torch.int64)
    return b ^ ((b >> 63) & 0x7FFFFFFFFFFFFFFF)


def _from_key(k, dtype):
    f = _total_order_key(k).view(torch.float64)
    return torch.where(torch.isnan(f), float("nan"), f).to(dtype)


def _keys(v, nan_key: int):
    """Floats as total-order int64 keys, every NaN as ``nan_key``."""
    return torch.where(torch.isnan(v), nan_key, _total_order_key(v.double()))


def segment_minmax_plain(slots, values, capacity: int):
    """Plain PyTorch version of the ``segment_minmax`` kernel: the
    identities folded with ``segment_minmax_into_plain`` (so floats
    order -0 < +0, as the kernel and the reference do, and a NaN makes
    its slot NaN in both outputs)."""
    lo_id, hi_id = _identities(values.dtype)
    mn = torch.full((capacity,), lo_id, dtype=values.dtype, device=values.device)
    mx = torch.full((capacity,), hi_id, dtype=values.dtype, device=values.device)
    segment_minmax_into_plain(mn, mx, slots, values)
    return mn, mx


def segment_ingest_into_plain(sum_col, cnt_col, sq_col, idx, values):
    """Plain PyTorch version of the ``segment_ingest`` kernel, in place:
    ``index_add_`` of ``values`` (and ``values * values``) into
    ``sum_col`` (and ``sq_col``), and of 1 into ``cnt_col``, over the
    points whose ``idx`` lies in [0, len).  Points outside add the
    neutral element (-0.0 for floats: ``x + -0.0 == x`` for every x,
    signed zeros and NaN included; 0 for integers) to lane 0, so no mask
    selects and the call holds no host synchronisation.  On the CPU,
    ``index_add_`` adds each lane's points in arrival order, as the
    reference's scatter does; on a card its float adds are atomics in no
    fixed order."""
    ok = (idx >= 0) & (idx < sum_col.shape[0])
    i = torch.where(ok, idx, 0).long()
    neutral = -0.0 if values.dtype.is_floating_point else 0
    sum_col.index_add_(0, i, torch.where(ok, values, neutral))
    cnt_col.index_add_(0, i, ok.to(cnt_col.dtype))
    if sq_col is not None:
        sq_col.index_add_(0, i, torch.where(ok, values * values, neutral))


def segment_minmax_into_plain(mn_col, mx_col, idx, values):
    """Plain PyTorch version of the ``segment_minmax`` kernel, in place:
    the drop-mode ``.at[idx].min`` / ``.at[idx].max`` of the reference
    into ``mn_col`` / ``mx_col``, in the kernel's order (IEEE total order
    for floats, NaN sticky on either side)."""
    ok = (idx >= 0) & (idx < mn_col.shape[0])
    i = torch.where(ok, idx, 0).long()
    if not values.dtype.is_floating_point:
        lo_id, hi_id = _identities(values.dtype)
        mn_col.scatter_reduce_(0, i, torch.where(ok, values, lo_id), "amin")
        mx_col.scatter_reduce_(0, i, torch.where(ok, values, hi_id), "amax")
        return
    kmn, kmx = _keys(mn_col, _I64_MIN), _keys(mx_col, _I64_MAX)
    kmn.scatter_reduce_(0, i, torch.where(ok, _keys(values, _I64_MIN), _I64_MAX), "amin")
    kmx.scatter_reduce_(0, i, torch.where(ok, _keys(values, _I64_MAX), _I64_MIN), "amax")
    mn_col.copy_(_from_key(kmn, mn_col.dtype))
    mx_col.copy_(_from_key(kmx, mx_col.dtype))


def _lib(name):
    lib = _cuda.load(name)
    fn = getattr(lib, f"m3_{name}_into")
    if fn.argtypes is None:
        if name == INGEST_KERNEL:
            fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int64] * 2
                           + [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
        else:
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2
                           + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check_into(name, cols, idx, values):
    """The into-forms' argument checks; returns the columns' length."""
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name} wants an int32 or int64 index, got {idx.dtype}")
    if idx.dim() != 1 or values.dim() != 1 or idx.shape != values.shape:
        raise ValueError(f"{name} wants matching 1-D index and values, got "
                         f"{tuple(idx.shape)} and {tuple(values.shape)}")
    n_out = cols[0].shape[0]
    for c in cols:
        if c.dim() != 1 or c.shape[0] != n_out:
            raise ValueError(f"{name}: the columns must be 1-D of one length")
        if c.device != values.device or idx.device != values.device:
            raise ValueError(f"{name}: columns, index and values on different devices")
    if values.device.type == "cuda":
        if values.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name}: no kernel for {values.dtype} values "
                            "(int32, int64, float32, float64)")
        if not all(t.is_contiguous() for t in (*cols, idx, values)):
            raise ValueError(f"{name}: columns, index and values must be contiguous")
        if idx.shape[0] >= 1 << 31 or n_out >= 1 << 32:
            raise ValueError(f"{name}: the kernel takes < 2^31 points and < 2^32 lanes")
    elif values.device.type != "cpu":
        raise ValueError(f"{name}: no kernel for device {values.device}")
    return n_out


# the ingest kernel's scratch per (device, stream): hits (lanes), ctrl
# (8), tiles (points / 256) and order (points), int32, grown to the
# largest call seen.  hits and ctrl are zero between launches (the kernel
# leaves them so).  A buffer that is outgrown stays referenced, so that a
# CUDA graph captured with it stays valid; sizes grow by powers of two.
_scratch: dict = {}


def _ingest_scratch(dev, stream, n_out: int, n: int):
    key = (dev.index, stream.cuda_stream)
    bufs = _scratch.setdefault(key, {"retired": []})
    want = {"hits": n_out, "ctrl": 8, "tiles": -(-n // 256), "order": n}
    for name, size in want.items():
        cur = bufs.get(name)
        if cur is not None and cur.shape[0] >= size:
            continue
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "segment_ingest_into: the kernel's scratch for this stream and size is "
                "made on an eager call; make one call of this size on the capturing "
                "stream before capturing a CUDA graph")
        if cur is not None:
            bufs["retired"].append(cur)
        bufs[name] = torch.zeros(1 << max(size - 1, 0).bit_length(), dtype=torch.int32,
                                 device=dev)
    return bufs["hits"], bufs["ctrl"], bufs["tiles"], bufs["order"]


def segment_ingest_into(sum_col, cnt_col, sq_col, idx, values):
    """Add each point of ``values`` into ``sum_col[idx]``, 1 into
    ``cnt_col[idx]`` and, unless ``sq_col`` is None, ``values * values``
    into ``sq_col[idx]``, in place; ``idx`` outside [0, len) drops.
    Each lane's points are added in arrival order, so the result is the
    same on every run and equal bit for bit to the reference's scatter.
    ``cnt_col`` is int32 or int64; integer lanes wrap.  CPU tensors: the
    plain version; CUDA tensors: the kernel, five grids a call (three of
    them exit at once unless two points share a lane), each counted in
    ``launches``."""
    cols = [c for c in (sum_col, cnt_col, sq_col) if c is not None]
    n_out = _check_into("segment_ingest_into", cols, idx, values)
    for c in (sum_col, sq_col):
        if c is not None and c.dtype != values.dtype:
            raise TypeError(f"segment_ingest_into: {c.dtype} column for {values.dtype} values")
    if cnt_col.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"segment_ingest_into: count column {cnt_col.dtype}, "
                        "want int32 or int64")
    if values.device.type == "cpu":
        segment_ingest_into_plain(sum_col, cnt_col, sq_col, idx, values)
        return
    n = values.shape[0]
    if not n:
        return
    stream = torch.cuda.current_stream(values.device)
    hits, ctrl, tiles, order = _ingest_scratch(values.device, stream, n_out, n)
    lib = _lib(INGEST_KERNEL)
    grids = ctypes.c_int(0)
    with torch.cuda.device(values.device):  # the runtime launches on the current device
        rc = lib.m3_segment_ingest_into(
            idx.data_ptr(), values.data_ptr(), sum_col.data_ptr(), cnt_col.data_ptr(),
            sq_col.data_ptr() if sq_col is not None else None, hits.data_ptr(),
            ctrl.data_ptr(), tiles.data_ptr(), order.data_ptr(), n, n_out,
            _DTYPE_CODE[values.dtype], int(idx.dtype == torch.int64),
            int(cnt_col.dtype == torch.int64), stream.cuda_stream, ctypes.byref(grids))
    _cuda.check(lib, rc, "segment_ingest_into")
    launches[INGEST_KERNEL] += grids.value
    devseams.launched(INGEST_KERNEL, grids.value)


def segment_minmax_into(mn_col, mx_col, idx, values):
    """Fold each point of ``values`` into ``mn_col[idx]`` and
    ``mx_col[idx]`` in place, in IEEE total order for floats (-0 < +0)
    with NaN sticky; ``idx`` outside [0, len) drops.  A NaN stored in a
    float column must carry its side's sign (see ``segment_minmax.cu``).
    CPU tensors: the plain version; CUDA tensors: the kernel."""
    _check_into("segment_minmax_into", [mn_col, mx_col], idx, values)
    if mn_col.dtype != values.dtype or mx_col.dtype != values.dtype:
        raise TypeError("segment_minmax_into: the columns must have the values' dtype")
    if values.device.type == "cpu":
        segment_minmax_into_plain(mn_col, mx_col, idx, values)
        return
    n = values.shape[0]
    if not n:
        return
    lib = _lib(MINMAX_KERNEL)
    with torch.cuda.device(values.device):  # the runtime launches on the current device
        rc = lib.m3_segment_minmax_into(
            idx.data_ptr(), values.data_ptr(), mn_col.data_ptr(), mx_col.data_ptr(), n,
            mn_col.shape[0], _DTYPE_CODE[values.dtype], int(idx.dtype == torch.int64),
            torch.cuda.current_stream(values.device).cuda_stream)
    _cuda.check(lib, rc, "segment_minmax_into")
    launches[MINMAX_KERNEL] += 1
    devseams.launched(MINMAX_KERNEL, 1)


def segment_ingest(slots, values, capacity: int, with_sq: bool = False):
    """(capacity,) sum, int32 count and, with ``with_sq``, sum of squares
    of ``values`` grouped by int32 ``slots``; any batch size.  CPU
    tensors: the plain version; CUDA tensors: the kernel into fresh
    zeroed outputs."""
    _check("segment_ingest", slots, values, capacity)
    if values.device.type == "cpu":
        return segment_ingest_plain(slots, values, capacity, with_sq)
    s = torch.zeros(capacity, dtype=values.dtype, device=values.device)
    c = torch.zeros(capacity, dtype=torch.int32, device=values.device)
    sq = torch.zeros_like(s) if with_sq else None
    segment_ingest_into(s, c, sq, slots, values)
    return (s, c, sq) if with_sq else (s, c)


def segment_minmax(slots, values, capacity: int):
    """(capacity,) per-slot (min, max) of ``values`` grouped by int32
    ``slots``; empty slots hold the identities; any batch size.  CPU
    tensors: the plain version; CUDA tensors: the kernel into fresh
    outputs filled with the identities."""
    _check("segment_minmax", slots, values, capacity)
    if values.device.type == "cpu":
        return segment_minmax_plain(slots, values, capacity)
    lo_id, hi_id = _identities(values.dtype)
    mn = torch.full((capacity,), lo_id, dtype=values.dtype, device=values.device)
    mx = torch.full((capacity,), hi_id, dtype=values.dtype, device=values.device)
    segment_minmax_into(mn, mx, slots, values)
    return mn, mx


def _single_batch(slots, name):
    n = slots.shape[0]
    if n > MAX_BATCH:
        raise ValueError(
            f"batch of {n} exceeds MAX_BATCH={MAX_BATCH}: chunk the batch "
            f"({name})")


def pallas_segment_ingest(slots, values, capacity: int):
    """Sum + int32 count of ``values`` by ``slots`` into (capacity,)
    accumulators in one launch; at most ``MAX_BATCH`` points."""
    _single_batch(slots, "segment_ingest_chunked / segment_moments_chunked")
    return segment_ingest(slots, values, capacity)


def pallas_segment_moments(slots, values, capacity: int):
    """(sum, count, sum of squares) in one launch; at most ``MAX_BATCH``
    points."""
    _single_batch(slots, "segment_ingest_chunked / segment_moments_chunked")
    return segment_ingest(slots, values, capacity, with_sq=True)


def pallas_segment_minmax(slots, values, capacity: int):
    """Per-slot (min, max) in one launch; at most ``MAX_BATCH`` points."""
    _single_batch(slots, "segment_minmax_chunked")
    return segment_minmax(slots, values, capacity)


def _chunks(n: int):
    return range(0, max(n, 1), MAX_BATCH)


def segment_ingest_chunked(slots, values, capacity: int):
    """``pallas_segment_ingest`` over any batch: ``MAX_BATCH`` chunks,
    sums and counts added chunk by chunk, as in the JAX package."""
    s = c = None
    for lo in _chunks(values.shape[0]):
        s1, c1 = pallas_segment_ingest(slots[lo:lo + MAX_BATCH],
                                       values[lo:lo + MAX_BATCH], capacity)
        s = s1 if s is None else s + s1
        c = c1 if c is None else c + c1
    return s, c


def segment_moments_chunked(slots, values, capacity: int):
    """``pallas_segment_moments`` over any batch."""
    s = c = sq = None
    for lo in _chunks(values.shape[0]):
        s1, c1, q1 = pallas_segment_moments(slots[lo:lo + MAX_BATCH],
                                            values[lo:lo + MAX_BATCH], capacity)
        s = s1 if s is None else s + s1
        c = c1 if c is None else c + c1
        sq = q1 if sq is None else sq + q1
    return s, c, sq


def segment_minmax_chunked(slots, values, capacity: int):
    """``pallas_segment_minmax`` over any batch: one ``segment_minmax``
    call, which takes any batch (folding chunk by chunk, as the JAX
    package does, gives the same result in the kernel's order)."""
    return segment_minmax(slots, values, capacity)
