"""The aggregator's segmented ingest reductions: the counterpart of
``m3_tpu/parallel/pallas_ingest.py``.

Two hand-written CUDA kernels replace the two Pallas kernels there:

* ``csrc/segment_ingest.cu`` replaces ``_ingest_kernel``: per-slot sum
  and int32 count of (slot, value) pairs and, in the moments form, the
  sum of squares;
* ``csrc/segment_minmax.cu`` replaces ``_minmax_kernel``: per-slot min
  and max, the identities (+-inf or the integer extremes) in empty slots.

Slots outside [0, capacity) drop, negative ones included.  The public
names keep the JAX package's (``pallas_segment_*``, ``*_chunked``,
``xla_segment_ingest``) so that each function's counterpart is easy to
find; here they launch the CUDA kernels.  ``segment_ingest`` and
``segment_minmax`` are the wrappers: a CPU tensor takes the plain
PyTorch version, a CUDA tensor launches the kernel or raises.  They take
any batch size (the kernels index in 64 bits); ``MAX_BATCH`` bounds only
the single-batch ``pallas_*`` functions, whose contract it is.

Float sums from the kernel depend on the order of its atomics where
points of one launch share a slot; integer lanes, counts, min and max do
not (see the note in each ``.cu``).
"""

from __future__ import annotations

import ctypes

import torch

from m3_tpu_torch.parallel import _cuda

INGEST_KERNEL = "segment_ingest"
MINMAX_KERNEL = "segment_minmax"
KERNELS = (INGEST_KERNEL, MINMAX_KERNEL)
MAX_BATCH = 1 << 18  # the single-batch functions' limit, as in the JAX package

# kernel launches since the last reset (the wrappers' counts)
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


_KEY_POS_INF = 0x7FF0000000000000        # _total_order_key(+inf)
_KEY_NEG_INF = -_KEY_POS_INF - 1          # _total_order_key(-inf)
_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


def _total_order_key(v):
    """float64 -> int64 key in IEEE total order (-0 < +0); the map is its
    own inverse on int64 keys viewed back as float64."""
    b = v.view(torch.int64)
    return b ^ ((b >> 63) & 0x7FFFFFFFFFFFFFFF)


def _from_key(k, dtype):
    f = _total_order_key(k).view(torch.float64)
    return torch.where(torch.isnan(f), float("nan"), f).to(dtype)


def segment_minmax_plain(slots, values, capacity: int):
    """Plain PyTorch version of the ``segment_minmax`` kernel:
    ``scatter_reduce_`` amin / amax into (C + 1,) buffers started at the
    identities, then ``[:C]``.  Floats reduce on total-order integer keys
    (so -0 < +0, as the kernel and the reference order them) with every
    NaN mapped to the extreme key of its side, which makes a NaN slot NaN
    in both outputs."""
    idx = _drop_index(slots, capacity)
    dev = values.device
    if not values.dtype.is_floating_point:
        lo_id, hi_id = _identities(values.dtype)
        mn = torch.full((capacity + 1,), lo_id, dtype=values.dtype, device=dev)
        mx = torch.full((capacity + 1,), hi_id, dtype=values.dtype, device=dev)
        mn.scatter_reduce_(0, idx, values, "amin", include_self=True)
        mx.scatter_reduce_(0, idx, values, "amax", include_self=True)
        return mn[:capacity], mx[:capacity]
    nan = torch.isnan(values)
    key = _total_order_key(values.double())
    mn = torch.full((capacity + 1,), _KEY_POS_INF, dtype=torch.int64, device=dev)
    mx = torch.full((capacity + 1,), _KEY_NEG_INF, dtype=torch.int64, device=dev)
    mn.scatter_reduce_(0, idx, torch.where(nan, _I64_MIN, key), "amin", include_self=True)
    mx.scatter_reduce_(0, idx, torch.where(nan, _I64_MAX, key), "amax", include_self=True)
    return (_from_key(mn[:capacity], values.dtype),
            _from_key(mx[:capacity], values.dtype))


def _pick(a, b, b_wins):
    if not a.dtype.is_floating_point:
        return torch.where(b_wins(b, a), b, a)
    ka, kb = _total_order_key(a.double()), _total_order_key(b.double())
    out = torch.where(b_wins(kb, ka), b, a)
    return torch.where(torch.isnan(a) | torch.isnan(b), float("nan"), out)


def minimum(a, b):
    """Elementwise min in the kernel's order: IEEE total order for floats
    (-0 < +0), NaN if either side is NaN.  ``torch.minimum`` leaves the
    sign of a zero tie to its argument order."""
    return _pick(a, b, torch.lt)


def maximum(a, b):
    """Elementwise max in the kernel's order (see ``minimum``)."""
    return _pick(a, b, torch.gt)


def _kernel_args(name, slots, values):
    if values.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: no kernel for {values.dtype} values "
                        "(int32, int64, float32, float64)")
    if not (slots.is_contiguous() and values.is_contiguous()):
        raise ValueError(f"{name}: slots and values must be contiguous")
    return _DTYPE_CODE[values.dtype], torch.cuda.current_stream(values.device).cuda_stream


def _lib(name):
    lib = _cuda.load(name)
    fn = getattr(lib, f"m3_{name}")
    if fn.argtypes is None:
        n_ptrs = 5 if name == INGEST_KERNEL else 4
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs
                       + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def segment_ingest(slots, values, capacity: int, with_sq: bool = False):
    """(capacity,) sum, int32 count and, with ``with_sq``, sum of squares
    of ``values`` grouped by int32 ``slots``; any batch size.  CPU
    tensors: the plain version; CUDA tensors: the kernel."""
    _check("segment_ingest", slots, values, capacity)
    if values.device.type == "cpu":
        return segment_ingest_plain(slots, values, capacity, with_sq)
    if values.device.type != "cuda":
        raise ValueError(f"segment_ingest: no kernel for device {values.device}")
    code, stream = _kernel_args("segment_ingest", slots, values)
    s = torch.zeros(capacity, dtype=values.dtype, device=values.device)
    c = torch.zeros(capacity, dtype=torch.int32, device=values.device)
    sq = torch.zeros_like(s) if with_sq else None
    n = values.shape[0]
    if n:
        lib = _lib(INGEST_KERNEL)
        rc = lib.m3_segment_ingest(slots.data_ptr(), values.data_ptr(), s.data_ptr(),
                                   c.data_ptr(), sq.data_ptr() if with_sq else None,
                                   n, capacity, code, stream)
        _cuda.check(lib, rc, "segment_ingest")
        launches[INGEST_KERNEL] += 1
    return (s, c, sq) if with_sq else (s, c)


def segment_minmax(slots, values, capacity: int):
    """(capacity,) per-slot (min, max) of ``values`` grouped by int32
    ``slots``; empty slots hold the identities; any batch size.  CPU
    tensors: the plain version; CUDA tensors: the kernel."""
    _check("segment_minmax", slots, values, capacity)
    if values.device.type == "cpu":
        return segment_minmax_plain(slots, values, capacity)
    if values.device.type != "cuda":
        raise ValueError(f"segment_minmax: no kernel for device {values.device}")
    code, stream = _kernel_args("segment_minmax", slots, values)
    lo_id, hi_id = _identities(values.dtype)
    mn = torch.full((capacity,), lo_id, dtype=values.dtype, device=values.device)
    mx = torch.full((capacity,), hi_id, dtype=values.dtype, device=values.device)
    n = values.shape[0]
    if n:
        lib = _lib(MINMAX_KERNEL)
        rc = lib.m3_segment_minmax(slots.data_ptr(), values.data_ptr(), mn.data_ptr(),
                                   mx.data_ptr(), n, capacity, code, stream)
        _cuda.check(lib, rc, "segment_minmax")
        launches[MINMAX_KERNEL] += 1
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
    """``pallas_segment_minmax`` over any batch."""
    mn = mx = None
    for lo in _chunks(values.shape[0]):
        m1, x1 = pallas_segment_minmax(slots[lo:lo + MAX_BATCH],
                                       values[lo:lo + MAX_BATCH], capacity)
        mn = m1 if mn is None else minimum(mn, m1)
        mx = x1 if mx is None else maximum(mx, x1)
    return mn, mx
