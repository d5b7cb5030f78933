"""Process-level device-memory budget: admission, not autopsy.  The
port's counterpart of ``m3_tpu/x/membudget.py``.

Every long-lived device structure — the aggregation arenas, the series
buffer ring, the decode control table — and the big transient stage
buffers (encoder and decoder lane tables) REGISTER a byte reservation
before any tensor is allocated.  Over budget raises the typed
:class:`DeviceBudgetExceeded` (a :class:`~m3_tpu_torch.x.devguard.DeviceOOM`,
so the device guard classifies and counts it) and bumps the rejected
counter — reject-and-count, before the card is asked.

The budget is accounting on the host: it tracks the bytes THIS process
asked for through the seam, not everything the caching allocator holds
(kernel scratch, library workspaces and the allocator's cached free
blocks are outside it).  The footprint formulas below are the port's
tensors, each rounded up to the CUDA caching allocator's 512-byte block,
so a resident structure's reservation is what ``memory_allocated()``
grows by when the structure is built on a card whose allocator splits
every block to the request (``expandable_segments``).  The gauges
(``device_mem_budget_bytes`` / ``device_mem_used_bytes`` /
``device_mem_rejected_total`` on /metrics) make the high-water mark
visible.

Configuration: the node config's ``device.mem_budget``, applied by
run_node through :func:`set_budget` before any reservation is taken
(the reference's ``M3_DEVICE_MEM_BUDGET`` environment seam has no
counterpart).  "0" means unlimited.

Reservations release on ``release()``/context-manager exit, or
automatically when their ``owner`` object is garbage-collected (a
``weakref.finalize``) — arena and buffer objects have no close() and
must not leak ledger bytes when an engine drops them.
"""

from __future__ import annotations

import re
import threading
import weakref
from typing import Dict

from m3_tpu_torch.x.devguard import DeviceOOM

__all__ = [
    "DeviceBudgetExceeded", "Reservation", "budget", "used", "parse_bytes",
    "reserve", "transient", "set_budget", "snapshot", "counters",
    "reset", "arena_bytes", "buffer_bytes", "counter_arena_bytes",
    "gauge_arena_bytes", "timer_arena_bytes", "encode_lane_bytes",
    "decode_lane_bytes", "encode_lane_parts", "decode_lane_parts", "block_bytes",
]


class DeviceBudgetExceeded(DeviceOOM):
    """Typed admission reject: the reservation would exceed the device
    memory budget.  A DeviceOOM subclass so the devguard classifier and
    breakers treat it as the OOM it prevents."""

    kind = "budget"

    def __init__(self, component: str, nbytes: int, budget: int, used: int):
        super().__init__(
            component,
            f"reserving {nbytes} bytes would exceed the device memory "
            f"budget ({used} of {budget} in use) — raise "
            "device.mem_budget or shrink the arena/buffer geometry")
        self.component = component
        self.nbytes = nbytes
        self.budget = budget
        self.used = used


_SIZE_RE = re.compile(r"^(\d+(?:\.\d+)?)\s*([KMGT]i?)?B?$", re.IGNORECASE)
_SIZE_MULT = {None: 1, "K": 1 << 10, "M": 1 << 20, "G": 1 << 30,
              "T": 1 << 40}


def parse_bytes(v) -> int:
    """"512M" / "2GiB" / 1048576 → bytes (binary units; 0 = unlimited)."""
    if isinstance(v, (int, float)):
        return int(v)
    m = _SIZE_RE.match(str(v).strip())
    if not m:
        raise ValueError(
            f"bad byte size {v!r} (want e.g. '512M', '2GiB', or bytes)")
    suffix = m.group(2)
    mult = _SIZE_MULT[suffix[0].upper() if suffix else None]
    return int(float(m.group(1)) * mult)


_lock = threading.Lock()
_budget = 0
_used = 0
_peak = 0
_rejected = 0
_by_component: Dict[str, int] = {}


def set_budget(nbytes) -> None:
    """Set the process budget (bytes or suffixed string; 0 disables
    admission).  Existing reservations stay — shrinking below current
    use only affects NEW reservations."""
    global _budget
    _budget = parse_bytes(nbytes)


def budget() -> int:
    return _budget


def used() -> int:
    with _lock:
        return _used


def counters() -> Dict[str, int]:
    with _lock:
        return {"membudget.used_bytes": _used,
                "membudget.peak_bytes": _peak,
                "membudget.rejected_total": _rejected}


def snapshot() -> dict:
    """The /health view: budget/used/peak/rejected + per-component
    bytes currently reserved."""
    with _lock:
        return {
            "budget_bytes": _budget,
            "used_bytes": _used,
            "peak_bytes": _peak,
            "rejected_total": _rejected,
            "components": dict(_by_component),
        }


def reset() -> None:
    """Test hygiene: zero the ledger (live Reservations become no-ops
    for the bytes they release — only use between isolated tests)."""
    global _used, _peak, _rejected
    with _lock:
        _used = 0
        _peak = 0
        _rejected = 0
        _by_component.clear()


class Reservation:
    """One admitted byte reservation; release is idempotent."""

    def __init__(self, component: str, nbytes: int):
        self.component = component
        self.nbytes = int(nbytes)
        self._released = False
        self._finalizer = None

    def resize(self, nbytes: int) -> None:
        """Grow/shrink in place (the ``_grow`` paths): the DELTA is
        admitted against the budget; an over-budget grow raises typed
        and leaves the reservation unchanged."""
        nbytes = int(nbytes)
        delta = nbytes - self.nbytes
        if self._released or delta == 0:
            return
        _admit(self.component, delta)
        self.nbytes = nbytes

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        if self._finalizer is not None:
            self._finalizer.detach()
            self._finalizer = None
        _admit(self.component, -self.nbytes, count_reject=False)

    def __enter__(self) -> "Reservation":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def _admit(component: str, delta: int, count_reject: bool = True) -> None:
    global _used, _peak, _rejected
    with _lock:
        if delta > 0 and _budget > 0 and _used + delta > _budget:
            if count_reject:
                _rejected += 1
            raise DeviceBudgetExceeded(component, delta, _budget, _used)
        _used += delta
        _peak = max(_peak, _used)
        _by_component[component] = _by_component.get(component, 0) + delta
        if _by_component[component] <= 0:
            del _by_component[component]


def reserve(component: str, nbytes: int, owner=None) -> Reservation:
    """Admit ``nbytes`` for ``component`` or raise
    :class:`DeviceBudgetExceeded` (counted).  With ``owner`` given the
    reservation auto-releases when the owner is collected."""
    _admit(component, int(nbytes))
    res = Reservation(component, nbytes)
    if owner is not None:
        res._finalizer = weakref.finalize(owner, _finalize_release, res)
    return res


def _finalize_release(res: Reservation) -> None:
    # module-level (not a bound method) so the finalizer holds no cycle
    res._finalizer = None
    res.release()


def transient(component: str, nbytes: int) -> Reservation:
    """Context-managed reservation for a stage's transient device
    buffers (encoder/decoder lane tables): admitted for the duration
    of the call, released on exit either way."""
    return reserve(component, nbytes)


# ---------------------------------------------------------------------------
# Footprint formulas.  Each mirrors its state NamedTuple field by field,
# every tensor at the caching allocator's block granularity; a layout
# change that alters a dtype or a lane set must update its formula
# (tests/test_torch_membudget.py holds each against the state tensors).
# Against the reference's formulas: no XLA tuple overhead (512 B a
# state there), and the packed counter's u32 minmax word is an int64
# here (28 B a slot, not 24).
# ---------------------------------------------------------------------------

_BLOCK = 512  # the CUDA caching allocator rounds every block up to this


def block_bytes(nbytes: int) -> int:
    """One tensor's ``numel * element_size`` as the caching allocator
    hands it out: rounded up to a 512-byte block (an empty tensor takes
    none)."""
    return -(-int(nbytes) // _BLOCK) * _BLOCK


def counter_arena_bytes(layout: str, num_windows: int, capacity: int,
                        pool_capacity: int | None = None) -> int:
    """packed: base, sq and minmax i64 + pool_idx i32 per slot (28 B),
    five i64 and one i32 lane per overflow-pool row (default
    P = max(64, W*C/16)), the two i32 scalars (pool_n, err); f64: five
    i64 lanes per slot (40 B).  Both carry the per-slot i64 last_at."""
    wc = num_windows * capacity
    last_at = block_bytes(8 * capacity)
    if layout == "packed":
        P = pool_capacity if pool_capacity is not None else max(64, wc // 16)
        return (3 * block_bytes(8 * wc) + block_bytes(4 * wc)
                + 5 * block_bytes(8 * P) + block_bytes(4 * P)
                + 2 * block_bytes(4) + last_at)
    return 5 * block_bytes(8 * wc) + last_at


def gauge_arena_bytes(layout: str, num_windows: int, capacity: int) -> int:
    """Seven f64/i64 lanes per slot (56 B) on both layouts + the
    per-slot last_at."""
    return (7 * block_bytes(8 * num_windows * capacity)
            + block_bytes(8 * capacity))


def timer_arena_bytes(layout: str, num_windows: int, capacity: int,
                      sample_capacity: int) -> int:
    """packed: one i64 word per buffered sample; f64: three 8-byte
    moment lanes per slot (24 B) + an i32 slot and an f64 value per
    buffered sample (12 B).  Plus the per-window i64 write heads and the
    per-slot last_at."""
    W, C, S = num_windows, capacity, sample_capacity
    heads = block_bytes(8 * W) + block_bytes(8 * C)
    if layout == "packed":
        return block_bytes(8 * W * S) + heads
    return (3 * block_bytes(8 * W * C) + block_bytes(4 * W * S)
            + block_bytes(8 * W * S) + heads)


def arena_bytes(layout: str, num_windows: int, capacity: int,
                sample_capacity: int) -> int:
    """Total device bytes of one (counter, gauge, timer) arena triple —
    the sum of the per-arena formulas above."""
    return (counter_arena_bytes(layout, num_windows, capacity)
            + gauge_arena_bytes(layout, num_windows, capacity)
            + timer_arena_bytes(layout, num_windows, capacity,
                                sample_capacity))


def buffer_bytes(num_windows: int, sample_capacity: int) -> int:
    """Series-buffer ring bytes: slot i32 + ts i64 + val f64 per
    (window, sample) plus the per-window i64 write heads."""
    ws = num_windows * sample_capacity
    return (block_bytes(4 * ws) + 2 * block_bytes(8 * ws)
            + block_bytes(8 * num_windows))


# Per-datapoint TEMP coefficients of the codec passes: the (T, 4, S)
# lane tables, offset prefix sums and (4T, S) fragment planes the encode
# keeps live at once, and the (P, S) lane tables and chain planes of the
# decode tails.  Each covers the pass's measured device peak
# (chip_smoke.py phase 22 prints the ratio) with headroom; phase 25 (a)
# holds all three to [1, 2] of the card's peak at the costwatch
# canonical shapes (the fused tail measured ~10 B/dp there, so its
# coefficient is the reference's 16, not 48, which over-admitted 2.4x).
_ENCODE_TEMP_PER_DP = 320
_DECODE_TEMP_PER_DP = {"gather": 240, "fused": 16}
_DECODE_PAD_WORDS = 16  # the decoder's zero pad after each stream


def encode_lane_parts(S: int, T: int, out_words: int) -> dict:
    """:func:`encode_lane_bytes` by part: the exact ``args`` (ts i64 +
    value bits i64 + valid bool + start i64) and ``out`` (words +
    total_bits + fallback), and the ``temp`` coefficient's bytes."""
    return {"args": 17 * S * T + 8 * S, "out": 8 * S * out_words + 9 * S,
            "temp": _ENCODE_TEMP_PER_DP * S * T}


def encode_lane_bytes(S: int, T: int, out_words: int) -> int:
    """Transient device bytes of one encode pass: the exact argument
    footprint, the exact output and the temp coefficient
    (:func:`encode_lane_parts`).  The reference's ``place=`` argument is
    dropped: the port has one placement (kernel #1)."""
    return sum(encode_lane_parts(S, T, out_words).values())


def decode_lane_parts(S: int, W: int, max_points: int,
                      chains: str = "gather") -> dict:
    """:func:`decode_lane_bytes` by part: the exact ``args`` (words +
    nbits) with their padded copy, the exact ``out`` (ts i64 + payload
    i64 + meta u8 per point, plus err/prec/ann) and the tail's ``temp``
    coefficient's bytes."""
    return {"args": 8 * S * W + 8 * S + 8 * S * (W + _DECODE_PAD_WORDS),
            "out": 17 * S * max_points + 24 * S,
            "temp": _DECODE_TEMP_PER_DP[chains] * S * max_points}


def decode_lane_bytes(S: int, W: int, max_points: int,
                      chains: str = "gather") -> int:
    """Transient device bytes of one decode pass through the ``chains``
    tail (``"gather"`` or ``"fused"``, the port's two tails; ``W`` =
    stream words per series): the parts of :func:`decode_lane_parts`.
    The control table is resident (``decode.ctrl_table``), not counted
    here; the reference's ``extract=`` argument is dropped (one
    extraction: kernel #2)."""
    return sum(decode_lane_parts(S, W, max_points, chains).values())
