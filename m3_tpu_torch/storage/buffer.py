"""Device series buffer: the in-memory mutable head of every series.  The
counterpart of ``m3_tpu/storage/buffer.py``.

Re-design of the reference's per-series `dbBuffer`
(`src/dbnode/storage/series/buffer.go:221-247` BufferBucketVersions per
block start; `Write` classifies warm/cold vs bufferPast/bufferFuture
`buffer.go:290-413`; `WarmFlush` merges bucket streams `buffer.go:634`).
Instead of an encoder object per (series, block), the whole shard buffers
into a ring of **append logs on the device** — one per open block window:

    slot (W, S) i32 | ts (W, S) i64 | val (W, S) f64 | n (W,) i64

Ingest is one scatter per batch into the ring's columns, in place.  A
drain sorts a window by (slot, ts, arrival descending) with stable sorts,
least significant key first, and keeps the first of each (slot, ts) run:
the *last arrival* wins, the reference's merge rule at flush.

Out-of-window writes (cold writes / too-late / too-future) never touch the
device: the host routes them to a per-block overflow list, flushed as a
higher fileset volume (the reference's cold flush,
`storage/coldflush.go` + `fs_merge_with_mem.go`).

The ring reserves its bytes with ``x.membudget`` before it allocates
(and its ``_grow`` resizes the reservation first); every append and
every drain runs behind ``x.devguard``'s ``storage.buffer_append`` and
``storage.buffer_drain`` stages.  Unlike the JAX package, a failed device
append or drain raises typed: there is no host staging or host drain to
fall back to.  The append runs before any sample of the batch is routed
anywhere, so a batch the card refuses leaves the buffer as it was, and
the caller does not acknowledge it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from m3_tpu_torch import resolve_device
from m3_tpu_torch.x import devguard, membudget

I64_MAX = int(np.iinfo(np.int64).max)


class BufferState(NamedTuple):
    slot: torch.Tensor  # i32 (W, S); capacity = empty sentinel
    ts: torch.Tensor  # i64 (W, S)
    val: torch.Tensor  # f64 (W, S)
    n: torch.Tensor  # i64 (W,)


def buffer_init(num_windows: int, sample_capacity: int, slot_capacity: int,
                device=None) -> BufferState:
    dev = resolve_device(device)
    shape = (num_windows, sample_capacity)
    return BufferState(
        slot=torch.full(shape, slot_capacity, dtype=torch.int32, device=dev),
        ts=torch.full(shape, I64_MAX, dtype=torch.int64, device=dev),
        val=torch.zeros(shape, dtype=torch.float64, device=dev),
        n=torch.zeros(num_windows, dtype=torch.int64, device=dev),
    )


def buffer_append(
    state: BufferState,
    windows: torch.Tensor,  # i32 (N,) ring row per sample; OOB drops
    slots: torch.Tensor,  # i32 (N,)
    ts: torch.Tensor,  # i64 (N,)
    vals: torch.Tensor,  # f64 (N,)
) -> BufferState:
    """Append a batch; the state's columns are written IN PLACE (the JAX
    function donates them) and the state is returned.

    Samples keep arrival order within each window (stable sort by
    window).  A sample whose window is out of range, or whose lane would
    pass ``sample_capacity``, is dropped, while ``n`` still grows by the
    window's whole count, as the reference's drop-mode scatter leaves it.
    No host sync: dropped lanes rewrite the bits one kept lane writes (or,
    with none kept, lane 0's own bits), so every duplicate index of the
    one ``index_put_`` carries the same value."""
    num_w, scap = state.slot.shape
    n = slots.shape[0]
    if n == 0:
        return state
    oob = (windows < 0) | (windows >= num_w)
    wkey = torch.where(oob, num_w, windows.to(torch.int64))
    s_w, order = torch.sort(wkey, stable=True)
    s_slot, s_ts, s_val = slots[order], ts[order], vals[order]
    pos = torch.arange(n, dtype=torch.int64, device=wkey.device)
    rank = pos - torch.searchsorted(s_w, s_w)
    dst = state.n[s_w.clamp(0, num_w - 1)] + rank
    keep = (s_w < num_w) & (dst < scap)
    flat = s_w * scap + dst
    # one kept lane (or lane 0 untouched) as the target of every dropped lane
    any_keep = keep.any()
    k0 = keep.to(torch.uint8).argmax()
    f_slot, f_ts, f_val = (state.slot.view(-1), state.ts.view(-1),
                           state.val.view(-1))
    a_flat = torch.where(any_keep, flat[k0], 0)
    flat = torch.where(keep, flat, a_flat)
    f_slot[flat] = torch.where(keep, s_slot, torch.where(any_keep, s_slot[k0], f_slot[0]))
    f_ts[flat] = torch.where(keep, s_ts, torch.where(any_keep, s_ts[k0], f_ts[0]))
    # f64 lanes move as their int64 bits (a NaN keeps its payload)
    v_bits = s_val.view(torch.int64)
    f_bits = f_val.view(torch.int64)
    f_bits[flat] = torch.where(keep, v_bits, torch.where(any_keep, v_bits[k0], f_bits[0]))
    edges = torch.searchsorted(
        s_w, torch.arange(num_w + 1, dtype=torch.int64, device=s_w.device))
    state.n.add_(edges[1:] - edges[:-1])
    return state


def _sort_window(slot_w: torch.Tensor, ts_w: torch.Tensor, val_w: torch.Tensor):
    """Sort one window's lanes by (slot, ts, arrival descending) — the
    JAX package's three-key ``lax.sort`` — as stable sorts, least
    significant key first: reverse the lanes (arrival descending), then
    by ts, then by slot.  Returns (slot, ts, val, first)."""
    m = slot_w.shape[0]
    perm = torch.arange(m - 1, -1, -1, dtype=torch.int64, device=slot_w.device)
    perm = perm[torch.sort(ts_w[perm], stable=True).indices]
    perm = perm[torch.sort(slot_w[perm], stable=True).indices]
    s_slot, s_ts, s_val = slot_w[perm], ts_w[perm], val_w[perm]
    first = torch.ones(m, dtype=torch.bool, device=slot_w.device)
    first[1:] = (s_slot[1:] != s_slot[:-1]) | (s_ts[1:] != s_ts[:-1])
    return s_slot, s_ts, s_val, first


def buffer_drain(state: BufferState, window: int):
    """One window -> (slot, ts, val, first) sorted by (slot, ts), all
    ``sample_capacity`` lanes (sentinels sort last).

    ``first`` masks out duplicate (slot, ts) pairs — the *last arrival*
    wins, matching the reference's merge rule where a later write at the
    same timestamp supersedes."""
    w = int(window)
    return _sort_window(state.slot[w], state.ts[w], state.val[w])


def dedupe_last_write_wins(slots: np.ndarray, ts: np.ndarray, vals: np.ndarray):
    """Sort by (slot, ts) and keep the LAST-arriving sample per (slot, ts)
    — the one merge rule every host-side path shares (cold drain,
    snapshot merge), mirroring the device path in `buffer_drain`."""
    arrival = np.arange(len(slots))
    order = np.lexsort((-arrival, ts, slots))
    slots, ts, vals = slots[order], ts[order], vals[order]
    first = np.ones(len(slots), bool)
    first[1:] = (slots[1:] != slots[:-1]) | (ts[1:] != ts[:-1])
    return slots[first], ts[first], vals[first]


def _empty():
    return (np.empty(0, np.int32), np.empty(0, np.int64), np.empty(0))


class ShardBuffer:
    """Host wrapper owning one shard's buffer ring + overflow lists.
    ``device=None`` means CUDA (raises without one)."""

    def __init__(self, block_size_nanos: int, num_windows: int,
                 sample_capacity: int, slot_capacity: int, device=None):
        self.block_size = block_size_nanos
        self.num_windows = num_windows
        self.sample_capacity = sample_capacity
        self.slot_capacity = slot_capacity
        self.device = resolve_device(device)
        # Admission before allocation: an over-budget ring rejects
        # typed (DeviceBudgetExceeded) here; released automatically when
        # this buffer is collected.
        self._mem = membudget.reserve(
            "storage.buffer",
            membudget.buffer_bytes(num_windows, sample_capacity),
            owner=self)
        # the ring's allocation belongs to the stage that fills it: a
        # card that refuses it counts against storage.buffer_append
        try:
            self.state = devguard.run_guarded(
                "storage.buffer_append", lambda: buffer_init(
                    num_windows, sample_capacity, slot_capacity, self.device))
        except BaseException:
            self._mem.release()
            raise
        self._n_host = np.zeros(num_windows, np.int64)
        # block_start -> ring row for open windows
        self.open_blocks: dict[int, int] = {}
        # block_start -> [(slot, ts, val)] host overflow (cold writes)
        self.cold: dict[int, list] = {}
        # Sorted-window snapshot cache: every read of an open window
        # needs the same device sort+dedupe of the whole window; one
        # version counter (bumped on any mutation) lets K reads between
        # two writes share ONE drain + K binary searches.
        self._version = 0
        self._snap: dict[int, tuple] = {}  # block_start -> (version, s, t, v)

    def _row_for(self, block_start: int) -> int:
        return (block_start // self.block_size) % self.num_windows

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def write(self, slots: np.ndarray, ts: np.ndarray, vals: np.ndarray,
              open_starts: set[int]) -> int:
        """Append a batch.  open_starts = block starts currently accepting
        warm writes (decided by the shard: retention/bufferPast/Future).
        Returns count of samples routed to the cold path."""
        block_starts = (ts // self.block_size) * self.block_size
        warm = np.isin(block_starts, list(open_starts))
        if warm.any():
            # the device append first: a batch it refuses is routed
            # nowhere (no host staging — the caller acknowledges nothing)
            self._append_warm(slots[warm], ts[warm], vals[warm],
                              block_starts[warm])
        ncold = int((~warm).sum())
        if ncold:
            for bs in np.unique(block_starts[~warm]):
                sel = (~warm) & (block_starts == bs)
                self.cold.setdefault(int(bs), []).append(
                    (slots[sel].copy(), ts[sel].copy(), vals[sel].copy())
                )
        return ncold

    def _append_warm(self, wslots, wts, wvals, wstarts) -> None:
        """One batch of warm samples into the device ring, behind the
        ``storage.buffer_append`` stage (the ring's growth inside it, as
        the reference grows inside its guarded append); the host shadows
        commit only after the append succeeds."""
        rows = ((wstarts // self.block_size) % self.num_windows).astype(np.int32)
        per_row = np.bincount(rows, minlength=self.num_windows)
        needed = int((self._n_host + per_row).max())

        def append():
            if needed > self.sample_capacity:
                self._grow(needed)
            return buffer_append(
                self.state,
                self._dev(rows),
                self._dev(wslots.astype(np.int32)),
                self._dev(wts.astype(np.int64)),
                self._dev(wvals.astype(np.float64)),
            )

        self._version += 1  # sorted snapshots are now stale
        self.state = devguard.run_guarded("storage.buffer_append", append)
        for bs in np.unique(wstarts):
            self.open_blocks[int(bs)] = self._row_for(int(bs))
        self._n_host += per_row

    def _grow(self, needed: int) -> None:
        new_cap = self.sample_capacity
        while new_cap < needed:
            new_cap *= 2
        # Admit the growth BEFORE padding: an over-budget grow raises
        # typed inside the guarded append, which refuses the batch (and a
        # pad the card refuses puts the reservation back).
        old = self._mem.nbytes
        self._mem.resize(membudget.buffer_bytes(self.num_windows, new_cap))
        pad = new_cap - self.sample_capacity
        st = self.state
        W = self.num_windows

        def _pad(col, fill):
            return torch.cat([col, torch.full((W, pad), fill, dtype=col.dtype,
                                              device=col.device)], dim=1)

        try:
            self.state = BufferState(
                slot=_pad(st.slot, self.slot_capacity),
                ts=_pad(st.ts, I64_MAX),
                val=_pad(st.val, 0.0),
                n=st.n,
            )
        except BaseException:
            self._mem.resize(old)
            raise
        self.sample_capacity = new_cap

    def _drain_row(self, row: int):
        """One window's samples sorted by (slot, ts), last write winning,
        sentinels dropped, as host arrays: ONE device -> host copy.

        Only the first ``n[row]`` lanes are sorted: every lane past them
        is a sentinel (slot = capacity), which sorts after all of them and
        which the keep mask drops, so the kept samples are those of the
        whole row's sort (``buffer_drain``).  Runs behind the
        ``storage.buffer_drain`` stage, with the ``device.transfer``
        point before the copy to the host."""
        m = int(min(self._n_host[row], self.sample_capacity))

        def drain():
            st = self.state
            s_slot, s_ts, s_val, first = _sort_window(
                st.slot[row, :m], st.ts[row, :m], st.val[row, :m])
            keep = first & (s_slot < self.slot_capacity)
            packed = torch.stack([s_slot.to(torch.int64), s_ts,
                                  s_val.view(torch.int64)])[:, keep]
            devguard.transfer_point("storage.buffer_drain")
            return packed.cpu().numpy()

        host = devguard.run_guarded("storage.buffer_drain", drain)
        return (host[0].astype(np.int32), host[1].copy(),
                host[2].view(np.float64).copy())

    def drain(self, block_start: int):
        """Seal one open block: device sort+dedupe, then host-side
        ragged split.  Returns (slots, ts, vals) sorted by (slot, ts)
        with duplicates resolved last-write-wins; clears the window (only
        once the drain succeeded: a failed drain leaves it open)."""
        row = self.open_blocks.get(block_start)
        if row is None:
            return _empty()
        out = self._drain_row(row)
        del self.open_blocks[block_start]
        self._reset_row(row)
        return out

    def _reset_row(self, row: int) -> None:
        self._version += 1
        self.state.slot[row].fill_(self.slot_capacity)
        self.state.ts[row].fill_(I64_MAX)
        self.state.n[row] = 0
        self._n_host[row] = 0

    def discard(self, block_start: int) -> None:
        """Drop one open window WITHOUT the drain sort.  The flush path
        reads via :meth:`peek`, writes the volume, and discards only
        once the write is durably on disk — an ENOSPC mid-write leaves
        the window buffered and readable for the next tick's retry."""
        row = self.open_blocks.pop(block_start, None)
        if row is not None:
            self._reset_row(row)

    def drain_cold(self, block_start: int):
        """Pull the overflow list for one block (sorted, deduped)."""
        parts = self.cold.pop(block_start, None)
        return self._merge_cold(parts)

    def peek_cold(self, block_start: int):
        """Non-destructive :meth:`drain_cold` — pair with
        :meth:`discard_cold` after the merged volume lands on disk."""
        return self._merge_cold(self.cold.get(block_start))

    def discard_cold(self, block_start: int) -> None:
        self.cold.pop(block_start, None)

    @staticmethod
    def _merge_cold(parts):
        if not parts:
            return _empty()
        slots = np.concatenate([p[0] for p in parts]).astype(np.int32)
        ts = np.concatenate([p[1] for p in parts]).astype(np.int64)
        vals = np.concatenate([p[2] for p in parts]).astype(np.float64)
        return dedupe_last_write_wins(slots, ts, vals)

    def _sorted_window(self, block_start: int):
        """(slots, ts, vals) of one open window, sorted by (slot, ts),
        deduped last-write-wins, sentinel-stripped — served from the
        version-stamped snapshot cache (invalidated by any write/drain)
        so reads between mutations share ONE device sort."""
        row = self.open_blocks.get(block_start)
        if row is None:
            return None
        hit = self._snap.get(block_start)
        if hit is not None and hit[0] == self._version:
            return hit[1:]
        out = self._drain_row(row)
        # one snapshot per OPEN window; closed windows' entries are
        # pruned here
        self._snap = {
            bs: v for bs, v in self._snap.items() if bs in self.open_blocks
        }
        self._snap[block_start] = (self._version,) + out
        return out

    def peek(self, block_start: int):
        """Non-destructive drain of one open window: (slots, ts, vals)
        sorted+deduped, state untouched — the snapshot read
        (reference buffer.go:537 Snapshot streams the open buckets
        without evicting them)."""
        snap = self._sorted_window(block_start)
        if snap is None:
            return _empty()
        return snap

    def read_window(self, block_start: int, slot: int):
        """Read one series' points from an open (unsealed) block — the
        read path's buffer component (buffer.go:705 ReadEncoded): a
        binary search over the sorted snapshot."""
        snap = self._sorted_window(block_start)
        if snap is None:
            return np.empty(0, np.int64), np.empty(0)
        s_slot, s_ts, s_val = snap
        # keys in the window's own dtype: int64 keys would cast the whole
        # window on every read
        lo, hi = np.searchsorted(s_slot, np.asarray([slot, slot + 1], s_slot.dtype))
        return s_ts[lo:hi], s_val[lo:hi]

    def read_window_many(self, block_start: int, slots: np.ndarray):
        """Batched :meth:`read_window`: one sorted snapshot serves every
        requested slot.  Returns ``[(ts, vals), ...]`` aligned with
        ``slots``; a slot < 0 (unknown series) yields empty arrays."""
        empty = (np.empty(0, np.int64), np.empty(0))
        snap = self._sorted_window(block_start)
        if snap is None:
            return [empty for _ in slots]
        s_slot, s_ts, s_val = snap
        slots = np.asarray(slots, np.int64)
        los = np.searchsorted(s_slot, slots)
        his = np.searchsorted(s_slot, slots + 1)
        return [
            (s_ts[lo:hi], s_val[lo:hi]) if (hi > lo and sl >= 0) else empty
            for sl, lo, hi in zip(slots.tolist(), los.tolist(), his.tolist())
        ]
