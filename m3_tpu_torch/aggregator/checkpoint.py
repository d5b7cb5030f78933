"""Bit-exact aggregation-arena checkpoint/restore: the counterpart of
``m3_tpu/aggregator/checkpoint.py``, in the same file format, so a file
the JAX package wrote restores into the port.

Serialization contract (the reference's):

* **Arrays are raw bytes** — every arena lane (packed and f64 layouts),
  in the JAX package's dtypes (the packed ``base`` as uint64, ``minmax``
  as uint32: ``arena.state_to_numpy`` / ``state_from_numpy`` convert the
  port's int64 tensors losslessly), each with its own adler32.  Restore
  is bit-exact by construction.
* **Host bookkeeping is pickled** — slot maps (exact slot→id
  assignment, free lists), window watermarks, pipeline tails and
  transform state, reject counters, a caller's extra meta (the
  downsampler's series tags).  The header names the classes of the
  package that wrote it; the loader maps ``m3_tpu.*`` onto the port's
  modules of the same relative path and class name, so a JAX file
  restores without importing the JAX package.
* **Corruption is typed** — a bad magic/schema raises
  :class:`~m3_tpu_torch.persist.corruption.FormatCorruption`, a digest
  mismatch :class:`~m3_tpu_torch.persist.corruption.ChecksumMismatch`.
* **Writes are atomic** — temp file + rename: a kill mid-save leaves the
  previous checkpoint intact.
"""

from __future__ import annotations

import io
import os
import pickle
import struct
import tempfile
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from m3_tpu_torch.aggregator.arena import state_from_numpy, state_to_numpy
from m3_tpu_torch.persist.capacity import capacity_guard, inject
from m3_tpu_torch.persist.corruption import (
    ChecksumMismatch, CorruptionError, FormatCorruption)
from m3_tpu_torch.persist.digest import digest

MAGIC = b"M3AGGCKPT"
SCHEMA = 1

__all__ = ["AggregatorCheckpointer", "save_lists", "load_lists",
           "restore_lists", "list_state", "restore_list_state"]

_REFERENCE_PKG = "m3_tpu"
_PORT_PKG = "m3_tpu_torch"


class _Unpickler(pickle.Unpickler):
    """Resolves the reference package's module paths to the port's."""

    def find_class(self, module, name):
        if module == _REFERENCE_PKG or module.startswith(_REFERENCE_PKG + "."):
            module = _PORT_PKG + module[len(_REFERENCE_PKG):]
        return super().find_class(module, name)


def _state_kind(arena) -> str:
    """``arena.state_from_numpy``'s kind for this arena's state."""
    cls = type(arena.state).__name__  # e.g. PackedCounterState, GaugeState
    base = cls[:-len("State")].lower()
    return "packed_" + base[len("packed"):] if base.startswith("packed") else base


# ---------------------------------------------------------------------------
# MetricList <-> (meta, arrays)
# ---------------------------------------------------------------------------


def list_state(ml) -> Tuple[dict, List[Tuple[str, np.ndarray]]]:
    """One MetricList as (host meta, named lanes).  Lane names are
    ``<arena>.<field>`` over the state's fields, in the JAX dtypes."""
    arrays: List[Tuple[str, np.ndarray]] = []
    arena_meta: Dict[str, dict] = {}
    for aname, arena in (("counter", ml.counters), ("gauge", ml.gauges),
                         ("timer", ml.timers)):
        st = arena.state
        arena_meta[aname] = {
            "state_cls": type(st).__name__,
            "fields": list(st._fields),
            "sample_capacity": getattr(arena, "sample_capacity", None),
            "sample_n_host": getattr(arena, "_sample_n_host", None),
        }
        lanes = state_to_numpy(st)
        for f in st._fields:
            arrays.append((f"{aname}.{f}", lanes[f]))
    maps = {int(mt): m.to_entries() for mt, m in ml.maps.items()}
    meta = {
        "policy": str(ml.policy),
        "layout": type(ml.counters).__name__,  # Packed* vs plain
        "opts": {
            "capacity": ml.opts.capacity,
            "num_windows": ml.opts.num_windows,
            "timer_sample_capacity": ml.timers.sample_capacity,
            "quantiles": tuple(ml.opts.quantiles),
            "timer_packed32": ml.opts.timer_packed32,
            "layout": ("packed" if type(ml.counters).__name__.startswith(
                "Packed") else "f64"),
        },
        "consumed_until": ml.consumed_until,
        "drops": ml.drops,
        "timed_rejects": dict(ml.timed_rejects),
        "new_series_rejected": ml.new_series_rejected,
        "forward_errors": ml.forward_errors,
        "maps": maps,
        "pipelines": dict(ml._pipelines),
        "tf_state": dict(ml._tf_state),
        "tail_sigs": dict(ml._tail_sigs),
        "forward_buffer": list(ml._forward_buffer),
        "arenas": arena_meta,
    }
    return meta, arrays


def restore_list_state(ml, meta: dict, arrays: Dict[str, np.ndarray]) -> None:
    """Install a saved state into a freshly constructed MetricList of the
    same geometry, its tensors on the list's device.  Array dtypes and
    shapes are checked against the live state: a geometry mismatch is
    format corruption."""
    from m3_tpu_torch.metrics.types import MetricType

    for aname, arena in (("counter", ml.counters), ("gauge", ml.gauges),
                         ("timer", ml.timers)):
        st = arena.state
        am = meta["arenas"][aname]
        if list(st._fields) != am["fields"]:
            raise FormatCorruption(
                f"checkpoint arena {aname!r} fields {am['fields']} do not "
                f"match this build's {list(st._fields)}",
                component="aggregator.checkpoint")
        live = state_to_numpy(st)
        vals = {}
        for f in st._fields:
            saved = arrays[f"{aname}.{f}"]
            if saved.shape != live[f].shape or saved.dtype != live[f].dtype:
                raise FormatCorruption(
                    f"checkpoint lane {aname}.{f}: {saved.dtype}"
                    f"{saved.shape} vs live {live[f].dtype}{live[f].shape}",
                    component="aggregator.checkpoint")
            vals[f] = saved
        arena.state = state_from_numpy(_state_kind(arena), vals, device=ml.device)
        if am.get("sample_n_host") is not None:
            arena._sample_n_host = np.asarray(am["sample_n_host"]).copy()
    for mt_val, entries in meta["maps"].items():
        ml.maps[MetricType(mt_val)].load_entries(entries)
    ml.consumed_until = meta["consumed_until"]
    ml.drops = meta["drops"]
    ml.timed_rejects = dict(meta["timed_rejects"])
    ml.new_series_rejected = meta["new_series_rejected"]
    ml.forward_errors = meta["forward_errors"]
    ml._pipelines = dict(meta["pipelines"])
    ml._tf_state = dict(meta["tf_state"])
    ml._tail_sigs = dict(meta["tail_sigs"])
    ml._forward_buffer = list(meta["forward_buffer"])


# ---------------------------------------------------------------------------
# File envelope: MAGIC | u8 schema | u64 header_len | u32 header digest
#                | pickle(header) | raw array blob  (array digests live
#                in the header)
# ---------------------------------------------------------------------------


def save_lists(lists: dict, path, extra_meta: dict | None = None) -> int:
    """Write ``{StoragePolicy: MetricList}`` (+ optional extra host meta)
    to ``path`` atomically.  Returns bytes written."""
    entries = []
    blobs: List[bytes] = []
    offset = 0
    for sp, ml in lists.items():
        meta, arrays = list_state(ml)
        arr_meta = []
        for name, a in arrays:
            # record the true shape (0-d lanes stay 0-d), serialize bytes
            raw = np.ascontiguousarray(a).tobytes()
            arr_meta.append({
                "name": name, "dtype": str(a.dtype), "shape": a.shape,
                "offset": offset, "nbytes": len(raw),
                "digest": digest(raw),
            })
            blobs.append(raw)
            offset += len(raw)
        meta["arrays"] = arr_meta
        entries.append(meta)
    header = {"schema": SCHEMA, "lists": entries, "extra": extra_meta or {}}
    hbytes = pickle.dumps(header, protocol=4)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), prefix=path.name + ".tmp")
    try:
        with capacity_guard(path=path, component="checkpoint", op="write",
                            cleanup=(tmp,)):
            inject("checkpoint.write")
            with os.fdopen(fd, "wb") as f:
                f.write(MAGIC)
                f.write(struct.pack("<BQ", SCHEMA, len(hbytes)))
                f.write(struct.pack("<I", digest(hbytes)))
                f.write(hbytes)
                for raw in blobs:
                    f.write(raw)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return len(MAGIC) + 13 + len(hbytes) + offset


def load_lists(path):
    """Parse + verify a checkpoint → (header dict, arrays-by-list).
    Typed failures: FormatCorruption (magic/schema/truncation),
    ChecksumMismatch (header or lane digest)."""
    path = Path(path)
    data = path.read_bytes()
    if len(data) < len(MAGIC) + 13 or not data.startswith(MAGIC):
        raise FormatCorruption("aggregator checkpoint: bad magic/truncated",
                               path=str(path), component="aggregator.checkpoint")
    off = len(MAGIC)
    schema, hlen = struct.unpack_from("<BQ", data, off)
    off += 9
    (hdig,) = struct.unpack_from("<I", data, off)
    off += 4
    if schema != SCHEMA:
        raise FormatCorruption(
            f"aggregator checkpoint schema {schema} != {SCHEMA}",
            path=str(path), component="aggregator.checkpoint")
    hbytes = data[off:off + hlen]
    if len(hbytes) != hlen:
        raise FormatCorruption("aggregator checkpoint: truncated header",
                               path=str(path), component="aggregator.checkpoint")
    if digest(hbytes) != hdig:
        raise ChecksumMismatch(
            "aggregator checkpoint header digest mismatch",
            path=str(path), component="aggregator.checkpoint", check="adler32")
    header = _Unpickler(io.BytesIO(hbytes)).load()
    blob = data[off + hlen:]
    per_list: List[Dict[str, np.ndarray]] = []
    for meta in header["lists"]:
        arrays: Dict[str, np.ndarray] = {}
        for am in meta["arrays"]:
            raw = blob[am["offset"]:am["offset"] + am["nbytes"]]
            if len(raw) != am["nbytes"]:
                raise FormatCorruption(
                    f"aggregator checkpoint: truncated lane {am['name']}",
                    path=str(path), component="aggregator.checkpoint")
            if digest(raw) != am["digest"]:
                raise ChecksumMismatch(
                    f"aggregator checkpoint lane {am['name']} digest mismatch",
                    path=str(path), component="aggregator.checkpoint",
                    check="adler32")
            arrays[am["name"]] = np.frombuffer(
                raw, dtype=np.dtype(am["dtype"])).reshape(am["shape"])
        per_list.append(arrays)
    return header, per_list


def restore_lists(path, make_list):
    """Load a checkpoint and rebuild every MetricList through
    ``make_list(policy_str, opts_dict)`` (the caller owns list
    construction, and so the device).  Returns (``{policy_str:
    MetricList}``, extra meta)."""
    header, per_list = load_lists(path)
    out = {}
    for meta, arrays in zip(header["lists"], per_list):
        ml = make_list(meta["policy"], meta["opts"])
        restore_list_state(ml, meta, arrays)
        out[meta["policy"]] = ml
    return out, header.get("extra", {})


# ---------------------------------------------------------------------------
# The checkpointer of a Downsampler
# ---------------------------------------------------------------------------


class AggregatorCheckpointer:
    """Owns one checkpoint file for a coordinator Downsampler.

    ``save()`` snapshots every (policy, MetricList) under the
    downsampler's lock; ``restore()`` rebuilds them, moving a corrupt
    file aside (``<path>.corrupt``) and starting fresh rather than
    crash-looping.  ``instrument=`` (a registry scope) counts them under
    ``aggregator.checkpoint`` as the reference does."""

    def __init__(self, downsampler, path, instrument=None):
        self.downsampler = downsampler
        self.path = Path(path)
        self.saves = 0
        self.save_errors = 0
        self.restores = 0
        self.corrupt = 0
        self._scope = (instrument.scope("aggregator.checkpoint")
                       if instrument is not None else None)

    def _count(self, name: str) -> None:
        if self._scope is not None:
            self._scope.counter(name).inc()

    def save(self) -> dict:
        try:
            nbytes = self.downsampler.checkpoint_to(self.path)
        except Exception:  # noqa: BLE001 — counted, then re-raised
            self.save_errors += 1
            self._count("save_errors")
            raise
        self.saves += 1
        self._count("saves")
        if self._scope is not None:
            self._scope.gauge("bytes").update(nbytes)
        return {"bytes": nbytes, "path": str(self.path)}

    def restore(self) -> bool:
        if not self.path.exists():
            return False
        try:
            self.downsampler.restore_from(self.path)
        except CorruptionError:
            self.corrupt += 1
            self._count("corrupt")
            # keep the bytes for forensics, never crash-loop on them
            try:
                with capacity_guard(path=self.path, component="checkpoint",
                                    op="sideline"):
                    os.replace(self.path, str(self.path) + ".corrupt")
            except OSError:
                pass
            return False
        self.restores += 1
        self._count("restores")
        return True

    def status(self) -> dict:
        return {
            "path": str(self.path),
            "saves": self.saves,
            "save_errors": self.save_errors,
            "restores": self.restores,
            "corrupt": self.corrupt,
        }
