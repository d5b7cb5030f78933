"""Per-root disk budget ledger: membudget's twin for the other finite
The port's copy of ``m3_tpu/x/diskbudget.py`` (it imports nothing of ``m3_tpu``).
resource.

The reference runs ``storage/cleanup.go`` + commitlog retention because
a dbnode that fills its disk dies mid-flush; this module gives the
node the numbers to act BEFORE that happens.  One ledger per process
(the node owns one root), refreshed on the mediator tick: a walk of the
root classifies every byte by artifact family (filesets / commitlog /
snapshots / quarantine / checkpoints), headroom comes from
``os.statvfs`` — or from a configured ``disk.capacity`` quota when the
root shares a filesystem with other tenants (every dtest node on one
disk) or an operator wants a bound tighter than the device.

Watermarks, coarse on purpose (two thresholds an operator can reason
about, not a PID controller):

* **OK** — free ratio above ``low_ratio``: nothing changes.
* **LOW** — free ratio at/below ``low_ratio``: the mediator runs the
  cleanup machinery EAGERLY (superseded volumes, stale snapshots,
  retention-aged quarantine, fully-flushed commitlog segments) instead
  of waiting for its cadence.
* **CRITICAL** — free ratio at/below ``critical_ratio`` OR absolute
  free bytes inside the ``reserve`` band: NEW ingest is shed with the
  typed :class:`~m3_tpu_torch.persist.capacity.DiskCapacityError` (the ingest
  backoff contract: never acked = never lost), while reads, flushes,
  WAL appends and the final-drain snapshot keep running — the reserve
  exists precisely so the writes that make data durable always have
  room to complete.

The ledger is **advisory accounting, host-side only** (the membudget
discipline): it does not intercept writes, it informs the shed/reclaim
machinery and the /metrics + /health surfaces.  Gauges:
``disk_free_ratio`` / ``disk_free_bytes`` / ``disk_total_bytes`` /
``disk_used_bytes`` / ``disk_reserve_bytes`` / ``disk_level`` (0/1/2) /
``disk_ingest_shed_total`` plus per-family ``disk_component_bytes``.
Selfmon stores them like any gauge, so ``disk_free_ratio`` history is
PromQL-queryable and the ``disk-pressure`` SLO rule closes the loop
through the controller's ``emergency_cleanup`` actuator.
"""

from __future__ import annotations

import os
import re
import threading
from pathlib import Path
from typing import Dict, Optional

from m3_tpu_torch.persist.capacity import DiskCapacityError

_SIZE_RE = re.compile(r"^(\d+(?:\.\d+)?)\s*([KMGT]i?)?B?$", re.IGNORECASE)
_SIZE_MULT = {None: 1, "K": 1 << 10, "M": 1 << 20, "G": 1 << 30,
              "T": 1 << 40}


def parse_bytes(v) -> int:
    """"512M" / "2GiB" / 1048576 → bytes (binary units; 0 = unlimited).
    A copy of ``m3_tpu/x/membudget.py``'s parser: the device-memory
    ledger itself is not ported."""
    if isinstance(v, (int, float)):
        return int(v)
    m = _SIZE_RE.match(str(v).strip())
    if not m:
        raise ValueError(
            f"bad byte size {v!r} (want e.g. '512M', '2GiB', or bytes)")
    suffix = m.group(2)
    mult = _SIZE_MULT[suffix[0].upper() if suffix else None]
    return int(float(m.group(1)) * mult)

__all__ = [
    "LEVELS", "check_ingest", "components", "configure", "counters",
    "enabled", "level", "refresh", "reset", "shedding", "snapshot",
]

# Watermark levels, exported as the ``disk_level`` gauge value.
LEVELS = ("ok", "low", "critical")

_lock = threading.Lock()
_root: Optional[Path] = None
_capacity = 0          # 0 = statvfs headroom, >0 = configured quota bytes
_reserve = 0
_low_ratio = 0.25
_critical_ratio = 0.10
_shed_total = 0
_last: Optional[dict] = None

# Top-level directory → artifact family.  Anything else under the root
# (node.json, chaos ballast, stray files) lands in "other" so the ledger
# always sums to the bytes actually present.
_FAMILIES = {
    "data": "filesets",
    "commitlogs": "commitlog",
    "snapshots": "snapshots",
    "quarantine": "quarantine",
    "checkpoint": "checkpoints",
}


def configure(root, capacity=0, reserve="64M", low_ratio: float = 0.25,
              critical_ratio: float = 0.10) -> None:
    """Arm the ledger for ``root``.  ``capacity`` (bytes or suffixed
    string) of 0 means headroom comes from ``os.statvfs``; non-zero
    treats the root as a quota of that many bytes (the dtest/multi-
    tenant mode).  ``reserve`` is the flush-headroom band: free bytes
    at/below it are CRITICAL regardless of ratio."""
    global _root, _capacity, _reserve, _low_ratio, _critical_ratio, _last
    if not (0.0 <= critical_ratio <= low_ratio <= 1.0):
        raise ValueError(
            f"want 0 <= critical_ratio <= low_ratio <= 1, got "
            f"critical={critical_ratio} low={low_ratio}")
    with _lock:
        _root = Path(root)
        _capacity = parse_bytes(capacity)
        _reserve = parse_bytes(reserve)
        _low_ratio = float(low_ratio)
        _critical_ratio = float(critical_ratio)
        _last = None


def enabled() -> bool:
    with _lock:
        return _root is not None


def _walk_components(root: Path) -> Dict[str, int]:
    by: Dict[str, int] = {}
    for dirpath, _dirnames, filenames in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        top = rel.split(os.sep, 1)[0]
        family = _FAMILIES.get(top, "other")
        total = 0
        for name in filenames:
            try:
                total += os.lstat(os.path.join(dirpath, name)).st_size
            except OSError:
                continue
        if total:
            by[family] = by.get(family, 0) + total
    return by


def refresh() -> dict:
    """Re-walk the root and recompute the watermark verdict; returns
    (and caches) the snapshot dict.  Called from the mediator tick —
    /metrics and /health read the cache, so a scrape never walks."""
    with _lock:
        root, capacity, reserve = _root, _capacity, _reserve
        low, crit = _low_ratio, _critical_ratio
    if root is None:
        return snapshot()
    by = _walk_components(root)
    used = sum(by.values())
    if capacity > 0:
        total = capacity
        free = max(0, capacity - used)
    else:
        try:
            st = os.statvfs(root)
            total = st.f_blocks * st.f_frsize
            free = st.f_bavail * st.f_frsize
        except OSError:
            total, free = 0, 0
    ratio = (free / total) if total > 0 else 1.0
    if ratio <= crit or (reserve > 0 and free <= reserve):
        lvl = 2
    elif ratio <= low:
        lvl = 1
    else:
        lvl = 0
    snap = {
        "enabled": True,
        "root": str(root),
        "capacity_bytes": capacity,
        "total_bytes": total,
        "used_bytes": used,
        "free_bytes": free,
        "free_ratio": ratio,
        "reserve_bytes": reserve,
        "low_ratio": low,
        "critical_ratio": crit,
        "level": LEVELS[lvl],
        "level_value": lvl,
        "components": by,
    }
    global _last
    with _lock:
        snap["shed_total"] = _shed_total
        _last = snap
    return snap


def snapshot() -> dict:
    """Last refreshed view (the /health ``disk`` section).  Before the
    first mediator tick — or with the ledger unconfigured — a benign
    OK stub, so surfaces never block on a walk."""
    with _lock:
        if _last is not None:
            return dict(_last, shed_total=_shed_total)
        return {
            "enabled": _root is not None,
            "root": str(_root) if _root is not None else None,
            "capacity_bytes": _capacity,
            "total_bytes": 0,
            "used_bytes": 0,
            "free_bytes": 0,
            "free_ratio": 1.0,
            "reserve_bytes": _reserve,
            "low_ratio": _low_ratio,
            "critical_ratio": _critical_ratio,
            "level": "ok",
            "level_value": 0,
            "components": {},
            "shed_total": _shed_total,
        }


def level() -> str:
    """Current watermark verdict ("ok" / "low" / "critical")."""
    return snapshot()["level"]


def shedding() -> bool:
    """True when NEW ingest should be refused (CRITICAL)."""
    return snapshot()["level_value"] >= 2


def components() -> Dict[str, int]:
    """Per-family byte accounting from the last refresh."""
    return dict(snapshot()["components"])


def check_ingest() -> None:
    """Admission gate for NEW ingest: at CRITICAL raise the typed
    capacity error (counted) so the RPC/wire layers refuse the batch
    un-acked — the replica set absorbs it, nothing acked is lost."""
    snap = snapshot()
    if snap["level_value"] < 2:
        return
    global _shed_total
    with _lock:
        _shed_total += 1
    raise DiskCapacityError(
        f"ingest shed: disk critical ({snap['free_bytes']} bytes free of "
        f"{snap['total_bytes']}, ratio {snap['free_ratio']:.3f} <= "
        f"{snap['critical_ratio']}, reserve {snap['reserve_bytes']}) — "
        "retry after cleanup reclaims space",
        path=snap["root"], component="ingest", op="admit")


def counters() -> Dict[str, int]:
    with _lock:
        return {"diskbudget.shed_total": _shed_total}


def reset() -> None:
    """Test hygiene: disarm the ledger and zero the counters."""
    global _root, _capacity, _reserve, _low_ratio, _critical_ratio
    global _shed_total, _last
    with _lock:
        _root = None
        _capacity = 0
        _reserve = 0
        _low_ratio = 0.25
        _critical_ratio = 0.10
        _shed_total = 0
        _last = None
