"""Background integrity scrubber: detect → quarantine → repair from peers.
The port's counterpart of ``m3_tpu/storage/scrub.py``.

The wire layer already treats every network failure as expected
and recoverable; this module gives the *disk* edge the same contract.
Reference parity: the repair subsystem's checksum comparison
(`src/dbnode/storage/repair.go`) assumes somebody notices local rot —
real deployments pair it with periodic verification (the
`verify_data_files` tool run under cron).  Here that loop is in-process:

* **Budgeted sweep** — each mediator tick verifies at most
  ``budget_volumes`` fileset volumes (checkpoint → digest file →
  per-file adler32 → per-segment checksums, all via the existing
  ``DataFileSetReader`` open + ``read_all`` walk), resuming from a
  cursor so a large disk is scrubbed incrementally, a few volumes per
  tick, forever.
* **Quarantine** — a failed verify routes through
  ``Shard.quarantine_volume`` (atomic move + reason file + cache
  invalidation + flushed-block bookkeeping).
* **Peer-assisted recovery** — after the sweep, every quarantined
  (namespace, shard, block) with NO intact local volume is re-fetched
  through the existing anti-entropy surface
  (``repair.repair_shard_block`` over the replica handles): the local
  handle presents as a reachable-but-blockless replica, so the merged
  block is written straight back as a fresh fileset volume — the same
  convergence path a wiped node uses.

Counters (``scrub.*`` on a node's /metrics): ``volumes_checked``,
``corruptions_found``, ``repair_attempts``, ``repairs_completed``,
``sweeps``.

Also runnable on demand: ``POST /api/v1/database/scrub`` (admin API)
runs an unbudgeted sweep in-process, and ``python -m
m3_tpu_torch.tools.cli scrub <root>`` (:func:`scrub_root`) sweeps a data
root offline without a running Database.
"""

from __future__ import annotations

import struct
import threading
from typing import Dict, List

from m3_tpu_torch.instrument import logger
from m3_tpu_torch.persist import quarantine as quar
from m3_tpu_torch.persist.fs import DataFileSetReader, list_fileset_volumes

_LOG = logger("storage.scrub")


def verify_volume(root, namespace: str, shard: int, block_start: int,
                  volume: int) -> int:
    """Full integrity walk of one fileset volume; raises
    :class:`~m3_tpu_torch.persist.corruption.CorruptionError` on the
    first failed check, returns the series count otherwise.  Open
    verifies checkpoint/digest/per-file adler32; draining ``read_all``
    verifies every segment checksum."""
    r = DataFileSetReader(root, namespace, shard, block_start, volume)
    try:
        return sum(1 for _ in r.read_all())
    finally:
        r.close()


def _verify_outcome(root, namespace: str, shard: int, block_start: int,
                    volume: int):
    """The online and offline sweeps' verify-and-classify step: ``("ok", series)``,
    ``("gone", None)`` (raced cleanup), or ``("corrupt", err)``.  ``corrupt`` covers the typed hierarchy AND
    untyped reader failures — bare decode errors and I/O-level rot
    (EIO on a failing sector) alike must flag the one volume, never
    kill the rest of the sweep."""
    try:
        return "ok", verify_volume(root, namespace, shard, block_start, volume)
    except FileNotFoundError:
        return "gone", None
    except (ValueError, EOFError, struct.error, OSError) as e:
        return "corrupt", e


class Scrubber:
    """Owns the sweep cursor and the repair worklist for one Database.

    ``peers`` are replica handles (local ``Database`` objects or
    ``server.rpc.RemoteDatabase``) used for post-quarantine recovery;
    with no peers the scrubber still detects and quarantines (a later
    WAL-covered flush or an operator restore fills the hole).
    """

    #: per-(ns, shard, block) ceiling on peer-repair attempts; a hole
    #: nobody can fill (no replica ever flushed it, or it aged out of
    #: retention everywhere) must not generate RPC traffic forever.
    #: In-memory, so a restart grants a fresh allowance — bounded both
    #: ways.
    REPAIR_ATTEMPT_CAP = 5

    def __init__(self, db, peers: List[object] | None = None,
                 budget_volumes: int = 4, instrument=None):
        self.db = db
        self.peers = list(peers or [])
        self.budget_volumes = int(budget_volumes)
        self._cursor = None  # last (ns, shard, block, vol) verified
        self._lock = threading.Lock()
        self._repair_lock = threading.Lock()  # one repair pass at a time
        self._hole_attempts: Dict[tuple, int] = {}
        self._scope = (
            instrument.scope("scrub") if instrument is not None else None
        )

    def _count(self, name: str, n: int = 1) -> None:
        if self._scope is not None and n:
            self._scope.counter(name).inc(n)

    def _volume_list(self) -> List[tuple]:
        # Namespace enumeration under the engine lock: ensure_namespace
        # inserts concurrently on the ingest path, and iterating a
        # resizing dict raises.  The (slow) per-shard globbing happens
        # OUTSIDE the lock.
        with self.db._mu:
            shards = [
                (name, shard.shard_id)
                for name in sorted(self.db.namespaces)
                for shard in self.db.namespaces[name].shards
            ]
        out = []
        for name, shard_id in shards:
            for bs, vol in list_fileset_volumes(
                    self.db.opts.root, name, shard_id):
                out.append((name, shard_id, bs, vol))
        return out

    def run_once(self, budget: int | None = None, repair: bool = True,
                 wait: bool = True) -> dict:
        """One scrub pass: verify up to ``budget`` volumes (None = the
        configured per-tick budget; 0 = the whole disk, the on-demand
        shape), quarantine what fails, then attempt peer repair of every
        open hole.  Returns the pass's stats.

        ``wait=False`` (the mediator's shape) returns ``{"skipped":
        True}`` instead of blocking when another sweep — e.g. an
        admin-triggered whole-disk scrub — already holds the sweep
        lock: a long on-demand scrub must never stall the maintenance
        tick behind it."""
        budget = self.budget_volumes if budget is None else int(budget)
        stats = {"checked": 0, "corrupt": 0, "repair_attempts": 0,
                 "repaired": 0, "wrapped": False}
        if not self._lock.acquire(blocking=wait):
            return {"skipped": True}
        try:
            vols = self._volume_list()
            if vols:
                # Resume strictly after the cursor, wrapping at the end
                # — every volume is eventually visited no matter how
                # small the per-tick budget.
                if self._cursor is not None:
                    after = [v for v in vols if v > self._cursor]
                    stats["wrapped"] = not after
                    vols = after + [v for v in vols if v <= self._cursor]
                take = vols if budget <= 0 else vols[:budget]
                for name, shard_id, bs, vol in take:
                    stats["checked"] += 1
                    self._cursor = (name, shard_id, bs, vol)
                    outcome, detail = _verify_outcome(
                        self.db.opts.root, name, shard_id, bs, vol)
                    if outcome == "corrupt":
                        stats["corrupt"] += 1
                        self.db.quarantine_fileset_volume(
                            name, shard_id, bs, vol, detail
                        )
        finally:
            self._lock.release()
        # Repair OUTSIDE the sweep lock — and, on the mediator's
        # non-blocking (wait=False) path, on a BACKGROUND thread: peer
        # fetches can block up to the RPC timeout on an unreachable
        # replica, and the maintenance tick must never stall behind
        # them (flush/snapshot/cleanup would back up for minutes).
        # On-demand callers (admin endpoint) keep the synchronous shape
        # so the HTTP response carries the repair outcome.
        if repair:
            if wait:
                # Serialize with any in-flight background pass: two
                # passes walking the same holes would double-rewrite
                # blocks cluster-wide and race _hole_attempts.
                with self._repair_lock:
                    self._repair_holes(stats)
            else:
                stats["repair_async"] = self._spawn_repair()
        self._count("volumes_checked", stats["checked"])
        self._count("corruptions_found", stats["corrupt"])
        self._count("sweeps")
        return stats

    def _spawn_repair(self) -> bool:
        """Start one background repair pass; False when no peers exist
        or a previous pass is still running (it will pick up any new
        holes next tick)."""
        if not self.peers:
            return False
        if not self._repair_lock.acquire(blocking=False):
            return False
        def run():
            try:
                self._repair_holes({"repair_attempts": 0, "repaired": 0})
            except Exception:  # noqa: BLE001 — background loop must survive
                _LOG.exception("background repair pass failed")
            finally:
                self._repair_lock.release()
        threading.Thread(target=run, daemon=True,
                         name="m3-scrub-repair").start()
        return True

    def _repair_holes(self, stats: dict) -> None:
        """Re-fetch every quarantined (ns, shard, block) that has no
        intact local volume from the replica set.  Stateless worklist:
        the quarantine inventory names the holes, the presence of a
        local fileset marks one healed — no extra bookkeeping files.
        Per-hole attempts are capped (REPAIR_ATTEMPT_CAP) so a hole no
        replica can fill stops generating RPC traffic."""
        if not self.peers:
            return
        holes = set()
        for entry in quar.list_quarantined(self.db.opts.root):
            if entry.get("kind") != "fileset" or entry.get("label") != "data":
                continue  # snapshot filesets re-converge via the WAL/peers
            name = entry.get("namespace")
            if name not in self.db.namespaces:
                continue
            holes.add((name, int(entry["shard"]), int(entry["block_start"])))
        from m3_tpu_torch.storage.repair import repair_shard_block

        for name, shard_id, bs in sorted(holes):
            if bs in dict(self.db.list_block_filesets(name, shard_id)):
                self._hole_attempts.pop((name, shard_id, bs), None)
                continue  # healed (repair, re-flush, or intact lower volume)
            attempts = self._hole_attempts.get((name, shard_id, bs), 0)
            if attempts >= self.REPAIR_ATTEMPT_CAP:
                continue  # exhausted: operator restore / restart re-arms
            self._hole_attempts[(name, shard_id, bs)] = attempts + 1
            stats["repair_attempts"] += 1
            try:
                repair_shard_block([self.db] + self.peers, name, shard_id, bs)
            except Exception:  # noqa: BLE001 — scrub loop must survive
                _LOG.exception(
                    "peer repair failed ns=%s shard=%d block=%d",
                    name, shard_id, bs,
                )
                continue
            if bs in dict(self.db.list_block_filesets(name, shard_id)):
                stats["repaired"] += 1
                self._hole_attempts.pop((name, shard_id, bs), None)
                _LOG.info("peer repair healed ns=%s shard=%d block=%d",
                          name, shard_id, bs)
        self._count("repair_attempts", stats["repair_attempts"])
        self._count("repairs_completed", stats["repaired"])


def scrub_root(root, quarantine: bool = True) -> List[dict]:
    """Offline sweep of a data root (no Database required — the ops/CLI
    shape).  Verifies every checkpointed volume; corrupt ones are
    quarantined unless ``quarantine=False`` (report-only).  Returns one
    result dict per volume."""
    from pathlib import Path

    results = []
    d = Path(root) / "data"
    namespaces = sorted(p.name for p in d.iterdir() if p.is_dir()) if d.exists() else []
    for ns in namespaces:
        shards = sorted(
            int(p.name) for p in (d / ns).iterdir() if p.name.isdigit()
        )
        for shard in shards:
            for bs, vol in list_fileset_volumes(root, ns, shard):
                rec: Dict = {"namespace": ns, "shard": shard,
                             "block_start": bs, "volume": vol, "ok": True}
                outcome, detail = _verify_outcome(root, ns, shard, bs, vol)
                if outcome == "gone":
                    continue
                if outcome == "ok":
                    rec["series"] = detail
                else:
                    rec.update(ok=False, error=str(detail),
                               check=getattr(detail, "check", None))
                    if quarantine:
                        rec["quarantined"] = str(
                            quar.quarantine_fileset(root, ns, shard, bs, vol,
                                                    detail)
                        )
                results.append(rec)
    return results
