"""Background integrity scrubber: detect → quarantine → repair from peers.

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

The port's copy of ``m3_tpu/storage/scrub.py`` with no peers: it
detects and quarantines, and a hole waits for a WAL-covered flush or an
operator restore.  Peer repair (``storage/repair.py``) needs the RPC data
plane, which is not ported, so ``Scrubber(peers=[...])`` raises.  The
reference's offline sweep (``scrub_root``, for its CLI) is not ported.
"""

from __future__ import annotations

import struct
import threading
from typing import List

from m3_tpu_torch.persist.fs import DataFileSetReader, list_fileset_volumes


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
    """The sweep's verify-and-classify step: ``("ok", series)``,
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

    ``peers`` must be empty: the scrubber detects and quarantines (a
    later WAL-covered flush or an operator restore fills the hole).
    """

    def __init__(self, db, peers: List[object] | None = None,
                 budget_volumes: int = 4, instrument=None):
        if peers:
            raise NotImplementedError(
                "Scrubber(peers=...): peer repair (storage/repair.py) is "
                "not ported; the port's scrubber detects and quarantines")
        self.db = db
        self.peers: List[object] = []
        self.budget_volumes = int(budget_volumes)
        self._cursor = None  # last (ns, shard, block, vol) verified
        self._lock = threading.Lock()
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
        shape) and quarantine what fails.  Returns the pass's stats (the
        reference's keys; with no peers no repair is attempted).

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
        # With no peers the reference's repair pass returns at once:
        # the synchronous shape adds nothing, the mediator's reports
        # that no background pass started.
        if repair and not wait:
            stats["repair_async"] = False
        self._count("volumes_checked", stats["checked"])
        self._count("corruptions_found", stats["corrupt"])
        self._count("sweeps")
        return stats
