"""ShardMigrator: the node-side shard lifecycle state machine.  The
port's counterpart of ``m3_tpu/storage/migration.py``; its default
resolver dials the port's ``server.rpc.RemoteDatabase``.

Reference parity: the dbnode pieces between "a placement you can edit"
and "a cluster you can grow/shrink/roll-restart under load" —
`src/dbnode/storage/bootstrap/bootstrapper/peers` (stream INITIALIZING
shards from the donor peer), `topology/dynamic.go` consumption in
`storage/database.go` (assign/close shards on every topology map), and
the coordinator's MarkShardsAvailable cutover.  One object owns the
whole lifecycle for one node:

* **Ownership install** — every observed placement version installs the
  node's owned shard set into the ``Database``
  (INITIALIZING ∪ AVAILABLE ∪ LEAVING; writes/reads outside it raise
  the typed ``ShardNotOwnedError``).  No placement yet = own all (the
  single-node bring-up default).
* **Streaming** — INITIALIZING shards pull missing flushed blocks from
  the donor named in the placement over the existing block replication
  RPC surface (``list_block_filesets``/``block_metadata``/
  ``read_block``/``write_block``), budgeted per tick so a big backfill
  never starves flush/snapshot/cleanup.  Every streamed segment is
  digest-verified against the donor's block metadata before it lands —
  a corrupt wire copy is rejected, counted, and retried next tick.
  When the donor is unreachable (replace of a dead node), streaming
  falls back to any AVAILABLE replica of the shard.
* **Cutover** — a fully streamed shard CAS-flips
  INITIALIZING→AVAILABLE through ``PlacementService.update`` (bounded
  retry on version conflict); the donor's LEAVING entry disappears in
  the same placement version.
* **Drop** — shards that leave this node's placement entry (cutover
  completed elsewhere, or the instance was removed) lose ownership
  immediately (clients re-route on their next placement observation)
  and their filesets/buffers are deleted after a grace period of ticks,
  so in-flight peer streams and repairs drain first.  Shards never
  observed as owned are NOT dropped — a mistyped instance id must not
  wipe a disk.

Faultpoints: ``topology.stream`` arms at the block-fetch boundary
(drop = the fetch is lost this tick, delay = slow donor, error = typed
transport failure, corrupt = byte-flip caught by digest verify).

Counters (``topology_*`` on /metrics): ``placement_changes``,
``blocks_streamed``, ``series_streamed``, ``stream_errors``,
``verify_failures``, ``cutovers``, ``cutover_failures``,
``shards_dropped``; gauges ``placement_version``,
``shards_initializing``/``_available``/``_leaving``, ``pending_drops``.
Progress is served in /health via :meth:`status`.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from m3_tpu_torch.cluster.placement import PlacementService, ShardState, mark_available
from m3_tpu_torch.cluster.topology import TopologyView, TopologyWatcher
from m3_tpu_torch.instrument import logger
from m3_tpu_torch.persist.digest import digest as checksum
from m3_tpu_torch.x import fault

_LOG = logger("storage.migration")


class ShardMigrator:
    """Drives one node's shard lifecycle off the mediator tick thread.

    ``resolve(instance)`` returns a Database-shaped handle for a
    placement instance; the default dials ``instance.endpoint`` with
    ``server.rpc.RemoteDatabase`` (in-process tests pass a dict-backed
    resolver instead).  Handles are cached and closed with the
    migrator."""

    def __init__(self, db, watcher: TopologyWatcher,
                 placements: PlacementService, resolve=None,
                 stream_blocks_per_tick: int = 4, grace_ticks: int = 2,
                 instrument=None):
        self.db = db
        self.watcher = watcher
        self.placements = placements
        self._resolve = resolve if resolve is not None else self._dial
        self.stream_blocks_per_tick = int(stream_blocks_per_tick)
        self.grace_ticks = max(0, int(grace_ticks))
        self._scope = (
            instrument.scope("topology") if instrument is not None else None
        )
        # per-shard stream-pass latency (hot during a node replace):
        # windowed histogram, interned once
        self._hist_stream = (self._scope.histogram("stream_seconds")
                             if self._scope is not None else None)
        self._mu = threading.Lock()
        # Serializes whole tick() passes: the admin's on-demand
        # POST /topology/migrate racing the mediator tick would stream
        # duplicate volumes and double-advance drop grace countdowns
        # (same mediator-vs-admin race the scrubber guards with its
        # sweep lock).
        self._tick_mu = threading.Lock()
        self._applied_version = -1
        self._prev_owned: Optional[frozenset] = None  # last installed set
        self._had_placement = False
        self._pending_drops: Dict[int, int] = {}      # shard -> ticks left
        self._progress: Dict[int, dict] = {}          # shard -> copied/total
        self._handles: Dict[tuple, object] = {}
        self._mismatch_warned: set = set()
        watcher.on_change(self._on_view)

    # -- instrumentation ---------------------------------------------------

    def _count(self, name: str, n: int = 1) -> None:
        if self._scope is not None and n:
            self._scope.counter(name).inc(n)

    def _gauge(self, name: str, v: float) -> None:
        if self._scope is not None:
            self._scope.gauge(name).update(v)

    # -- handle resolution -------------------------------------------------

    @staticmethod
    def _dial(instance):
        if not instance.endpoint:
            raise ConnectionError(
                f"instance {instance.id} has no endpoint in the placement"
            )
        from m3_tpu_torch.server.rpc import RemoteDatabase

        host, _, port = instance.endpoint.rpartition(":")
        return RemoteDatabase((host, int(port)))

    def _handle_for(self, instance):
        key = (instance.id, instance.endpoint)
        with self._mu:
            h = self._handles.get(key)
        if h is not None:
            return h
        h = self._resolve(instance)
        with self._mu:
            self._handles.setdefault(key, h)
            return self._handles[key]

    # -- placement observation --------------------------------------------

    def _matching_namespaces(self, placement) -> List[str]:
        """Namespaces the placement's shard space governs.  A namespace
        sharded differently from the placement keeps own-all (the
        placement cannot describe it) — warned once, never silently
        half-applied."""
        # Namespace map snapshot under the engine lock: ensure_namespace
        # inserts concurrently on the ingest path (scrub._volume_list
        # takes the same precaution).
        with self.db._mu:
            items = list(self.db.namespaces.items())
        out = []
        for name, ns in items:
            if ns.opts.num_shards == placement.num_shards:
                out.append(name)
            elif name not in self._mismatch_warned:
                self._mismatch_warned.add(name)
                _LOG.warning(
                    "namespace %s has %d shards but the placement has %d; "
                    "ownership not applied to it", name, ns.opts.num_shards,
                    placement.num_shards,
                )
        return out

    def _on_view(self, view: TopologyView) -> None:
        """Watch listener: install ownership and schedule drops.  Cheap
        and non-blocking (runs inside the KV notification path); the
        heavy streaming/drop work happens on tick()."""
        if view.placement is None:
            return
        with self._mu:
            if view.version <= self._applied_version:
                return
            self._applied_version = view.version
            owned = view.owned_shards()
            prev = self._prev_owned
            had = self._had_placement
            self._prev_owned = owned
            self._had_placement = True
            if had and prev is not None and owned is not None:
                # Shards that left my entry between two observed
                # versions: revoke now, delete after grace.  First-ever
                # observation never drops (a node with a wrong
                # instance_id must not wipe its disk).
                for shard in prev - owned:
                    self._pending_drops.setdefault(shard, self.grace_ticks)
                for shard in owned:
                    # re-acquired mid-grace (operator reverted): keep data
                    self._pending_drops.pop(shard, None)
            self._progress = {
                s: self._progress.get(s, {"copied": 0, "total": None})
                for s in view.shards_in_state(ShardState.INITIALIZING)
            }
            # Ownership installs INSIDE the version-gated section: with
            # it outside, a tick-thread apply of v1 racing a
            # watch-thread apply of v2 could finish LAST and leave v1's
            # stale shard set installed forever (the gate would then
            # drop every re-delivery of v2).  Lock order here is
            # migrator._mu -> db._mu; nothing takes them in reverse.
            for name in self._matching_namespaces(view.placement):
                self.db.set_shard_ownership(name, owned)
            # Namespaces created AFTER this version (dynamic namespace
            # add, downsampler ensure_namespace) inherit the same set
            # at construction — they must never start own-all on a
            # placement-scoped node.
            self.db.set_ownership_template(view.placement.num_shards, owned)
        self._count("placement_changes")
        self._gauge("placement_version", view.version)
        for st, g in ((ShardState.INITIALIZING, "shards_initializing"),
                      (ShardState.AVAILABLE, "shards_available"),
                      (ShardState.LEAVING, "shards_leaving")):
            self._gauge(g, len(view.shards_in_state(st)))

    # -- streaming ---------------------------------------------------------

    def _stream_sources(self, view: TopologyView, shard: int) -> list:
        """Donor first, then any AVAILABLE replica (the dead-donor
        fallback).  Returns (instance, handle) pairs; unreachable
        resolves are skipped here, unreachable calls are skipped by the
        caller."""
        sources = []
        donor_id = view.donor_for(shard)
        insts = []
        if donor_id and view.placement is not None:
            donor = view.placement.instances.get(donor_id)
            if donor is not None:
                insts.append(donor)
        insts.extend(i for i in view.available_replicas(shard)
                     if not insts or i.id != insts[0].id)
        for inst in insts:
            try:
                sources.append((inst, self._handle_for(inst)))
            except Exception:  # noqa: BLE001 — unresolvable peer ≙ down
                self._count("stream_errors")
        return sources

    def _stream_shard(self, view: TopologyView, shard: int,
                      budget: int, stats: dict) -> bool:
        """Pull missing flushed blocks for one INITIALIZING shard.
        Returns True when the shard is KNOWN fully copied (some source
        answered and nothing is missing) — the cutover precondition."""
        import time as _time

        t0 = _time.perf_counter()
        try:
            return self._stream_shard_inner(view, shard, budget, stats)
        finally:
            if self._hist_stream is not None:
                self._hist_stream.record(_time.perf_counter() - t0)

    def _stream_shard_inner(self, view: TopologyView, shard: int,
                            budget: int, stats: dict) -> bool:
        complete = True
        answered = False
        copied = total = 0
        for name in self._matching_namespaces(view.placement):
            local = dict(self.db.list_block_filesets(name, shard))
            src_blocks = None
            for inst, handle in self._stream_sources(view, shard):
                try:
                    src_blocks = handle.list_block_filesets(name, shard)
                except Exception:  # noqa: BLE001 — source down: next one
                    self._count("stream_errors")
                    stats["stream_errors"] += 1
                    continue
                src = (inst, handle)
                break
            if src_blocks is None:
                # Nobody reachable knows this shard's blocks: cutting
                # over blind could present data loss as AVAILABLE.
                complete = False
                continue
            answered = True
            total += len(src_blocks)
            copied += sum(1 for bs, _ in src_blocks if bs in local)
            for bs, _vol in src_blocks:
                if bs in local:
                    continue
                if budget - stats["blocks_streamed"] <= 0:
                    complete = False
                    break
                ok = self._copy_block(src[1], name, shard, bs, stats)
                if ok:
                    copied += 1
                else:
                    complete = False
            else:
                continue
            complete = False  # budget broke the loop
        with self._mu:
            if shard in self._progress:
                self._progress[shard] = {"copied": copied, "total": total}
        return complete and answered

    def _copy_block(self, handle, name: str, shard: int, bs: int,
                    stats: dict) -> bool:
        """One block over the wire, digest-verified, behind the
        ``topology.stream`` faultpoint."""
        try:
            if fault.fire("topology.stream") == "drop":
                raise fault.FaultInjected("topology.stream: fetch dropped")
            meta = handle.block_metadata(name, shard, bs) or {}
            series = handle.read_block(name, shard, bs)
        except Exception:  # noqa: BLE001 — donor died mid-stream: the
            # shard stays INITIALIZING and next tick retries/falls back
            self._count("stream_errors")
            stats["stream_errors"] += 1
            return False
        verified = []
        for sid, seg in series:
            _, seg = fault.mangle("topology.stream", seg)
            want = meta.get(sid)
            if want is not None and checksum(seg) != want:
                # Wire/source corruption: refuse the whole block (a
                # half-verified block would cut over with holes).
                self._count("verify_failures")
                stats["verify_failures"] += 1
                return False
            verified.append((sid, seg))
        try:
            self.db.write_block(name, shard, bs, verified)
        except Exception:  # noqa: BLE001 — e.g. ownership revoked by a
            # racing placement move; next tick re-evaluates
            self._count("stream_errors")
            stats["stream_errors"] += 1
            return False
        self._count("blocks_streamed")
        self._count("series_streamed", len(verified))
        stats["blocks_streamed"] += 1
        stats["series_streamed"] += len(verified)
        return True

    # -- cutover -----------------------------------------------------------

    def _cutover(self, shard: int, stats: dict) -> None:
        iid = self.watcher.instance_id

        def mutate(p):
            if p is None:
                raise ValueError("placement vanished before cutover")
            return mark_available(p, iid, shard)

        try:
            self.placements.update(mutate)
        except (KeyError, ValueError) as e:
            # Not initializing anymore (operator raced us) or CAS
            # retries exhausted: the next observed placement version
            # tells us which; nothing to do now.
            self._count("cutover_failures")
            stats["cutover_failures"] += 1
            _LOG.warning("cutover of shard %d failed: %s", shard, e)
            return
        self._count("cutovers")
        stats["cutovers"] += 1
        _LOG.info("shard %d cut over to AVAILABLE on %s", shard, iid)

    # -- drop --------------------------------------------------------------

    def _process_drops(self, stats: dict) -> None:
        with self._mu:
            due = []
            for shard in sorted(self._pending_drops):
                self._pending_drops[shard] -= 1
                if self._pending_drops[shard] < 0:
                    due.append(shard)
            for shard in due:
                del self._pending_drops[shard]
        view = self.watcher.view()
        if view.placement is None:
            return
        for shard in due:
            for name in self._matching_namespaces(view.placement):
                try:
                    stats["fileset_volumes_dropped"] += self.db.drop_shard(
                        name, shard)
                except Exception:  # noqa: BLE001 — a failed delete
                    # retries via cleanup/retention, never kills the tick
                    _LOG.exception("drop of shard %d ns=%s failed",
                                   shard, name)
            self._count("shards_dropped")
            stats["shards_dropped"] += 1

    # -- the tick ----------------------------------------------------------

    def tick(self, wait: bool = True) -> dict:
        """One lifecycle pass (mediator-driven): stream INITIALIZING
        shards under the per-tick block budget, cut fully streamed ones
        over, then advance grace countdowns and drop expired shards.

        Whole passes are serialized; ``wait=False`` (nothing uses it
        yet, but it mirrors the scrubber's mediator shape) returns
        ``{"skipped": True}`` instead of queueing behind a pass already
        in flight."""
        if not self._tick_mu.acquire(blocking=wait):
            return {"skipped": True}
        try:
            stats = {"blocks_streamed": 0, "series_streamed": 0,
                     "stream_errors": 0, "verify_failures": 0, "cutovers": 0,
                     "cutover_failures": 0, "shards_dropped": 0,
                     "fileset_volumes_dropped": 0}
            view = self.watcher.view()
            if view.placement is not None:
                self._on_view(view)  # idempotent: covers a missed fire
                budget = (self.stream_blocks_per_tick
                          if self.stream_blocks_per_tick > 0 else 1 << 30)
                for shard in view.shards_in_state(ShardState.INITIALIZING):
                    if self._stream_shard(view, shard, budget, stats):
                        self._cutover(shard, stats)
            self._process_drops(stats)
            self._gauge("pending_drops", len(self._pending_drops))
            return stats
        finally:
            self._tick_mu.release()

    # -- introspection / drain --------------------------------------------

    def status(self) -> dict:
        """Migration progress for /health."""
        view = self.watcher.view()
        with self._mu:
            progress = {str(s): dict(p) for s, p in self._progress.items()}
            pending = sorted(self._pending_drops)
        out = {
            "instance": self.watcher.instance_id,
            "placement_version": view.version,
            "in_placement": view.in_placement,
            "shards": {
                "initializing": view.shards_in_state(ShardState.INITIALIZING),
                "available": view.shards_in_state(ShardState.AVAILABLE),
                "leaving": view.shards_in_state(ShardState.LEAVING),
            },
            "streaming": progress,
            "pending_drops": pending,
        }
        return out

    def wait_handed_off(self, timeout_s: float = 30.0,
                        poll_s: float = 0.2) -> bool:
        """Drain aid: block until none of this node's shards is LEAVING
        (every handoff cut over) or the timeout passes.  Driven purely
        by the placement watch — the newcomers do the actual work."""
        deadline = time.monotonic() + timeout_s
        while True:
            view = self.watcher.view()
            if (view.placement is None
                    or not view.shards_in_state(ShardState.LEAVING)):
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(poll_s)

    def close(self) -> None:
        with self._mu:
            handles, self._handles = self._handles, {}
        for h in handles.values():
            if hasattr(h, "close"):
                try:
                    h.close()
                except Exception:  # noqa: BLE001
                    pass
