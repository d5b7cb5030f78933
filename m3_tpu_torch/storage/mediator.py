"""Mediator: the background maintenance loop of the storage engine.

Equivalent of the reference's mediator (`src/dbnode/storage/mediator.go:74
struct, :159 Open, :284 ongoingTick, :318 runFileSystemProcesses`): one
orchestrator owning the periodic tick (seal + warm/cold flush), buffer
snapshots, and expired-data cleanup, so callers never drive those by hand.

Differences by design: the reference interleaves a tick pipeline over
every namespace/shard with per-step locking; here each `run_once` is a
single-threaded pass (the Database's engine work is batched array
programs, so the win is in the kernels, not goroutine interleaving).  A
deterministic `clock` injection point replaces the reference's
clock.Options for tests — the same controllable-clock trick its
integration harness uses (`integration/setup.go` nowFn overrides).

The port's copy of ``m3_tpu/storage/mediator.py`` over the port's
``Database``: the same stages, cadence and counters.  A stage that fails
is logged and counted (``*_errors``) and the pass goes on, as in the
reference; callers that must not miss a failure read those counters and
the returned stats.  :meth:`close` joins the loop thread, so a pass in
flight ends before the caller frees the database.  The optional
``profiler`` (an ``instrument.debug.TriggeringProfiler``) observes each
pass's wall duration, as in the reference.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from m3_tpu_torch.instrument import logger
from m3_tpu_torch.storage.database import Database

_LOG = logger("storage.mediator")


def _wall_clock_nanos() -> int:
    return time.time_ns()


class Mediator:
    """Drives tick → snapshot → cleanup on an interval (or on demand)."""

    def __init__(
        self,
        db: Database,
        clock: Callable[[], int] = _wall_clock_nanos,
        tick_interval_s: float = 10.0,
        snapshot_every: int = 6,
        cleanup_every: int = 6,
        scrubber=None,
        scrub_every: int = 1,
        migrator=None,
        migrate_every: int = 1,
        downsampler=None,
        checkpointer=None,
        checkpoint_every: int = 0,
        selfmon=None,
        selfmon_every: int = 1,
        controller=None,
        controller_every: int = 1,
        diskpressure=None,
        instrument=None,
    ):
        self.db = db
        self.clock = clock
        self.tick_interval_s = tick_interval_s
        self.snapshot_every = max(1, snapshot_every)
        self.cleanup_every = max(1, cleanup_every)
        # Optional storage.scrub.Scrubber: the corruption sweep rides
        # the same maintenance loop as flush/snapshot/cleanup, budgeted
        # per pass so it never monopolizes a tick.
        self.scrubber = scrubber
        self.scrub_every = max(1, scrub_every)
        # Optional storage.migration.ShardMigrator: the shard lifecycle
        # (stream INITIALIZING, cut over, grace-drop LEAVING leftovers)
        # runs off this same thread, budgeted per tick like the scrub.
        self.migrator = migrator
        self.migrate_every = max(1, migrate_every)
        # Optional coordinator Downsampler: its window drain rides the
        # maintenance loop (the reference coordinator's flush manager
        # role) — without this, a live node's downsampled aggregates
        # would only ever flush on drain.
        self.downsampler = downsampler
        # Optional aggregator.checkpoint.AggregatorCheckpointer: the
        # arena checkpoint rides the tick cadence (plus SIGTERM drain),
        # so a SIGKILL loses at most checkpoint_every ticks of window
        # state; 0 disables the periodic save.
        self.checkpointer = checkpointer
        self.checkpoint_every = checkpoint_every
        # Optional instrument.selfmon.SelfMonitor: the self-scrape
        # (registry + fleet peers → the _m3_selfmon namespace through
        # the real write path) and the SLO burn-rate evaluation ride
        # the maintenance loop on their own cadence.
        self.selfmon = selfmon
        self.selfmon_every = max(1, selfmon_every)
        # Optional x.controller.Controller: the self-healing pass reads
        # the verdicts the selfmon stage just refreshed and acts through
        # its typed actuator registry — sensor before controller, every
        # pass, by construction.
        self.controller = controller
        self.controller_every = max(1, controller_every)
        # Optional disk-pressure stage (assembly closure over
        # x.diskbudget + Database.cleanup): refreshes the disk ledger
        # every pass and runs cleanup EAGERLY at/above the LOW
        # watermark — pressure-driven reclaim instead of cadence.
        self.diskpressure = diskpressure
        self._ticks = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._scope = (
            instrument.scope("mediator") if instrument is not None else None
        )
        # Timer (lifetime reservoir) is the RIGHT instrument here and
        # deliberately kept: the mediator ticks every few seconds, so a
        # windowed histogram would mostly be empty, and "how have ticks
        # behaved over the process's life" is the question an operator
        # asks.  Hot paths (ingest/query/flush) use Histogram instead —
        # see instrument.Timer's staleness caveat.
        self._timer_tick = (self._scope.timer("tick_wall_seconds")
                            if self._scope is not None else None)
        # Optional condition-triggered profiler (reference
        # triggering_profile.go): observe() gets each pass's wall
        # duration, so a slow tick auto-captures a debug bundle.
        self.profiler = None

    def run_once(self, now_nanos: int | None = None) -> dict:
        """One maintenance pass: tick (seal+flush) every call, snapshot and
        cleanup on their cadence (mediator.go:284 ongoingTick + :318
        runFileSystemProcesses)."""
        with self._lock:
            t0 = time.monotonic()
            now = self.clock() if now_nanos is None else now_nanos
            stats: dict = {"tick": self.db.tick(now)}
            self._ticks += 1
            if self._ticks % self.snapshot_every == 0:
                stats["snapshot"] = self.db.snapshot()
            if self._ticks % self.cleanup_every == 0:
                stats["cleanup"] = self.db.cleanup(now)
            if self.diskpressure is not None:
                # After flush/snapshot/cleanup (their writes are the
                # bytes being measured), before selfmon (so this pass's
                # scrape stores the watermark the ledger just computed).
                try:
                    stats["disk"] = self.diskpressure(now)
                except Exception:  # noqa: BLE001 — a failing ledger
                    # walk must not disable maintenance; counted so a
                    # silently-dead disk stage is visible on /metrics
                    _LOG.exception("mediator: disk-pressure stage failed")
                    if self._scope is not None:
                        self._scope.counter("disk_pressure_errors").inc()
            if (self.migrator is not None
                    and self._ticks % self.migrate_every == 0):
                # Shard lifecycle before the scrub stage: a freshly
                # streamed block is immediately eligible for verify,
                # and a due drop frees its volumes before the sweep
                # re-lists them.
                stats["topology"] = self.migrator.tick()
            if self.downsampler is not None:
                try:
                    stats["downsample_flushed"] = self.downsampler.flush(now)
                except Exception:  # noqa: BLE001 — one bad drain must
                    # not disable flush/snapshot/cleanup for the pass
                    _LOG.exception("mediator: downsampler flush failed")
                    if self._scope is not None:
                        self._scope.counter("downsample_flush_errors").inc()
            if (self.selfmon is not None
                    and self._ticks % self.selfmon_every == 0):
                # Self-scrape AFTER the flush stages so the cycle's
                # samples record this tick's flush counters; the writes
                # land in open buffers and seal on a later tick like
                # any other ingest.
                try:
                    stats["selfmon"] = self.selfmon.tick(now)
                except Exception:  # noqa: BLE001 — a failing scrape
                    # must not disable flush/snapshot/cleanup; counted
                    # so a silently-dead selfmon is visible on /metrics
                    _LOG.exception("mediator: selfmon tick failed")
                    if self._scope is not None:
                        self._scope.counter("selfmon_tick_errors").inc()
            if (self.controller is not None
                    and self._ticks % self.controller_every == 0):
                # Self-healing AFTER selfmon so each pass acts on the
                # verdicts evaluated THIS tick, never last tick's.
                try:
                    stats["controller"] = self.controller.tick(now)
                except Exception:  # noqa: BLE001 — a failing control
                    # pass must not disable maintenance; counted so a
                    # silently-dead controller is visible on /metrics
                    _LOG.exception("mediator: controller tick failed")
                    if self._scope is not None:
                        self._scope.counter("controller_tick_errors").inc()
            if (self.checkpointer is not None and self.checkpoint_every > 0
                    and self._ticks % self.checkpoint_every == 0):
                try:
                    stats["checkpoint"] = self.checkpointer.save()
                except Exception:  # noqa: BLE001 — counted by the
                    # checkpointer; the tick's remaining stages still run
                    _LOG.exception("mediator: aggregator checkpoint failed")
            if (self.scrubber is not None
                    and self._ticks % self.scrub_every == 0):
                # Non-blocking: an admin-triggered whole-disk scrub in
                # flight must not stall flush/snapshot/cleanup — the
                # tick just skips its scrub stage and retries next pass.
                stats["scrub"] = self.scrubber.run_once(wait=False)
            if self._scope is not None:
                self._scope.counter("ticks").inc()
                for ns_stats in stats["tick"].values():
                    self._scope.counter("warm_flushed").inc(
                        ns_stats.get("warm_flushed", 0)
                    )
                    self._scope.counter("cold_flushed").inc(
                        ns_stats.get("cold_flushed", 0)
                    )
            stats["duration_s"] = time.monotonic() - t0
            if self._timer_tick is not None:
                self._timer_tick.record(stats["duration_s"])
            if self.profiler is not None:
                stats["profile"] = self.profiler.observe(stats["duration_s"])
            return stats

    # -- background loop ---------------------------------------------------

    def open(self) -> None:
        """Start the background loop (mediator.go:159 Open)."""
        if self._thread is not None:
            raise RuntimeError("mediator already open")
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.tick_interval_s):
            try:
                self.run_once()
            except Exception:  # noqa: BLE001 - the loop must survive
                # A persistently failing tick silently disabling
                # flush/snapshot/cleanup would be invisible data-loss
                # risk — always log, count when metered.
                _LOG.exception("mediator tick failed")
                if self._scope is not None:
                    self._scope.counter("tick_errors").inc()
