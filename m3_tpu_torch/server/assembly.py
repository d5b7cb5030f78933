"""Config-driven server assembly: one call from NodeConfig to a running
node.  The port's counterpart of ``m3_tpu/server/assembly.py``.

Equivalent of the reference's monolithic startup
(`src/dbnode/server/server.go:171 Run`: config → pools → topology →
storage.NewDatabase → servers → bootstrap; and the query side
`src/query/server/query.go:195`): build the instrument registry, the
Database (with namespaces from config), the control plane (KV, the
topology watcher and shard migrator), bootstrap (local, then from
peers), the RPC listener, the mediator loop, and the HTTP and admin
APIs.  `Assembly.close()` tears down in reverse order.

The node runs on ``device`` (None = CUDA; raises without a card).  The
reference's process-global env seams have no counterpart:
``coordinator.arena_layout`` becomes the downsampler's layout argument,
and ``coordinator.arena_ingest`` may only name what the port does anyway
(``auto``: each arena ingest routes by its tensor's device).  A config
that asks for a subsystem this package does not have is refused with a
:class:`ConfigError` naming the missing module (:data:`UNPORTED`), never
ignored.
"""

from __future__ import annotations

import dataclasses
import time as _time
from pathlib import Path

from m3_tpu_torch import instrument
from m3_tpu_torch.core.config import (
    ConfigError, NodeConfig, load_config, parse_duration,
)
from m3_tpu_torch.server.http_api import ApiContext, serve_background
from m3_tpu_torch.storage.database import Database, DatabaseOptions, NamespaceOptions
from m3_tpu_torch.storage.mediator import Mediator

_LOG = instrument.logger("server.assembly")

# (config field, predicate on the NodeConfig, the reference module it
# needs): run_node refuses each one that is set
UNPORTED = (
    ("coordinator.carbon_listen_port",
     lambda c: (c.coordinator is not None
                and c.coordinator.carbon_listen_port is not None),
     "m3_tpu/metrics/carbon.py"),
    ("query.listen_port", lambda c: c.query.listen_port is not None,
     "m3_tpu/query/remote.py"),
    ("query.remotes", lambda c: bool(c.query.remotes),
     "m3_tpu/query/fanout.py and m3_tpu/query/remote.py"),
    ("selfmon.enabled", lambda c: c.selfmon.enabled,
     "m3_tpu/instrument/selfmon.py"),
    ("controller.enabled", lambda c: c.controller.enabled,
     "m3_tpu/x/controller.py"),
    ("device.mem_budget", lambda c: _mem_budget(c) != 0,
     "m3_tpu/x/membudget.py"),
    ("device.breaker_failures/breaker_reset",
     lambda c: (c.device.breaker_failures, c.device.breaker_reset)
     != (5, "10s"),
     "m3_tpu/x/devguard.py"),
)


def _mem_budget(cfg: NodeConfig) -> int:
    from m3_tpu_torch.x.diskbudget import parse_bytes

    return parse_bytes(cfg.device.mem_budget)


def refuse_unported(cfg: NodeConfig) -> None:
    """Raise one ConfigError naming every set field whose subsystem this
    package does not have, and the module each needs."""
    errs = [f"{field}: {module} is not ported"
            for field, is_set, module in UNPORTED if is_set(cfg)]
    if cfg.coordinator is not None and cfg.coordinator.arena_ingest not in (
            "", "auto"):
        errs.append(
            f"coordinator.arena_ingest: {cfg.coordinator.arena_ingest!r} has "
            "no counterpart (each arena ingest routes by its tensor's "
            "device, the reference's 'auto')")
    if errs:
        raise ConfigError("; ".join(errs))


@dataclasses.dataclass
class Assembly:
    config: NodeConfig
    registry: "instrument.Registry"
    db: Database
    mediator: Mediator | None
    http_server: object | None
    tracer: object | None = None
    admin_server: object | None = None
    kv: object | None = None
    rpc_server: object | None = None
    peer_handles: list = dataclasses.field(default_factory=list)
    scrubber: object | None = None
    topology: object | None = None   # cluster.topology.TopologyWatcher
    migrator: object | None = None   # storage.migration.ShardMigrator
    downsampler: object | None = None   # coordinator.downsample.Downsampler
    checkpointer: object | None = None  # aggregator.checkpoint.AggregatorCheckpointer

    @property
    def port(self) -> int | None:
        return self.http_server.server_address[1] if self.http_server else None

    @property
    def rpc_port(self) -> int | None:
        return self.rpc_server.port if self.rpc_server else None

    @property
    def admin_port(self) -> int | None:
        return self.admin_server.server_address[1] if self.admin_server else None

    def close(self) -> None:
        """Stop the listeners (RPC, admin, HTTP), join the mediator (a
        pass in flight finishes first), release the migrator, the
        topology watch and the KV client, then close the database."""
        for h in self.peer_handles:
            h.close()
        self.peer_handles = []
        for attr in ("rpc_server", "admin_server", "http_server"):
            srv = getattr(self, attr)
            if srv is not None:
                srv.shutdown()
                srv.server_close()
                setattr(self, attr, None)
        if self.mediator is not None:
            self.mediator.close()
            self.mediator = None
        if self.migrator is not None:
            self.migrator.close()
            self.migrator = None
        if self.topology is not None:
            self.topology.close()
            self.topology = None
        # the KV client closes only after every server that used it is
        # down — a racing admin request must not reconnect a closed store
        if self.kv is not None and hasattr(self.kv, "close"):
            self.kv.close()
        self.db.close()

    def drain(self, handoff_timeout_s: float = 60.0) -> None:
        """SIGTERM drain (the reference dbnode's graceful shutdown):
        stop taking ingest → persist what we hold → wait for any LEAVING
        shards to cut over to their new owners → tear down.  The RPC
        listener stays up until the very end so peers can stream this
        node's blocks throughout the handoff window."""
        if self.http_server is not None:
            self.http_server.shutdown()
            self.http_server.server_close()
            self.http_server = None
        if self.mediator is not None:
            self.mediator.close()
            self.mediator = None
        # Persist everything persistable: seal+flush whatever left the
        # warm window, snapshot the still-open buffers, rotate the WAL
        # — a restart replays cleanly AND peers can stream every
        # flushed block.
        try:
            now = _time.time_ns()
            self.db.tick(now)
            self.db.snapshot()
        except Exception:  # noqa: BLE001 — drain must reach close()
            _LOG.exception("drain: final flush/snapshot failed")
        if self.checkpointer is not None:
            # Final arena checkpoint: a SIGTERM'd coordinator resumes its
            # open windows on restart (aggregator/checkpoint.py)
            try:
                self.checkpointer.save()
            except Exception:  # noqa: BLE001 — drain must reach close()
                _LOG.exception("drain: aggregator checkpoint failed")
        if self.migrator is not None:
            if not self.migrator.wait_handed_off(handoff_timeout_s):
                _LOG.warning(
                    "drain: handoff incomplete after %.0fs "
                    "(LEAVING shards remain; replicas will repair)",
                    handoff_timeout_s,
                )
        self.close()


def namespace_options(ns_cfg) -> NamespaceOptions:
    kw = {}
    # cardinality sizing: 0 keeps the storage defaults; a node serving
    # million-series traffic raises slot_capacity per shard
    if ns_cfg.slot_capacity:
        kw["slot_capacity"] = ns_cfg.slot_capacity
    if ns_cfg.sample_capacity:
        kw["sample_capacity"] = ns_cfg.sample_capacity
    return NamespaceOptions(
        block_size_nanos=parse_duration(ns_cfg.block_size),
        retention_nanos=parse_duration(ns_cfg.retention),
        buffer_past_nanos=parse_duration(ns_cfg.buffer_past),
        buffer_future_nanos=parse_duration(ns_cfg.buffer_future),
        cold_writes_enabled=ns_cfg.cold_writes_enabled,
        num_shards=ns_cfg.num_shards,
        **kw,
    )


def run_node(source, start_mediator: bool | None = None,
             serve_http: bool = True, ruleset=None, device=None) -> Assembly:
    """Boot a node from a YAML/JSON path or string, or a NodeConfig.

    Mirrors server.Run's order: config validate → storage → control
    plane (KV, topology watcher, migrator) → bootstrap (local, then
    peers) → RPC listener → background maintenance → front doors.  `ruleset` (a
    metrics.rules.RuleSet) is required when the coordinator config sets
    `downsample: true` — rules are programmatic/KV objects in the
    reference too, not static YAML.  ``device`` is where the database,
    the engine and the downsampler's arenas live (None = CUDA).
    """
    cfg = source if isinstance(source, NodeConfig) else load_config(source)
    cfg.validate()
    if (cfg.coordinator is not None and cfg.coordinator.downsample
            and ruleset is None):
        raise ConfigError(
            "coordinator.downsample=true requires run_node(..., ruleset=...)"
        )
    refuse_unported(cfg)
    # Disk ledger: armed before the Database exists so the very first
    # mediator tick refreshes real watermarks.  reset() when disabled —
    # the ledger is process-global and a prior in-process node's
    # configuration must not leak into this one.
    from m3_tpu_torch.x import diskbudget as _diskbudget

    if cfg.disk.enabled:
        _diskbudget.configure(
            cfg.db.root,
            capacity=cfg.disk.capacity,
            reserve=cfg.disk.reserve,
            low_ratio=cfg.disk.low_ratio,
            critical_ratio=cfg.disk.critical_ratio)
    else:
        _diskbudget.reset()
    registry = instrument.new_registry()
    scope = registry.scope(cfg.metrics_prefix)
    # Mirror the process-global fault/retry/breaker/disk counters onto
    # this node's /metrics.
    from m3_tpu_torch.x import register_metrics

    register_metrics(registry)
    # Process-level self-observation (RSS/CPU/threads/FDs/uptime) on
    # every scrape.
    from m3_tpu_torch.instrument.procstats import install_process_collector

    install_process_collector(registry, scope)
    tracer = None
    if cfg.coordinator is not None and cfg.coordinator.tracing:
        from m3_tpu_torch.instrument.tracing import Tracer

        tracer = Tracer()

    from m3_tpu_torch.storage.limits import LimitsOptions, QueryLimits

    limits = QueryLimits(
        LimitsOptions(
            max_docs_matched=cfg.db.limits.max_docs_matched,
            max_series_read=cfg.db.limits.max_series_read,
            max_bytes_read=cfg.db.limits.max_bytes_read,
            lookback_s=parse_duration(cfg.db.limits.lookback) / 1e9,
        ),
        instrument=scope,
    )
    namespaces = {
        name: namespace_options(ns) for name, ns in cfg.db.namespaces.items()
    }
    db = Database(
        DatabaseOptions(
            root=cfg.db.root, commitlog_enabled=cfg.db.commitlog_enabled
        ),
        namespaces=namespaces,
        instrument=scope,
        tracer=tracer,
        limits=limits,
        device=device,
    )
    # Tear down everything already started if a later step fails — a
    # half-built node must not leak its mediator thread or bound socket.
    asm = Assembly(cfg, registry, db, None, None, tracer)
    try:
        # Control plane FIRST: the topology watcher must install this
        # node's shard ownership before bootstrap so WAL replay and the
        # peers pass are placement-scoped from the very first byte.
        need_kv = (
            cfg.db.kv_endpoint is not None
            or cfg.db.instance_id is not None
            or (cfg.coordinator is not None
                and cfg.coordinator.admin_listen_port is not None)
        )
        if need_kv:
            if cfg.db.kv_endpoint:
                # shared external control plane (etcd role) — survives
                # this node and is visible to every replica
                from m3_tpu_torch.cluster.kv_remote import RemoteKVStore

                h, _, p = cfg.db.kv_endpoint.rpartition(":")
                asm.kv = RemoteKVStore((h, int(p)))
            else:
                from m3_tpu_torch.cluster.kv import KVStore

                asm.kv = KVStore(cfg.db.root)  # file-backed control plane
        if cfg.db.instance_id is not None and asm.kv is not None:
            from m3_tpu_torch.cluster.placement import PlacementService
            from m3_tpu_torch.cluster.topology import TopologyWatcher
            from m3_tpu_torch.storage.migration import ShardMigrator

            asm.topology = TopologyWatcher(asm.kv, cfg.db.instance_id)
            asm.migrator = ShardMigrator(
                db, asm.topology, PlacementService(asm.kv),
                stream_blocks_per_tick=cfg.mediator.migrate_blocks,
                grace_ticks=cfg.mediator.migrate_grace_ticks,
                instrument=scope,
            )

        db.bootstrap()

        # Peers bootstrap: after local fs+commitlog recovery, pull any
        # (shard, block) filesets a replica peer has that this node
        # lacks, over the socket RPC (the bootstrap chain's final
        # `peers` stage — bootstrapper/peers/source.go).  Unreachable
        # peers are skipped; repair converges them later.  With a
        # topology watcher installed the pass is scoped to
        # placement-owned shards.
        if cfg.db.peers:
            from m3_tpu_torch.server.rpc import RemoteDatabase

            asm.peer_handles = [
                RemoteDatabase((h, int(p)))
                for h, _, p in (a.rpartition(":") for a in cfg.db.peers)
            ]
            if cfg.db.bootstrap_peers:
                from m3_tpu_torch.storage.repair import peers_bootstrap

                for ns_name in cfg.db.namespaces:
                    peers_bootstrap(db, asm.peer_handles, ns_name)

        if cfg.db.rpc_listen_port is not None:
            from m3_tpu_torch.server.rpc import serve_rpc_background

            asm.rpc_server = serve_rpc_background(
                db, host=cfg.db.rpc_listen_host, port=cfg.db.rpc_listen_port
            )
            if cfg.disk.enabled:
                # CRITICAL watermark → refuse write batches un-acked
                # (typed RPC_ERR the session's consistency level
                # absorbs); reads/repair/ticks are never gated.
                asm.rpc_server.ingest_gate = _diskbudget.check_ingest

        # Corruption scrubber: always constructed (the admin endpoint
        # scrubs on demand); attached to the mediator loop only when a
        # per-tick budget is configured.  Peers double as the repair
        # source — a quarantined (shard, block) hole heals from a
        # replica on the next sweep.
        from m3_tpu_torch.storage.scrub import Scrubber

        asm.scrubber = Scrubber(
            db, peers=asm.peer_handles,
            budget_volumes=cfg.mediator.scrub_volumes, instrument=scope,
        )

        # Downsampler BEFORE the mediator: its window drain and arena
        # checkpoint ride the mediator tick, and a checkpoint restore
        # must land before any traffic re-opens the windows.
        downsampler = None
        if (serve_http and cfg.coordinator is not None
                and cfg.coordinator.downsample):
            from m3_tpu_torch.coordinator.downsample import (
                Downsampler, DownsamplerOptions,
            )

            downsampler = Downsampler(
                db, ruleset, namespace=cfg.coordinator.namespace,
                opts=DownsamplerOptions(layout=cfg.coordinator.arena_layout),
                device=db.device,
            )
            asm.downsampler = downsampler
            if cfg.coordinator.checkpoint_every > 0:
                from m3_tpu_torch.aggregator.checkpoint import (
                    AggregatorCheckpointer,
                )

                asm.checkpointer = AggregatorCheckpointer(
                    downsampler,
                    Path(cfg.db.root) / "checkpoint" / "aggregator.ckpt",
                    instrument=scope,
                )
                # Resume open aggregation windows from the last
                # checkpoint; a corrupt file is moved aside and the
                # node boots fresh.
                asm.checkpointer.restore()

        admission = None
        if cfg.coordinator is not None:
            from m3_tpu_torch.x.admission import AdmissionController

            admission = AdmissionController(
                max_concurrent=cfg.query.max_concurrent,
                max_queue=cfg.query.max_queue,
                queue_timeout_s=parse_duration(cfg.query.queue_timeout) / 1e9,
            )

        # Disk-pressure stage for the mediator: refresh the ledger every
        # pass; at/above LOW run cleanup EAGERLY instead of waiting out
        # the cleanup cadence.
        _disk_stage = None
        if cfg.disk.enabled:
            def _disk_stage(now: int, _db=db) -> dict:
                dsnap = _diskbudget.refresh()
                out = {"level": dsnap["level"],
                       "free_ratio": round(dsnap["free_ratio"], 4)}
                if dsnap["level_value"] >= 1:
                    out["cleanup"] = _db.cleanup(now)
                return out

        if cfg.mediator.enabled if start_mediator is None else start_mediator:
            asm.mediator = Mediator(
                db,
                tick_interval_s=parse_duration(cfg.mediator.tick_interval) / 1e9,
                snapshot_every=cfg.mediator.snapshot_every,
                cleanup_every=cfg.mediator.cleanup_every,
                scrubber=(asm.scrubber
                          if cfg.mediator.scrub_volumes > 0 else None),
                scrub_every=cfg.mediator.scrub_every,
                migrator=asm.migrator,
                migrate_every=cfg.mediator.migrate_every,
                downsampler=downsampler,
                checkpointer=asm.checkpointer,
                checkpoint_every=(cfg.coordinator.checkpoint_every
                                  if cfg.coordinator is not None else 0),
                diskpressure=_disk_stage,
                instrument=scope,
            )
            asm.mediator.open()

        if serve_http and cfg.coordinator is not None:
            ctx = ApiContext(
                db, namespace=cfg.coordinator.namespace, registry=registry,
                metrics_scope=scope,
                downsampler=downsampler, tracer=tracer,
                admission=admission,
                query_timeout_s=parse_duration(cfg.query.default_timeout) / 1e9,
                slow_query_fraction=cfg.query.slow_query_fraction,
                checkpointer=asm.checkpointer,
                migrator=asm.migrator,
            )

            # Admission/slow-query observability rides the scrape-time
            # collector pattern of the fault/retry/breaker mirrors.
            def collect_query(_ctx=ctx) -> None:
                m = _ctx.admission.metrics()
                scope.gauge("query_active").update(m["active"])
                scope.gauge("query_queued").update(m["waiting"])
                scope.gauge("query_shed_total").update(m["shed_total"])
                scope.gauge("query_admitted_total").update(m["admitted_total"])
                scope.gauge("slow_query_total").update(_ctx.slow_query_total)

            registry.register_collector(collect_query)
            asm.http_server = serve_background(
                ctx, cfg.coordinator.listen_host, cfg.coordinator.listen_port
            )
        if (serve_http and cfg.coordinator is not None
                and cfg.coordinator.admin_listen_port is not None):
            from m3_tpu_torch.server.admin_api import (
                AdminContext, serve_admin_background,
            )

            # asm.kv was built up front (the topology watcher shares it)
            admin_ctx = AdminContext(asm.kv, db, scrubber=asm.scrubber,
                                     migrator=asm.migrator)
            # live-tune query limits + cache budget through runtime
            # options (runtime_options_manager.go's role)
            def _limit_applier(lim):
                def apply(value, _lim=lim):
                    _lim.limit = int(value)
                return apply

            appliers = [
                ("max_docs_matched", _limit_applier(limits.docs)),
                ("max_series_read", _limit_applier(limits.series)),
                ("max_bytes_read", _limit_applier(limits.bytes)),
                ("block_cache_max_bytes",
                 lambda v: setattr(db.block_cache, "max_bytes", int(v))),
                ("write_new_series_limit_per_sec",
                 lambda v: db.new_series_limiter.set_rate(float(v))),
            ]
            for opt, apply in appliers:
                admin_ctx.runtime.on_change(opt, apply)
                # replay the persisted value: the KV watch fired during
                # AdminContext construction, BEFORE this listener existed
                # — a restart must re-apply tuned values, not report
                # them while running untuned
                persisted = admin_ctx.runtime.get(opt)
                if persisted:
                    apply(persisted)
            asm.admin_server = serve_admin_background(
                admin_ctx, cfg.coordinator.listen_host,
                cfg.coordinator.admin_listen_port,
            )
    except BaseException:
        asm.close()
        raise
    return asm
