"""Config-driven server assembly: one call from NodeConfig to a running
node.  The port's counterpart of ``m3_tpu/server/assembly.py``.

Equivalent of the reference's monolithic startup
(`src/dbnode/server/server.go:171 Run`: config → pools → topology →
storage.NewDatabase → servers → bootstrap; and the query side
`src/query/server/query.go:195`): set the device budget and the stage
breakers' knobs, build the instrument registry, the Database (with
namespaces from config), the control plane (KV, the topology watcher and
shard migrator), bootstrap (local, then from peers), the RPC listener,
query federation (the QUERY_FETCH server and the remote stores),
self-monitoring and the SLO-burn controller, the mediator loop, and the
HTTP, carbon and admin front doors.  `Assembly.close()` tears down in
reverse order.

The controller registers the reference's actuators but one: the
``device_fallback`` actuator (``devguard.force_fallback``) switches
guarded stages onto their fallbacks, and the port's stages have none.

The node runs on ``device`` (None = CUDA; raises without a card).  The
reference's process-global env seams have no counterpart:
``coordinator.arena_layout`` becomes the downsampler's layout argument,
and ``coordinator.arena_ingest`` may only name what the port does anyway
(``auto``: each arena ingest routes by its tensor's device); any other
value is refused with a :class:`ConfigError`, never ignored.

Carbon has no acknowledgement channel: a batch the card refuses (a typed
``x.devguard.DeviceError`` from the buffer append, counted on its stage)
is dropped and the connection keeps serving, where the reference stages
it on the host.
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

def refuse_unported(cfg: NodeConfig) -> None:
    """Raise a ConfigError for an ``arena_ingest`` the port has no
    counterpart for (it routes each ingest by its tensor's device)."""
    if cfg.coordinator is not None and cfg.coordinator.arena_ingest not in (
            "", "auto"):
        raise ConfigError(
            f"coordinator.arena_ingest: {cfg.coordinator.arena_ingest!r} has "
            "no counterpart (each arena ingest routes by its tensor's "
            "device, the reference's 'auto')")


@dataclasses.dataclass
class Assembly:
    config: NodeConfig
    registry: "instrument.Registry"
    db: Database
    mediator: Mediator | None
    http_server: object | None
    carbon_server: object | None = None
    tracer: object | None = None
    admin_server: object | None = None
    kv: object | None = None
    rpc_server: object | None = None
    peer_handles: list = dataclasses.field(default_factory=list)
    scrubber: object | None = None
    topology: object | None = None   # cluster.topology.TopologyWatcher
    migrator: object | None = None   # storage.migration.ShardMigrator
    query_server: object | None = None  # query.remote.QueryServer
    remote_stores: list = dataclasses.field(default_factory=list)
    downsampler: object | None = None   # coordinator.downsample.Downsampler
    checkpointer: object | None = None  # aggregator.checkpoint.AggregatorCheckpointer
    selfmon: object | None = None       # instrument.selfmon.SelfMonitor
    controller: object | None = None    # x.controller.Controller

    @property
    def port(self) -> int | None:
        return self.http_server.server_address[1] if self.http_server else None

    @property
    def rpc_port(self) -> int | None:
        return self.rpc_server.port if self.rpc_server else None

    @property
    def query_port(self) -> int | None:
        return self.query_server.port if self.query_server else None

    @property
    def carbon_port(self) -> int | None:
        return self.carbon_server.port if self.carbon_server else None

    @property
    def admin_port(self) -> int | None:
        return self.admin_server.server_address[1] if self.admin_server else None

    def close(self) -> None:
        """Release the peer handles and remote stores, stop the
        listeners (query, RPC, admin, carbon, HTTP), join the mediator (a
        pass in flight finishes first), release the migrator, the
        topology watch and the KV client, then close the database."""
        for h in self.peer_handles:
            h.close()
        self.peer_handles = []
        for r in self.remote_stores:
            r.close()
        self.remote_stores = []
        for attr in ("query_server", "rpc_server", "admin_server",
                     "carbon_server", "http_server"):
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
        for attr in ("carbon_server", "http_server"):
            srv = getattr(self, attr)
            if srv is not None:
                srv.shutdown()
                srv.server_close()
                setattr(self, attr, None)
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


def _build_controller(cfg: NodeConfig, asm: Assembly, db, admission, scope):
    """The SLO-burn controller in the reference's order of actuators and
    bindings, less ``device_fallback`` (see the module docstring)."""
    from m3_tpu_torch.x import controller as xctl
    from m3_tpu_torch.x import membudget as _mb

    ccfg = cfg.controller
    slo = asm.selfmon.slo
    known = set(slo.rules())
    reg = xctl.ActuatorRegistry()
    bindings: list = []

    def _bind(rule: str, acts: list, name: str = "", **kw) -> None:
        if rule and rule in known and acts:
            bindings.append(xctl.Binding(
                rule=rule, actuators=tuple(acts),
                name=name or rule,
                fire_ticks=ccfg.fire_ticks,
                clear_ticks=ccfg.clear_ticks,
                clear_burn=ccfg.clear_burn,
                hold_ticks=ccfg.hold_ticks, **kw))

    slot_acts = []
    if admission is not None:
        reg.register(xctl.admission_actuator(
            admission, floor=ccfg.query_floor, step=ccfg.query_step))
        slot_acts = ["query_slots"]
    _bind(ccfg.query_rule, slot_acts, name="query-burn")
    _bind(ccfg.ingest_rule, slot_acts, name="ingest-burn")
    dev_acts = []
    if asm.checkpointer is not None:
        dev_acts.append(reg.register(
            xctl.checkpoint_actuator(asm.checkpointer)).name)
    budget_b = _mb.budget()
    if budget_b > 0:
        floor_b = int(budget_b * ccfg.mem_floor_frac)
        step_b = max(1, (budget_b - floor_b) // ccfg.mem_steps)
        dev_acts.append(reg.register(xctl.membudget_actuator(
            floor_bytes=floor_b, step_bytes=step_b)).name)
    _bind(ccfg.device_rule, dev_acts, name="device-burn")
    if asm.migrator is not None:
        reg.register(xctl.rebalance_actuator(asm.migrator))
        _bind(ccfg.node_rule, ["rebalance"], name="node-burn",
              sustain_window=ccfg.sustain_window,
              sustain_burn=ccfg.sustain_burn)
    if cfg.disk.enabled:
        # Disk-burn → a cleanup PULSE: the watermark gate sheds ingest on
        # its own; the controller's job is to force a reclaim pass the
        # cadence wouldn't run yet.
        reg.register(xctl.emergency_cleanup_actuator(
            lambda: db.cleanup(_time.time_ns())))
        _bind(ccfg.disk_rule, ["emergency_cleanup"], name="disk-burn")
    return xctl.Controller(
        reg, bindings, burn_source=slo.status,
        instrument=scope,
        min_interval_s=parse_duration(ccfg.min_action_interval) / 1e9,
        history=xctl.BurnHistory(
            slo.engine,
            metric=f"{cfg.metrics_prefix}_slo_burn",
            deadline_s=parse_duration(ccfg.history_deadline) / 1e9))


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


def carbon_sink(db, ns_name: str, downsampler=None):
    """The carbon listener's sink: the same downsample-then-write path
    as HTTP writes (the reference's carbon ingester feeds the
    downsampler too), so rules apply whatever the ingest protocol."""
    import numpy as np

    from m3_tpu_torch.storage.database import ShardNotOwnedError
    from m3_tpu_torch.x.devguard import DeviceError

    def sink(docs, ts, vals):
        keep = None
        if downsampler is not None:
            keep = downsampler.write_batch(docs, ts, vals)
        if keep is not None:
            idx = np.nonzero(keep)[0]
            if not len(idx):
                return
            docs = [docs[i] for i in idx]
            ts, vals = ts[idx], vals[idx]
        try:
            db.write_tagged_batch(ns_name, docs, ts, vals)
        except ShardNotOwnedError:
            # Placement-scoped node fed carbon traffic for shards it does
            # not own: carbon has no ack channel to push back on, and the
            # connection thread must survive (mixed batches partial-accept
            # inside write_batch; only an ALL-unowned flush lands here).
            # Counted via db's shard_not_owned.
            pass
        except DeviceError:
            # The card refused the append (counted on the
            # storage.buffer_append stage); nothing was logged or
            # acknowledged, and the connection goes on serving.
            _LOG.warning("carbon: dropped a batch of %d samples the "
                         "device refused", len(docs), exc_info=True)

    return sink


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
    # Device-boundary knobs FIRST: the memory budget must be installed
    # before any arena/buffer reserves against it, and the stage
    # breakers bind their thresholds at first guarded call.
    from m3_tpu_torch.x import devguard as _devguard, membudget as _membudget

    _membudget.set_budget(cfg.device.mem_budget)
    _devguard.configure(
        failures=cfg.device.breaker_failures,
        reset_s=parse_duration(cfg.device.breaker_reset) / 1e9)
    # Disk ledger next (membudget's twin): armed before the Database
    # exists so the very first mediator tick refreshes real watermarks.
    # reset() when disabled — the ledger is process-global and a prior
    # in-process node's configuration must not leak into this one.
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
    if cfg.selfmon.enabled and cfg.selfmon.namespace not in namespaces:
        # Auto-provision the reserved self-monitoring namespace as an
        # ordinary db.namespaces entry (declare it in config to tune
        # retention/blocks).  num_shards follows the serving namespace
        # so a placement installed by the topology watcher scopes it
        # identically — selfmon writes cross the same ownership gate
        # as user ingest.
        base = cfg.db.namespaces.get(
            cfg.coordinator.namespace if cfg.coordinator is not None
            else "default")
        namespaces[cfg.selfmon.namespace] = NamespaceOptions(
            num_shards=base.num_shards if base is not None else 4)
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
    # Tear down everything already started if a later step fails (e.g.
    # the carbon port is taken) — a half-built node must not leak its
    # mediator thread or bound socket.
    asm = Assembly(cfg, registry, db, None, None, tracer=tracer)
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

        # Query federation (query/remote): serve THIS node's storage to
        # peer coordinators over QUERY_FETCH, and/or federate peer
        # coordinators' stores into this node's engine.  Each remote
        # gets the process-shared per-peer circuit breaker so a dead
        # region fails fast for every query at once.
        ns0 = (cfg.coordinator.namespace if cfg.coordinator is not None
               else "default")
        if cfg.query.listen_port is not None:
            from m3_tpu_torch.query.remote import serve_query_background
            from m3_tpu_torch.query.storage_adapter import DatabaseStorage

            asm.query_server = serve_query_background(
                DatabaseStorage(db, ns0),
                host=(cfg.coordinator.listen_host
                      if cfg.coordinator is not None else "127.0.0.1"),
                port=cfg.query.listen_port,
                tracer=tracer,
            )
        if cfg.query.remotes:
            from m3_tpu_torch.query.remote import RemoteStorage
            from m3_tpu_torch.x.breaker import breaker_for

            breaker_reset_s = parse_duration(cfg.query.breaker_reset) / 1e9
            asm.remote_stores = [
                RemoteStorage(
                    (h, int(p)),
                    timeout_s=parse_duration(cfg.query.default_timeout) / 1e9,
                    breaker=breaker_for(
                        f"query:{h}:{p}",
                        failure_threshold=cfg.query.breaker_failures,
                        reset_timeout_s=breaker_reset_s),
                )
                for h, _, p in (a.rpartition(":") for a in cfg.query.remotes)
            ]

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

        # Self-monitoring BEFORE the mediator: the scrape task rides
        # the tick loop, and its SLO evaluator binds the selfmon
        # namespace engine at construction.
        if cfg.selfmon.enabled:
            from m3_tpu_torch.instrument.selfmon import SelfMonitor
            from m3_tpu_torch.query.slo import default_rules, rule_from_dict

            rules = (default_rules(cfg.metrics_prefix)
                     if cfg.selfmon.default_rules else [])
            rules += [rule_from_dict(r) for r in cfg.selfmon.rules]
            asm.selfmon = SelfMonitor(
                db, registry,
                namespace=cfg.selfmon.namespace,
                instance=(cfg.selfmon.instance or cfg.db.instance_id
                          or "self"),
                budget=cfg.selfmon.budget,
                peers=cfg.selfmon.peers,
                scrape_timeout_s=parse_duration(
                    cfg.selfmon.scrape_timeout) / 1e9,
                slo_rules=rules,
                slo_deadline_s=parse_duration(
                    cfg.selfmon.slo_deadline) / 1e9,
                instrument=scope,
            )

        # Admission is shared by the HTTP front door and the
        # controller's query_slots actuator — build it before either
        # consumer exists.
        admission = None
        if cfg.coordinator is not None:
            from m3_tpu_torch.x.admission import AdmissionController

            admission = AdmissionController(
                max_concurrent=cfg.query.max_concurrent,
                max_queue=cfg.query.max_queue,
                queue_timeout_s=parse_duration(cfg.query.queue_timeout) / 1e9,
            )

        # The self-healing control plane BEFORE the mediator (its pass
        # rides the tick loop right after the selfmon stage, acting on
        # the verdicts evaluated the same tick).  Bindings resolve by
        # rule NAME against the evaluator's configured rule set
        # (slo.rules()) — an unconfigured name simply does not bind.
        if (cfg.controller.enabled and asm.selfmon is not None
                and getattr(asm.selfmon, "slo", None) is not None):
            asm.controller = _build_controller(cfg, asm, db, admission, scope)

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
                selfmon=asm.selfmon,
                selfmon_every=cfg.selfmon.every,
                controller=asm.controller,
                controller_every=cfg.controller.every,
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
                remotes=asm.remote_stores,
                remotes_required=cfg.query.remotes_required,
                checkpointer=asm.checkpointer,
                migrator=asm.migrator,
                selfmon=asm.selfmon,
                controller=asm.controller,
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
                and cfg.coordinator.carbon_listen_port is not None):
            from m3_tpu_torch.metrics.carbon import serve_carbon_background

            asm.carbon_server = serve_carbon_background(
                carbon_sink(db, cfg.coordinator.namespace, downsampler),
                cfg.coordinator.listen_host, cfg.coordinator.carbon_listen_port,
                instrument=scope,
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
