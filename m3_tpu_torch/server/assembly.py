"""Config-driven server assembly: one call from NodeConfig to a running
node.  The port's counterpart of ``m3_tpu/server/assembly.py``.

Equivalent of the reference's monolithic startup
(`src/dbnode/server/server.go:171 Run`: config → pools → topology →
storage.NewDatabase → servers → bootstrap; and the query side
`src/query/server/query.go:195`): build the instrument registry, the
Database (with namespaces from config), bootstrap it, open the mediator
loop, and serve the HTTP API.  `Assembly.close()` tears down in reverse
order.

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
    ("db.rpc_listen_port", lambda c: c.db.rpc_listen_port is not None,
     "m3_tpu/server/rpc.py"),
    ("db.peers", lambda c: bool(c.db.peers),
     "m3_tpu/server/rpc.py and m3_tpu/storage/repair.py"),
    ("db.kv_endpoint", lambda c: c.db.kv_endpoint is not None,
     "m3_tpu/cluster/kv_remote.py"),
    ("db.instance_id", lambda c: c.db.instance_id is not None,
     "m3_tpu/cluster/topology.py and m3_tpu/storage/migration.py"),
    ("coordinator.admin_listen_port",
     lambda c: (c.coordinator is not None
                and c.coordinator.admin_listen_port is not None),
     "m3_tpu/server/admin_api.py"),
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
    scrubber: object | None = None
    downsampler: object | None = None   # coordinator.downsample.Downsampler
    checkpointer: object | None = None  # aggregator.checkpoint.AggregatorCheckpointer

    @property
    def port(self) -> int | None:
        return self.http_server.server_address[1] if self.http_server else None

    def close(self) -> None:
        """Stop the front door, join the mediator (a pass in flight
        finishes first), then close the database."""
        if self.http_server is not None:
            self.http_server.shutdown()
            self.http_server.server_close()
            self.http_server = None
        if self.mediator is not None:
            self.mediator.close()
            self.mediator = None
        self.db.close()

    def drain(self) -> None:
        """SIGTERM drain (the reference dbnode's graceful shutdown):
        stop taking ingest → persist what we hold → tear down.  This
        node owns every shard (no placement), so unlike the reference's
        drain there is no shard handoff to wait for."""
        if self.http_server is not None:
            self.http_server.shutdown()
            self.http_server.server_close()
            self.http_server = None
        if self.mediator is not None:
            self.mediator.close()
            self.mediator = None
        # Persist everything persistable: seal+flush whatever left the
        # warm window, snapshot the still-open buffers, rotate the WAL.
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

    Mirrors server.Run's order: config validate → storage → bootstrap →
    background maintenance → front door.  `ruleset` (a
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
        db.bootstrap()

        # Corruption scrubber: always constructed; attached to the
        # mediator loop only when a per-tick budget is configured.  No
        # peers: peer repair is not ported.
        from m3_tpu_torch.storage.scrub import Scrubber

        asm.scrubber = Scrubber(
            db, budget_volumes=cfg.mediator.scrub_volumes, instrument=scope,
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
    except BaseException:
        asm.close()
        raise
    return asm
