"""Typed YAML configuration with env expansion and validation.

Equivalent of the reference's `src/x/config` (YAML + go-validator struct
tags + env-var expansion, `x/config/config.go`) and the one-big-typed
`Configuration` per service (`cmd/services/m3dbnode/config/config.go:101-113`
— a node can run DB + coordinator from one file).  Dataclasses replace
struct tags; `validate()` raises one error naming every bad field, like
go-validator's aggregated messages.

Durations are human strings ("10s", "2h", "30d") parsed to nanos —
the YAML-facing analogue of Go's time.Duration fields.

The port's copy of ``m3_tpu/core/config.py``: the same sections, fields,
defaults and validation messages.  PyYAML is imported only inside
:func:`load_config`; without it, ``load_config`` reads JSON text (which
YAML 1.2 parses to the same mapping) and refuses anything else with a
:class:`ConfigError` naming PyYAML.  The selfmon peer and SLO-rule checks
are copies of ``m3_tpu/instrument/selfmon.parse_peer`` and
``m3_tpu/query/slo.rule_from_dict``'s validation, since neither module is
ported.  Which sections a node built by the port can run is
``server/assembly.run_node``'s business: it refuses the rest by name.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from pathlib import Path
from typing import Dict, Optional

_DUR_RE = re.compile(r"^(\d+(?:\.\d+)?)(ns|us|ms|s|m|h|d|w)$")
_UNIT_NANOS = {
    "ns": 1, "us": 10**3, "ms": 10**6, "s": 10**9,
    "m": 60 * 10**9, "h": 3600 * 10**9, "d": 86400 * 10**9,
    "w": 7 * 86400 * 10**9,
}
_ENV_RE = re.compile(r"\$\{([A-Za-z_][A-Za-z0-9_]*)(?::([^}]*))?\}")


class ConfigError(ValueError):
    pass


def parse_duration(v) -> int:
    """"2h" → nanos; ints pass through as nanos already."""
    if isinstance(v, int):
        return v
    m = _DUR_RE.match(str(v).strip())
    if not m:
        raise ConfigError(f"bad duration {v!r} (want e.g. '10s', '2h')")
    return int(float(m.group(1)) * _UNIT_NANOS[m.group(2)])


def _expand_env(text: str) -> str:
    """${VAR} / ${VAR:default} expansion (x/config envExpand)."""
    def sub(m):
        val = os.environ.get(m.group(1))
        if val is None:
            if m.group(2) is None:
                raise ConfigError(f"config references unset env var {m.group(1)}")
            return m.group(2)
        return val
    return _ENV_RE.sub(sub, text)


def _check_peer(entry) -> None:
    """``host:port`` or ``name=host:port`` (selfmon.parse_peer's check)."""
    entry = str(entry).strip()
    name, sep, addr = entry.partition("=")
    if not sep:
        name, addr = entry, entry
    host, _, port = addr.rpartition(":")
    if (not name or not host or not port.isdigit()
            or not (0 < int(port) < 65536)):
        raise ValueError(
            f"selfmon peer {entry!r}: expected 'host:port' or "
            "'name=host:port'")


def _check_burn_window(long: str, short: str, factor: float) -> None:
    for f, v in (("long", long), ("short", short)):
        try:
            parse_duration(v)
        except ConfigError as e:
            raise ValueError(f"burn window {f}: {e}") from None
    if parse_duration(short) > parse_duration(long):
        raise ValueError(
            f"burn window short {short!r} exceeds long {long!r}")
    if factor <= 0:
        raise ValueError("burn window factor must be > 0")


def _check_slo_rule(d: dict) -> None:
    """slo.rule_from_dict's validation: the same checks, in the same
    order, with the same messages."""
    unknown = set(d) - {"name", "objective", "ratio", "windows"}
    if unknown:
        raise ValueError(f"SLO rule: unknown keys {sorted(unknown)}")
    n_windows = 2  # the SRE-workbook default ladder
    if "windows" in d:
        n_windows = 0
        for i, w in enumerate(d["windows"]):
            bad = set(w) - {"long", "short", "factor"}
            if bad:
                raise ValueError(
                    f"SLO rule window #{i}: unknown keys {sorted(bad)}")
            missing = {"long", "short", "factor"} - set(w)
            if missing:
                raise ValueError(
                    f"SLO rule window #{i}: missing keys {sorted(missing)}")
            _check_burn_window(str(w["long"]), str(w["short"]),
                               float(w["factor"]))
            n_windows += 1
    try:
        name = str(d.get("name", ""))
        objective = float(d.get("objective", 0.0))
        ratio = str(d.get("ratio", ""))
        if not name:
            raise ValueError("SLO rule needs a name")
        if not (0.0 < objective < 1.0):
            raise ValueError(
                f"rule {name}: objective must be in (0, 1), "
                f"got {objective}")
        if "{window}" not in ratio:
            raise ValueError(
                f"rule {name}: ratio template must contain '{{window}}'")
        if not n_windows:
            raise ValueError(f"rule {name}: at least one burn window")
    except ValueError as e:
        raise ValueError(f"SLO rule {d.get('name', '?')!r}: {e}") from None


@dataclasses.dataclass
class NamespaceConfig:
    retention: str = "48h"
    block_size: str = "2h"
    buffer_past: str = "10m"
    buffer_future: str = "2m"
    cold_writes_enabled: bool = True
    num_shards: int = 4
    resolution: str = "0s"  # 0 = raw/unaggregated namespace
    # Per-shard series/sample sizing (0 = the storage defaults).  The
    # slot capacity bounds ACTIVE series per shard — a node serving
    # high-cardinality soak/production traffic must be sized for it
    # (creations past the cap are rejected-and-counted, never stored).
    slot_capacity: int = 0
    sample_capacity: int = 0

    def validate(self, path: str, errs: list) -> None:
        for f in ("retention", "block_size", "buffer_past", "buffer_future",
                  "resolution"):
            try:
                parse_duration(getattr(self, f))
            except ConfigError as e:
                errs.append(f"{path}.{f}: {e}")
        if self.num_shards < 1:
            errs.append(f"{path}.num_shards: must be >= 1")
        for f in ("slot_capacity", "sample_capacity"):
            if getattr(self, f) < 0:
                errs.append(f"{path}.{f}: must be >= 0 (0 = default)")
        try:
            if parse_duration(self.block_size) > parse_duration(self.retention):
                errs.append(f"{path}: block_size exceeds retention")
        except ConfigError:
            pass


@dataclasses.dataclass
class LimitsConfig:
    """Per-query limits; 0 disables (reference storage/limits config)."""

    max_docs_matched: int = 0
    max_series_read: int = 0
    max_bytes_read: int = 0
    lookback: str = "5s"

    def validate(self, errs: list) -> None:
        try:
            parse_duration(self.lookback)
        except ConfigError as e:
            errs.append(f"db.limits.lookback: {e}")
        for f in ("max_docs_matched", "max_series_read", "max_bytes_read"):
            if getattr(self, f) < 0:
                errs.append(f"db.limits.{f}: must be >= 0")


@dataclasses.dataclass
class DBConfig:
    root: str = "m3tpu_data"
    commitlog_enabled: bool = True
    namespaces: Dict[str, NamespaceConfig] = dataclasses.field(
        default_factory=lambda: {"default": NamespaceConfig()}
    )
    limits: LimitsConfig = dataclasses.field(default_factory=LimitsConfig)
    # Cross-process data plane (server/rpc.py).  rpc_listen_port None
    # disables the RPC listener (single-node deployments); 0 binds an
    # ephemeral port (published via the node.json status file).  The
    # bind host defaults to loopback; multi-host deployments must set
    # rpc_listen_host (e.g. "0.0.0.0") or peer dials get ECONNREFUSED.
    # peers lists other replicas' RPC endpoints as "host:port"; when
    # bootstrap_peers is true the node's bootstrap chain ends with a
    # wire peers-bootstrap pass against them (reference
    # bootstrapper/peers/source.go).
    rpc_listen_host: str = "127.0.0.1"
    rpc_listen_port: Optional[int] = None
    peers: list = dataclasses.field(default_factory=list)
    bootstrap_peers: bool = False
    # External control plane (cluster/kv_remote.py): "host:port" of a
    # KV service shared by the cluster; None keeps the control plane
    # file-backed inside this node (single-node deployments).  The
    # reference's etcd endpoint role (client/etcd/client.go).
    kv_endpoint: Optional[str] = None
    # This node's identity in the cluster placement (the reference's
    # hostID, config.go HostID resolvers).  With an instance_id set the
    # node watches the placement key in KV and serves ONLY its assigned
    # shards — streaming INITIALIZING ones from their donor, cutting
    # them AVAILABLE, and dropping handed-off ones (see
    # storage/migration.py).  None keeps the own-every-shard behavior.
    instance_id: Optional[str] = None

    def validate(self, errs: list) -> None:
        if not self.namespaces:
            errs.append("db.namespaces: at least one namespace required")
        for name, ns in self.namespaces.items():
            ns.validate(f"db.namespaces.{name}", errs)
        self.limits.validate(errs)
        if self.rpc_listen_port is not None and not (
                0 <= self.rpc_listen_port < 65536):
            errs.append("db.rpc_listen_port: out of range")
        for p in self.peers:
            host, _, port = p.rpartition(":") if isinstance(p, str) else ("", "", "")
            if not host or not port.isdigit() or not (0 < int(port) < 65536):
                errs.append(f"db.peers: expected 'host:port', got {p!r}")
        if self.kv_endpoint is not None:
            host, _, port = self.kv_endpoint.rpartition(":")
            if not host or not port.isdigit() or not (0 < int(port) < 65536):
                errs.append(
                    f"db.kv_endpoint: expected 'host:port', got {self.kv_endpoint!r}")
        if self.bootstrap_peers and not self.peers:
            errs.append("db.bootstrap_peers requires db.peers")


@dataclasses.dataclass
class MediatorConfig:
    enabled: bool = True
    tick_interval: str = "10s"
    snapshot_every: int = 6
    cleanup_every: int = 6
    # Corruption scrub cadence: every scrub_every-th tick verifies up
    # to scrub_volumes fileset volumes (resumable cursor) and attempts
    # peer repair of quarantined holes.  scrub_volumes 0 disables the
    # background sweep (the admin endpoint still scrubs on demand).
    # Default rides the cleanup cadence (one pass/minute at 10s ticks):
    # verifying re-READS whole volumes, so an every-tick default would
    # be a permanent background read load competing with query I/O.
    scrub_every: int = 6
    scrub_volumes: int = 4
    # Shard-migration cadence: every migrate_every-th tick streams up
    # to migrate_blocks missing fileset blocks into INITIALIZING shards
    # (0 = unbudgeted) and advances LEAVING-drop grace countdowns; a
    # dropped shard's data is deleted migrate_grace_ticks migration
    # passes after its cutover is observed.
    migrate_every: int = 1
    migrate_blocks: int = 4
    migrate_grace_ticks: int = 2

    def validate(self, errs: list) -> None:
        try:
            parse_duration(self.tick_interval)
        except ConfigError as e:
            errs.append(f"mediator.tick_interval: {e}")
        if self.scrub_every < 1:
            errs.append("mediator.scrub_every: must be >= 1")
        if self.scrub_volumes < 0:
            errs.append("mediator.scrub_volumes: must be >= 0")
        if self.migrate_every < 1:
            errs.append("mediator.migrate_every: must be >= 1")
        if self.migrate_blocks < 0:
            errs.append("mediator.migrate_blocks: must be >= 0")
        if self.migrate_grace_ticks < 0:
            errs.append("mediator.migrate_grace_ticks: must be >= 0")


@dataclasses.dataclass
class QueryConfig:
    """Read-path overload controls: the query-side mirror of the ingest
    load-shed contract.  Every query carries an end-to-end deadline
    (``timeout=`` param, defaulting to ``default_timeout``); admission
    control bounds concurrent queries (``max_concurrent`` slots, a
    ``max_queue``-deep wait queue shedding 503 after
    ``queue_timeout``); per-peer circuit breakers trip after
    ``breaker_failures`` consecutive transport/deadline failures and
    probe again after ``breaker_reset``.  ``listen_port`` serves this
    node's storage to peer coordinators over the QUERY_FETCH protocol;
    ``remotes`` federates their stores into this node's engine
    (best-effort unless ``remotes_required``)."""

    default_timeout: str = "30s"
    max_concurrent: int = 0          # 0 disables admission gating
    max_queue: int = 0
    queue_timeout: str = "1s"
    # log queries that spend more than this fraction of their deadline
    # (0 disables the slow-query log)
    slow_query_fraction: float = 0.75
    listen_port: Optional[int] = None  # None = no federation server
    remotes: list = dataclasses.field(default_factory=list)
    remotes_required: bool = False
    breaker_failures: int = 5
    breaker_reset: str = "10s"

    def validate(self, errs: list) -> None:
        for f in ("default_timeout", "queue_timeout", "breaker_reset"):
            try:
                parse_duration(getattr(self, f))
            except ConfigError as e:
                errs.append(f"query.{f}: {e}")
        for f in ("max_concurrent", "max_queue"):
            if getattr(self, f) < 0:
                errs.append(f"query.{f}: must be >= 0")
        if not (0.0 <= self.slow_query_fraction <= 1.0):
            errs.append("query.slow_query_fraction: must be in [0, 1]")
        if self.breaker_failures < 1:
            errs.append("query.breaker_failures: must be >= 1")
        if self.listen_port is not None and not (
                0 <= self.listen_port < 65536):
            errs.append("query.listen_port: out of range")
        for p in self.remotes:
            host, _, port = (p.rpartition(":") if isinstance(p, str)
                             else ("", "", ""))
            if not host or not port.isdigit() or not (0 < int(port) < 65536):
                errs.append(f"query.remotes: expected 'host:port', got {p!r}")


@dataclasses.dataclass
class DeviceConfig:
    """Device-boundary resilience knobs (x/devguard + x/membudget).

    ``mem_budget`` caps the bytes the process's device-resident
    structures (arenas, series buffers, control tables, big transient
    stage buffers) may reserve — 0 disables admission; accepts plain
    bytes or K/M/G/T-suffixed strings (binary units).  Over-budget
    construction rejects typed (DeviceBudgetExceeded) instead of
    OOM-crashing inside XLA.  ``breaker_failures``/``breaker_reset``
    are the per-stage fallback breakers' trip threshold and open →
    half-open cool-down (the query breaker knobs' shape)."""

    mem_budget: str = "0"
    breaker_failures: int = 5
    breaker_reset: str = "10s"

    def validate(self, errs: list) -> None:
        from m3_tpu_torch.x.diskbudget import parse_bytes

        try:
            parse_bytes(self.mem_budget)
        except ValueError as e:
            errs.append(f"device.mem_budget: {e}")
        if self.breaker_failures < 1:
            errs.append("device.breaker_failures: must be >= 1")
        try:
            parse_duration(self.breaker_reset)
        except ConfigError as e:
            errs.append(f"device.breaker_reset: {e}")


@dataclasses.dataclass
class DiskConfig:
    """Disk-capacity resilience knobs (x/diskbudget + persist/capacity).

    ``capacity`` treats ``db.root`` as a quota of that many bytes (byte
    count or K/M/G/T-suffixed string, binary units) — 0 means headroom
    comes from ``os.statvfs`` (production: the root owns its
    filesystem).  ``reserve`` is the flush-headroom band: free bytes
    at/below it are CRITICAL regardless of ratio, so cold flush, WAL
    appends and the final-drain snapshot always have room to complete.
    ``low_ratio``/``critical_ratio`` are the free-ratio watermarks: LOW
    runs cleanup eagerly on the mediator tick, CRITICAL additionally
    sheds NEW ingest typed (DiskCapacityError → backoff) while reads
    and flushes keep serving.  ``enabled: false`` leaves the ledger
    disarmed (no walks, no gauges, no shedding)."""

    enabled: bool = False
    capacity: str = "0"
    reserve: str = "64M"
    low_ratio: float = 0.25
    critical_ratio: float = 0.10

    def validate(self, errs: list) -> None:
        from m3_tpu_torch.x.diskbudget import parse_bytes

        for f in ("capacity", "reserve"):
            try:
                parse_bytes(getattr(self, f))
            except ValueError as e:
                errs.append(f"disk.{f}: {e}")
        if not (0.0 <= self.critical_ratio <= self.low_ratio <= 1.0):
            errs.append(
                "disk: want 0 <= critical_ratio <= low_ratio <= 1, got "
                f"critical={self.critical_ratio} low={self.low_ratio}")


@dataclasses.dataclass
class SelfmonConfig:
    """Self-monitoring (instrument/selfmon.py): the node scrapes its
    own registry — and, in fleet mode, its peers' ``/metrics`` — into
    the reserved ``namespace`` through the real write path on the
    mediator tick cadence, and evaluates multi-window multi-burn-rate
    SLO rules (query/slo.py) over the stored history.

    ``every`` = mediator ticks per scrape cycle; ``budget`` = hard
    per-source series cap per cycle (deterministic sorted survivors,
    excess counted, never written); ``peers`` lists fleet-scrape
    targets as ``host:port`` or ``name=host:port``; ``rules`` are SLO
    rule dicts (``{name, objective, ratio, windows}``) layered on top
    of the built-ins when ``default_rules`` is true.  The namespace is
    auto-provisioned as a ``db.namespaces`` entry when absent —
    declare it explicitly to tune retention/blocks."""

    enabled: bool = False
    every: int = 1
    namespace: str = "_m3_selfmon"
    budget: int = 2000
    instance: str = ""          # instance tag (default: db.instance_id)
    peers: list = dataclasses.field(default_factory=list)
    scrape_timeout: str = "2s"
    slo_deadline: str = "2s"
    default_rules: bool = True
    rules: list = dataclasses.field(default_factory=list)

    def validate(self, errs: list) -> None:
        if self.every < 1:
            errs.append("selfmon.every: must be >= 1")
        if self.budget < 0:
            errs.append("selfmon.budget: must be >= 0 (0 = unbudgeted)")
        if not self.namespace:
            errs.append("selfmon.namespace: must be non-empty")
        for f in ("scrape_timeout", "slo_deadline"):
            try:
                parse_duration(getattr(self, f))
            except ConfigError as e:
                errs.append(f"selfmon.{f}: {e}")
        for p in self.peers:
            try:
                _check_peer(p)
            except ValueError as e:
                errs.append(f"selfmon.peers: {e}")
        for i, r in enumerate(self.rules):
            try:
                _check_slo_rule(r)
            except (ValueError, TypeError) as e:
                errs.append(f"selfmon.rules[{i}]: {e}")


@dataclasses.dataclass
class ControllerConfig:
    """SLO-burn-driven self-healing (x/controller.py): a mediator-tick
    control plane that reads the node's own selfmon burn verdicts and
    acts through the typed actuator registry — shed query slots on
    query burn, evacuate the device path + pre-checkpoint on device
    burn, pulse a placement rebalance on SUSTAINED node burn — then
    relaxes every action back to baseline half-open on recovery.

    Requires ``selfmon.enabled`` (the verdicts are the sensor).  Rule
    bindings are by NAME against the evaluator's configured rule set
    (``slo.rules()``): a named rule that is not configured is simply
    not bound.  All hysteresis knobs are in mediator-controller ticks
    (``every`` mediator ticks per controller pass)."""

    enabled: bool = False
    every: int = 1                    # mediator ticks per controller pass
    fire_ticks: int = 2               # consecutive firing verdicts to act
    clear_ticks: int = 3              # consecutive clear verdicts to relax
    clear_burn: float = 1.0           # burn multiple at/under which "clear"
    hold_ticks: int = 2               # post-shed ticks before relax starts
    min_action_interval: str = "5s"   # per-actuator rate limit
    history_deadline: str = "1s"      # PromQL budget for sustained reads
    # rule-name bindings ("" = do not bind)
    ingest_rule: str = "ingest-latency"
    query_rule: str = "query-latency"
    device_rule: str = ""
    node_rule: str = ""               # sustained burn -> rebalance pulse
    disk_rule: str = ""               # disk burn -> emergency cleanup pulse
    sustain_window: str = "120s"      # min_over_time window for node_rule
    sustain_burn: float = 1.0         # min sustained burn multiple to act
    # actuator envelopes
    query_floor: int = 2              # query-slot shed target
    query_step: int = 2               # slots per shed/relax step
    mem_floor_frac: float = 0.5       # membudget shed floor (x budget)
    mem_steps: int = 4                # steps from budget to floor

    def validate(self, errs: list) -> None:
        for f in ("every", "fire_ticks", "clear_ticks"):
            if getattr(self, f) < 1:
                errs.append(f"controller.{f}: must be >= 1")
        if self.hold_ticks < 0:
            errs.append("controller.hold_ticks: must be >= 0")
        if self.clear_burn <= 0:
            errs.append("controller.clear_burn: must be > 0")
        for f in ("min_action_interval", "history_deadline",
                  "sustain_window"):
            try:
                parse_duration(getattr(self, f))
            except ConfigError as e:
                errs.append(f"controller.{f}: {e}")
        if self.sustain_burn < 0:
            errs.append("controller.sustain_burn: must be >= 0")
        if self.query_floor < 0:
            errs.append("controller.query_floor: must be >= 0")
        if self.query_step < 1:
            errs.append("controller.query_step: must be >= 1")
        if not (0.0 < self.mem_floor_frac <= 1.0):
            errs.append("controller.mem_floor_frac: must be in (0, 1]")
        if self.mem_steps < 1:
            errs.append("controller.mem_steps: must be >= 1")


# the reference's aggregator/arena.py INGEST_IMPLS (validation only)
INGEST_IMPLS = ("scatter", "pallas", "auto")


@dataclasses.dataclass
class CoordinatorConfig:
    listen_host: str = "127.0.0.1"
    listen_port: int = 0  # 0 = ephemeral
    namespace: str = "default"
    downsample: bool = False
    carbon_listen_port: Optional[int] = None  # None = no carbon listener
    admin_listen_port: Optional[int] = None   # None = no admin API
    tracing: bool = False
    # Aggregation-arena ingest implementation (the reference's process
    # seam).  The port routes by the tensor's device, which is the
    # reference's "auto"; run_node refuses "scatter" and "pallas".
    arena_ingest: str = ""
    # Aggregation-arena state layout of the downsampler's lists:
    # "" | auto -> packed (the sort/segment formulation); f64 = the
    # scatter-arena parity oracle (aggregator/arena.py + packed.py).
    arena_layout: str = ""
    # Aggregation-arena checkpointing (aggregator/checkpoint.py): the
    # downsampler's open windows are snapshotted bit-exactly to
    # <db.root>/checkpoint/aggregator.ckpt every N mediator ticks (and
    # on SIGTERM drain) and restored on boot — a SIGKILL mid-window
    # resumes instead of losing up to a resolution window of acked
    # samples.  0 disables (requires downsample: true to matter).
    checkpoint_every: int = 0

    def validate(self, errs: list) -> None:
        if not (0 <= self.listen_port < 65536):
            errs.append("coordinator.listen_port: out of range")
        if self.checkpoint_every < 0:
            errs.append("coordinator.checkpoint_every: must be >= 0")
        for f in ("carbon_listen_port", "admin_listen_port"):
            v = getattr(self, f)
            if v is not None and not (0 <= v < 65536):
                errs.append(f"coordinator.{f}: out of range")
        if self.arena_ingest:
            if self.arena_ingest not in INGEST_IMPLS:
                errs.append(
                    f"coordinator.arena_ingest: {self.arena_ingest!r} not "
                    f"one of {INGEST_IMPLS}")
        if self.arena_layout:
            from m3_tpu_torch.aggregator import arena  # LAYOUTS

            if self.arena_layout not in arena.LAYOUTS:
                errs.append(
                    f"coordinator.arena_layout: {self.arena_layout!r} not "
                    f"one of {arena.LAYOUTS}")


@dataclasses.dataclass
class NodeConfig:
    """One process = db + coordinator (+ mediator), the reference's
    combined dbnode/coordinator configuration (config.go:102-107)."""

    db: DBConfig = dataclasses.field(default_factory=DBConfig)
    coordinator: Optional[CoordinatorConfig] = dataclasses.field(
        default_factory=CoordinatorConfig
    )
    mediator: MediatorConfig = dataclasses.field(default_factory=MediatorConfig)
    query: QueryConfig = dataclasses.field(default_factory=QueryConfig)
    device: DeviceConfig = dataclasses.field(default_factory=DeviceConfig)
    disk: DiskConfig = dataclasses.field(default_factory=DiskConfig)
    selfmon: SelfmonConfig = dataclasses.field(default_factory=SelfmonConfig)
    controller: ControllerConfig = dataclasses.field(
        default_factory=ControllerConfig)
    metrics_prefix: str = "m3tpu"

    def validate(self) -> None:
        errs: list[str] = []
        self.db.validate(errs)
        if self.coordinator is not None:
            self.coordinator.validate(errs)
        self.mediator.validate(errs)
        self.query.validate(errs)
        self.device.validate(errs)
        self.disk.validate(errs)
        self.selfmon.validate(errs)
        self.controller.validate(errs)
        if self.controller.enabled and not self.selfmon.enabled:
            errs.append(
                "controller.enabled: requires selfmon.enabled (the burn "
                "verdicts are the controller's only sensor)")
        if (self.selfmon.enabled and self.coordinator is not None
                and self.selfmon.namespace == self.coordinator.namespace):
            errs.append(
                "selfmon.namespace: must not be the coordinator's serving "
                "namespace (self-monitoring series would mix into user data)")
        if errs:
            raise ConfigError("; ".join(errs))


# field name → nested dataclass (explicit, no annotation reflection)
_NESTED = {
    "db": DBConfig,
    "coordinator": CoordinatorConfig,
    "mediator": MediatorConfig,
    "query": QueryConfig,
    "device": DeviceConfig,
    "disk": DiskConfig,
    "selfmon": SelfmonConfig,
    "controller": ControllerConfig,
}
# Optional nested sections: an explicit `field: null` disables the
# subsystem (yields None) instead of instantiating defaults.
_NESTED_OPTIONAL = {"coordinator"}


def _build(cls, data, path: str):
    if data is None:
        return cls()
    if not isinstance(data, dict):
        raise ConfigError(f"{path}: expected mapping, got {type(data).__name__}")
    fields = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in data.items():
        if k not in fields:
            raise ConfigError(f"{path}.{k}: unknown field")
        if k == "limits" and cls is DBConfig:
            kwargs[k] = _build(LimitsConfig, v, f"{path}.limits")
        elif k == "namespaces":
            kwargs[k] = {
                name: _build(NamespaceConfig, nsv, f"{path}.namespaces.{name}")
                for name, nsv in (v or {}).items()
            }
        elif k in _NESTED:
            if v is None and k in _NESTED_OPTIONAL:
                kwargs[k] = None
            else:
                kwargs[k] = _build(_NESTED[k], v, f"{path}.{k}")
        else:
            kwargs[k] = v
    return cls(**kwargs)


def _parse_text(text: str):
    """YAML text → a mapping; JSON text when PyYAML is not installed."""
    try:
        import yaml
    except ImportError:
        try:
            return json.loads(text) if text.strip() else {}
        except ValueError:
            raise ConfigError(
                "config is not JSON text and PyYAML is not installed: "
                "install PyYAML or write the config as JSON") from None
    return yaml.safe_load(text)


def load_config(source) -> NodeConfig:
    """Parse + env-expand + validate a NodeConfig from a YAML (or JSON)
    path or string (x/config Load)."""
    text = Path(source).read_text() if isinstance(source, Path) or (
        isinstance(source, str) and "\n" not in source
        and source.endswith((".yml", ".yaml", ".json"))
    ) else str(source)
    data = _parse_text(_expand_env(text)) or {}
    cfg = _build(NodeConfig, data, "config")
    cfg.validate()
    return cfg
