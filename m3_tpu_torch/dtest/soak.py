"""Million-series soak: the resilience substrate under production
intensity, measured.  The port's counterpart of ``m3_tpu/dtest/soak.py``.

The node carries deadlines, admission, breakers, migration,
quarantine/scrub and faultpoints, and a measurement substrate (fleet-
mergeable histograms, strict /metrics parsing).  This module is the
proving ground that turns both into NUMBERS: a dtest-tier load harness
that stands up a real multi-process cluster, drives sustained ingest of
a configurable series space (>=1M active series at full scale) plus
concurrent PromQL + Graphite query traffic, while a deterministic
chaos scheduler (x/chaos) injects a scripted timeline of peer death,
disk corruption, wire faults, a device-fault window and a rolling node
replace — and emits a BENCH-style SOAK artifact:

* fleet-merged p50/p99 ingest + query latency PER PHASE (healthy /
  each fault window / recovered), from strict-parsed /metrics scraped
  at phase boundaries (restart-aware counter deltas, partial-scrape
  flagged) plus the driver's own observations;
* shed/backoff/error rates and breaker/migration/quarantine counter
  deltas per phase;
* a **zero-acked-sample-loss verdict**: every write the session ACKED
  at Majority is re-read at Majority after recovery and compared value-
  for-value; sha256 digests over the sorted ledger and the sorted
  recovered projection make the verdict independently checkable.

Durability accounting is exact by construction: the workload generator
is a pure function of ``(series index, sweep, seed)``, so the ledger
stores acked BATCH DESCRIPTORS (sweep, slice, timestamp), not samples —
a million-series ledger is a few hundred tuples, and verification
regenerates the expected samples bit-for-bit.  Extra samples found in
the store but not in the ledger are possible and EXPECTED (a Majority-
failed write may still have landed on one replica; at-least-once
retries re-send) — they are counted (``unacked_extras``) but are not
loss.

Every node process runs on ``device`` (None = the CUDA card; the CPU
tests pass ``"cpu"``).  The device-fault window arms ``device.dispatch``
errors on node 0: its guarded stages fail typed and its buffer appends
are REFUSED (a typed error over RPC, 503 at the HTTP front door), so
nothing staged is ever acknowledged — the port has no host staging path
— and the verdict logic is the reference's: what was refused was never
acked, so it never enters the ledger.

``cli soak`` runs it; ``cli soak --smoke`` is the tier-1 shape
(2 nodes, ~20K series, one wire-fault window, under a minute);
``cli soak --check BASELINE`` re-runs the baseline's config and exits
nonzero on SLO/loss regression — the before/after gate for a rebuild
of the node's hot path.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import shutil
import socket
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from typing import Dict, List

import numpy as np

from m3_tpu_torch.x.chaos import ChaosEvent, ChaosScheduler

NS = "default"
SCHEMA = 1


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SoakConfig:
    nodes: int = 3            # initial cluster size (rf = min(3, nodes))
    series: int = 1_000_000   # bulk series space (active series >= this)
    batch: int = 10_000       # samples per ingest batch
    sweeps: int = 1           # minimum full passes over the series space
    max_sweeps: int = 12      # hard cap (chaos overrun guard)
    num_shards: int = 8
    # Per-shard active-series cap in the node config: the first 1M-run
    # hit the storage default (2^17/shard = 524K/node) as a wall of
    # rejected creations — nodes must be SIZED for the cardinality they
    # serve.  8 shards x 2^18 = 2M headroom over the 1M space + churn.
    slot_capacity: int = 1 << 18
    churn: float = 0.02       # fraction of series re-keyed per sweep
    seed: int = 10
    query_corpus: int = 200   # tagged series per engine (promql+graphite)
    query_interval_s: float = 2.0
    hist_series: int = 2000   # historical corpus (flushes to filesets —
    hist_points: int = 3      # the corruption/migration substrate)
    block_size: str = "6h"    # bulk blocks: long enough that a warm seal
    buffer_past: str = "30m"  # mid-run is unlikely (a 2h block sealing
    #                           1M series through the encoder would stall
    #                           every node for minutes on a small box)
    verify_batch: int = 20_000
    smoke: bool = False
    # phase durations (seconds); replace waits on cutover, recovered
    # lasts until the sweep target is met
    t_healthy: float = 60.0
    t_wire: float = 45.0
    t_kill: float = 60.0
    t_corrupt: float = 45.0
    wire_spec: str = "rpc.server=delay:ms=25:p=0.5;rpc.server=drop:p=0.1"
    # device-fault window (x/devguard seam): every guarded device
    # dispatch on the target node fails typed for t_device seconds —
    # the node refuses its buffer appends (never acknowledged; the port
    # stages nothing on the host), the stage breaker trips, and
    # the zero-acked-loss verdict must still hold (riding the soak's
    # own ledger).  0 disables the window.
    t_device: float = 30.0
    device_spec: str = "device.dispatch=error"
    replace: bool = True
    # Self-monitoring: every node scrapes itself — and, in
    # fleet mode, its peers — into the _m3_selfmon namespace through
    # the real write path on the mediator tick, so the soak's SLO
    # record is retro-queryable PromQL history instead of harness-side
    # scrape diffs.  selfmon_windows are the burn-rate rule windows,
    # soak-scaled (a 14.4x-over-1h page rule would never fire inside a
    # minutes-long run).
    selfmon: bool = True
    selfmon_budget: int = 4000
    selfmon_long: str = "120s"
    selfmon_short: str = "30s"
    # extra SLO rule dicts appended to every node's selfmon config
    # (the acceptance dtest injects a wire-error burn rule here)
    selfmon_extra_rules: list = dataclasses.field(default_factory=list)
    # Self-healing: the x/controller control plane rides
    # every node's mediator tick whenever selfmon is on.  Its trigger
    # is a DEDICATED error-ratio rule ("ingest-errors": the share of
    # rpc write frames dropped at the wire), appended next to the
    # recorded latency SLOs — an error ratio is exactly 0.0 on a
    # healthy run, so the smoke pin (controller enabled, ZERO actions)
    # can never flake on a slow box's latency blips, while the
    # recorded 0.25s-lane SLO stays the honest latency record.  The
    # 0.90 objective (budget 0.1, factor 1.0) fires at >10% dropped
    # frames: the smoke wire window (drop p=0.05) stays below it, the
    # selfheal sustained window (drop p=0.4) blows through it.
    controller: bool = True
    controller_fire_ticks: int = 3
    controller_clear_ticks: int = 3
    controller_hold_ticks: int = 2
    controller_min_interval: str = "3s"
    # selfheal phase: a ``sustained`` chaos event (arm + hold +
    # auto-disarm as ONE timeline entry) hard enough to trip the
    # controller; off by default so the pinned phase-label lists of
    # the full and smoke shapes stay exactly as committed.
    selfheal: bool = False
    t_selfheal: float = 45.0
    selfheal_spec: str = "rpc.server=drop:p=0.4"
    # Disk-pressure resilience: with disk_capacity set, each
    # node runs its x/diskbudget ledger in capacity-quota mode (the
    # nodes share one real filesystem, so statvfs would watermark them
    # all at once) and the timeline gains a disk_pressure window:
    # ballast-fill node 1's root to disk_spec (a target FREE ratio),
    # hold t_disk seconds, auto-release.  The reserve is deliberately
    # small — soak quotas are hundreds of MB, and the 64M production
    # default would put CRITICAL at absurdly high free ratios.
    # disk_rule optionally binds the controller's emergency_cleanup
    # pulse to the disk-pressure SLO rule ("" = record-only).
    disk_capacity: str = ""   # per-node byte quota; "" = ledger off
    disk_reserve: str = "4M"
    disk_low: float = 0.25
    disk_crit: float = 0.10
    t_disk: float = 0.0       # disk-pressure window seconds; 0 = off
    disk_spec: str = "0.18"   # ballast target free ratio (LOW, not crit)
    disk_rule: str = ""       # controller disk binding rule name

    @classmethod
    def smoke_config(cls, **kw) -> "SoakConfig":
        """The tier-1 shape: 2 nodes, ~20K series, one wire-fault
        window, no kill/corrupt/replace — generator, chaos scheduler,
        ledger verify and artifact schema exercised end to end in well
        under a minute of load."""
        base = dict(
            nodes=2, series=20_000, batch=2_000, sweeps=2, num_shards=2,
            slot_capacity=1 << 16, churn=0.05, query_corpus=40,
            query_interval_s=1.0,
            hist_series=200, hist_points=2, verify_batch=5_000, smoke=True,
            t_healthy=6.0, t_wire=10.0, t_kill=0.0, t_corrupt=0.0,
            t_device=8.0,
            wire_spec="rpc.server=delay:ms=10:p=0.4;rpc.server=drop:p=0.05",
            replace=False,
            # short disk-pressure window: ballast to free=0.18 — LOW
            # (eager cleanup, ledger visible) but above CRITICAL, so
            # nothing sheds and the quiet-controller pin still holds
            disk_capacity="192M", t_disk=6.0,
        )
        base.update(kw)
        return cls(**base)

    @property
    def rf(self) -> int:
        return min(3, self.nodes)


def build_timeline(cfg: SoakConfig) -> List[ChaosEvent]:
    """The scripted chaos: phase marks bucket the SLOs, fault events
    ride between them.  Offsets are fixed by config — same config +
    seed = same chaos (the determinism contract TESTING.md documents).

    Full shape:  healthy → wire_faults (delay+drop at the rpc server
    boundary of node 1) → sigkill (node nodes-1 killed cold, restarted
    mid-window: WAL replay + peers bootstrap under load) → corrupt
    (byte-flipped flushed fileset on node 1 → scrub → quarantine → peer
    repair) → replace (rolling replace of node nodes-1 by the spare
    through the migration path) → recovered."""
    ev: List[ChaosEvent] = []
    t = 0.0
    ev.append(ChaosEvent(t, "phase", arg="healthy"))
    t += cfg.t_healthy
    ev.append(ChaosEvent(t, "phase", arg="wire_faults"))
    ev.append(ChaosEvent(t + 1, "wire_fault", node=1 % cfg.nodes,
                         arg=cfg.wire_spec))
    t += cfg.t_wire
    ev.append(ChaosEvent(t - 1, "clear_faults", node=1 % cfg.nodes))
    if cfg.t_device > 0:
        # Device-boundary faults on node 0 (always a write target of
        # the replicated session): guarded stages fail typed, its
        # buffer appends are refused (never acknowledged), breakers
        # trip — acked samples must all verify after the window clears.
        ev.append(ChaosEvent(t, "phase", arg="device_faults"))
        ev.append(ChaosEvent(t + 1, "device_fault", node=0,
                             arg=cfg.device_spec))
        t += cfg.t_device
        ev.append(ChaosEvent(t - 1, "clear_faults", node=0))
    if cfg.t_disk > 0 and cfg.disk_capacity:
        # Disk-pressure window: one windowed event ballast-fills node
        # 1's root to the target free ratio and auto-releases 2s before
        # the phase ends, so 'recovered' (or the next window) starts
        # with the ledger relaxing back.
        ev.append(ChaosEvent(t, "phase", arg="disk_pressure"))
        ev.append(ChaosEvent(t + 1, "disk_pressure", node=1 % cfg.nodes,
                             arg=cfg.disk_spec,
                             hold_s=max(1.0, cfg.t_disk - 3)))
        t += cfg.t_disk
    victim = cfg.nodes - 1
    if cfg.t_kill > 0:
        ev.append(ChaosEvent(t, "phase", arg="sigkill"))
        ev.append(ChaosEvent(t + 1, "kill", node=victim))
        ev.append(ChaosEvent(t + max(2.0, cfg.t_kill * 0.4), "restart",
                             node=victim))
        t += cfg.t_kill
    if cfg.t_corrupt > 0:
        ev.append(ChaosEvent(t, "phase", arg="corrupt"))
        ev.append(ChaosEvent(t + 1, "corrupt", node=1 % cfg.nodes))
        t += cfg.t_corrupt
    if cfg.replace:
        ev.append(ChaosEvent(t, "phase", arg="replace"))
        ev.append(ChaosEvent(t + 1, "replace", node=victim))
        t += 2  # replace blocks until cutover; recovered marks after it
    if cfg.selfheal and cfg.t_selfheal > 0:
        # One ``sustained`` entry: arm the heavy drop spec on node 1,
        # hold long enough for the controller to shed, auto-disarm 2s
        # before the phase ends so the recovered window starts clean.
        ev.append(ChaosEvent(t, "phase", arg="selfheal"))
        ev.append(ChaosEvent(t + 1, "sustained", node=1 % cfg.nodes,
                             arg=cfg.selfheal_spec,
                             hold_s=max(1.0, cfg.t_selfheal - 3)))
        t += cfg.t_selfheal
    ev.append(ChaosEvent(t, "phase", arg="recovered"))
    return ev


# ---------------------------------------------------------------------------
# workload generator (columnar, pure function of (index, sweep, seed))
# ---------------------------------------------------------------------------

_MIX = 2654435761  # Knuth multiplicative hash


class WorkloadGen:
    """Deterministic columnar sample generator.

    Three value families striped across the series space by index:
    gauge noise (hash-mixed), monotonic counters (sweep-scaled), and
    spiky (quiet baseline with periodic 1e6 spikes).  A seeded ``churn``
    subset re-keys every sweep (``.g<sweep>`` suffix) — sustained NEW
    series creation, the pressure the new-series limiter and index
    exist to absorb.  Everything is a pure function of
    ``(index, sweep, seed)`` so the soak ledger can store slice
    descriptors and regenerate expected samples exactly at verify
    time."""

    def __init__(self, series: int, churn: float = 0.02, seed: int = 0):
        self.series = int(series)
        self.churn = float(churn)
        self.seed = int(seed)

    def _churned(self, idx: np.ndarray) -> np.ndarray:
        return ((idx * _MIX + self.seed * 1013904223) % 100_000
                < self.churn * 100_000)

    def ids(self, sweep: int, lo: int, hi: int) -> List[bytes]:
        idx = np.arange(lo, hi)
        gens = np.where(self._churned(idx), sweep, 0)
        return [b"soak.%08d.g%03d" % (i, g)
                for i, g in zip(idx.tolist(), gens.tolist())]

    def values(self, sweep: int, lo: int, hi: int) -> np.ndarray:
        idx = np.arange(lo, hi, dtype=np.int64)
        fam = idx % 3
        gauge = ((idx * _MIX + (sweep + self.seed) * 40503)
                 & 0xFFFFF).astype(np.float64) / 1048.576
        counter = (sweep + 1.0) * ((idx % 97) + 1.0)
        spiky = np.where((idx + sweep) % 50 == 0, 1e6, 1.0)
        return np.where(fam == 0, gauge, np.where(fam == 1, counter, spiky))

class Ledger:
    """Acked-write ledger: batch DESCRIPTORS, not samples.

    ``bulk`` rows are ``(sweep, lo, hi, ts)`` — regenerated through the
    same WorkloadGen at verify; ``explicit`` rows are ``(sid, ts, val)``
    for the small corpora (historical seed, query corpus).  ``expected``
    expands the whole thing into {sid: {ts: val}} (last write wins on
    the impossible same-(sid,ts) collision, matching storage)."""

    def __init__(self, gen: WorkloadGen):
        self.gen = gen
        self.bulk: List[tuple] = []
        self.explicit: List[tuple] = []
        self._lock = threading.Lock()

    def ack_bulk(self, sweep: int, lo: int, hi: int, ts: int) -> None:
        with self._lock:
            self.bulk.append((sweep, lo, hi, ts))

    def ack_explicit(self, rows) -> None:
        with self._lock:
            self.explicit.extend(rows)

    @property
    def acked_samples(self) -> int:
        with self._lock:
            return (sum(hi - lo for _, lo, hi, _ in self.bulk)
                    + len(self.explicit))

    def expected(self) -> Dict[bytes, Dict[int, float]]:
        with self._lock:
            bulk = list(self.bulk)
            explicit = list(self.explicit)
        out: Dict[bytes, Dict[int, float]] = {}
        for sweep, lo, hi, ts in bulk:
            ids = self.gen.ids(sweep, lo, hi)
            vals = self.gen.values(sweep, lo, hi)
            for sid, v in zip(ids, vals.tolist()):
                out.setdefault(sid, {})[ts] = v
        for sid, ts, v in explicit:
            out.setdefault(sid, {})[int(ts)] = float(v)
        return out


def _digest(stream) -> str:
    """sha256 over canonical sample lines (sorted upstream)."""
    h = hashlib.sha256()
    for sid, ts, val in stream:
        h.update(sid)
        h.update(b"\t%d\t%r\n" % (ts, val))
    return h.hexdigest()


# ---------------------------------------------------------------------------
# phase tracking (driver observations + /metrics boundary scrapes)
# ---------------------------------------------------------------------------


class _Phase:
    __slots__ = ("name", "t_start", "t_end", "ingest_lat", "query_lat",
                 "acked_batches", "acked_samples", "failed_batches",
                 "query_ok", "query_shed", "query_err", "scrape_before",
                 "scrape_after")

    def __init__(self, name: str, t_start: float, scrape_before):
        self.name = name
        self.t_start = t_start
        self.t_end: float | None = None
        self.ingest_lat: List[float] = []
        self.query_lat: List[float] = []
        self.acked_batches = 0
        self.acked_samples = 0
        self.failed_batches = 0
        self.query_ok = 0
        self.query_shed = 0
        self.query_err = 0
        self.scrape_before = scrape_before
        self.scrape_after = None


# counter deltas reported per phase: (artifact key, /metrics name)
_PHASE_COUNTERS = (
    ("db_writes", "m3tpu_db_writes"),
    ("shard_not_owned", "m3tpu_db_shard_not_owned"),
    ("new_series_rejected", "m3tpu_db_new_series_rejected"),
    ("corruption_detected", "m3tpu_db_corruption_detected"),
    ("corruption_quarantined", "m3tpu_db_corruption_quarantined"),
    ("scrub_repairs", "m3tpu_scrub_repairs_completed"),
    ("migration_blocks_streamed", "m3tpu_topology_blocks_streamed"),
    ("query_shed_total", "m3tpu_query_shed_total"),
    ("query_deadline_exceeded", "m3tpu_query_deadline_exceeded_total"),
)


class PhaseTracker:
    """Phase-bucketed SLO accounting.  ``transition(label)`` scrapes the
    whole fleet ONCE (tolerating dead nodes) and uses that scrape as
    both the closing boundary of the old phase and the opening boundary
    of the new one, so per-phase /metrics deltas tile the run exactly."""

    def __init__(self, scrape_fn):
        self._scrape = scrape_fn
        self._lock = threading.Lock()
        self.phases: List[_Phase] = []
        self._t0 = time.monotonic()

    @property
    def current(self) -> _Phase | None:
        with self._lock:
            return self.phases[-1] if self.phases else None

    def transition(self, label: str) -> None:
        now = time.monotonic() - self._t0
        scrape = self._scrape()
        with self._lock:
            if self.phases:
                self.phases[-1].t_end = now
                self.phases[-1].scrape_after = scrape
            self.phases.append(_Phase(label, now, scrape))

    def finish(self) -> None:
        self.transition("__end__")
        with self._lock:
            self.phases.pop()  # the sentinel carried the closing scrape

    def record_ingest(self, latency_s: float, n: int) -> None:
        with self._lock:
            if self.phases:
                p = self.phases[-1]
                p.ingest_lat.append(latency_s)
                p.acked_batches += 1
                p.acked_samples += n

    def record_ingest_failure(self) -> None:
        with self._lock:
            if self.phases:
                self.phases[-1].failed_batches += 1

    def record_query(self, latency_s: float, outcome: str) -> None:
        with self._lock:
            if self.phases:
                p = self.phases[-1]
                if outcome == "ok":
                    p.query_lat.append(latency_s)
                    p.query_ok += 1
                elif outcome == "shed":
                    p.query_shed += 1
                else:
                    p.query_err += 1

    # -- artifact rendering -------------------------------------------------

    def render(self) -> List[dict]:
        from m3_tpu_torch.instrument import exposition

        out = []
        for p in self.phases:
            dur = (p.t_end or (time.monotonic() - self._t0)) - p.t_start

            def _lat(vals):
                if not vals:
                    return {"n": 0, "driver_p50_ms": None,
                            "driver_p99_ms": None}
                a = np.asarray(vals)
                return {"n": len(vals),
                        "driver_p50_ms": round(float(np.quantile(a, 0.5))
                                               * 1e3, 3),
                        "driver_p99_ms": round(float(np.quantile(a, 0.99))
                                               * 1e3, 3)}

            rec = {
                "name": p.name,
                "start_s": round(p.t_start, 1),
                "duration_s": round(dur, 1),
                "ingest": dict(
                    _lat(p.ingest_lat),
                    acked_batches=p.acked_batches,
                    acked_samples=p.acked_samples,
                    failed_batches=p.failed_batches,
                    samples_per_s=round(p.acked_samples / dur, 1)
                    if dur > 0 else None,
                ),
                "query": dict(
                    _lat(p.query_lat),
                    ok=p.query_ok, shed=p.query_shed, errors=p.query_err,
                ),
            }
            if p.scrape_after is not None:
                rec["fleet_ingest"] = exposition.fleet_summary(
                    p.scrape_after, "m3tpu_db_write_batch_seconds",
                    before=p.scrape_before)
                rec["fleet_query"] = exposition.fleet_summary(
                    p.scrape_after, "m3tpu_query_seconds",
                    before=p.scrape_before)
                deltas = {}
                for key, metric in _PHASE_COUNTERS:
                    total = 0.0
                    for node, after in p.scrape_after.items():
                        if after is None:
                            continue
                        a = exposition.counter_value(after, metric)
                        b = exposition.counter_value(
                            (p.scrape_before or {}).get(node), metric)
                        # restart-aware: a counter below its previous
                        # value means the process restarted — the new
                        # process's absolute value IS the delta
                        total += a if a < b else a - b
                    deltas[key] = total
                rec["counters"] = deltas
            out.append(rec)
        return out


# ---------------------------------------------------------------------------
# the cluster (real node processes) + chaos ops adapter
# ---------------------------------------------------------------------------


def _free_ports(n: int) -> list:
    socks, ports = [], []
    try:
        for _ in range(n):
            s = socket.socket()
            socks.append(s)  # registered before bind: no leak on raise
            s.bind(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])
    finally:
        for s in socks:
            s.close()
    return ports


class SoakCluster:
    """N+1 real node processes (the +1 is the replace spare) over a
    shared remote KV, placement installed through the admin API, all
    chaos verbs implemented against live public surfaces: SIGKILL +
    restart via the process harness, wire faults via
    ``POST /api/v1/debug/faults``, corruption via on-disk byte flips +
    admin scrub, replace via the placement admin verb + the migration
    path, device faults via the same endpoint's ``device.dispatch``
    point.  Every node runs on ``device`` (None = the CUDA card).  Also
    the ChaosScheduler's ops adapter."""

    def __init__(self, cfg: SoakConfig, workdir: Path, tracker: PhaseTracker
                 | None = None, device=None):
        self.cfg = cfg
        self.device = device
        self.workdir = Path(workdir)
        self.tracker = tracker
        self.kv_srv = None
        self.kv = None
        self.session = None
        self.nodes: List = []
        self.rpc_ports: List[int] = []
        self.total = cfg.nodes + (1 if cfg.replace else 0)
        self.log: List[str] = []
        self._log_lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------

    def note(self, msg: str) -> None:
        with self._log_lock:
            self.log.append(f"{time.strftime('%H:%M:%S')} {msg}")

    def _selfmon_config(self, k: int) -> dict:
        """Node k's selfmon section (JSON is valid YAML): fleet mode —
        every node scrapes every OTHER node's /metrics under its
        instance tag — with the soak-scaled burn windows (the 1h/6h
        SRE defaults would never fire inside a minutes-long run)."""
        from m3_tpu_torch.query.slo import latency_ratio

        win = [{"long": self.cfg.selfmon_long,
                "short": self.cfg.selfmon_short, "factor": 2.0}]
        rules = [
            {"name": "ingest-latency", "objective": 0.999,
             "ratio": latency_ratio("m3tpu_db_write_batch_seconds", "0.25"),
             "windows": win},
            {"name": "query-latency", "objective": 0.99,
             "ratio": latency_ratio("m3tpu_query_seconds", "1.0"),
             "windows": win},
        ] + list(self.cfg.selfmon_extra_rules)
        if self.cfg.controller:
            # The controller's dedicated trigger (see SoakConfig): the
            # dropped-frame share of rpc write traffic, scoped to THIS
            # node's instance — self-healing is a node-local decision
            # on the node's OWN burn, and the fleet-wide sum would
            # dilute one node's drops under every peer's (selfmon-
            # inflated) completion rate.  Zero on a healthy run by
            # construction; fires past 10% drops (the drop share can
            # never exceed the armed drop probability, so the smoke
            # window's p=0.05 is quiet by margin, not by luck).
            # fault_drop_triggers is the x/fault mirror every node
            # exposes; both sides are frame-rate, same unit.
            inst = f'{{instance="i{k}"}}'
            # FIRST in the rule list: the whole pass runs under one
            # deadline budget and rules past it degrade to "error"
            # (burn unknown) — the control plane's sensor must never
            # be the one starved behind the heavy latency-histogram
            # rules on a loaded box (unknown means HOLD forever).
            rules.insert(0, {
                "name": "ingest-errors", "objective": 0.90,
                "ratio": (f"sum(rate(fault_drop_triggers{inst}"
                          "[{window}])) / "
                          "clamp_min(sum(rate("
                          f"m3tpu_db_write_batch_seconds_count{inst}"
                          "[{window}])) + "
                          f"sum(rate(fault_drop_triggers{inst}"
                          "[{window}])), 0.1)"),
                "windows": [{"long": "30s", "short": "10s",
                             "factor": 1.0}],
            })
            if self.cfg.selfheal:
                # The selfheal profile binds the device lane too.  The
                # ratio is the refused share of guarded device calls:
                # device_error_total over device_guard_calls, the
                # port's counters, which every refused guarded dispatch
                # bumps (the port has no fallback, so the reference's
                # device_fallback_total would be an empty ratio and a
                # verdict that never fires) — exactly 0.0 on a healthy
                # run (same no-flake property as ingest-errors), driven
                # hard by the device_fault window.
                rules.insert(1, {
                    "name": "device-errors", "objective": 0.90,
                    "ratio": ("sum(rate(device_error_total"
                              f"{inst}" "[{window}])) / "
                              "clamp_min(sum(rate(device_guard_calls"
                              f"{inst}" "[{window}])), 0.1)"),
                    "windows": [{"long": "30s", "short": "10s",
                                 "factor": 1.0}],
                })
        if self.cfg.disk_capacity:
            # Disk headroom as an SLO.  disk_free_ratio is a
            # LEVEL (a gauge), not an event rate, so the burn ratio is
            # "how far below the LOW watermark did this window get",
            # normalized over the LOW→CRITICAL span: 0.0 at/above LOW,
            # 1.0 at/below CRITICAL.  max_over_time makes a brief dip
            # count for the whole window — exactly what paging on disk
            # pressure should do.  Node-local, like ingest-errors.
            inst = f'{{instance="i{k}"}}'
            span = max(0.01, self.cfg.disk_low - self.cfg.disk_crit)
            rules.insert(0, {
                "name": "disk-pressure", "objective": 0.75,
                "ratio": (f"clamp_max(clamp_min({self.cfg.disk_low} - "
                          f"max_over_time(disk_free_ratio{inst}"
                          "[{window}])" f", 0) / {span}, 1)"),
                "windows": [{"long": "30s", "short": "10s",
                             "factor": 1.0}],
            })
        return {
            "enabled": True, "every": 1,
            "budget": self.cfg.selfmon_budget,
            "instance": f"i{k}",
            "peers": [f"i{i}=127.0.0.1:{p}"
                      for i, p in enumerate(self.fixed_http_ports)
                      if i != k],
            # 3 rules x 2 windows x 2 ratio queries over a fleet-
            # scraped namespace on a shared box: the 2s default budget
            # systematically starves the tail of the rule list
            "slo_deadline": "6s",
            "default_rules": False, "rules": rules,
        }

    def _controller_config(self) -> dict:
        """Every node's control plane: the ingest binding
        rides the dedicated error-ratio trigger; the latency SLOs stay
        record-only (bound to nothing) so a slow box's latency blips
        can never move an actuator mid-run."""
        cfg = self.cfg
        return {
            "enabled": True, "every": 1,
            "ingest_rule": "ingest-errors", "query_rule": "",
            # selfheal profile binds the device and node lanes too:
            # device burn → the devguard/
            # checkpoint/membudget actuators; node burn → rebalance,
            # with disk pressure as its realistic driver.  Default
            # profile leaves both record-only, so the smoke quiet-
            # controller pin can never flake.
            "device_rule": "device-errors" if cfg.selfheal else "",
            "node_rule": ("disk-pressure"
                          if cfg.selfheal and cfg.disk_capacity else ""),
            "disk_rule": cfg.disk_rule,
            "fire_ticks": cfg.controller_fire_ticks,
            "clear_ticks": cfg.controller_clear_ticks,
            "hold_ticks": cfg.controller_hold_ticks,
            "min_action_interval": cfg.controller_min_interval,
        }

    def start(self) -> None:
        from m3_tpu_torch.client.session import ConsistencyLevel, ReplicatedSession
        from m3_tpu_torch.cluster.kv_remote import (
            RemoteKVStore, serve_kv_background,
        )
        from m3_tpu_torch.dtest.harness import NodeProcess
        from m3_tpu_torch.server.rpc import RemoteDatabase

        (self.workdir / "kv").mkdir(parents=True, exist_ok=True)
        self.kv_srv = serve_kv_background(root=str(self.workdir / "kv"))
        # HTTP ports are pre-allocated (not ephemeral): the selfmon
        # fleet mode needs every node's /metrics endpoint
        # in every OTHER node's static config.  ONE _free_ports call
        # for both sets — two calls could hand the second set a port
        # the kernel just released from the first (bind-failure flake).
        ports = _free_ports(2 * self.total)
        self.rpc_ports = ports[:self.total]
        self.fixed_http_ports = ports[self.total:]
        for k in range(self.total):
            root = self.workdir / f"n{k}" / "data"
            cfgp = self.workdir / f"n{k}" / "node.yaml"
            peers = [f"127.0.0.1:{p}" for i, p in enumerate(self.rpc_ports)
                     if i != k]
            selfmon_yaml = ""
            if self.cfg.selfmon:
                selfmon_yaml = "selfmon: " + json.dumps(
                    self._selfmon_config(k)) + "\n"
                if self.cfg.controller:  # requires selfmon (validated)
                    selfmon_yaml += "controller: " + json.dumps(
                        self._controller_config()) + "\n"
            if self.cfg.disk_capacity:
                # capacity-quota mode: all nodes share one real
                # filesystem, so statvfs would watermark them together
                selfmon_yaml += "disk: " + json.dumps({
                    "enabled": True,
                    "capacity": self.cfg.disk_capacity,
                    "reserve": self.cfg.disk_reserve,
                    "low_ratio": self.cfg.disk_low,
                    "critical_ratio": self.cfg.disk_crit,
                }) + "\n"
            cfgp.parent.mkdir(parents=True, exist_ok=True)
            cfgp.write_text(f"""
db:
  root: {root}
  instance_id: i{k}
  kv_endpoint: 127.0.0.1:{self.kv_srv.port}
  rpc_listen_port: {self.rpc_ports[k]}
  peers: [{", ".join(repr(p) for p in peers)}]
  bootstrap_peers: true
  namespaces:
    default:
      num_shards: {self.cfg.num_shards}
      slot_capacity: {self.cfg.slot_capacity}
      block_size: {self.cfg.block_size}
      buffer_past: {self.cfg.buffer_past}
coordinator: {{listen_port: {self.fixed_http_ports[k]}, admin_listen_port: 0}}
mediator:
  enabled: true
  tick_interval: {"1s" if self.cfg.smoke else "2s"}
  snapshot_every: 1000000
  cleanup_every: 30
  scrub_volumes: 0
  migrate_blocks: 4
  migrate_grace_ticks: 2
{selfmon_yaml}""")
            root.mkdir(parents=True, exist_ok=True)
            self.nodes.append(NodeProcess(
                str(cfgp), str(root), device=self.device))
        for k in range(self.cfg.nodes):  # the spare stays down for now
            self.nodes[k].start(timeout_s=300)
        self.note(f"{self.cfg.nodes} nodes up (+{self.total - self.cfg.nodes} "
                  "spare config)")
        self._admin(0, "POST", "/api/v1/services/m3db/placement/init", {
            "instances": [
                {"id": f"i{k}", "isolation_group": f"g{k}",
                 "endpoint": f"127.0.0.1:{self.rpc_ports[k]}"}
                for k in range(self.cfg.nodes)
            ],
            "num_shards": self.cfg.num_shards, "rf": self.cfg.rf,
        })

        def resolve(inst):
            h, _, p = inst.endpoint.rpartition(":")
            return RemoteDatabase((h, int(p)))

        self.kv = RemoteKVStore(("127.0.0.1", self.kv_srv.port),
                                watch_poll_s=0.25)
        self.session = ReplicatedSession.dynamic(
            self.kv, resolve,
            write_level=ConsistencyLevel.MAJORITY,
            read_level=ConsistencyLevel.MAJORITY,
        )

    def close(self) -> None:
        if self.session is not None:
            self.session.close()
        if self.kv is not None:
            self.kv.close()
        for nd in self.nodes:
            nd.kill()
        if self.kv_srv is not None:
            self.kv_srv.shutdown()
            self.kv_srv.server_close()

    # -- node access -------------------------------------------------------

    def _status(self, k: int) -> dict:
        return json.loads(
            (self.workdir / f"n{k}" / "data" / "node.json").read_text())

    def http_port(self, k: int) -> int | None:
        try:
            return self._status(k)["port"]
        except (OSError, ValueError, KeyError):
            return None

    def _admin(self, k: int, method: str, path: str, body=None) -> dict:
        req = urllib.request.Request(
            f"http://127.0.0.1:{self._status(k)['admin_port']}{path}",
            method=method,
            data=json.dumps(body).encode() if body is not None else None,
        )
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.load(r)

    def node_post(self, k: int, path: str, body: dict) -> dict:
        req = urllib.request.Request(
            f"http://127.0.0.1:{self._status(k)['port']}{path}",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.load(r)

    def alive_nodes(self) -> List[int]:
        return [k for k in range(self.total)
                if k < len(self.nodes) and self.nodes[k].alive()]

    def promql(self, k: int, query: str, namespace: str | None = None,
               time_s: int | None = None, timeout_s: float = 60.0) -> list:
        """Instant PromQL query against node k's HTTP API; with
        ``namespace`` the query runs over that namespace's storage
        (how ``_m3_selfmon`` history is read from outside)."""
        url = (f"http://127.0.0.1:{self.http_port(k)}/api/v1/query?"
               f"query={urllib.request.quote(query)}"
               f"&time={time_s if time_s is not None else int(time.time())}")
        if namespace:
            url += f"&namespace={namespace}"
        with urllib.request.urlopen(url, timeout=timeout_s) as r:
            out = json.load(r)
        if out.get("status") != "success":
            raise RuntimeError(out)
        return out["data"]["result"]

    def scrape_all(self) -> dict:
        """{node index: parsed /metrics | None} — the PhaseTracker's
        boundary scrape.  Dead/mid-restart nodes scrape as None (the
        partial-merge path exposition.fleet_summary flags)."""
        from m3_tpu_torch.dtest.harness import scrape_fleet

        started = [k for k in range(self.total)
                   if (self.workdir / f"n{k}" / "data" / "node.json").exists()
                   or self.nodes[k].alive()]
        ports = {k: self.http_port(k) for k in started}
        by_port = scrape_fleet([p for p in ports.values() if p], timeout_s=10)
        return {k: (by_port.get(p) if p is not None else None)
                for k, p in ports.items()}

    # -- chaos ops (ChaosScheduler adapter) --------------------------------

    def phase(self, label: str) -> None:
        self.note(f"phase -> {label}")
        if self.tracker is not None:
            self.tracker.transition(label)

    def kill(self, k: int) -> None:
        self.note(f"SIGKILL node {k}")
        self.nodes[k].kill()

    def restart(self, k: int) -> None:
        self.note(f"restart node {k}")
        self.nodes[k].restart(timeout_s=600)

    def arm_faults(self, k: int, spec: str) -> None:
        self.note(f"arm faults on node {k}: {spec}")
        self.node_post(k, "/api/v1/debug/faults",
                       {"disarm": True, "arm": spec})

    def clear_faults(self, k: int) -> None:
        self.note(f"clear faults on node {k}")
        self.node_post(k, "/api/v1/debug/faults", {"disarm": True})

    def corrupt(self, k: int, seed: int) -> None:
        import random

        root = self.workdir / f"n{k}" / "data"
        victims = sorted(p for p in root.glob(
            "data/default/*/fileset-*-data.db") if p.stat().st_size > 0)
        if not victims:
            raise RuntimeError(f"corrupt: no flushed filesets on node {k}")
        rng = random.Random(f"soak-corrupt:{seed}")
        victim = victims[rng.randrange(len(victims))]
        raw = bytearray(victim.read_bytes())
        raw[rng.randrange(len(raw))] ^= 0xFF
        victim.write_bytes(bytes(raw))
        self.note(f"corrupted {victim.relative_to(root)} on node {k}")
        # force detection + peer repair NOW (the mediator's budgeted
        # sweep would find it eventually; the soak wants the window
        # deterministic)
        out = self._admin(k, "POST", "/api/v1/database/scrub",
                          {"repair": True})
        self.note(f"scrub on node {k}: {out.get('scrub')}")

    def disk_fill(self, k: int, target: float) -> None:
        """Ballast-fill node k's storage root so its capacity-quota
        ledger sees ``target`` free ratio.  The ballast is a SPARSE
        file (truncate, no real bytes): the ledger walks ``st_size``,
        so the node experiences genuine watermark pressure while the
        shared host filesystem spends nothing — which is also why the
        soak runs quota mode instead of statvfs."""
        from m3_tpu_torch.x.membudget import parse_bytes

        root = self.workdir / f"n{k}" / "data"
        ballast = root / "ballast.fill"
        capacity = parse_bytes(self.cfg.disk_capacity)
        used = 0
        for p in root.rglob("*"):
            try:
                if p != ballast and p.is_file():
                    used += p.lstat().st_size
            except OSError:
                continue
        size = max(0, int(capacity * (1.0 - target)) - used)
        with open(ballast, "wb") as f:
            f.truncate(size)
        self.note(f"disk ballast on node {k}: {size} bytes "
                  f"(target free ratio {target})")

    def disk_release(self, k: int) -> None:
        ballast = self.workdir / f"n{k}" / "data" / "ballast.fill"
        ballast.unlink(missing_ok=True)
        self.note(f"disk ballast released on node {k}")

    def replace(self, k: int, timeout_s: float = 600.0) -> None:
        from m3_tpu_torch.cluster.placement import PlacementService

        spare = self.total - 1
        if not self.nodes[spare].alive():
            self.note(f"starting spare node {spare}")
            self.nodes[spare].start(timeout_s=600)
        self.note(f"rolling replace: i{k} -> i{spare}")
        self._admin(0, "POST", "/api/v1/services/m3db/placement/replace", {
            "leaving_id": f"i{k}",
            "instance": {"id": f"i{spare}", "isolation_group": f"g{spare}",
                         "endpoint": f"127.0.0.1:{self.rpc_ports[spare]}"},
        })
        ps = PlacementService(self.kv)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            p = ps.get()
            newcomer = p.instances.get(f"i{spare}")
            if (newcomer is not None and newcomer.shards
                    and all(a.state.value == "A"
                            for a in newcomer.shards.values())
                    and not p.instances[f"i{k}"].shards):
                self.note(f"cutover complete: i{spare} AVAILABLE, "
                          f"i{k} drained")
                # Wait for the donor's GRACE DROP before SIGTERM: the
                # drop resets its (possibly million-series) buffers, so
                # the drain's final snapshot is cheap.  Stopping at
                # cutover would snapshot the full warm window — minutes
                # of encode on a big soak, blowing the stop timeout.
                root = self.workdir / f"n{k}" / "data"
                drop_deadline = time.monotonic() + 120
                while time.monotonic() < drop_deadline:
                    if not list(root.glob("data/default/*/fileset-*")):
                        break
                    time.sleep(1.0)
                rc = self.nodes[k].stop(timeout_s=300)
                self.note(f"donor node {k} drained (rc={rc})")
                return
            time.sleep(1.0)
        raise TimeoutError(f"replace i{k}->i{spare}: cutover incomplete "
                           f"after {timeout_s:.0f}s")


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------


def _ingest_loop(cluster: SoakCluster, gen: WorkloadGen, ledger: Ledger,
                 tracker: PhaseTracker, scheduler: ChaosScheduler,
                 cfg: SoakConfig, stop: threading.Event,
                 first_ack: threading.Event) -> int:
    """Sustained bulk ingest: slice the series space into batches, write
    at Majority through the replicated session, ledger ONLY what was
    acked.  Runs at least cfg.sweeps full passes, then keeps the load
    on until the chaos timeline has finished.  ``first_ack`` fires
    after the first acknowledged batch — the run starts its chaos clock
    there, so the one-time node-side costs of a cold write path (kernel
    library loads, the card's lazy initialisations) land in the setup
    phase, not inside 'healthy'."""
    sess = cluster.session
    sweep = 0
    while not stop.is_set():
        for lo in range(0, cfg.series, cfg.batch):
            if stop.is_set():
                break
            hi = min(lo + cfg.batch, cfg.series)
            ids = gen.ids(sweep, lo, hi)
            vals = gen.values(sweep, lo, hi)
            ts = time.time_ns()
            tsa = np.full(hi - lo, ts, np.int64)
            t0 = time.perf_counter()
            try:
                rejected = sess.write_batch(NS, ids, tsa, vals, now_nanos=ts)
            except Exception:  # noqa: BLE001 — unacked: no durability claim
                tracker.record_ingest_failure()
                stop.wait(0.2)
                continue
            if rejected:
                # partially-accepted batch (new-series cap/limiter): a
                # rejected sample was NOT stored, so nothing in this
                # batch enters the durability ledger — counted as a
                # failed batch, the per-phase counters carry the
                # node-side rejection totals
                tracker.record_ingest_failure()
                continue
            tracker.record_ingest(time.perf_counter() - t0, hi - lo)
            ledger.ack_bulk(sweep, lo, hi, ts)
            first_ack.set()
        sweep += 1
        if sweep >= cfg.sweeps and scheduler.done:
            break
        if sweep >= cfg.max_sweeps:
            cluster.note(f"ingest: max_sweeps={cfg.max_sweeps} reached with "
                         "chaos still running")
            break
    return sweep


def _query_loop(cluster: SoakCluster, ledger: Ledger, tracker: PhaseTracker,
                cfg: SoakConfig, stop: threading.Event) -> None:
    """Concurrent query traffic: every interval, write a fresh point to
    the tagged query corpora (PromQL labels + Graphite path docs) and
    fire one PromQL range query and one Graphite render at a rotating
    live node.  503/504/429 count as shed (the overload substrate doing
    its job), everything else non-200 as an error."""
    from m3_tpu_torch.index.doc import Document, Field

    sess = cluster.session
    rnd = 0
    C = cfg.query_corpus
    while not stop.wait(cfg.query_interval_s):
        ts = time.time_ns()
        # corpus points: deterministic value = rnd + i/1000
        docs = []
        rows = []
        vals = np.arange(C, dtype=np.float64) / 1000.0 + rnd
        for i in range(C):
            pid = b"soakq;%04d" % i
            docs.append(Document(pid, (
                Field(b"__name__", b"soakq"),
                Field(b"family", b"f%d" % (i % 3)),
                Field(b"idx", b"%04d" % i),
            )))
            rows.append((pid, ts, vals[i]))
            gid = b"soak.q.s%04d" % i
            docs.append(Document(gid, (
                Field(b"__g0__", b"soak"),
                Field(b"__g1__", b"q"),
                Field(b"__g2__", b"s%04d" % i),
            )))
            rows.append((gid, ts, vals[i]))
        ts2 = np.full(len(docs), ts, np.int64)
        try:
            if sess.write_tagged_batch(NS, docs, ts2, np.repeat(vals, 2),
                                       now_nanos=ts) == 0:
                ledger.ack_explicit(rows)
            else:
                tracker.record_ingest_failure()
        except Exception:  # noqa: BLE001
            tracker.record_ingest_failure()
        alive = cluster.alive_nodes()
        if not alive:
            rnd += 1
            continue
        port = cluster.http_port(alive[rnd % len(alive)])
        if port is None:
            rnd += 1
            continue
        now_s = ts // 10**9
        if rnd % 2 == 0:
            url = (f"http://127.0.0.1:{port}/api/v1/query_range?"
                   f"query=sum(soakq)%20by%20(family)&start={now_s - 300}"
                   f"&end={now_s}&step=30s&timeout=10s")
        else:
            url = (f"http://127.0.0.1:{port}/render?target=soak.q.*"
                   f"&from=-5min&until=now&timeout=10s")
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(url, timeout=15) as r:
                r.read()
            tracker.record_query(time.perf_counter() - t0, "ok")
        except urllib.error.HTTPError as e:
            tracker.record_query(time.perf_counter() - t0,
                                 "shed" if e.code in (429, 503, 504)
                                 else "err")
        except OSError:
            tracker.record_query(time.perf_counter() - t0, "err")
        rnd += 1


def _write_historical(cluster: SoakCluster, ledger: Ledger,
                      cfg: SoakConfig) -> None:
    """Seed a small corpus two blocks in the past so the mediator
    flushes real filesets early — the substrate the corruption window
    (quarantine → peer repair) and the rolling replace (block
    streaming) act on."""
    from m3_tpu_torch.core.config import parse_duration

    bsz = parse_duration(cfg.block_size)
    t_hist = (time.time_ns() // bsz - 2) * bsz
    ids = [b"soakhist.%05d" % i for i in range(cfg.hist_series)]
    for p in range(cfg.hist_points):
        ts = t_hist + (p + 1) * 10**9
        vals = np.arange(cfg.hist_series, dtype=np.float64) + p * 1000.0
        tsa = np.full(cfg.hist_series, ts, np.int64)
        if cluster.session.write_batch(NS, ids, tsa, vals, now_nanos=ts):
            raise RuntimeError("historical corpus writes were rejected "
                               "(undersized slot capacity?)")
        ledger.ack_explicit(
            [(sid, ts, float(v)) for sid, v in zip(ids, vals.tolist())])
    # wait for every initial node to flush the historical block
    def flushed(k):
        return list((cluster.workdir / f"n{k}" / "data").glob(
            "data/default/*/fileset-*-data.db"))

    deadline = time.monotonic() + 240
    while time.monotonic() < deadline:
        if all(flushed(k) for k in range(cfg.nodes)):
            cluster.note("historical corpus flushed on every node")
            return
        time.sleep(1.0)
    raise TimeoutError("historical corpus did not flush to filesets")


def _verify(cluster: SoakCluster, ledger: Ledger, cfg: SoakConfig) -> dict:
    """The zero-acked-sample-loss verdict: regenerate every acked
    sample from the ledger, re-read ALL of them at Majority through the
    batched fetch, compare value-for-value.  Digests are computed over
    the same sorted iteration for both sides, so
    ``ledger_sha256 == recovered_sha256`` exactly when nothing acked
    was lost or altered."""
    t0 = time.perf_counter()
    expected = ledger.expected()
    sids = sorted(expected)
    t_min = min((min(pts) for pts in expected.values()), default=0)
    t_max = max((max(pts) for pts in expected.values()), default=0)
    h_ledger = hashlib.sha256()
    h_got = hashlib.sha256()
    missing = mismatched = present = extras = 0
    missing_examples: List[str] = []
    for lo in range(0, len(sids), cfg.verify_batch):
        chunk = sids[lo:lo + cfg.verify_batch]
        got_lists = cluster.session.fetch_batch(
            NS, chunk, t_min, t_max + 1)
        for sid, got in zip(chunk, got_lists):
            want = expected[sid]
            got_map = dict(got)
            extras += sum(1 for t in got_map if t not in want)
            for ts in sorted(want):
                val = want[ts]
                h_ledger.update(sid)
                h_ledger.update(b"\t%d\t%r\n" % (ts, val))
                gv = got_map.get(ts)
                if gv is None:
                    missing += 1
                    if len(missing_examples) < 10:
                        missing_examples.append(f"{sid!r}@{ts}")
                    continue
                if gv != val:
                    mismatched += 1
                    if len(missing_examples) < 10:
                        missing_examples.append(
                            f"{sid!r}@{ts}: {gv!r} != {val!r}")
                    continue
                present += 1
                h_got.update(sid)
                h_got.update(b"\t%d\t%r\n" % (ts, gv))
    return {
        "acked_samples": present + missing + mismatched,
        "active_series": len(sids),
        "verified_present": present,
        "missing": missing,
        "mismatched": mismatched,
        "unacked_extras": extras,
        "missing_examples": missing_examples,
        "ledger_sha256": h_ledger.hexdigest(),
        "recovered_sha256": h_got.hexdigest(),
        "zero_acked_loss": missing == 0 and mismatched == 0,
        "verify_seconds": round(time.perf_counter() - t0, 1),
    }


def selfmon_report(cluster: SoakCluster, window_s: int) -> dict:
    """The SLO record: instead of harness-side scrape diffs,
    the run's fleet SLOs are PromQL queries over the ``_m3_selfmon``
    HISTORY a live node stored through its own write path — the same
    queries an operator would issue mid-incident, issued here against
    ONE node whose fleet scrape covered its peers.  Returns the
    queries, their answers, the per-(rule, instance) max burn verdicts
    over the run, and the queried node's /health ``slo`` section."""
    alive = cluster.alive_nodes()
    if not alive:
        return {"error": "no live node to query"}
    k = alive[0]
    w = f"{max(60, window_s)}s"
    out: dict = {"queried_node": k, "window": w, "queries": {}}

    def one_value(query: str):
        rows = cluster.promql(k, query, namespace="_m3_selfmon")
        if not rows:
            return None
        v = float(rows[0]["value"][1])
        return None if v != v else round(v, 6)

    for key, q in (
        ("fleet_ingest_p99_s",
         f"histogram_quantile(0.99, sum(rate("
         f"m3tpu_db_write_batch_seconds_bucket[{w}])) by (le))"),
        ("fleet_ingest_p50_s",
         f"histogram_quantile(0.5, sum(rate("
         f"m3tpu_db_write_batch_seconds_bucket[{w}])) by (le))"),
        ("fleet_query_p99_s",
         f"histogram_quantile(0.99, sum(rate("
         f"m3tpu_query_seconds_bucket[{w}])) by (le))"),
        ("fleet_write_batches_per_s",
         f"sum(rate(m3tpu_db_write_batch_seconds_count[{w}]))"),
    ):
        try:
            out["queries"][key] = one_value(q)
        except Exception as e:  # noqa: BLE001 — recorded, not fatal
            out["queries"][key] = f"error: {type(e).__name__}: {e}"
    verdicts = []
    rows = cluster.promql(k, f"max_over_time(m3tpu_slo_burn[{w}])",
                          namespace="_m3_selfmon")
    for r in rows:
        verdicts.append({
            "rule": r["metric"].get("rule"),
            "instance": r["metric"].get("instance"),
            "max_burn": round(float(r["value"][1]), 4),
        })
    out["verdicts"] = sorted(
        verdicts, key=lambda v: (v["rule"] or "", v["instance"] or ""))
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{cluster.http_port(k)}/health",
                timeout=30) as r:
            out["health_slo"] = json.load(r).get("slo")
    except OSError:
        out["health_slo"] = None
    return out


def controller_report(cluster: SoakCluster, window_s: int) -> dict:
    """The self-healing record: every controller decision was
    emitted as a ``controller_action`` gauge sample and self-scraped
    into ``_m3_selfmon``, so the run's full act→hold→relax sequence is
    retro-queryable PromQL history FROM A PEER — the same question an
    operator asks post-incident ("what did the control plane do, and
    did it relax back?").  Also snapshots every live node's ``/health``
    ``controller`` section (actions_total, per-actuator at_baseline)."""
    alive = cluster.alive_nodes()
    if not alive:
        return {"error": "no live node to query"}
    k = alive[0]
    w = f"{max(60, window_s)}s"
    out: dict = {"queried_node": k, "window": w, "history": [],
                 "actions_total": 0, "nodes": {}}
    rows = cluster.promql(k, f"max_over_time(m3tpu_controller_action[{w}])",
                          namespace="_m3_selfmon")
    for r in rows:
        out["history"].append({
            "instance": r["metric"].get("instance"),
            "rule": r["metric"].get("rule"),
            "actuator": r["metric"].get("actuator"),
            "action": r["metric"].get("action"),
            "last_level": round(float(r["value"][1]), 6),
        })
    out["history"].sort(key=lambda h: (h["instance"] or "",
                                       h["actuator"] or "",
                                       h["action"] or ""))
    for n in alive:
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{cluster.http_port(n)}/health",
                    timeout=30) as r:
                ctl = json.load(r).get("controller")
        except OSError:
            ctl = None
        if ctl:
            out["nodes"][f"i{n}"] = {
                "actions_total": ctl.get("actions_total", 0),
                "held_unknown": ctl.get("held_unknown", 0),
                "rate_limited": ctl.get("rate_limited", 0),
                "at_baseline": {
                    name: a.get("at_baseline")
                    for name, a in ctl.get("actuators", {}).items()},
            }
            out["actions_total"] += int(ctl.get("actions_total", 0))
    return out


def device_report(tracker: PhaseTracker) -> dict:
    """Each node's device boundary over the run, from the phase-boundary
    scrapes (the devguard and membudget counters every node mirrors onto
    /metrics): ``encode_calls`` (the most ``device_guard_calls{stage=
    "encode"}`` any scrape showed — a restart resets the counter),
    ``errors_by_phase`` (restart-aware ``device_error_total`` deltas:
    refused guarded dispatches), ``error_stages`` and ``mem_peak_bytes``
    (the most ``device_mem_peak_bytes`` any scrape showed).  Keyed by
    instance id."""
    from m3_tpu_torch.instrument import exposition

    out: dict = {}
    for p in tracker.phases:
        for node, after in sorted((p.scrape_after or {}).items()):
            if after is None:
                continue
            rec = out.setdefault(f"i{node}", {
                "encode_calls": 0.0, "errors_by_phase": {},
                "error_stages": [], "mem_peak_bytes": 0.0})
            before = (p.scrape_before or {}).get(node)
            a = exposition.counter_value(after, "device_error_total")
            b = exposition.counter_value(before, "device_error_total")
            rec["errors_by_phase"][p.name] = (
                rec["errors_by_phase"].get(p.name, 0.0)
                + (a if a < b else a - b))
            rec["encode_calls"] = max(rec["encode_calls"], exposition.counter_value(
                after, "device_guard_calls", {"stage": "encode"}))
            rec["mem_peak_bytes"] = max(rec["mem_peak_bytes"], exposition.counter_value(
                after, "device_mem_peak_bytes"))
            stages = {sm.label("stage") for sm in after
                      if sm.name == "device_error_total" and sm.value > 0}
            rec["error_stages"] = sorted(set(rec["error_stages"]) | stages)
    return out


# ---------------------------------------------------------------------------
# the run + the regression gate
# ---------------------------------------------------------------------------


def run_soak(cfg: SoakConfig, workdir: str | None = None,
             keep_workdir: bool = False, log=print, device=None) -> dict:
    """Stand up the cluster on ``device`` (None = the CUDA card), drive
    load + chaos, verify, render the artifact.  Returns the artifact
    dict (schema identical at smoke and full scale)."""
    import tempfile

    from m3_tpu_torch.x import retry as xretry

    wd = Path(workdir) if workdir else Path(tempfile.mkdtemp(prefix="soak-"))
    started_unix = int(time.time())
    t_run0 = time.monotonic()
    tracker: PhaseTracker | None = None
    cluster = None
    retry_before = dict(xretry.counters())
    try:
        tracker = PhaseTracker(lambda: cluster.scrape_all())
        cluster = SoakCluster(cfg, wd, tracker, device=device)
        log(f"soak: workdir {wd}; starting {cfg.nodes} nodes "
            f"(+{1 if cfg.replace else 0} spare)...")
        cluster.start()
        gen = WorkloadGen(cfg.series, cfg.churn, cfg.seed)
        ledger = Ledger(gen)
        tracker.transition("setup")
        log("soak: writing historical corpus (fileset substrate)...")
        _write_historical(cluster, ledger, cfg)

        timeline = build_timeline(cfg)
        scheduler = ChaosScheduler(timeline, cluster, seed=cfg.seed)
        stop = threading.Event()
        first_ack = threading.Event()
        sweeps_box: List[int] = []
        qthread = threading.Thread(
            target=_query_loop,
            args=(cluster, ledger, tracker, cfg, stop), daemon=True)
        ithread = threading.Thread(
            target=lambda: sweeps_box.append(_ingest_loop(
                cluster, gen, ledger, tracker, scheduler, cfg, stop,
                first_ack)),
            daemon=True)
        log(f"soak: load on — {cfg.series} series x {cfg.sweeps}+ sweeps, "
            f"chaos timeline of {len(timeline)} events")
        ithread.start()
        qthread.start()
        # chaos clock starts at the first ACKED batch: the cold write
        # path's one-time costs belong to setup, not to 'healthy'
        if not first_ack.wait(600):
            raise TimeoutError("no batch acked within 600s of load start")
        scheduler.start()
        ithread.join()
        scheduler.stop()
        stop.set()
        qthread.join(30)
        tracker.finish()
        sweeps_done = sweeps_box[0] if sweeps_box else 0

        log(f"soak: load off after {sweeps_done} sweeps, "
            f"{ledger.acked_samples} acked samples; verifying at "
            "Majority...")
        # recovery precondition: every placement member answering
        for k in cluster.alive_nodes():
            cluster.nodes[k].wait_healthy(120)
        verdict = _verify(cluster, ledger, cfg)
        log(f"soak: verdict zero_acked_loss={verdict['zero_acked_loss']} "
            f"({verdict['verified_present']} present, "
            f"{verdict['missing']} missing, "
            f"{verdict['mismatched']} mismatched, "
            f"{verdict['unacked_extras']} unacked extras)")

        # The run's SLO record comes from PromQL over the
        # fleet's self-stored _m3_selfmon history, not harness scrape
        # diffs — at least one burn verdict must be retro-queryable or
        # the self-monitoring contract is broken (verdict gated).
        selfmon_rec = None
        if cfg.selfmon:
            try:
                selfmon_rec = selfmon_report(
                    cluster, int(time.monotonic() - t_run0) + 60)
            except Exception as e:  # noqa: BLE001 — the artifact must
                # record the failure; the verdict flag below trips
                selfmon_rec = {"error": f"{type(e).__name__}: {e}"}
            verdict["slo_recorded"] = bool(selfmon_rec.get("verdicts"))
            log(f"soak: selfmon verdicts={len(selfmon_rec.get('verdicts', []))} "
                f"fleet ingest p99="
                f"{selfmon_rec.get('queries', {}).get('fleet_ingest_p99_s')}s")

        # The controller's decision record.  A selfheal run
        # must show actions AND every actuator back at baseline; any
        # other run must show ZERO actions (the enabled-but-quiet
        # invariant the smoke tier pins).
        controller_rec = None
        if cfg.selfmon and cfg.controller:
            try:
                controller_rec = controller_report(
                    cluster, int(time.monotonic() - t_run0) + 60)
            except Exception as e:  # noqa: BLE001 — recorded, not fatal
                controller_rec = {"error": f"{type(e).__name__}: {e}"}
            acted = int(controller_rec.get("actions_total", 0) or 0)
            baseline_ok = all(
                all(n.get("at_baseline", {}).values())
                for n in controller_rec.get("nodes", {}).values())
            verdict["controller_quiet"] = (acted == 0)
            verdict["controller_relaxed"] = baseline_ok
            if cfg.selfheal:
                verdict["controller_acted"] = acted > 0
            log(f"soak: controller actions={acted} "
                f"relaxed_to_baseline={baseline_ok}")

        retry_after = xretry.counters()
        artifact = {
            "kind": "SOAK",
            "schema": SCHEMA,
            "started_unix": started_unix,
            "wall_s": round(time.monotonic() - t_run0, 1),
            "config": dataclasses.asdict(cfg),
            "sweeps_completed": sweeps_done,
            "phases": tracker.render(),
            "chaos": scheduler.log,
            "driver": {
                "retry_counters": {
                    k: v - retry_before.get(k, 0)
                    for k, v in retry_after.items()
                    if v - retry_before.get(k, 0)
                },
                "read_breakers": cluster.session.breaker_states(),
                "routing_misses": cluster.session.routing_misses,
            },
            "cluster_log": cluster.log,
            "verdict": verdict,
        }
        if selfmon_rec is not None:
            artifact["selfmon"] = selfmon_rec
        if controller_rec is not None:
            artifact["controller"] = controller_rec
        artifact["device"] = {
            "device": "cuda" if device is None else str(device),
            "nodes": device_report(tracker)}
        return artifact
    finally:
        if cluster is not None:
            cluster.close()
        if not keep_workdir:
            shutil.rmtree(wd, ignore_errors=True)


def check_artifact(new: dict, baseline: dict,
                   tolerance: float = 2.0) -> List[str]:
    """The regression gate: nonempty return = FAIL.

    * the new run's zero-acked-loss verdict must PASS — loss is never
      within tolerance;
    * for every phase present in both artifacts, the new p99s (driver-
      observed and fleet-merged, ingest and query) must stay within
      ``tolerance`` x the baseline's — a ratio, not an absolute, so the
      gate is meaningful across box speeds.  The ``setup`` phase is
      EXCLUDED: it exists precisely to quarantine one-time kernel-library
      loads and cold-path warmup (see run_soak), and its p99 swings many x
      between identical runs — a gate that false-fails on compile noise
      gates nothing (the loss verdict still covers setup's writes);
    * schema/kind must match (a gate comparing different artifact
      shapes proves nothing).
    """
    errs: List[str] = []
    if new.get("kind") != baseline.get("kind"):
        errs.append(f"artifact kind {new.get('kind')!r} != baseline "
                    f"{baseline.get('kind')!r}")
        return errs
    if new.get("schema") != baseline.get("schema"):
        # a schema bump may rename the very fields compared below, and
        # every .get() miss would silently skip its comparison — the
        # gate must fail loudly instead of passing vacuously
        errs.append(f"artifact schema {new.get('schema')!r} != baseline "
                    f"{baseline.get('schema')!r}")
        return errs
    if not new.get("verdict", {}).get("zero_acked_loss"):
        v = new.get("verdict", {})
        errs.append(
            f"acked-sample loss: {v.get('missing')} missing, "
            f"{v.get('mismatched')} mismatched of {v.get('acked_samples')}")
    if new.get("verdict", {}).get("slo_recorded") is False:
        # selfmon was on but the run left no queryable burn verdict in
        # _m3_selfmon — the self-monitoring contract itself regressed
        errs.append("selfmon: no SLO verdict queryable from _m3_selfmon")
    base_phases = {p["name"]: p for p in baseline.get("phases", ())}
    for p in new.get("phases", ()):  # noqa: B007
        if p["name"] == "setup":
            continue
        b = base_phases.get(p["name"])
        if b is None:
            continue
        for side in ("ingest", "query"):
            nv = (p.get(side) or {}).get("driver_p99_ms")
            bv = (b.get(side) or {}).get("driver_p99_ms")
            if nv is not None and bv:
                if nv > bv * tolerance:
                    errs.append(
                        f"phase {p['name']}: {side} driver p99 "
                        f"{nv:.1f}ms > {tolerance}x baseline {bv:.1f}ms")
            fq = (p.get(f"fleet_{side}") or {}).get("quantiles", {})
            bq = (b.get(f"fleet_{side}") or {}).get("quantiles", {})
            nf, bf = fq.get("p99"), bq.get("p99")
            if nf is not None and bf:
                if nf > bf * tolerance:
                    errs.append(
                        f"phase {p['name']}: fleet {side} p99 "
                        f"{nf * 1e3:.1f}ms > {tolerance}x baseline "
                        f"{bf * 1e3:.1f}ms")
    return errs


def config_from_artifact(artifact: dict, **overrides) -> SoakConfig:
    """Rebuild the run config a committed artifact was produced with
    (the --check contract: the gate re-runs the BASELINE's shape, so
    the comparison is like-for-like)."""
    fields = {f.name for f in dataclasses.fields(SoakConfig)}
    raw = {k: v for k, v in artifact.get("config", {}).items()
           if k in fields}
    raw.update(overrides)
    return SoakConfig(**raw)
