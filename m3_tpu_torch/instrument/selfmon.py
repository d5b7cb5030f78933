"""Self-monitoring: the node scrapes itself into its own storage.  The
port's copy of ``m3_tpu/instrument/selfmon.py``: the writes go through
the port's ``Database`` (its buffers and flushes on the database's
device) and the SLO evaluator's engine runs on the same device.
``measure_overhead`` (the reference benchmark's selfmon block) takes
the device its databases run on.

A point-in-time ``/metrics`` scrape dies with the process.  This module
closes the dogfooding loop: each node converts its OWN registry into
tagged samples and writes them through the REAL write path (WAL,
placement ownership, mediator flush) into a reserved ``_m3_selfmon``
namespace, so the fleet's health becomes ordinary retro-queryable PromQL
series.  The fixed 31-bucket histograms make the stored latency series
bounded-cardinality by construction — a scrape can never mint new
bucket series.

Three contracts, enforced here:

* **One parser for self and fleet.**  The local scrape renders the
  registry to the Prometheus text format and re-parses it through the
  STRICT ``exposition.parse_text`` — the exact code path a peer scrape
  takes over HTTP.  A registry that renders something the parser
  rejects fails the selfmon tick the same way it fails the exposition
  tests, and the round-trip property (registry value →
  scrape → ingest → PromQL) is tested end to end, not per-branch.
* **Amplification guard.**  Metrics whose name contains ``selfmon``
  (the monitor's own scrape/write counters) are EXCLUDED from
  conversion, so the loop cannot feed itself: writing metrics moves
  ``db_*`` counters, but those are pre-existing series — the stored
  series count is CONSTANT across cycles (pinned by test).  The
  ``slo_burn`` gauges are deliberately NOT excluded: burn history is
  a product of the loop, primed at construction so it too is present
  from the first cycle.
* **Hard per-scrape series budget.**  Each source (local registry,
  each peer) is capped at ``budget`` series per cycle; the survivors
  are the first ``budget`` in sorted (name, labels) order — a
  deterministic set, so an over-budget registry degrades to a stable
  subset instead of flapping — and the excess is counted
  (``selfmon_budget_dropped``), never written.

Fleet mode: ``peers`` lists other nodes' ``/metrics`` endpoints
(``host:port`` or ``name=host:port``); each peer's scrape lands in the
same namespace under its ``instance`` tag, so the whole cluster's
health is one PromQL query away from ANY node.  Peer samples carrying
Prometheus timestamps keep them; everything else is stamped at scrape
time.  An unreachable peer contributes nothing and is counted — a
fleet scrapes through node restarts, so that path is hot, not
exceptional.
"""

from __future__ import annotations

import threading
import time
import urllib.request
from typing import Iterable, List, Sequence, Tuple

import numpy as np

from m3_tpu_torch.instrument import exposition

__all__ = ["SELFMON_NAMESPACE", "SelfMonitor", "Peer", "parse_peer",
           "samples_to_writes", "is_selfmon_metric"]

SELFMON_NAMESPACE = "_m3_selfmon"

# Any metric whose name contains this token is selfmon-about-selfmon
# and never stored (the amplification guard above).
_EXCLUDE_TOKEN = "selfmon"


def is_selfmon_metric(name: str) -> bool:
    return _EXCLUDE_TOKEN in name


class Peer:
    """One fleet-scrape target: ``instance`` tag + /metrics URL."""

    __slots__ = ("instance", "addr")

    def __init__(self, instance: str, addr: str):
        self.instance = instance
        self.addr = addr

    @property
    def url(self) -> str:
        return f"http://{self.addr}/metrics"

    def __repr__(self) -> str:  # artifact/log readability
        return f"Peer({self.instance}={self.addr})"


def parse_peer(entry: str) -> Peer:
    """``host:port`` (instance = the endpoint string) or
    ``name=host:port`` (explicit instance tag)."""
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
    return Peer(name, addr)


def _series_id(tags: dict) -> bytes:
    name = tags.get(b"__name__", b"")
    return name + b"{" + b",".join(
        k + b"=" + v for k, v in sorted(tags.items()) if k != b"__name__"
    ) + b"}"


def samples_to_writes(samples: Sequence[exposition.Sample], instance: str,
                      now_nanos: int, budget: int = 0) -> tuple:
    """Parsed exposition samples → one tagged write batch.

    Every sample becomes a series tagged ``__name__`` + its labels +
    the scraper-owned ``instance`` tag (an inbound ``instance`` label
    is overwritten — the scraper, not the scraped text, names the
    source).  Returns ``(docs, ts, vals, stats)`` with ``stats`` =
    ``{"converted", "excluded", "budget_dropped"}``.  Ordering is the
    sorted (name, labels) order unconditionally, so the budget's
    survivor set is deterministic."""
    from m3_tpu_torch.index.doc import Document

    rows = sorted((s for s in samples if not is_selfmon_metric(s.name)),
                  key=lambda s: (s.name, s.labels))
    excluded = len(samples) - len(rows)
    dropped = 0
    if budget and len(rows) > budget:
        dropped = len(rows) - budget
        rows = rows[:budget]
    docs, ts, vals = [], [], []
    inst = instance.encode()
    for s in rows:
        tags = {b"__name__": s.name.encode()}
        for k, v in s.labels:
            tags[k.encode()] = v.encode()
        tags[b"instance"] = inst
        docs.append(Document.from_tags(_series_id(tags), tags))
        ts.append(s.timestamp_ms * 10**6 if s.timestamp_ms is not None
                  else now_nanos)
        vals.append(float(s.value))
    stats = {"converted": len(docs), "excluded": excluded,
             "budget_dropped": dropped}
    return docs, ts, vals, stats


def _http_fetch(url: str, timeout_s: float) -> str:
    with urllib.request.urlopen(url, timeout=timeout_s) as r:
        return r.read().decode()


class SelfMonitor:
    """The mediator-driven self-scrape task (+ SLO evaluation).

    ``tick(now_nanos)`` runs one cycle: local registry scrape → peer
    scrapes (fleet mode) → one tagged write per source through
    ``db.write_tagged_batch`` → one SLO evaluation pass over the
    freshly extended history.  Designed to ride ``Mediator.run_once``
    exactly like the downsampler flush: a raising tick is the
    mediator's problem to log/count, a raising PEER is this module's
    problem to absorb.

    Placement note: writes go through the real ownership gate — on a
    placement-scoped node a mixed batch partial-accepts (owned shards
    land, the unowned remainder is counted ``not_owned`` by the db) and
    an all-unowned batch rejects typed and is counted here.  Fleet
    coverage under rf < nodes comes from every node scraping its peers,
    not from any single node owning everything.
    """

    def __init__(self, db, registry, namespace: str = SELFMON_NAMESPACE,
                 instance: str = "self", budget: int = 2000,
                 peers: Iterable = (), scrape_timeout_s: float = 2.0,
                 slo_rules: Iterable = (), slo_deadline_s: float = 2.0,
                 instrument=None, http_fetch=_http_fetch):
        self.db = db
        self.registry = registry
        self.namespace = namespace
        self.instance = instance
        self.budget = int(budget)
        self.peers: List[Peer] = [
            p if isinstance(p, Peer) else parse_peer(p) for p in peers]
        self.scrape_timeout_s = float(scrape_timeout_s)
        self._fetch = http_fetch
        # _tick_lock serializes scrape cycles (peer HTTP fetches + the
        # SLO pass — seconds under a hung peer); _lock guards ONLY the
        # cached stats, so status()/health_slo() — the /health path —
        # never block behind an in-flight cycle.
        self._tick_lock = threading.Lock()
        self._lock = threading.Lock()
        self._last: dict = {}
        self._cycles = 0
        # Own observability — interned ONCE; every name carries the
        # "selfmon" token so the amplification guard excludes it.
        scope = (instrument.scope("selfmon") if instrument is not None
                 else None)
        n = (lambda name: scope.counter(name)) if scope is not None else (
            lambda name: None)
        self._c_cycles = n("cycles")
        self._c_written = n("series_written")
        self._c_excluded = n("series_excluded")
        self._c_dropped = n("budget_dropped")
        self._c_not_owned = n("series_not_owned")
        self._c_rejected = n("series_rejected")
        self._c_write_errors = n("write_errors")
        self._c_peer_ok = n("peer_scrapes_ok")
        self._c_peer_failed = n("peer_scrapes_failed")
        self._g_last_series = (scope.gauge("last_cycle_series")
                               if scope is not None else None)
        # SLO evaluation rides the same tick, over the same namespace,
        # through the ordinary engine (burn gauges live OUTSIDE the
        # selfmon scope so their history IS stored).
        self.slo = None
        slo_rules = tuple(slo_rules)
        if slo_rules:
            from m3_tpu_torch.query.engine import Engine
            from m3_tpu_torch.query.slo import SLOEvaluator
            from m3_tpu_torch.query.storage_adapter import DatabaseStorage

            self.slo = SLOEvaluator(
                Engine(DatabaseStorage(db, namespace), device=db.device),
                slo_rules,
                deadline_s=slo_deadline_s, scope=instrument)

    # -- the cycle ---------------------------------------------------------

    def _inc(self, counter, delta: int = 1) -> None:
        if counter is not None and delta:
            counter.inc(delta)

    def scrape_local(self) -> List[exposition.Sample]:
        """Render + STRICT-parse this process's registry — the same
        grammar gate a peer scrape crosses."""
        return exposition.parse_text(self.registry.render_prometheus())

    def _scrape_peers(self) -> List[Tuple[str, list]]:
        """Fetch + strict-parse every peer CONCURRENTLY: the whole peer
        pass costs ~one scrape_timeout wall, not one per dead peer —
        a SIGKILL window must not multiply the mediator tick cadence
        by the fleet size.  Returns ``[(instance, samples | None)]``
        (None = unreachable/rotten)."""
        if not self.peers:
            return []

        results: List = [None] * len(self.peers)

        def one(i: int, peer: Peer) -> None:
            try:
                text = self._fetch(peer.url, self.scrape_timeout_s)
                results[i] = exposition.parse_text(text)
            except Exception:  # noqa: BLE001 — recorded as None
                results[i] = None

        threads = [threading.Thread(target=one, args=(i, p), daemon=True)
                   for i, p in enumerate(self.peers)]
        for t in threads:
            t.start()
        # join with margin over the per-fetch timeout; a socket wedged
        # past its own timeout leaves its slot None (the daemon thread
        # is abandoned — slot writes are claim-free: one writer each)
        deadline = time.monotonic() + self.scrape_timeout_s + 2.0
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        return [(p.instance, results[i] if not threads[i].is_alive()
                 else None)
                for i, p in enumerate(self.peers)]

    def tick(self, now_nanos: int) -> dict:
        """One full cycle; returns the cycle stats dict (also cached
        for :meth:`status`)."""
        from m3_tpu_torch.storage.database import ShardNotOwnedError

        with self._tick_lock:
            stats = {"written": 0, "excluded": 0, "budget_dropped": 0,
                     "not_owned": 0, "rejected": 0, "peers_ok": 0,
                     "peers_failed": 0, "write_errors": 0}
            batches: List[Tuple[str, list]] = [
                (self.instance, self.scrape_local())]
            for instance, samples in self._scrape_peers():
                if samples is None:
                    # a dead peer is a normal fleet condition
                    # (mid-SIGKILL), counted and skipped; next cycle
                    # retries
                    stats["peers_failed"] += 1
                else:
                    batches.append((instance, samples))
                    stats["peers_ok"] += 1
            for instance, samples in batches:
                docs, ts, vals, st = samples_to_writes(
                    samples, instance, now_nanos, self.budget)
                stats["excluded"] += st["excluded"]
                stats["budget_dropped"] += st["budget_dropped"]
                if not docs:
                    continue
                try:
                    res = self.db.write_tagged_batch(
                        self.namespace, docs,
                        np.asarray(ts, np.int64),
                        np.asarray(vals, np.float64),
                        now_nanos=now_nanos)
                except ShardNotOwnedError:
                    # all-unowned on a placement-scoped node: these
                    # series belong to peers' shards; their own selfmon
                    # stores them
                    stats["not_owned"] += len(docs)
                    continue
                except Exception:  # noqa: BLE001 — one source's write
                    # failing must not lose the other sources' cycle
                    stats["write_errors"] += 1
                    continue
                not_owned = getattr(res, "not_owned", 0)
                # series whose CREATION the shared new-series limiter /
                # slot capacity rejected were NOT stored — counting
                # them as written would hide e.g. missing histogram
                # lanes from every downstream burn-rate answer
                rejected = getattr(res, "rejected", 0)
                stats["not_owned"] += not_owned
                stats["rejected"] += rejected
                stats["written"] += len(docs) - not_owned - rejected
            if self.slo is not None:
                stats["slo_firing"] = list(
                    self.slo.evaluate(now_nanos).get("firing", ()))
            self._inc(self._c_cycles)
            self._inc(self._c_written, stats["written"])
            self._inc(self._c_excluded, stats["excluded"])
            self._inc(self._c_dropped, stats["budget_dropped"])
            self._inc(self._c_not_owned, stats["not_owned"])
            self._inc(self._c_rejected, stats["rejected"])
            self._inc(self._c_write_errors, stats["write_errors"])
            self._inc(self._c_peer_ok, stats["peers_ok"])
            self._inc(self._c_peer_failed, stats["peers_failed"])
            if self._g_last_series is not None:
                self._g_last_series.update(stats["written"])
            with self._lock:
                self._cycles += 1
                self._last = stats
            return stats

    # -- read surfaces -----------------------------------------------------

    def status(self) -> dict:
        """The /health-facing document: scrape configuration + last
        cycle stats + the cached SLO verdicts (no queries run here)."""
        with self._lock:
            out = {
                "namespace": self.namespace,
                "instance": self.instance,
                "budget": self.budget,
                "peers": [f"{p.instance}={p.addr}" for p in self.peers],
                "cycles": self._cycles,
                "last_cycle": dict(self._last),
            }
        if self.slo is not None:
            out["slo"] = self.slo.status()
        return out

    def health_slo(self) -> dict | None:
        """The /health ``slo`` section: verdicts + a compact scrape
        summary; None when no rules are configured (noise-free health
        on nodes that only store, never judge)."""
        if self.slo is None:
            return None
        out = self.slo.status()
        with self._lock:
            out["selfmon"] = {
                "namespace": self.namespace,
                "cycles": self._cycles,
                "last_cycle": dict(self._last),
            }
        return out


# ---------------------------------------------------------------------------
# overhead measurement (the bench `selfmon` block)
# ---------------------------------------------------------------------------


def measure_overhead(duration_s: float = 4.0, batch: int = 2000,
                     series: int = 20_000, cadence_s: float = 2.0,
                     with_rules: bool = True,
                     root: str | None = None, device=None) -> dict:
    """Measured selfmon cost on the storage ingest hot path.

    Drives identical ``db.write_batch`` load for ``duration_s`` twice
    against fresh databases — once bare, once with a SelfMonitor
    (default SLO rules included when ``with_rules``) ticking on a
    WALL-CLOCK ``cadence_s`` like the mediator drives it (2s = the
    soak cadence, 5x more aggressive than the 10s production default)
    — and reports the steady-state throughput delta.  Warmup on both
    sides is untimed and includes two full scrape+evaluate cycles, so
    one-time costs (slot allocation for the selfmon series, the SLO
    rate-kernel first builds) don't masquerade as per-sample overhead.
    The bench records this block in the artifact; the acceptance bound
    is overhead < 5% of ingest throughput.  Both databases (and the SLO
    engine) run on ``device``: None means the card, as every entry
    point."""
    import shutil
    import tempfile
    import time as _time

    from m3_tpu_torch import instrument
    from m3_tpu_torch.storage.database import (
        Database, DatabaseOptions, NamespaceOptions,
    )

    def _run(with_selfmon: bool) -> dict:
        wd = tempfile.mkdtemp(prefix="selfmon-bench-", dir=root)
        try:
            registry = instrument.new_registry()
            scope = registry.scope("m3tpu")
            db = Database(
                DatabaseOptions(root=wd, commitlog_enabled=True),
                namespaces={
                    "default": NamespaceOptions(num_shards=2),
                    SELFMON_NAMESPACE: NamespaceOptions(num_shards=2),
                },
                instrument=scope, device=device,
            )
            db.bootstrap()
            mon = None
            if with_selfmon:
                rules = ()
                if with_rules:
                    from m3_tpu_torch.query.slo import default_rules

                    rules = default_rules("m3tpu")
                mon = SelfMonitor(db, registry, slo_rules=rules,
                                  instrument=scope)
            vals = np.arange(batch, dtype=np.float64)
            base_ts = _time.time_ns()
            b = 0

            def write_one() -> None:
                nonlocal b
                ts = np.full(batch, base_ts + b * 10**6, np.int64)
                sids = [b"bench.%06d" % ((b * batch + i) % series)
                        for i in range(batch)]
                db.write_batch("default", sids, ts, vals,
                               now_nanos=int(ts[0]))
                b += 1

            # untimed warmup: touch the whole id space (slot
            # allocation) and run two full selfmon cycles (selfmon
            # series creation + SLO query first builds)
            for _ in range(max(1, series // batch)):
                write_one()
            if mon is not None:
                mon.tick(base_ts + b * 10**6)
                mon.tick(base_ts + b * 10**6 + 1)
            cycles = 0
            wrote = 0
            t0 = _time.perf_counter()
            next_scrape = t0 + cadence_s
            while True:
                now = _time.perf_counter()
                if now - t0 >= duration_s:
                    break
                write_one()
                wrote += batch
                if mon is not None and _time.perf_counter() >= next_scrape:
                    mon.tick(base_ts + b * 10**6)
                    cycles += 1
                    next_scrape += cadence_s
            wall = _time.perf_counter() - t0
            db.close()
            return {"wall_s": round(wall, 4),
                    "samples_per_s": round(wrote / wall, 1),
                    "scrape_cycles": cycles}
        finally:
            shutil.rmtree(wd, ignore_errors=True)

    bare = _run(False)
    mon = _run(True)
    overhead = (1.0 - mon["samples_per_s"] / bare["samples_per_s"]) * 100.0
    return {
        "duration_s": duration_s, "batch": batch, "series": series,
        "cadence_s": cadence_s, "with_rules": with_rules,
        "base": bare, "selfmon": mon,
        "overhead_pct": round(overhead, 2),
        "bound_pct": 5.0,
        "ok": overhead < 5.0,
    }
