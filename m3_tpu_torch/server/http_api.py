"""HTTP API: the coordinator's front door (JSON write + PromQL read).

Reference parity: `src/query/api/v1` — Prometheus-compatible query
endpoints (`handler/prometheus/native/read.go:111` → engine), the JSON
write endpoint (`api/v1/json/write`), and label/series metadata
endpoints.  Response shapes follow the Prometheus HTTP API so Grafana
pointed at `/api/v1/query_range` works unchanged — the same
compatibility target the reference serves.

Read-path overload contract (`/api/v1/query`, `/api/v1/query_range`,
`/render`, `/api/v1/prom/remote/read`):

* ``timeout=`` query param (seconds or a duration like ``30s``/``2m``)
  sets the query's END-TO-END deadline, defaulting to the
  ``query.default_timeout`` config; the deadline is threaded through
  the engine, fanout and every wire hop (x/deadline), and partial
  results from non-required fanout sources surface in the Prometheus
  ``warnings`` response field.
* Status mapping: **429** a per-query resource limit tripped
  (``QueryLimitExceeded``, local or remote) — client should back off;
  **503 + Retry-After** admission control shed the query
  (``QueryShedError``: concurrency slots and wait queue full) — retry
  after the hinted delay; **504** the deadline was exceeded
  (``DeadlineExceeded``, including cooperative cancellation) — retry
  with a longer ``timeout=`` or narrower query.  Multiple REQUIRED
  fanout sources failing together (``PartialResultError``) map by the
  dominant cause: 504 if any missed the deadline, 429 if any tripped a
  limit, else **502**.
* Queries spending more than ``query.slow_query_fraction`` of their
  deadline land in the slow-query log (`/health` ``query.slow`` +
  ``slow_query_total`` on /metrics) with per-phase timings.
* ``namespace=`` on ``/api/v1/query``/``query_range`` evaluates over
  another configured namespace's LOCAL storage (unknown names 400); the
  ``_m3_selfmon`` self-monitoring history is queried this way.

The port's counterpart of ``m3_tpu/server/http_api.py``: the same routes,
status codes and response bodies over the port's ``Database`` and
``Engine`` (on the database's device), the Graphite engine
(``/render``, ``/metrics/find``) and the federated default engine (the
local database plus ``query.remotes``).  One status differs on purpose:
a typed device error (``x.devguard.DeviceError``) answers **503 +
Retry-After** — the port refuses a write the card cannot take (it has
no host staging), and a client must retry it, not drop it as a 4xx
tells it to.
"""

from __future__ import annotations

import collections
import json
import math
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

import numpy as np

from m3_tpu_torch.index.doc import Document
from m3_tpu_torch.index.search import All
from m3_tpu_torch.instrument.tracing import NOOP_TRACER, Tracepoint, traces_response
from m3_tpu_torch.query.engine import Engine
from m3_tpu_torch.query.fanout import FederatedStorage, PartialResultError
from m3_tpu_torch.query.storage_adapter import DatabaseStorage
from m3_tpu_torch.storage.database import Database, ShardNotOwnedError
from m3_tpu_torch.storage.limits import QueryLimitExceeded
from m3_tpu_torch.x import deadline as xdeadline
from m3_tpu_torch.x.admission import AdmissionController, QueryShedError
from m3_tpu_torch.x.deadline import Deadline, DeadlineExceeded
from m3_tpu_torch.x.devguard import DeviceError

_DUR_RE = re.compile(r"^(\d+(?:\.\d+)?)([smhdwy]|ms)$")


def _parse_time(v: str) -> int:
    """RFC3339-less Prometheus time params: unix seconds (float) → nanos."""
    return int(float(v) * 1e9)


def _parse_step(v: str) -> int:
    m = _DUR_RE.match(v)
    if m:
        mult = {"ms": 1e6, "s": 1e9, "m": 60e9, "h": 3600e9, "d": 86400e9,
                "w": 7 * 86400e9, "y": 365 * 86400e9}[m.group(2)]
        return int(float(m.group(1)) * mult)
    return int(float(v) * 1e9)


class _Handler(BaseHTTPRequestHandler):
    server_version = "m3tpu/0.1"
    ctx = None  # set by make_server

    def log_message(self, fmt, *args):  # quiet
        pass

    # -- helpers -----------------------------------------------------------

    def _json(self, code: int, obj, headers: dict | None = None) -> None:
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _error(self, code: int, msg: str,
               headers: dict | None = None) -> None:
        self._json(code, {"status": "error", "error": msg}, headers)

    def _overload_status(self, e: Exception) -> None:
        """The typed overload and device errors → HTTP status (see
        module docstring: 429 limit / 503 shed / 504 deadline / 503
        device).  A multi-source ``PartialResultError`` maps by its
        dominant cause — these are server-side failures, never a 400."""
        if isinstance(e, PartialResultError):
            causes = e.failures.values()
            if any(isinstance(c, DeadlineExceeded) for c in causes):
                return self._error(504, str(e))
            if any(isinstance(c, QueryLimitExceeded) for c in causes):
                return self._error(429, str(e))
            return self._error(502, str(e))
        if isinstance(e, QueryLimitExceeded):
            return self._error(429, str(e))
        if isinstance(e, QueryShedError):
            return self._error(
                503, str(e),
                headers={"Retry-After":
                         str(max(1, math.ceil(e.retry_after_s)))})
        if isinstance(e, DeadlineExceeded):
            return self._error(504, str(e))
        if isinstance(e, DeviceError):
            return self._error(503, str(e), headers={"Retry-After": "1"})
        raise e

    def _deadline(self, q) -> Deadline:
        """Every read request gets an end-to-end deadline: the
        ``timeout=`` param (seconds or ``30s``-style duration), default
        from config (``query.default_timeout``)."""
        v = q.get("timeout", [None])[0]
        timeout_s = (self.ctx.query_timeout_s if v is None
                     else _parse_step(v) / 1e9)
        return Deadline(timeout_s)

    def _body(self):
        n = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(n)

    # -- routes ------------------------------------------------------------

    def do_GET(self):
        u = urlparse(self.path)
        q = parse_qs(u.query)
        try:
            if u.path == "/health":
                return self._health()
            if u.path == "/metrics":
                return self._metrics()
            if u.path in ("/debug/traces", "/api/v1/debug/traces"):
                return self._traces(q)
            if u.path == "/api/v1/debug/faults":
                return self._faults()
            if u.path == "/debug/dump":
                return self._debug_dump(q)
            if u.path in ("/api/v1/query_range", "/api/v1/query"):
                return self._query(u.path.endswith("query_range"), q)
            if u.path == "/api/v1/labels":
                return self._labels(q)
            if u.path.startswith("/api/v1/label/") and u.path.endswith("/values"):
                name = u.path[len("/api/v1/label/") : -len("/values")]
                return self._label_values(name, q)
            if u.path == "/api/v1/series":
                return self._series(q)
            if u.path == "/render":
                return self._render(q)
            if u.path == "/metrics/find":
                return self._find(q)
            return self._error(404, f"unknown path {u.path}")
        except (QueryLimitExceeded, QueryShedError, DeadlineExceeded,
                PartialResultError, DeviceError) as e:
            return self._overload_status(e)
        except Exception as e:  # noqa: BLE001 — API boundary
            return self._error(400, str(e))

    def do_POST(self):
        u = urlparse(self.path)
        try:
            if u.path == "/api/v1/json/write":
                return self._write_json()
            if u.path in ("/api/v1/influxdb/write", "/write"):
                return self._influx_write(parse_qs(u.query))
            if u.path == "/api/v1/prom/remote/write":
                return self._prom_remote_write()
            if u.path == "/api/v1/prom/remote/read":
                return self._prom_remote_read(parse_qs(u.query))
            if u.path in ("/api/v1/query_range", "/api/v1/query"):
                q = parse_qs(self._body().decode())
                return self._query(u.path.endswith("query_range"), q)
            if u.path == "/api/v1/debug/faults":
                return self._faults(json.loads(self._body() or b"{}"))
            return self._error(404, f"unknown path {u.path}")
        except (QueryLimitExceeded, QueryShedError, DeadlineExceeded,
                PartialResultError, DeviceError) as e:
            return self._overload_status(e)
        except Exception as e:  # noqa: BLE001
            return self._error(400, str(e))

    # -- handlers ----------------------------------------------------------

    def _health(self):
        """Liveness plus the corruption-quarantine inventory: a node
        serving around quarantined volumes is healthy (that is the
        design) but an operator must be able to SEE the holes without
        shelling into the data dir."""
        out = {"ok": True}
        try:
            inv = self.ctx.db.quarantine_inventory()
        except Exception:  # noqa: BLE001 — health must never 500
            inv = None
        if inv:
            # Byte accounting per entry: under disk pressure the reaper
            # (and the operator) needs to know what releasing an entry
            # buys, not just that it exists.
            qbytes = 0
            for e in inv:
                try:
                    d = e.get("dir")
                    if d:
                        qbytes += sum(f.stat().st_size
                                      for f in Path(d).rglob("*")
                                      if f.is_file())
                except OSError:
                    pass
            out["quarantine"] = {
                "entries": len(inv),
                "bytes": qbytes,
                # brief per-entry detail; the full reason files live in
                # <root>/quarantine/
                "items": [
                    {k: e.get(k) for k in ("label", "namespace", "shard",
                                           "block_start", "volume", "check",
                                           "error_type")}
                    for e in inv[:50]
                ],
            }
        # Topology/migration visibility: which shards this node serves
        # per the watched placement, per-shard streaming progress of
        # INITIALIZING ones, and pending grace-period drops — the
        # operator's window into a rolling node add/replace/remove.
        if self.ctx.migrator is not None:
            try:
                out["topology"] = self.ctx.migrator.status()
            except Exception:  # noqa: BLE001 — health must never 500
                pass
        # Hot-path latency (windowed histogram summaries, NOT lifetime
        # reservoirs): merged p50/p99 per surface — ingest batches,
        # query phases, flush/snapshot, drains.  Omitted while no
        # histogram has recorded anything.
        try:
            if self.ctx.registry is not None:
                lat = {name: {k: round(v, 6) if isinstance(v, float) else v
                              for k, v in s.items()}
                       for name, s in
                       self.ctx.registry.histogram_summaries().items()
                       if s["count"]}
                if lat:
                    out["latency"] = lat
        except Exception:  # noqa: BLE001 — health must never 500
            pass
        # Read-path overload visibility: admission gauges, the slow-
        # query log tail, and per-peer breaker states — the operator's
        # window into WHY queries are shedding/504ing.  Omitted while
        # there is nothing to see (no gating configured, no slow
        # queries, no peers): a clean node's health stays noise-free.
        try:
            q = self.ctx.query_status()
            from m3_tpu_torch.x.breaker import all_breakers

            # peer breakers only: stage:* breakers (x/devguard) report
            # through the `device` section below, not the query view
            breakers = {name: br.state
                        for name, br in all_breakers().items()
                        if br.kind == "peer"}
            if breakers:
                q["breakers"] = breakers
            if (breakers or q["max_concurrent"] > 0
                    or q["slow_query_total"] or q["shed_total"]):
                out["query"] = q
        except Exception:  # noqa: BLE001 — health must never 500
            pass
        # Device-boundary visibility: per-stage guard counters +
        # breaker states (x/devguard), the device budget ledger
        # (x/membudget), and the arena checkpoint driver — the
        # operator's window into a degraded device path.  Health reports
        # DEGRADATION, not activity: a stage appears once it has errors
        # or a non-closed breaker (full happy-path counters live on
        # /metrics), so a clean node's health stays noise-free.
        try:
            from m3_tpu_torch.x import devguard, membudget

            dev = devguard.status()
            mb = membudget.snapshot()
            section = {}
            degraded = {
                st: doc for st, doc in dev["stages"].items()
                if doc.get("errors")
                or doc.get("breaker", "closed") != "closed"
            }
            if degraded:
                section["stages"] = degraded
            # used_bytes alone is NOT a signal — every node's buffers
            # reserve bytes; the ledger is health-worthy only once a
            # budget is configured (or something was rejected before
            # one was)
            if mb["budget_bytes"] or mb["rejected_total"]:
                section["membudget"] = mb
            if self.ctx.checkpointer is not None:
                section["checkpoint"] = self.ctx.checkpointer.status()
            if section:
                out["device"] = section
        except Exception:  # noqa: BLE001 — health must never 500
            pass
        # Disk-capacity visibility (x/diskbudget + persist/capacity):
        # the ledger's watermark verdict, per-family byte accounting
        # and shed/typed-error counters.  The membudget discipline —
        # health reports DEGRADATION, not activity: the section appears
        # only once the node is at/past LOW, has shed ingest, or has
        # classified a capacity error; a clean node stays noise-free.
        try:
            from m3_tpu_torch.persist import capacity as xcap
            from m3_tpu_torch.x import diskbudget

            dsnap = diskbudget.snapshot()
            caps = xcap.counters()
            if dsnap["enabled"] and (dsnap["level_value"] > 0
                                     or dsnap["shed_total"] or caps):
                disk = dict(dsnap)
                disk["free_ratio"] = round(disk["free_ratio"], 4)
                if caps:
                    disk["capacity_errors"] = caps
                out["disk"] = disk
            elif caps:
                # Typed errors with the ledger disarmed (statvfs-only
                # deployments without watermarks) still surface.
                out["disk"] = {"enabled": False, "capacity_errors": caps}
        except Exception:  # noqa: BLE001 — health must never 500
            pass
        # SLO burn-rate verdicts over the self-monitored history
        # (query/slo.py: cached last evaluation, no queries run here)
        # plus a compact selfmon scrape summary.  Present only when
        # rules are configured — a node that only stores, never
        # judges, keeps a noise-free health document.
        try:
            if self.ctx.selfmon is not None:
                slo = self.ctx.selfmon.health_slo()
                if slo is not None:
                    out["slo"] = slo
        except Exception:  # noqa: BLE001 — health must never 500
            pass
        # Self-healing controller: configuration + per-binding state +
        # actuator positions + the recent action tail (x/controller;
        # cheap cached state, no queries run here).
        try:
            if self.ctx.controller is not None:
                out["controller"] = self.ctx.controller.status()
        except Exception:  # noqa: BLE001 — health must never 500
            pass
        return self._json(200, out)

    def _debug_dump(self, q):
        """One-stop debug zip: thread stacks, a short CPU profile, a
        heap view, host info + metrics snapshot (reference
        x/debug/debug.go's pprof bundle served over HTTP)."""
        from m3_tpu_torch.instrument.debug import debug_bundle

        seconds = min(float(q.get("seconds", ["0.5"])[0]), 10.0)
        data = debug_bundle(self.ctx.registry, cpu_seconds=seconds)
        self.send_response(200)
        self.send_header("Content-Type", "application/zip")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _metrics(self):
        """Prometheus text exposition of the process registry (reference
        x/instrument tally prometheus reporter + x/debug introspection)."""
        reg = self.ctx.registry
        if reg is None:
            return self._error(404, "no instrument registry configured")
        data = reg.render_prometheus().encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; version=0.0.4")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _render(self, q):
        """Graphite render endpoint (reference
        `query/api/v1/handler/graphite/render.go`): JSON list of
        {target, datapoints: [[value|null, unix_seconds], ...]}."""
        import math as _math
        import time as _time

        from m3_tpu_torch.query.graphite import parse_graphite_time

        now = _time.time_ns()
        start = parse_graphite_time(q.get("from", ["-1h"])[0], now)
        end = parse_graphite_time(q.get("until", ["now"])[0], now)
        step = _parse_step(q.get("step", ["10s"])[0])
        dl = self._deadline(q)
        out = []
        targets = q.get("target", [])
        try:
            with self.ctx.admission.admit(deadline=dl), xdeadline.bind(dl):
                for target in targets:
                    for s in self.ctx.graphite.render(target, start, end,
                                                      step):
                        step_s = s.step_nanos / 1e9
                        out.append({
                            "target": s.name,
                            "datapoints": [
                                [None if _math.isnan(v) else v,
                                 int(s.start_nanos / 1e9 + i * step_s)]
                                for i, v in enumerate(s.values.tolist())
                            ],
                        })
        except Exception as e:  # noqa: BLE001 — observed, then re-raised
            self.ctx.observe_query("graphite", ";".join(targets), dl, error=e)
            raise
        self.ctx.observe_query("graphite", ";".join(targets), dl)
        return self._json(200, out)

    def _find(self, q):
        """Graphite find endpoint (reference handler/graphite/find.go)."""
        pattern = q["query"][0]
        prefix = pattern.rsplit(".", 1)[0] + "." if "." in pattern else ""
        out = [
            {"text": name, "id": prefix + name, "leaf": 1 if leaf else 0,
             "expandable": 1 if expandable else 0}
            for name, leaf, expandable in self.ctx.graphite.storage.find(pattern)
        ]
        return self._json(200, out)

    def _traces(self, q=None):
        """Span-ring debug surface (reference x/debug's introspection
        bundles; jaeger exporter seam collapses to JSON-over-HTTP).

        ``/api/v1/debug/traces``            — ring inventory (one row
                                              per trace) + raw spans
        ``?trace_id=<id>``                  — that trace's spans,
                                              parent-before-child
        ``?name=<tracepoint>``              — spans of one tracepoint
        """
        tr = self.ctx.tracer
        if tr is None:
            return self._error(404, "no tracer configured")
        q = q or {}
        return self._json(200, traces_response(
            tr, trace_id=q.get("trace_id", [None])[0],
            name=q.get("name", [None])[0]))

    def _faults(self, body: dict | None = None):
        """Faultpoint debug surface: GET = armed specs + counters, POST =
        runtime re-arm in the faultpoint spec grammar (x/fault owns the
        parse/apply builders).  This is how a chaos scheduler opens and
        closes fault windows on a LIVE node instead of restarting it."""
        from m3_tpu_torch.x import fault

        if body is None:
            return self._json(200, fault.registry_response())
        return self._json(200, fault.apply_request(body))

    @staticmethod
    def _series_id(tags: dict) -> bytes:
        name = tags.get(b"__name__", b"")
        return name + b"{" + b",".join(
            k + b"=" + v for k, v in sorted(tags.items()) if k != b"__name__"
        ) + b"}"

    def _ingest_tagged(self, docs, ts, vals) -> tuple[int, int]:
        """Shared downsample-then-write tail of every write handler.
        Returns (written, rejected): rejected = samples whose series
        creation hit the new-series rate limit — the typed
        back-pressure signal, surfaced so HTTP writers can back off.

        Opens the ``api.write`` root span (the coordinator-ingest end
        of a cross-process trace: downstream session/rpc hops join it
        through the bound context) and records the batch into the
        windowed ingest-latency histogram."""
        ctx = self.ctx
        t0 = time.perf_counter()
        with (ctx.tracer or NOOP_TRACER).start_span(
                Tracepoint.API_WRITE, {"n": len(docs)}):
            keep = np.ones(len(docs), bool)
            if ctx.downsampler is not None:
                keep = ctx.downsampler.write_batch(
                    docs, np.asarray(ts, np.int64), np.asarray(vals)
                )
            idx = np.nonzero(keep)[0]
            rejected = not_owned = 0
            if len(idx):
                res = ctx.db.write_tagged_batch(
                    ctx.namespace,
                    [docs[i] for i in idx],
                    np.asarray(ts, np.int64)[idx],
                    np.asarray(vals)[idx],
                )
                rejected = getattr(res, "rejected", 0)
                # samples whose shard this node does not own
                # (placement-scoped node fed directly): dropped, not
                # written — the correct ingest path for a scoped
                # cluster is the session
                not_owned = getattr(res, "not_owned", 0)
        if ctx.hist_ingest is not None:
            ctx.hist_ingest.record(time.perf_counter() - t0)
        return int(len(idx)) - rejected - not_owned, rejected

    def _prom_remote_write(self):
        """Prometheus remote write: snappy+protobuf WriteRequest
        (reference handler/prometheus/remote/write.go)."""
        from m3_tpu_torch.server.prom_remote import parse_write_request

        series = parse_write_request(self._body())
        docs, ts, vals = [], [], []
        for s in series:
            sid = self._series_id(s.labels)
            doc = Document.from_tags(sid, s.labels)
            for t_nanos, v in s.samples:
                docs.append(doc)
                ts.append(t_nanos)
                vals.append(v)
        rejected = 0
        if docs:
            _, rejected = self._ingest_tagged(docs, ts, vals)
        # Prometheus remote-write clients back off on 429 — the typed
        # signal for new-series rate limiting; 2xx otherwise.  The 429
        # is deliberate despite the accepted subset having been
        # persisted: spec-compliant clients retry the WHOLE batch, and
        # retrying is what eventually admits the REJECTED series (a 2xx
        # would silently drop them).  Costs of that choice: accepted
        # samples are re-written into the WAL (harmless — raw-namespace
        # dedupe is last-write-wins — but WAL volume inflates under
        # sustained churn), and if a downsampler is attached the retry
        # RE-AGGREGATES accepted samples into any still-open window
        # (sum/count lanes double-count until the window closes).
        # Deployments pairing the limiter with downsampling should set
        # the limit headroom so steady-state traffic never 429s.
        self.send_response(429 if rejected else 204)
        if rejected:
            self.send_header("X-Rejected", str(rejected))
        self.send_header("Content-Length", "0")
        self.end_headers()
        return None

    def _prom_remote_read(self, uq):
        """Prometheus remote read: snappy+protobuf ReadRequest →
        ReadResponse (reference handler/prometheus/remote/read.go).
        ``timeout=`` rides the URL query string (the body is
        protobuf)."""
        from m3_tpu_torch.query.promql import LabelMatcher
        from m3_tpu_torch.query.storage_adapter import matchers_to_query
        from m3_tpu_torch.server.prom_remote import (
            PromTimeSeries, build_read_response, parse_read_request,
        )

        ctx = self.ctx
        _OPS = {0: "=", 1: "!=", 2: "=~", 3: "!~"}
        results = []
        dl = self._deadline(uq)
        with ctx.admission.admit(deadline=dl), xdeadline.bind(dl):
            for q in parse_read_request(self._body()):
                matchers = tuple(
                    LabelMatcher(m.name, _OPS[m.type], m.value)
                    for m in q.matchers
                )
                idx_q = matchers_to_query(None, matchers)
                # prompb end timestamps are INCLUSIVE; db reads are
                # end-exclusive (same boundary rule as Engine._fetch)
                end = q.end_nanos + 1
                docs = ctx.db.query_ids(ctx.namespace, idx_q,
                                        q.start_nanos, end)
                series_out = []
                for i, d in enumerate(sorted(docs, key=lambda d: d.id)):
                    if i % 64 == 0:  # per-series read loop: cancellable
                        dl.check("remote read")
                    try:
                        pts = ctx.db.read(ctx.namespace, d.id,
                                          q.start_nanos, end)
                    except ShardNotOwnedError:
                        continue  # unowned shard: replicas answer it
                    series_out.append(PromTimeSeries(d.tags(), list(pts)))
                results.append(series_out)
        body = build_read_response(results)
        self.send_response(200)
        self.send_header("Content-Type", "application/x-protobuf")
        self.send_header("Content-Encoding", "snappy")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
        return None

    def _write_json(self):
        """reference api/v1/json/write: one sample or a list of
        {tags: {..}, timestamp (unix s or nanos), value}."""
        payload = json.loads(self._body())
        samples = payload if isinstance(payload, list) else [payload]
        docs, ts, vals = [], [], []
        for s in samples:
            tags = {k.encode(): v.encode() for k, v in s["tags"].items()}
            docs.append(Document.from_tags(self._series_id(tags), tags))
            t = s["timestamp"]
            ts.append(int(t * 1e9) if t < 1e12 else int(t))
            vals.append(float(s["value"]))
        written, rejected = (self._ingest_tagged(docs, ts, vals)
                             if docs else (0, 0))
        body = {"status": "success", "written": written}
        if rejected:
            # partial acceptance: series churn hit the rate limit
            body.update(status="partial", rejected=rejected,
                        error="new-series rate limit exceeded")
            return self._json(429, body)
        return self._json(200, body)

    def _influx_write(self, q):
        """InfluxDB line-protocol write endpoint (reference
        `api/v1/handler/influxdb/write.go`); 204 on success like
        InfluxDB itself."""
        import time as _time

        from m3_tpu_torch.server.influx import parse_lines, points_to_writes

        precision = q.get("precision", ["ns"])[0]
        points = parse_lines(self._body().decode(), precision,
                             now_nanos=int(_time.time() * 1e9))
        docs, ts, vals = points_to_writes(points)
        written, rejected = (self._ingest_tagged(docs, ts, vals)
                             if docs else (0, 0))
        self.send_response(429 if rejected else 204)
        self.send_header("X-Written", str(written))
        if rejected:
            self.send_header("X-Rejected", str(rejected))
        self.send_header("Content-Length", "0")
        self.end_headers()

    def _query(self, is_range: bool, q):
        query = q["query"][0]
        if is_range:
            start = _parse_time(q["start"][0])
            end = _parse_time(q["end"][0])
            step = _parse_step(q["step"][0])
        else:
            start = end = _parse_time(q["time"][0])
            step = 10**9
        dl = self._deadline(q)
        ctx = self.ctx
        # optional namespace override (another configured namespace's
        # local storage); unknown names 400 via the ValueError path
        engine = ctx.engine_for(q.get("namespace", [None])[0])
        try:
            # admission first (a shed query must not bind engine
            # resources), then the deadline rides the context into the
            # engine → fanout → wire
            with ctx.admission.admit(deadline=dl), xdeadline.bind(dl):
                block = engine.execute_range(query, start, end, step)
        except Exception as e:  # noqa: BLE001 — observed, then re-raised
            ctx.observe_query("promql", query, dl, error=e)
            raise
        result = []
        for i, meta in enumerate(block.series):
            values = [
                [t / 1e9, _fmt(v)]
                for t, v in zip(block.step_times.tolist(), block.values[i])
                if not math.isnan(v)
            ]
            if not values:
                continue
            metric = {k.decode(): v.decode() for k, v in meta.tags}
            if is_range:
                result.append({"metric": metric, "values": values})
            else:
                result.append({"metric": metric, "value": values[-1]})
        ctx.observe_query("promql", query, dl)
        payload = {
            "status": "success",
            "data": {
                "resultType": "matrix" if is_range else "vector",
                "result": result,
            },
        }
        if dl.warnings:
            # partial-result policy: non-required fanout sources that
            # failed/missed the deadline (Prometheus warnings field)
            payload["warnings"] = list(dl.warnings)
        return self._json(200, payload)

    def _fetch_docs(self, q):
        ctx = self.ctx
        start = _parse_time(q.get("start", ["0"])[0])
        # Prometheus API bounds are inclusive; index queries are
        # end-exclusive (same rule as Engine._fetch / remote read)
        end = _parse_time(q.get("end", [str(2**31)])[0]) + 1
        return ctx.db.query_ids(ctx.namespace, All(), start, end)

    def _labels(self, q):
        names = set()
        for d in self._fetch_docs(q):
            names.update(k.decode() for k in d.tags())
        return self._json(200, {"status": "success", "data": sorted(names)})

    def _label_values(self, name, q):
        values = set()
        for d in self._fetch_docs(q):
            v = d.tags().get(name.encode())
            if v is not None:
                values.add(v.decode())
        return self._json(200, {"status": "success", "data": sorted(values)})

    def _series(self, q):
        out = [
            {k.decode(): v.decode() for k, v in sorted(d.tags().items())}
            for d in self._fetch_docs(q)
        ]
        return self._json(200, {"status": "success", "data": out})


def _fmt(v: float) -> str:
    return repr(float(v)) if v == v else "NaN"


class ApiContext:
    """What the handlers serve: the database, its engine (on the
    database's device), admission, deadlines and the latency
    histograms, the shard migrator, the self-monitor and the controller
    whose status ``/health`` serves, the remote stores the default
    engine federates, and the Graphite engine."""

    def __init__(self, db: Database, namespace: str = "default",
                 downsampler=None, registry=None, tracer=None,
                 admission: AdmissionController | None = None,
                 query_timeout_s: float = 30.0,
                 slow_query_fraction: float = 0.75,
                 remotes=None, remotes_required: bool = False,
                 metrics_scope=None, checkpointer=None, migrator=None,
                 selfmon=None, controller=None):
        self.db = db
        self.selfmon = selfmon  # instrument.selfmon.SelfMonitor | None
        self.controller = controller  # x.controller.Controller | None
        self.migrator = migrator  # storage.migration.ShardMigrator | None
        self.namespace = namespace
        self.downsampler = downsampler
        self.registry = registry
        self.tracer = tracer
        self.checkpointer = checkpointer  # aggregator.checkpoint.AggregatorCheckpointer
        # Per-namespace engine interning for the ``namespace=`` query
        # param (bounded: namespaces are config objects, not request
        # input — an unknown name 400s before anything is built).
        self._ns_engines: dict = {}
        self._ns_engines_mu = threading.Lock()
        # read-path overload controls (see module docstring); the
        # default AdmissionController(0) gates nothing
        self.admission = admission or AdmissionController()
        self.query_timeout_s = float(query_timeout_s)
        self.slow_query_fraction = float(slow_query_fraction)
        self.slow_query_total = 0
        self._slow_mu = threading.Lock()
        self.slow_queries = collections.deque(maxlen=32)
        # Hot-path latency histograms, interned ONCE (per-request
        # intern is the metric-hygiene waste): coordinator ingest, and
        # query end-to-end + per-phase (fetch = storage time recorded
        # by the deadline's phase accumulator, eval = the rest).
        self.hist_ingest = self.hist_query = None
        self._hist_query_phase = {}
        if registry is not None:
            # under the node's metrics prefix (assembly passes its
            # prefixed scope) so the series merge across a fleet
            base = (metrics_scope if metrics_scope is not None
                    else registry.scope(""))
            self.hist_ingest = base.scope("ingest").histogram("seconds")
            qscope = base.scope("query")
            self.hist_query = qscope.histogram("seconds")
            self._hist_query_phase = {
                "fetch": qscope.tagged({"phase": "fetch"}).histogram(
                    "phase_seconds"),
                "eval": qscope.tagged({"phase": "eval"}).histogram(
                    "phase_seconds"),
            }
        # cross-coordinator federation: remote stores (query/remote
        # RemoteStorage) merged best-effort with the local database
        # unless remotes_required
        self.remotes = list(remotes or [])
        local = DatabaseStorage(db, namespace)
        if self.remotes:
            stores = [local] + self.remotes
            required = [0] + (list(range(1, len(stores)))
                              if remotes_required else [])
            storage = FederatedStorage(stores, required=required)
        else:
            storage = local
        self.engine = Engine(storage, tracer=tracer, device=db.device)
        from m3_tpu_torch.query.graphite import GraphiteEngine, GraphiteStorage

        self.graphite = GraphiteEngine(GraphiteStorage(db, namespace))

    def engine_for(self, namespace: str | None) -> Engine:
        """The engine serving one namespace: the default request path
        keeps the federated default-namespace engine; ``namespace=``
        gets a local-storage engine over that namespace, interned per
        name."""
        if namespace is None or namespace == self.namespace:
            return self.engine
        if namespace not in self.db.namespaces:
            raise ValueError(f"unknown namespace {namespace!r}")
        with self._ns_engines_mu:
            eng = self._ns_engines.get(namespace)
            if eng is None:
                eng = self._ns_engines[namespace] = Engine(
                    DatabaseStorage(self.db, namespace), tracer=self.tracer,
                    device=self.db.device)
            return eng

    def observe_query(self, kind: str, query: str, dl: Deadline,
                      error: Exception | None = None) -> None:
        """Slow-query log + latency histograms: every query lands in
        the windowed query histograms (end-to-end + fetch/eval phase
        split); queries that spent more than ``slow_query_fraction`` of
        their deadline (or died trying) additionally land in the
        slow-query log with matchers and per-phase timings — the
        operator's view of WHAT is eating the budget (`/health`
        ``query.slow``)."""
        elapsed = dl.elapsed()
        if self.hist_query is not None:
            self.hist_query.record(elapsed)
            fetch_s = dl.phases.get("fetch", 0.0)
            self._hist_query_phase["fetch"].record(fetch_s)
            self._hist_query_phase["eval"].record(max(0.0, elapsed - fetch_s))
        if self.slow_query_fraction <= 0 or dl.timeout_s <= 0:
            return
        frac = dl.elapsed() / dl.timeout_s
        if frac < self.slow_query_fraction:
            return  # fast queries — including fast failures — skip the log
        entry = {
            "kind": kind,
            "query": query,
            "timeout_s": round(dl.timeout_s, 3),
            "elapsed_s": round(dl.elapsed(), 3),
            "deadline_fraction": round(frac, 3),
            "phases": {k: round(v, 3) for k, v in dl.phases.items()},
            "time_unix": time.time(),
        }
        if dl.warnings:
            entry["warnings"] = list(dl.warnings)
        if error is not None:
            entry["error"] = f"{type(error).__name__}: {error}"
        with self._slow_mu:
            self.slow_query_total += 1
            self.slow_queries.append(entry)

    def query_status(self) -> dict:
        """The /health ``query`` document: admission gauges + the slow
        log tail."""
        out = self.admission.metrics()
        out["default_timeout_s"] = self.query_timeout_s
        with self._slow_mu:
            out["slow_query_total"] = self.slow_query_total
            out["slow"] = list(self.slow_queries)[-10:]
        return out


def make_server(ctx: ApiContext, host: str = "127.0.0.1", port: int = 0):
    """Returns a ThreadingHTTPServer bound to (host, port); port 0 picks
    a free one (server.server_address[1])."""
    handler = type("BoundHandler", (_Handler,), {"ctx": ctx})
    return ThreadingHTTPServer((host, port), handler)


def serve_background(ctx: ApiContext, host: str = "127.0.0.1", port: int = 0):
    srv = make_server(ctx, host, port)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv
