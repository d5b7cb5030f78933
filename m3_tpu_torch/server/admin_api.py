"""Admin API: namespace / placement / topic / runtime-option CRUD.  The
port's counterpart of ``m3_tpu/server/admin_api.py``: the same routes,
status codes and bodies over the port's KV, placements and bus.  The
reference's ``slo`` and ``controller`` sections of ``/health`` belong to
subsystems the port does not have, so its ``AdminContext`` takes no
selfmon or controller.

Equivalent of the reference's coordinator admin handlers
(`src/query/api/v1/handler/{namespace,placement...}` +
`cluster/placementhandler` + topic handlers): cluster metadata CRUD
over the KV control plane.  Routes:

    GET/POST          /api/v1/services/m3db/namespace
    DELETE            /api/v1/services/m3db/namespace/<name>
    GET/DELETE        /api/v1/services/m3db/placement
    POST              /api/v1/services/m3db/placement/init
    POST              /api/v1/services/m3db/placement          (add instance)
    POST              /api/v1/services/m3db/placement/replace  (body
                      {"leaving_id": ..., "instance": {...}}: the
                      newcomer takes the leaver's shards INITIALIZING,
                      streaming from it — the rolling node-replace verb)
    DELETE            /api/v1/services/m3db/placement/<instance_id>
                      (staged remove_instance while the instance still
                      owns shards; outright forget once it is drained —
                      also the dead-leaver cleanup)
    POST              /api/v1/topology/migrate                 (run one
                      shard-migration pass in-process now, instead of
                      waiting for the mediator tick)
    GET               /api/v1/topology/status                  (the same
                      migration-progress document /health embeds)
    GET/POST          /api/v1/topic
    GET/PUT           /api/v1/runtime                          (options)
    POST              /api/v1/database/scrub                   (on-demand
                      corruption sweep + peer repair; body optionally
                      {"budget": N volumes (0 = whole disk, the default),
                       "repair": bool})
    GET/POST          /api/v1/debug/faults                     (runtime
                      faultpoint re-arm: GET = armed specs + counters;
                      POST {"disarm": true|[points], "arm":
                      "point=mode[:k=v]*;...", "reset_counters": bool}
                      — the M3_FAULTPOINTS grammar, applied LIVE so a
                      chaos scheduler flips fault windows without
                      restarting the node; counters survive re-arm)

Every placement mutation goes through ``PlacementService.update`` — a
get→mutate→CAS loop with bounded retry on version conflict, so two
concurrent admin calls (or an admin call racing a node's cutover CAS)
both land instead of one 500ing.

Query-path overload controls live on the MAIN HTTP API
(server/http_api.py), not here: the read endpoints accept a
``timeout=`` param (end-to-end deadline, default
``query.default_timeout``) and map the typed overload errors to
**429** (resource limit), **503 + Retry-After** (admission shed) and
**504** (deadline exceeded); admission/breaker/slow-query state is
observable on every node's ``/health`` (``query`` section) and
``/metrics`` — see TESTING.md "Query deadlines, admission & breakers".
"""

from __future__ import annotations

import dataclasses
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from m3_tpu_torch.cluster.kv import KVStore
from m3_tpu_torch.cluster.namespace_registry import NamespaceMeta, NamespaceRegistry
from m3_tpu_torch.cluster.placement import (
    Instance, PlacementService, add_instance, forget_instance,
    initial_placement, remove_instance, replace_instance,
)
from m3_tpu_torch.core.runtime_options import RuntimeOptionsManager
from m3_tpu_torch.msg.bus import ConsumerService, ConsumptionType, Topic, TopicService


# Retention -> recommended block size ladder (reference
# handler/database/create.go recommendedBlockSizesByRetentionAsc).
_BLOCK_LADDER_HOURS = (
    (12, 0.5), (24, 1), (7 * 24, 2), (30 * 24, 12), (365 * 24, 24),
)


def _recommended_block_size(retention_nanos: int) -> int:
    hours = retention_nanos / 3600e9
    for upto, block in _BLOCK_LADDER_HOURS:
        if hours <= upto:
            return int(block * 3600 * 10**9)
    return 24 * 3600 * 10**9


def _parse_dur_nanos(s) -> int:
    from m3_tpu_torch.core.config import parse_duration

    return parse_duration(str(s))


class AdminContext:
    def __init__(self, kv: KVStore, db=None, aggregator=None, scrubber=None,
                 migrator=None, tracer=None):
        self.kv = kv
        self.namespaces = NamespaceRegistry(kv)
        self.placements = PlacementService(kv)
        self.topics = TopicService(kv)
        self.runtime = RuntimeOptionsManager(kv)
        self.aggregator = aggregator
        self.scrubber = scrubber
        self.migrator = migrator  # storage.migration.ShardMigrator | None
        # span-ring debug surface: defaults to the database's tracer so
        # the admin port serves the same ring as the main API's
        # /api/v1/debug/traces (dtest trace collection hits either)
        self.tracer = (tracer if tracer is not None
                       else getattr(db, "tracer", None))
        if db is not None:
            self.namespaces.attach(db)


def _parse_instance(body: dict) -> Instance:
    return Instance(body["id"], body.get("isolation_group", ""),
                    body.get("weight", 1),
                    shard_set_id=body.get("shard_set_id", 0),
                    endpoint=body.get("endpoint", ""))


class _AdminHandler(BaseHTTPRequestHandler):
    ctx: AdminContext = None

    def log_message(self, fmt, *args):
        pass

    def _json(self, code: int, obj) -> None:
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _body(self) -> dict:
        n = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(n)) if n else {}

    def do_GET(self):
        try:
            path = self.path.split("?")[0].rstrip("/")
            if path == "/health":
                # Admin-port liveness (the reference adds its slo and
                # controller sections here; the port has neither).
                return self._json(200, {"ok": True})
            if path == "/api/v1/debug/traces":
                # the same ring + filters the main API serves, through
                # the ONE shared response builder (tracing.
                # traces_response): trace collection must work through
                # whichever port a harness has (dtest joins spans from
                # every process) and the two handlers must not drift
                from urllib.parse import parse_qs, urlparse

                from m3_tpu_torch.instrument.tracing import traces_response

                tr = self.ctx.tracer
                if tr is None:
                    return self._json(404, {"error": "no tracer configured"})
                q = parse_qs(urlparse(self.path).query)
                return self._json(200, traces_response(
                    tr, trace_id=q.get("trace_id", [None])[0],
                    name=q.get("name", [None])[0]))
            if path == "/api/v1/debug/faults":
                # same shared builder as the main API (the
                # traces_response pattern): the chaos scheduler arms
                # through whichever port it holds
                from m3_tpu_torch.x import fault

                return self._json(200, fault.registry_response())
            if path == "/api/v1/services/m3db/namespace":
                return self._json(200, {
                    "registry": {
                        n: dataclasses.asdict(m)
                        for n, m in self.ctx.namespaces.all().items()
                    }
                })
            if path == "/api/v1/services/m3db/placement":
                p = self.ctx.placements.get()
                if p is None:
                    return self._json(404, {"error": "no placement"})
                return self._json(200, json.loads(p.to_json()))
            if path == "/api/v1/topic":
                names = [k.split("/", 1)[1] for k in self.ctx.kv.keys()
                         if k.startswith("_topic/")]
                return self._json(200, {"topics": names})
            if path.startswith("/api/v1/topic/"):
                t = self.ctx.topics.get(path.rsplit("/", 1)[1])
                if t is None:
                    return self._json(404, {"error": "no such topic"})
                return self._json(200, json.loads(t.to_json()))
            if path == "/api/v1/runtime":
                return self._json(200, self.ctx.runtime.snapshot())
            if path == "/api/v1/topology/status":
                if self.ctx.migrator is None:
                    return self._json(
                        404, {"error": "no shard migrator in this process "
                              "(db.instance_id not configured)"})
                return self._json(200, {"topology": self.ctx.migrator.status()})
            if path == "/api/v1/aggregator/status":
                # Engine operational counters incl. forwarded-tail
                # conflicts (the reference aggregator httpd's /status
                # role) — a silent-drop edge must be auditable from
                # outside the process.
                if self.ctx.aggregator is None:
                    return self._json(
                        404, {"error": "no aggregator in this process"})
                return self._json(
                    200, {"counters": self.ctx.aggregator.counters()})
            return self._json(404, {"error": f"unknown path {path}"})
        except Exception as e:  # noqa: BLE001 — API boundary
            return self._json(400, {"error": str(e)})

    def do_POST(self):
        try:
            path = self.path.split("?")[0].rstrip("/")
            body = self._body()
            if path == "/api/v1/services/m3db/namespace":
                meta = NamespaceMeta(**body)
                self.ctx.namespaces.add(meta)
                return self._json(200, dataclasses.asdict(meta))
            if path == "/api/v1/services/m3db/placement/init":
                instances = [_parse_instance(i) for i in body["instances"]]

                def init_mutate(cur):
                    if cur is not None:
                        raise ValueError(
                            "placement already exists; DELETE it first")
                    if body.get("mirrored", False):
                        # Aggregator-style HA placement (algo/mirrored.go):
                        # shard sets of RF instances sharing identical
                        # shards.
                        from m3_tpu_torch.cluster.placement_mirrored import (
                            mirrored_initial_placement,
                        )

                        return mirrored_initial_placement(
                            instances, body.get("num_shards", 64),
                            body.get("rf", 3),
                        )
                    return initial_placement(
                        instances, body.get("num_shards", 64),
                        body.get("rf", 3),
                    )

                p = self.ctx.placements.update(init_mutate)
                return self._json(200, json.loads(p.to_json()))
            if path == "/api/v1/services/m3db/placement":
                if self.ctx.placements.get() is None:
                    # 404, not 400: the resource is missing (run init),
                    # the request body may be perfectly fine
                    return self._json(404, {"error": "no placement; init first"})

                def add_mutate(p):
                    if p is None:
                        raise KeyError("no placement; init first")
                    if p.is_mirrored:
                        # Mirrored placements grow by whole shard sets
                        # of RF instances (algo/mirrored.go
                        # AddInstances); a solo add would break the
                        # mirror invariant.
                        insts = body.get("instances")
                        if not insts:
                            raise ValueError(
                                "mirrored placement: POST {'instances': "
                                "[RF members sharing a new shard_set_id]}")
                        from m3_tpu_torch.cluster.placement_mirrored import (
                            mirrored_add_group,
                        )

                        group = [_parse_instance(dict(i, shard_set_id=i[
                            "shard_set_id"])) for i in insts]
                        return mirrored_add_group(p, group)
                    return add_instance(p, _parse_instance(body))

                p2 = self.ctx.placements.update(add_mutate)
                return self._json(200, json.loads(p2.to_json()))
            if path == "/api/v1/services/m3db/placement/replace":
                # Rolling node replace (algo ReplaceInstances): the
                # newcomer takes exactly the leaver's shards
                # INITIALIZING with a streaming source; node-side
                # migrators do the rest.  Mirrored placements use the
                # mirror-preserving variant (the newcomer streams from
                # the SURVIVING mirror, algo/mirrored.go).
                if self.ctx.placements.get() is None:
                    return self._json(404, {"error": "no placement; init first"})
                new = _parse_instance(body["instance"])
                leaving = body["leaving_id"]

                def replace_mutate(p):
                    if p is None:
                        raise KeyError("no placement; init first")
                    if p.is_mirrored:
                        from m3_tpu_torch.cluster.placement_mirrored import (
                            mirrored_replace_instance,
                        )

                        return mirrored_replace_instance(p, leaving, new)
                    return replace_instance(p, leaving, new)

                p2 = self.ctx.placements.update(replace_mutate)
                return self._json(200, json.loads(p2.to_json()))
            if path == "/api/v1/topology/migrate":
                if self.ctx.migrator is None:
                    return self._json(
                        404, {"error": "no shard migrator in this process "
                              "(db.instance_id not configured)"})
                return self._json(200, {"migrate": self.ctx.migrator.tick()})
            if path == "/api/v1/database/create":
                # One-call bring-up (reference handler/database/create.go):
                # namespace with a retention-recommended block size, plus a
                # single-node placement when none exists ("local" type).
                name = body.get("namespaceName")
                if not name:
                    return self._json(400, {"error": "namespaceName required"})
                retention = _parse_dur_nanos(body.get("retentionTime", "48h"))
                block = _recommended_block_size(retention)
                meta = NamespaceMeta(
                    name=name, retention_nanos=retention,
                    block_size_nanos=block,
                    num_shards=int(body.get("numShards", 4)),
                )
                self.ctx.namespaces.add(meta)
                placement_out = None
                if (body.get("type", "local") == "local"
                        and self.ctx.placements.get() is None):
                    host = body.get("hostID", "m3db_local")

                    def local_mutate(cur):
                        if cur is not None:
                            return cur  # raced another create: keep it
                        return initial_placement(
                            [Instance(host)], num_shards=meta.num_shards,
                            rf=1)

                    p = self.ctx.placements.update(local_mutate)
                    placement_out = json.loads(p.to_json())
                return self._json(200, {
                    "namespace": dataclasses.asdict(meta),
                    "placement": placement_out,
                })
            if path == "/api/v1/debug/faults":
                # Runtime re-arm: validate-then-mutate through the ONE
                # shared grammar/applier in x/fault (disarm first, then
                # arm; counters preserved) — the soak's chaos scheduler
                # opens/closes wire-fault windows on live nodes here.
                from m3_tpu_torch.x import fault

                return self._json(200, fault.apply_request(body))
            if path == "/api/v1/database/scrub":
                # On-demand integrity sweep (reference ops run
                # verify_data_files out-of-band; here the scrubber is
                # in-process so the sweep also quarantines and repairs
                # from peers).  Default budget 0 = the whole disk.
                if self.ctx.scrubber is None:
                    return self._json(
                        404, {"error": "no scrubber in this process"})
                stats = self.ctx.scrubber.run_once(
                    budget=int(body.get("budget", 0)),
                    repair=bool(body.get("repair", True)),
                )
                return self._json(200, {"scrub": stats})
            if path == "/api/v1/topic":
                t = Topic(
                    body["name"], body.get("num_shards", 64),
                    tuple(
                        ConsumerService(
                            c["name"],
                            ConsumptionType(c.get("consumption", "shared")),
                        )
                        for c in body.get("consumer_services", [])
                    ),
                )
                self.ctx.topics.set(t)
                return self._json(200, json.loads(t.to_json()))
            return self._json(404, {"error": f"unknown path {path}"})
        except Exception as e:  # noqa: BLE001 — every failure must come
            # back as an HTTP error, never a dropped connection (config
            # parse errors, registry conflicts, placement validation...)
            code = 400 if isinstance(
                e, (KeyError, TypeError, ValueError)) else 500
            return self._json(code, {"error": f"{type(e).__name__}: {e}"})

    def do_PUT(self):
        try:
            path = self.path.split("?")[0].rstrip("/")
            if path == "/api/v1/runtime":
                body = self._body()
                # validate the WHOLE body before applying anything — a
                # partial apply followed by a 400 would leave the
                # operator believing nothing changed
                for name, value in body.items():
                    self.ctx.runtime.validate(name, value)
                for name, value in body.items():
                    self.ctx.runtime.set(name, value)
                return self._json(200, self.ctx.runtime.snapshot())
            return self._json(404, {"error": f"unknown path {path}"})
        except KeyError as e:
            return self._json(400, {"error": str(e)})

    def do_DELETE(self):
        try:
            path = self.path.split("?")[0].rstrip("/")
            if path.startswith("/api/v1/services/m3db/namespace/"):
                name = path.rsplit("/", 1)[1]
                if not self.ctx.namespaces.remove(name):
                    return self._json(404, {"error": f"no namespace {name}"})
                return self._json(200, {"deleted": name})
            if path == "/api/v1/services/m3db/placement":
                self.ctx.kv.delete(self.ctx.placements.key)
                return self._json(200, {"deleted": "placement"})
            if path.startswith("/api/v1/services/m3db/placement/"):
                # Instance removal: staged (remove_instance — shards go
                # INITIALIZING on survivors, streaming from the leaver)
                # while the instance still owns live shards; outright
                # forget once it is drained/empty — which also covers a
                # dead leaver whose shards were already re-homed.
                iid = path.rsplit("/", 1)[1]

                def rm_mutate(p):
                    if p is None:
                        raise KeyError("no placement")
                    if iid not in p.instances:
                        raise KeyError(f"no instance {iid}")
                    try:
                        # drained/dead-leaver entry: drop it outright
                        # (forget_instance owns the live-shard guard)
                        return forget_instance(p, iid)
                    except ValueError:
                        if p.is_mirrored:
                            # removing one loaded member would break the
                            # shard-set mirror invariant; the mirror
                            # verbs operate on whole groups
                            raise ValueError(
                                "mirrored placement: replace the member "
                                "(POST .../placement/replace) or remove "
                                "its whole shard set")
                        return remove_instance(p, iid)

                p2 = self.ctx.placements.update(rm_mutate)
                return self._json(200, json.loads(p2.to_json()))
            return self._json(404, {"error": f"unknown path {path}"})
        except KeyError as e:
            return self._json(404, {"error": str(e)})
        except Exception as e:  # noqa: BLE001
            return self._json(400, {"error": str(e)})


def serve_admin_background(ctx: AdminContext, host: str = "127.0.0.1",
                           port: int = 0) -> ThreadingHTTPServer:
    handler = type("BoundAdmin", (_AdminHandler,), {"ctx": ctx})
    srv = ThreadingHTTPServer((host, port), handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv
