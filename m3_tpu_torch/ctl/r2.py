"""R2: the rules-management service (HTTP CRUD over versioned rulesets).

Equivalent of the reference's r2/ctl service (`src/ctl` — an HTTP API
for editing mapping/rollup rules with versioning, backing the rules UI;
rules live in KV and the matcher watches them,
`src/metrics/rules/store`).  Endpoints:

    GET    /api/v1/rules                       list namespaces
    GET    /api/v1/rules/<namespace>           fetch ruleset (with version)
    PUT    /api/v1/rules/<namespace>           replace ruleset; body must
                                               carry the expected current
                                               version (optimistic CAS —
                                               conflicting editors get 409)
    DELETE /api/v1/rules/<namespace>           tombstone the namespace

Downstream consumers (the coordinator downsampler's matcher) watch the
same KV key and hot-reload on version change.

The port's copy of ``m3_tpu/ctl/r2.py`` over the port's ``cluster/kv``
and ``metrics/rules_json``: the same routes, answers and KV bytes.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from m3_tpu_torch.cluster.kv import KVStore
from m3_tpu_torch.metrics.rules import RuleSet
from m3_tpu_torch.metrics.rules_json import ruleset_from_json, ruleset_to_json

KEY_PREFIX = "rules/"


class RulesStore:
    """Versioned ruleset storage over KV (reference rules/store/kv)."""

    def __init__(self, kv: KVStore):
        self.kv = kv

    def _key(self, namespace: str) -> str:
        return KEY_PREFIX + namespace

    def namespaces(self) -> list[str]:
        return sorted(
            k[len(KEY_PREFIX):] for k in self.kv.keys()
            if k.startswith(KEY_PREFIX) and self.get(k[len(KEY_PREFIX):])
        )

    def get(self, namespace: str) -> RuleSet | None:
        """None for absent AND tombstoned namespaces."""
        vv = self.kv.get(self._key(namespace))
        if vv is None:
            return None
        doc = json.loads(vv.data)
        if doc.get("tombstoned"):
            return None
        rs = ruleset_from_json(doc)
        rs.version = vv.version
        return rs

    def set(self, namespace: str, rs: RuleSet,
            expected_version: int | None) -> RuleSet:
        """CAS update: expected_version None means create-only.  Both
        paths use the KV store's atomic primitives — a racing create or
        interleaved write surfaces as VersionConflict, never a silent
        overwrite."""
        data = json.dumps(ruleset_to_json(rs)).encode()
        key = self._key(namespace)
        try:
            if expected_version is None:
                cur = self.kv.get(key)
                if cur is not None and json.loads(cur.data).get("tombstoned"):
                    # recreating a tombstoned namespace continues its
                    # version history
                    new_version = self.kv.check_and_set(key, cur.version, data)
                else:
                    new_version = self.kv.set_if_not_exists(key, data)
            else:
                new_version = self.kv.check_and_set(key, expected_version, data)
        except (KeyError, ValueError) as e:
            raise VersionConflict(str(e)) from None
        rs.version = new_version
        return rs

    def delete(self, namespace: str) -> bool:
        """Tombstone, not hard delete: watchers must observe the removal
        (KV only notifies on set), and the version history survives —
        the reference tombstones rules the same way."""
        key = self._key(namespace)
        if self.get(namespace) is None:
            return False
        self.kv.set(key, json.dumps(
            {"namespace": namespace, "tombstoned": True}
        ).encode())
        return True

    def watch(self, namespace: str, fn) -> None:
        self.kv.watch(self._key(namespace), fn)


class VersionConflict(RuntimeError):
    pass


class _R2Handler(BaseHTTPRequestHandler):
    store: RulesStore = None

    def log_message(self, fmt, *args):
        pass

    def _json(self, code: int, obj) -> None:
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _ns(self) -> str | None:
        parts = self.path.split("?")[0].strip("/").split("/")
        # api/v1/rules[/<ns>]
        if parts[:3] != ["api", "v1", "rules"]:
            return None
        return parts[3] if len(parts) > 3 else ""

    def do_GET(self):
        ns = self._ns()
        if ns is None:
            return self._json(404, {"error": "unknown path"})
        if ns == "":
            return self._json(200, {"namespaces": self.store.namespaces()})
        rs = self.store.get(ns)
        if rs is None:
            return self._json(404, {"error": f"no rules for {ns}"})
        return self._json(200, ruleset_to_json(rs))

    def do_PUT(self):
        ns = self._ns()
        if not ns:
            return self._json(404, {"error": "namespace required"})
        try:
            body = json.loads(
                self.rfile.read(int(self.headers.get("Content-Length", 0)))
            )
            rs = ruleset_from_json(body)
            rs.namespace = ns
            expected = body.get("expected_version")
            out = self.store.set(ns, rs, expected)
        except VersionConflict as e:
            return self._json(409, {"error": str(e)})
        except (ValueError, KeyError, AttributeError, TypeError) as e:
            # malformed documents (non-dict body, wrongly-typed fields)
            # must be a 400, not a dropped connection
            return self._json(400, {"error": f"bad ruleset: {e}"})
        return self._json(200, ruleset_to_json(out))

    def do_DELETE(self):
        ns = self._ns()
        if not ns:
            return self._json(404, {"error": "namespace required"})
        if not self.store.delete(ns):
            return self._json(404, {"error": f"no rules for {ns}"})
        return self._json(200, {"deleted": ns})


def serve_r2_background(store: RulesStore, host: str = "127.0.0.1",
                        port: int = 0) -> ThreadingHTTPServer:
    handler = type("BoundR2", (_R2Handler,), {"store": store})
    srv = ThreadingHTTPServer((host, port), handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv
