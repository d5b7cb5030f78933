"""m3_tpu_torch.server.admin_api, cluster.namespace_registry and
core.runtime_options against the JAX package's on the CPU.

Each case of ``tests/test_admin_api.py`` runs once through each package
(the port's ``Database`` on ``device="cpu"``): the reference's assertions
hold on both, and every status code and response body, and every KV
document written, is equal.  The node's assembly wires the admin port
(``coordinator.admin_listen_port``) and replays tuned limits on a
restart in both packages."""

import json
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import m3_tpu.cluster.kv as jkv
import m3_tpu.cluster.namespace_registry as jnr
import m3_tpu.core.runtime_options as jro
import m3_tpu.server.admin_api as jadmin
import m3_tpu.server.assembly as jasm
import m3_tpu.storage.database as jdb
import m3_tpu_torch.cluster.kv as tkv
import m3_tpu_torch.cluster.namespace_registry as tnr
import m3_tpu_torch.core.runtime_options as tro
import m3_tpu_torch.server.admin_api as tadmin
import m3_tpu_torch.server.assembly as tasm
import m3_tpu_torch.storage.database as tdb

BLOCK = 2 * 3600 * 10**9
START = (1_700_000_000 * 10**9) // BLOCK * BLOCK

PKGS = {
    "jax": types.SimpleNamespace(kv=jkv, nr=jnr, ro=jro, admin=jadmin, asm=jasm, db=jdb,
                                 dev={}, node={}),
    "torch": types.SimpleNamespace(kv=tkv, nr=tnr, ro=tro, admin=tadmin, asm=tasm, db=tdb,
                                   dev={"device": "cpu"}, node={"device": "cpu"}),
}


def both(scenario, tmp_path=None):
    out = {}
    for side, P in PKGS.items():
        root = None
        if tmp_path is not None:
            root = tmp_path / side
            root.mkdir()
        out[side] = scenario(P, root)
    assert out["torch"] == out["jax"]
    return out["torch"]


def _req(base, method, path, body=None):
    r = urllib.request.Request(base + path, method=method,
                               data=json.dumps(body).encode() if body is not None else None)
    try:
        with urllib.request.urlopen(r, timeout=30) as resp:
            return resp.status, json.load(resp)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def _db(P, root, num_shards=1):
    return P.db.Database(P.db.DatabaseOptions(root=str(root)),
                         namespaces={"default": P.db.NamespaceOptions(num_shards=num_shards)},
                         **P.dev)


# ---- runtime options --------------------------------------------------------


def test_set_get_and_listeners():
    def run(P, _):
        mgr = P.ro.RuntimeOptionsManager(P.kv.KVStore())
        assert mgr.get("max_series_read") == 0
        seen = []
        mgr.on_change("max_series_read", seen.append)
        mgr.set("max_series_read", 500)
        assert mgr.get("max_series_read") == 500 and seen == [500]
        return mgr.snapshot(), mgr.kv.get("runtime/max_series_read").data
    both(run)


def test_unknown_option_rejected():
    def run(P, _):
        mgr = P.ro.RuntimeOptionsManager(P.kv.KVStore())
        errs = []
        for fn in (lambda: mgr.set("nope", 1), lambda: mgr.get("nope"),
                   lambda: mgr.validate("max_series_read", "lots"),
                   lambda: mgr.on_change("nope", print)):
            with pytest.raises(KeyError) as e:
                fn()
            errs.append(str(e.value))
        return errs
    both(run)


def test_shared_kv_converges_two_managers(tmp_path):
    def run(P, root):
        m1 = P.ro.RuntimeOptionsManager(P.kv.KVStore(str(root)))
        m1.set("max_docs_matched", 1234)
        m2 = P.ro.RuntimeOptionsManager(P.kv.KVStore(str(root)))
        assert m2.get("max_docs_matched") == 1234
        return m2.snapshot()
    both(run, tmp_path)
    # each package reads the KV file the other wrote
    assert tro.RuntimeOptionsManager(tkv.KVStore(str(tmp_path / "jax"))).get(
        "max_docs_matched") == 1234
    assert jro.RuntimeOptionsManager(jkv.KVStore(str(tmp_path / "torch"))).get(
        "max_docs_matched") == 1234


def test_malformed_kv_value_ignored():
    def run(P, _):
        kv = P.kv.KVStore()
        mgr = P.ro.RuntimeOptionsManager(kv)
        kv.set("runtime/max_series_read", b"not json{")
        assert mgr.get("max_series_read") == 0  # the default survives
        return mgr.snapshot()
    both(run)


# ---- dynamic namespaces -----------------------------------------------------


def test_attach_materializes_existing_and_future(tmp_path):
    def run(P, root):
        kv = P.kv.KVStore()
        reg = P.nr.NamespaceRegistry(kv)
        reg.add(P.nr.NamespaceMeta("agg_1m", num_shards=2))
        db = _db(P, root)
        reg.attach(db)
        assert "agg_1m" in db.namespaces  # existing at attach
        reg.add(P.nr.NamespaceMeta("agg_1h", num_shards=2,
                                   retention_nanos=365 * 86400 * 10**9))
        assert "agg_1h" in db.namespaces  # future, via the watch
        assert db.namespaces["agg_1h"].opts.retention_nanos == 365 * 86400 * 10**9
        db.write_batch("agg_1h", [b"x"], np.asarray([START], np.int64), np.asarray([1.0]))
        got = db.read("agg_1h", b"x", START, START + BLOCK)
        assert got
        db.close()
        return got, kv.get("namespaces").data, sorted(db.namespaces)
    both(run, tmp_path)


def test_duplicate_add_rejected():
    def run(P, _):
        reg = P.nr.NamespaceRegistry(P.kv.KVStore())
        reg.add(P.nr.NamespaceMeta("a"))
        with pytest.raises(ValueError) as e:
            reg.add(P.nr.NamespaceMeta("a"))
        assert not reg.remove("b") and reg.remove("a")
        return str(e.value)
    both(run)


def test_concurrent_adds_do_not_lose_namespaces():
    def run(P, _):
        reg = P.nr.NamespaceRegistry(P.kv.KVStore())
        errs = []

        def add(k):
            try:
                reg.add(P.nr.NamespaceMeta(f"ns{k}"))
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=add, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads) and not errs
        assert len(reg.all()) == 8
        return sorted(reg.all())
    both(run)


# ---- the admin API ---------------------------------------------------------


def _served(P, root, fn):
    kv = P.kv.KVStore()
    db = _db(P, root)
    srv = P.admin.serve_admin_background(P.admin.AdminContext(kv, db))
    try:
        return fn(f"http://127.0.0.1:{srv.server_address[1]}", db, kv)
    finally:
        srv.shutdown()
        srv.server_close()
        db.close()


def test_namespace_crud_reaches_database(tmp_path):
    def run(P, root):
        def body(base, db, kv):
            out = [_req(base, "POST", "/api/v1/services/m3db/namespace",
                        {"name": "agg_10s", "num_shards": 2})]
            assert out[0][0] == 200 and "agg_10s" in db.namespaces  # dynamic attach
            out.append(_req(base, "GET", "/api/v1/services/m3db/namespace"))
            assert "agg_10s" in out[-1][1]["registry"]
            out.append(_req(base, "DELETE", "/api/v1/services/m3db/namespace/agg_10s"))
            assert out[-1][0] == 200
            out.append(_req(base, "GET", "/api/v1/services/m3db/namespace"))
            assert "agg_10s" not in out[-1][1]["registry"]
            out.append(_req(base, "DELETE", "/api/v1/services/m3db/namespace/agg_10s"))
            out.append(_req(base, "POST", "/api/v1/database/create",
                            {"namespaceName": "metrics", "retentionTime": "168h"}))
            out.append(_req(base, "GET", "/api/v1/nope"))
            return out
        return _served(P, root, body)
    both(run, tmp_path)


def test_placement_init_and_add(tmp_path):
    def run(P, root):
        def body(base, db, kv):
            out = [_req(base, "GET", "/api/v1/services/m3db/placement")]
            assert out[0][0] == 404
            out.append(_req(base, "POST", "/api/v1/services/m3db/placement",
                            {"id": "n0"}))  # no placement yet: 404
            out.append(_req(base, "POST", "/api/v1/services/m3db/placement/init", {
                "instances": [{"id": "n1", "isolation_group": "a"},
                              {"id": "n2", "isolation_group": "b"}],
                "num_shards": 8, "rf": 2}))
            assert out[-1][0] == 200 and out[-1][1]["num_shards"] == 8
            out.append(_req(base, "POST", "/api/v1/services/m3db/placement",
                            {"id": "n3", "isolation_group": "c"}))
            assert out[-1][0] == 200 and "n3" in out[-1][1]["instances"]
            out.append(_req(base, "POST", "/api/v1/services/m3db/placement/init",
                            {"instances": [{"id": "x"}]}))  # exists already: 400
            return out, kv.get("placement").data
        return _served(P, root, body)
    both(run, tmp_path)


def test_placement_replace_and_instance_delete(tmp_path):
    def run(P, root):
        def body(base, db, kv):
            out = [_req(base, "POST", "/api/v1/services/m3db/placement/init", {
                "instances": [{"id": "n1", "endpoint": "127.0.0.1:9001"},
                              {"id": "n2", "endpoint": "127.0.0.1:9002"}],
                "num_shards": 4, "rf": 2})]
            out.append(_req(base, "POST", "/api/v1/services/m3db/placement/replace",
                            {"leaving_id": "n2",
                             "instance": {"id": "n3", "endpoint": "127.0.0.1:9003"}}))
            code, rep = out[-1]
            assert code == 200 and rep["instances"]["n3"]["endpoint"] == "127.0.0.1:9003"
            assert all(st == "I" and src == "n2"
                       for st, src in rep["instances"]["n3"]["shards"].values())
            assert all(st == "L" for st, _ in rep["instances"]["n2"]["shards"].values())
            out.append(_req(base, "DELETE", "/api/v1/services/m3db/placement"))
            out.append(_req(base, "POST", "/api/v1/services/m3db/placement/init", {
                "instances": [{"id": "m1"}, {"id": "m2"}, {"id": "m3"}],
                "num_shards": 6, "rf": 1}))
            out.append(_req(base, "DELETE", "/api/v1/services/m3db/placement/m1"))
            code, rm = out[-1]
            assert code == 200
            assert all(st == "L" for st, _ in rm["instances"]["m1"]["shards"].values())
            takers = [(iid, s) for iid, inst in rm["instances"].items()
                      for s, (st, src) in inst["shards"].items() if st == "I"]
            assert takers and all(rm["instances"][i]["shards"][s][1] == "m1"
                                  for i, s in takers)
            out.append(_req(base, "DELETE", "/api/v1/services/m3db/placement/ghost"))
            assert out[-1][0] == 404
            return out
        return _served(P, root, body)
    both(run, tmp_path)


def test_mirrored_placement_routes(tmp_path):
    def run(P, root):
        def body(base, db, kv):
            out = [_req(base, "POST", "/api/v1/services/m3db/placement/init", {
                "instances": [{"id": f"a{k}", "isolation_group": f"g{k}", "shard_set_id": 1}
                              for k in range(2)],
                "num_shards": 4, "rf": 2, "mirrored": True})]
            out.append(_req(base, "POST", "/api/v1/services/m3db/placement", {"id": "solo"}))
            out.append(_req(base, "POST", "/api/v1/services/m3db/placement", {
                "instances": [{"id": f"b{k}", "isolation_group": f"g{k}", "shard_set_id": 2}
                              for k in range(2)]}))
            out.append(_req(base, "POST", "/api/v1/services/m3db/placement/replace", {
                "leaving_id": "a0", "instance": {"id": "c0", "isolation_group": "g0",
                                                 "shard_set_id": 1}}))
            out.append(_req(base, "DELETE", "/api/v1/services/m3db/placement/b1"))
            return out
        return _served(P, root, body)
    both(run, tmp_path)


def test_concurrent_add_instance_both_land(tmp_path):
    """Two racing add-instance calls read the same base placement
    version; the CAS loser retries and lands (both 200)."""
    def run(P, _):
        kv = P.kv.KVStore()
        real_cas = kv.check_and_set
        barrier = threading.Barrier(2, timeout=10)
        state = {"n": 0}
        lock = threading.Lock()

        def synced_cas(key, expect, data):
            with lock:
                state["n"] += 1
                n = state["n"]
            if 2 <= n <= 3:  # the two racing add-instance CAS attempts
                try:
                    barrier.wait()
                except threading.BrokenBarrierError:
                    pass
            return real_cas(key, expect, data)

        kv.check_and_set = synced_cas
        srv = P.admin.serve_admin_background(P.admin.AdminContext(kv))
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            code, _ = _req(base, "POST", "/api/v1/services/m3db/placement/init",
                           {"instances": [{"id": "n1"}], "num_shards": 4, "rf": 1})
            assert code == 200
            results = []
            threads = [threading.Thread(target=lambda iid=iid: results.append(
                (iid,) + _req(base, "POST", "/api/v1/services/m3db/placement", {"id": iid})))
                for iid in ("ra", "rb")]
            for t in threads:
                t.start()
            for t in threads:
                t.join(20)
            assert len(results) == 2 and all(c == 200 for _, c, _ in results), results
            code, out = _req(base, "GET", "/api/v1/services/m3db/placement")
            assert {"ra", "rb"} <= set(out["instances"]) and state["n"] >= 4
            return sorted(out["instances"]), kv.get("placement").version
        finally:
            srv.shutdown()
            srv.server_close()
    both(run)


def test_topic_crud(tmp_path):
    def run(P, root):
        def body(base, db, kv):
            out = [_req(base, "POST", "/api/v1/topic", {
                "name": "agg_out", "num_shards": 4,
                "consumer_services": [{"name": "coordinator"}]})]
            assert out[0][0] == 200
            out.append(_req(base, "GET", "/api/v1/topic"))
            assert out[-1][1]["topics"] == ["agg_out"]
            out.append(_req(base, "GET", "/api/v1/topic/agg_out"))
            assert out[-1][1]["num_shards"] == 4
            out.append(_req(base, "GET", "/api/v1/topic/none"))
            return out, kv.get("_topic/agg_out").data
        return _served(P, root, body)
    both(run, tmp_path)


def test_runtime_options_over_http(tmp_path):
    def run(P, root):
        def body(base, db, kv):
            out = [_req(base, "PUT", "/api/v1/runtime", {"max_series_read": 99})]
            assert out[0][0] == 200 and out[0][1]["max_series_read"] == 99
            out.append(_req(base, "GET", "/api/v1/runtime"))
            assert out[-1][1]["max_series_read"] == 99
            out.append(_req(base, "PUT", "/api/v1/runtime", {"bogus": 1}))
            assert out[-1][0] == 400
            return out
        return _served(P, root, body)
    both(run, tmp_path)


def test_bad_namespace_body(tmp_path):
    def run(P, root):
        def body(base, db, kv):
            out = _req(base, "POST", "/api/v1/services/m3db/namespace", {"nope": True})
            assert out[0] == 400
            return out
        return _served(P, root, body)
    both(run, tmp_path)


def test_runtime_put_is_atomic(tmp_path):
    """A body with one bad key applies nothing."""
    def run(P, root):
        def body(base, db, kv):
            out = [_req(base, "PUT", "/api/v1/runtime", {"max_series_read": 77, "bogus": 1})]
            assert out[0][0] == 400
            out.append(_req(base, "GET", "/api/v1/runtime"))
            assert out[-1][1]["max_series_read"] == 0  # untouched
            return out
        return _served(P, root, body)
    both(run, tmp_path)


def test_runtime_type_validation(tmp_path):
    def run(P, root):
        def body(base, db, kv):
            out = _req(base, "PUT", "/api/v1/runtime", {"max_series_read": "lots"})
            assert out[0] == 400
            return out
        return _served(P, root, body)
    both(run, tmp_path)


def test_health_faults_and_missing_subsystems(tmp_path):
    """The admin port's liveness, the fault registry, and the routes whose
    subsystem this process lacks (404 with the reference's bodies).  Each
    package's fault counters start at zero: they are process-global, and
    other tests in the process leave theirs."""
    from m3_tpu.x import fault as jfault
    from m3_tpu_torch.x import fault as tfault

    jfault.reset_counters()
    tfault.reset_counters()

    def run(P, root):
        def body(base, db, kv):
            out = [_req(base, "GET", "/health")]
            for path in ("/api/v1/topology/status", "/api/v1/aggregator/status",
                         "/api/v1/debug/traces"):
                out.append(_req(base, "GET", path))
            out.append(_req(base, "POST", "/api/v1/topology/migrate", {}))
            out.append(_req(base, "POST", "/api/v1/database/scrub", {}))
            out.append(_req(base, "GET", "/api/v1/debug/faults"))
            return out
        return _served(P, root, body)
    both(run, tmp_path)


def test_persisted_limits_reapply_on_restart(tmp_path):
    """Tuned limits survive a node restart: the KV watch fires before the
    limit listeners exist, so ``run_node`` replays the persisted value."""
    def run(P, root):
        cfg = f"""
db:
  root: {root}
  namespaces:
    default: {{num_shards: 1}}
coordinator: {{listen_port: 0, admin_listen_port: 0}}
mediator: {{enabled: false}}
"""
        asm = P.asm.run_node(cfg, **P.node)
        try:
            out = [_req(f"http://127.0.0.1:{asm.admin_port}", "PUT", "/api/v1/runtime",
                        {"max_series_read": 1})]
        finally:
            asm.close()
        asm2 = P.asm.run_node(cfg, **P.node)
        try:
            t0 = START // 10**9
            samples = [{"tags": {"__name__": "m", "i": str(i)}, "timestamp": t0,
                        "value": 1.0} for i in range(4)]
            urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{asm2.port}/api/v1/json/write",
                data=json.dumps(samples).encode()), timeout=30)
            q = (f"http://127.0.0.1:{asm2.port}/api/v1/query_range?"
                 f"query=m&start={t0}&end={t0 + 10}&step=10s")
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(q, timeout=30)
            assert ei.value.code == 429  # limit=1 is live after the restart
            out.append((ei.value.code, json.load(ei.value)))
            out.append(_req(f"http://127.0.0.1:{asm2.admin_port}", "GET", "/api/v1/runtime"))
        finally:
            asm2.close()
        return out
    both(run, tmp_path)
