"""The replicated storage cluster through the port's node entry points,
against the JAX package's, on the CPU.

Three dbnodes per package are booted with ``run_node`` (the port's on
``device="cpu"``) on one shared KV service (``KVServer``, the etcd
role), each with ``rpc_listen_port``, ``kv_endpoint`` and
``instance_id``; a placement of 8 shards at RF 3 goes into the KV and a
``ReplicatedSession.dynamic`` writes at MAJORITY, one node down for the
last scrapes.  The mediators flush, the down node is wiped and restarts
with ``db.peers`` and ``bootstrap_peers``, and every replica's filesets
come out sha256-equal to each other and to the JAX cluster's.  A fourth
node joins through the admin API's placement add and the mediators
stream, cut over and drop.  ``/health`` serves the migrator's
``topology`` section as the JAX node does, and ``node_main`` reports
its RPC and admin ports."""

import hashlib
import json
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import time
import types
import urllib.request

import numpy as np
import pytest

import m3_tpu.client.session as jsess
import m3_tpu.cluster.kv_remote as jkr
import m3_tpu.cluster.placement as jpl
import m3_tpu.core.config as jcfg
import m3_tpu.server.assembly as jasm
import m3_tpu.server.rpc as jrpc
import m3_tpu_torch.client.session as tsess
import m3_tpu_torch.cluster.kv_remote as tkr
import m3_tpu_torch.cluster.placement as tpl
import m3_tpu_torch.core.config as tcfg
import m3_tpu_torch.server.assembly as tasm
import m3_tpu_torch.server.rpc as trpc

REPO = pathlib.Path(__file__).resolve().parent.parent
SEC = 10**9
BLOCK = 2 * 3600 * SEC
T0 = (1_700_000_000 * SEC) // BLOCK * BLOCK
SHARDS = 8
FLUSH_AT = T0 + BLOCK + 10 * 60 * SEC + SEC

PKGS = {
    "jax": types.SimpleNamespace(sess=jsess, kr=jkr, pl=jpl, cfg=jcfg, asm=jasm, rpc=jrpc,
                                 node={}),
    "torch": types.SimpleNamespace(sess=tsess, kr=tkr, pl=tpl, cfg=tcfg, asm=tasm, rpc=trpc,
                                   node={"device": "cpu"}),
}


def _digests(root) -> dict:
    root = pathlib.Path(root)
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "data").rglob("*")) if p.is_file()}


def _config(P, root, name, kv_port, rpc_port=0, peers=(), admin=False):
    c = P.cfg
    return c.NodeConfig(
        db=c.DBConfig(root=str(root), namespaces={"default": c.NamespaceConfig(
            num_shards=SHARDS, slot_capacity=1 << 10, sample_capacity=1 << 12)},
            rpc_listen_port=rpc_port, kv_endpoint=f"127.0.0.1:{kv_port}", instance_id=name,
            peers=list(peers), bootstrap_peers=bool(peers)),
        coordinator=c.CoordinatorConfig(listen_port=0, admin_listen_port=0) if admin else None,
        mediator=c.MediatorConfig(tick_interval="24h", scrub_volumes=0, migrate_blocks=0))


def _wait(pred, what, timeout=30.0):
    t0 = time.monotonic()
    while not pred():
        assert time.monotonic() - t0 < timeout, what
        time.sleep(0.05)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return json.load(r)


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method="POST",
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.load(r)


def _cluster_run(P, root):
    """The cluster's life in one package; returns what it observed."""
    kvs = P.kr.serve_kv_background(root=str(root))
    kv = P.kr.RemoteKVStore(("127.0.0.1", kvs.port), watch_poll_s=0.05, timeout_s=30.0)
    asms, ports, sess = {}, {}, None

    def boot(name, peers=(), admin=False):
        asms[name] = P.asm.run_node(_config(P, root / name, name, kvs.port,
                                            ports.get(name, 0),
                                            [f"127.0.0.1:{ports[p]}" for p in peers], admin),
                                    **P.node)
        ports[name] = asms[name].rpc_port

    def settle():
        v = kv.get("placement").version
        for name, a in asms.items():
            _wait(lambda: a.topology.view().version >= v, f"{name} at v{v}")

    try:
        for name in "ABC":
            boot(name, admin=(name == "A"))
        admin = asms["A"].admin_port
        out = {"init": _post(admin, "/api/v1/services/m3db/placement/init", {
            "instances": [{"id": n, "isolation_group": f"g{k}",
                           "endpoint": f"127.0.0.1:{ports[n]}"} for k, n in enumerate("ABC")],
            "num_shards": SHARDS, "rf": 3})}
        settle()
        out["health"] = _get(asms["A"].port, "/health")["topology"]

        def resolve(inst):
            host, _, port = inst.endpoint.rpartition(":")
            return P.rpc.RemoteDatabase((host, int(port)), timeout_s=30.0)

        sess = P.sess.ReplicatedSession.dynamic(kv, resolve)
        rng = np.random.default_rng(12)
        ids = [b"node%03d.gauge" % i for i in range(64)]
        vals = np.round(rng.normal(50, 5, (6, len(ids))), 2)
        for k in range(6):
            if k == 4:  # C's RPC listener down for the last two scrapes
                asms["C"].rpc_server.shutdown()
                asms["C"].rpc_server.server_close()
                asms["C"].rpc_server = None
                sess.connections["C"].close()
            t = np.full(len(ids), T0 + k * 10 * SEC, np.int64)
            assert sess.write_batch("default", ids, t, vals[k],
                                    now_nanos=T0 + (k + 1) * 10 * SEC) == 0
        for name in "AB":
            asms[name].mediator.run_once(FLUSH_AT)
        asms["C"].close()
        shutil.rmtree(root / "C")
        boot("C", peers="AB")
        files = {n: _digests(root / n) for n in "ABC"}
        assert files["A"] == files["B"] == files["C"] and files["A"]
        out["files"] = files["A"]
        out["reads"] = sess.fetch_batch("default", ids, T0, T0 + BLOCK)
        assert all(len(p) == 6 for p in out["reads"])
        # D joins through the admin API; the mediators stream, cut over, drop
        boot("D")
        out["add"] = _post(admin, "/api/v1/services/m3db/placement", {
            "id": "D", "isolation_group": "g3", "endpoint": f"127.0.0.1:{ports['D']}"})
        settle()
        out["migrate"] = asms["D"].mediator.run_once(FLUSH_AT)["topology"]
        settle()
        dropped = 0
        for _ in range(4):
            for name in "ABC":
                dropped += asms[name].mediator.run_once(FLUSH_AT)["topology"]["shards_dropped"]
        out["dropped"] = dropped
        out["final"] = _get(asms["A"].admin_port, "/api/v1/services/m3db/placement")
        out["status"] = _get(admin, "/api/v1/topology/status")
        out["reads_after"] = sess.fetch_batch("default", ids, T0, T0 + BLOCK)
        assert out["reads_after"] == out["reads"]
        out["d_files"] = _digests(root / "D")
    finally:
        if sess is not None:
            sess.close()
        for a in asms.values():
            a.close()
        kv.close()
        kvs.shutdown()
        kvs.server_close()
    return out


def test_three_node_cluster_through_run_node_matches_jax(tmp_path):
    got = {}
    for side, P in PKGS.items():
        (tmp_path / side).mkdir()
        got[side] = _cluster_run(P, tmp_path / side)
    # ephemeral ports differ between the runs; everything else is equal
    for out in got.values():
        for inst in out["init"]["instances"].values():
            inst.pop("endpoint")
        for inst in out["add"]["instances"].values():
            inst.pop("endpoint")
        for inst in out["final"]["instances"].values():
            inst.pop("endpoint")
    assert got["torch"] == got["jax"]
    assert got["torch"]["migrate"]["cutovers"] > 0
    assert got["torch"]["dropped"] == got["torch"]["migrate"]["cutovers"]


def test_node_main_reports_rpc_and_admin_ports(tmp_path):
    """``node_main`` with ``rpc_listen_port``, ``instance_id`` and
    ``admin_listen_port`` on a file-backed KV: ``node.json`` names the
    RPC and admin ports, a ``RemoteDatabase`` writes through the RPC port,
    the placement goes in through the admin port, ``/health`` serves the
    topology, and SIGTERM drains to exit 0."""
    root = tmp_path / "root"
    cfg = tmp_path / "node.json"
    cfg.write_text(json.dumps({
        "db": {"root": str(root), "rpc_listen_port": 0, "instance_id": "n0",
               "namespaces": {"default": {"num_shards": 4}}},
        "coordinator": {"listen_port": 0, "admin_listen_port": 0},
        "mediator": {"tick_interval": "24h"}}))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "m3_tpu_torch.server.node_main", str(cfg), "--device", "cpu"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        status = root / "node.json"
        _wait(lambda: status.exists() or proc.poll() is not None, "node.json", 120)
        assert proc.poll() is None, proc.stdout.read().decode()
        info = json.loads(status.read_text())
        assert info["rpc_port"] and info["admin_port"] and info["device"] == "cpu"
        _post(info["admin_port"], "/api/v1/services/m3db/placement/init", {
            "instances": [{"id": "n0", "endpoint": f"127.0.0.1:{info['rpc_port']}"}],
            "num_shards": 4, "rf": 1})
        topo = _get(info["port"], "/health")["topology"]
        assert topo["in_placement"] and topo["shards"]["available"] == [0, 1, 2, 3]
        r = trpc.RemoteDatabase(("127.0.0.1", info["rpc_port"]), timeout_s=30.0)
        try:
            r.write_batch("default", [b"a"], np.array([T0 + SEC]), np.array([1.0]),
                          now_nanos=T0 + SEC)
            assert r.read("default", b"a", T0, T0 + BLOCK) == [(T0 + SEC, 1.0)]
        finally:
            r.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, proc.stdout.read().decode()
        assert not status.exists()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_rpc_write_gate_at_critical_disk_matches_jax(tmp_path):
    """With ``disk.enabled`` the RPC listener refuses write batches at the
    CRITICAL watermark with the typed capacity error (reads are never
    gated), as the JAX node's does: a reserve as large as the quota
    makes the root CRITICAL at once."""
    import m3_tpu.x.diskbudget as jdisk
    import m3_tpu_torch.x.diskbudget as tdisk

    out = {}
    for side, P in PKGS.items():
        disk = jdisk if side == "jax" else tdisk
        cfg = P.cfg.load_config(json.dumps({
            "db": {"root": str(tmp_path / side), "rpc_listen_port": 0,
                   "namespaces": {"default": {"num_shards": 2}}},
            "mediator": {"enabled": False},
            "disk": {"enabled": True, "capacity": "1K", "reserve": "1K"}}))
        asm = P.asm.run_node(cfg, **P.node)
        try:
            assert asm.rpc_server.ingest_gate is disk.check_ingest
            disk.refresh()
            r = P.rpc.RemoteDatabase(("127.0.0.1", asm.rpc_port), timeout_s=30.0)
            try:
                with pytest.raises(P.rpc.RemoteError) as e:
                    r.write_batch("default", [b"a"], np.array([T0 + SEC]), np.array([1.0]),
                                  now_nanos=T0 + SEC)
                out[side] = (str(e.value).split(":")[0], r.read("default", b"a", T0, T0 + BLOCK))
            finally:
                r.close()
        finally:
            asm.close()
            disk.reset()
    assert out["torch"] == out["jax"] == ("DiskCapacityError", [])
