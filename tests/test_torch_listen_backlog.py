"""The listen backlog of the port's socket servers against the JAX
package's, on the CPU.

Every server the two packages run (the node's HTTP API, the admin API,
the dbnode RPC server, the KV service) is a ``socketserver`` server with
its default ``request_queue_size`` of 5.  Bound but not yet accepting,
each takes the same number of twelve connects in both packages, dialled
one at a time so that which dial finds the accept queue full does not
depend on thread scheduling; the rest wait for the kernel's SYN retry,
and once the server accepts, every waiting client is served.  A client
that arrives while the backlog is full waits: the two packages behave
alike here, and neither adds a retry."""

import socket
import threading
import time

import pytest

import m3_tpu.cluster.kv_remote as jkr
import m3_tpu.server.admin_api as jadmin
import m3_tpu.server.http_api as jhttp
import m3_tpu.server.rpc as jrpc
import m3_tpu.storage.database as jdb
import m3_tpu_torch.cluster.kv_remote as tkr
import m3_tpu_torch.server.admin_api as tadmin
import m3_tpu_torch.server.http_api as thttp
import m3_tpu_torch.server.rpc as trpc
import m3_tpu_torch.storage.database as tdb
from http.server import ThreadingHTTPServer

DIALS = 12


def _db(side, root):
    m = jdb if side == "jax" else tdb
    kw = {} if side == "jax" else {"device": "cpu"}
    return m.Database(m.DatabaseOptions(root=str(root), commitlog_enabled=False),
                      {"default": m.NamespaceOptions(num_shards=1, slot_capacity=64,
                                                     sample_capacity=256)}, **kw)


def _server(kind, side, root):
    """A bound, listening server of ``kind``, not yet accepting, and what
    to close after it."""
    if kind == "rpc":
        db = _db(side, root)
        return (jrpc if side == "jax" else trpc).DbNodeRpcServer(db), db
    if kind == "kv":
        return (jkr if side == "jax" else tkr).KVServer(root=None), None
    if kind == "http":
        db = _db(side, root)
        mod = jhttp if side == "jax" else thttp
        return mod.make_server(mod.ApiContext(db)), db
    # what serve_admin_background binds before it starts serving
    mod = jadmin if side == "jax" else tadmin
    return ThreadingHTTPServer(("127.0.0.1", 0), mod._AdminHandler), None


def _dial(port, out, i):
    s = socket.socket()
    s.settimeout(0.5)
    try:
        s.connect(("127.0.0.1", port))
        out[i] = "connected"
    except socket.timeout:
        out[i] = "waiting"
    except OSError as e:
        out[i] = type(e).__name__
    finally:
        s.close()


@pytest.mark.parametrize("kind", ["rpc", "kv", "http", "admin"])
def test_full_backlog_behaves_alike(tmp_path, kind):
    got = {}
    for side in ("jax", "torch"):
        srv, db = _server(kind, side, tmp_path / side)
        try:
            assert srv.request_queue_size == 5
            out = {}
            for i in range(DIALS):  # in order: each dial sees the queue the last left
                _dial(srv.server_address[1], out, i)
            got[side] = [out[i] for i in range(DIALS)]
        finally:
            srv.server_close()
            if db is not None:
                db.close()
    assert got["torch"] == got["jax"], got
    assert "connected" in got["torch"], got


def test_waiting_clients_are_served_once_the_server_accepts(tmp_path):
    """Twelve health calls against a port RPC server that starts accepting
    half a second late: every call succeeds."""
    db = _db("torch", tmp_path)
    srv = trpc.DbNodeRpcServer(db)
    results = []
    try:
        def call():
            r = trpc.RemoteDatabase(("127.0.0.1", srv.port), timeout_s=30.0)
            try:
                results.append(r.health())
            except Exception as e:  # noqa: BLE001 — recorded, asserted below
                results.append(repr(e))
            finally:
                r.close()

        threads = [threading.Thread(target=call) for _ in range(DIALS)]
        for t in threads:
            t.start()
        time.sleep(0.5)
        server = threading.Thread(target=srv.serve_forever, daemon=True)
        server.start()
        for t in threads:
            t.join(timeout=60)
        assert results == [True] * DIALS
    finally:
        srv.shutdown()
        srv.server_close()
        db.close()
