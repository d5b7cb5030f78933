"""m3_tpu_torch.cluster.kv_remote against m3_tpu.cluster.kv_remote on the
CPU: the cases of ``tests/test_kv_remote.py`` through the port's server
and client, and across the packages in both directions (a port client
on a JAX server and the reverse), with the frames each side sends held
byte-identical to the JAX package's for the same calls.  Every server is
shut down in a ``finally`` or a fixture; every client is closed."""

import threading
import time

import pytest

from m3_tpu.cluster import kv as jkv
from m3_tpu.cluster import kv_remote as jkr
from m3_tpu.cluster import namespace_registry as jnr
from m3_tpu.cluster import placement as jpl
from m3_tpu_torch.cluster import kv as tkv
from m3_tpu_torch.cluster import kv_remote as tkr
from m3_tpu_torch.cluster import namespace_registry as tnr
from m3_tpu_torch.cluster import placement as tpl

SIDE = {"jax": (jkv, jkr, jnr, jpl), "torch": (tkv, tkr, tnr, tpl)}
# (server package, client package): the port alone, and both crossings
PAIRS = [("torch", "torch"), ("jax", "torch"), ("torch", "jax")]
IDS = [f"{s}-server-{c}-client" for s, c in PAIRS]


def _stop(srv):
    srv.shutdown()
    srv.server_close()


@pytest.fixture(params=PAIRS, ids=IDS)
def kv_pair(request, tmp_path):
    srv_side, cli_side = request.param
    srv = SIDE[srv_side][1].serve_kv_background(root=str(tmp_path))
    client = SIDE[cli_side][1].RemoteKVStore(("127.0.0.1", srv.port), watch_poll_s=0.05,
                                             timeout_s=10.0)
    try:
        yield srv, client, SIDE[cli_side]
    finally:
        client.close()
        _stop(srv)


def test_versioned_roundtrip(kv_pair):
    _, kv, _ = kv_pair
    assert kv.get("a") is None
    assert kv.set("a", b"one") == 1
    assert kv.set("a", b"two") == 2
    v = kv.get("a")
    assert (v.version, v.data) == (2, b"two")
    assert kv.keys() == ["a"]
    assert kv.delete("a") and not kv.delete("a")


def test_cas_conflicts_are_typed(kv_pair):
    _, kv, _ = kv_pair
    assert kv.check_and_set("c", 0, b"x") == 1
    with pytest.raises(ValueError, match="version conflict") as e:
        kv.check_and_set("c", 0, b"y")
    local = jkv.KVStore()
    local.check_and_set("c", 0, b"x")
    with pytest.raises(ValueError) as want:
        local.check_and_set("c", 0, b"y")
    assert str(e.value) == str(want.value)
    assert kv.check_and_set("c", 1, b"y") == 2
    kv.set_if_not_exists("nx", b"v")
    with pytest.raises(KeyError):
        kv.set_if_not_exists("nx", b"v2")


@pytest.mark.parametrize("srv_side,cli_side", PAIRS, ids=IDS)
def test_durability_across_server_restart(tmp_path, srv_side, cli_side):
    mod = SIDE[srv_side][1]
    srv = mod.serve_kv_background(root=str(tmp_path))
    kv = SIDE[cli_side][1].RemoteKVStore(("127.0.0.1", srv.port), timeout_s=10.0)
    try:
        kv.set("p", b"persisted")
        port = srv.port
    finally:
        kv.close()
        _stop(srv)
    # the other package's server reads the same KV file
    other = SIDE["jax" if srv_side == "torch" else "torch"][1]
    srv2 = other.serve_kv_background(root=str(tmp_path), port=port)
    kv2 = SIDE[cli_side][1].RemoteKVStore(("127.0.0.1", port), timeout_s=10.0)
    try:
        v = kv2.get("p")
        assert v and v.data == b"persisted"
    finally:
        kv2.close()
        _stop(srv2)


def test_watch_fires_on_remote_change(kv_pair):
    srv, kv, side = kv_pair
    seen = []
    kv.watch("w", lambda v: seen.append((v.version, v.data)))
    # a DIFFERENT client mutates the key (cross-process shape)
    other = side[1].RemoteKVStore(("127.0.0.1", srv.port), timeout_s=10.0)
    try:
        other.set("w", b"first")
        other.set("w", b"second")
        deadline = time.monotonic() + 5
        while len(seen) < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert (2, b"second") in seen, seen
    finally:
        other.close()


def test_services_work_over_the_wire(kv_pair):
    """PlacementService + NamespaceRegistry on the remote store: the same
    documents either package writes."""
    _, kv, side = kv_pair
    _, _, nr, pl = side
    ps = pl.PlacementService(kv)
    ps.set(pl.initial_placement([pl.Instance("i0"), pl.Instance("i1")],
                                num_shards=4, rf=2))
    got = ps.get()
    assert got.num_shards == 4 and len(got.instances) == 2
    want = jpl.initial_placement([jpl.Instance("i0"), jpl.Instance("i1")], num_shards=4, rf=2)
    assert kv.get("placement").data == want.to_json()

    reg = nr.NamespaceRegistry(kv)
    reg.add(nr.NamespaceMeta(name="remote_ns"))
    assert "remote_ns" in reg.all()
    jreg = jnr.NamespaceRegistry(jkv.KVStore())
    jreg.add(jnr.NamespaceMeta(name="remote_ns"))
    assert kv.get("namespaces").data == jreg.kv.get("namespaces").data


def test_cross_client_leader_election(kv_pair):
    """Two clients (two processes in production) campaign on the shared
    plane: exactly one leads; lease expiry hands over."""
    srv, kv_a, side = kv_pair
    kv_b = side[1].RemoteKVStore(("127.0.0.1", srv.port), timeout_s=10.0)
    try:
        t0 = 1_000_000_000_000
        a = side[0].LeaderElection(kv_a, "svc", "A", ttl_nanos=10**9)
        b = side[0].LeaderElection(kv_b, "svc", "B", ttl_nanos=10**9)
        assert a.campaign(now_nanos=t0) and not b.campaign(now_nanos=t0)
        assert b.leader(now_nanos=t0) == "A"
        assert b.campaign(now_nanos=t0 + 2 * 10**9)
        assert a.leader(now_nanos=t0 + 2 * 10**9) == "B"
    finally:
        kv_b.close()


def test_concurrent_cas_single_winner(kv_pair):
    srv, _, side = kv_pair
    winners = []

    def racer(name):
        c = side[1].RemoteKVStore(("127.0.0.1", srv.port), timeout_s=10.0)
        try:
            c.check_and_set("race", 0, name.encode())
            winners.append(name)
        except ValueError:
            pass
        finally:
            c.close()

    threads = [threading.Thread(target=racer, args=(f"r{i}",)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(winners) == 1


def _record_frames(mod, monkeypatch) -> list:
    """Every frame the module's server and client send, in order."""
    sent = []
    real = mod.send_frame

    def rec(sock, ftype, payload):
        sent.append((ftype, bytes(payload)))
        return real(sock, ftype, payload)

    monkeypatch.setattr(mod, "send_frame", rec)
    return sent


def _script(kv):
    """One call of every method, errors included."""
    out = [kv.get("k"), kv.set("k", b"v1"), kv.set("k", b"v2"), kv.get("k").data,
           kv.set_if_not_exists("n", b"x"), kv.check_and_set("k", 2, b"v3"), kv.keys()]
    for fn in (lambda: kv.check_and_set("k", 1, b"no"), lambda: kv.set_if_not_exists("n", b"y")):
        try:
            fn()
        except (ValueError, KeyError) as e:
            out.append((type(e).__name__, str(e)))
    out += [kv.delete("k"), kv.delete("k"), kv.keys()]
    return out


def test_frames_byte_identical(tmp_path, monkeypatch):
    """The same calls through each package's own client and server send
    the same frames, requests and replies, byte for byte; and each
    package's client gets the same answers from the other's server."""
    frames, answers = {}, {}
    for side in ("jax", "torch"):
        mod = SIDE[side][1]
        sent = _record_frames(mod, monkeypatch)
        (tmp_path / side).mkdir()
        srv = mod.serve_kv_background(root=str(tmp_path / side))
        kv = mod.RemoteKVStore(("127.0.0.1", srv.port), timeout_s=10.0)
        try:
            answers[side] = _script(kv)
        finally:
            kv.close()
            _stop(srv)
        frames[side] = list(sent)
    assert frames["torch"] == frames["jax"] and len(frames["jax"]) == 2 * 12
    assert answers["torch"] == answers["jax"]
    for srv_side, cli_side in PAIRS[1:]:
        (tmp_path / f"x{srv_side}").mkdir()
        srv = SIDE[srv_side][1].serve_kv_background(root=str(tmp_path / f"x{srv_side}"))
        kv = SIDE[cli_side][1].RemoteKVStore(("127.0.0.1", srv.port), timeout_s=10.0)
        try:
            assert _script(kv) == answers["jax"]
        finally:
            kv.close()
            _stop(srv)


def test_watch_thread_stops_on_close(tmp_path):
    """``close()`` ends the watch poller within its poll interval, and a
    closed client refuses calls without waiting out the retry ladder."""
    srv = tkr.serve_kv_background(root=str(tmp_path))
    kv = tkr.RemoteKVStore(("127.0.0.1", srv.port), watch_poll_s=0.05, timeout_s=10.0)
    try:
        kv.watch("w", lambda v: None)
        thread = kv._watch_thread
        assert thread.is_alive()
        kv.close()
        thread.join(timeout=5)
        assert not thread.is_alive()
        t0 = time.monotonic()
        with pytest.raises(ConnectionError, match="store closed"):
            kv.get("w")
        assert time.monotonic() - t0 < 1.0
    finally:
        kv.close()
        _stop(srv)
