"""The port's dtest harness and agent (``m3_tpu_torch/dtest/{harness,
agent}.py``): real ``m3_tpu_torch.server.node_main`` processes on the
CPU — start, health, write, query, SIGKILL, restart, SIGTERM's drain
with its ``--drain-timeout`` — the harness's diagnostics, the fleet
collectors held against the JAX harness's functions over the same port
node, and the agent's name checks and one lifecycle through its HTTP
surface (the reference's ``tests/test_dtest.py`` and
``tests/test_soak.py`` harness cases)."""

import json
import socket
import subprocess
import sys
import threading
import types
import urllib.request

import pytest

import m3_tpu.dtest.harness as jh
import m3_tpu_torch.dtest.harness as th

BLOCK = 2 * 3600 * 10**9
START_S = (1_700_000_000 * 10**9) // BLOCK * BLOCK // 10**9

CONFIG = """
db:
  root: {root}
  namespaces:
    default: {{num_shards: 2}}
coordinator: {{listen_port: 0}}
mediator: {{enabled: false}}
"""


def _node(tmp_path, config=CONFIG, **kw) -> th.NodeProcess:
    root = tmp_path / "data"
    cfg = tmp_path / "node.yaml"
    cfg.write_text(config.format(root=root))
    root.mkdir(parents=True, exist_ok=True)
    return th.NodeProcess(str(cfg), str(root), device="cpu", **kw)


def _samples(n, t0=START_S):
    return [
        {"tags": {"__name__": "dt", "host": f"h{i % 2}"},
         "timestamp": t0 + i * 10, "value": float(i)}
        for i in range(n)
    ]


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    """One port node on the CPU, tracing on, with a few writes and a
    query behind it."""
    node = _node(tmp_path_factory.mktemp("live"),
                 CONFIG.replace("{{listen_port: 0}}", "{{listen_port: 0, tracing: true}}"))
    node.start()
    try:
        assert node.write_json(_samples(40)) == 40
        assert node.query_range("sum(dt)", START_S, START_S + 400)
        yield node
    finally:
        node.kill()


# ---------------------------------------------------------------------------
# the node lifecycle
# ---------------------------------------------------------------------------


def test_argv_names_the_port_node_its_device_and_drain_wait(tmp_path):
    node = _node(tmp_path, drain_timeout_s=20.0)
    argv = node.argv()
    assert argv[1:4] == ["-m", "m3_tpu_torch.server.node_main", node.config_path]
    assert argv[argv.index("--device") + 1] == "cpu"
    assert float(argv[argv.index("--drain-timeout") + 1]) == 20.0
    assert "--device" not in th.NodeProcess("c", str(tmp_path)).argv()  # the card
    assert th.NodeProcess("c", str(tmp_path)).env is None  # inherits, reads none


def test_crash_recovery_via_real_process(tmp_path):
    """Seed → kill -9 → restart → the data is back (WAL replay through
    an actual process crash)."""
    node = _node(tmp_path)
    node.start()
    try:
        assert node.alive() and node.port
        assert node.write_json(_samples(40)) == 40
        before = node.query_range("sum(dt)", START_S, START_S + 400)
        assert before
        node.kill()  # no flush, no graceful close
        assert not node.alive()
        node.restart()
        after = node.query_range("sum(dt)", START_S, START_S + 400)
        assert after == before
        assert json.loads(node.status_path.read_text())["device"] == "cpu"
    finally:
        node.kill()


def test_graceful_stop_drains_then_restart(tmp_path):
    node = _node(tmp_path, drain_timeout_s=5.0)
    node.start()
    try:
        node.write_json(_samples(10))
        assert node.stop() == 0
        assert not (tmp_path / "data" / "node.json").exists()
        log = node.log_path.read_text()
        assert "node draining" in log and "node shut down" in log
        node.start()
        out = node.query_range("dt", START_S, START_S + 100)
        assert len(out) == 2  # both hosts
    finally:
        node.kill()


@pytest.mark.parametrize("argv,want", [([], 60.0), (["--drain-timeout", "7.5"], 7.5)])
def test_drain_timeout_reaches_the_drain(monkeypatch, tmp_path, argv, want):
    """``node_main --drain-timeout S`` is the wait SIGTERM's drain gives
    LEAVING shards (``Assembly.drain(handoff_timeout_s=S)``), 60 s by
    default — the reference's ``M3_DRAIN_TIMEOUT_S``, as an argument."""
    import m3_tpu_torch.server.assembly as tasm
    from m3_tpu_torch.server import node_main

    got = {}

    class _Asm:
        port = rpc_port = admin_port = 0
        db = types.SimpleNamespace(device="cpu")

        def drain(self, handoff_timeout_s=60.0):
            got["handoff_timeout_s"] = handoff_timeout_s

    monkeypatch.setattr(tasm, "run_node", lambda cfg, device=None: _Asm())
    stop = threading.Event()
    stop.set()  # as if SIGTERM had come
    monkeypatch.setattr(node_main, "threading",
                        types.SimpleNamespace(Event=lambda: stop))
    monkeypatch.setattr(node_main, "signal",
                        types.SimpleNamespace(signal=lambda *a: None,
                                              SIGTERM=15, SIGINT=2))
    cfg = tmp_path / "node.yaml"
    cfg.write_text(CONFIG.format(root=tmp_path / "data"))
    (tmp_path / "data").mkdir()
    assert node_main.main([str(cfg), "--device", "cpu", *argv]) == 0
    assert got == {"handoff_timeout_s": want}


# ---------------------------------------------------------------------------
# diagnostics (the reference's TestHarnessDiagnostics)
# ---------------------------------------------------------------------------


def _hung_node(tmp_path):
    node = th.NodeProcess(str(tmp_path / "cfg.yaml"), str(tmp_path), device="cpu")
    node.log_path.write_bytes(b"x" * 5000 + b"THE ACTUAL REASON\n")
    node.proc = subprocess.Popen(
        [sys.executable, "-c", "import time; time.sleep(60)"])
    return node


def test_timeout_carries_log_tail_and_health(tmp_path):
    node = _hung_node(tmp_path)
    try:
        with pytest.raises(TimeoutError) as ei:
            node.wait_healthy(0.4)
        msg = str(ei.value)
        assert "THE ACTUAL REASON" in msg
        assert "never reached /health" in msg
    finally:
        node.proc.kill()
        node.proc.wait()


def test_dead_node_carries_rc_and_log(tmp_path):
    node = _hung_node(tmp_path)
    node.proc.kill()
    node.proc.wait()
    with pytest.raises(RuntimeError) as ei:
        node.wait_healthy(5)
    assert "died during startup" in str(ei.value)
    assert f"rc={node.proc.returncode}" in str(ei.value)
    assert "THE ACTUAL REASON" in str(ei.value)


def test_a_node_that_fails_to_boot_carries_its_own_error(tmp_path):
    cfg = tmp_path / "node.yaml"
    cfg.write_text("db: {root: " + str(tmp_path / "data") + ", bootstrap_peers: true}\n")
    (tmp_path / "data").mkdir()
    node = th.NodeProcess(str(cfg), str(tmp_path / "data"), device="cpu")
    with pytest.raises(RuntimeError) as ei:
        node.start(timeout_s=60)
    assert "rc=1" in str(ei.value) and "bootstrap_peers requires db.peers" in str(ei.value)


# ---------------------------------------------------------------------------
# the fleet collectors against the JAX harness's, over the same port node
# ---------------------------------------------------------------------------


def _dead_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# series that move while the collectors scrape (the scrapes themselves,
# the process's own clock and memory)
_MOVING = ("m3tpu_process_", "m3tpu_http_")


def _steady(samples):
    return sorted((s.name, s.labels, s.value) for s in samples
                  if not s.name.startswith(_MOVING))


def test_scrape_fleet_equals_the_reference_collector(live):
    dead = _dead_port()
    th.scrape_fleet([live.port])  # every lazily made series exists from here on
    j = jh.scrape_fleet([live.port, dead])
    t = th.scrape_fleet([live.port, dead])
    assert j[dead] is None and t[dead] is None
    assert _steady(t[live.port]) == _steady(j[live.port])
    assert ({(s.name, s.labels) for s in t[live.port]}
            == {(s.name, s.labels) for s in j[live.port]})
    assert any(s.name == "m3tpu_db_write_batch_seconds_count" and s.value > 0
               for s in t[live.port])


@pytest.mark.parametrize("base", ["m3tpu_db_write_batch_seconds", "m3tpu_query_seconds"])
def test_merged_histogram_equals_the_reference_collector(live, base):
    from m3_tpu.instrument import exposition as jexp
    from m3_tpu_torch.instrument import exposition as texp

    j = jh.merged_histogram([live.port, live.port], base)
    t = th.merged_histogram([live.port, live.port], base)
    assert t == j and t
    for q in (0.5, 0.99):
        assert texp.merged_quantile(t, q) == jexp.merged_quantile(j, q)


def test_collect_traces_equals_the_reference_collector(live):
    from m3_tpu_torch.instrument.tracing import Tracer

    tracer = Tracer()
    with tracer.start_span("dtest.local"):
        pass
    local = [sp.to_dict() for sp in tracer.finished()]
    j = jh.collect_traces([live.port], local_spans=local)
    t = th.collect_traces([live.port], local_spans=local)
    assert t == j
    assert len(t) >= 2  # the node's own traces and the local one


# ---------------------------------------------------------------------------
# the agent
# ---------------------------------------------------------------------------

NAMES = ["n1", "node-0", "a_b.c", "x" * 64, "../x", "a/b", "..", ".", "",
         "x" * 65, "a\x00b", "a b", "é"]


@pytest.mark.parametrize("name", NAMES)
def test_agent_name_checks_equal_the_reference(tmp_path, name):
    from m3_tpu.dtest.agent import Agent as JAgent
    from m3_tpu_torch.dtest.agent import Agent as TAgent

    outcomes = []
    for cls, sub in ((JAgent, "j"), (TAgent, "t")):
        agent = cls(str(tmp_path / sub))
        try:
            try:
                outcomes.append(("ok", agent.setup(name, "db: {}")["name"]))
            except ValueError as e:
                outcomes.append(("ValueError", str(e)))
            try:
                agent.teardown(name)
                outcomes.append(("ok",))
            except (ValueError, KeyError) as e:
                outcomes.append((type(e).__name__, str(e)))
        finally:
            agent.close()
    assert outcomes[:2] == outcomes[2:]
    bad = name in ("../x", "a/b", "..", ".", "", "x" * 65, "a\x00b", "a b")
    assert (outcomes[2][0] == "ValueError") == bad


def test_agent_lifecycle_over_http(tmp_path):
    """setup → start → status → write → kill → start (WAL recovery) →
    logs → teardown, through ``AgentClient`` against
    ``serve_agent_background(device="cpu")``; bad requests answer 400."""
    from m3_tpu_torch.dtest.agent import AgentClient, serve_agent_background

    srv = serve_agent_background(str(tmp_path / "agent"), device="cpu")
    client = AgentClient(srv.server_address)
    try:
        out = client.setup("n1", CONFIG.format(root=tmp_path / "agent" / "n1" / "data"))
        assert out["name"] == "n1"
        st = client.start("n1")
        assert st["alive"] and st["port"] and st["device"] == "cpu"
        req = urllib.request.Request(
            f"http://127.0.0.1:{st['port']}/api/v1/json/write",
            data=json.dumps([{"tags": {"__name__": "am"}, "timestamp": START_S + 10,
                              "value": 5.0}]).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert json.load(r)["written"] == 1
        assert client.status()["nodes"]["n1"]["alive"]
        assert client.kill("n1") == {"name": "n1", "killed": True}
        assert not client.status()["nodes"]["n1"]["alive"]
        st2 = client.start("n1")
        assert st2["alive"]
        url = (f"http://127.0.0.1:{st2['port']}/api/v1/query_range?"
               f"query=am&start={START_S}&end={START_S + 100}&step=10s")
        with urllib.request.urlopen(url, timeout=60) as r:
            assert json.load(r)["data"]["result"]
        logs = client.logs("n1")
        assert isinstance(logs, bytes) and b"node up" in logs
        for path, body in (("/setup", {"name": "../x", "config_yaml": ""}),
                           ("/start", {"name": "nope"}), ("/start", {})):
            with pytest.raises(urllib.error.HTTPError) as ei:
                client._post(path, body)
            assert ei.value.code == 400
        assert client.stop("n1")["rc"] == 0
        client.teardown("n1")
        assert "n1" not in client.status()["nodes"]
        assert not (tmp_path / "agent" / "n1").exists()
    finally:
        srv.agent.close()
        srv.shutdown()
        srv.server_close()
