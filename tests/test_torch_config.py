"""m3_tpu_torch.core.config against m3_tpu.core.config on the CPU.

One YAML text through both loaders gives equal ``dataclasses.asdict``
(env expansion included); invalid configs raise the same ``ConfigError``
text; JSON text loads to the same config; ``run_node`` refuses an
``arena_ingest`` it has no counterpart for, builds the replicated
cluster's sections (RPC, peers, remote KV, instance id, admin port), and
boots with each front-door section (the carbon port, the query listener,
query remotes) to answer as the JAX node does.
"""

import dataclasses
import json
import socket
import time
import urllib.request

import numpy as np
import pytest

from m3_tpu.core import config as jc
from m3_tpu.server import assembly as jasm
from m3_tpu_torch.core import config as tc
from m3_tpu_torch.query import promql as tpromql
from m3_tpu_torch.query import remote as trem
from m3_tpu_torch.server import assembly as tasm

FULL = """
db:
  root: ${M3_TEST_ROOT:/tmp/m3-default}
  commitlog_enabled: true
  namespaces:
    default: {retention: 48h, block_size: 2h, num_shards: 2,
              slot_capacity: 4096, sample_capacity: 65536}
    agg: {retention: 720h, block_size: 24h, resolution: 1m}
  limits: {max_docs_matched: 100, max_series_read: 0, lookback: 10s}
coordinator:
  listen_port: 0
  namespace: default
  downsample: true
  tracing: true
  arena_layout: f64
  checkpoint_every: 3
mediator: {tick_interval: 2s, snapshot_every: 3, cleanup_every: 4,
           scrub_every: 2, scrub_volumes: 8}
query: {default_timeout: 45s, max_concurrent: 4, max_queue: 8,
        queue_timeout: 250ms, slow_query_fraction: 0.5}
disk: {enabled: true, capacity: 1G, reserve: 1M, low_ratio: 0.3,
       critical_ratio: 0.1}
selfmon: {peers: ['b=127.0.0.1:9001'],
          rules: [{name: r, objective: 0.99, ratio: 'x[{window}]'}]}
metrics_prefix: m3x
"""


def _both(text):
    return tc.load_config(text), jc.load_config(text)


def test_full_yaml_equal(monkeypatch):
    monkeypatch.setenv("M3_TEST_ROOT", "/tmp/m3-env-root")
    t, j = _both(FULL)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.db.root == "/tmp/m3-env-root"


def test_defaults_and_env_default_equal(monkeypatch):
    monkeypatch.delenv("M3_TEST_ROOT", raising=False)
    t, j = _both(FULL)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.db.root == "/tmp/m3-default"
    t, j = _both("coordinator: null\n")
    assert t.coordinator is None and dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(tc.NodeConfig()) == dataclasses.asdict(jc.NodeConfig())


def test_json_text_loads_the_same(tmp_path, monkeypatch):
    monkeypatch.setenv("M3_TEST_ROOT", "/tmp/m3-env-root")
    j = jc.load_config(FULL)
    as_json = json.dumps(dataclasses.asdict(j))
    assert dataclasses.asdict(tc.load_config(as_json)) == dataclasses.asdict(j)
    path = tmp_path / "node.json"
    path.write_text(as_json)
    assert dataclasses.asdict(tc.load_config(str(path))) == dataclasses.asdict(j)


def test_json_without_yaml(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "yaml", None)  # PyYAML missing
    cfg = tc.load_config('{"db": {"root": "/tmp/j"}, "query": {"max_queue": 3}}')
    assert cfg.db.root == "/tmp/j" and cfg.query.max_queue == 3
    with pytest.raises(tc.ConfigError, match="PyYAML"):
        tc.load_config("db: {root: /tmp/y}\n")


INVALID = [
    "db: {namespaces: {}}\n",
    "db: {namespaces: {a: {block_size: 3x, num_shards: 0}}}\n",
    "db: {namespaces: {a: {block_size: 72h, retention: 48h}}}\n",
    "db: {bogus: 1}\n",
    "db: {peers: ['nohost'], bootstrap_peers: true, kv_endpoint: 'x:0'}\n",
    "db: {rpc_listen_port: 70000, limits: {lookback: zz, max_bytes_read: -1}}\n",
    "mediator: {tick_interval: 1q, scrub_every: 0, migrate_blocks: -1}\n",
    "query: {slow_query_fraction: 2, max_concurrent: -1, remotes: [x]}\n",
    "device: {mem_budget: lots, breaker_failures: 0}\n",
    "disk: {capacity: 1Q, low_ratio: 0.1, critical_ratio: 0.5}\n",
    "coordinator: {listen_port: 99999, arena_ingest: fast, arena_layout: x,"
    " checkpoint_every: -1}\n",
    "selfmon: {enabled: true, every: 0, peers: ['a=b'], namespace: default,"
    " rules: [{name: r, objective: 2, ratio: q}, {bad: 1},"
    " {name: w, objective: 0.9, ratio: 'a{window}',"
    " windows: [{long: 5m, short: 1h, factor: 2}]},"
    " {name: v, ratio: 'a{window}', windows: [{long: 1h}]}]}\n",
    "controller: {enabled: true, every: 0, clear_burn: 0, mem_floor_frac: 2}\n",
    "coordinator: [1, 2]\n",
]


@pytest.mark.parametrize("text", INVALID)
def test_invalid_same_error_text(text):
    with pytest.raises(jc.ConfigError) as je:
        jc.load_config(text)
    with pytest.raises(tc.ConfigError) as te:
        tc.load_config(text)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("v", ["10s", "2h", "1.5m", "30d", "250ms", 7, "9w"])
def test_parse_duration_equal(v):
    assert tc.parse_duration(v) == jc.parse_duration(v)


REFUSED = [
    ("coordinator: {arena_ingest: pallas}", "has no counterpart"),
]


@pytest.mark.parametrize("text,module", REFUSED)
def test_unported_sections_refuse(tmp_path, text, module):
    cfg = tc.load_config(f"{text}\n")
    cfg.db.root = str(tmp_path)
    with pytest.raises(tc.ConfigError, match=module.replace(".", r"\.")):
        tasm.run_node(cfg, device="cpu")
    assert not any(tmp_path.iterdir())  # refused before anything was built


# the replicated cluster's sections, refused until the RPC data plane was
# ported, and the part of the node each one builds
CLUSTER_SECTIONS = [
    ("db: {rpc_listen_port: 0}", "rpc_server"),
    ("db: {peers: ['127.0.0.1:9']}", "peer_handles"),
    ("db: {kv_endpoint: '127.0.0.1:9'}", "kv"),
    ("db: {instance_id: i0}", "migrator"),
    ("coordinator: {admin_listen_port: 0}", "admin_server"),
]


@pytest.mark.parametrize("text,part", CLUSTER_SECTIONS)
def test_cluster_sections_are_accepted(tmp_path, text, part):
    cfg = tc.load_config(f"{text}\nmediator: {{enabled: false}}\n")
    cfg.db.root = str(tmp_path)
    tasm.refuse_unported(cfg)
    asm = tasm.run_node(cfg, device="cpu")
    try:
        assert getattr(asm, part)
        assert (asm.rpc_port is not None) == (part == "rpc_server")
        assert (asm.admin_port is not None) == (part == "admin_server")
    finally:
        asm.close()


# the device-boundary and control-plane sections, refused until
# devguard, membudget, selfmon and the controller were ported, and what
# each one sets on the node it builds
DEVICE_AND_CONTROL_SECTIONS = [
    ("selfmon: {enabled: true}", "selfmon"),
    ("selfmon: {enabled: true}\ncontroller: {enabled: true}", "controller"),
    ("device: {mem_budget: 1G}", "mem_budget"),
    ("device: {breaker_failures: 2}", "breaker_failures"),
]


@pytest.mark.parametrize("text,part", DEVICE_AND_CONTROL_SECTIONS)
def test_device_and_control_sections_are_accepted(tmp_path, text, part):
    from m3_tpu_torch.x import devguard, membudget

    cfg = tc.load_config(f"{text}\nmediator: {{enabled: false}}\n")
    cfg.db.root = str(tmp_path)
    tasm.refuse_unported(cfg)
    asm = tasm.run_node(cfg, device="cpu")
    try:
        if part in ("selfmon", "controller"):
            assert getattr(asm, part) is not None
            assert "_m3_selfmon" in asm.db.namespaces
        elif part == "mem_budget":
            assert membudget.budget() == 1 << 30
        else:
            assert devguard._FAILURES == 2
    finally:
        asm.close()
        membudget.set_budget(0)
        devguard.configure(failures=5, reset_s=10.0)


def test_arena_ingest_auto_is_accepted():
    tasm.refuse_unported(tc.load_config("coordinator: {arena_ingest: auto}\n"))


# -- the front doors: carbon, the query listener, query remotes -------------

T0 = 1_700_000_000  # seconds
FRONT_DOORS = ["coordinator: {listen_port: 0, carbon_listen_port: 0}",
               "coordinator: {listen_port: 0}\nquery: {listen_port: 0}",
               "coordinator: {listen_port: 0}\nquery: {remotes: ['127.0.0.1:{peer}']}"]


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return r.status, r.read()


def _json_write(port, region: str, n: int = 6):
    rows = [{"tags": {"__name__": "reqs", "region": region, "host": f"h{i % 2}"},
             "timestamp": T0 + k, "value": float(k * (i + 1))}
            for k in range(n) for i in range(2)]
    req = urllib.request.Request(f"http://127.0.0.1:{port}/api/v1/json/write",
                                 data=json.dumps(rows).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.status == 200


def _carbon_lines():
    rng = np.random.default_rng(9)
    return [(f"m3.dc0.host{i}.cpu", repr(float(v)), T0 + 10 * k)
            for k in range(4) for i, v in enumerate(rng.normal(50, 10, 3))]


def _carbon_readback(asm, lines) -> bytes:
    with socket.create_connection(("127.0.0.1", asm.carbon_port)) as s:
        s.sendall("".join(f"{p} {v} {t}\n" for p, v, t in lines).encode())
    path = f"/render?target=m3.dc0.*.cpu&from={T0}&until={T0 + 40}&step=10s"
    deadline = time.monotonic() + 60
    while True:
        st, body = _get(asm.port, path)
        got = json.loads(body)
        if st == 200 and sum(v is not None for s in got
                             for v, _ in s["datapoints"]) == len(lines):
            return body
        assert time.monotonic() < deadline, body
        time.sleep(0.05)


@pytest.mark.parametrize("section", ["carbon_listen_port", "listen_port", "remotes"])
def test_front_door_sections_boot_and_answer_like_jax(tmp_path, section):
    text = FRONT_DOORS[["carbon_listen_port", "listen_port", "remotes"].index(section)]
    peer = None
    if section == "remotes":  # the remote region: a port node's query listener
        peer = tasm.run_node(f"db: {{root: {tmp_path / 'peer'}}}\n"
                             "coordinator: {listen_port: 0}\nquery: {listen_port: 0}\n"
                             "mediator: {enabled: false}\n", device="cpu")
        _json_write(peer.port, "eu")
        text = text.replace("{peer}", str(peer.query_port))
    nodes = {}
    try:
        for side, run in (("torch", lambda c: tasm.run_node(c, device="cpu")),
                          ("jax", jasm.run_node)):
            nodes[side] = run(f"db: {{root: {tmp_path / side}}}\n{text}\n"
                              "mediator: {enabled: false}\n")
        answers = {}
        for side, asm in nodes.items():
            if section == "carbon_listen_port":
                answers[side] = _carbon_readback(asm, _carbon_lines())
            elif section == "listen_port":
                _json_write(asm.port, "us")
                store = trem.RemoteStorage(("127.0.0.1", asm.query_port))
                try:
                    blk = store.fetch_raw(b"reqs", (tpromql.LabelMatcher(
                        b"region", "=", b"us"),), T0 * 10**9, (T0 + 60) * 10**9)
                finally:
                    store.close()
                answers[side] = ([m.tags for m in blk.series], blk.ts.tolist(),
                                 blk.values.tolist(), blk.counts.tolist())
            else:
                _json_write(asm.port, "us")
                st, body = _get(asm.port, "/api/v1/query_range?query=sum+by+(region)+(reqs)"
                                f"&start={T0}&end={T0 + 5}&step=1s")
                assert st == 200
                answers[side] = json.loads(body)
        assert answers["torch"] == answers["jax"]
        if section == "carbon_listen_port":
            got = {s["target"]: [v for v, _ in s["datapoints"]]
                   for s in json.loads(answers["torch"])}
            for p, v, t in _carbon_lines():
                assert got[p][(t - T0) // 10] == float(v)
        elif section == "listen_port":
            assert len(answers["torch"][0]) == 2
        else:
            res = answers["torch"]["data"]["result"]
            assert sorted(r["metric"]["region"] for r in res) == ["eu", "us"]
    finally:
        for asm in nodes.values():
            asm.close()
        if peer is not None:
            peer.close()


def test_tracing_node_with_carbon_keeps_each_part(tmp_path):
    """``coordinator.tracing`` and ``carbon_listen_port`` together: the
    node's tracer and its carbon listener each land in their own field,
    and ``close()`` stops the listener."""
    from m3_tpu_torch.instrument.tracing import Tracer
    from m3_tpu_torch.metrics.carbon import CarbonServer

    asm = tasm.run_node(f"db: {{root: {tmp_path}}}\ncoordinator: {{listen_port: 0, "
                        "carbon_listen_port: 0, tracing: true}\n"
                        "mediator: {enabled: false}\n", device="cpu")
    try:
        assert isinstance(asm.tracer, Tracer)
        assert isinstance(asm.carbon_server, CarbonServer) and asm.carbon_port
    finally:
        asm.close()
    assert asm.carbon_server is None and asm.http_server is None
