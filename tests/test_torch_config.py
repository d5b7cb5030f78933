"""m3_tpu_torch.core.config against m3_tpu.core.config on the CPU.

One YAML text through both loaders gives equal ``dataclasses.asdict``
(env expansion included); invalid configs raise the same ``ConfigError``
text; JSON text loads to the same config; ``run_node`` refuses, by
name, every section whose subsystem the port does not have, and builds
the replicated cluster's sections (RPC, peers, remote KV, instance id,
admin port).
"""

import dataclasses
import json

import pytest

from m3_tpu.core import config as jc
from m3_tpu_torch.core import config as tc
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


UNPORTED = [
    ("coordinator: {carbon_listen_port: 0}", "m3_tpu/metrics/carbon.py"),
    ("query: {listen_port: 0}", "m3_tpu/query/remote.py"),
    ("query: {remotes: ['127.0.0.1:9']}", "m3_tpu/query/fanout.py"),
    ("selfmon: {enabled: true}", "m3_tpu/instrument/selfmon.py"),
    ("selfmon: {enabled: true}\ncontroller: {enabled: true}",
     "m3_tpu/x/controller.py"),
    ("device: {mem_budget: 1G}", "m3_tpu/x/membudget.py"),
    ("device: {breaker_failures: 2}", "m3_tpu/x/devguard.py"),
    ("coordinator: {arena_ingest: pallas}", "has no counterpart"),
]


@pytest.mark.parametrize("text,module", UNPORTED)
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


def test_arena_ingest_auto_is_accepted():
    tasm.refuse_unported(tc.load_config("coordinator: {arena_ingest: auto}\n"))
