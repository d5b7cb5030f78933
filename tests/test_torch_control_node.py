"""A port node and a JAX node with every config section this slice
accepts (``device.mem_budget``, ``device.breaker_*``, ``selfmon``,
``controller``), fed the same writes and mediator passes on one clock,
on the CPU.

``/health`` has the same sections; ``slo`` (the verdicts and the selfmon
summary) is equal; ``controller`` is equal but for the reference's
``device_fallback`` actuator, which the port does not have;
``device.membudget`` has the same budget, rejects and components, each
component's bytes the package's own footprint formula (the port counts
its tensors at the allocator's 512-byte blocks, the reference adds its
XLA allowance); the self-monitoring series answer PromQL alike.
Timing-valued fields (``latency``, evaluation stamps) are left out.
"""

import gc
import json
import urllib.error
import urllib.request

import pytest

import m3_tpu.persist.capacity as jcap
import m3_tpu.x as jx
import m3_tpu_torch.persist.capacity as tcap
import m3_tpu_torch.x as tx
from m3_tpu.query.slo import latency_ratio
from m3_tpu.server import assembly as jasm
from m3_tpu.x import breaker as jbreaker
from m3_tpu.x import devguard as jdg
from m3_tpu.x import membudget as jmb
from m3_tpu_torch.server import assembly as tasm
from m3_tpu_torch.x import breaker as tbreaker
from m3_tpu_torch.x import devguard as tdg
from m3_tpu_torch.x import membudget as tmb

SEC = 10**9
T0 = 1_700_000_000 * SEC
RULES = [
    {"name": "query-latency", "objective": 0.99,
     "ratio": latency_ratio("m3tpu_query_seconds", "1.0")},
    {"name": "writes-rate", "objective": 0.5,
     "ratio": "clamp_max(sum(rate(m3tpu_db_writes_tagged[{window}])) / 10, 1)",
     "windows": [{"long": "1m", "short": "30s", "factor": 1.0}]},
]


def _config(root) -> str:
    return json.dumps({
        "db": {"root": str(root)},
        "coordinator": {"listen_port": 0},
        "mediator": {"tick_interval": "1h"},
        "device": {"mem_budget": "8G", "breaker_failures": 3, "breaker_reset": "2s"},
        # a deadline no first evaluation (the JAX package compiles its
        # queries then) can miss on a loaded host: an unknown verdict
        # would hold one controller and not the other
        "selfmon": {"enabled": True, "default_rules": False, "rules": RULES,
                    "slo_deadline": "300s"},
        "controller": {"enabled": True, "min_action_interval": "0s"},
    }) + "\n"


def _call(port, path, body=None, method="GET"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _drive(asm) -> tuple:
    for k in range(3):
        body = [{"tags": {"__name__": "g", "i": str(i)},
                 "timestamp": T0 + k * 10 * SEC, "value": float(k * i)}
                for i in range(10)]
        assert _call(asm.port, "/api/v1/json/write", json.dumps(body).encode(),
                     "POST")[0] == 200
        asm.mediator.run_once(T0 + k * 10 * SEC + SEC)
    health = json.loads(_call(asm.port, "/health")[1])
    q = (f"/api/v1/query?query=m3tpu_db_writes_tagged&namespace=_m3_selfmon"
         f"&time={(T0 + 25 * SEC) / 1e9}")
    answer = json.loads(_call(asm.port, q)[1])
    return health, answer


def _fresh_process_counters():
    """Each package's process-global counters that a node's /metrics
    mirrors (and its selfmon stores) back to zero: other tests in the
    same process leave theirs (their dead structures release first)."""
    gc.collect()
    for x, cap in ((tx, tcap), (jx, jcap)):
        for mod in (x.fault, x.retry, x.deadline, x.breaker):
            mod.reset_counters()
        x.breaker.reset_registry()
        x.devguard.reset_stages()
        x.membudget.reset()
        cap.reset()


@pytest.fixture
def nodes(tmp_path):
    _fresh_process_counters()
    made = []

    def make(run, **kw):
        asm = run(_config(tmp_path / str(len(made))), **kw)
        made.append(asm)
        return asm

    yield make
    for asm in made:
        asm.close()
    for mb in (tmb, jmb):
        mb.set_budget(0)
    for dg in (tdg, jdg):
        dg.reset_stages()
        dg.configure(failures=5, reset_s=10.0)
    for br in (tbreaker, jbreaker):
        br.reset_registry()


def test_health_equal_but_the_stated_differences(nodes):
    port_asm = nodes(tasm.run_node, device="cpu")
    port, port_answer = _drive(port_asm)
    ref_asm = nodes(jasm.run_node)
    ref, ref_answer = _drive(ref_asm)

    assert set(port) == set(ref) == {"ok", "latency", "device", "slo", "controller"}
    assert port_answer == ref_answer and port_answer["data"]["result"]

    for doc in (port["slo"], ref["slo"]):
        doc.pop("evaluated_unix")
        doc.pop("elapsed_s")
    assert port["slo"] == ref["slo"]
    assert port["slo"]["selfmon"]["last_cycle"]["written"] > 0
    assert port["slo"]["rules"]["writes-rate"]["burn"] > 0

    # the stated difference: the reference's device_fallback actuator
    fb = ref["controller"]["actuators"].pop("device_fallback")
    assert fb["kind"] == "devguard"
    assert "device_fallback" not in port_asm.controller.registry.names()
    assert port["controller"] == ref["controller"]
    assert port["controller"]["ticks"] == 3
    assert set(port["controller"]["bindings"]) == {"query-burn"}

    pm, rm = port["device"]["membudget"], ref["device"]["membudget"]
    assert (pm["budget_bytes"], pm["rejected_total"]) == (rm["budget_bytes"], 0) \
        == (8 << 30, 0)
    assert set(pm["components"]) == set(rm["components"]) == {"storage.buffer"}
    nbuf = sum(len(ns.shards) for ns in port_asm.db.namespaces.values())
    buf = port_asm.db.namespaces["default"].shards[0].buffer
    assert pm["components"]["storage.buffer"] == nbuf * tmb.buffer_bytes(
        buf.num_windows, buf.sample_capacity)
    assert rm["components"]["storage.buffer"] == nbuf * jmb.buffer_bytes(
        buf.num_windows, buf.sample_capacity)
    assert "stages" not in port["device"] and "stages" not in ref["device"]
