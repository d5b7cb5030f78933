"""m3_tpu_torch.x.chaos and m3_tpu_torch.ctl.r2 against the JAX
package's on the CPU.

* Chaos: the same ``(seed, timeline)`` parses to the same events, expands
  its sustained windows the same way, and a scheduler on a fake clock
  drives a recording ops adapter through the same calls (faultpoint
  specs seeded alike) with the same log; malformed timelines raise the
  same messages; a ``device_fault`` event's spec arms the port's own
  ``device.*`` points, which its device guard fires.
* r2: the same HTTP requests against each package's rules service give
  the same status codes and bodies, and the same KV bytes and versions
  underneath, through create, CAS conflict, update, tombstone and
  re-create.

Exact comparisons.
"""

import json
import urllib.error
import urllib.request

import pytest

from m3_tpu.cluster.kv import KVStore as JKV
from m3_tpu.ctl import r2 as jr2
from m3_tpu.metrics.aggregation import AggregationID, AggregationType
from m3_tpu.metrics.filters import TagsFilter
from m3_tpu.metrics.pipeline import AggregationOp, Pipeline, RollupOp
from m3_tpu.metrics.policy import StoragePolicy
from m3_tpu.metrics.rules import MappingRule, RollupRule, RollupTarget, RuleSet
from m3_tpu.metrics.rules_json import ruleset_to_json
from m3_tpu.x import chaos as jchaos
from m3_tpu_torch.cluster.kv import KVStore as TKV
from m3_tpu_torch.ctl import r2 as tr2
from m3_tpu_torch.x import chaos as tchaos
from m3_tpu_torch.x import devguard as tdg
from m3_tpu_torch.x import fault as tfault

TIMELINE = {"seed": 42, "events": [
    {"at_s": 0.0, "action": "phase", "arg": "steady"},
    {"at_s": 5.0, "action": "wire_fault", "node": 1,
     "arg": "rpc.call=drop:p=0.3;rpc.call=delay:ms=20"},
    {"at_s": 2.0, "action": "device_fault", "node": 0,
     "arg": "device.dispatch=error:n=3"},
    {"at_s": 6.0, "action": "sustained", "node": 2, "hold_s": 4.0,
     "arg": "device.transfer=error:p=0.5"},
    {"at_s": 7.5, "action": "sustained", "node": 1, "hold_s": 1.0,
     "arg": "query.fetch=delay:ms=900:seed=3"},
    {"at_s": 8.0, "action": "kill", "node": 1},
    {"at_s": 9.0, "action": "restart", "node": 1},
    {"at_s": 9.5, "action": "corrupt", "node": 0},
    {"at_s": 10.0, "action": "disk_pressure", "node": 2, "arg": "0.15",
     "hold_s": 3.0},
    {"at_s": 11.0, "action": "replace", "node": 0},
    {"at_s": 12.0, "action": "clear_faults", "node": 0},
    {"at_s": 14.0, "action": "phase", "arg": "recovered"},
]}


class _Ops:
    """Records every call; ``kill`` of node 1 raises, as a failed
    injection does."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def op(*a):
            self.calls.append((name,) + a)
            if name == "kill" and a == (1,):
                raise RuntimeError("no such process")
        return op


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


def _drive(chaos):
    seed, events = chaos.parse_timeline(TIMELINE)
    ops, clock = _Ops(), _Clock()
    sched = chaos.ChaosScheduler(events, ops, seed=seed, clock=clock,
                                 sleep=clock.sleep)
    log = sched.run()
    return ([e.to_dict() for e in events],
            [e.to_dict() for e in chaos.expand_sustained(events)], ops.calls, log)


def test_same_timeline_same_chaos():
    port, ref = _drive(tchaos), _drive(jchaos)
    assert port == ref
    events, expanded, calls, log = port
    assert [e["action"] for e in expanded].count("clear_faults") == 3
    assert ("arm_faults", 0, "device.dispatch=error:n=3:seed=43") in calls
    assert [r["ok"] for r in log].count(False) == 1


BAD = [
    {"seed": 1, "evts": []},
    {"events": [{"at_s": 0, "action": "explode", "node": 0}]},
    {"events": [{"at_s": 0, "action": "phase"}]},
    {"events": [{"at_s": 0, "action": "kill"}]},
    {"events": [{"at_s": 0, "action": "kill", "node": 0, "hold_s": 2}]},
    {"events": [{"at_s": 0, "action": "device_fault", "node": 0,
                 "arg": "rpc.call=drop"}]},
    {"events": [{"at_s": 0, "action": "sustained", "node": 0,
                 "arg": "device.dispatch=error;rpc.call=drop", "hold_s": 1}]},
    {"events": [{"at_s": 0, "action": "sustained", "node": 0,
                 "arg": "device.dispatch=error"}]},
    {"events": [{"at_s": 0, "action": "disk_pressure", "node": 0, "arg": "15"}]},
    {"events": [{"at_s": 0, "action": "wire_fault", "node": 0,
                 "arg": "rpc.call=nonsense"}]},
    {"events": [{"at_s": 0, "action": "kill", "node": 0, "when": 3}]},
]


@pytest.mark.parametrize("spec", BAD)
def test_bad_timelines_raise_the_same(spec):
    with pytest.raises(ValueError) as te:
        tchaos.parse_timeline(spec)
    with pytest.raises(ValueError) as je:
        jchaos.parse_timeline(spec)
    assert str(te.value) == str(je.value)


def test_device_fault_arms_the_ports_device_points():
    seed, events = tchaos.parse_timeline(TIMELINE)
    ev = next(e for e in events if e.action == "device_fault")
    tdg.reset_stages()
    try:
        tfault.apply_request({"arm": tchaos._seeded_spec(ev.arg, seed)})
        outcomes = []
        for _ in range(4):
            try:
                outcomes.append(tdg.run_guarded("chaos.stage", lambda: "ok"))
            except tdg.DeviceOOM:
                outcomes.append("oom")
        assert outcomes == ["oom", "oom", "oom", "ok"]
    finally:
        tfault.disarm()
        tdg.reset_stages()


def _ruleset_doc():
    return ruleset_to_json(RuleSet(
        namespace="default",
        mapping_rules=[MappingRule(
            name="keep-web", filter=TagsFilter.parse("role:web*"),
            policies=(StoragePolicy.parse("10s:2d"), StoragePolicy.parse("1m:40d")),
            aggregation_id=AggregationID.compress(
                [AggregationType.SUM, AggregationType.MAX]))],
        rollup_rules=[RollupRule(
            name="rollup-reqs", filter=TagsFilter.parse("__name__:requests dc:us-*"),
            targets=(RollupTarget(
                pipeline=Pipeline((AggregationOp(AggregationType.SUM),
                                   RollupOp(b"requests_by_dc", (b"dc",)))),
                policies=(StoragePolicy.parse("1m:40d"),)),))],
    ))


def _r2_session(r2, kv_cls, root):
    kv = kv_cls(str(root))
    srv = r2.serve_r2_background(r2.RulesStore(kv))
    base = f"http://127.0.0.1:{srv.server_address[1]}/api/v1/rules"

    def req(method, path="", body=None, raw=None):
        data = raw if raw is not None else (
            json.dumps(body).encode() if body is not None else None)
        r = urllib.request.Request(base + path, method=method, data=data)
        try:
            with urllib.request.urlopen(r, timeout=30) as resp:
                return resp.status, json.load(resp)
        except urllib.error.HTTPError as e:
            return e.code, json.load(e)

    doc = _ruleset_doc()
    out = [req("GET"), req("PUT", "/default", doc), req("PUT", "/default", doc),
           req("GET", "/default"), req("GET", "/nope"),
           req("PUT", "/default", dict(doc, expected_version=99)),
           req("PUT", "/default", dict(doc, expected_version=1, mapping_rules=[])),
           req("PUT", "/other", raw=b"[1, 2]"), req("PUT", "", doc),
           req("GET"), req("DELETE", "/default"), req("DELETE", "/default"),
           req("GET", "/default"), req("PUT", "/default", doc), req("GET")]
    srv.shutdown()
    srv.server_close()
    kv_bytes = {k: (kv.get(k).version, kv.get(k).data) for k in sorted(kv.keys())}
    return out, kv_bytes, (root / "kv.json").read_bytes() if (root / "kv.json").exists() else None


def test_r2_answers_and_kv_bytes_equal(tmp_path):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    port = _r2_session(tr2, TKV, tmp_path / "t")
    ref = _r2_session(jr2, JKV, tmp_path / "j")
    assert port == ref
    answers = [code for code, _ in port[0]]
    assert answers == [200, 200, 409, 200, 404, 409, 200, 400, 404, 200, 200,
                       404, 404, 200, 200]
