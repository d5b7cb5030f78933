"""The port's cluster KV and leader/follower flush manager
(``m3_tpu_torch/cluster/kv.py``, ``m3_tpu_torch/aggregator/flush_mgr.py``)
against the JAX package's, over each package's ``Aggregator`` (the
port's on the CPU), with the same ticks and traffic.

Compared exactly: each tick's role, every emitted batch (instance,
timestamp, metric type, slots, aggregation types, value bits), the
persisted flush-times record, and each list's watermark.  Scenarios:
two replicas with one leader; the leader killed between ticks, the
follower promoted after the lease expires with no window flushed twice
or lost; a restart resuming at the persisted window; two-stage forwards
routed across shards by both the leader and the shadow-consuming
follower; and the lease election and KV semantics on their own.
"""

import json

import numpy as np
import pytest

import m3_tpu.aggregator.engine as je
import m3_tpu.aggregator.flush_mgr as jfm
import m3_tpu.cluster.kv as jkv
import m3_tpu.metrics.aggregation as jagg
import m3_tpu.metrics.pipeline as jpipe
import m3_tpu.metrics.policy as jpol
import m3_tpu.metrics.types as jtypes
import m3_tpu_torch.aggregator.engine as te
import m3_tpu_torch.aggregator.flush_mgr as tfm
import m3_tpu_torch.cluster.kv as tkv
import m3_tpu_torch.metrics.aggregation as tagg
import m3_tpu_torch.metrics.pipeline as tpipe
import m3_tpu_torch.metrics.policy as tpol
import m3_tpu_torch.metrics.types as ttypes

SEC = 10**9
T0 = 1000 * SEC
PKGS = {
    "jax": dict(eng=je, fm=jfm, kv=jkv, agg=jagg, pipe=jpipe, pol=jpol, types=jtypes, kw={}),
    "port": dict(eng=te, fm=tfm, kv=tkv, agg=tagg, pipe=tpipe, pol=tpol, types=ttypes,
                 kw={"device": "cpu"}),
}


class _World:
    """Two replicas sharing one KV store, one package."""

    def __init__(self, pkg, layout, kv_root=None):
        self.P = PKGS[pkg]
        self.kv = self.P["kv"].KVStore(kv_root)
        self.sink = []
        self.nodes = {}
        self.layout = layout

    def node(self, name):
        P = self.P
        opts = P["eng"].AggregatorOptions(
            capacity=64, num_windows=4, timer_sample_capacity=1024, layout=self.layout,
            storage_policies=(P["pol"].StoragePolicy.parse("10s:2d"),))
        agg = P["eng"].Aggregator(num_shards=2, opts=opts, **P["kw"])
        fm = P["fm"].FlushManager(agg, self.kv, name, lease_nanos=30 * SEC,
                                  flush_handler=lambda ml, f: self.sink.append((name, f)))
        self.nodes[name] = (agg, fm)
        return agg, fm

    def ingest(self, name, t0, n=8, seed=0):
        P = self.P
        agg = self.nodes[name][0]
        rng = np.random.default_rng(seed + t0 // SEC)
        ids = [b"metric-%d" % i for i in range(n)]
        agg.add_untimed_batch(P["types"].MetricType.GAUGE, ids,
                              np.round(rng.normal(5, 2, n), 3), np.full(n, t0 + SEC, np.int64))
        # a two-stage forward crossing shards
        sum_id = P["agg"].AggregationID.compress([P["agg"].AggregationType.SUM])
        pl = P["pipe"].Pipeline((P["pipe"].AppliedRollupOp(b"stage2.total", sum_id),))
        for sid in (b"s1.a", b"s1.b", b"s1.c"):
            agg.shard_for(sid).lists[agg.opts.storage_policies[0]].add_batch(
                P["types"].MetricType.COUNTER, [sid], np.asarray([float(t0 // SEC % 7 + 1)]),
                np.asarray([t0 + SEC], np.int64), sum_id, pipeline=pl)

    def canon(self):
        out = []
        for who, f in self.sink:
            out.append((who, f.timestamp_nanos, int(f.metric_type), f.slots.tolist(),
                        f.types.tolist(), np.asarray(f.values).view(np.uint64).tolist()))
        return out

    def times(self):
        cur = self.kv.get("_flushtimes/agg")
        return None if cur is None else (cur.version, json.loads(cur.data))

    def watermarks(self):
        return {name: [ml.consumed_until for sh in agg.shards for ml in sh.lists.values()]
                for name, (agg, _) in self.nodes.items()}


def _scenario_failover(w):
    roles = []
    w.node("n1")
    w.node("n2")
    w.ingest("n1", T0)
    w.ingest("n2", T0)
    roles += [w.nodes["n1"][1].tick(T0 + 10 * SEC), w.nodes["n2"][1].tick(T0 + 10 * SEC)]
    # n1 dies between ticks; n2 ingests on and takes over after the lease
    for k in (1, 2, 3):
        w.ingest("n2", T0 + k * 10 * SEC)
        roles.append(w.nodes["n2"][1].tick(T0 + (k + 1) * 10 * SEC))
    roles.append(w.nodes["n2"][1].tick(T0 + 60 * SEC))
    return roles


def _scenario_restart(w):
    roles = []
    w.node("n1")
    w.ingest("n1", T0)
    roles.append(w.nodes["n1"][1].tick(T0 + 10 * SEC))
    w.node("n1")  # restart: fresh state, watermark from the KV
    w.nodes["n1"][1].restore()
    roles.append(w.nodes["n1"][1].tick(T0 + 10 * SEC))
    w.ingest("n1", T0 + 10 * SEC)
    roles.append(w.nodes["n1"][1].tick(T0 + 20 * SEC))
    roles.append(w.nodes["n1"][1].tick(T0 + 30 * SEC))
    return roles


@pytest.mark.parametrize("layout", ["f64", "packed"])
@pytest.mark.parametrize("scenario", [_scenario_failover, _scenario_restart])
def test_flush_manager_matches_jax(scenario, layout, tmp_path):
    got = {}
    for pkg in PKGS:
        (tmp_path / pkg).mkdir()
        w = _World(pkg, layout, kv_root=str(tmp_path / pkg))
        roles = scenario(w)
        got[pkg] = (roles, w.canon(), w.times(), w.watermarks())
        assert (tmp_path / pkg / "kv.json").exists()
    assert got["port"] == got["jax"]
    roles, sink, _, _ = got["port"]
    assert "leader" in roles
    # every window emitted, by exactly one instance, never twice
    per = {}
    for who, ts, mt, slots, types, _ in sink:
        per.setdefault((ts, mt, tuple(slots), tuple(types)), set()).add(who)
    assert all(len(v) == 1 for v in per.values())
    windows = sorted({k[0] for k in per})
    assert windows == sorted(set(windows)) and len(windows) >= 2


def test_failover_emits_every_window_once(tmp_path):
    w = _World("port", "packed")
    _scenario_failover(w)
    wins = sorted({f.timestamp_nanos for _, f in w.sink})
    assert wins[:4] == [T0 + k * 10 * SEC for k in (1, 2, 3, 4)]
    per = {}
    for who, f in w.sink:
        per.setdefault(f.timestamp_nanos, set()).add(who)
    assert all(len(v) == 1 for v in per.values())
    assert per[T0 + 10 * SEC] == {"n1"} and per[T0 + 20 * SEC] == {"n2"}


def test_kv_and_lease_election_match_jax(tmp_path):
    def run(kvmod, root):
        kv = kvmod.KVStore(root)
        seen = []
        kv.watch("k", lambda v: seen.append((v.version, v.data)))
        out = [kv.set("k", b"a"), kv.check_and_set("k", 1, b"b")]
        for bad in (lambda: kv.check_and_set("k", 1, b"c"), lambda: kv.set_if_not_exists("k", b"d")):
            try:
                bad()
            except (KeyError, ValueError) as e:
                out.append(type(e).__name__)
        e1 = kvmod.LeaderElection(kv, "x", "n1", ttl_nanos=10 * SEC)
        e2 = kvmod.LeaderElection(kv, "x", "n2", ttl_nanos=10 * SEC)
        out += [e1.campaign(0), e2.campaign(5 * SEC), e1.campaign(8 * SEC),
                e2.campaign(15 * SEC), e2.campaign(19 * SEC), e2.is_leader(19 * SEC),
                e1.campaign(20 * SEC), e1.leader(20 * SEC)]
        with pytest.raises(ValueError):
            e1.campaign()
        legacy1, legacy2 = kvmod.LeaderElection(kv, "y", "a"), kvmod.LeaderElection(kv, "y", "b")
        out += [legacy1.campaign(), legacy2.campaign()]
        legacy1.resign()
        out += [legacy2.campaign(), kv.delete("k"), kv.delete("k"), kv.keys(), seen]
        reopened = kvmod.KVStore(root)
        out.append({k: (reopened.get(k).version, reopened.get(k).data) for k in reopened.keys()})
        return out

    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    assert run(tkv, str(tmp_path / "t")) == run(jkv, str(tmp_path / "j"))
