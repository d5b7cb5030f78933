"""The port's placements (``m3_tpu_torch/cluster/placement.py``,
``placement_mirrored.py``) against the JAX package's.

The same inputs give the same assignment in both packages: every step
of each scenario is compared as the placement's JSON bytes (shard,
state, source, version, the mirrored flag), and each refused move
raises the same exception with the same message.  A placement either
package writes into a KV root reads back equal in the other, and the
CAS update loop behaves alike under a conflicting writer.
"""

import numpy as np
import pytest

import m3_tpu.client.aggregator_client as jclient
import m3_tpu.cluster.kv as jkv
import m3_tpu.cluster.placement as jp
import m3_tpu.cluster.placement_mirrored as jm
import m3_tpu_torch.client.aggregator_client as tclient
import m3_tpu_torch.cluster.kv as tkv
import m3_tpu_torch.cluster.placement as tp
import m3_tpu_torch.cluster.placement_mirrored as tm

PKGS = {"jax": (jp, jm, jkv, jclient), "port": (tp, tm, tkv, tclient)}


def outcome(fn, *a, **kw):
    try:
        r = fn(*a, **kw)
        return ("ok", r.to_json() if hasattr(r, "to_json") else r)
    except Exception as e:  # noqa: BLE001 — the outcome is the datum
        return ("raise", type(e).__name__, str(e))


def insts(P, spec):
    """spec: (id, isolation group, weight, shard set, endpoint) tuples."""
    return [P.Instance(i, g, w, shard_set_id=ss, endpoint=ep) for i, g, w, ss, ep in spec]


SHARDED = [
    # (instances, num_shards, rf)
    ([("a", "g0", 1, 0, ""), ("b", "g1", 1, 0, ""), ("c", "g2", 1, 0, "")], 12, 2),
    ([("a", "g0", 1, 0, "h:1"), ("b", "g0", 2, 0, "h:2"), ("c", "g1", 1, 0, ""),
      ("d", "g1", 3, 0, "")], 64, 3),
    ([("n%d" % i, "g%d" % (i % 3), 1 + i % 2, 0, "") for i in range(7)], 1024, 3),
    ([("solo", "", 1, 0, "")], 16, 1),
]


def sharded_steps(mod, spec, n, rf):
    """One scenario's placements (or refusals) step by step."""
    P = mod[0]
    out = []
    p = P.initial_placement(insts(P, spec), n, rf)
    out.append(p.to_json())
    first = spec[0][0]
    newcomer = P.Instance("new", "g9", 2, endpoint="h:9")
    for step in (lambda q: P.add_instance(q, newcomer),
                 lambda q: P.remove_instance(q, first),
                 lambda q: P.replace_instance(q, spec[-1][0], P.Instance("rep", "gR")),
                 lambda q: P.forget_instance(q, first),
                 lambda q: P.forget_instance(q, "nobody")):
        r = outcome(step, p)
        out.append(r)
        if r[0] == "ok":
            p2 = P.Placement.from_json(r[1])
            # cut over every initializing shard, one at a time
            for inst in sorted(p2.instances):
                for s, a in sorted(p2.instances[inst].shards.items()):
                    if a.state == P.ShardState.INITIALIZING:
                        p2 = P.mark_available(p2, inst, s)
                        out.append(p2.to_json())
            out.append(outcome(p2.validate))
            out.append(outcome(P.mark_available, p2, first, 0))
            p = p2
    return out


@pytest.mark.parametrize("spec,n,rf", SHARDED)
def test_sharded_moves_give_the_same_placements(spec, n, rf):
    got = {k: sharded_steps(m, spec, n, rf) for k, m in PKGS.items()}
    assert got["port"] == got["jax"]
    assert len(got["port"]) > 4


def test_initial_placement_refusals_match():
    for spec, n, rf in (([("a", "g0", 1, 0, "")], 4, 2),
                        ([("a", "g0", 1, 0, ""), ("b", "g0", 1, 0, "")], 4, 3)):
        a = outcome(jp.initial_placement, insts(jp, spec), n, rf)
        b = outcome(tp.initial_placement, insts(tp, spec), n, rf)
        assert a == b and a[0] == "raise"


def mirror_spec(groups, iso=None):
    return [(iid, (iso or {}).get(iid, f"g{k}"), 1 + (k % 2), ssid, f"{iid}:1")
            for ssid, ids in groups.items() for k, iid in enumerate(ids)]


MIRRORED = [
    ({1: ["a1", "a2"], 2: ["b1", "b2"], 3: ["c1", "c2"]}, 12, 2),
    ({1: ["a1", "a2"], 2: ["b1", "b2"]}, 64, 2),
    ({7: ["x1", "x2", "x3"], 3: ["y1", "y2", "y3"]}, 10, 3),
    ({1: ["a1", "a2"]}, 64, 2),
]


def mirrored_steps(mod, groups, n, rf):
    P, M = mod[0], mod[1]
    out = []
    p = M.mirrored_initial_placement(insts(P, mirror_spec(groups)), n, rf)
    out.append(p.to_json())
    out.append(outcome(M.validate_mirrored, p))
    ssid0 = sorted(groups)[0]
    m0 = groups[ssid0][-1]
    new_group = [P.Instance(f"z{k}", f"g{k}", 1, shard_set_id=99) for k in range(rf)]

    def cut_over(q):
        for inst in sorted(q.instances):
            if inst not in q.instances:
                continue
            for s, a in sorted(q.instances[inst].shards.items()):
                if a.state == P.ShardState.INITIALIZING:
                    q = M.mirrored_mark_available(q, inst, s)
                    out.append(q.to_json())
        return q

    for step in (lambda q: M.mirrored_add_group(q, new_group),
                 lambda q: M.mirrored_replace_instance(q, m0, P.Instance("r0", "gR")),
                 lambda q: M.mirrored_remove_group(q, ssid0),
                 lambda q: M.mirrored_remove_group(q, 12345),
                 lambda q: M.mirrored_add_group(q, new_group[:1]),
                 lambda q: M.mirrored_add_group(q, new_group)):
        r = outcome(step, p)
        out.append(r)
        if r[0] == "ok":
            p = cut_over(P.Placement.from_json(r[1]))
            out.append(outcome(M.validate_mirrored, p))
    # the shared cutover keeps the mirrored flag
    q = M.mirrored_replace_instance(p, sorted(p.instances)[0], P.Instance("r1", "gQ"))
    s0 = sorted(q.instances["r1"].shards)[0]
    out.append(P.mark_available(q, "r1", s0).to_json())
    out.append(outcome(M.mirrored_mark_available, q, "r1", 10**6))
    out.append(M.iid_all_leaving(q, sorted(p.instances)[0]))
    return out


@pytest.mark.parametrize("groups,n,rf", MIRRORED)
def test_mirrored_moves_give_the_same_placements(groups, n, rf):
    got = {k: mirrored_steps(m, groups, n, rf) for k, m in PKGS.items()}
    assert got["port"] == got["jax"]


def test_mirrored_refusals_match():
    for groups, n, rf in (({1: ["a1", "a2", "a3"], 2: ["b1", "b2"]}, 4, 2), ({}, 4, 2)):
        a = outcome(jm.mirrored_initial_placement, insts(jp, mirror_spec(groups)), n, rf)
        b = outcome(tm.mirrored_initial_placement, insts(tp, mirror_spec(groups)), n, rf)
        assert a == b and a[0] == "raise"
    bad = jm.mirrored_initial_placement(insts(jp, mirror_spec({1: ["a", "b"]})), 4, 2)
    raw = bad.to_json().replace(b'"0": ["A", null]', b'"0": ["I", null]', 1)
    for P, M in ((jp, jm), (tp, tm)):
        assert outcome(M.validate_mirrored, P.Placement.from_json(raw))[0] == "raise"
    assert outcome(jm.validate_mirrored, jp.Placement.from_json(raw)) == \
        outcome(tm.validate_mirrored, tp.Placement.from_json(raw))


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_kv_placement_reads_back_in_the_other_package(writer, reader, tmp_path):
    Pw, Mw, KVw, _ = PKGS[writer]
    Pr, _, KVr, _ = PKGS[reader]
    svc = Pw.PlacementService(KVw.KVStore(str(tmp_path)))
    p = Mw.mirrored_initial_placement(insts(Pw, mirror_spec({1: ["a", "b"], 2: ["c", "d"]})),
                                      16, 2)
    svc.set(p)
    svc.update(lambda q: Mw.mirrored_replace_instance(q, "b", Pw.Instance("e", "g1")))
    got = Pr.PlacementService(KVr.KVStore(str(tmp_path))).get()
    assert got.to_json() == svc.get().to_json()
    assert got.version == 2 and got.is_mirrored
    assert got.instances["e"].shards[0].state == Pr.ShardState.INITIALIZING
    assert got.instances["e"].endpoint == "" and got.instances["a"].endpoint == "a:1"


def test_kv_files_are_byte_equal(tmp_path):
    for k, (P, M, KV, _) in PKGS.items():
        (tmp_path / k).mkdir()
        svc = P.PlacementService(KV.KVStore(str(tmp_path / k)))
        svc.set(P.initial_placement(insts(P, SHARDED[1][0]), 64, 3))
        svc.update(lambda q: P.add_instance(q, P.Instance("x", "g5")))
    assert (tmp_path / "port" / "kv.json").read_bytes() == \
        (tmp_path / "jax" / "kv.json").read_bytes()


def test_update_retries_a_version_conflict_like_jax():
    got = {}
    for k, (P, M, KV, _) in PKGS.items():
        kv = KV.KVStore()
        svc = P.PlacementService(kv)
        svc.set(P.initial_placement(insts(P, SHARDED[0][0]), 12, 2))
        races = []

        def mutate(q):
            if not races:  # another writer lands between our get and our set
                races.append(1)
                svc.set(P.add_instance(q, P.Instance("other", "g7")))
            return P.add_instance(q, P.Instance("mine", "g8"))

        p = svc.update(mutate)
        always = outcome(svc.update, lambda q: (kv.set("placement", q.to_json()),
                                                 P.add_instance(q, P.Instance("z")))[1],
                         max_attempts=2)
        got[k] = (p.to_json(), kv.get("placement").version, always,
                  outcome(svc.update, lambda q: P.forget_instance(q, "nobody")))
    assert got["port"] == got["jax"]
    assert got["port"][2][0] == "raise" and "version conflict" in got["port"][2][2]


@pytest.mark.parametrize("groups,n,rf", MIRRORED[:3])
def test_client_fans_each_shard_to_its_mirror_set(groups, n, rf):
    got = {}
    ids = [b"metric-%d" % i for i in range(200)]
    for k, (P, M, KV, C) in PKGS.items():
        p = M.mirrored_initial_placement(insts(P, mirror_spec(groups)), n, rf)
        client = C.AggregatorClient(p, resolve=lambda iid: ("127.0.0.1", 1))
        reached = client.write_batch(np.ones(200, np.uint8), ids, np.arange(200.0),
                                     np.arange(200, dtype=np.int64))
        got[k] = (reached, {key: list(q._ids) for key, q in client.queues.items()})
    assert got["port"] == got["jax"]
    reached, queues = got["port"]
    assert reached == 200 * rf
    for key, q_ids in queues.items():
        for mid in q_ids:
            owners = {i.id for i in p.instances_for_shard(tclient.shard_for(mid, n))}
            assert key[0] in owners and len(owners) == rf
