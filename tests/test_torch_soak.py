"""The port's soak (``m3_tpu_torch/dtest/soak.py``) against the JAX
package's (``m3_tpu/dtest/soak.py``) on the same seeded inputs: the
workload generator, the ledger and its digests, the chaos timelines, the
regression gate, the config round trip and the phase renderer, all
exactly equal.  Then every metric the soak's selfmon and controller rules
read is served by a live port node, and the port's ``cli soak --smoke``
runs end to end on the CPU with the reference smoke test's assertions
(``tests/test_soak.py``), its device window's refused writes never
acknowledged."""

import dataclasses
import json
import re

import numpy as np
import pytest

import m3_tpu.dtest.soak as jsoak
import m3_tpu_torch.dtest.soak as tsoak

BOTH = pytest.mark.parametrize("mod", [jsoak, tsoak], ids=["jax", "torch"])


# ---------------------------------------------------------------------------
# workload generator + ledger
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,churn", [(0, 0.02), (10, 0.02), (7, 0.05),
                                        (3, 0.0), (99, 0.5)])
@pytest.mark.parametrize("sweep", [0, 1, 5, 11])
def test_workload_ids_and_values_are_bit_equal(seed, churn, sweep):
    j = jsoak.WorkloadGen(5000, churn, seed)
    t = tsoak.WorkloadGen(5000, churn, seed)
    for lo, hi in ((0, 5000), (1234, 2345), (4999, 5000)):
        assert t.ids(sweep, lo, hi) == j.ids(sweep, lo, hi)
        tv, jv = t.values(sweep, lo, hi), j.values(sweep, lo, hi)
        assert tv.dtype == jv.dtype == np.float64
        assert np.array_equal(tv.view(np.uint64), jv.view(np.uint64))


def _ledger(mod, seed: int):
    rng = np.random.default_rng(seed)
    led = mod.Ledger(mod.WorkloadGen(3000, 0.05, seed))
    for k in range(12):
        lo = int(rng.integers(0, 2900))
        led.ack_bulk(int(rng.integers(0, 4)), lo, lo + int(rng.integers(1, 100)),
                     1_700_000_000 * 10**9 + k * 10**9)
    led.ack_explicit([(b"soakq;%04d" % i, 1_700_000_000 * 10**9 + i, i / 1000.0)
                      for i in range(40)])
    return led


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ledger_expected_and_digests_are_equal(seed):
    j, t = _ledger(jsoak, seed), _ledger(tsoak, seed)
    assert t.acked_samples == j.acked_samples
    je, te = j.expected(), t.expected()
    assert te == je
    stream = [(sid, ts, v) for sid in sorted(je) for ts, v in sorted(je[sid].items())]
    assert tsoak._digest(stream) == jsoak._digest(stream)


# ---------------------------------------------------------------------------
# chaos timelines, the gate, the config round trip
# ---------------------------------------------------------------------------

TIMELINE_CONFIGS = {
    "default": {},
    "smoke": {"smoke": True},
    "no_device_window": {"smoke": True, "t_device": 0.0},
    "no_disk_window": {"smoke": True, "disk_capacity": ""},
    "selfheal": {"smoke": True, "selfheal": True},
    "selfheal_full": {"selfheal": True, "disk_capacity": "256M", "t_disk": 20.0},
}


def _config(mod, kw: dict):
    kw = dict(kw)
    return (mod.SoakConfig.smoke_config(**kw) if kw.pop("smoke", False)
            else mod.SoakConfig(**kw))


@pytest.mark.parametrize("name", sorted(TIMELINE_CONFIGS))
def test_timelines_are_equal(name):
    kw = TIMELINE_CONFIGS[name]
    jc, tc = _config(jsoak, kw), _config(tsoak, kw)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    j = [e.to_dict() for e in jsoak.build_timeline(jc)]
    t = [e.to_dict() for e in tsoak.build_timeline(tc)]
    assert t == j and t


def _artifact(p99_ms=100.0, fleet_p99_s=0.1, loss=False):
    return {
        "kind": "SOAK", "schema": 1,
        "config": {"series": 1000, "nodes": 2, "smoke": True},
        "phases": [{
            "name": "healthy",
            "ingest": {"driver_p99_ms": p99_ms, "acked_samples": 100},
            "query": {"driver_p99_ms": p99_ms / 2},
            "fleet_ingest": {"quantiles": {"p99": fleet_p99_s}},
            "fleet_query": {"quantiles": {"p99": fleet_p99_s / 2}},
        }],
        "verdict": {"zero_acked_loss": not loss, "missing": 3 if loss else 0,
                    "mismatched": 0, "acked_samples": 100},
    }


def _with_setup(art, p99):
    art["phases"].insert(0, {
        "name": "setup",
        "ingest": {"driver_p99_ms": p99}, "query": {"driver_p99_ms": p99},
        "fleet_ingest": {"quantiles": {"p99": p99 / 1e3}},
        "fleet_query": {"quantiles": {"p99": p99 / 1e3}},
    })
    return art


def _slo(recorded):
    art = _artifact()
    art["verdict"]["slo_recorded"] = recorded
    return art


def _schema2():
    art = _artifact()
    art["schema"] = 2
    return art


# the reference's TestCheckGate cases (tests/test_soak.py): (new, base, tolerance)
GATE_CASES = {
    "clean": (_artifact, _artifact, 2.0),
    "loss": (lambda: _artifact(loss=True), _artifact, 1e9),
    "driver_p99": (lambda: _artifact(p99_ms=500.0), _artifact, 2.0),
    "fleet_p99": (lambda: _artifact(fleet_p99_s=1.0), _artifact, 2.0),
    "within_tolerance": (lambda: _artifact(p99_ms=150.0, fleet_p99_s=0.15),
                         _artifact, 2.0),
    "kind": (lambda: {"kind": "BENCH"}, _artifact, 2.0),
    "slo_not_recorded": (lambda: _slo(False), _artifact, 2.0),
    "slo_recorded": (lambda: _slo(True), _artifact, 2.0),
    "schema": (_schema2, _artifact, 2.0),
    "setup_excluded": (lambda: _with_setup(_artifact(), 50_000.0),
                       lambda: _with_setup(_artifact(), 10.0), 2.0),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_check_gate_gives_the_same_violations(case):
    new, base, tol = GATE_CASES[case]
    j = jsoak.check_artifact(new(), base(), tolerance=tol)
    t = tsoak.check_artifact(new(), base(), tolerance=tol)
    assert t == j
    assert bool(t) == (case in ("loss", "driver_p99", "fleet_p99", "kind",
                                "slo_not_recorded", "schema"))


@BOTH
def test_config_from_artifact_round_trips(mod):
    """Either package's artifact config rebuilds the port's config, and
    the port's the reference's: the same fields and defaults."""
    cfg = mod.SoakConfig.smoke_config()
    art = {"config": dataclasses.asdict(cfg)}
    for rebuild in (jsoak, tsoak):
        cfg2 = rebuild.config_from_artifact(art, series=999)
        assert cfg2.nodes == cfg.nodes and cfg2.series == 999 and cfg2.smoke
        assert dataclasses.asdict(cfg2) == dict(dataclasses.asdict(cfg), series=999)


# ---------------------------------------------------------------------------
# the phase renderer on a fixed scrape
# ---------------------------------------------------------------------------


def _scrape_text(writes: int, hist: list, extra: str = "") -> str:
    lines = []
    for base in ("m3tpu_db_write_batch_seconds", "m3tpu_query_seconds"):
        lines.append(f"# TYPE {base} histogram")
        cum = 0
        for le, n in zip(("0.001", "0.25", "1", "+Inf"), hist):
            cum += n
            lines.append(f'{base}_bucket{{le="{le}"}} {cum}')
        lines.append(f"{base}_sum {sum(hist) * 0.01}")
        lines.append(f"{base}_count {cum}")
    lines.append("# TYPE m3tpu_db_writes counter")
    lines.append(f"m3tpu_db_writes {writes}")
    lines.append("# TYPE m3tpu_db_corruption_detected counter")
    lines.append("m3tpu_db_corruption_detected 1")
    return "\n".join(lines) + "\n" + extra


def _rendered(mod, exposition):
    scrapes = [
        {0: exposition.parse_text(_scrape_text(10, [1, 2, 0, 0])),
         1: exposition.parse_text(_scrape_text(5, [0, 1, 1, 0]))},
        {0: exposition.parse_text(_scrape_text(40, [3, 4, 1, 1])),
         1: None},  # node 1 down at the boundary
        {0: exposition.parse_text(_scrape_text(45, [3, 5, 1, 1])),
         1: exposition.parse_text(_scrape_text(2, [1, 0, 0, 0]))},  # restarted
    ]
    it = iter(scrapes)
    tr = mod.PhaseTracker(lambda: next(it))
    tr.transition("healthy")
    tr.record_ingest(0.010, 100)
    tr.record_ingest(0.030, 50)
    tr.record_ingest_failure()
    tr.record_query(0.2, "ok")
    tr.record_query(0.3, "shed")
    tr.record_query(0.4, "err")
    tr.transition("wire_faults")
    tr.record_ingest(0.5, 10)
    tr.finish()
    for k, p in enumerate(tr.phases):  # fixed walls
        p.t_start, p.t_end = 10.0 * k, 10.0 * k + 7.5
    return tr.render()


def test_phase_render_is_equal_on_a_fixed_scrape():
    from m3_tpu.instrument import exposition as jexp
    from m3_tpu_torch.instrument import exposition as texp

    j = _rendered(jsoak, jexp)
    t = _rendered(tsoak, texp)
    assert t == j
    assert [p["name"] for p in t] == ["healthy", "wire_faults"]
    assert t[1]["counters"]["db_writes"] == 45 - 40 + 2  # restart-aware
    assert t[0]["fleet_ingest"]["unreachable"] == [1]  # down at its close


# ---------------------------------------------------------------------------
# the rules' metrics on a live port node
# ---------------------------------------------------------------------------

_METRIC = re.compile(r"([A-Za-z_:][A-Za-z0-9_:]*)\s*[{\[]")


def _rule_metrics(cluster) -> set:
    names = set()
    for rule in cluster._selfmon_config(0)["rules"]:
        names |= {m for m in _METRIC.findall(rule["ratio"]) if m != "window"}
    return names


def test_every_metric_the_rules_read_is_served(tmp_path):
    """Two port nodes with the soak's whole selfmon + controller + disk
    configuration (the selfheal profile binds every rule), node 0 under
    the soak's two fault kinds in turn (a device window, then dropped
    wire frames) around one write each, then one clean write and one
    query: each metric a rule reads must be on node 0's /metrics — a
    rule that names a metric the port lacks would read an empty ratio,
    a verdict that never fires."""
    from m3_tpu_torch.client.session import ConsistencyError
    from m3_tpu_torch.dtest.harness import scrape_fleet
    from m3_tpu_torch.index.doc import Document, Field

    cfg = tsoak.SoakConfig(nodes=2, series=100, num_shards=2, slot_capacity=1 << 10,
                           replace=False, selfheal=True, disk_capacity="64M",
                           t_disk=5.0, disk_rule="disk-pressure", smoke=True)
    cluster = tsoak.SoakCluster(cfg, tmp_path, device="cpu")
    try:
        cluster.start()
        want = _rule_metrics(cluster)
        assert {"device_error_total", "device_guard_calls", "fault_drop_triggers",
                "disk_free_ratio", "m3tpu_db_write_batch_seconds_count",
                "m3tpu_query_seconds_bucket"} <= want, want
        now = 1_700_000_000 * 10**9
        docs = [Document(b"soakq;0000", (Field(b"__name__", b"soakq"),))]
        for spec in (cfg.device_spec, "rpc.server=drop:p=1.0"):
            cluster.arm_faults(0, spec)
            with pytest.raises(ConsistencyError):  # Majority of rf 2: refused
                cluster.session.write_tagged_batch(
                    tsoak.NS, docs, np.array([now]), np.array([1.0]), now_nanos=now)
        cluster.clear_faults(0)
        assert cluster.session.write_tagged_batch(
            tsoak.NS, docs, np.array([now]), np.array([1.0]), now_nanos=now) == 0
        cluster.promql(0, "sum(soakq)")
        served = {s.name for s in scrape_fleet([cluster.http_port(0)])[cluster.http_port(0)]}
        assert want <= served, sorted(want - served)
        assert "device_fallback_total" not in served
    finally:
        cluster.close()


# ---------------------------------------------------------------------------
# the smoke soak end to end, on the CPU
# ---------------------------------------------------------------------------


def test_cli_soak_smoke_end_to_end(tmp_path):
    """``cli soak --smoke --device cpu``: 2 real port node processes on
    the CPU, one wire-fault window, one device window, one disk window —
    generator, chaos scheduler, runtime fault re-arm, ledger verify and
    artifact schema end to end, with the reference smoke test's
    assertions.  In the device window node 0 refuses its appends, so
    writes at Majority of rf 2 fail there and stay out of the ledger."""
    from m3_tpu_torch.tools import cli

    out = tmp_path / "SOAK_smoke.json"
    rc = cli.main(["soak", "--smoke", "--series", "6000", "--sweeps", "1",
                   "--device", "cpu", "--out", str(out)])
    assert rc == 0
    art = json.loads(out.read_text())
    assert art["kind"] == "SOAK" and art["schema"] == 1
    v = art["verdict"]
    assert v["zero_acked_loss"] is True
    assert v["missing"] == 0 and v["mismatched"] == 0
    assert v["ledger_sha256"] == v["recovered_sha256"]
    assert v["active_series"] >= 6000
    names = [p["name"] for p in art["phases"]]
    assert names[0] == "setup"
    assert {"healthy", "wire_faults", "recovered"} <= set(names)
    assert any(e["action"] == "wire_fault" and e["ok"] for e in art["chaos"])
    for p in art["phases"]:
        if p["name"] == "recovered":
            assert p["fleet_ingest"]["count"] > 0
            assert p["fleet_ingest"]["quantiles"]["p99"] is not None
            assert p["ingest"]["acked_samples"] > 0
    total = sum(p["ingest"]["acked_samples"] for p in art["phases"])
    assert 0 < total <= v["acked_samples"]
    assert v["slo_recorded"] is True
    sm = art["selfmon"]
    assert sm["verdicts"], sm
    rules = {vd["rule"] for vd in sm["verdicts"]}
    assert {"ingest-latency", "query-latency"} <= rules
    insts = {vd["instance"] for vd in sm["verdicts"]}
    assert {"i0", "i1"} <= insts
    assert sm["queries"]["fleet_ingest_p99_s"] is not None
    assert sm["health_slo"] and "rules" in sm["health_slo"]
    assert "ingest-errors" in rules
    ctl = art["controller"]
    assert ctl["actions_total"] == 0 and ctl["history"] == []
    assert v["controller_quiet"] is True
    assert v["controller_relaxed"] is True
    assert ctl["nodes"], ctl
    for node in ctl["nodes"].values():
        assert all(node["at_baseline"].values())
    # the device window: every chaos event ran, node 0 refused guarded
    # dispatches there and nowhere else, no other node refused any, and
    # the refused batches failed (unacked) while the verdict holds
    assert all(e["ok"] for e in art["chaos"]), art["chaos"]
    assert any(e["action"] == "device_fault" for e in art["chaos"])
    dev = art["device"]
    assert dev["device"] == "cpu"
    for inst, rec in dev["nodes"].items():
        assert rec["encode_calls"] > 0, (inst, rec)  # the historical flush
        errs = {p: n for p, n in rec["errors_by_phase"].items() if n}
        assert set(errs) == ({"device_faults"} if inst == "i0" else set()), (inst, rec)
    window = next(p for p in art["phases"] if p["name"] == "device_faults")
    assert window["ingest"]["failed_batches"] > 0
