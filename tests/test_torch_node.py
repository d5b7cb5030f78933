"""The port's node (m3_tpu_torch.server: config → assembly → bootstrap →
mediator → HTTP front door) against the JAX package's node on the CPU.

Both nodes run in this process, each from the same YAML text under its
own root and on an ephemeral port (the JAX node as
``tests/test_mediator_snapshot.py`` runs it, the port's with
``device="cpu"``), and get one scripted sequence of requests: JSON,
Prometheus remote and Influx writes, ``query_range`` (GET and POST),
``query``, labels, label values, series, remote read, a ``timeout=0``
query and read (504 in both), the Graphite routes (byte-equal bodies),
``/metrics``, ``/health`` and the faultpoint surface.  Status codes, written counts and metadata answers
must be exact; query values within ``rtol`` 1e-12 (the tolerance of
``tests/test_torch_query_engine.py`` for these families); the remote
read body byte-equal.  Then ``mediator.run_once`` on the same clock past
the block: equal stats (tick, snapshot, cleanup, scrub), and after both
nodes close, every fileset, commit-log, index and snapshot file
sha256-equal.  A restart on the same roots answers the same.  A
downsampling node's rollup volumes, and a checkpointed node's restored
windows, are sha256-equal to the JAX node's, with equal checkpoint
counters.  Finally ``node_main --device cpu`` as a subprocess boots,
writes ``node.json``, answers ``/health`` and exits 0 on SIGTERM.
"""

import hashlib
import io
import json
import math
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.parse
import urllib.request
import zipfile

import numpy as np
import pytest

import m3_tpu.metrics.rules_json as jrj
import m3_tpu.server.assembly as jasm
import m3_tpu.server.prom_remote as jpr
import m3_tpu_torch.metrics.rules_json as trj
import m3_tpu_torch.server.assembly as tasm
import m3_tpu_torch.server.prom_remote as tpr
from tests.test_torch_control_node import _fresh_process_counters

BLOCK = 2 * 3600 * 10**9
START = (1_700_000_000 * 10**9) // BLOCK * BLOCK
SEC = 10**9
REPO = pathlib.Path(__file__).resolve().parent.parent

CONFIG = """
db:
  root: {root}
  namespaces:
    default: {{num_shards: 2, slot_capacity: 1024, sample_capacity: 8192}}
coordinator: {{listen_port: 0{extra}}}
mediator: {{tick_interval: 1h, snapshot_every: 1, cleanup_every: 1,
           scrub_every: 1, scrub_volumes: 4}}
"""


def _boot(side, root, extra="", ruleset=None):
    text = CONFIG.format(root=root, extra=extra)
    if side == "jax":
        return jasm.run_node(text, ruleset=ruleset)
    return tasm.run_node(text, ruleset=ruleset, device="cpu")


def _call(port, path, body=None, method=None, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _digests(root) -> dict:
    root = pathlib.Path(root)
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _series(mod, k0, k1):
    """Remote-write traffic: 6 counters (3 hosts x 2 codes), scrapes k0..k1
    every 10 s, values from a seed."""
    rng = np.random.default_rng(7)
    incs = rng.integers(0, 50, (6, 200))
    out = []
    for i in range(6):
        labels = {b"__name__": b"http_requests_total", b"host": b"h%d" % (i // 2),
                  b"code": [b"200", b"500"][i % 2]}
        pts = [(START + k * 10 * SEC, float(incs[i, :k + 1].sum()))
               for k in range(k0, k1)]
        out.append(mod.PromTimeSeries(labels, pts))
    return out


def _json_samples(k0, k1):
    return json.dumps([
        {"tags": {"__name__": "cpu", "host": f"h{i}"},
         "timestamp": (START + k * 10 * SEC) // SEC, "value": (i + 1) * 0.25 * k}
        for k in range(k0, k1) for i in range(3)]).encode()


def _influx(k0, k1):
    return "\n".join(
        f"mem,host=h{i} used={100 + i * k}i,free={0.5 * k} {START + k * 10 * SEC}"
        for k in range(k0, k1) for i in range(2)).encode()


def _read_body(mod):
    q = (mod._emit_field(1, 0, mod._emit_varint(START // 10**6))
         + mod._emit_field(2, 0, mod._emit_varint((START + 3600 * SEC) // 10**6))
         + mod._emit_len(3, mod._emit_field(1, 0, mod._emit_varint(0))
                         + mod._emit_len(2, b"__name__")
                         + mod._emit_len(3, b"http_requests_total"))
         + mod._emit_len(3, mod._emit_field(1, 0, mod._emit_varint(2))
                         + mod._emit_len(2, b"host") + mod._emit_len(3, b"h[01]")))
    return mod.snappy.compress(mod._emit_len(1, q))


T_END = (START + 590 * SEC) // SEC
QUERIES = [
    f"/api/v1/query_range?query=sum+by+(host)+(rate(http_requests_total[1m]))"
    f"&start={START // SEC + 60}&end={T_END}&step=30s",
    f"/api/v1/query_range?query=avg_over_time(cpu[2m])&start={START // SEC + 120}"
    f"&end={T_END}&step=15",
    f"/api/v1/query?query=sum(mem_used)+/+sum(mem_free)&time={T_END}",
    f"/api/v1/query?query=increase(http_requests_total{{code=\"500\"}}[5m])"
    f"&time={T_END}",
]


def _same_answer(a: bytes, b: bytes) -> None:
    """Two query responses: the same series, values within rtol 1e-12."""
    da, db = json.loads(a), json.loads(b)
    assert da["status"] == db["status"] == "success"
    ra = {json.dumps(r["metric"], sort_keys=True): r for r in da["data"]["result"]}
    rb = {json.dumps(r["metric"], sort_keys=True): r for r in db["data"]["result"]}
    assert ra.keys() == rb.keys() and ra
    for key, r in ra.items():
        va = r.get("values", [r.get("value")])
        vb = rb[key].get("values", [rb[key].get("value")])
        assert [t for t, _ in va] == [t for t, _ in vb]
        for (_, x), (_, y) in zip(va, vb):
            assert math.isclose(float(x), float(y), rel_tol=1e-12, abs_tol=0.0) \
                or x == y, (key, x, y)


def _metric_lines(text: bytes, names) -> dict:
    out = {}
    for line in text.decode().splitlines():
        for n in names:
            if line.startswith(n + " ") or line.startswith(n + "{"):
                out[line.rsplit(" ", 1)[0]] = float(line.rsplit(" ", 1)[1])
    return out


COUNTERS = ("m3tpu_db_writes_tagged", "m3tpu_db_reads", "m3tpu_mediator_ticks",
            "m3tpu_mediator_warm_flushed", "m3tpu_scrub_volumes_checked",
            "m3tpu_scrub_sweeps", "m3tpu_db_tick_seconds_count",
            "m3tpu_db_write_batch_seconds_count", "m3tpu_query_seconds_count",
            "m3tpu_ingest_seconds_count", "m3tpu_block_cache_misses",
            "m3tpu_aggregator_checkpoint_saves",
            "m3tpu_aggregator_checkpoint_restores")


def _traffic(port, k0, k1, mod):
    """One pass of writes; returns the statuses and written counts."""
    got = []
    st, _, body = _call(port, "/api/v1/json/write", _json_samples(k0, k1), "POST")
    got.append((st, json.loads(body)))
    st, _, _ = _call(port, "/api/v1/prom/remote/write",
                     mod.build_write_request(_series(mod, k0, k1)), "POST",
                     {"Content-Encoding": "snappy"})
    got.append((st,))
    st, h, _ = _call(port, "/api/v1/influxdb/write?precision=ns", _influx(k0, k1), "POST")
    got.append((st, h.get("X-Written")))
    st, h, _ = _call(port, "/write", _influx(k1, k1 + 1), "POST")
    got.append((st, h.get("X-Written")))
    return got


def _reads(port, mod):
    """Every read request; returns {name: (status, body)}."""
    out = {}
    for i, q in enumerate(QUERIES):
        out[f"q{i}"] = _call(port, q)[::2]
    path, _, form = QUERIES[0].partition("?")
    out["post"] = _call(port, path, form.encode(), "POST",
                        {"Content-Type": "application/x-www-form-urlencoded"})[::2]
    end = f"&start={START // SEC}&end={T_END}"
    out["labels"] = _call(port, "/api/v1/labels?" + end[1:])[::2]
    out["values"] = _call(port, "/api/v1/label/host/values?" + end[1:])[::2]
    out["series"] = _call(port, "/api/v1/series?" + end[1:])[::2]
    out["read"] = _call(port, "/api/v1/prom/remote/read", _read_body(mod), "POST")[::2]
    out["q_504"] = _call(port, QUERIES[0] + "&timeout=0")[::2]
    out["read_504"] = _call(port, "/api/v1/prom/remote/read?timeout=0",
                            _read_body(mod), "POST")[::2]
    out["bad"] = _call(port, "/api/v1/query?query=sum(&time=1")[::2]
    out["unknown"] = _call(port, "/api/v1/nope")[::2]
    out["traces"] = _call(port, "/api/v1/debug/traces")[::2]
    return out


GRAPHITE_WINDOW = f"&from={START // SEC}&until={T_END}&step=30s"
GRAPHITE_READS = [
    "/render?target=x" + GRAPHITE_WINDOW,
    "/render?target=constantLine(3)&target=identity(%22t%22)" + GRAPHITE_WINDOW,
    "/render?target=sumSeries(http_requests_total)" + GRAPHITE_WINDOW,
    "/render?target=nosuch(x)" + GRAPHITE_WINDOW,
    "/metrics/find?query=x",
    "/metrics/find?query=*",
]


def _same_reads(t, j):
    assert {k: v[0] for k, v in t.items()} == {k: v[0] for k, v in j.items()}
    for k in [f"q{i}" for i in range(len(QUERIES))] + ["post"]:
        assert t[k][0] == 200, (k, t[k])
        _same_answer(t[k][1], j[k][1])
    for k in ("labels", "values", "series"):
        assert json.loads(t[k][1]) == json.loads(j[k][1]), k
    assert t["read"][1] == j["read"][1]          # byte-equal ReadResponse
    for k in ("q_504", "read_504"):
        assert t[k][0] == 504


@pytest.fixture
def nodes(tmp_path):
    # /health and /metrics read each package's process-global ledgers
    # (breakers, device stages, membudget, capacity counters): another
    # test in this process must not leave one package's set apart
    _fresh_process_counters()
    made = {}

    def boot(name, side, **kw):
        root = tmp_path / f"{name}-{side}"
        made[(name, side)] = _boot(side, root, **kw)
        return made[(name, side)], root

    yield boot
    for asm in made.values():
        try:
            asm.close()
        except Exception:  # noqa: BLE001 — already closed by the test
            pass


def test_requests_flush_files_and_restart_match(nodes):
    (ta, troot), (ja, jroot) = nodes("n", "torch"), nodes("n", "jax")
    wrote = _traffic(ta.port, 0, 40, tpr)
    assert wrote == _traffic(ja.port, 0, 40, jpr)
    assert wrote == [(200, {"status": "success", "written": 120}), (204,),
                     (204, "160"), (204, "4")]
    t_reads, j_reads = _reads(ta.port, tpr), _reads(ja.port, jpr)
    _same_reads(t_reads, j_reads)
    assert len(json.loads(t_reads["series"][1])["data"]) == 6 + 3 + 4

    # faultpoint surface: the same armed spec document
    spec = {"arm": "node.test=delay:ms=0:n=1:seed=3"}
    ft = json.loads(_call(ta.port, "/api/v1/debug/faults",
                          json.dumps(spec).encode(), "POST")[2])
    fj = json.loads(_call(ja.port, "/api/v1/debug/faults",
                          json.dumps(spec).encode(), "POST")[2])
    assert ft["armed"] == fj["armed"] and ft["armed_count"] == 1
    for port in (ta.port, ja.port):
        _call(port, "/api/v1/debug/faults", b'{"disarm": ["node.test"]}', "POST")

    # the Graphite routes answer as the JAX node's, byte for byte
    for path in GRAPHITE_READS:
        got = [_call(port, path)[::2] for port in (ta.port, ja.port)]
        assert got[0] == got[1] and got[0][0] in (200, 400), (path, got)
    # the debug bundle: a zip of the reference's members
    members = []
    for port in (ta.port, ja.port):
        st, _, body = _call(port, "/debug/dump?seconds=0.05")
        assert st == 200
        members.append(zipfile.ZipFile(io.BytesIO(body)).namelist())
    assert members[0] == members[1] == ["threads.txt", "cpu.txt", "heap.txt",
                                        "host.json"]

    st_t, _, ht = _call(ta.port, "/health")
    st_j, _, hj = _call(ja.port, "/health")
    assert st_t == st_j == 200
    assert json.loads(ht)["ok"] and set(json.loads(ht)) == set(json.loads(hj))

    # the mediator on one clock, past the block end + bufferPast
    now = START + BLOCK + 11 * 60 * SEC
    st = ta.mediator.run_once(now)
    sj = ja.mediator.run_once(now)
    for s in (st, sj):
        s.pop("duration_s")
    assert st == sj
    assert st["tick"]["default"]["warm_flushed"] > 0
    assert st["scrub"]["checked"] > 0 and st["scrub"]["corrupt"] == 0
    _same_reads(_reads(ta.port, tpr), _reads(ja.port, jpr))

    mt = _metric_lines(_call(ta.port, "/metrics")[2], COUNTERS)
    mj = _metric_lines(_call(ja.port, "/metrics")[2], COUNTERS)
    assert mt == mj and mt["m3tpu_db_writes_tagged"] == 120 + 240 + 160 + 4
    assert "m3tpu_mediator_tick_errors" not in _call(ta.port, "/metrics")[2].decode()

    ta.close()
    ja.close()
    dt, dj = _digests(troot), _digests(jroot)
    assert dt == dj
    assert any("fileset" in k for k in dt) and any("commitlog" in k for k in dt)

    # restart on the same roots: bootstrap replays what the files hold
    ta, ja = _boot("torch", troot), _boot("jax", jroot)
    try:
        _same_reads(_reads(ta.port, tpr), _reads(ja.port, jpr))
        _same_reads(_reads(ta.port, tpr), t_reads)
    finally:
        ta.close()
        ja.close()


ROLLUP = {"namespace": "default", "version": 1, "mapping_rules": [], "rollup_rules": [{
    "name": "req-by-code", "filter": "__name__:http_requests_total",
    "targets": [{"pipeline": [
        {"aggregation": "SUM"},
        {"rollup": {"new_name": "req.by_code", "tags": ["code"], "aggregation": []}},
        {"transformation": "PER_SECOND"}], "policies": ["10s:2d"]}]}]}


def _rollup_files(root) -> dict:
    return {k: v for k, v in _digests(root).items() if "10s:2d" in k}


def test_downsampling_node_rollup_volumes_match(nodes):
    sides = {}
    for side, rj in (("torch", trj), ("jax", jrj)):
        asm, root = nodes("ds", side, extra=", downsample: true",
                          ruleset=rj.ruleset_from_json(ROLLUP))
        sides[side] = (asm, root)
    for k0 in range(0, 30, 10):
        got = [_traffic(sides[s][0].port, k0, k0 + 10,
                        tpr if s == "torch" else jpr) for s in sides]
        assert got[0] == got[1]
    for now in (START + 400 * SEC, START + BLOCK + 11 * 60 * SEC,
                START + 2 * BLOCK + 11 * 60 * SEC):
        stats = [sides[s][0].mediator.run_once(now) for s in sides]
        for s in stats:
            s.pop("duration_s")
        assert stats[0] == stats[1]
    for s in sides:
        sides[s][0].close()
    ft, fj = _rollup_files(sides["torch"][1]), _rollup_files(sides["jax"][1])
    assert ft == fj and any("fileset" in k for k in ft)


def test_checkpointed_node_restores_open_windows(nodes):
    extra = ", downsample: true, checkpoint_every: 1"
    roots, counters = {}, {}
    for side, rj, mod in (("torch", trj, tpr), ("jax", jrj, jpr)):
        rs = rj.ruleset_from_json(ROLLUP)
        asm, root = nodes("ck", side, extra=extra, ruleset=rs)
        roots[side] = root
        _traffic(asm.port, 0, 4, mod)             # a window left open
        saved = asm.mediator.run_once(START + 35 * SEC)
        assert saved["checkpoint"]["bytes"] > 0
        asm.close()                               # a kill after the save
        asm = _boot(side, root, extra=extra, ruleset=rs)
        try:
            assert asm.checkpointer.restores == 1
            _traffic(asm.port, 4, 12, mod)
            for now in (START + 400 * SEC, START + BLOCK + 11 * 60 * SEC):
                asm.mediator.run_once(now)
            counters[side] = _metric_lines(_call(asm.port, "/metrics")[2], COUNTERS)
        finally:
            asm.close()
    assert counters["torch"] == counters["jax"]
    assert counters["torch"]["m3tpu_aggregator_checkpoint_restores"] == 1
    ft, fj = _rollup_files(roots["torch"]), _rollup_files(roots["jax"])
    assert ft == fj and any("fileset" in k for k in ft)


def _carbon_send(port, k0, k1):
    """Carbon plaintext: 12 graphite paths, scrapes k0..k1 every 10 s."""
    rng = np.random.default_rng(k0)
    lines = [f"m3.dc{i % 2}.host{i // 2}.cpu {float(v)!r} {(START + k * 10 * SEC) // SEC}\n"
             for k in range(k0, k1) for i, v in enumerate(rng.normal(50, 10, 12))]
    with socket.create_connection(("127.0.0.1", port)) as s:
        s.sendall("".join(lines).encode())
    return len(lines)


# groupByNode takes the reference's short names ("sum"); graphite-web's
# "sumSeries" spelling answers 400 in both packages
GRAPHITE_TARGETS = ["m3.*.*.cpu", "sumSeries(m3.dc0.*.cpu)",
                    'groupByNode(m3.*.*.cpu, 1, "sum")',
                    'groupByNode(m3.*.*.cpu, 1, "sumSeries")',
                    "movingAverage(m3.dc1.host1*.cpu, 3)"]


def _graphite_reads(port):
    out = [_call(port, "/render?target=" + urllib.parse.quote(t) + GRAPHITE_WINDOW)[::2]
           for t in GRAPHITE_TARGETS]
    out += [_call(port, f"/metrics/find?query={q}")[::2] for q in ("m3.*", "m3.dc0.*")]
    return out


def test_front_doors_node_files_match(nodes, tmp_path):
    """``coordinator.carbon_listen_port``, ``query.listen_port`` and
    ``query.remotes`` on both packages: carbon lines read back through
    /render and /metrics/find byte-equal, federated queries equal, the
    same mediator stats, and after both close every file sha256-equal."""
    roots, answers = {}, {}
    for side, mod in (("torch", tpr), ("jax", jpr)):
        peer, proot = nodes("peer", side, extra="}\nquery: {listen_port: 0")
        st, _, body = _call(peer.port, "/api/v1/json/write", _json_samples(0, 40), "POST")
        assert st == 200
        asm, root = nodes("fd", side, extra=(
            ", carbon_listen_port: 0}\nquery: {listen_port: 0, "
            f"remotes: ['127.0.0.1:{peer.query_port}']"))
        roots[side] = (root, proot)
        assert asm.query_port and asm.carbon_port and len(asm.remote_stores) == 1
        _traffic(asm.port, 0, 40, mod)
        sent = _carbon_send(asm.carbon_port, 0, 40)
        deadline = time.monotonic() + 60
        while True:
            got = json.loads(_call(asm.port, "/render?target=m3.*.*.cpu"
                                   + GRAPHITE_WINDOW.replace("30s", "10s"))[2])
            if sum(v is not None for s in got for v, _ in s["datapoints"]) == sent:
                break
            assert time.monotonic() < deadline, "carbon lines not read back"
            time.sleep(0.05)
        reads = {"graphite": _graphite_reads(asm.port),
                 "fed": [_call(asm.port, q)[::2] for q in QUERIES[:2]]}
        now = START + BLOCK + 11 * 60 * SEC
        stats = [asm.mediator.run_once(now), peer.mediator.run_once(now)]
        for st_ in stats:
            st_.pop("duration_s")
        reads["graphite_flushed"] = _graphite_reads(asm.port)
        reads["stats"] = stats
        asm.close()
        peer.close()
        answers[side] = reads
    t, j = answers["torch"], answers["jax"]
    assert t["graphite"] == j["graphite"] and t["stats"] == j["stats"]
    assert t["graphite_flushed"] == j["graphite_flushed"] == t["graphite"]
    assert [st for st, _ in t["graphite"]] == [200, 200, 200, 400, 200, 200, 200]
    assert len(json.loads(t["graphite"][0][1])) == 12
    for (st_t, bt), (st_j, bj) in zip(t["fed"], j["fed"]):
        assert st_t == st_j == 200
        _same_answer(bt, bj)
    assert t["stats"][0]["tick"]["default"]["warm_flushed"] > 0
    for (rt, pt), (rj, pj) in zip([roots["torch"]], [roots["jax"]]):
        assert _digests(rt) == _digests(rj) and _digests(pt) == _digests(pj)
        assert any("fileset" in k for k in _digests(rt))


def test_node_main_subprocess_boots_and_drains(tmp_path):
    cfg = tmp_path / "node.yaml"
    root = tmp_path / "root"
    cfg.write_text(CONFIG.format(root=root, extra=""))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "m3_tpu_torch.server.node_main", str(cfg),
         "--device", "cpu"], cwd=tmp_path, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        status = root / "node.json"
        deadline = time.monotonic() + 120
        while not status.exists():
            assert proc.poll() is None, proc.stdout.read().decode()
            assert time.monotonic() < deadline, "node.json never appeared"
            time.sleep(0.1)
        info = json.loads(status.read_text())
        assert info["pid"] == proc.pid and info["device"] == "cpu"
        st, _, body = _call(info["port"], "/health")
        assert st == 200 and json.loads(body)["ok"]
        st, _, body = _call(info["port"], "/api/v1/json/write",
                            _json_samples(0, 2), "POST")
        assert st == 200 and json.loads(body)["written"] == 6
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, proc.stdout.read().decode()
        assert not status.exists()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_disk_ledger_node_matches(tmp_path):
    """``disk.enabled``: the mediator's disk stage and the disk gauges on
    /metrics are equal on both nodes after the same writes (their roots
    hold the same bytes)."""
    from m3_tpu.x import diskbudget as jdisk
    from m3_tpu_torch.x import diskbudget as tdisk

    got = {}
    try:
        for side, mod in (("torch", tpr), ("jax", jpr)):
            cfg = (CONFIG.format(root=tmp_path / side, extra="")
                   + "disk: {enabled: true, capacity: 64M, reserve: 1K}\n")
            asm = (tasm.run_node(cfg, device="cpu") if side == "torch"
                   else jasm.run_node(cfg))
            try:
                _traffic(asm.port, 0, 10, mod)
                st = asm.mediator.run_once(START + 300 * SEC)
                st.pop("duration_s")
                gauges = _metric_lines(
                    _call(asm.port, "/metrics")[2],
                    ("disk_level", "disk_total_bytes", "disk_ingest_shed_total"))
                got[side] = (st, gauges)
            finally:
                asm.close()
    finally:  # the ledgers are process-global: leave them disarmed
        jdisk.reset()
        tdisk.reset()
    assert got["torch"] == got["jax"]
    assert got["torch"][0]["disk"]["level"] == "ok" and got["torch"][1]
