"""m3_tpu_torch's self-monitoring (instrument/exposition, query/slo,
instrument/selfmon, instrument/debug) against the JAX package's on the
CPU.

* Exposition: one registry content in both packages renders to the same
  bytes, which both strict parsers read to the same samples; malformed
  texts raise the same messages; the fleet merge helpers agree.
* SLO burns: the same latency-histogram history written into each
  package's ``Database`` (through each package's ``samples_to_writes``)
  gives the same verdict documents from ``SLOEvaluator.evaluate`` for
  the default rules and short-window rules, through the port's engine
  (ratios rounded to 9 digits by both: compared exactly).
* Selfmon rows: ``SelfMonitor.tick`` over the same registry content
  writes the same series, timestamps and values, with the same stats;
  a peer scrape through a fake fetch lands under its instance tag.
"""

import io
import math
import zipfile

import numpy as np
import pytest

from m3_tpu import instrument as jinst
from m3_tpu.instrument import debug as jdebug
from m3_tpu.instrument import exposition as jexp
from m3_tpu.instrument import selfmon as jsm
from m3_tpu.query import slo as jslo
from m3_tpu.query.engine import Engine as JEngine
from m3_tpu.query.storage_adapter import DatabaseStorage as JStorage
from m3_tpu.storage import database as jdb
from m3_tpu_torch import instrument as tinst
from m3_tpu_torch.instrument import debug as tdebug
from m3_tpu_torch.instrument import exposition as texp
from m3_tpu_torch.instrument import selfmon as tsm
from m3_tpu_torch.query import slo as tslo
from m3_tpu_torch.query.engine import Engine as TEngine
from m3_tpu_torch.query.storage_adapter import DatabaseStorage as TStorage
from m3_tpu_torch.storage import database as tdb

SEC = 10**9
T0 = 1_700_000_000 * SEC
NS = "_m3_selfmon"


def _fill(reg, seed: int = 0):
    """The same instruments and values in a registry of either package."""
    rng = np.random.default_rng(seed)
    scope = reg.scope("m3tpu")
    scope.counter("db_writes").inc(12345)
    scope.tagged({"shard": "3", "path": 'a"b\\c'}).counter("errors").inc(2)
    scope.gauge("query_active").update(3.5)
    scope.gauge("nan_gauge").update(float("nan"))
    scope.scope("selfmon").counter("cycles").inc(9)
    h = scope.scope("query").histogram("seconds")
    for v in rng.exponential(0.4, 200):
        h.record(float(v))
    scope.tagged({"phase": "fetch"}).scope("query").histogram(
        "phase_seconds").record(0.003)
    return reg


def test_exposition_bytes_and_parse_equal():
    tt = _fill(tinst.new_registry()).render_prometheus()
    jt = _fill(jinst.new_registry()).render_prometheus()
    assert tt.encode() == jt.encode()
    ts, js = texp.parse_text(tt), jexp.parse_text(jt)
    assert [(s.name, s.labels, s.timestamp_ms) for s in ts] == \
        [(s.name, s.labels, s.timestamp_ms) for s in js]
    assert all((a.value == b.value) or (math.isnan(a.value) and math.isnan(b.value))
               for a, b in zip(ts, js))
    base = "m3tpu_query_seconds"
    mt, mj = texp.merge_histograms([ts, ts], base), jexp.merge_histograms([js, js], base)
    assert mt == mj
    assert texp.merged_quantile(mt, 0.99) == jexp.merged_quantile(mj, 0.99)
    assert texp.fleet_summary({"a": ts, "b": None}, base) == \
        jexp.fleet_summary({"a": js, "b": None}, base)


BAD_TEXTS = [
    "m 1\nm 2\n",
    "m{a=\"1\"} x\n",
    "h_bucket{le=\"1\"} 2\nh_bucket{le=\"+Inf\"} 1\nh_count 1\n",
    "h_bucket{le=\"1\"} 1\nh_count 1\n",
    "m{a=1} 1\n",
    "9m 1\n",
    "m 1 2 3\n",
]


@pytest.mark.parametrize("text", BAD_TEXTS)
def test_parse_errors_equal(text):
    with pytest.raises(ValueError) as te:
        texp.parse_text(text)
    with pytest.raises(ValueError) as je:
        jexp.parse_text(text)
    assert str(te.value) == str(je.value)


def _history_text(k: int, slow_every: int) -> str:
    """Scrape k of a query-latency histogram: 10 queries a scrape, one in
    ``slow_every`` slower than 1 s; cumulative lanes; a Prometheus
    timestamp on every line."""
    n = 10 * (k + 1)
    slow = sum(1 for i in range(n) if slow_every and i % slow_every == 0)
    t_ms = (T0 + k * 10 * SEC) // 10**6
    lines = []
    for le, c in (("0.25", n - slow - k), ("1.0", n - slow), ("+Inf", n)):
        lines.append(f'm3tpu_query_seconds_bucket{{le="{le}"}} {c} {t_ms}')
    lines.append(f"m3tpu_query_seconds_count {n} {t_ms}")
    lines.append(f"m3tpu_db_write_batch_seconds_count {n} {t_ms}")
    lines.append(f'm3tpu_db_write_batch_seconds_bucket{{le="0.25"}} {n} {t_ms}')
    lines.append(f'm3tpu_db_write_batch_seconds_bucket{{le="+Inf"}} {n} {t_ms}')
    return "\n".join(lines) + "\n"


RULES = [{"name": "fast-query", "objective": 0.9,
          "ratio": jslo.latency_ratio("m3tpu_query_seconds", "1.0"),
          "windows": [{"long": "5m", "short": "1m", "factor": 1.0}]},
         {"name": "broken", "objective": 0.5, "ratio": "no_such_fn({window})"}]


def _slo_run(pkg, tmp, slow_every: int, scrapes: int):
    db_mod, exp, sm, slo, Engine, Storage = pkg
    kw = {"device": "cpu"} if db_mod is tdb else {}
    db = db_mod.Database(db_mod.DatabaseOptions(root=str(tmp), commitlog_enabled=False),
                         namespaces={NS: db_mod.NamespaceOptions(num_shards=2)}, **kw)
    db.bootstrap()
    for k in range(scrapes):
        docs, ts, vals, _ = sm.samples_to_writes(
            exp.parse_text(_history_text(k, slow_every)), "n0", 0)
        db.write_tagged_batch(NS, docs, np.asarray(ts, np.int64),
                              np.asarray(vals, np.float64),
                              now_nanos=T0 + k * 10 * SEC)
    eng_kw = {"device": "cpu"} if Engine is TEngine else {}
    rules = slo.default_rules("m3tpu") + [slo.rule_from_dict(r) for r in RULES]
    ev = slo.SLOEvaluator(Engine(Storage(db, NS), **eng_kw), rules, deadline_s=60)
    out = ev.evaluate(T0 + (scrapes - 1) * 10 * SEC)
    status = ev.status()
    db.close()
    for doc in (out, status):
        doc.pop("evaluated_unix")
        doc.pop("elapsed_s")
    return out, status, ev.rules()


@pytest.mark.parametrize("slow_every", [0, 3, 1])
def test_slo_burns_equal(tmp_path, slow_every):
    port = _slo_run((tdb, texp, tsm, tslo, TEngine, TStorage), tmp_path / "t",
                    slow_every, 40)
    ref = _slo_run((jdb, jexp, jsm, jslo, JEngine, JStorage), tmp_path / "j",
                   slow_every, 40)
    assert port == ref
    rules = port[0]["rules"]
    assert rules["broken"]["burn"] is None and "error" in rules["broken"]
    if slow_every == 1:
        assert "fast-query" in port[0]["firing"]
    if slow_every == 0:
        assert port[0]["firing"] == []


class _Fetch:
    def __init__(self, texts):
        self.texts = texts

    def __call__(self, url, timeout_s):
        if url not in self.texts:
            raise OSError("connection refused")
        return self.texts[url]


def _selfmon_run(pkg, inst, tmp):
    db_mod, sm = pkg
    kw = {"device": "cpu"} if db_mod is tdb else {}
    db = db_mod.Database(db_mod.DatabaseOptions(root=str(tmp), commitlog_enabled=False),
                         namespaces={NS: db_mod.NamespaceOptions(num_shards=2)}, **kw)
    db.bootstrap()
    reg = _fill(inst.new_registry())
    peer = "127.0.0.1:9"
    fetch = _Fetch({f"http://{peer}/metrics": _history_text(2, 3)})
    mon = sm.SelfMonitor(db, reg, instance="n0", budget=12,
                         peers=[f"p1={peer}", "p2=127.0.0.1:10"], http_fetch=fetch)
    stats = [mon.tick(T0), mon.tick(T0 + 10 * SEC)]
    ids = sorted(d.id for d in db.query_ids(NS, _all(db_mod), 0, T0 + 60 * SEC))
    # values as their bits: the NaN gauge compares equal to itself
    rows = {i: [(t, int(np.float64(v).view(np.int64)))
                for t, v in db.read(NS, i, 0, T0 + 60 * SEC)] for i in ids}
    status = mon.status()
    db.close()
    return stats, rows, status


def _all(db_mod):
    if db_mod is tdb:
        from m3_tpu_torch.index.search import All
    else:
        from m3_tpu.index.search import All
    return All()


def test_selfmon_rows_equal(tmp_path):
    port = _selfmon_run((tdb, tsm), tinst, tmp_path / "t")
    ref = _selfmon_run((jdb, jsm), jinst, tmp_path / "j")
    assert port == ref
    stats, rows, _ = port
    assert stats[0]["budget_dropped"] > 0 and stats[0]["excluded"] == 1
    assert stats[0]["peers_ok"] == 1 and stats[0]["peers_failed"] == 1
    assert any(b"instance=p1" in i for i in rows)
    assert not any(b"selfmon" in i for i in rows)


def test_parse_peer_equal():
    for entry in ("h:1", "a=h:80", " b=10.0.0.1:9100 "):
        p, j = tsm.parse_peer(entry), jsm.parse_peer(entry)
        assert (p.instance, p.addr, p.url) == (j.instance, j.addr, j.url)
    for bad in ("h", "a=h:0", "=h:1", "h:99999"):
        with pytest.raises(ValueError) as te:
            tsm.parse_peer(bad)
        with pytest.raises(ValueError) as je:
            jsm.parse_peer(bad)
        assert str(te.value) == str(je.value)


def test_debug_bundle_members_equal():
    names = []
    for dbg, inst in ((tdebug, tinst), (jdebug, jinst)):
        data = dbg.debug_bundle(_fill(inst.new_registry()), cpu_seconds=0.05)
        z = zipfile.ZipFile(io.BytesIO(data))
        names.append(z.namelist())
        assert b"m3tpu" in z.read("host.json")
    assert names[0] == names[1]
