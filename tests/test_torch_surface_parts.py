"""The public parts of ported modules the port lacked until the public
surface was checked name by name, each held against the JAX package on
the same inputs: ``x/fault.arm_many`` and ``points``,
``instrument/debug.TriggeringProfiler`` with the storage mediator's
``profiler`` hook, ``instrument/selfmon.measure_overhead`` (on the CPU),
``metrics/policy``'s ``Policy``, ``PipelineMetadata``, ``Metadata``,
``StagedMetadata`` and ``DEFAULT_STAGED_METADATA``, and
``metrics/types``' ``Metric`` and ``ChunkedID``."""

from __future__ import annotations

import dataclasses
import io
import zipfile

import pytest

import m3_tpu.instrument.debug as jdebug
import m3_tpu.instrument.selfmon as jselfmon
import m3_tpu.metrics.policy as jpolicy
import m3_tpu.metrics.types as jtypes
import m3_tpu.x.fault as jfault
import m3_tpu_torch.instrument.debug as tdebug
import m3_tpu_torch.instrument.selfmon as tselfmon
import m3_tpu_torch.metrics.policy as tpolicy
import m3_tpu_torch.metrics.types as ttypes
import m3_tpu_torch.x.fault as tfault

BLOCK = 2 * 3600 * 10**9
START = (1_700_000_000 * 10**9) // BLOCK * BLOCK
PACKAGES = {"jax": (jfault, jdebug, jselfmon, jpolicy, jtypes),
            "port": (tfault, tdebug, tselfmon, tpolicy, ttypes)}


@pytest.fixture()
def faults():
    """Both packages' fault registries, empty before and after."""
    for f in (jfault, tfault):
        f.disarm()
        f.reset_counters()
    yield jfault, tfault
    for f in (jfault, tfault):
        f.disarm()
        f.reset_counters()


# -- x/fault -----------------------------------------------------------------

@pytest.mark.parametrize("raw", [
    "a.b=drop:p=0.25;a.b=delay:ms=7:seed=3",
    "z.q=error:n=2;c.d=corrupt:after=1;a.b=drop",
    "",
])
def test_arm_many_arms_as_the_reference(faults, raw):
    counts = [f.arm_many(raw) for f in faults]
    assert counts[0] == counts[1] == len([e for e in raw.split(";") if e])
    assert faults[0].snapshot() == faults[1].snapshot()
    assert faults[0].points() == faults[1].points()


@pytest.mark.parametrize("raw", ["a.b=drop;c.d=notamode", "a.b=drop;c.d",
                                 "a.b=drop:p=0.5;c.d=delay:bogus=1"])
def test_arm_many_is_all_or_nothing(faults, raw):
    messages = []
    for f in faults:
        with pytest.raises(ValueError) as exc:
            f.arm_many(raw)
        messages.append(str(exc.value))
        assert f.snapshot() == [] and f.points() == []
    assert messages[0] == messages[1]


def test_points_sorted_and_forgotten_on_disarm(faults):
    for f in faults:
        f.arm("c.d", "drop")
        f.arm("a.b", "delay", delay_ms=1)
        with f.armed("p.ctx", "error"):
            assert f.points() == ["a.b", "c.d", "p.ctx"]
        assert f.points() == ["a.b", "c.d"]
        f.disarm("c.d")
        assert f.points() == ["a.b"]
    assert faults[0].points() == faults[1].points()


# -- instrument/debug.TriggeringProfiler and the mediator's hook ------------

def _capture_log(debug, tmp_path):
    clock = [0.0]
    prof = debug.TriggeringProfiler(
        str(tmp_path), lambda d: d > 1.0, min_interval_s=60,
        max_captures=2, cpu_seconds=0.05, now=lambda: clock[0])
    log = [prof.observe(0.5), prof.observe(5.0), prof.observe(5.0)]
    clock[0] += 61
    log.append(prof.observe(5.0))
    clock[0] += 61
    log.append(prof.observe(5.0))
    return prof, log


def test_profiler_rate_limit_and_cap_as_the_reference(tmp_path):
    got = {}
    for name, (_, debug, *_rest) in PACKAGES.items():
        prof, log = _capture_log(debug, tmp_path / name)
        members = [sorted(zipfile.ZipFile(p).namelist()) if p else None for p in log]
        got[name] = ([p.name if p else None for p in log], members, prof.captures)
    assert got["port"] == got["jax"]
    assert got["port"][0] == [None, "triggered-001.zip", None, "triggered-002.zip", None]


@pytest.mark.parametrize("predicate", [lambda d: 1 / 0, lambda d: d.nope])
def test_broken_predicate_never_raises(tmp_path, predicate):
    for _, debug, *_rest in PACKAGES.values():
        prof = debug.TriggeringProfiler(str(tmp_path), predicate)
        assert prof.observe(1.0) is None
        assert prof.captures == 0


def test_unwritable_directory_never_raises(tmp_path):
    (tmp_path / "file").write_bytes(b"")
    for _, debug, *_rest in PACKAGES.values():
        prof = debug.TriggeringProfiler(str(tmp_path / "file" / "sub"),
                                        lambda d: True, cpu_seconds=0.05)
        assert prof.observe(1.0) is None


def test_mediator_slow_tick_captures_the_same_bundle(tmp_path):
    import m3_tpu.storage.database as jdb
    import m3_tpu.storage.mediator as jmed
    import m3_tpu_torch.storage.database as tdb
    import m3_tpu_torch.storage.mediator as tmed

    ns = dict(num_shards=1, slot_capacity=64, sample_capacity=256)
    members = {}
    for name, db_mod, med_mod, debug, kw in (
            ("jax", jdb, jmed, jdebug, {}), ("port", tdb, tmed, tdebug, {"device": "cpu"})):
        db = db_mod.Database(
            db_mod.DatabaseOptions(root=str(tmp_path / name / "db"), commitlog_enabled=False),
            {"default": db_mod.NamespaceOptions(**ns)}, **kw)
        med = med_mod.Mediator(db, clock=lambda: START + 1)
        assert med.profiler is None
        assert "profile" not in med.run_once()
        med.profiler = debug.TriggeringProfiler(
            str(tmp_path / name / "prof"), lambda d: d >= 0.0, cpu_seconds=0.05)
        stats = med.run_once()
        assert stats["profile"] is not None and stats["profile"].exists()
        assert "duration_s" in stats
        z = zipfile.ZipFile(io.BytesIO(stats["profile"].read_bytes()))
        members[name] = (stats["profile"].name, sorted(z.namelist()))
        db.close()
    assert members["port"] == members["jax"]
    assert members["port"][1] == ["cpu.txt", "heap.txt", "host.json", "threads.txt"]


# -- instrument/selfmon.measure_overhead -------------------------------------

def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


def test_measure_overhead_has_the_reference_keys(tmp_path):
    """The reference test's tiny shape (``tests/test_selfmon.py``), both
    packages; the port's databases on the CPU."""
    shape = dict(duration_s=0.4, batch=500, series=1000, cadence_s=0.2,
                 with_rules=False)
    ref = jselfmon.measure_overhead(root=str(tmp_path), **shape)
    out = tselfmon.measure_overhead(root=str(tmp_path), device="cpu", **shape)
    assert _keys(out) == _keys(ref)
    for k in ("duration_s", "batch", "series", "cadence_s", "with_rules", "bound_pct"):
        assert out[k] == ref[k]
    assert out["base"]["samples_per_s"] > 0
    assert out["selfmon"]["samples_per_s"] > 0
    assert out["selfmon"]["scrape_cycles"] >= 1
    assert isinstance(out["overhead_pct"], float)
    assert out["ok"] == (out["overhead_pct"] < 5.0)
    assert list(tmp_path.iterdir()) == []  # each run removes its databases


# -- metrics/policy and metrics/types ----------------------------------------

def _plain(v):
    """A value with every dataclass in it turned into a tuple, so that the
    two packages' (distinct) classes compare by their fields."""
    if dataclasses.is_dataclass(v):
        return dataclasses.astuple(v)
    if isinstance(v, tuple):
        return tuple(_plain(x) for x in v)
    return v


def test_default_staged_metadata_equals_the_reference():
    assert (dataclasses.astuple(tpolicy.DEFAULT_STAGED_METADATA)
            == dataclasses.astuple(jpolicy.DEFAULT_STAGED_METADATA))
    assert tpolicy.DEFAULT_STAGED_METADATA == tpolicy.StagedMetadata()
    md = tpolicy.DEFAULT_STAGED_METADATA.metadata.pipelines[0]
    assert [str(p) for p in md.storage_policies] == ["10s:2d", "1m:40d"]
    assert [str(p) for p in tpolicy.DEFAULT_STORAGE_POLICIES] == ["10s:2d", "1m:40d"]


@pytest.mark.parametrize("cls", ["Policy", "PipelineMetadata", "Metadata", "StagedMetadata"])
def test_policy_classes_equal_the_reference(cls):
    ours, ref = getattr(tpolicy, cls), getattr(jpolicy, cls)
    fields = [(f.name, f.default if f.default is not dataclasses.MISSING else None)
              for f in dataclasses.fields(ours)]
    ref_fields = [(f.name, f.default if f.default is not dataclasses.MISSING else None)
                  for f in dataclasses.fields(ref)]
    assert [n for n, _ in fields] == [n for n, _ in ref_fields]
    assert [_plain(d) for _, d in fields] == [_plain(d) for _, d in ref_fields]
    assert ours.__dataclass_params__.frozen and ref.__dataclass_params__.frozen


def test_policy_values_behave_as_the_reference():
    made = {}
    for name, (*_, policy, _types) in PACKAGES.items():
        sp = policy.StoragePolicy.parse("1m@1s:40d")
        p = policy.Policy(sp)
        pm = policy.PipelineMetadata(storage_policies=(sp,), drop_policy=1)
        sm = policy.StagedMetadata(policy.Metadata((pm,)), cutover_nanos=7, tombstoned=True)
        with pytest.raises(dataclasses.FrozenInstanceError):
            sm.cutover_nanos = 8
        assert sm == policy.StagedMetadata(policy.Metadata((pm,)), 7, True)
        assert hash(sm) == hash(policy.StagedMetadata(policy.Metadata((pm,)), 7, True))
        made[name] = [dataclasses.astuple(v) for v in (p, pm, sm)]
        made[name].append(int(p.aggregation_id))
    assert made["port"] == made["jax"]


@pytest.mark.parametrize("mtype,value,values", [
    ("TIMER", 3.0, ()), ("TIMER", 0.0, (1.0, 2.5)), ("COUNTER", 4.0, ()),
    ("GAUGE", 1.5, (9.0,)), ("UNKNOWN", 0.0, ())])
def test_metric_timer_values_equal_the_reference(mtype, value, values):
    got = [types.Metric(b"id", types.MetricType[mtype], value, values).timer_values
           for *_, types in PACKAGES.values()]
    assert got[0] == got[1]
    m = ttypes.Metric(b"id", ttypes.MetricType[mtype], value, values, 5, b"a")
    assert (m.time_nanos, m.annotation) == (5, b"a")


def test_chunked_id_equals_the_reference():
    got = [types.ChunkedID(b"pre.", b"data", b".suf") for *_, types in PACKAGES.values()]
    assert got[0].bytes() == got[1].bytes() == b"pre.data.suf"
    assert dataclasses.astuple(got[0]) == dataclasses.astuple(got[1])
    with pytest.raises(dataclasses.FrozenInstanceError):
        got[1].data = b"x"
