"""x/irlint for the port: the IRLINT artifact over the stage registry's
censuses and the chain's residency on the CPU, checked green against the
committed ``irlint_baseline_cpu.json``; its tables against
``costwatch.stage_names()``; each of the five rules flipped by a
regression seeded in the test (an added ``scatter_``, an added int64 or
float64 cast, an added ``.item()`` in a stage, a table moved to a
per-call upload, an array copied across the boundary at a composed
seam); and the check's refusal of a baseline pinned elsewhere.

The artifact is built once for the module (one counted run per stage
and one residency pass at ``CPU_PIPE``, ~40 s on one CPU core).  On the
CPU nothing is a transfer, so the upload and residency regressions use
the ``meta`` device as the card's stand-in, as the hopwatch tests do.
"""

from __future__ import annotations

import copy
import json

import numpy as np
import pytest
import torch

from m3_tpu_torch.x import costwatch as cw
from m3_tpu_torch.x import irlint

BASELINE = irlint.default_baseline_path("cpu")
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def artifact():
    return irlint.build_artifact(device="cpu")


def test_committed_baseline_is_wellformed():
    base = json.loads(BASELINE.read_text())
    assert base["artifact"] == "IRLINT" and base["schema"] == irlint.SCHEMA
    assert base["config"]["platform"] == "cpu" and base["config"]["cuda"] is None
    assert base["config"]["pipe"] == irlint.CPU_PIPE
    assert base["stages"] == list(cw.stage_names())
    assert base["rules"] == list(irlint.RULES)
    assert irlint.default_baseline_path("cuda").name == "irlint_baseline_cuda.json"


def test_check_against_committed_baseline_green(artifact):
    errs = irlint.check_against_baseline(artifact, BASELINE)
    assert errs == [], "\n".join(e["message"] for e in errs)


def test_tables_cover_exactly_the_stage_registry():
    names = set(cw.stage_names())
    assert set(irlint.SCATTER_BUDGETS) == names
    assert set(irlint.WIDTH_CONTRACTS) == names
    assert set(irlint.CARD_WIDTH_DELTAS) <= names
    assert set(irlint.WIDE_FORBIDDEN) == {n for n in names if n.startswith(("decode/", "encode"))}
    assert all(k[0] in names for k in irlint.CONST_WHITELIST)


def test_contracts_hold_the_cpu_census(artifact):
    """Budgets and ceilings are the CPU census's own counts: no scatter or
    ceiling finding today; the codec's float64 results are findings, each
    naming its op; the only syncs are the packed ingests' scalar reads."""
    assert artifact["counts"]["scatter-budget"] == 0
    assert artifact["counts"]["ir-const-bloat"] == 0
    assert artifact["counts"]["residency-composition"] == 0
    width = [f for f in artifact["findings"] if f["rule"] == "width-discipline"]
    assert {f["path"] for f in width} == set(irlint.WIDE_FORBIDDEN)
    assert all("forbidden wide type float64 from aten::" in f["message"] for f in width)
    syncs = {(f["path"], f["message"].split()[2]) for f in artifact["findings"]
             if f["rule"] == "transfer-free"}
    assert syncs == {("arena/rollup_ingest_packed", "aten::_local_scalar_dense"),
                     ("timer/ingest_packed", "aten::_local_scalar_dense")}


@pytest.mark.parametrize("platform", ["cpu", "cuda"])
def test_width_ceilings_are_the_census_exactly(artifact, platform):
    """Each 64-bit ceiling that is not a forbidden type equals the
    platform's census: the live CPU census here, and the card's committed
    one (``costs_baseline_cuda.json``, written on the card) for
    ``cuda``, so one added 64-bit result is a finding on either."""
    if platform == "cpu":
        census = {n: cs.fingerprint["types"] for n, cs in cw.counted_stages(device=CPU).items()}
    else:
        base = json.loads((BASELINE.parent / "costs_baseline_cuda.json").read_text())
        census = {n: fp["types"] for n, fp in base["stages"].items()}
    assert set(census) == set(cw.stage_names())
    for name, types in census.items():
        ceil = irlint.width_contract(name, platform)
        for t in irlint.WIDE_TYPES:
            if t not in irlint.WIDE_FORBIDDEN.get(name, ()):
                assert ceil[t] == types.get(t, 0), (name, t, ceil[t], types.get(t, 0))


def test_residency_on_the_cpu(artifact):
    res = artifact["residency"]
    assert res["chain"] == list(irlint.CHAIN) and res["pipe"] == irlint.CPU_PIPE
    assert [s["seam"] for s in res["seams"]] == [s[0] for s in irlint.SEAMS]
    assert all(s["composed"] and not s["crossings"] for s in res["seams"])
    assert res["ledger_equal"] and res["samples"] == irlint.CPU_PIPE["S"] * irlint.CPU_PIPE["T"]


# ---------------------------------------------------------------------------
# Seeded regressions: each flips its rule
# ---------------------------------------------------------------------------


def _stage(name: str):
    fn, args, dp, _ = {s.name: s for s in cw.STAGES}[name].build(CPU)
    return fn, args, dp


def _flips(name: str, seeded, rule: str, device=CPU, fn_args=None):
    """The stage's program and the seeded one: the rule is silent on the
    first, fires on the second, and the ratchet fails on the difference."""
    fn, args, dp = fn_args or _stage(name)
    good = irlint.program(name, fn, args, dp, device)
    bad = irlint.program(name, seeded(fn), args, dp, device)
    before = [f for f in irlint.analyze_program(good)[0] if f.rule == rule]
    after = [f for f in irlint.analyze_program(bad)[0] if f.rule == rule]
    assert not before and after, (before, after)
    doc = lambda fs: {"schema": irlint.SCHEMA, "config": cw.platform_config(CPU),
                      "stages": [name], "findings": [
                          {"rule": f.rule, "path": f.path, "message": f.message} for f in fs]}
    errs = irlint.check_artifact(doc(irlint.analyze_program(bad)[0]),
                                 doc(irlint.analyze_program(good)[0]))
    assert {e["kind"] for e in errs} == {"new-finding"}
    return after


def test_added_scatter_flips_scatter_budget():
    def seeded(fn):
        def run(*a):
            out = fn(*a)
            torch.zeros(8, dtype=torch.float64).scatter_(
                0, torch.tensor([1, 2], dtype=torch.int64),
                torch.ones(2, dtype=torch.float64))
            return out
        return run

    got = _flips("arena/counter_consume_packed", seeded, "scatter-budget")
    assert "census 1 exceeds the stage budget 0" in got[0].message


@pytest.mark.parametrize("dtype,kind", [(torch.int64, "int64"), (torch.float64, "float64")])
def test_added_wide_cast_flips_width_discipline(dtype, kind):
    def seeded(fn):
        def run(st, idx, slots, vals, times):
            return fn(st, idx, slots.to(dtype).to(slots.dtype), vals, times)
        return run

    got = _flips("arena/counter_ingest_f64", seeded, "width-discipline")
    assert any(f"census {kind}" in f.message for f in got), got


def test_added_float64_in_a_codec_stage_names_its_op():
    """A float64 result in a codec stage is a finding of its own op, on
    top of the committed ones (the program here: the decode's
    sign-extension helper at a small shape)."""
    from m3_tpu_torch.encoding import m3tsz_torch as mt

    v = torch.arange(64, dtype=torch.int64)
    n = torch.full((64,), 7, dtype=torch.int64)

    def seeded(fn):
        return lambda v, n: fn(v, n) + v.to(torch.float64).floor().to(torch.int64)

    got = _flips("decode/gather", seeded, "width-discipline",
                 fn_args=(mt._sign_extend, (v, n), 64))
    assert any("from aten::_to_copy" in f.message for f in got), got


def test_added_item_flips_transfer_free():
    def seeded(fn):
        def run(st):
            out = fn(st)
            out[0].sum().item()
            return out
        return run

    got = _flips("arena/gauge_consume_f64", seeded, "transfer-free")
    assert "aten::_local_scalar_dense x1" in got[0].message


def test_table_moved_to_a_per_call_upload_flips_ir_const_bloat():
    """The decoder's control table made a tensor every call instead of
    handed in: on the card (here the meta device, its stand-in) one
    upload of 1 MiB a call."""
    from m3_tpu_torch.encoding import m3tsz_torch as mt

    meta = torch.device("meta")
    idx = torch.zeros(16, dtype=torch.int64, device=meta)
    table = torch.as_tensor(mt._VALUE_CTRL_TBL.astype(np.int32), device=meta)

    def resident(tbl, i):
        return tbl[i]

    def seeded(fn):
        return lambda tbl, i: fn(torch.as_tensor(mt._VALUE_CTRL_TBL.astype(np.int32),
                                                 device=i.device), i)

    got = _flips("decode/gather", seeded, "ir-const-bloat", device=meta,
                 fn_args=(resident, (table, idx), 16))
    assert f"of {mt._VALUE_CTRL_TBL.size * 4} B" in got[0].message
    # a reviewed whitelist entry turns it into a recorded suppression
    key = ("decode/gather", "torch.as_tensor", mt._VALUE_CTRL_TBL.size * 4)
    bad = irlint.program("decode/gather", seeded(resident), (table, idx), 16, meta)
    found, sups = irlint.rule_ir_const_bloat(bad, whitelist={key: "reviewed"})
    assert not found and sups[0]["reason"] == "reviewed"


_TINY = {"S": 64, "T": 10, "resolution_s": 10}


def test_window_copied_across_the_boundary_at_a_composed_seam_flips_residency(monkeypatch):
    """Every seam is composed in the artifact's pass (above).  The drain
    first copies its arenas' state across the boundary (to
    the meta device, the card's stand-in on the CPU): the arena_ingest ->
    window_drain seam stops being composed, each copy a finding with its
    dtype, shape, bytes, count and the function that made it."""
    from m3_tpu_torch.aggregator import engine

    consume = engine.MetricList.consume

    def pulled(self, target_nanos, *a, **kw):
        for t in self.gauges.state:
            if isinstance(t, torch.Tensor) and t.dim():
                t.to("meta")
        return consume(self, target_nanos, *a, **kw)

    monkeypatch.setattr(engine.MetricList, "consume", pulled)
    bad, rec = irlint.residency_report("cpu", _TINY)
    seam = rec["seams"][0]
    assert not seam["composed"] and rec["ledger_equal"]
    assert bad and all(f.path == "seam:arena_ingest->window_drain" for f in bad)
    assert all("h2d window_drain.aten::_to_copy" in f.message for f in bad)
    assert all(f.message.endswith("via test_torch_irlint.py:pulled") for f in bad)
    assert sum(c["transfers"] for c in seam["crossings"]) == seam["transfers"] > 0


# ---------------------------------------------------------------------------
# The check's refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key,value,kind", [
    ("platform", "cuda", "platform"),
    ("device_name", "NVIDIA H100 80GB HBM3", "device"),
    ("torch", "0.0.0", "torch-version"),
    ("cuda", "12.8", "cuda-version"),
    ("pipe", dict(irlint.PIPE), "config"),
    ("canonical", {"S": 1}, "config"),
])
def test_check_refuses_a_baseline_pinned_elsewhere(artifact, key, value, kind):
    base = copy.deepcopy(artifact)
    base["config"][key] = value
    errs = irlint.check_artifact(artifact, base)
    assert [e["kind"] for e in errs] == [kind], errs


def test_check_refuses_another_schema_or_stage_set(artifact):
    base = copy.deepcopy(artifact)
    base["schema"] = irlint.SCHEMA + 1
    assert [e["kind"] for e in irlint.check_artifact(artifact, base)] == ["schema"]
    base = copy.deepcopy(artifact)
    base["stages"] = base["stages"][1:]
    assert [e["kind"] for e in irlint.check_artifact(artifact, base)] == ["stages"]


def test_a_fixed_finding_fails_as_stale_until_rebaselined(artifact):
    cur = copy.deepcopy(artifact)
    gone = cur["findings"].pop(0)
    errs = irlint.check_artifact(cur, artifact)
    assert [e["kind"] for e in errs] == ["stale-baseline"] and errs[0]["rule"] == gone["rule"]


@pytest.mark.parametrize("rule", irlint.RULES)
def test_every_rule_has_an_explanation(rule):
    entry = irlint.EXPLAIN[rule]
    assert all(entry[k] for k in ("why", "bad", "good"))
