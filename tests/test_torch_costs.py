"""tools/costs: the port's COSTS artifact over the whole registry on the
CPU, checked green against the committed ``costs_baseline_cpu.json``
(the tier-1 gate), its cross-checks, and the seeded regressions that
must flip the check: an added int64 cast in a stage and the decoder's
control table moved from an argument into a per-call upload.

The artifact is built once per module (one counted run per stage, ~35 s
on one CPU core); the ratchet gates counts exactly and bytes within the
reference's 5 %; the membudget contract is "formula >= actual and <= 2x
actual"; the census's step counts stay within 10 % of the documented
ones, as the reference's do."""

from __future__ import annotations

import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from m3_tpu_torch.encoding import m3tsz_torch as mt
from m3_tpu_torch.tools import costs
from m3_tpu_torch.x import costwatch as cw

BASELINE = costs.default_baseline_path("cpu")


@pytest.fixture(scope="module")
def artifact():
    return costs.build_artifact(device="cpu")


def test_committed_baseline_is_wellformed():
    art = json.loads(BASELINE.read_text())
    assert art["artifact"] == "COSTS" and art["schema"] == costs.SCHEMA
    assert art["config"]["platform"] == "cpu" and art["config"]["cuda"] is None
    assert set(art["stages"]) == set(cw.stage_names())
    for key in ("decode", "encode"):
        assert art["opsdp_crosscheck"][key]["documented_ops_per_dp"] == \
            cw.DOCUMENTED_OPS_PER_DP[f"{key}_step"]
    assert costs.default_baseline_path("cuda").name == "costs_baseline_cuda.json"


def test_check_against_committed_baseline_green(artifact):
    errs = costs.check_against_baseline(artifact, BASELINE)
    assert errs == [], "\n".join(e["message"] for e in errs)


def test_every_stage_fingerprinted(artifact):
    stages = artifact["stages"]
    assert list(stages) == list(cw.stage_names())
    for name, fp in stages.items():
        assert fp["datapoints"] > 0 and fp["dispatches"] > 0, name
        assert sum(fp["ops"].values()) == fp["dispatches"], name
        assert fp["memory"]["argument_bytes"] > 0, name
        assert fp["memory"]["peak_bytes"] is None, name  # not measured on the CPU
        assert fp["transfers"]["uploads"] == fp["transfers"]["downloads"] == 0, name
        assert fp["config"], name
        # one counted run, no timed loop
        assert not {"wall_s", "dps", "seconds"} & set(fp), name
    for name in ("decode/sharded", "encode/sharded"):
        assert stages[name]["config"]["devices"] == 2


def test_no_stage_launches_a_kernel_on_the_cpu(artifact):
    assert costs.stage_kernel_violations(artifact) == []
    assert all(not fp["kernels"] for fp in artifact["stages"].values())


def test_sharded_stages_run_each_shard_through_the_one_device_program(artifact):
    st = artifact["stages"]
    # phase 1 runs once a shard: the sharded pass has twice the steps
    for one, two in (("encode", "encode/sharded"), ("decode/gather", "decode/sharded")):
        assert 1.9 < st[two]["dispatches"] / st[one]["dispatches"] < 2.1


def test_census_step_counts_track_the_documented_ones(artifact):
    cc = artifact["opsdp_crosscheck"]
    for key in ("decode", "encode"):
        assert 0.9 <= cc[key]["census_vs_documented"] <= 1.1, cc[key]
        # phase 1 is the pass: the stage's dispatches are T steps' and a few
        assert 1.0 <= cc[key]["stage_vs_step"] <= 1.1, cc[key]
    assert "explanation" in cc


def test_membudget_formulas_within_contract(artifact):
    mb = artifact["membudget_crosscheck"]
    assert len(mb["arena"]) == 6 and len(mb["codec"]) == 3
    for name, rec in {**mb["arena"], **mb["codec"]}.items():
        assert 1.0 <= rec["ratio"] <= 2.0, (name, rec)
        assert rec["actual"], name
    assert mb["arena"]["counter/f64"]["actual"] == "state tensors' nbytes"
    assert mb["codec"]["encode"]["actual"].startswith("counted argument + output")


def test_a_second_build_agrees(artifact):
    cw.clear_stage_cache()
    again = costs.build_artifact(["arena/gauge_ingest_f64", "timer/consume_packed"],
                                 device="cpu")
    for name, fp in again["stages"].items():
        assert fp == artifact["stages"][name], name


# ---------------------------------------------------------------------------
# Seeded regressions: each must flip the check to FAIL
# ---------------------------------------------------------------------------

_S, _T = 8, 16


def _seed_artifact(name: str, fp: dict, cfg: dict) -> dict:
    return {"artifact": "COSTS", "schema": costs.SCHEMA,
            "config": cw.platform_config("cpu"), "stages": {name: dict(fp, config=cfg)}}


def _encode_fp():
    ts, vals, starts = cw.bench_corpus(_S, _T)
    args = (torch.from_numpy(ts), torch.from_numpy(vals.view(np.int64)),
            torch.from_numpy(starts), torch.ones((_S, _T), dtype=torch.bool))
    fn = lambda *a: mt._encode_batch_device(*a, out_words=_T * 16 // 64 + 4, device="cpu")
    return cw.fingerprint_call(fn, args, _S * _T, "cpu")


def test_int64_cast_flips_check_to_fail(monkeypatch):
    """One more int64 cast in the encode (the lanes' int32 widths cast
    before the fragments are cut): the exact counts move and the gate
    FAILS on the fingerprint alone."""
    cfg = {"S": _S, "T": _T}
    baseline = _seed_artifact("encode/seeded", _encode_fp(), cfg)
    frags = mt._lane_frags
    monkeypatch.setattr(mt, "_lane_frags",
                        lambda v, pos, n: frags(v, pos, n.to(torch.int64)))
    seeded = _seed_artifact("encode/seeded", _encode_fp(), cfg)
    errs = costs.check_artifact(seeded, baseline)
    assert {e["kind"] for e in errs} == {"regression"}, errs
    assert {"dispatches", "ops.copy", "width64"} <= {e["metric"] for e in errs}, errs
    monkeypatch.undo()
    again = _seed_artifact("encode/seeded", _encode_fp(), cfg)
    assert costs.check_artifact(again, baseline) == []


def test_ctrl_table_as_per_call_upload_flips_check_to_fail(monkeypatch):
    """The decoder's value-control table re-made every call instead of
    handed in resident: its 1 MiB leaves the arguments and the gate
    FAILS (on the card it is also one upload a call)."""
    ts, vals, starts = cw.bench_corpus(_S, _T)
    streams, _ = mt.encode_batch(ts, vals, starts, device="cpu")
    words, nbits = mt.pack_streams(streams)
    w, n = torch.from_numpy(words.view(np.int64)), torch.from_numpy(nbits)
    dec = lambda w, n, tbl=None: mt._decode_batch_device(w, n, _T + 1, device="cpu",
                                                         chains="gather", ctrl_tbl=tbl)
    cfg = {"S": _S, "T": _T}
    good = cw.fingerprint_call(dec, (w, n, mt.value_ctrl_table(torch.device("cpu"))),
                               _S * _T, "cpu")
    monkeypatch.setattr(mt, "value_ctrl_table", lambda dev: torch.as_tensor(
        mt._VALUE_CTRL_TBL.astype(np.int32), device=dev))
    bad = cw.fingerprint_call(dec, (w, n), _S * _T, "cpu")
    assert good["memory"]["argument_bytes"] > 1 << 20 > bad["memory"]["argument_bytes"]
    errs = costs.check_artifact(_seed_artifact("decode/seeded", bad, cfg),
                                _seed_artifact("decode/seeded", good, cfg))
    assert any(e["metric"] == "memory.argument_bytes" for e in errs), errs


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------


def _run(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = costs.main(argv)
    return rc, [ln for ln in buf.getvalue().splitlines() if ln.strip()]


def test_cli_subset_json():
    rc, lines = _run(["--device", "cpu", "--stage", "arena/counter_consume_f64", "--json"])
    assert rc == 0
    rep = json.loads(lines[-1])
    assert rep["ok"] is True and rep["stages"] == 1


def test_cli_check_subset_reports_vanished_stages():
    rc, lines = _run(["--device", "cpu", "--stage", "arena/counter_consume_f64",
                      "--check", str(BASELINE), "--json"])
    assert rc == 1
    rep = json.loads(lines[-1])
    assert rep["ok"] is False
    assert {v["kind"] for v in rep["violations"]} == {"stage-vanished"}


def test_cli_missing_baseline_fails_fast():
    assert _run(["--device", "cpu", "--check", "/no/such/file.json"])[0] == 2


def test_cli_out_writes_artifact(tmp_path):
    out = tmp_path / "costs.json"
    rc, _ = _run(["--device", "cpu", "--stage", "arena/gauge_consume_f64", "--out", str(out)])
    assert rc == 0
    art = json.loads(out.read_text())
    assert art["artifact"] == "COSTS" and set(art["stages"]) == {"arena/gauge_consume_f64"}
