"""The port's ops CLI (``m3_tpu_torch/tools/cli.py``) against the JAX
package's (``m3_tpu/tools/cli.py``).

Every file tool prints the same JSON lines as the JAX CLI over one store
root the port wrote (the port's files are sha256-equal to the JAX
package's, ``tests/test_torch_database.py``), ``scrub`` and
``verify_data_files`` over a corrupted volume too.  The parser has the
reference's subcommands and options, less ``tpu_backlog`` and plus
``--device``.  The gates run green on the CPU: ``lint --json`` (and
``--explain``), ``costs --check`` and ``irlint --check`` against their
CPU baselines, and ``hops --check`` against
``m3_tpu_torch/tools/hops_baseline_cpu.json``; the reference's
``check_against_baseline`` cases (``tests/test_observability.py``) give
the same violations through both packages' functions."""

import argparse
import hashlib
import json
import pathlib
import shutil

import numpy as np
import pytest

import m3_tpu.tools.cli as jcli
import m3_tpu.tools.hops as jhops
import m3_tpu_torch.tools.cli as tcli
import m3_tpu_torch.tools.hops as thops

BLOCK = 2 * 3600 * 10**9
START = (1_700_000_000 * 10**9) // BLOCK * BLOCK
SEC = 10**9
MIN = 60 * SEC


def _write_root(root: pathlib.Path) -> None:
    """A port node's root: tagged and untagged series flushed into one
    block's filesets and index segment, and a few writes of the next
    block left in the commit log."""
    import m3_tpu_torch.index.doc as tdoc
    import m3_tpu_torch.storage.database as tdb

    ns = tdb.NamespaceOptions(
        block_size_nanos=BLOCK, retention_nanos=48 * 3600 * SEC,
        buffer_past_nanos=10 * MIN, buffer_future_nanos=2 * MIN, num_shards=2,
        slot_capacity=1 << 10, sample_capacity=1 << 6)
    db = tdb.Database(tdb.DatabaseOptions(root=str(root)), {"default": ns}, device="cpu")
    docs = [tdoc.Document.from_tags(b"reqs{i%d}" % g, {
        b"__name__": b"reqs", b"job": b"api", b"instance": b"i%d" % g}) for g in range(4)]
    rng = np.random.default_rng(0)
    for k in range(20):
        t = START + MIN + k * 15 * SEC
        db.write_tagged_batch("default", docs, np.full(len(docs), t, np.int64),
                              np.round(rng.normal(50, 5, len(docs)), 2))
    ids = [b"host%03d.cpu" % i for i in range(10)]
    for k in range(30):
        db.write_batch("default", ids, np.full(len(ids), START + k * 10 * SEC + 7 * SEC,
                                               np.int64),
                       np.round(rng.normal(10, 1, len(ids)), 2))
    db.tick(START + BLOCK + 11 * MIN)
    db.write_batch("default", ids[:3], np.full(3, START + BLOCK + 11 * MIN, np.int64),
                   np.array([1.0, 2.0, 3.0]))
    db.close()


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("store") / "root"
    _write_root(root)
    assert list(root.glob("data/default/*/fileset-*-data.db"))
    assert list(root.glob("index/default/segment-*.db"))
    assert list(root.glob("commitlogs/commitlog-*.db"))
    return root


def _run(cli, argv, capsys):
    capsys.readouterr()
    rc = cli.main(argv)
    out = capsys.readouterr().out
    return rc, [json.loads(line) for line in out.splitlines() if line.strip()]


def _both(argv_j, argv_t, capsys, root_j=None, root_t=None):
    j = _run(jcli, argv_j, capsys)
    t = _run(tcli, argv_t, capsys)
    if root_j is not None:  # paths name each run's own root
        j = (j[0], json.loads(json.dumps(j[1]).replace(str(root_j), "<root>")))
        t = (t[0], json.loads(json.dumps(t[1]).replace(str(root_t), "<root>")))
    for _, lines in (j, t):  # a quarantine records its own wall clock
        for rec in lines:
            if "quarantined_at" in rec:
                assert isinstance(rec.pop("quarantined_at"), float)
    return j, t


# ---------------------------------------------------------------------------
# the file tools
# ---------------------------------------------------------------------------

FILE_TOOLS = {
    "read_data_files": lambda r: ["read_data_files", r],
    "read_data_files_one_id": lambda r: ["read_data_files", r, "--namespace", "default",
                                         "--shard", "1", "--block-start", str(START),
                                         "--id", "host003.cpu"],
    "read_index_files": lambda r: ["read_index_files", r],
    "read_commitlog": lambda r: ["read_commitlog", r],
    "verify_data_files": lambda r: ["verify_data_files", r],
    "scrub_verbose_inventory": lambda r: ["scrub", r, "--verbose", "--inventory",
                                          "--no-quarantine"],
}


@pytest.mark.parametrize("tool", sorted(FILE_TOOLS))
def test_file_tools_print_the_reference_lines(store, tool, capsys):
    argv = FILE_TOOLS[tool](str(store))
    (jrc, jout), (trc, tout) = _both(argv, argv, capsys)
    assert (trc, tout) == (jrc, jout)
    assert trc == 0 and tout


def test_read_commitlog_of_one_file_and_without_input(store, capsys):
    log = str(next(store.glob("commitlogs/commitlog-*.db")))
    (jrc, jout), (trc, tout) = _both(["read_commitlog", "--file", log],
                                     ["read_commitlog", "--file", log], capsys)
    assert (trc, tout) == (jrc, jout) and tout
    assert tcli.main(["read_commitlog"]) == jcli.main(["read_commitlog"]) == 2


@pytest.mark.parametrize("field,value", [("__name__", "reqs"), ("instance", "i2"),
                                         ("job", "none")])
def test_query_index_segments_matches(store, field, value, capsys):
    argv = ["query_index_segments", str(store), field, value]
    (jrc, jout), (trc, tout) = _both(argv, argv + ["--device", "cpu"], capsys)
    assert (trc, tout) == (jrc, jout)
    assert (len(tout) > 0) == (value != "none")


def _tree(root: pathlib.Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_clone_fileset_writes_the_same_files(store, tmp_path, capsys):
    args = [str(store), "default", "1", str(START)]
    dj, dt = tmp_path / "j", tmp_path / "t"
    (jrc, jout), (trc, tout) = _both(
        ["clone_fileset", *args, str(dj), "--dest-shard", "5"],
        ["clone_fileset", *args, str(dt), "--dest-shard", "5"], capsys)
    assert (trc, tout) == (jrc, jout) and tout[0]["cloned"] > 0
    assert _tree(dt) == _tree(dj) and _tree(dt)


def test_scrub_quarantines_the_corrupted_volume_alike(store, tmp_path, capsys):
    """One byte flipped in one volume's data file: ``verify_data_files``
    reports it, ``scrub --inventory`` quarantines it under
    ``<root>/quarantine/`` and lists it, identically."""
    roots = {}
    for side in ("j", "t"):
        root = tmp_path / side
        shutil.copytree(store, root)
        victim = next(root.glob("data/default/1/fileset-*-data.db"))
        raw = bytearray(victim.read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        victim.write_bytes(bytes(raw))
        roots[side] = root
    rj, rt = str(roots["j"]), str(roots["t"])
    (jrc, jout), (trc, tout) = _both(["verify_data_files", rj], ["verify_data_files", rt],
                                     capsys, rj, rt)
    assert (trc, tout) == (jrc, jout) and trc == 1
    (jrc, jout), (trc, tout) = _both(["scrub", rj, "--inventory"], ["scrub", rt, "--inventory"],
                                     capsys, rj, rt)
    assert (trc, tout) == (jrc, jout) and trc == 1
    assert tout[-1] == {"checked": 2, "corrupt": 1}
    assert any("quarantined" in rec for rec in tout)
    assert _tree(roots["t"] / "quarantine").keys() == _tree(roots["j"] / "quarantine").keys()
    # once quarantined, a second sweep is clean in both
    (jrc, jout), (trc, tout) = _both(["scrub", rj], ["scrub", rt], capsys, rj, rt)
    assert (trc, tout) == (jrc, jout) and trc == 0


# ---------------------------------------------------------------------------
# the parser
# ---------------------------------------------------------------------------


class _Parsed(Exception):
    pass


def _parser_of(cli, monkeypatch) -> argparse.ArgumentParser:
    def grab(self, *a, **kw):
        raise _Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed) as ei:
            cli.main([])
    return ei.value.args[0]


def _shape(parser) -> dict:
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    out = {}
    for name, p in sub.choices.items():
        out[name] = sorted(
            (tuple(a.option_strings) or (a.dest,), a.dest, a.nargs, a.const, a.default,
             a.type.__name__ if a.type else None)
            for a in p._actions if not isinstance(a, argparse._HelpAction))
    return out


def test_parser_has_the_reference_subcommands_and_options(monkeypatch):
    j = _shape(_parser_of(jcli, monkeypatch))
    t = _shape(_parser_of(tcli, monkeypatch))
    device = (("--device",), "device", None, None, None, None)
    assert set(j) - set(t) == {"tpu_backlog"} and set(t) <= set(j)
    with_device = {"query_index_segments", "hops", "costs", "irlint", "soak"}
    for name in t:
        want = sorted(j[name] + [device]) if name in with_device else j[name]
        assert t[name] == want, name


# ---------------------------------------------------------------------------
# the gates, green on the CPU
# ---------------------------------------------------------------------------


def test_lint_json_and_explain(capsys):
    rc, out = _run(tcli, ["lint", "--json"], capsys)
    assert rc == 0 and out == [{"ok": True, "findings": 0, "baseline": 0,
                                "new": [], "fixed": []}]
    capsys.readouterr()
    assert tcli.main(["lint", "--explain", "retrace-risk"]) == 0
    text = capsys.readouterr().out
    assert text.startswith("[retrace-risk]") and "violates:" in text and "clean:" in text
    assert tcli.main(["lint", "--explain", "no-such-rule"]) == 2


def test_lint_of_a_subdirectory_keeps_package_paths(capsys, tmp_path):
    """``--root`` below the package still reports ``m3_tpu_torch/...``
    paths, so the path-scoped rules match (their baseline is empty)."""
    root = pathlib.Path(tcli.__file__).resolve().parent.parent / "dtest"
    rc, out = _run(tcli, ["lint", "--json", "--root", str(root),
                          "--baseline", str(tmp_path / "none.json")], capsys)
    assert rc == 0 and out[0]["ok"] and out[0]["findings"] == 0


def test_costs_then_irlint_check_green_against_the_cpu_baselines(capsys):
    rc, out = _run(tcli, ["costs", "--device", "cpu", "--check", "--json"], capsys)
    assert rc == 0, out
    assert out[0]["ok"] and out[0]["stages"] == 16 and out[0]["baseline"].endswith(
        "costs_baseline_cpu.json")
    rc, out = _run(tcli, ["irlint", "--device", "cpu", "--check", "--json"], capsys)
    assert rc == 0, out
    assert out[0]["ok"] and out[0]["baseline"].endswith("irlint_baseline_cpu.json")
    assert tcli.main(["irlint", "--explain", "scatter-budget"]) == 0
    assert tcli.main(["irlint", "--explain", "nope"]) == 2


@pytest.mark.parametrize("tool", ["hops", "costs", "irlint"])
def test_a_missing_baseline_fails_fast(tool, capsys):
    assert tcli.main([tool, "--device", "cpu", "--check", "/no/such/file.json"]) == 2
    assert "no baseline" in capsys.readouterr().err


def test_soak_check_needs_a_named_baseline(capsys, tmp_path):
    assert tcli.main(["soak", "--check", "--device", "cpu"]) == 2
    assert "no baseline" in capsys.readouterr().err
    assert tcli.main(["soak", "--check", str(tmp_path / "none.json")]) == 2


def test_hops_check_green_against_the_cpu_baseline(capsys):
    """The committed CPU baseline is a 48-series x 20 s corpus's (the
    pinned one takes minutes here; the card checks it): no transfer,
    build or dispatch (nothing crosses a device boundary on the CPU, at
    any corpus), every hop, its three volumes equal.  The check pins the
    corpus, so it runs the baseline's."""
    base = thops.default_baseline_path("cpu")
    committed = json.loads(base.read_text())
    assert committed["config"]["platform"] == "cpu"
    assert (committed["config"]["S"], committed["config"]["T"]) == (48, 20)
    assert committed["pipeline"]["transfer_bytes_steady"] == 0
    assert committed["pipeline"]["dispatches_steady"] == 0
    assert committed["pipeline"]["compiles_steady"] == 0
    assert set(committed["hops"]) == set(thops.HOPS)
    assert (committed["volume_sha256"] == committed["cold_volume_sha256"]
            == committed["ledger_volume_sha256"])
    assert committed["findings"] == thops.derive_findings(committed)
    rc, out = _run(tcli, ["hops", "--device", "cpu", "--check",
                          "--series", "48", "--samples", "20"], capsys)
    assert rc == 0, out
    chk = out[0]["hops_check"]
    assert chk["ok"] and chk["violations"] == [] and chk["baseline"] == str(base)


def test_committed_card_baseline_names_its_card():
    card = json.loads(thops.default_baseline_path("cuda").read_text())
    cfg = card["config"]
    assert cfg["platform"] == "cuda" and cfg["device_name"].startswith("NVIDIA")
    assert cfg["power_limit"] and cfg["torch"] and cfg["cuda"]
    assert (cfg["S"], cfg["T"]) == (thops.S_DEFAULT, thops.T_DEFAULT)
    assert set(card["hops"]) == set(thops.HOPS)
    assert card["volume_sha256"] == thops.PINNED_VOLUME_SHA256
    assert card["pipeline"]["compiles_steady"] == 0
    assert card["pipeline"]["transfer_bytes_steady"] > 0
    assert card["findings"] == thops.derive_findings(card)


# ---------------------------------------------------------------------------
# the regression gate: the reference's cases through both packages
# ---------------------------------------------------------------------------


def _artifact(bytes_steady, compiles_steady=0, dispatches=None):
    return {
        "pipeline": {"transfer_bytes_steady": bytes_steady,
                     "compiles_steady": compiles_steady},
        "hops": ({h: {"dispatches": d} for h, d in dispatches.items()}
                 if dispatches else {}),
    }


R09 = {"pipeline": {"transfer_bytes_steady": 1000, "compiles_steady": 0},
       "hops": {"window_drain": {"steady": {"dispatches": 100}}}}

# (baseline, current, kwargs, expected fragment or None for a pass)
GATE_CASES = {
    "within_tolerance": (_artifact(1000), _artifact(1200), {"tolerance": 0.25}, None),
    "transfer_regression": (_artifact(1000), _artifact(1300), {"tolerance": 0.25},
                            "transfer bytes regressed"),
    "steady_compile": (_artifact(1000, 0), _artifact(1000, 2), {}, "compiles regressed"),
    "dispatch_regression": (_artifact(1000, dispatches={"window_drain": 198}),
                            _artifact(1000, dispatches={"window_drain": 240}),
                            {"dispatch_tolerance": 0.10}, "dispatches regressed"),
    "dispatch_within": (_artifact(1000, dispatches={"window_drain": 198}),
                        _artifact(1000, dispatches={"window_drain": 210}),
                        {"dispatch_tolerance": 0.10}, None),
    "dispatch_from_zero": (_artifact(1000, dispatches={"wire_parse": 0}),
                           _artifact(1000, dispatches={"wire_parse": 1}), {},
                           "dispatches regressed"),
    "missing_hop": (_artifact(1000, dispatches={"encode": 1}), _artifact(1000), {},
                    "missing from this run"),
    "r09_nesting_regressed": (R09, _artifact(1000, dispatches={"window_drain": 150}), {},
                              "dispatches regressed"),
    "r09_nesting_within": (R09, _artifact(1000, dispatches={"window_drain": 105}), {}, None),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_check_against_baseline_gives_the_reference_violations(case, tmp_path):
    base, cur, kw, fragment = GATE_CASES[case]
    path = tmp_path / "PIPELINE.json"
    path.write_text(json.dumps(base))
    j = jhops.check_against_baseline(cur, str(path), **kw)
    t = thops.check_against_baseline(cur, str(path), **kw)
    assert t == j
    assert (fragment is None and t == []) or (t and fragment in t[0])


@pytest.mark.parametrize("key,value", [("platform", "cuda"), ("device_name", "other"),
                                       ("torch", "0.0"), ("S", 48), ("T", 20)])
def test_check_refuses_a_baseline_of_another_ledger(tmp_path, key, value):
    """A ledger of another platform, card, torch or corpus is another
    ledger: a small corpus's fewer bytes and dispatches are no pass."""
    cfg = {"platform": "cpu", "device_name": "cpu", "torch": "x", "S": 1024, "T": 320}
    path = tmp_path / "PIPELINE.json"
    path.write_text(json.dumps(dict(_artifact(1000), config=cfg)))
    assert thops.check_against_baseline(dict(_artifact(1000), config=cfg), path) == []
    errs = thops.check_against_baseline(
        dict(_artifact(1000), config=dict(cfg, **{key: value})), path)
    assert len(errs) == 1 and errs[0].startswith(f"{key} mismatch")


def _findings_artifact(dominant: str, amp: float, reupload: int) -> dict:
    hops = {h: {"host_time_fraction": 0.6 if h == dominant else 0.1,
                "steady": {"h2d_bytes": reupload if h == "encode" else 0}}
            for h in thops.HOPS}
    return {"hops": hops, "config": {"wire_bytes": 1000},
            "pipeline": {"transfer_bytes_steady": int(1000 * amp), "transfers_steady": 7}}


@pytest.mark.parametrize("dominant,amp,reupload", [
    ("window_drain", 2.0, 64), ("arena_ingest", 0.5, 0), ("encode", 1.0, 8)])
def test_findings_name_what_the_reference_names(dominant, amp, reupload):
    art = _findings_artifact(dominant, amp, reupload)
    j = jhops.derive_findings(art)
    t = thops.derive_findings(art)
    assert len(t) == len(j) == 1 + (amp > 1.0) + (reupload > 0)
    assert t[0].split()[0] == j[0].split()[0] == dominant
    assert [f.split(":")[0] for f in t[1:]] == [f.split(":")[0] for f in j[1:]]
