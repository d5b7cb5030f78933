"""Ops tools: inspect and verify on-disk artifacts.
The port's counterpart of ``m3_tpu/tools/cli.py``.

Equivalents of the reference's `src/cmd/tools/*`: `read_data_files`
(dump series from a fileset), `read_index_files` (dump index segment
terms), `read_commitlog` (dump WAL entries), `verify_data_files`
(checksum-verify every fileset), `scrub` (verify AND quarantine corrupt
volumes under <root>/quarantine/), `clone_fileset`, and
`query_index_segments` (run a term query against sealed segments).
One binary, subcommand per tool, JSON-lines output for scripting.  The
port's gates and harnesses ride it too: `hops`, `costs`, `irlint`,
`soak` and `lint`, each over the port's module of the same name.

A subcommand that touches a device (`query_index_segments`, `hops`,
`costs`, `irlint`, `soak`) runs on the CUDA card unless `--device` names
another (`--device cpu`).  The reference's `tpu_backlog` (the JAX
system's on-chip bench backlog over a TPU relay) has no counterpart:
the port's benchmark is a program of its own.

Usage:  python -m m3_tpu_torch.tools.cli <tool> [args...]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from m3_tpu_torch.encoding.m3tsz import decode_series
from m3_tpu_torch.persist.commitlog import list_commitlogs, read_commitlog
from m3_tpu_torch.persist.fs import (
    DataFileSetReader, DataFileSetWriter, list_filesets,
)


def _out(obj) -> None:
    sys.stdout.write(json.dumps(obj) + "\n")


def _namespaces(root: str) -> list[str]:
    d = Path(root) / "data"
    return sorted(p.name for p in d.iterdir() if p.is_dir()) if d.exists() else []


def _shards(root: str, ns: str) -> list[int]:
    d = Path(root) / "data" / ns
    return sorted(int(p.name) for p in d.iterdir() if p.name.isdigit()) if d.exists() else []


def read_data_files(args) -> int:
    """Dump every (id, points) from filesets (cmd/tools/read_data_files)."""
    for ns in ([args.namespace] if args.namespace else _namespaces(args.root)):
        for shard in ([args.shard] if args.shard is not None else _shards(args.root, ns)):
            for bs, vol in list_filesets(args.root, ns, shard):
                if args.block_start is not None and bs != args.block_start:
                    continue
                r = DataFileSetReader(args.root, ns, shard, bs, vol)
                for sid, seg in r.read_all():
                    if args.id and args.id.encode() != sid:
                        continue
                    pts = decode_series(seg)
                    _out({
                        "namespace": ns, "shard": shard, "block_start": bs,
                        "volume": vol, "id": sid.decode(errors="replace"),
                        "points": [[d.timestamp, d.value] for d in pts],
                    })
    return 0


def read_index_files(args) -> int:
    """Dump sealed index segments (cmd/tools/read_index_files)."""
    from m3_tpu_torch.index.segment import SealedSegment

    d = Path(args.root) / "index"
    for nsdir in sorted(d.iterdir()) if d.exists() else []:
        for f in sorted(nsdir.glob("segment-*.db")):
            seg = SealedSegment.from_bytes(f.read_bytes())
            fields = {}
            for name in seg.fields():
                fields[name.decode(errors="replace")] = [
                    v.decode(errors="replace") for v in seg.terms(name)
                ]
            _out({
                "namespace": nsdir.name,
                "block_start": int(f.stem.split("-")[1]),
                "num_docs": len(seg),
                "fields": fields,
            })
    return 0


def read_commitlog_cmd(args) -> int:
    """Dump WAL entries (cmd/tools/read_commitlog)."""
    if not args.file and not args.root:
        print("read_commitlog: provide a data root or --file", file=sys.stderr)
        return 2
    logs = [Path(args.file)] if args.file else list_commitlogs(args.root)
    for log in logs:
        for e in read_commitlog(log):
            _out({
                "log": log.name, "namespace": e.namespace.decode(),
                "id": e.series_id.decode(errors="replace"),
                "timestamp": e.timestamp, "value": e.value,
            })
    return 0


def verify_data_files(args) -> int:
    """Checksum-verify every fileset; exit 1 on any corruption
    (cmd/tools/verify_data_files).  Report-only view over the scrub
    sweep (checkpoint → digest → per-file adler32 → per-segment
    checksums); `scrub` is the same walk plus quarantine."""
    from m3_tpu_torch.storage.scrub import scrub_root

    bad = 0
    for rec in scrub_root(args.root, quarantine=False):
        if not rec["ok"]:
            bad += 1
        _out(rec)
    return 1 if bad else 0


def clone_fileset(args) -> int:
    """Copy one fileset to another root/namespace/shard, re-writing (and
    re-checksumming) it (cmd/tools/clone_fileset)."""
    r = DataFileSetReader(args.root, args.namespace, args.shard,
                          args.block_start, args.volume)
    series = list(r.read_all())
    DataFileSetWriter(
        args.dest_root, args.dest_namespace or args.namespace,
        args.dest_shard if args.dest_shard is not None else args.shard,
        args.block_start, r.info.block_size, volume=args.volume,
    ).write_all(series)
    _out({"cloned": len(series)})
    return 0


def query_index_segments(args) -> int:
    """Run a term query against sealed segments
    (cmd/tools/query_index_segments)."""
    from m3_tpu_torch.index.namespace_index import NamespaceIndex
    from m3_tpu_torch.index.search import Term

    idx = NamespaceIndex(args.block_size, args.root, args.namespace,
                         device=args.device)
    q = Term(args.field.encode(), args.value.encode())
    docs = idx.query(q, -(2**62), 2**62)
    for d in docs:
        _out({"id": d.id.decode(errors="replace"),
              "tags": {k.decode(): v.decode() for k, v in d.tags().items()}})
    return 0


def scrub(args) -> int:
    """Offline corruption sweep of a data root: verify every
    checkpointed fileset volume (checkpoint → digests → per-segment
    checksums) and quarantine what fails under <root>/quarantine/ with
    a reason file (report-only with --no-quarantine).  Exit 1 when any
    corruption was found — the cron/CI shape of the reference's
    verify_data_files tool, plus the quarantine step."""
    from m3_tpu_torch.persist.quarantine import list_quarantined
    from m3_tpu_torch.storage.scrub import scrub_root

    results = scrub_root(args.root, quarantine=not args.no_quarantine)
    bad = 0
    for rec in results:
        if not rec["ok"]:
            bad += 1
        if not rec["ok"] or args.verbose:
            _out(rec)
    if args.inventory:
        for entry in list_quarantined(args.root):
            _out(entry)
    _out({"checked": len(results), "corrupt": bad})
    return 1 if bad else 0


def hops(args) -> int:
    """Profile the wire→arena→drain→encode→fileset ingest pipeline
    under x/hopwatch (per-hop transfers, bytes, build-vs-steady ledger,
    host-time fraction) and emit the PIPELINE artifact JSON
    (``tools/hops.run_pipeline``).

    ``--out PIPELINE.json`` writes the artifact; ``--check [BASELINE]``
    re-runs the profile and exits nonzero if the steady pipeline moves
    more transfer bytes than the baseline allows (±tolerance), builds a
    kernel library in the steady pass, grows any hop's steady dispatch
    count past ``--dispatch-tolerance`` (dispatch growth is the leading
    indicator the transfer gate misses) or loses a hop — the hot path
    must not quietly regress to MORE host hops.  The default baseline
    is the committed one of the device's platform
    (``tools/hops_baseline_{cpu,cuda}.json``)."""
    from m3_tpu_torch import resolve_device
    from m3_tpu_torch.tools.hops import (
        check_against_baseline, default_baseline_path, run_pipeline,
    )

    dev = resolve_device(args.device)
    baseline = None
    if args.check is not None:
        # resolve + validate the baseline BEFORE the multi-minute
        # profile run: a typo'd path must fail in milliseconds
        baseline = args.check or str(default_baseline_path(dev.type))
        if not Path(baseline).exists():
            print(f"hops --check: no baseline at {baseline}",
                  file=sys.stderr)
            return 2
    artifact = run_pipeline(S=args.series, T=args.samples, device=dev)
    if baseline is not None:
        errs = check_against_baseline(
            artifact, baseline, tolerance=args.tolerance,
            dispatch_tolerance=args.dispatch_tolerance)
        _out({"hops_check": {"ok": not errs, "baseline": baseline,
                             "violations": errs,
                             "pipeline": artifact["pipeline"]}})
        return 1 if errs else 0
    text = json.dumps(artifact, indent=1)
    if args.out:
        Path(args.out).write_text(text + "\n")
        print(f"hops: artifact written to {args.out}", file=sys.stderr)
    else:
        sys.stdout.write(text + "\n")
    return 0


def costs(args) -> int:
    """Per-stage dispatch fingerprints (x/costwatch.py): one counted
    eager run of every registered hot-path program at pinned canonical
    shapes on the device, its aten dispatches by class, kernel launches,
    transfers, argument/output/peak bytes and 64-bit census with
    per-datapoint normalizations (``tools/costs.build_artifact``).  The
    counts are exact: no timed loops.

    ``--out COSTS.json`` writes the artifact; ``--check [BASELINE]``
    re-runs the registry and exits nonzero when any per-stage gated
    metric moves past tolerance in either direction, a stage vanishes/
    appears, a pinned config changes, or a stage launches other kernels
    than it names — improvements re-baseline (the lint/hops multiset-
    ratchet tradition).  The default baseline is the committed one of
    the device's platform.  ``--json`` emits the structured CI report
    (`cli lint --json` shape).  The sharded stages repeat the one
    device (x/costwatch), so no host-device knob is needed."""
    from m3_tpu_torch import resolve_device
    from m3_tpu_torch.tools.costs import (
        DEFAULT_TOLERANCE, build_artifact, check_against_baseline,
        default_baseline_path, stage_kernel_violations,
    )

    dev = resolve_device(args.device)
    baseline = None
    if args.check is not None:
        # resolve + validate the baseline BEFORE the census run: a
        # typo'd path must fail in milliseconds (the hops precedent)
        baseline = args.check or str(default_baseline_path(dev.type))
        if not Path(baseline).exists():
            print(f"costs --check: no baseline at {baseline}",
                  file=sys.stderr)
            return 2

    def log(msg):
        print(msg, file=sys.stderr)

    artifact = build_artifact(args.stage or None, dev, log=log)
    text = json.dumps(artifact, indent=1)
    if args.out:
        Path(args.out).write_text(text + "\n")
        log(f"costs: artifact written to {args.out}")
    kernel_errs = [{"kind": "kernels", "message": m}
                   for m in stage_kernel_violations(artifact)]
    if baseline is not None:
        errs = check_against_baseline(
            artifact, baseline,
            tolerance=(args.tolerance if args.tolerance is not None
                       else DEFAULT_TOLERANCE)) + kernel_errs
        if args.json:
            _out({"ok": not errs, "artifact": "COSTS",
                  "baseline": baseline,
                  "stages": len(artifact["stages"]),
                  "violations": errs})
        else:
            for e in errs:
                print(f"{e['kind'].upper():<14} {e['message']}",
                      file=sys.stderr)
            _out({"costs_check": {"ok": not errs, "baseline": baseline,
                                  "stages": len(artifact["stages"]),
                                  "violations": len(errs)}})
        return 1 if errs else 0
    if args.json:
        _out({"ok": not kernel_errs, "artifact": "COSTS",
              "stages": len(artifact["stages"]),
              "violations": kernel_errs})
    elif not args.out:
        sys.stdout.write(text + "\n")
    return 1 if kernel_errs else 0


def irlint(args) -> int:
    """Typed rules over the device-program registry's op census
    (x/irlint.py): every costwatch stage's counted run through the
    shared stage cache, held against per-stage contracts
    (transfer-free / scatter-budget / width-discipline /
    ir-const-bloat), plus the residency-composition pass over the
    ingest → drain → encode phase 1 → placement chain, whose host
    crossings are the committed burn-down list.

    ``--check [BASELINE]`` ratchets against the committed baseline of
    the device's platform (new finding fails, stale baseline entry
    fails — improvements re-baseline); ``--out`` writes the artifact;
    ``--explain RULE`` prints a rule's rationale + examples."""
    if args.explain:
        from m3_tpu_torch.x.irlint import EXPLAIN

        info = EXPLAIN.get(args.explain)
        if info is None:
            print(f"unknown irlint rule {args.explain!r}; rules: "
                  f"{', '.join(sorted(EXPLAIN))}", file=sys.stderr)
            return 2
        print(f"[{args.explain}]\n\n{info['why']}\n\nviolates:\n  "
              f"{info['bad']}\n\nclean:\n  {info['good']}")
        return 0

    from m3_tpu_torch import resolve_device
    from m3_tpu_torch.x.irlint import (
        build_artifact, check_against_baseline, default_baseline_path,
    )

    dev = resolve_device(args.device)
    baseline = None
    if args.check is not None:
        # resolve + validate the baseline BEFORE the census run: a
        # typo'd path must fail in milliseconds (the costs precedent)
        baseline = args.check or str(default_baseline_path(dev.type))
        if not Path(baseline).exists():
            print(f"irlint --check: no baseline at {baseline}",
                  file=sys.stderr)
            return 2

    def log(msg):
        print(msg, file=sys.stderr)

    artifact = build_artifact(dev, stage_names=args.stage or None, log=log)
    text = json.dumps(artifact, indent=1)
    if args.out:
        Path(args.out).write_text(text + "\n")
        log(f"irlint: artifact written to {args.out}")
    if baseline is not None:
        errs = check_against_baseline(artifact, baseline)
        if args.json:
            _out({"ok": not errs, "artifact": "IRLINT",
                  "baseline": baseline, "counts": artifact["counts"],
                  "violations": errs})
        else:
            for e in errs:
                print(f"{e['kind'].upper():<14} {e['message']}",
                      file=sys.stderr)
            _out({"irlint_check": {"ok": not errs, "baseline": baseline,
                                   "counts": artifact["counts"],
                                   "violations": len(errs)}})
        return 1 if errs else 0
    if args.json:
        _out({"ok": True, "artifact": "IRLINT",
              "counts": artifact["counts"],
              "findings": artifact["findings"]})
    elif not args.out:
        sys.stdout.write(text + "\n")
    return 0


def soak(args) -> int:
    """Million-series soak (dtest/soak.py): real multi-node cluster on
    the device, sustained bulk ingest + PromQL/Graphite query traffic, a
    seeded chaos timeline (wire faults, a device-fault window, SIGKILL,
    fileset corruption, rolling replace), and a zero-acked-sample-loss
    verdict — emitted as a BENCH-style SOAK artifact.

    ``--smoke`` is the tier-1 shape (2 nodes, ~20K series, one wire-
    fault window).  ``--check BASELINE`` re-runs the baseline
    artifact's own config and exits nonzero on SLO/loss regression —
    the before/after gate for a rebuild of the node's hot path (run
    ``cli soak --out SOAK_before.json`` before the refactor, ``cli
    soak --check SOAK_before.json`` after).  The baseline is always
    named: no run of another machine is a default."""
    from m3_tpu_torch.dtest.soak import (
        SoakConfig, check_artifact, config_from_artifact, run_soak,
    )

    def log(msg):
        print(msg, file=sys.stderr)

    baseline = None
    if args.check is not None:
        bpath = args.check
        if not bpath:
            print("soak --check: no baseline named (soak --check "
                  "BASELINE)", file=sys.stderr)
            return 2
        if not Path(bpath).exists():
            print(f"soak --check: no baseline at {bpath}", file=sys.stderr)
            return 2
        baseline = json.loads(Path(bpath).read_text())

    overrides = {}
    for name in ("series", "nodes", "batch", "sweeps", "seed"):
        v = getattr(args, name)
        if v is not None:
            overrides[name] = v
    if args.selfheal:
        overrides["selfheal"] = True
        # The selfheal profile binds the device and node lanes and
        # gives node burn its realistic driver — a capacity-quota disk
        # ledger, a disk-pressure window, and the emergency_cleanup
        # binding.
        overrides.setdefault("disk_capacity", "256M")
        overrides.setdefault("t_disk", 20.0)
        overrides.setdefault("disk_rule", "disk-pressure")
    if baseline is not None:
        cfg = config_from_artifact(baseline, **overrides)
    else:
        cfg = (SoakConfig.smoke_config if args.smoke else SoakConfig)(**overrides)
        # max_sweeps caps the load at the default series space's 12
        # sweeps; a config that cuts ``series`` scales the cap by the
        # cut, so it bounds the same samples and does not end a fast
        # node's load, and with it the timeline, before the chaos ran
        full = SoakConfig()
        if cfg.series < full.series:
            cfg.max_sweeps = -(-full.max_sweeps * full.series // cfg.series)

    artifact = run_soak(cfg, workdir=args.workdir,
                        keep_workdir=args.keep_workdir, log=log,
                        device=args.device)
    text = json.dumps(artifact, indent=1)
    if args.out:
        # --out is honored in check mode too: a --check re-run is a
        # full soak, and its artifact is the candidate next baseline
        Path(args.out).write_text(text + "\n")
        log(f"soak: artifact written to {args.out}")
    if baseline is not None:
        errs = check_artifact(artifact, baseline, tolerance=args.tolerance)
        _out({"soak_check": {"ok": not errs, "violations": errs,
                             "verdict": artifact["verdict"]}})
        return 1 if errs else 0
    if not args.out:
        sys.stdout.write(text + "\n")
    v = artifact["verdict"]
    # with selfmon on, the run must also leave at least one
    # retro-queryable SLO verdict in _m3_selfmon (the dogfooding gate)
    return 0 if v["zero_acked_loss"] and v.get("slo_recorded", True) else 1


def lint(args) -> int:
    """Run m3lint over the port's package and gate against the
    committed baseline (m3_tpu_torch/tools/lint_baseline.json).  Exit 0 only when the findings
    match the baseline exactly: new findings fail the gate, and so do
    stale baseline entries — a fixed finding must ratchet the baseline
    down (--update-baseline).  ``--explain <rule>`` prints a rule's
    rationale plus a minimal violating/clean example instead of
    linting; ``--json`` emits a machine-readable report (findings as
    structured objects) for CI consumption."""
    from m3_tpu_torch.x import lint as m3lint
    from m3_tpu_torch.x.lint.core import RULES, explain

    if args.explain:
        rule = args.explain
        entry = explain(rule)
        if entry is None:
            print(f"lint --explain: unknown rule {rule!r}; rules: "
                  f"{', '.join(RULES)}", file=sys.stderr)
            return 2
        print(f"[{rule}]\n")
        print(entry["why"].strip() + "\n")
        print("violates:\n" + "\n".join(
            "    " + ln for ln in entry["bad"].rstrip().splitlines()) + "\n")
        print("clean:\n" + "\n".join(
            "    " + ln for ln in entry["good"].rstrip().splitlines()))
        return 0

    root = Path(args.root).resolve() if args.root else (
        Path(__file__).resolve().parent.parent)
    # Walk up past __init__.py so a subdirectory --root still reports
    # package-rooted paths ("m3_tpu_torch/server/rpc.py") — otherwise the
    # path-scoped rules (fault-coverage, explicit-dtype, the constant
    # ratchet) silently never match and the run is a false green.
    rel_root = root
    while (rel_root / "__init__.py").exists() and rel_root.parent != rel_root:
        rel_root = rel_root.parent
    findings = m3lint.lint_tree(root, rel_root)
    baseline_path = (Path(args.baseline) if args.baseline
                     else m3lint.default_baseline_path())
    if args.update_baseline:
        m3lint.save_baseline(baseline_path, findings)
        print(f"lint: baseline updated: {len(findings)} findings "
              f"-> {baseline_path}", file=sys.stderr)
        return 0
    baseline = m3lint.load_baseline(baseline_path)
    new, fixed = m3lint.diff_baseline(findings, baseline)
    if args.json:
        def _rec(f):
            return {"rule": f.rule, "path": f.path, "line": f.line,
                    "message": f.message}
        _out({
            "ok": not (new or fixed),
            "findings": len(findings), "baseline": len(baseline),
            "new": [_rec(f) for f in new],
            "fixed": [_rec(f) for f in fixed],
        })
    else:
        for f in new:
            print(f"NEW     {f.render()}", file=sys.stderr)
        for f in fixed:
            print(f"FIXED   {f.render()} (stale baseline entry — run "
                  f"lint --update-baseline)", file=sys.stderr)
        print(f"lint: {len(findings)} findings, {len(baseline)} baselined, "
              f"{len(new)} new, {len(fixed)} fixed", file=sys.stderr)
    return 1 if (new or fixed) else 0


_DEVICE_HELP = "torch device (default: the CUDA card; cpu)"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="m3tpu-tools", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="tool", required=True)

    rd = sub.add_parser("read_data_files")
    rd.add_argument("root")
    rd.add_argument("--namespace")
    rd.add_argument("--shard", type=int)
    rd.add_argument("--block-start", type=int, dest="block_start")
    rd.add_argument("--id")
    rd.set_defaults(fn=read_data_files)

    ri = sub.add_parser("read_index_files")
    ri.add_argument("root")
    ri.set_defaults(fn=read_index_files)

    rc = sub.add_parser("read_commitlog")
    rc.add_argument("root", nargs="?")
    rc.add_argument("--file")
    rc.set_defaults(fn=read_commitlog_cmd)

    vf = sub.add_parser("verify_data_files")
    vf.add_argument("root")
    vf.set_defaults(fn=verify_data_files)

    cl = sub.add_parser("clone_fileset")
    cl.add_argument("root")
    cl.add_argument("namespace")
    cl.add_argument("shard", type=int)
    cl.add_argument("block_start", type=int)
    cl.add_argument("dest_root")
    cl.add_argument("--volume", type=int, default=0)
    cl.add_argument("--dest-namespace", dest="dest_namespace")
    cl.add_argument("--dest-shard", type=int, dest="dest_shard")
    cl.set_defaults(fn=clone_fileset)

    qi = sub.add_parser("query_index_segments")
    qi.add_argument("root")
    qi.add_argument("field")
    qi.add_argument("value")
    qi.add_argument("--namespace", default="default")
    qi.add_argument("--block-size", type=int, dest="block_size",
                    default=2 * 3600 * 10**9)
    qi.add_argument("--device", help=_DEVICE_HELP)
    qi.set_defaults(fn=query_index_segments)

    sc = sub.add_parser(
        "scrub", help="verify + quarantine corrupt filesets in a data root")
    sc.add_argument("root")
    sc.add_argument("--no-quarantine", action="store_true",
                    dest="no_quarantine",
                    help="report corruption without moving anything")
    sc.add_argument("--verbose", action="store_true",
                    help="emit one line per clean volume too")
    sc.add_argument("--inventory", action="store_true",
                    help="also dump the quarantine inventory")
    sc.set_defaults(fn=scrub)

    hp = sub.add_parser(
        "hops",
        help="profile the wire→arena→drain→encode→fileset pipeline's "
             "host↔device hops (x/hopwatch) and emit/check the "
             "PIPELINE artifact")
    hp.add_argument("--series", type=int, default=1024,
                    help="corpus series count (default 1024 — the "
                         "pinned artifact shape)")
    hp.add_argument("--samples", type=int, default=320,
                    help="samples per series (default 320)")
    hp.add_argument("--out", help="write the artifact JSON here")
    hp.add_argument("--check", nargs="?", const="", default=None,
                    metavar="BASELINE",
                    help="gate against a PIPELINE artifact (default: the "
                         "committed tools/hops_baseline_<platform>.json); "
                         "exit 1 on transfer-byte/build/dispatch "
                         "regression or a missing hop")
    hp.add_argument("--tolerance", type=float, default=0.25,
                    help="allowed transfer-byte growth vs baseline "
                         "(default 0.25)")
    hp.add_argument("--dispatch-tolerance", type=float, default=0.10,
                    dest="dispatch_tolerance",
                    help="allowed per-hop steady dispatch-count growth "
                         "vs baseline (default 0.10 — dispatch counts "
                         "are deterministic at the pinned corpus shape)")
    hp.add_argument("--device", help=_DEVICE_HELP)
    hp.set_defaults(fn=hops)

    co = sub.add_parser(
        "costs",
        help="per-stage dispatch fingerprints from one counted run of "
             "each registered program (dispatches by class, launches, "
             "transfers, bytes and peak per datapoint at pinned "
             "canonical shapes); emit/check the COSTS artifact")
    co.add_argument("--out", help="write the artifact JSON here")
    co.add_argument("--check", nargs="?", const="", default=None,
                    metavar="BASELINE",
                    help="gate against a COSTS artifact (default: the "
                         "committed tools/costs_baseline_<platform>.json); "
                         "exit 1 when "
                         "any gated per-stage metric moves past "
                         "tolerance, a stage vanishes/appears, or a "
                         "pinned config changes")
    co.add_argument("--tolerance", type=float, default=None,
                    help="allowed per-metric ratio drift vs baseline "
                         "(default 0.05; both directions — "
                         "improvements re-baseline)")
    co.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout (ok flag + "
                         "structured violations) for CI")
    co.add_argument("--stage", action="append", metavar="NAME",
                    help="restrict to named stages (repeatable; "
                         "default: full registry)")
    co.add_argument("--device", help=_DEVICE_HELP)
    co.set_defaults(fn=costs)

    ir = sub.add_parser(
        "irlint",
        help="typed rules over the device-program registry's op census "
             "(transfer-free / scatter-budget / width-discipline / "
             "ir-const-bloat) + the residency-composition pass of the "
             "ingest -> placement chain; emit/check the IRLINT artifact")
    ir.add_argument("--out", help="write the artifact JSON here")
    ir.add_argument("--check", nargs="?", const="", default=None,
                    metavar="BASELINE",
                    help="gate against an IRLINT artifact (default: the "
                         "committed tools/irlint_baseline_<platform>.json); "
                         "exit 1 on "
                         "any new finding or stale baseline entry "
                         "(improvements re-baseline)")
    ir.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout (ok flag + "
                         "per-rule counts + violations) for CI")
    ir.add_argument("--stage", action="append", metavar="NAME",
                    help="restrict the rules to named registry stages "
                         "(repeatable; the residency pass always runs)")
    ir.add_argument("--explain", metavar="RULE",
                    help="print one rule's rationale + violating/clean "
                         "examples and exit")
    ir.add_argument("--device", help=_DEVICE_HELP)
    ir.set_defaults(fn=irlint)

    sk = sub.add_parser(
        "soak",
        help="million-series chaos soak: multi-node cluster under "
             "sustained ingest + queries with a scripted fault "
             "timeline; emits the SOAK SLO artifact with a zero-acked-"
             "sample-loss verdict")
    sk.add_argument("--smoke", action="store_true",
                    help="tier-1 shape: 2 nodes, ~20K series, one "
                         "wire-fault window, <2 min")
    sk.add_argument("--selfheal", action="store_true",
                    help="add the selfheal phase: a sustained "
                         "heavy-drop window the SLO-burn controller "
                         "must shed, survive, and relax back from; "
                         "also binds the device/node/disk lanes "
                         "(device-errors, disk-pressure) with a disk-"
                         "pressure window as the node-burn driver "
                         "(artifact records the controller_action "
                         "history)")
    sk.add_argument("--check", nargs="?", const="", default=None,
                    metavar="BASELINE",
                    help="re-run BASELINE's config (a SOAK artifact; "
                         "required: there is no default) and exit 1 on "
                         "SLO p99 regression (> --tolerance x) or any "
                         "acked-sample loss")
    sk.add_argument("--series", type=int, help="bulk series space")
    sk.add_argument("--nodes", type=int, help="initial cluster size")
    sk.add_argument("--batch", type=int, help="samples per ingest batch")
    sk.add_argument("--sweeps", type=int,
                    help="minimum full passes over the series space")
    sk.add_argument("--seed", type=int, help="chaos + workload seed")
    sk.add_argument("--tolerance", type=float, default=2.0,
                    help="allowed p99 growth ratio vs baseline "
                         "(default 2.0 — phase windows on a shared box "
                         "are noisy; loss is never tolerated)")
    sk.add_argument("--out", help="write the artifact JSON here")
    sk.add_argument("--workdir", help="cluster scratch dir (default: "
                                      "a fresh tempdir)")
    sk.add_argument("--keep-workdir", action="store_true",
                    dest="keep_workdir",
                    help="keep node roots/logs after the run")
    sk.add_argument("--device", help="device of every node process "
                                     "(default: the CUDA card; cpu)")
    sk.set_defaults(fn=soak)

    li = sub.add_parser(
        "lint", help="codebase-aware static analysis, baseline-gated")
    li.add_argument("--root", help="package root to lint (default: "
                                   "m3_tpu_torch)")
    li.add_argument("--baseline",
                    help="baseline path (default: "
                         "m3_tpu_torch/tools/lint_baseline.json)")
    li.add_argument("--update-baseline", action="store_true",
                    dest="update_baseline",
                    help="rewrite the baseline to the current findings")
    li.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout (structured "
                         "new/fixed findings + ok flag) for CI")
    li.add_argument("--explain", metavar="RULE",
                    help="print RULE's rationale + a minimal violating/"
                         "clean example and exit")
    li.set_defaults(fn=lint)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
