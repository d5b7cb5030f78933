"""Per-stage dispatch fingerprints and their ratchet: the counterpart of
``m3_tpu/tools/costs.py`` (the reference's ``cli costs``).

Builds the COSTS artifact — one fingerprint per registered hot-path
program (``x/costwatch``: both decode tails and the sharded decode, the
encode and the sharded encode, the packed and f64 arena ingest and
consume programs, the timer path), each from one counted eager run on
seeded data at the canonical shapes — plus two cross-checks:

* ``opsdp_crosscheck`` — the census's live per-step counts of the
  decoder's and the encoder's phase-1 steps against
  ``costwatch.DOCUMENTED_OPS_PER_DP``;
* ``membudget_crosscheck`` — every ``x/membudget`` footprint formula
  held to "≥ actual and ≤ 2× actual".  On the card, actual is measured:
  an arena's growth of ``torch.cuda.memory_allocated()`` over its init,
  and a codec pass's interface bytes plus the growth of
  ``max_memory_allocated()`` over its counted run.  On the CPU, actual
  is the state tensors' ``nbytes`` for arenas, and for codec passes the
  counted argument + output bytes against the formula's exact
  (argument + output) part; each row says which it used (``actual``).

``--check BASELINE`` is the regression gate, the reference's multiset
ratchet: a stage vanishing, a new stage, a changed config, or a gated
metric moving past tolerance in EITHER direction fails (counts gate
exactly: the census is exact); improvements re-baseline (``--out`` the
new artifact and commit it with the change that earned it).  The
committed baselines are ``costs_baseline_cpu.json`` (the CPU tests' gate)
and ``costs_baseline_cuda.json`` (written from the card by ``--out``,
checked by ``chip_smoke.py`` phase 25), beside this module.

    python -m m3_tpu_torch.tools.costs --device cpu --check
    python -m m3_tpu_torch.tools.costs --out costs.json        # the card
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

SCHEMA = 1
DEFAULT_TOLERANCE = 0.05
_HERE = Path(__file__).resolve().parent


def default_baseline_path(platform: str) -> Path:
    """The committed baseline of ``platform`` (``"cpu"`` or ``"cuda"``)."""
    return _HERE / f"costs_baseline_{platform}.json"


def membudget_arena_cases() -> list:
    """The (name, init_fn(device), formula_fn) case table at the
    canonical shapes: the one home of the arena rows."""
    from m3_tpu_torch.aggregator import arena, packed
    from m3_tpu_torch.x import costwatch, membudget

    W, C = costwatch.CANONICAL["W"], costwatch.CANONICAL["C"]
    SCAP = costwatch.CANONICAL["SCAP"]
    return [
        ("counter/f64", lambda d: arena.counter_init(W, C, device=d),
         lambda: membudget.counter_arena_bytes("f64", W, C)),
        ("gauge/f64", lambda d: arena.gauge_init(W, C, device=d),
         lambda: membudget.gauge_arena_bytes("f64", W, C)),
        ("timer/f64", lambda d: arena.timer_init(W, C, SCAP, device=d),
         lambda: membudget.timer_arena_bytes("f64", W, C, SCAP)),
        ("counter/packed", lambda d: packed.counter_init(W, C, device=d),
         lambda: membudget.counter_arena_bytes("packed", W, C)),
        ("gauge/packed", lambda d: packed.gauge_init(W, C, device=d),
         lambda: membudget.gauge_arena_bytes("packed", W, C)),
        ("timer/packed", lambda d: packed.timer_init(W, C, SCAP, device=d),
         lambda: membudget.timer_arena_bytes("packed", W, C, SCAP)),
    ]


def _row(formula: int, actual: int, how: str) -> dict:
    return {"formula_bytes": int(formula), "actual_bytes": int(actual), "actual": how,
            "ratio": round(formula / max(actual, 1), 4)}


def _arena_rows(dev) -> dict:
    import torch

    from m3_tpu_torch.x import costwatch

    out = {}
    for name, initfn, formula_fn in membudget_arena_cases():
        if dev.type == "cuda":
            with costwatch.quiet_heap():
                torch.cuda.synchronize(dev)
                base = torch.cuda.memory_allocated(dev)
                st = initfn(dev)
                torch.cuda.synchronize(dev)
                grown = torch.cuda.memory_allocated(dev) - base
            out[name] = _row(formula_fn(), grown, "memory_allocated growth over the init")
        else:
            st = initfn(dev)
            out[name] = _row(formula_fn(), costwatch._distinct_bytes(costwatch._tensors(st)),
                             "state tensors' nbytes")
        del st
    return out


def _codec_rows(stage_fps: dict, dev) -> dict:
    """Codec-formula rows from the stages' fingerprints (no extra run)."""
    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.x import membudget

    tbl = mt._VALUE_CTRL_TBL.size * 4  # the resident table, not the pass's
    out = {}
    for stage in ("decode/fused", "decode/gather", "encode"):
        fp = stage_fps.get(stage)
        if fp is None:
            continue
        cfg, mem = fp["config"], fp["memory"]
        if stage == "encode":
            parts = membudget.encode_lane_parts(cfg["S"], cfg["T"], cfg["out_words"])
            args = mem["argument_bytes"]
        else:
            parts = membudget.decode_lane_parts(cfg["S"], cfg["stream_words"],
                                                cfg["max_points"], cfg["chains"])
            args = mem["argument_bytes"] - tbl
        if mem["peak_bytes"] is not None:
            out[stage] = _row(sum(parts.values()), args + mem["peak_bytes"],
                              "argument bytes + max_memory_allocated growth over the run")
        else:
            out[stage] = _row(parts["args"] + parts["out"], args + mem["output_bytes"],
                              "counted argument + output bytes, against the formula's "
                              "argument + output part")
    return out


def membudget_crosscheck(stage_fps: dict, device=None) -> dict:
    """Every formula against its actual at the canonical shapes (see the
    module docstring); the contract is pinned by the tests and held by
    phase 25 on the card."""
    from m3_tpu_torch import resolve_device

    dev = resolve_device(device)
    return {"arena": _arena_rows(dev), "codec": _codec_rows(stage_fps, dev),
            "contract": "formula >= actual and <= 2x actual at the canonical shapes"}


def build_artifact(stage_names=None, device=None, log=None) -> dict:
    """Run the registry on ``device`` (None = CUDA) and assemble the COSTS
    document."""
    from m3_tpu_torch import resolve_device
    from m3_tpu_torch.x import costwatch

    dev = resolve_device(device)

    def on_stage(name, seconds):
        if log is not None:
            log(f"costs: {name} counted in {seconds:.1f} s")

    stages = costwatch.run_stages(stage_names, dev, on_stage=on_stage)
    artifact = {
        "artifact": "COSTS",
        "schema": SCHEMA,
        "generated_by": "python -m m3_tpu_torch.tools.costs",
        "config": dict(costwatch.platform_config(dev), canonical={
            k: (list(v) if isinstance(v, tuple) else v)
            for k, v in costwatch.CANONICAL.items()}),
        "stages": stages,
        "opsdp_crosscheck": costwatch.step_ops_crosscheck(stages, dev),
    }
    if stage_names is None:
        artifact["membudget_crosscheck"] = membudget_crosscheck(stages, dev)
    return artifact


def stage_kernel_violations(artifact: dict) -> list:
    """Stages whose launched hand kernels differ from
    ``costwatch.STAGE_KERNELS`` (on the CPU every stage launches none)."""
    from m3_tpu_torch.x import costwatch

    cuda = artifact["config"]["platform"] == "cuda"
    out = []
    for name, fp in artifact["stages"].items():
        want = set(costwatch.STAGE_KERNELS.get(name, ())) if cuda else set()
        got = {k for k, v in fp["kernels"].items() if v["launches"]}
        if got != want:
            out.append(f"{name}: launched {sorted(got)}, the table says {sorted(want)}")
    return out


# ---------------------------------------------------------------------------
# The ratchet
# ---------------------------------------------------------------------------


def _metric(fp: dict, path: str):
    cur = fp
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


_PINNED = (  # (config key, violation kind, what moves it legitimately)
    ("platform", "platform", "a card artifact checked against the CPU baseline is a "
     "head-to-head, not a regression"),
    ("device_name", "device", "another card runs other kernels' shapes; keep one "
     "baseline a card"),
    ("torch", "torch-version", "a torch upgrade moves dispatches legitimately; "
     "re-baseline (--out) in a change of its own"),
    ("cuda", "cuda-version", "a CUDA upgrade moves the card's numbers legitimately; "
     "re-baseline (--out) in a change of its own"),
)


def check_artifact(artifact: dict, baseline: dict,
                   tolerance: float = DEFAULT_TOLERANCE) -> list:
    """Multiset ratchet: violations as structured dicts (empty = pass).

    Refuses to compare across schema, platform, device name, torch or
    CUDA version, or canonical geometry; a stage vanishing, appearing or
    changing its pinned config fails; every gated metric must stay
    within ±tolerance of the baseline (the exact metrics within 0) —
    shrinkage past it is a REAL improvement that must re-baseline."""
    from m3_tpu_torch.x import costwatch

    errs: list = []

    def err(kind, msg, **extra):
        errs.append(dict({"kind": kind, "message": msg}, **extra))

    if baseline.get("schema") != artifact.get("schema"):
        err("schema", f"schema mismatch: baseline {baseline.get('schema')} vs current "
            f"{artifact.get('schema')} — regenerate the baseline")
        return errs
    bcfg, ccfg = baseline.get("config", {}), artifact.get("config", {})
    for key, kind, why in _PINNED:
        if bcfg.get(key) != ccfg.get(key):
            err(kind, f"{key} mismatch: baseline {bcfg.get(key)!r} vs current "
                f"{ccfg.get(key)!r} — {why}")
            return errs
    if bcfg.get("canonical") != ccfg.get("canonical"):
        err("config", f"canonical geometry changed: baseline {bcfg.get('canonical')} vs "
            f"current {ccfg.get('canonical')} — the registry's pinned shapes moved; "
            "re-baseline deliberately")
        return errs

    base_stages = baseline.get("stages", {})
    cur_stages = artifact.get("stages", {})
    for name in base_stages:
        if name not in cur_stages:
            err("stage-vanished", f"{name}: stage present in baseline but not produced "
                "by the registry — a deleted stage must re-baseline", stage=name)
    for name in cur_stages:
        if name not in base_stages:
            err("stage-new", f"{name}: stage not in baseline — a new registered stage "
                "must re-baseline", stage=name)
    for name, cur in sorted(cur_stages.items()):
        base = base_stages.get(name)
        if base is None:
            continue
        if base.get("config") != cur.get("config"):
            err("config", f"{name}: pinned config changed ({base.get('config')} -> "
                f"{cur.get('config')}) — canonical shapes moved; re-baseline "
                "deliberately", stage=name)
            continue
        for metric in costwatch.GATED_METRICS:
            b = _metric(base, metric)
            c = _metric(cur, metric)
            if b is None and c is None:
                continue
            b = b or 0
            c = c or 0
            if b == c:
                continue
            tol = 0.0 if metric in costwatch.EXACT_METRICS else tolerance
            if b == 0:
                err("regression", f"{name}: {metric} appeared (0 -> {c})", stage=name,
                    metric=metric, baseline=b, current=c)
                continue
            ratio = c / b
            if ratio > 1.0 + tol:
                err("regression", f"{name}: {metric} regressed {b} -> {c} "
                    f"({ratio:.4f}x, tolerance +{tol:.0%})", stage=name, metric=metric,
                    baseline=b, current=c, ratio=round(ratio, 4))
            elif ratio < 1.0 - tol:
                err("improvement", f"{name}: {metric} improved {b} -> {c} "
                    f"({ratio:.4f}x) — past tolerance; commit the win: --out and "
                    "re-baseline", stage=name, metric=metric, baseline=b, current=c,
                    ratio=round(ratio, 4))
    return errs


def check_against_baseline(artifact: dict, baseline_path,
                           tolerance: float = DEFAULT_TOLERANCE) -> list:
    base = json.loads(Path(baseline_path).read_text())
    return check_artifact(artifact, base, tolerance=tolerance)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default)")
    ap.add_argument("--stage", action="append", help="only this stage (repeatable)")
    ap.add_argument("--check", nargs="?", const="", default=None,
                    help="ratchet against BASELINE (default: the committed one)")
    ap.add_argument("--out", default=None, help="write the artifact here")
    ap.add_argument("--json", action="store_true", help="one JSON report line")
    args = ap.parse_args(argv)
    from m3_tpu_torch import resolve_device

    dev = resolve_device(args.device)
    base_path = None
    if args.check is not None:
        base_path = Path(args.check) if args.check else default_baseline_path(dev.type)
        if not base_path.exists():
            print(f"costs: no baseline at {base_path}", file=sys.stderr)
            return 2
    log = None if args.json else (lambda m: print(m, file=sys.stderr))
    art = build_artifact(args.stage, dev, log=log)
    if args.out:
        Path(args.out).write_text(json.dumps(art, indent=1, sort_keys=True) + "\n")
    viol = [] if base_path is None else check_against_baseline(art, base_path)
    viol += [{"kind": "kernels", "message": m} for m in stage_kernel_violations(art)]
    report = {"ok": not viol, "stages": len(art["stages"]), "violations": viol}
    if args.json:
        print(json.dumps(report))
    else:
        for v in viol:
            print(v["message"])
        print(f"costs: {len(art['stages'])} stages, {len(viol)} violations")
    return 0 if not viol else 1


if __name__ == "__main__":
    sys.exit(main())
