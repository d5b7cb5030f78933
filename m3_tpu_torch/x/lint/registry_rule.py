"""Rule family 16 — device-program registry completeness
(``registry-complete``), over the port's registries.  The counterpart of
``m3_tpu/x/lint/registry_rule.py``.

Three registries must describe the same set of device programs: the
``x.devguard`` entry points (``run_guarded``/``transfer_point`` stage
names: fault classification and breakers), the ``x.membudget``
footprint components (admission before allocation), and the
``x.costwatch`` stage registry (the census gate of ``tools/costs`` and
``x/irlint``).  A program present in one but missing from another is a
coverage hole nothing else detects: a guarded stage with no costwatch
row is invisible to both gates, a budgeted component with no guard
fails untyped, a costwatch family with no budget is unadmitted memory.

The agreement is declared ONCE, in :data:`FAMILIES`, and checked per
file:

* a ``run_guarded("X", ...)`` / ``transfer_point("X")`` literal whose
  stage no family declares is a finding;
* a ``membudget.reserve("X", ...)`` / ``membudget.transient("X", ...)``
  literal (or the arenas' ``self._alloc("X", ...)``, their
  reserve-then-allocate helper) whose component no family declares is a
  finding;
* in the costwatch file, a ``Stage("...")`` no family's cost prefix
  covers is a finding (a prefix ``p/`` covers ``p`` itself and every
  ``p/...``; the port's encode stage is ``encode``), and the inverse: a
  family whose cost prefixes match no Stage, or that has neither a cost
  leg nor a reviewed ``cost_waiver``, is a finding;
* in each family's home files, every declared guard and membudget
  component must appear as a literal (the table drifting from the code
  is itself the bug).

The gap this rule finds in the port is the reference's: the buffer
family has no costwatch stage.  It is recorded as a reviewed
``cost_waiver`` with its reason, as the reference records it.
"""

from __future__ import annotations

import ast
from typing import Dict, List

from m3_tpu_torch.x.lint.core import Context, FileUnit, Finding, dotted

# The one declaration of "these three registries agree".  Each family
# names its devguard stages, membudget components, costwatch stage-name
# prefixes, and the home files where the guard/membudget literals live.
# ``cost_waiver`` documents a REVIEWED absence of a cost leg — without
# it, a family with no costwatch coverage is a finding.
FAMILIES: Dict[str, dict] = {
    "codec.decode": {
        "guards": ("decode",),
        "guard_files": ("m3_tpu_torch/encoding/m3tsz_torch.py",),
        "membudget": ("decode.lanes", "decode.ctrl_table"),
        "membudget_files": ("m3_tpu_torch/encoding/m3tsz_torch.py",),
        "cost_prefixes": ("decode/",),
    },
    "codec.encode": {
        "guards": ("encode",),
        "guard_files": ("m3_tpu_torch/encoding/m3tsz_torch.py",),
        "membudget": ("encode.lanes",),
        "membudget_files": ("m3_tpu_torch/encoding/m3tsz_torch.py",),
        "cost_prefixes": ("encode/",),
    },
    "arena": {
        "guards": ("arena.ingest", "arena.consume"),
        "guard_files": ("m3_tpu_torch/aggregator/arena.py",),
        "membudget": ("aggregator.counter", "aggregator.gauge",
                      "aggregator.timer"),
        "membudget_files": ("m3_tpu_torch/aggregator/arena.py",),
        "cost_prefixes": ("arena/", "timer/"),
    },
    "buffer": {
        "guards": ("storage.buffer_append", "storage.buffer_drain"),
        "guard_files": ("m3_tpu_torch/storage/buffer.py",),
        "membudget": ("storage.buffer",),
        "membudget_files": ("m3_tpu_torch/storage/buffer.py",),
        "cost_prefixes": (),
        "cost_waiver": (
            "the costwatch registry is the reference's stage set, which has "
            "no buffer stage; the buffer's programs run at node-configured "
            "ring shapes, so a pinned-shape buffer stage is new registry "
            "work (ROADMAP Queue A), not a port of an existing one"),
    },
}

_GUARD_CALLS = {"devguard.run_guarded", "run_guarded",
                "devguard.transfer_point", "transfer_point"}
_BUDGET_CALLS = {"membudget.reserve", "membudget.transient", "self._alloc"}


def _declared(field: str) -> set:
    out: set = set()
    for fam in FAMILIES.values():
        out.update(fam.get(field, ()))
    return out


def _covers(prefix: str, stage: str) -> bool:
    """A cost prefix ``p/`` covers the stage ``p`` and every ``p/...``."""
    return stage == prefix.rstrip("/") or stage.startswith(prefix)


def _str_arg0(node: ast.Call):
    if node.args and isinstance(node.args[0], ast.Constant) \
            and isinstance(node.args[0].value, str):
        return node.args[0].value
    return None


def check(unit: FileUnit, ctx: Context) -> List[Finding]:
    cost_file = ctx.registry_cost_file
    prefixes = ctx.registry_prefixes
    in_scope = any(unit.path.startswith(p) for p in prefixes)
    is_cost_file = unit.path == cost_file
    is_home = any(
        unit.path in fam.get("guard_files", ())
        or unit.path in fam.get("membudget_files", ())
        for fam in FAMILIES.values())
    if not (in_scope or is_cost_file or is_home):
        return []

    findings: List[Finding] = []
    guards = _declared("guards")
    budgets = _declared("membudget")
    cost_prefixes = _declared("cost_prefixes")
    seen_guards: set = set()
    seen_budgets: set = set()
    stage_names: List[tuple] = []

    for node in ast.walk(unit.tree):
        if not isinstance(node, ast.Call):
            continue
        callee = dotted(node.func)
        lit = _str_arg0(node)
        if lit is None:
            continue
        if callee in _GUARD_CALLS:
            seen_guards.add(lit)
            if in_scope and lit not in guards:
                findings.append(Finding(
                    "registry-complete", unit.path, node.lineno,
                    f"device entry point '{lit}' is not declared by any "
                    "registry family — a guarded stage outside "
                    "registry_rule.FAMILIES has no membudget/costwatch "
                    "cross-check (declare it, with its budget and cost "
                    "legs, or it is a coverage hole)"))
        elif callee in _BUDGET_CALLS:
            seen_budgets.add(lit)
            if in_scope and lit not in budgets:
                findings.append(Finding(
                    "registry-complete", unit.path, node.lineno,
                    f"membudget component '{lit}' is not declared by any "
                    "registry family — a budgeted footprint outside "
                    "registry_rule.FAMILIES has no devguard/costwatch "
                    "cross-check"))
        elif callee == "Stage" and is_cost_file:
            stage_names.append((lit, node.lineno))
            prefix = lit.split("/", 1)[0] + "/"
            if prefix not in cost_prefixes:
                findings.append(Finding(
                    "registry-complete", unit.path, node.lineno,
                    f"costwatch stage '{lit}' has prefix '{prefix}' no "
                    "registry family covers — a fingerprinted program "
                    "with no devguard/membudget family is a coverage "
                    "hole"))

    # table -> code direction: every declared name must exist in its
    # declared home file (the table drifting from the code is the bug)
    for fam_name, fam in sorted(FAMILIES.items()):
        if unit.path in fam.get("guard_files", ()):
            for g in fam["guards"]:
                if g not in seen_guards:
                    findings.append(Finding(
                        "registry-complete", unit.path, 1,
                        f"family '{fam_name}' declares device entry "
                        f"point '{g}' in this file but no run_guarded/"
                        "transfer_point literal registers it"))
        if unit.path in fam.get("membudget_files", ()):
            for b in fam["membudget"]:
                if b not in seen_budgets:
                    findings.append(Finding(
                        "registry-complete", unit.path, 1,
                        f"family '{fam_name}' declares membudget "
                        f"component '{b}' in this file but no "
                        "membudget.reserve/transient literal registers "
                        "it"))
        if is_cost_file:
            covered = [s for s, _ in stage_names
                       if any(_covers(p, s)
                              for p in fam.get("cost_prefixes", ()))]
            for p in fam.get("cost_prefixes", ()):
                if not any(_covers(p, s) for s, _ in stage_names):
                    findings.append(Finding(
                        "registry-complete", unit.path, 1,
                        f"family '{fam_name}' declares costwatch prefix "
                        f"'{p}' but the registry has no such stage"))
            if not fam.get("cost_prefixes") and not covered \
                    and not fam.get("cost_waiver"):
                findings.append(Finding(
                    "registry-complete", unit.path, 1,
                    f"family '{fam_name}' has no costwatch leg and no "
                    "reviewed cost_waiver — its device programs are "
                    "invisible to the costs and irlint gates"))
    return findings


EXPLAIN = {
    "registry-complete": {
        "why": (
            "Three registries must describe the same device programs: "
            "x.devguard entry points (fault classification + "
            "breakers), x.membudget components (device-memory admission), and "
            "the x.costwatch stage registry (the costs/irlint census "
            "gates).  A program present in one but missing from "
            "another is a hole nothing else detects — a guarded stage "
            "with no costwatch row dodges both IR gates; a budgeted "
            "component with no guard OOMs untyped.  The agreement is "
            "declared once (registry_rule.FAMILIES) and cross-checked "
            "per file in both directions; a family with no cost leg "
            "must carry a reviewed cost_waiver."),
        "bad": ("devguard.run_guarded(\"rollup.flush\", primary)  "
                "# stage not in any FAMILIES entry\n"),
        "good": ("devguard.run_guarded(\"encode\", primary)  # a stage "
                 "FAMILIES declares, with its membudget and costwatch legs\n"),
    },
}
