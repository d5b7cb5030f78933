"""Rule family 8 — placement CAS discipline (``placement-cas``).

The port's copy of ``m3_tpu/x/lint/placement.py``: the same logic, over the port's
paths (``core.Context``).

The topology PR's invariant, made permanent: every mutation of the
placement KV key must go through ``cluster.placement.PlacementService``
(whose ``update()`` is a get→mutate→CAS loop with bounded
version-conflict retry).  A raw ``kv.set("placement", ...)`` added next
quarter would blow straight past concurrent admin mutations AND the
node-side ``mark_available`` cutover CAS — a lost placement update is a
cluster that silently believes two different topologies.  This rule
turns that regression into a gate failure.

A call is flagged when BOTH hold:

* the callee is a ``set`` / ``set_if_not_exists`` / ``check_and_set``
  attribute call (any receiver — ``kv.set``, ``self.kv.check_and_set``,
  ``store.set_if_not_exists``...);
* its first positional argument is the string literal ``"placement"``
  (or an f-string/concat containing it as a fragment — key-prefix
  schemes must not dodge the rule).

``delete`` is deliberately legal: deleting the key is the operator's
reset verb (admin DELETE /placement), not a lost-update hazard.  Files
under ``Context.placement_files`` (the PlacementService home) are
exempt — that IS the blessed mutation path.
"""

from __future__ import annotations

import ast
from typing import List

from m3_tpu_torch.x.lint.core import Context, FileUnit, Finding

_MUTATORS = {"set", "set_if_not_exists", "check_and_set"}


def _string_fragments(node: ast.AST):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            yield sub.value


def _names_placement_key(arg: ast.AST) -> bool:
    return any(s == "placement" or s.startswith("placement/")
               for s in _string_fragments(arg))


def check(unit: FileUnit, ctx: Context) -> List[Finding]:
    if unit.path in ctx.placement_files:
        return []
    findings: List[Finding] = []
    for node in ast.walk(unit.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if not (isinstance(fn, ast.Attribute) and fn.attr in _MUTATORS):
            continue
        if not node.args or not _names_placement_key(node.args[0]):
            continue
        findings.append(Finding(
            "placement-cas", unit.path, node.lineno,
            f"raw kv.{fn.attr} of the placement key — go through "
            "cluster.placement.PlacementService (update() for the "
            "CAS-retried get→mutate→set) so concurrent mutations and "
            "node cutovers serialize"))
    return findings


EXPLAIN = {
    "placement-cas": {
        "why": (
            "Raw kv.set/check_and_set of the placement key outside "
            "cluster/placement.py bypasses PlacementService's CAS "
            "retry loop — a concurrent admin edit racing a node "
            "cutover loses one of the writes and the cluster's shard "
            "map forks."),
        "bad": "kv.set(PLACEMENT_KEY, blob)      # clobbers concurrent CAS\n",
        "good": "PlacementService(kv).update(mutate_fn)  # serialized CAS\n",
    },
}
