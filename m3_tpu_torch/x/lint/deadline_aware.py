"""Rule family 9 — query-path deadline coverage (``deadline-aware``).

The port's copy of ``m3_tpu/x/lint/deadline_aware.py``: the same logic, over the port's
paths (``core.Context``).

The read-side twin of the ``fault-coverage`` rule: the query path's
overload contract says every blocking wire primitive reachable
from a query — ``send_frame``/``recv_frame``/``connect`` in
``query/remote.py``, the ``server/rpc.py`` client classes, and the
``client/session.py`` read path — must flow through a
deadline-accepting helper, so a slow peer can never hold a query past
its budget.  A bare ``recv_frame`` added later would be a wire
hop the deadline cannot bound — this rule makes that a gate failure,
not a review catch.

A function is **deadline-aware** when it visibly threads the budget:

* it calls into the deadline module (any dotted callee containing
  ``deadline`` — ``xdeadline.socket_timeout``, ``deadline.current``,
  ``xdeadline.check_current``, ``xdeadline.bind`` ...), or
* it calls a deadline-budget method (``.remaining()`` /
  ``.remaining_ms()`` / ``.socket_timeout()``) on some object, or
* it takes the deadline explicitly (a parameter named ``deadline`` or
  ``dl``).

Scope: files listed in ``Context.deadline_files`` (plus
``deadline_prefixes`` so the seeded corpus can opt in wholesale).
Server-side frame loops satisfy the rule naturally — they decode and
bind the frame's deadline trailer, which is exactly the awareness the
rule wants to see.
"""

from __future__ import annotations

import ast
from typing import List

from m3_tpu_torch.x.lint.core import Context, FileUnit, Finding, dotted

# blocking wire primitives, matched by final dotted component
_BLOCKING = {"send_frame": "frame send", "recv_frame": "frame recv",
             "connect": "dial", "wire_connect": "dial"}
# budget-deriving attribute calls that mark a function deadline-aware
_BUDGET_ATTRS = {"remaining", "remaining_ms", "socket_timeout"}
_DEADLINE_PARAMS = {"deadline", "dl"}


def _applies(path: str, ctx: Context) -> bool:
    return (path in ctx.deadline_files
            or any(path.startswith(p) for p in ctx.deadline_prefixes))


def _is_aware(fn: ast.AST) -> bool:
    args = getattr(fn, "args", None)
    if args is not None:
        names = [a.arg for a in (args.posonlyargs + args.args
                                 + args.kwonlyargs)]
        if any(n in _DEADLINE_PARAMS for n in names):
            return True
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        callee = dotted(node.func) or ""
        if "deadline" in callee:
            return True
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _BUDGET_ATTRS):
            return True
    return False


def check(unit: FileUnit, ctx: Context) -> List[Finding]:
    if not _applies(unit.path, ctx):
        return []
    findings: List[Finding] = []
    funcs = [n for n in ast.walk(unit.tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    aware = {id(fn) for fn in funcs if _is_aware(fn)}
    # innermost enclosing function per call (nested defs walk later and
    # overwrite their enclosing def — same trick as fault-coverage)
    enclosing: dict = {}
    for fn in funcs:
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                enclosing[id(node)] = fn
    for node in ast.walk(unit.tree):
        if not isinstance(node, ast.Call):
            continue
        callee = dotted(node.func) or ""
        leaf = callee.rpartition(".")[2]
        what = _BLOCKING.get(leaf)
        if what is None:
            continue
        fn = enclosing.get(id(node))
        if fn is not None and id(fn) in aware:
            continue
        where = f"{fn.name}()" if fn is not None else "module level"
        findings.append(Finding(
            "deadline-aware", unit.path, node.lineno,
            f"blocking {what} ({leaf}) in {where} without deadline "
            f"plumbing — query-path wire I/O must derive its timeout "
            f"from x.deadline"))
    return findings


EXPLAIN = {
    "deadline-aware": {
        "why": (
            "Blocking send_frame/recv_frame/connect in query-path "
            "modules must derive their socket timeouts from the "
            "riding x.deadline budget: a wire hop that blocks on its "
            "own 30s constant keeps burning a peer's time long after "
            "the caller's deadline expired (the overload contract: "
            "spent budget maps to 504, not a wedged worker)."),
        "bad": "frame = recv_frame(sock)         # blocks past the deadline\n",
        "good": ("sock.settimeout(deadline.current().socket_timeout())\n"
                 "frame = recv_frame(sock)\n"),
    },
}
