"""Rule family 15 — device-boundary guard coverage (``device-guard``),
restated for torch.  The counterpart of ``m3_tpu/x/lint/devguard_rule.py``.

Every piece of raw device work on the serving hot path — a call of a
hand-kernel wrapper, a ``.to(<device>)`` or ``.cuda()`` copy, a
``torch.cuda.synchronize()`` — in ``server/``, ``storage/`` and
``aggregator/`` must flow through the ``x.devguard`` seam
(``run_guarded``/``transfer_point``, or the arena's
``_guarded_ingest``/``_guarded_consume``/``_guarded_state_op`` helpers
built on it).  Raw device work added later is a device boundary the
fault tier cannot reach (the ``device.compile``/``device.dispatch``/
``device.transfer`` faultpoints fire inside the seam) and a failure the
per-stage breakers cannot count: a CUDA error there is a node crash
instead of a typed, counted refusal.  (The reference flags module-jitted
calls, ``device_put`` and ``block_until_ready``; these are their
counterparts.)

Mechanics, as the reference states them:

* a call is COVERED when any enclosing function — the innermost def or
  an ancestor (guarded primaries are closures passed INTO the seam) —
  calls a seam name, or when the enclosing function is reached, through
  the file's call graph (plain names and ``self.<method>`` calls), from
  a primary passed to a seam: it runs inside the guard, the counterpart
  of the reference's exemption for calls inside a jitted def, whose
  dispatch is guarded at its callers;
* ``x/`` itself (the seam's home) and ``parallel/`` (the kernels'
  modules, whose host wrappers are what the seam guards) are out of
  scope.

A ``.to(...)`` is a device copy when it names a device: ``device=``, a
string, a ``torch.device(...)``, or a name or attribute that is not a
dtype (``.to(torch.int64)`` and ``.to(I64)`` are casts, not copies).
"""

from __future__ import annotations

import ast
from typing import Dict, List

from m3_tpu_torch.x.lint.core import Context, FileUnit, Finding, dotted
from m3_tpu_torch.x.lint.purity import KERNEL_WRAPPERS
from m3_tpu_torch.x.lint.torchlint import _dtype_of

_SEAM_CALLS = {
    "devguard.run_guarded", "run_guarded",
    "devguard.transfer_point", "transfer_point",
    "_guarded_ingest", "_guarded_consume", "_guarded_state_op",
}
_DTYPE_WORDS = frozenset(("dtype", "I64", "I32", "F64", "F32", "U64", "U32"))


def _names_device(call: ast.Call) -> bool:
    """Whether a ``.to(...)`` call names a device (see the docstring)."""
    if any(k.arg == "device" for k in call.keywords):
        return True
    if not call.args:
        return False
    a = call.args[0]
    if isinstance(a, ast.Constant):
        return isinstance(a.value, str)
    if isinstance(a, ast.Call):
        return dotted(a.func) in ("torch.device",)
    d = dotted(a)
    if d is None or _dtype_of(a) is not None:
        return False
    last = d.rpartition(".")[2]
    return not (last in _DTYPE_WORDS or last.endswith("dtype")
                or d.startswith("torch.") and d != "torch.device")


def _raw(node: ast.Call) -> str | None:
    callee = dotted(node.func)
    if callee == "torch.cuda.synchronize":
        return "torch.cuda.synchronize()"
    if isinstance(node.func, ast.Attribute):
        if node.func.attr == "cuda" and callee != "torch.cuda":
            return ".cuda() copy"
        if node.func.attr == "to" and _names_device(node):
            return ".to(<device>) copy"
    name = callee.rpartition(".")[2] if callee else None
    if name in KERNEL_WRAPPERS:
        return f"hand-kernel call {name}()"
    return None


def _guarded_defs(tree: ast.AST, funcs: list) -> dict:
    """The defs and lambdas that run inside a guard, by id: the primaries
    passed to a seam (names and lambdas) and what they reach in the
    file."""
    by_name: dict = {}
    for fn in funcs:
        by_name.setdefault(fn.name, fn)
    frontier = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and dotted(node.func) in _SEAM_CALLS:
            for arg in list(node.args) + [k.value for k in node.keywords]:
                if isinstance(arg, ast.Lambda):
                    frontier.append(arg)
                elif isinstance(arg, ast.Name) and arg.id in by_name:
                    frontier.append(by_name[arg.id])
    seen: dict = {}
    while frontier:
        fn = frontier.pop()
        if id(fn) in seen:
            continue
        seen[id(fn)] = fn
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            name = (f.id if isinstance(f, ast.Name) else
                    f.attr if isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name) and f.value.id == "self"
                    else None)
            if name in by_name:
                frontier.append(by_name[name])
    return seen


def _calls_seam(fn: ast.AST) -> bool:
    return any(isinstance(n, ast.Call) and dotted(n.func) in _SEAM_CALLS
               for n in ast.walk(fn))


def check(unit: FileUnit, ctx: Context) -> List[Finding]:
    if not any(unit.path.startswith(p) for p in ctx.device_prefixes):
        return []
    if unit.path in ctx.device_helper_files:
        return []
    funcs = [n for n in ast.walk(unit.tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    # innermost enclosing def per call, and def -> parent def, so that
    # coverage flows OUTWARD (a guarded primary is a nested closure whose
    # seam call sits in the parent)
    parent: Dict[int, ast.AST] = {}
    enclosing: Dict[int, ast.AST] = {}
    for fn in funcs:
        for node in ast.walk(fn):
            if node is fn:
                continue
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                parent[id(node)] = fn  # innermost wins on later visits
            if isinstance(node, ast.Call):
                enclosing[id(node)] = fn
    guarded = _guarded_defs(unit.tree, funcs)
    fires = {id(fn) for fn in funcs if _calls_seam(fn)} | set(guarded)
    inside = {id(n) for g in guarded.values() for n in ast.walk(g)
              if isinstance(n, ast.Call)}

    def covered(fn) -> bool:
        hops = 0
        while fn is not None and hops < 64:
            if id(fn) in fires:
                return True
            fn = parent.get(id(fn))
            hops += 1
        return False

    findings: List[Finding] = []
    for node in ast.walk(unit.tree):
        if not isinstance(node, ast.Call):
            continue
        what = _raw(node)
        if what is None:
            continue
        fn = enclosing.get(id(node))
        if id(node) in inside or covered(fn):
            continue
        where = f"{fn.name}()" if fn is not None else "module level"
        findings.append(Finding(
            "device-guard", unit.path, node.lineno,
            f"raw {what} in {where} outside the devguard seam — hot-path "
            "device work must run behind x.devguard.run_guarded so device "
            "faults classify, count and stay injectable"))
    return findings


EXPLAIN = {
    "device-guard": {
        "why": (
            "A bare hand-kernel call, device copy or synchronize on the "
            "serving hot path is a device boundary the fault tier cannot "
            "reach and the per-stage breakers cannot count: a CUDA error "
            "or an out-of-memory there is a node crash and a lost ack "
            "instead of a typed, counted refusal (x/devguard.py)."),
        "bad": "self.state = buffer_append(self.state, rows.to(self.device))\n",
        "good": ("self.state = devguard.run_guarded(\"storage.buffer_append\",\n"
                 "    lambda: buffer_append(self.state, rows.to(self.device)))\n"),
    },
}
