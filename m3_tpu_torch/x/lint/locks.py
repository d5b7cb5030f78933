"""Rule family 1 — lock discipline (``lock-discipline``).

The port's copy of ``m3_tpu/x/lint/locks.py``: the same logic, over the port's
paths (``core.Context``).

Static model of the race class ``tests/test_race.py`` stress-tests at
runtime: per class, which ``self._*`` attributes are accessed under
``with self.<lock>`` and which are written outside any lock.

Two triggers:

* **mixed access** — an attribute touched (read or written) under a
  lock block somewhere in the class is WRITTEN outside any lock block
  in another method.  This is exactly the ``IngestServer._closing``
  shape: the shed gate reads it under ``_q_lock`` while shutdown
  assigns it bare, so a handler can miss the closing edge.
* **unguarded read-modify-write** — ``self.x += ...`` outside any lock
  block, in a class that owns locks.  ``+=`` on an attribute is a
  load/op/store triple in CPython; two threads interleave and one
  increment vanishes (the flush-stats counter shape).

``__init__`` is exempt (single-threaded construction), as are the lock
attributes themselves.  Lock attributes are recognized both by
construction (``self.x = threading.Lock()``/``RLock()``) and by name
(``*lock``, ``*mutex``, ``_mu``/``_wmu``-style).
"""

from __future__ import annotations

import ast
import re
from typing import List

from m3_tpu_torch.x.lint.core import Context, FileUnit, Finding, dotted

_LOCK_NAME_RE = re.compile(r"(lock|mutex)$|^_?w?mu$")
_INIT_METHODS = {"__init__", "__new__", "__post_init__"}


def _lock_attrs(cls: ast.ClassDef) -> set:
    """self attributes that hold locks: constructed as threading locks
    anywhere in the class, or named like one."""
    attrs = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            callee = dotted(node.value.func) or ""
            if callee in ("threading.Lock", "threading.RLock", "Lock",
                          "RLock", "threading.Condition", "Condition"):
                for t in node.targets:
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        attrs.add(t.attr)
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
            if node.value.id == "self" and _LOCK_NAME_RE.search(node.attr):
                attrs.add(node.attr)
    return attrs


class _Access:
    __slots__ = ("attr", "write", "aug", "guarded", "line", "method")

    def __init__(self, attr, write, aug, guarded, line, method):
        self.attr = attr
        self.write = write
        self.aug = aug
        self.guarded = guarded
        self.line = line
        self.method = method


def _is_lock_guard(item: ast.withitem, lock_attrs: set) -> bool:
    """``with self.<lockattr>:`` (or ``cls_obj.<lockattr>``) — any
    with-statement over a lock-named attribute counts as a guard."""
    expr = item.context_expr
    if isinstance(expr, ast.Attribute):
        if expr.attr in lock_attrs or _LOCK_NAME_RE.search(expr.attr):
            return True
    if isinstance(expr, ast.Name) and _LOCK_NAME_RE.search(expr.id):
        return True
    # fault.armed(...)/lock.acquire() style guards are not lock scopes
    return False


def _collect(method: ast.FunctionDef, lock_attrs: set, out: List[_Access]):
    def visit(node: ast.AST, guarded: bool):
        if isinstance(node, ast.With):
            g = guarded or any(_is_lock_guard(i, lock_attrs)
                               for i in node.items)
            for child in node.body:
                visit(child, g)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested defs (callbacks, closures) run on unknown threads
            # at unknown times — analyze them as unguarded scopes
            for child in node.body:
                visit(child, False)
            return
        if isinstance(node, ast.Assign):
            for t in node.targets:
                _record(t, node, guarded, aug=False)
        elif isinstance(node, ast.AugAssign):
            _record(node.target, node, guarded, aug=True)
        elif isinstance(node, ast.Attribute):
            _record_load(node, guarded)
        for child in ast.iter_child_nodes(node):
            visit(child, guarded)

    def _record(target, stmt, guarded, aug):
        if (isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self"):
            out.append(_Access(target.attr, True, aug, guarded,
                               stmt.lineno, method.name))

    def _record_load(node, guarded):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
                and isinstance(node.ctx, ast.Load)):
            out.append(_Access(node.attr, False, False, guarded,
                               node.lineno, method.name))

    for stmt in method.body:
        visit(stmt, False)


def check(unit: FileUnit, ctx: Context) -> List[Finding]:
    findings: List[Finding] = []
    for cls in [n for n in ast.walk(unit.tree) if isinstance(n, ast.ClassDef)]:
        lock_attrs = _lock_attrs(cls)
        if not lock_attrs:
            continue
        accesses: List[_Access] = []
        for item in cls.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _collect(item, lock_attrs, accesses)
        guarded_attrs = {}
        for a in accesses:
            if a.guarded and a.attr not in lock_attrs:
                guarded_attrs.setdefault(a.attr, a)
        seen = set()
        for a in accesses:
            if (not a.write or a.guarded or a.attr in lock_attrs
                    or a.method in _INIT_METHODS):
                continue
            if a.attr in guarded_attrs:
                g = guarded_attrs[a.attr]
                msg = (f"{cls.name}.{a.attr}: written without a lock in "
                       f"{a.method}() but accessed under a lock in "
                       f"{g.method}()")
            elif a.aug:
                msg = (f"{cls.name}.{a.attr}: non-atomic augmented write "
                       f"outside any lock in {a.method}() (class owns "
                       f"locks: {', '.join(sorted(lock_attrs))})")
            else:
                continue
            dedup = (msg, a.line)
            if dedup in seen:
                continue
            seen.add(dedup)
            findings.append(Finding("lock-discipline", unit.path, a.line, msg))
    return findings


EXPLAIN = {
    "lock-discipline": {
        "why": (
            "A class that guards self._* state with a lock must guard "
            "EVERY access: one unguarded write (or read-modify-write "
            "like +=) races every guarded reader, and CPython has no "
            "-race to catch it.  Runtime twin: x/lockcheck.install() "
            "catches ordering inversions; this rule "
            "catches coverage holes."),
        "bad": ("class C:\n"
                "    def __init__(self):\n"
                "        self._lock = threading.Lock()\n"
                "        self._n = 0\n"
                "    def read(self):\n"
                "        with self._lock:\n"
                "            return self._n\n"
                "    def bump(self):\n"
                "        self._n += 1      # unguarded RMW vs guarded read\n"),
        "good": ("    def bump(self):\n"
                 "        with self._lock:\n"
                 "            self._n += 1\n"),
    },
}
