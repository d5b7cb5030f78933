"""Rule family 5 — resource hygiene (``resource-hygiene``).

The port's copy of ``m3_tpu/x/lint/resources.py``: the same logic, over the port's
paths (``core.Context``).

Sockets and files opened and then *worked on* before anyone owns their
cleanup: if a statement between the open and the ownership transfer
raises, the handle leaks (the ``create_connection`` → ``setsockopt`` →
raise shape in the wire clients, where a failed HELLO leaks the
half-constructed socket until GC).

The model flags ``x = open(...)`` / ``x = socket.create_connection(...)``
/ ``x = socket.socket(...)`` assignments where:

* the value is not consumed by a ``with`` statement, and
* further fallible statements follow in the same block before the
  function ends (anything but a bare ``return``/``return x``/``pass``),
  and
* no ``try`` in the function closes the handle in an ``except`` or
  ``finally`` (``x.close()`` — including via the attribute the handle
  was stored to), and
* the target is not a plain ``self.<attr>`` store outside ``__init__``
  (a constructed object owns its handle via its ``close()``; in
  ``__init__`` the object may never finish existing, so the store does
  NOT transfer ownership yet).

``setattr(self, <name>, x)`` immediately after the open counts as a
self store (the fileset mmap-init idiom).
"""

from __future__ import annotations

import ast
from typing import List

from m3_tpu_torch.x.lint.core import Context, FileUnit, Finding, dotted

_OPENERS = {"open", "socket.socket", "socket.create_connection",
            "socket.socketpair",
            # the shared wire dial helper (msg/protocol.connect) hands
            # back a live socket — call sites carry the same close duty
            "connect", "wire.connect", "protocol.connect", "wire_connect"}


def _is_open_call(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and dotted(node.func) in _OPENERS


def _target_names(target: ast.AST):
    """('local', name) / ('self', attr) / None."""
    if isinstance(target, ast.Name):
        return ("local", target.id)
    if (isinstance(target, ast.Attribute)
            and isinstance(target.value, ast.Name)
            and target.value.id == "self"):
        return ("self", target.attr)
    return None


def _closes(fn: ast.AST, kind: str, name: str) -> bool:
    """Does any except/finally in the function close the handle?"""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Try):
            continue
        cleanup = list(node.finalbody)
        for h in node.handlers:
            cleanup.extend(h.body)
        for stmt in cleanup:
            for sub in ast.walk(stmt):
                if (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr == "close"):
                    owner = _target_names(sub.func.value)
                    if owner == (kind, name):
                        return True
    return False


def _transfers(stmt: ast.AST, name: str) -> bool:
    """The handle's ownership moves somewhere with a close() duty:
    returned to the caller, assigned to ``self``/another binding, or
    ``setattr(self, ..., x)`` (the fileset mmap-init idiom)."""
    if isinstance(stmt, ast.Return):
        return (isinstance(stmt.value, ast.Name)
                and stmt.value.id == name)
    if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Name):
        return stmt.value.id == name
    if (isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call)
            and dotted(stmt.value.func) == "setattr"):
        args = stmt.value.args
        return (len(args) == 3 and isinstance(args[0], ast.Name)
                and args[0].id == "self"
                and isinstance(args[2], ast.Name) and args[2].id == name)
    return False


def _tail_leaks(tail, name: str) -> bool:
    """Walk the statements after the open in order: the first transfer
    ends the at-risk window safely; any other fallible statement before
    a transfer is the leak window."""
    for stmt in tail:
        if _transfers(stmt, name):
            return False
        if isinstance(stmt, (ast.Pass, ast.Return)):
            continue  # bare return: refcount closes the local
        return True
    return False


def _scan_block(body, fn, in_init: bool, unit, findings):
    for i, stmt in enumerate(body):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue  # nested defs are scanned as their own fn
        if isinstance(stmt, ast.Assign) and _is_open_call(stmt.value):
            tgt = _target_names(stmt.targets[0]) if len(stmt.targets) == 1 else None
            if tgt is not None:
                kind, name = tgt
                if kind == "self" and not in_init:
                    pass  # long-lived member; close() owns it
                elif not _tail_leaks(body[i + 1:], name):
                    pass
                elif _closes(fn, kind, name):
                    pass
                else:
                    what = ("file" if dotted(stmt.value.func) == "open"
                            else "socket")
                    findings.append(Finding(
                        "resource-hygiene", unit.path, stmt.lineno,
                        f"{what} opened in {fn.name}() leaks if a later "
                        f"statement raises — wrap in try/finally (close "
                        f"on error) or a context manager"))
        # recurse into nested blocks (if/for/while/with/try bodies)
        for attr in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, attr, None)
            if sub:
                _scan_block(sub, fn, in_init, unit, findings)
        for h in getattr(stmt, "handlers", ()):
            _scan_block(h.body, fn, in_init, unit, findings)


def check(unit: FileUnit, ctx: Context) -> List[Finding]:
    findings: List[Finding] = []
    for fn in [n for n in ast.walk(unit.tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
        in_init = fn.name == "__init__"
        _scan_block(fn.body, fn, in_init, unit, findings)
    return findings


EXPLAIN = {
    "resource-hygiene": {
        "why": (
            "A socket/file opened with no owner on the error path leaks "
            "on every exception between open and the first close — "
            "under retry storms that exhausts fds exactly when the "
            "system is least able to afford it."),
        "bad": ("s = socket.create_connection(addr)\n"
                "s.sendall(hello)                 # raises -> s leaks\n"),
        "good": ("s = socket.create_connection(addr)\n"
                 "try:\n"
                 "    s.sendall(hello)\n"
                 "except BaseException:\n"
                 "    s.close()\n"
                 "    raise\n"),
    },
}
