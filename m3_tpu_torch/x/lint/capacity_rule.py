"""Rule family 18 — typed disk-capacity errors (``enospc-typed``).

The port's copy of ``m3_tpu/x/lint/capacity_rule.py``: the same logic, over the port's
paths (``core.Context``).

The disk-pressure round's invariant, made permanent (corruption-typed's
pattern, one seam over): a full disk must surface as
:class:`m3_tpu_torch.persist.capacity.DiskCapacityError`, never as a raw
``OSError`` that kills the flush/tick/drain that hit it.  The
classification lives in ONE place — ``capacity_guard`` — which also
unlinks atomic-write temp files on the error path and feeds the
``disk_capacity_errors_total`` counters; a durable write op added next
quarter outside the guard would silently reopen the raw-ENOSPC hole at
exactly the site most likely to fire under pressure.

Two triggers, scoped to the capacity modules (``persist/`` plus the
aggregator checkpoint; ``persist/capacity.py`` itself is the blessed
helper and exempt):

* a *durable write op* — ``os.fsync`` / ``os.fdatasync`` /
  ``os.replace`` / ``os.fdopen``, ``.write_bytes(``/``.write_text(``,
  or ``open(...)`` in a write mode — lexically outside any ``with``
  whose items include a ``capacity_guard(...)`` call;
* a ``raise OSError(...)`` carrying ENOSPC/EDQUOT markers (the errno
  constants, or no-space/quota wording) — hand-built capacity errors
  must be the typed class so ``except OSError`` fallbacks and the
  shed/cleanup handlers agree on what they saw.

Read-mode opens and file-object ``.write()`` calls (too generic — the
guard wraps the statement, not the handle) stay legal.
"""

from __future__ import annotations

import ast
import re
from typing import List

from m3_tpu_torch.x.lint.core import Context, FileUnit, Finding, dotted

_OS_DURABLE = {"os.fsync", "os.fdatasync", "os.replace", "os.fdopen"}
_PATH_WRITERS = {"write_bytes", "write_text"}
_ENOSPC_MSG_RE = re.compile(r"enospc|edquot|no space|quota exceed", re.I)
_ERRNO_NAMES = {"ENOSPC", "EDQUOT"}


def _open_write_mode(call: ast.Call) -> bool:
    """True for ``open(..., 'w'/'a'/'x'/'+')`` (positional or mode=)."""
    mode = None
    if len(call.args) >= 2:
        mode = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
        return any(c in mode.value for c in "wax+")
    return False


def _guarded_with(node: ast.With | ast.AsyncWith) -> bool:
    for item in node.items:
        expr = item.context_expr
        if isinstance(expr, ast.Call):
            callee = dotted(expr.func)
            if callee and callee.rsplit(".", 1)[-1] == "capacity_guard":
                return True
    return False


def _capacity_markers(call: ast.Call) -> bool:
    for sub in ast.walk(call):
        if isinstance(sub, ast.Attribute) and sub.attr in _ERRNO_NAMES:
            return True
        if isinstance(sub, ast.Name) and sub.id in _ERRNO_NAMES:
            return True
        if (isinstance(sub, ast.Constant) and isinstance(sub.value, str)
                and _ENOSPC_MSG_RE.search(sub.value)):
            return True
    return False


def check(unit: FileUnit, ctx: Context) -> List[Finding]:
    if not ctx.is_capacity_module(unit.path):
        return []
    findings: List[Finding] = []

    def visit(node: ast.AST, guarded: bool) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            guarded = guarded or _guarded_with(node)
        if isinstance(node, ast.Call) and not guarded:
            callee = dotted(node.func)
            site = None
            if callee in _OS_DURABLE:
                site = callee
            elif (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _PATH_WRITERS):
                site = f".{node.func.attr}()"
            elif (isinstance(node.func, ast.Name) and node.func.id == "open"
                    and _open_write_mode(node)):
                site = "open(.., write mode)"
            if site is not None:
                findings.append(Finding(
                    "enospc-typed", unit.path, node.lineno,
                    f"durable write op {site} outside capacity_guard — "
                    "an ENOSPC here escapes as a raw OSError (no typed "
                    "classification, no temp cleanup, no counter); wrap "
                    "the write in m3_tpu_torch.persist.capacity.capacity_guard"))
        if isinstance(node, ast.Raise):
            exc = node.exc
            if isinstance(exc, ast.Call):
                callee = dotted(exc.func)
                name = callee.rsplit(".", 1)[-1] if callee else None
                if name == "OSError" and _capacity_markers(exc):
                    findings.append(Finding(
                        "enospc-typed", unit.path, node.lineno,
                        "capacity-shaped OSError raised untyped — raise "
                        "m3_tpu_torch.persist.capacity.DiskCapacityError (an "
                        "OSError subclass) so shed/cleanup handlers "
                        "dispatch on it"))
        for child in ast.iter_child_nodes(node):
            visit(child, guarded)

    visit(unit.tree, False)
    return findings


EXPLAIN = {
    "enospc-typed": {
        "why": (
            "Durable write ops under persist/ (and the aggregator "
            "checkpoint) must run inside capacity_guard: it classifies "
            "ENOSPC/EDQUOT into the typed DiskCapacityError hierarchy, "
            "unlinks atomic-write temp files on the error path, and "
            "feeds the disk_capacity_errors_total counters.  A raw "
            "fsync/replace outside the guard turns a full disk into an "
            "undiagnosed crash of the flush/tick/drain that hit it."),
        "bad": ("def _write_atomic(path, data):\n"
                "    with open(tmp, 'wb') as f:\n"
                "        f.write(data)\n"
                "        os.fsync(f.fileno())\n"
                "    os.replace(tmp, path)\n"),
        "good": ("def _write_atomic(path, data):\n"
                 "    with capacity_guard(path=path, component='fileset',\n"
                 "                        op='write', cleanup=(tmp,)):\n"
                 "        with open(tmp, 'wb') as f:\n"
                 "            f.write(data)\n"
                 "            os.fsync(f.fileno())\n"
                 "        os.replace(tmp, path)\n"),
    },
}
