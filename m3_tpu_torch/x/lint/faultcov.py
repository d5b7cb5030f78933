"""Rule family 4 — fault/retry coverage (``fault-coverage``).

The port's copy of ``m3_tpu/x/lint/faultcov.py``: the same logic, over the port's
paths (``core.Context``).

The wire layer's invariant: every raw socket/disk primitive in
the wire layer (``server/``, ``client/``, ``cluster/``, ``msg/``,
``persist/commitlog.py``) flows through a faultpoint so dtest can
inject drop/delay/error/corrupt at that exact boundary.  A bare
``sock.sendall`` added later is a boundary the fault tier can
no longer reach — this rule makes that a gate failure, not a review
catch.

Exemptions:

* ``msg/protocol.py`` — the designated low-level framing seam
  (``send_frame``/``_recv_exact``); call sites reach it behind their
  own named faultpoints (``kv_remote.call``, ``ingest_tcp.frame``...).
* functions that call ``fault.fire``/``fault.mangle`` themselves — the
  primitive is already behind a faultpoint in that scope
  (``CommitLogWriter._flush_fsync``).
"""

from __future__ import annotations

import ast
from typing import List

from m3_tpu_torch.x.lint.core import Context, FileUnit, Finding, dotted

_RAW_METHODS = {"sendall": "socket send", "recv": "socket recv",
                "recv_into": "socket recv", "sendto": "socket send"}
_RAW_DOTTED = {"os.fsync": "fsync", "os.fdatasync": "fsync"}
_FAULT_CALLS = {"fault.fire", "fault.mangle", "fire", "mangle"}


def _fires_faultpoint(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            callee = dotted(node.func)
            if callee in _FAULT_CALLS:
                return True
    return False


def check(unit: FileUnit, ctx: Context) -> List[Finding]:
    if not ctx.is_wire_module(unit.path):
        return []
    if unit.path in ctx.fault_helper_files:
        return []
    findings: List[Finding] = []
    funcs = [n for n in ast.walk(unit.tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    covered = {id(fn) for fn in funcs if _fires_faultpoint(fn)}
    # map each call node to its innermost enclosing function (ast.walk
    # is breadth-first, so nested defs are processed after — and
    # overwrite — their enclosing def)
    enclosing: dict = {}
    for fn in funcs:
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                # innermost wins: later (nested) functions overwrite
                enclosing[id(node)] = fn
    for node in ast.walk(unit.tree):
        if not isinstance(node, ast.Call):
            continue
        what = None
        if isinstance(node.func, ast.Attribute):
            what = _RAW_METHODS.get(node.func.attr)
        callee = dotted(node.func)
        if what is None and callee in _RAW_DOTTED:
            what = _RAW_DOTTED[callee]
        if what is None:
            continue
        fn = enclosing.get(id(node))
        if fn is not None and id(fn) in covered:
            continue
        where = f"{fn.name}()" if fn is not None else "module level"
        findings.append(Finding(
            "fault-coverage", unit.path, node.lineno,
            f"raw {what} in {where} outside a faultpoint-wrapped helper "
            f"— wire I/O must stay reachable by m3_tpu_torch.x.fault"))
    return findings


EXPLAIN = {
    "fault-coverage": {
        "why": (
            "Raw sendall/recv/fsync in wire modules bypasses the "
            "faultpoint seams (x/fault.py), so the fault tier cannot "
            "inject drops/delays/corruption there — the path ships "
            "untested against the failures it WILL see."),
        "bad": "sock.sendall(frame)              # invisible to fault tier\n",
        "good": ("protocol.send_frame(sock, frame)  # faultpoint-wrapped "
                 "helper\n"),
    },
}
