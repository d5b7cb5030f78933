"""Rule family 3 — wire-frame dispatch exhaustiveness (``wire-exhaustive``).

The port's copy of ``m3_tpu/x/lint/wirecheck.py``: the same logic, over the port's
paths (``core.Context``).

Adding a frame type means touching every dispatcher by hand; a new
frame type must not be half-wired.  The rule models the protocol's frame constants as
*families* (a bus dispatcher owes nothing to ingest frames) and checks
every dispatcher — a function comparing one expression against two or
more constants of a family — for exhaustiveness:

* the function mentions EVERY constant of the family (directly or via a
  module-level tuple alias like ``_BATCH_FRAMES``), or
* it carries an explicit default: a ``not in``/``!=`` guard against the
  family, or a terminal ``else:`` on its if/elif dispatch chain.

Anything else is a dispatcher that silently ignores a frame type the
peer is allowed to send — the half-wired case.

The family table below is the analyzer's copy of ``msg/protocol.py``'s
constants.  A consistency pass over protocol.py itself flags any frame
constant that is missing from the table, so ADDING a frame type fails
the gate until the family (and therefore every dispatcher) is updated.
"""

from __future__ import annotations

import ast
from typing import List

from m3_tpu_torch.x.lint.core import Context, FileUnit, Finding, dotted

FAMILIES = {
    "bus": frozenset({"BUS_HELLO", "BUS_PUBLISH", "BUS_DELIVER", "BUS_ACK"}),
    "ingest": frozenset({"METRIC_BATCH", "TIMED_BATCH", "PASSTHROUGH_BATCH",
                         "FORWARDED_BATCH", "INGEST_HELLO", "INGEST_ACK",
                         "INGEST_BACKOFF", "INGEST_TRACE"}),
    "reply": frozenset({"OK", "ERROR"}),
    # frame families owned by other wire modules (server/rpc.py,
    # cluster/kv_remote.py, query/remote.py) — their dispatchers get the
    # same exhaustiveness treatment as protocol.py's
    "rpc": frozenset({"RPC_REQ", "RPC_REQ_DL", "RPC_REQ_TR", "RPC_OK",
                      "RPC_ERR"}),
    "kv": frozenset({"KV_REQ", "KV_OK", "KV_ERR"}),
    "query": frozenset({"QUERY_FETCH", "QUERY_RESULT"}),
    "rpc-method": frozenset({"M_WRITE_BATCH", "M_WRITE_TAGGED", "M_READ",
                             "M_QUERY_IDS", "M_LIST_BLOCKS", "M_BLOCK_META",
                             "M_READ_BLOCK", "M_WRITE_BLOCK", "M_TICK",
                             "M_HEALTH", "M_READ_BATCH"}),
    "kv-method": frozenset({"M_GET", "M_SET", "M_SET_NX", "M_CAS",
                            "M_DELETE", "M_KEYS"}),
}
_ALL_FAMILY_CONSTANTS = frozenset().union(*FAMILIES.values())

# wire-module module-level ints that are NOT frame/method types
_NON_FRAME_CONSTANTS = frozenset({"MAX_FRAME", "HELLO_WANT_ACKS"})


# modules frame constants are legitimately referenced through; guards
# against generic names (logging.ERROR, HTTPStatus.OK) polluting the
# "reply" family
_WIRE_MODULES = ("wire", "protocol")


def _const_name(node: ast.AST) -> str | None:
    """BUS_ACK / wire.BUS_ACK / protocol.BUS_ACK -> 'BUS_ACK'; None for
    attribute chains rooted anywhere else (logging.ERROR)."""
    if isinstance(node, ast.Name):
        return node.id if node.id in _ALL_FAMILY_CONSTANTS else None
    d = dotted(node)
    if d is None:
        return None
    prefix, _, name = d.rpartition(".")
    if prefix and prefix.rpartition(".")[2] not in _WIRE_MODULES:
        return None
    return name if name in _ALL_FAMILY_CONSTANTS else None


def _family_of(name: str) -> str | None:
    for fam, members in FAMILIES.items():
        if name in members:
            return fam
    return None


def _tuple_aliases(tree: ast.AST) -> dict:
    """Module-level ``_X = (wire.A, wire.B, ...)`` -> {_X: {A, B, ...}}."""
    aliases = {}
    for node in getattr(tree, "body", []):
        if (isinstance(node, ast.Assign)
                and isinstance(node.value, (ast.Tuple, ast.List, ast.Set))
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            names = set()
            for elt in node.value.elts:
                n = _const_name(elt)
                if n and _family_of(n):
                    names.add(n)
            if names:
                aliases[node.targets[0].id] = frozenset(names)
    return aliases


def _expr_constants(node: ast.AST, aliases: dict) -> set:
    """Family constants referenced by an expression (resolving tuple
    aliases and tuple/list/set literals)."""
    out = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id in aliases:
            out.update(aliases[sub.id])
            continue
        n = _const_name(sub)
        if n is not None and _family_of(n):
            out.add(n)
    return out


def _analyze_function(fn: ast.AST, aliases: dict):
    """Per family: (constants mentioned, has_default)."""
    mentioned: dict = {}
    defaults: set = set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.Name, ast.Attribute)):
            if isinstance(getattr(node, "ctx", None), ast.Load):
                n = _const_name(node)
                fam = _family_of(n) if n else None
                if fam:
                    mentioned.setdefault(fam, set()).add(n)
                elif isinstance(node, ast.Name) and node.id in aliases:
                    for c in aliases[node.id]:
                        f = _family_of(c)
                        if f:
                            mentioned.setdefault(f, set()).add(c)
        if isinstance(node, ast.Compare):
            consts = _expr_constants(node, aliases)
            fams = {_family_of(c) for c in consts} - {None}
            for op in node.ops:
                if isinstance(op, (ast.NotIn, ast.NotEq)):
                    # `ftype not in _BATCH_FRAMES` / `frame[0] != BUS_X`:
                    # an explicit everything-else branch exists
                    defaults.update(fams)
        if isinstance(node, ast.If):
            # terminal `else:` on an if/elif chain that dispatches on a
            # family constant
            consts = _expr_constants(node.test, aliases)
            fams = {_family_of(c) for c in consts} - {None}
            if fams:
                tail = node
                while (len(tail.orelse) == 1
                       and isinstance(tail.orelse[0], ast.If)):
                    tail = tail.orelse[0]
                    consts = _expr_constants(tail.test, aliases)
                    fams |= {_family_of(c) for c in consts} - {None}
                if tail.orelse:  # non-empty, non-elif terminal else
                    defaults.update(fams)
    return mentioned, defaults


def check(unit: FileUnit, ctx: Context) -> List[Finding]:
    findings: List[Finding] = []
    aliases = _tuple_aliases(unit.tree)
    for fn in [n for n in ast.walk(unit.tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
        mentioned, defaults = _analyze_function(fn, aliases)
        for fam, consts in mentioned.items():
            if len(consts) < 2 or fam in defaults:
                continue
            missing = FAMILIES[fam] - consts
            if missing:
                findings.append(Finding(
                    "wire-exhaustive", unit.path, fn.lineno,
                    f"{fn.name}() dispatches on {fam} frames "
                    f"{sorted(consts)} without a default branch and "
                    f"without handling {sorted(missing)}"))
    if unit.path in ctx.constant_files:
        findings.extend(_check_protocol_constants(unit))
    return findings


def _check_protocol_constants(unit: FileUnit) -> List[Finding]:
    """Every small-int module constant in a wire-constant file must
    belong to a family (or the known non-frame set) — adding
    INGEST_WHATEVER = 19 (or RPC_PING = 19 in rpc.py) fails the gate
    until FAMILIES (and so every dispatcher) learns it."""
    findings = []
    for node in getattr(unit.tree, "body", []):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        name = node.targets[0].id
        if not name.isupper():
            continue
        if not (isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, int)
                and 0 < node.value.value < 256):
            continue
        if name in _NON_FRAME_CONSTANTS or _family_of(name):
            continue
        findings.append(Finding(
            "wire-exhaustive", unit.path, node.lineno,
            f"frame constant {name} is not assigned to a dispatch family "
            f"in m3_tpu_torch/x/lint/wirecheck.py — dispatchers cannot be "
            f"checked for it"))
    return findings


EXPLAIN = {
    "wire-exhaustive": {
        "why": (
            "A frame-type dispatcher missing a family member (without "
            "an explicit default branch) silently drops the frame and "
            "desyncs the connection — the half-wired-frame-type class "
            "of bug.  The constant<->family table ratchet keeps new "
            "wire constants from being declared but never dispatched."),
        "bad": ("if ftype == MSG_A:\n"
                "    ...\n"
                "elif ftype == MSG_B:\n"
                "    ...                      # MSG_C exists; no default\n"),
        "good": ("elif ftype == MSG_C:\n"
                 "    ...\n"
                 "else:\n"
                 "    conn.close()             # explicit default\n"),
    },
}
