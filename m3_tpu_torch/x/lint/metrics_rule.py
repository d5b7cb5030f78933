"""Rule family 14 — instrument-callsite hygiene (``metric-hygiene``).

The port's copy of ``m3_tpu/x/lint/metrics_rule.py``: the same logic, over the port's
paths (``core.Context``).

The hot-path latency surfaces live on interned histograms; this rule
keeps the two ways instrument callsites rot from coming
back:

* **intern-in-hot-path** — creating an instrument
  (``.counter(...)``/``.gauge(...)``/``.timer(...)``/
  ``.histogram(...)``) inside a loop or a per-request handler method
  (``do_GET``/``do_POST``/``do_PUT``/``do_DELETE``/``handle``).
  Registry interning makes it *correct*, but every call pays a name
  build + registry-lock intern on the hot path — the waste
  ``ingest_tcp._IngestMetrics`` exists to avoid.  Intern once at
  construction, use the handle in the loop.
* **unbounded-tag-cardinality** — ``.tagged({...})`` (or
  ``.scope(prefix, {...})``) whose tag VALUES are f-strings, string
  concatenation/formatting, or arbitrary variables.  Every distinct
  tag value is a new interned series that lives forever in the
  registry: a peer address or user id as a tag value is an unbounded
  series leak on /metrics.  Tag values must be string literals (bounded
  by the code itself); derived values belong in log lines, not label
  sets.

Scope: ``Context.metric_prefixes`` (the request-serving trees —
``server/``, ``query/`` — plus
``instrument/selfmon.py`` and ``coordinator/``: the self-monitoring
loop converts SCRAPED samples every tick, where a per-sample intern or
a scraped-label tag value is exactly the leak above) — maintenance-path
modules may intern lazily.
"""

from __future__ import annotations

import ast
from typing import List

from m3_tpu_torch.x.lint.core import Context, FileUnit, Finding

_INSTRUMENT_FACTORIES = {"counter", "gauge", "timer", "histogram"}
_HANDLER_METHODS = {"do_GET", "do_POST", "do_PUT", "do_DELETE", "handle"}
_TAGGING = {"tagged", "scope"}


def _applies(path: str, ctx: Context) -> bool:
    return any(path.startswith(p) for p in ctx.metric_prefixes)


def _is_instrument_call(node: ast.Call) -> bool:
    return (isinstance(node.func, ast.Attribute)
            and node.func.attr in _INSTRUMENT_FACTORIES
            and len(node.args) >= 1
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str))


def _loops_and_handlers(tree: ast.AST):
    """Yield (container node, kind) for every loop body and per-request
    handler method."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.For, ast.While, ast.AsyncFor)):
            yield node, "loop"
        elif (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node.name in _HANDLER_METHODS):
            yield node, f"per-request handler {node.name}()"


def check(unit: FileUnit, ctx: Context) -> List[Finding]:
    if not _applies(unit.path, ctx):
        return []
    findings: List[Finding] = []
    seen: set = set()
    # (a) instrument interning inside loops / request handlers
    for container, kind in _loops_and_handlers(unit.tree):
        for node in ast.walk(container):
            if (isinstance(node, ast.Call) and _is_instrument_call(node)
                    and id(node) not in seen):
                seen.add(id(node))
                name = node.args[0].value
                findings.append(Finding(
                    "metric-hygiene", unit.path, node.lineno,
                    f".{node.func.attr}({name!r}) interned inside a "
                    f"{kind} — per-call name build + registry-lock "
                    f"intern on a hot path; intern the instrument once "
                    f"at construction and reuse the handle"))
    # (b) unbounded tag cardinality
    for node in ast.walk(unit.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _TAGGING):
            continue
        dicts = [a for a in list(node.args) + [kw.value
                                               for kw in node.keywords]
                 if isinstance(a, ast.Dict)]
        for d in dicts:
            for v in d.values:
                if v is None:
                    continue
                if isinstance(v, ast.Constant):
                    continue  # literal: bounded by the code
                desc = ("f-string" if isinstance(v, ast.JoinedStr)
                        else type(v).__name__)
                findings.append(Finding(
                    "metric-hygiene", unit.path, v.lineno,
                    f"unbounded tag cardinality: .{node.func.attr}() "
                    f"tag value is a {desc}, not a string literal — "
                    f"every distinct value interns a new series that "
                    f"lives forever on /metrics"))
    return findings


EXPLAIN = {
    "metric-hygiene": {
        "why": (
            "Two instrument-callsite rots: (1) interning an instrument "
            "per call inside a loop/request handler pays a name build "
            "+ registry-lock intern on the hot path (interning makes "
            "it correct, not free) — hoist to construction; (2) tag "
            "values derived from variables/f-strings (peer addresses, "
            "ids) intern a new series per distinct value — an "
            "unbounded /metrics leak.  Tag values must be literals."),
        "bad": ("while frames:\n"
                "    scope.counter('frames').inc()     # intern per frame\n"
                "scope.tagged({'peer': f'{host}:{port}'})  # unbounded\n"),
        "good": ("self._frames = scope.counter('frames')  # in __init__\n"
                 "while frames:\n"
                 "    self._frames.inc()\n"
                 "scope.tagged({'path': 'ingest'})         # literal\n"),
    },
}
