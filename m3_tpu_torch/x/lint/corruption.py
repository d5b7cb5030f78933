"""Rule family 7 — typed corruption errors (``corruption-typed``).

The port's copy of ``m3_tpu/x/lint/corruption.py``: the same logic, over the port's
paths (``core.Context``).

The corruption-resilience PR's invariant, made permanent: every
digest/checksum/magic verify site under ``m3_tpu_torch/persist/`` must raise
:class:`m3_tpu_torch.persist.corruption.CorruptionError` (or a subclass), not
a bare ``ValueError``.  The storage layer's quarantine/degrade/repair
handlers catch exactly the typed class — a bare ``ValueError`` added at
a new verify site would sail PAST them and abort a
bootstrap or fail a query, silently undoing the detect→quarantine→
repair contract.  This rule turns that regression into a gate failure.

A raise is classified as a *verify site* when either holds:

* the raised message (any string literal in the ``ValueError(...)``
  call, including f-string fragments) talks about integrity —
  corrupt/checksum/digest/magic/mismatch/torn/truncated/version;
* the enclosing ``if`` test performs an integrity comparison — calls
  ``digest``/``digest_file``/``unpack_digest``/``adler32`` or compares
  against a ``*_MAGIC`` constant (``INFO_MAGIC``, ``cls.MAGIC``...).

Ordinary argument validation (``raise ValueError("n must be >= 0")``)
matches neither and stays legal.
"""

from __future__ import annotations

import ast
import re
from typing import List

from m3_tpu_torch.x.lint.core import Context, FileUnit, Finding, dotted

_MSG_RE = re.compile(
    r"corrupt|checksum|digest|magic|mismatch|torn|truncat|version", re.I
)
_DIGEST_FNS = {"digest", "digest_file", "unpack_digest", "adler32"}


def _string_fragments(node: ast.AST):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            yield sub.value


def _integrity_message(call: ast.Call) -> bool:
    return any(_MSG_RE.search(s) for arg in call.args
               for s in _string_fragments(arg))


def _integrity_test(test: ast.AST) -> bool:
    for sub in ast.walk(test):
        if isinstance(sub, ast.Call):
            callee = dotted(sub.func)
            name = callee.rsplit(".", 1)[-1] if callee else None
            if name in _DIGEST_FNS:
                return True
        if isinstance(sub, ast.Name) and sub.id.endswith("_MAGIC"):
            return True
        if isinstance(sub, ast.Attribute) and sub.attr.endswith("MAGIC"):
            return True
    return False


def check(unit: FileUnit, ctx: Context) -> List[Finding]:
    if not ctx.is_persist_module(unit.path):
        return []
    findings: List[Finding] = []

    def visit(node: ast.AST, if_tests: tuple) -> None:
        if isinstance(node, ast.If):
            for child in node.body:
                visit(child, if_tests + (node.test,))
            for child in node.orelse:
                visit(child, if_tests)
            return
        if isinstance(node, ast.Raise):
            exc = node.exc
            if (isinstance(exc, ast.Call) and isinstance(exc.func, ast.Name)
                    and exc.func.id == "ValueError"):
                verify = _integrity_message(exc) or any(
                    _integrity_test(t) for t in if_tests
                )
                if verify:
                    findings.append(Finding(
                        "corruption-typed", unit.path, node.lineno,
                        "integrity verify raises bare ValueError — raise "
                        "m3_tpu_torch.persist.corruption.CorruptionError (a "
                        "ValueError subclass) so quarantine/repair handlers "
                        "see it"))
            return
        for child in ast.iter_child_nodes(node):
            visit(child, if_tests)

    visit(unit.tree, ())
    return findings


EXPLAIN = {
    "corruption-typed": {
        "why": (
            "Digest/checksum/magic verify sites under persist/ must "
            "raise the typed CorruptionError hierarchy: the quarantine/"
            "scrub/repair machinery dispatches on it, and a bare "
            "ValueError turns detected corruption into an undiagnosed "
            "crash instead of a quarantined volume."),
        "bad": ("if digest != expect:\n"
                "    raise ValueError('bad digest')\n"),
        "good": ("if digest != expect:\n"
                 "    raise ChecksumMismatch(path, 'digest', expect)\n"),
    },
}
