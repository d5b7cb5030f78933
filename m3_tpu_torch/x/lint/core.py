"""m3lint core for the port: findings, suppressions, the baseline ratchet
and the tree walk.  The counterpart of ``m3_tpu/x/lint/core.py``.

The analyzer is *codebase-aware*: its rules encode the port's
concurrency, wire, bit-exactness and device-boundary contracts (see the
rule modules), not generic style.  Everything runs on stdlib ``ast``, so
the gate works wherever the tests do, and it reads source text only: it
never imports the modules it lints.

Baseline ratchet: findings are compared against a committed baseline
(``m3_tpu_torch/tools/lint_baseline.json``, empty) as a MULTISET of
``(rule, path, message)`` keys.  Line numbers are recorded for humans
but ignored in the comparison, so unrelated edits that shift lines do
not churn the gate.  The gate fails on NEW findings *and* on stale
baseline entries: a fixed finding must shrink the baseline, so the debt
only ratchets down.

Suppression: a finding on line N is suppressed by a trailing comment on
that line (or on a comment-only line above it):

    self.hits += 1  # m3lint: disable=lock-discipline
    # m3lint: disable=wire-exhaustive  (next line suppressed)

``# m3lint: disable-file=<rule>`` within the first ten lines suppresses
the rule for the whole file.  Suppressions are for *reviewed* false
positives and carry their reason beside them; new debt belongs in the
baseline, where it is counted.
"""

from __future__ import annotations

import ast
import json
import re
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterable, List

RULES = (
    "lock-discipline",
    "jit-purity",
    "explicit-dtype",
    "wire-exhaustive",
    "fault-coverage",
    "resource-hygiene",
    "corruption-typed",
    "placement-cas",
    "deadline-aware",
    # the device-program families (torchlint.py), restated from the
    # reference's jax compile-stability families
    "retrace-risk",
    "transfer-hygiene",
    "dtype-stability",
    "constant-bloat",
    # instrument-callsite hygiene (metrics_rule.py)
    "metric-hygiene",
    # device-boundary guard coverage (devguard_rule.py)
    "device-guard",
    # device-program registry completeness (registry_rule.py)
    "registry-complete",
    # control-plane mutations only through x/controller.py (actuator_rule.py)
    "actuator-typed",
    # typed disk-capacity errors (capacity_rule.py)
    "enospc-typed",
)

_SUPPRESS_RE = re.compile(r"#\s*m3lint:\s*disable=([\w,-]+)")
_SUPPRESS_FILE_RE = re.compile(r"#\s*m3lint:\s*disable-file=([\w,-]+)")

PACKAGE = "m3_tpu_torch"


@dataclass(frozen=True, order=True)
class Finding:
    rule: str
    path: str      # posix path relative to the repo root (m3_tpu_torch/x/fault.py)
    line: int
    message: str

    @property
    def key(self):
        """Baseline identity: line numbers drift with unrelated edits,
        (rule, path, message) survives them."""
        return (self.rule, self.path, self.message)

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _p(*rels: str) -> tuple:
    return tuple(f"{PACKAGE}/{r}" for r in rels)


@dataclass
class Context:
    """Scope knobs the rules consult.  Paths are posix, relative to the
    repo root; prefixes select rule applicability per file.  The corpus
    tests pass permissive prefixes so every rule fires on the seeded
    violations wherever the corpus lives.

    The fields the ten path-only families read keep the reference's
    names and meanings over the port's paths; the device families'
    fields are the port's own."""

    # bit-exactness modules: the codec's and the arenas' word formats
    # (u64 lanes on int64, orderable-f32 words) are bit-layout contracts
    dtype_prefixes: tuple = _p("encoding/", "parallel/", "aggregator/")
    wire_prefixes: tuple = _p("server/", "client/", "cluster/", "msg/", "dtest/")
    wire_files: tuple = _p("persist/commitlog.py")
    # the framing module IS the designated low-level seam: raw socket
    # ops are legal only here
    fault_helper_files: tuple = _p("msg/protocol.py")
    # files whose module-level small-int constants must be registered in
    # a wirecheck dispatch family
    constant_files: tuple = _p("msg/protocol.py", "server/rpc.py",
                               "server/ingest_tcp.py", "cluster/kv_remote.py",
                               "query/remote.py")
    # digest/checksum/magic verify sites must raise CorruptionError
    persist_prefixes: tuple = _p("persist/")
    # the home of raw placement-key KV mutations (PlacementService)
    placement_files: tuple = _p("cluster/placement.py")
    # query-path modules whose blocking wire calls must be deadline-aware
    deadline_files: tuple = _p("query/remote.py", "server/rpc.py",
                               "client/session.py")
    deadline_prefixes: tuple = ()
    # the device modules (the numeric layer the device families police)
    torch_prefixes: tuple = _p("encoding/", "parallel/", "aggregator/")
    # declared host boundaries: the scalar codec and the tools own the
    # device->host reads; every other device module returns tensors
    host_boundary: tuple = _p("tools/", "encoding/m3tsz.py")
    # modules whose perf_counter-timed regions must synchronize the card
    timed_prefixes: tuple = _p("tools/")
    # request-serving trees where instrument interning must be hoisted
    # out of loops and handlers, and tag values must be literals
    metric_prefixes: tuple = _p("server/", "query/", "instrument/selfmon.py",
                                "coordinator/")
    # known large host tables (constant-bloat flags their per-call
    # conversion to a tensor, even across modules)
    large_constants: tuple = ("_VALUE_CTRL_TBL",)
    # serving trees whose raw device work (hand-kernel wrapper calls,
    # .to(<device>)/.cuda(), torch.cuda.synchronize()) must flow through
    # the x.devguard seam
    device_prefixes: tuple = _p("server/", "storage/", "aggregator/")
    device_helper_files: tuple = ()
    # trees whose run_guarded/membudget literals must be declared in
    # registry_rule.FAMILIES; the costwatch file also cross-checks the
    # inverse direction
    registry_prefixes: tuple = _p("storage/", "aggregator/", "encoding/", "server/")
    registry_cost_file: str = f"{PACKAGE}/x/costwatch.py"
    # the homes of control-plane mutation verbs: the controller's
    # actuator registry, devguard (breaker plumbing under the seam) and
    # assembly (boot-time configuration from the validated config)
    controller_files: tuple = _p("x/controller.py", "x/devguard.py",
                                 "server/assembly.py")
    # trees whose durable write ops must run inside capacity_guard; the
    # guard module itself is the classification seam and exempt
    capacity_prefixes: tuple = _p("persist/", "aggregator/checkpoint.py")
    capacity_helper_files: tuple = _p("persist/capacity.py")

    def is_wire_module(self, path: str) -> bool:
        return (path in self.wire_files
                or any(path.startswith(p) for p in self.wire_prefixes))

    def wants_dtype(self, path: str) -> bool:
        return any(path.startswith(p) for p in self.dtype_prefixes)

    def is_persist_module(self, path: str) -> bool:
        return any(path.startswith(p) for p in self.persist_prefixes)

    def wants_torch(self, path: str) -> bool:
        return any(path.startswith(p) for p in self.torch_prefixes)

    def is_host_boundary(self, path: str) -> bool:
        return any(path.startswith(p) for p in self.host_boundary)

    def wants_timed(self, path: str) -> bool:
        return any(path.startswith(p) for p in self.timed_prefixes)

    def is_capacity_module(self, path: str) -> bool:
        if path in self.capacity_helper_files:
            return False
        return any(path.startswith(p) for p in self.capacity_prefixes)


@dataclass
class FileUnit:
    """One parsed file handed to every rule."""

    path: str            # repo-relative posix
    tree: ast.AST
    source: str
    lines: List[str] = field(default_factory=list)

    def __post_init__(self):
        if not self.lines:
            self.lines = self.source.splitlines()


Rule = Callable[[FileUnit, Context], List[Finding]]


def _suppressions(unit: FileUnit):
    per_line: dict[int, set] = {}
    file_wide: set = set()
    for i, text in enumerate(unit.lines, start=1):
        m = _SUPPRESS_RE.search(text)
        if m:
            rules = set(m.group(1).split(","))
            per_line.setdefault(i, set()).update(rules)
            # a comment-only line also suppresses the line below it
            if text.lstrip().startswith("#"):
                per_line.setdefault(i + 1, set()).update(rules)
        if i <= 10:
            mf = _SUPPRESS_FILE_RE.search(text)
            if mf:
                file_wide.update(mf.group(1).split(","))
    return per_line, file_wide


def apply_suppressions(unit: FileUnit, findings: Iterable[Finding]) -> List[Finding]:
    per_line, file_wide = _suppressions(unit)
    out = []
    for f in findings:
        if f.rule in file_wide or "all" in file_wide:
            continue
        rules = per_line.get(f.line, ())
        if f.rule in rules or "all" in rules:
            continue
        out.append(f)
    return out


def _rule_modules():
    from m3_tpu_torch.x.lint import (
        actuator_rule, capacity_rule, corruption, deadline_aware,
        devguard_rule, faultcov, locks, metrics_rule, placement, purity,
        registry_rule, resources, torchlint, wirecheck,
    )

    return (torchlint, locks, purity, wirecheck, faultcov, resources,
            corruption, placement, deadline_aware, metrics_rule,
            devguard_rule, registry_rule, actuator_rule, capacity_rule)


def default_rules() -> List[Rule]:
    (torchlint, locks, purity, wirecheck, faultcov, resources, corruption,
     placement, deadline_aware, metrics_rule, devguard_rule, registry_rule,
     actuator_rule, capacity_rule) = _rule_modules()
    return [
        locks.check,
        purity.check_jit_purity,
        purity.check_explicit_dtype,
        wirecheck.check,
        faultcov.check,
        resources.check,
        corruption.check,
        placement.check,
        deadline_aware.check,
        torchlint.check_retrace,
        torchlint.check_transfer,
        torchlint.check_dtype_stability,
        torchlint.check_constant_bloat,
        metrics_rule.check,
        devguard_rule.check,
        registry_rule.check,
        actuator_rule.check,
        capacity_rule.check,
    ]


def explain(rule: str) -> dict | None:
    """{why, bad, good} for a rule name, from the rule modules' EXPLAIN
    tables."""
    for mod in _rule_modules():
        entry = getattr(mod, "EXPLAIN", {}).get(rule)
        if entry is not None:
            return entry
    return None


def lint_source(source: str, rel: str, ctx: Context | None = None,
                rules: List[Rule] | None = None) -> List[Finding]:
    """Lint one source text as if it lived at repo-relative ``rel``."""
    ctx = ctx or Context()
    try:
        tree = ast.parse(source, filename=rel)
    except SyntaxError as e:
        return [Finding("parse-error", rel, e.lineno or 0, str(e.msg))]
    unit = FileUnit(rel, tree, source)
    findings: List[Finding] = []
    for rule in (rules if rules is not None else default_rules()):
        findings.extend(rule(unit, ctx))
    return apply_suppressions(unit, findings)


def lint_file(path: Path, rel_root: Path, ctx: Context,
              rules: List[Rule] | None = None) -> List[Finding]:
    rel = Path(path).relative_to(rel_root).as_posix()
    return lint_source(Path(path).read_text(encoding="utf-8"), rel, ctx, rules)


def lint_tree(root: Path, rel_root: Path | None = None,
              ctx: Context | None = None,
              rules: List[Rule] | None = None) -> List[Finding]:
    """Lint every ``*.py`` under ``root``; paths are reported relative to
    ``rel_root`` (default: root's parent, so scanning
    ``<repo>/m3_tpu_torch`` yields ``m3_tpu_torch/...`` paths matching
    the Context prefixes)."""
    root = Path(root)
    rel_root = Path(rel_root) if rel_root is not None else root.parent
    ctx = ctx or Context()
    findings: List[Finding] = []
    for path in sorted(root.rglob("*.py")):
        findings.extend(lint_file(path, rel_root, ctx, rules))
    return sorted(findings)


# -- baseline ratchet --------------------------------------------------------


def default_baseline_path() -> Path:
    return Path(__file__).resolve().parents[2] / "tools" / "lint_baseline.json"


def load_baseline(path: Path) -> List[Finding]:
    if not Path(path).exists():
        return []
    raw = json.loads(Path(path).read_text())
    return [Finding(f["rule"], f["path"], int(f.get("line", 0)), f["message"])
            for f in raw.get("findings", [])]


def save_baseline(path: Path, findings: Iterable[Finding]) -> None:
    payload = {
        "version": 1,
        "findings": [
            {"rule": f.rule, "path": f.path, "line": f.line,
             "message": f.message}
            for f in sorted(findings)
        ],
    }
    Path(path).write_text(json.dumps(payload, indent=1) + "\n")


def diff_baseline(findings: Iterable[Finding], baseline: Iterable[Finding]):
    """Returns (new, fixed): findings not in the baseline, and baseline
    entries that no longer fire.  Multiset semantics: two identical
    findings in one file need two baseline entries."""
    findings, baseline = list(findings), list(baseline)
    cur = Counter(f.key for f in findings)
    base = Counter(f.key for f in baseline)
    by_key: dict = {}
    for f in findings + baseline:
        by_key.setdefault(f.key, f)
    new = [by_key[k] for k, n in (cur - base).items() for _ in range(n)]
    fixed = [by_key[k] for k, n in (base - cur).items() for _ in range(n)]
    return sorted(new), sorted(fixed)


# -- shared AST helpers ------------------------------------------------------


def dotted(node: ast.AST) -> str | None:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def func_defs(tree: ast.AST):
    """Every FunctionDef/AsyncFunctionDef in the tree (any nesting)."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node
