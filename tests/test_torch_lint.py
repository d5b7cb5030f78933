"""m3lint for the port (``m3_tpu_torch/x/lint/``) against the reference's
(``m3_tpu/x/lint/``), on the CPU.

* **The ten path-only families** run the reference's logic over the
  port's paths: each fixture of the reference's own corpus
  (``tests/data/lint_corpus/``), placed where the rule applies, goes
  through the reference rule with the reference's ``Context`` at an
  ``m3_tpu/`` path and through the port's rule with the port's
  ``Context`` at the same path under ``m3_tpu_torch/``; both give the
  same ``(rule, line, message)`` list, the reference's messages read
  with the same ``m3_tpu`` -> ``m3_tpu_torch`` mapping as the paths.  The
  same holds over every source file of both packages.
* **The eight restated families** flag a jax snippet (the reference's
  rule) and its torch counterpart (the port's) at the same lines, and
  each ``EXPLAIN`` bad example is flagged while its good example is not.
* **The gate**: ``run_repo()`` over ``m3_tpu_torch/`` finds nothing
  beyond the empty baseline, and no port module imports jax or the
  reference package.  The repairs it found: the database's corruption
  counters count exactly under concurrent notes, and the query
  precision policy reads no environment.
"""

from __future__ import annotations

import ast
import sys
import threading
from pathlib import Path

import pytest

from m3_tpu.x import lint as ref_lint
from m3_tpu.x.lint import (actuator_rule as r_act, capacity_rule as r_cap,
                           corruption as r_cor, deadline_aware as r_dl,
                           faultcov as r_fc, jaxlint as r_jl,
                           locks as r_lk, metrics_rule as r_mr, placement as r_pl,
                           purity as r_pu, registry_rule as r_rg, resources as r_rs,
                           wirecheck as r_wc)
from m3_tpu.x.lint.core import FileUnit as RefUnit
from m3_tpu.x.lint.core import default_rules as ref_default_rules
from m3_tpu_torch.x import lint
from m3_tpu_torch.x.lint import (actuator_rule, capacity_rule, core, corruption,
                                 deadline_aware, faultcov, locks, metrics_rule,
                                 placement, purity, registry_rule, resources,
                                 wirecheck)

ROOT = Path(__file__).resolve().parents[1]
CORPUS = ROOT / "tests" / "data" / "lint_corpus"

# the ten families whose contract does not depend on jax: reference rule,
# port rule
TEN = {
    "lock-discipline": (r_lk.check, locks.check),
    "wire-exhaustive": (r_wc.check, wirecheck.check),
    "fault-coverage": (r_fc.check, faultcov.check),
    "resource-hygiene": (r_rs.check, resources.check),
    "corruption-typed": (r_cor.check, corruption.check),
    "placement-cas": (r_pl.check, placement.check),
    "deadline-aware": (r_dl.check, deadline_aware.check),
    "metric-hygiene": (r_mr.check, metrics_rule.check),
    "actuator-typed": (r_act.check, actuator_rule.check),
    "enospc-typed": (r_cap.check, capacity_rule.check),
}

# (corpus fixture, where it is placed under each package): where each
# rule applies, and the homes each rule exempts
PLACEMENTS = [
    ("lock_cases.py", "storage/lock_cases.py"),
    ("wire_cases.py", "server/wire_cases.py"),
    ("wire_cases.py", "msg/protocol.py"),
    ("fault_cases.py", "client/fault_cases.py"),
    ("fault_cases.py", "msg/protocol.py"),
    ("fault_cases.py", "persist/commitlog.py"),
    ("dtest_cases.py", "dtest/dtest_cases.py"),
    ("resource_cases.py", "cluster/resource_cases.py"),
    ("corruption_cases.py", "persist/corruption_cases.py"),
    ("placement_cases.py", "cluster/admin_cases.py"),
    ("placement_cases.py", "cluster/placement.py"),
    ("deadline_cases.py", "query/remote.py"),
    ("deadline_cases.py", "query/engine_cases.py"),
    ("metric_cases.py", "server/metric_cases.py"),
    ("selfmon_cases.py", "instrument/selfmon.py"),
    ("actuator_cases.py", "server/actuator_cases.py"),
    ("actuator_cases.py", "x/controller.py"),
    ("capacity_cases.py", "persist/capacity_cases.py"),
    ("capacity_cases.py", "aggregator/checkpoint.py"),
    ("capacity_cases.py", "persist/capacity.py"),
]


def _mapped(text: str) -> str:
    return text.replace("m3_tpu/", "m3_tpu_torch/").replace("m3_tpu.", "m3_tpu_torch.")


def _both(family: str, source: str, rel: str):
    """(reference findings mapped to the port's names, port findings) of
    one family on one source placed at ``m3_tpu/<rel>`` and
    ``m3_tpu_torch/<rel>``."""
    ref_rule, port_rule = TEN[family]
    tree = ast.parse(source)
    ref = ref_rule(RefUnit(f"m3_tpu/{rel}", tree, source), ref_lint.Context())
    port = port_rule(core.FileUnit(f"m3_tpu_torch/{rel}", tree, source), core.Context())
    return ([(f.rule, f.line, _mapped(f.message)) for f in ref],
            [(f.rule, f.line, f.message) for f in port])


# ---------------------------------------------------------------------------
# The ten path-only families: identical findings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", sorted(TEN))
@pytest.mark.parametrize("fixture,rel", PLACEMENTS)
def test_path_only_family_matches_the_reference_on_its_corpus(fixture, rel, family):
    ref, port = _both(family, (CORPUS / fixture).read_text(), rel)
    assert port == ref


def test_the_corpus_placements_exercise_every_path_only_family():
    fired = set()
    for fixture, rel in PLACEMENTS:
        for family in TEN:
            if _both(family, (CORPUS / fixture).read_text(), rel)[1]:
                fired.add(family)
    assert fired == set(TEN)


def _sources(pkg: str):
    out = []
    for p in sorted((ROOT / pkg).rglob("*.py")):
        rel = p.relative_to(ROOT / pkg).as_posix()
        out.append((rel, p.read_text(encoding="utf-8")))
    return out


@pytest.fixture(scope="module")
def both_trees():
    return _sources("m3_tpu_torch") + _sources("m3_tpu")


@pytest.mark.parametrize("family", sorted(TEN))
def test_path_only_family_matches_the_reference_over_both_packages(both_trees, family):
    """Every source file of both packages, linted by the reference's rule
    at its ``m3_tpu/`` path and by the port's at the ``m3_tpu_torch/``
    path: the same findings, file by file."""
    for rel, source in both_trees:
        ref, port = _both(family, source, rel)
        assert port == ref, rel


# ---------------------------------------------------------------------------
# The eight restated families: paired fixtures
# ---------------------------------------------------------------------------

PAIRS = {
    "jit-purity": ("encoding/purity_pair.py", """\
import time
import jax

@jax.jit
def f(x):
    return x + time.time()

def helper(x):
    return time.perf_counter()

@jax.jit
def g(x):
    return helper(x)
""", """\
import time
import torch

# a plain version
def f_plain(x):
    return x + time.time()

def helper(x):
    return time.perf_counter()

# a plain version
def g_plain(x):
    return helper(x)
"""),
    "explicit-dtype": ("encoding/dtype_pair.py", """\
import jax.numpy as jnp
import numpy as np
a = jnp.zeros(4)
b = np.arange(8)
c = jnp.ones(3, jnp.int64)
""", """\
import torch
import numpy as np
a = torch.zeros(4)
b = np.arange(8)
c = torch.ones(3, dtype=torch.int64)
"""),
    "retrace-risk": ("encoding/retrace_pair.py", """\
import os
import jax

@jax.jit
def f(x, n):
    if n > 4:
        return x
    return -x

@jax.jit
def g(x):
    k = int(x)
    m = os.environ.get("M")
    return x.sum().item() + k
""", """\
import os
import torch

# a plain version
def f_plain(x, n):
    if n > 4:
        return x
    return -x

# a plain version
def g_plain(x):
    k = int(x)
    m = os.environ.get("M")
    return x.sum().item() + k
"""),
    "transfer-hygiene": ("tools/transfer_pair.py", """\
import time
import jax
import jax.numpy as jnp
import numpy as np

@jax.jit
def f(x):
    return np.asarray(x).sum()

@jax.jit
def g(x):
    print(x)
    return x

def timed(x):
    t0 = time.perf_counter()
    y = jnp.sum(x)
    return time.perf_counter() - t0, y
""", """\
import time
import torch
import torch.nn.functional as F
import numpy as np

# a plain version
def f_plain(x):
    return x.cpu().sum()

# a plain version
def g_plain(x):
    print(x)
    return x

def timed(x):
    t0 = time.perf_counter()
    y = torch.sum(x)
    return time.perf_counter() - t0, y
"""),
    "dtype-stability": ("encoding/stability_pair.py", """\
import jax.numpy as jnp
def f(v):
    a = v.astype(jnp.int32).astype(jnp.int64)
    b = jnp.asarray(5)
    return (a << 2.0), b
""", """\
import torch
def f(v):
    a = v.to(torch.int32).to(torch.int64)
    b = torch.as_tensor(5)
    return (a << 2.0), b
"""),
    "constant-bloat": ("encoding/bloat_pair.py", """\
import jax
import jax.numpy as jnp
import numpy as np
TBL = np.arange(1 << 18)

@jax.jit
def f(i):
    return jnp.asarray(TBL)[i]
""", """\
import torch

import numpy as np
TBL = np.arange(1 << 18)


def f(i):
    return torch.as_tensor(TBL, device=i.device)[i]
"""),
    "device-guard": ("storage/guard_pair.py", """\
import jax
from m3_tpu.x import devguard

@jax.jit
def buffer_append(s, r):
    return s

class Buf:
    def append(self, r):
        self.state = buffer_append(self.state, r)

    def upload(self, t):
        return jax.device_put(t)

    def guarded(self, r):
        return devguard.run_guarded("storage.buffer_append", lambda: buffer_append(self.state, r), lambda: None)
""", """\
import torch
from m3_tpu_torch.x import devguard
from m3_tpu_torch.parallel.encode_place import place_words

def buffer_append(s, r):
    return s

class Buf:
    def append(self, r):
        self.state = place_words(self.state, r, 4)

    def upload(self, t):
        return t.to(self.device)

    def guarded(self, r):
        return devguard.run_guarded("storage.buffer_append", lambda: place_words(self.state, r, 4))
"""),
    "registry-complete": ("storage/registry_pair.py",
                          (CORPUS / "registry_cases.py").read_text(),
                          (CORPUS / "registry_cases.py").read_text().replace(
                              "from m3_tpu.x import", "from m3_tpu_torch.x import")),
}


def _lines(findings, rule):
    return sorted(f.line for f in findings if f.rule == rule)


@pytest.mark.parametrize("family", sorted(PAIRS))
def test_restated_family_flags_the_torch_counterpart_at_the_same_lines(family):
    rel, jax_src, torch_src = PAIRS[family]
    ref_f = []
    unit = RefUnit(f"m3_tpu/{rel}", ast.parse(jax_src), jax_src)
    for rule in ref_default_rules():
        ref_f.extend(rule(unit, ref_lint.Context()))
    port_f = lint.lint_source(torch_src, f"m3_tpu_torch/{rel}")
    want = _lines(ref_f, family)
    assert want, f"the jax snippet does not exercise {family}"
    assert _lines(port_f, family) == want


@pytest.mark.parametrize("rule", core.RULES)
def test_every_rule_has_an_explanation(rule):
    entry = core.explain(rule)
    assert entry and all(entry[k] for k in ("why", "bad", "good")), rule


_EXPLAIN_AT = {
    "jit-purity": "encoding/x.py", "explicit-dtype": "encoding/x.py",
    "retrace-risk": "encoding/x.py", "transfer-hygiene": "tools/x.py",
    "dtype-stability": "encoding/x.py", "constant-bloat": "encoding/x.py",
    "device-guard": "storage/x.py", "registry-complete": "storage/x.py",
}


@pytest.mark.parametrize("rule", sorted(_EXPLAIN_AT))
def test_explain_bad_example_is_flagged_and_good_is_not(rule):
    entry = core.explain(rule)
    rel = f"m3_tpu_torch/{_EXPLAIN_AT[rule]}"
    assert _lines(lint.lint_source(entry["bad"], rel), rule)
    assert not _lines(lint.lint_source(entry["good"], rel), rule)


def test_jax_explain_examples_are_flagged_by_the_reference():
    """The reference's own bad examples of the restated families fire
    under its rules (its device-guard example names no jitted def, so it
    is a fragment there): the pairs above restate live contracts."""
    for rule, mod in (("retrace-risk", r_jl), ("transfer-hygiene", r_jl),
                      ("jit-purity", r_pu), ("explicit-dtype", r_pu),
                      ("dtype-stability", r_jl), ("constant-bloat", r_jl),
                      ("registry-complete", r_rg)):
        src = mod.EXPLAIN[rule]["bad"]
        rel = "m3_tpu/storage/x.py" if rule == "registry-complete" else "m3_tpu/encoding/x.py"
        unit = RefUnit(rel, ast.parse(src), src)
        got = [f for r in ref_default_rules() for f in r(unit, ref_lint.Context())
               if f.rule == rule]
        assert got, rule


# ---------------------------------------------------------------------------
# Suppressions and the ratchet behave as the reference's
# ---------------------------------------------------------------------------

_LOCK_SRC = (
    "import threading\n"
    "class C:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "        self.n = 0\n"
    "    def read(self):\n"
    "        with self._lock:\n"
    "            return self.n\n"
    "    def bump(self):\n"
    "        self.n = 1  # m3lint: disable=lock-discipline\n"
    "    def bump2(self):\n"
    "        # m3lint: disable=lock-discipline\n"
    "        self.n = 2\n"
    "    def bump3(self):\n"
    "        self.n = 3\n"
)


@pytest.mark.parametrize("source", [
    _LOCK_SRC,
    "# m3lint: disable-file=lock-discipline\n" + _LOCK_SRC,
    "# m3lint: disable-file=all\n" + _LOCK_SRC,
    _LOCK_SRC.replace("disable=lock-discipline", "disable=all"),
])
def test_suppressions_behave_as_the_references(tmp_path, source):
    for side in ("ref", "port"):
        (tmp_path / side).mkdir()
        (tmp_path / side / "mod.py").write_text(source)
    ref = ref_lint.lint_file(tmp_path / "ref" / "mod.py", tmp_path / "ref", ref_lint.Context(),
                             [r_lk.check])
    port = lint.lint_file(tmp_path / "port" / "mod.py", tmp_path / "port", lint.Context(),
                          [locks.check])
    assert [(f.rule, f.line, f.message) for f in port] == \
        [(f.rule, f.line, f.message) for f in ref]


@pytest.mark.parametrize("cur,base", [
    ([("r", "a.py", 5, "old debt"), ("r", "b.py", 2, "fresh debt")], [("r", "a.py", 1, "old debt")]),
    ([], [("r", "a.py", 1, "old debt")]),
    ([("r", "a.py", 1, "dup"), ("r", "a.py", 2, "dup")], [("r", "a.py", 1, "dup")]),
    ([("r", "a.py", 1, "dup")], [("r", "a.py", 1, "dup"), ("r", "a.py", 9, "dup")]),
])
def test_multiset_diff_behaves_as_the_references(cur, base):
    r = ref_lint.diff_baseline([ref_lint.Finding(*f) for f in cur],
                               [ref_lint.Finding(*f) for f in base])
    p = lint.diff_baseline([lint.Finding(*f) for f in cur], [lint.Finding(*f) for f in base])
    assert [[f.key for f in part] for part in p] == [[f.key for f in part] for part in r]


def test_baseline_roundtrip(tmp_path):
    found = [lint.Finding("lock-discipline", "m3_tpu_torch/a.py", 3, "one"),
             lint.Finding("jit-purity", "m3_tpu_torch/b.py", 9, "two")]
    lint.save_baseline(tmp_path / "b.json", found)
    assert sorted(lint.load_baseline(tmp_path / "b.json")) == sorted(found)


# ---------------------------------------------------------------------------
# The gate over the port's tree
# ---------------------------------------------------------------------------


def test_port_tree_has_no_finding_beyond_the_empty_baseline():
    findings, new, fixed = lint.run_repo()
    assert lint.default_baseline_path() == ROOT / "m3_tpu_torch" / "tools" / "lint_baseline.json"
    assert lint.load_baseline(lint.default_baseline_path()) == []
    assert not new and not fixed, "\n".join(f.render() for f in new + fixed)
    assert findings == []


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_port_module_imports_jax_or_the_reference():
    bad = []
    for p in sorted((ROOT / "m3_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for mod in _imports(p):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "m3_tpu"):
                bad.append((p.relative_to(ROOT).as_posix(), mod))
    assert bad == []


def test_the_lint_reads_only_the_ports_tree():
    assert lint.package_root() == ROOT / "m3_tpu_torch"
    assert all(p.startswith("m3_tpu_torch/") for ctx_field in (
        "dtype_prefixes", "wire_prefixes", "persist_prefixes", "torch_prefixes",
        "device_prefixes", "registry_prefixes", "controller_files", "capacity_prefixes")
        for p in getattr(lint.Context(), ctx_field))


def test_kernel_wrapper_table_names_every_launching_def():
    """``purity.KERNEL_WRAPPERS`` holds every def in ``parallel/`` that
    reports a launch, and names only defs that exist there."""
    defs, launching = set(), set()
    for p in (ROOT / "m3_tpu_torch" / "parallel").glob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.FunctionDef):
                defs.add(node.name)
                if purity._is_wrapper(node):
                    launching.add(node.name)
    assert launching and launching <= purity.KERNEL_WRAPPERS <= defs


def test_registry_families_name_the_ports_registries():
    from m3_tpu_torch.x import costwatch

    prefixes = {p for fam in registry_rule.FAMILIES.values() for p in fam["cost_prefixes"]}
    for name in costwatch.stage_names():
        assert any(registry_rule._covers(p, name) for p in prefixes), name
    assert registry_rule.FAMILIES["buffer"]["cost_waiver"]
    found = lint.lint_source(
        'from m3_tpu_torch.x import devguard\n'
        'devguard.run_guarded("rollup.flush", lambda: 0)\n',
        "m3_tpu_torch/storage/new_stage.py")
    assert [f.rule for f in found] == ["registry-complete"]


def test_env_reads_are_findings_anywhere_in_the_package():
    src = "import os\nX = os.environ.get('M3_X')\nY = os.getenv('M3_Y')\nZ = os.environ['M3_Z']\n"
    found = lint.lint_source(src, "m3_tpu_torch/server/anything.py")
    assert _lines(found, "retrace-risk") == [2, 3, 4]


# ---------------------------------------------------------------------------
# The repairs the gate found
# ---------------------------------------------------------------------------


def test_corruption_counters_count_exactly_under_concurrent_notes(tmp_path):
    """Many threads note corruptions at once (the interpreter switching
    threads as often as it can): the counters and their /metrics series
    equal the number of notes."""
    from m3_tpu_torch.instrument import Registry
    from m3_tpu_torch.storage import database as tdb

    reg = Registry()
    db = tdb.Database(tdb.DatabaseOptions(root=str(tmp_path), commitlog_enabled=False),
                      {"default": tdb.NamespaceOptions(num_shards=1, slot_capacity=64,
                                                       sample_capacity=256)},
                      instrument=reg, device="cpu")
    threads_n, notes = 16, 2000
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def note(k):
            for i in range(notes):
                db._note_corruption("default", 0, i, 0, ValueError("x"),
                                    quarantined=(i + k) % 2 == 0)

        ts = [threading.Thread(target=note, args=(k,)) for k in range(threads_n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    finally:
        sys.setswitchinterval(switch)
        db.close()
    assert db.corruption_detected == threads_n * notes
    assert db.corruption_quarantined == threads_n * notes // 2
    scope = reg.scope("db")
    assert scope.counter("corruption_detected").value == threads_n * notes
    assert scope.counter("corruption_quarantined").value == threads_n * notes // 2


def test_query_precision_reads_no_environment(monkeypatch):
    import importlib

    from m3_tpu_torch.query import precision

    monkeypatch.setenv("M3_QUERY_DTYPE", "f32")
    mod = importlib.reload(precision)
    try:
        assert mod.compute_dtype().name == "float64"
        mod.set_compute_dtype("f32")
        assert mod.compute_dtype().name == "float32"
    finally:
        monkeypatch.delenv("M3_QUERY_DTYPE")
        importlib.reload(precision)


@pytest.mark.parametrize("path,rule", [
    ("client/aggregator_client.py", "lock-discipline"),
    ("x/controller.py", "lock-discipline"),
    ("query/slo.py", "metric-hygiene"),
    ("tools/hops.py", "transfer-hygiene"),
])
def test_reviewed_suppressions_match_the_references(path, rule):
    """The sites the reference suppresses are suppressed in the port, in
    the same number, each with its reason beside it."""
    def count(pkg):
        src = (ROOT / pkg / path).read_text()
        return sum(1 for ln in src.splitlines() if f"m3lint: disable={rule}" in ln)

    assert count("m3_tpu_torch") == count("m3_tpu") > 0
