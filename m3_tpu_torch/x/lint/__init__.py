"""m3lint for the port: codebase-aware static analysis of the
``m3_tpu_torch`` tree.  The counterpart of ``m3_tpu/x/lint/``.

Eighteen rule families, each a contract the port already pays for at
run time (the race and fault tiers, the bit-exactness parity tests, the
device guard, the census) stated as a static gate.  Ten of them read
paths and the standard library only, and are the reference's logic over
the port's paths:

* ``lock-discipline``  — mixed locked/unlocked access to ``self._*``
  state, and unguarded ``+=`` in a class that owns locks.
* ``wire-exhaustive``  — frame-type dispatchers missing family members
  without an explicit default branch.
* ``fault-coverage``   — raw socket/fsync primitives in wire modules
  outside a faultpoint-wrapped helper.
* ``resource-hygiene`` — sockets/files opened with no owner on the
  error path.
* ``corruption-typed`` — verify sites under ``persist/`` raising bare
  ``ValueError`` instead of the typed ``CorruptionError``.
* ``placement-cas``    — raw KV writes of the placement key outside
  ``cluster/placement.py``.
* ``deadline-aware``   — blocking frame I/O in query-path modules
  outside a deadline-accepting helper.
* ``metric-hygiene``   — instrument interning in loops and per-request
  handlers, and unbounded tag values, in the serving trees.
* ``actuator-typed``   — control-plane knobs mutated outside
  ``x/controller.py``'s typed actuator registry.
* ``enospc-typed``     — durable write ops in ``persist/`` outside
  ``capacity_guard``, and untyped capacity-shaped ``OSError``.

Eight are restated for torch, keeping the reference's rule names where
the contract is the same (each module's docstring names its
counterpart):

* ``jit-purity`` / ``explicit-dtype`` (``purity.py``) — clocks, global
  randomness, locks, sockets and file I/O in the port's device programs
  (the hand-kernel wrappers, their plain versions and the primaries
  passed to ``run_guarded``); tensor constructors without ``dtype=`` in
  the bit-exactness modules.
* ``retrace-risk`` / ``transfer-hygiene`` / ``dtype-stability`` /
  ``constant-bloat`` (``torchlint.py``, the reference's ``jaxlint.py``)
  — host syncs in device programs and any environment read (the port
  has no env seams); host reads in device modules and unsynchronized
  timed regions; default-dtype seams and narrowing casts; large tables
  made tensors per call.
* ``device-guard`` (``devguard_rule.py``) — raw device work in the
  serving trees outside ``x.devguard``'s seam.
* ``registry-complete`` (``registry_rule.py``) — devguard stages ×
  membudget components × costwatch stages describe one program set.

``run_repo()`` is the gate: the port's tree against
``m3_tpu_torch/tools/lint_baseline.json``, which is empty.  Every
finding is repaired or carries an inline ``# m3lint: disable=<rule>``
with its reason; ``core.explain(rule)`` gives any rule's rationale with
a bad and a good example.
"""

from m3_tpu_torch.x.lint.core import (
    Context, Finding, default_baseline_path, default_rules, diff_baseline,
    explain, lint_file, lint_source, lint_tree, load_baseline, save_baseline,
)

__all__ = [
    "Context", "Finding", "default_baseline_path", "default_rules",
    "diff_baseline", "explain", "lint_file", "lint_source", "lint_tree",
    "load_baseline", "save_baseline", "package_root", "run_repo",
]


def package_root():
    """The ``m3_tpu_torch`` package directory this module belongs to."""
    from pathlib import Path

    import m3_tpu_torch

    return Path(m3_tpu_torch.__file__).resolve().parent


def run_repo():
    """(findings, new, fixed) for the port's tree against the committed
    baseline: the computation the gate runs."""
    pkg = package_root()
    findings = lint_tree(pkg, pkg.parent)
    new, fixed = diff_baseline(findings, load_baseline(default_baseline_path()))
    return findings, new, fixed
