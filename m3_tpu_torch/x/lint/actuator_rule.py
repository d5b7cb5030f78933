"""Rule family 17 — self-healing actuator discipline (``actuator-typed``).

The port's copy of ``m3_tpu/x/lint/actuator_rule.py``: the same logic, over the port's
paths (``core.Context``).

The control plane's invariant (the placement-cas pattern applied to
control state): every runtime mutation of a control-plane knob —
admission capacity (``admission.resize``), the device-memory budget
(``membudget.set_budget``), breaker thresholds/state
(``devguard.configure``, ``breaker.force_open``), (the port has no
forced device fallback, so ``force_fallback`` is flagged wherever it
appears) — must go through
``x/controller.py``'s typed actuator registry, where it is
bounds-clamped, rate-limited, hysteresis-bounded, and emitted as a
``controller_action`` series.  A direct ``membudget.set_budget(0)``
added later would be an invisible, unbounded, un-audited
mutation racing the controller's own relax path — exactly the class of
change this gate turns into a build failure.

A call is flagged when it matches one of the mutation verbs:

* ``.resize(...)`` on an admission-named receiver (``admission.resize``,
  ``self.admission.resize`` — membudget reservations' ``_mem.resize``
  is a different, ledger-internal verb and stays clean);
* ``set_budget(...)`` bare or on a membudget-named receiver;
* ``force_fallback(...)`` / ``force_open(...)`` on any receiver;
* ``.configure(...)`` on a devguard-named receiver.

Files under ``Context.controller_files`` are exempt: the controller
itself (the blessed mutation path), ``x/devguard.py`` (whose
``force_fallback`` drives ``force_open`` — the plumbing under the
seam), and ``server/assembly.py`` (boot-time configuration from the
validated config is initialization, not runtime mutation).
"""

from __future__ import annotations

import ast
from typing import List

from m3_tpu_torch.x.lint.core import Context, FileUnit, Finding, dotted

_VIA = ("go through x/controller.py's actuator registry so the change "
        "is bounds-clamped, rate-limited, and emitted as a "
        "controller_action series")


def _match(chain: str | None, attr: str) -> str | None:
    """The violation message for one callee, or None when clean."""
    chain = chain or ""
    if attr == "resize" and "admission" in chain:
        return f"direct admission mutation {chain}(...) — {_VIA}"
    if attr == "set_budget" and ("membudget" in chain
                                 or chain == "set_budget"):
        return f"direct membudget mutation {chain or attr}(...) — {_VIA}"
    if attr == "force_fallback":
        return f"direct forced-fallback mutation {chain or attr}(...) — {_VIA}"
    if attr == "force_open":
        return f"direct breaker force-open {chain or attr}(...) — {_VIA}"
    if attr == "configure" and "devguard" in chain:
        return f"direct breaker-threshold mutation {chain}(...) — {_VIA}"
    return None


def check(unit: FileUnit, ctx: Context) -> List[Finding]:
    if unit.path in ctx.controller_files:
        return []
    findings: List[Finding] = []
    for node in ast.walk(unit.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if isinstance(fn, ast.Attribute):
            attr = fn.attr
        elif isinstance(fn, ast.Name):
            attr = fn.id
        else:
            continue
        msg = _match(dotted(fn), attr)
        if msg is not None:
            findings.append(Finding(
                "actuator-typed", unit.path, node.lineno, msg))
    return findings


EXPLAIN = {
    "actuator-typed": {
        "why": (
            "Control-plane knobs (admission capacity, membudget budget, "
            "breaker thresholds/state, forced device fallback) mutated "
            "outside x/controller.py's actuator registry are unbounded, "
            "un-rate-limited, and invisible on the controller_action "
            "history — and they race the controller's own shed/relax "
            "steps over the same state."),
        "bad": "membudget.set_budget(0)       # unbounded, un-audited\n",
        "good": (
            "reg.register(membudget_actuator(floor, step))\n"
            "# the controller sheds/relaxes it: clamped, rate-limited,\n"
            "# every step a controller_action sample\n"),
    },
}
