"""Runtime build/transfer sanitizer: the port's counterpart of
``m3_tpu/x/tracewatch.py``.

Two halves, as in the reference:

* **The transfer guard** — :func:`no_transfers` forbids, in this thread,
  every host↔device transfer that ``x/devseams`` sees: on a device off
  the CPU (the card; the ``meta`` device in the CPU tests) ``.cpu()``,
  ``.to(...)``, ``.item()``, ``.tolist()``, a cross-device ``copy_``,
  ``torch.tensor``/``torch.as_tensor`` of host data, an ndarray upload,
  and the implicit syncs of ops whose output shape depends on the data.
  Both directions, as ``jax.transfer_guard("disallow")`` does on a real
  device.  The transfer raises :class:`TransferError`, naming the
  tensor's dtype and shape (``int64[8]``), before the copy runs.
  Compute on the device, hand kernels included, stays allowed.  The
  guard is per thread, nests, and works without :func:`install`;
  :func:`allow_transfers` re-opens it for a declared host boundary.
  CPU tensors are host memory: nothing on the CPU is a transfer.
* **The build half** — what the reference counts as XLA compiles, the
  port counts as kernel-library builds (``parallel/_cuda.build``'s
  ``nvcc``, ``native/_build.load_native``'s ``g++``): per source, with
  each build's signature (the source's content hash and the flags).
  Each source may build once a process; a second build is a retrace,
  which raises :class:`RetraceError` in the call that caused it, before
  the compiler runs (or, installed with ``raise_on_violation=False``,
  is recorded as a finding).  A library found built is not a build.

Arming is by code only (``install()`` / ``uninstall()``); the reference
also arms from ``M3_TRACEWATCH``, and the port reads no environment to
arm anything.  Not ported: ``retrace_budget(n)`` and the ``jax.jit`` /
``pjit`` factory wrapping (reference ``:276-325``): the port has no
traced functions to budget and uses no ``torch.compile``.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Dict, List

from m3_tpu_torch.x import devseams
from m3_tpu_torch.x.devseams import TransferError

__all__ = [
    "RetraceError", "TransferError", "RetraceFinding", "install",
    "uninstall", "installed", "reset", "compiles", "total_compiles",
    "compile_signatures", "findings", "no_transfers", "allow_transfers",
    "snapshot", "retraces_since",
]

BUILD_BUDGET = 1  # builds a source may take in one process

_installed = False
_raise_on_violation = True
_mu = threading.Lock()
_counts: Dict[str, int] = {}
_signatures: Dict[str, List[str]] = {}
_total = 0
_findings: List["RetraceFinding"] = []


class RetraceError(RuntimeError):
    """A kernel source built past its budget in this process.  Raised in
    the call that caused the build, carrying every signature seen."""


@dataclass
class RetraceFinding:
    """One budget violation: source ``name`` built ``count`` times
    against a budget of ``budget``; ``signatures`` lists each build's
    content hash and flags."""

    name: str
    count: int
    budget: int
    signatures: List[str] = field(default_factory=list)

    def __str__(self) -> str:
        sigs = "\n  ".join(self.signatures) or "<none recorded>"
        return (
            f"{self.name} built {self.count}x (budget {self.budget}) — a kernel "
            f"library was rebuilt in this process.  Signatures seen:\n  {sigs}\n"
            f"Build each source once (its library is named by the hash of its "
            f"source and flags) and keep the build directory for the process's "
            f"life.")


def _on_build(source: str, signature: str) -> None:
    global _total
    with _mu:
        _total += 1
        n = _counts[source] = _counts.get(source, 0) + 1
        sigs = _signatures.setdefault(source, [])
        if signature not in sigs:
            sigs.append(signature)
        over = n > BUILD_BUDGET
        if over:
            finding = RetraceFinding(source, n, BUILD_BUDGET, list(sigs))
            _findings.append(finding)
    if over and _raise_on_violation:
        raise RetraceError(str(finding))


def install(raise_on_violation: bool = True) -> None:
    """Arm the build half: count every build, enforce the budget.
    Idempotent."""
    global _installed, _raise_on_violation
    _raise_on_violation = raise_on_violation
    if _installed:
        return
    devseams.BUILD_HOOKS.append(_on_build)
    _installed = True


def uninstall() -> None:
    """Disarm (counters and findings survive; ``reset()`` clears
    them)."""
    global _installed
    if not _installed:
        return
    devseams.BUILD_HOOKS.remove(_on_build)
    _installed = False


def installed() -> bool:
    return _installed


def reset() -> None:
    """Clear counters, signatures and findings."""
    global _total
    with _mu:
        _counts.clear()
        _signatures.clear()
        _findings.clear()
        _total = 0


def compiles() -> Dict[str, int]:
    with _mu:
        return dict(_counts)


def total_compiles() -> int:
    with _mu:
        return _total


def compile_signatures() -> Dict[str, List[str]]:
    with _mu:
        return {k: list(v) for k, v in _signatures.items()}


def findings() -> List[RetraceFinding]:
    with _mu:
        return list(_findings)


def snapshot() -> int:
    """Opaque marker for :func:`retraces_since`: a steady-state region
    bracketed by the two must build nothing."""
    return total_compiles()


def retraces_since(snap: int) -> int:
    return total_compiles() - snap


@contextlib.contextmanager
def no_transfers():
    """Forbid host↔device transfers in this thread for the scope (see
    the module docstring); nests; needs no :func:`install`."""
    with devseams.guard(True):
        yield


@contextlib.contextmanager
def allow_transfers():
    """Escape hatch for a declared host boundary inside a
    ``no_transfers()`` region."""
    with devseams.guard(False):
        yield
