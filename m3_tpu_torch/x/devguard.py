"""Device-boundary guard: typed device errors, per-stage counters and
breakers.  The port's counterpart of ``m3_tpu/x/devguard.py``.

* **Typed errors** — :class:`DeviceError` and its kinds:
  :class:`DeviceOOM` (an allocation the card refused),
  :class:`CompileFailure` (a kernel that did not build),
  :class:`DeviceLost` (a sticky CUDA context error: the card's state is
  gone), :class:`DeviceStateError` (resident state unusable — the
  packed arena's sticky overflow flag, or a CUDA runtime error that
  names no better kind).  :func:`classify` maps what torch and the
  port's kernel wrappers raise to these types; anything it cannot place
  is NOT a device error and propagates raw (a programming bug must
  never trip a breaker).

* **The guarded seam** — :func:`run_guarded(stage, primary)` wraps every
  hot-path device entry point (arena ingest/consume, the series buffer
  append/drain, ``encode_batch_device`` / ``decode_batch_device`` and
  their sharded forms).  The device faultpoints fire, ``primary`` runs,
  a classified failure is counted per (stage, kind), recorded on the
  stage's circuit breaker (``x.breaker`` with ``kind="stage"``) and
  raised typed; success is counted as ``device.<stage>.calls``.

* **Faultpoints** — ``device.compile`` (before a stage's first device
  call in this process), ``device.dispatch`` (before every device
  call), ``device.transfer`` (at declared device-to-host boundaries,
  :func:`transfer_point`).  Error-mode triggers raise the class a real
  failure there would classify to (compile → CompileFailure, dispatch
  → DeviceOOM, transfer → DeviceLost), so device failures are
  injectable on a live node through ``POST /api/v1/debug/faults``.

Differences from the reference, by design: there is no fallback.  The
reference re-runs a failed batch on a second implementation (the jnp
ingest, a host drain, another codec tail) and skips the device while a
stage breaker is open; the port has one implementation a stage, so it
keeps the reference's own ``fallback=None`` path: the breaker records
and ``/health`` shows it, and the next call tries the card again.
``force_fallback`` / ``fallback_forced`` (the controller's
``device_fallback`` actuator) act only on stages with a fallback and are
left out.  The stage-breaker knobs are set by :func:`configure` (the
node config's ``device:`` section), never from the environment.
"""

from __future__ import annotations

import re
import threading
from typing import Callable, Dict

import torch

from m3_tpu_torch.x import fault
from m3_tpu_torch.x.breaker import breaker_for

__all__ = [
    "DeviceError", "DeviceOOM", "CompileFailure", "DeviceLost",
    "DeviceStateError", "classify", "run_guarded", "transfer_point",
    "configure", "counters", "reset_counters", "reset_stages", "status",
    "stage_breaker",
]


class DeviceError(RuntimeError):
    """A classified accelerator-boundary failure.  ``RuntimeError`` (not
    OSError) so the wire retry classifier never treats a device fault
    as a transport blip to retry into."""

    kind = "device"

    def __init__(self, stage: str, message: str = "",
                 cause: BaseException | None = None):
        detail = message or (f"{type(cause).__name__}: {cause}" if cause
                             else "")
        super().__init__(
            f"device {self.kind} at stage {stage!r}"
            + (f": {detail}" if detail else ""))
        self.stage = stage
        self.cause = cause


class DeviceOOM(DeviceError):
    """Device memory exhausted (a failed allocation)."""

    kind = "oom"


class CompileFailure(DeviceError):
    """A kernel of this stage did not build."""

    kind = "compile"


class DeviceLost(DeviceError):
    """The card's context is gone (a sticky CUDA error)."""

    kind = "lost"


class DeviceStateError(DeviceError):
    """Device-resident state is unusable (poisoned arena, failed
    restore) — the caller should restore from checkpoint or reset."""

    kind = "state"


# Message vocabulary, matched lowercase.  The port's own kernel wrappers
# raise "<what>: CUDA error <code> (<name>)" (parallel/_cuda.check) and
# "nvcc not found" / "CUDA kernel build failed" (parallel/_cuda.build);
# torch raises "CUDA error: <text>" and torch.OutOfMemoryError.
_OOM_PAT = ("cuda error: out of memory", "cuda out of memory")
_COMPILE_PAT = ("nvcc not found", "cuda kernel build failed")
# sticky context errors: the context must be torn down after these
_LOST_PAT = ("illegal memory access", "device-side assert",
             "unspecified launch failure", "illegal instruction",
             "misaligned address", "uncorrectable ecc")
_LOST_CODES = frozenset({214, 700, 702, 710, 714, 715, 716, 717, 718, 719})
_CUDA_CODE_RE = re.compile(r"cuda error (\d+) \(")
# Host-raised device-state shapes: the packed arena's sticky overflow
# raise.
_STATE_HOST_PAT = ("overflow-pool error", "arena state")


def classify(exc: BaseException) -> type | None:
    """The DeviceError subclass a raw exception maps to, or None when
    it is not a device failure (programming errors — ``TypeError``,
    ``ValueError`` — propagate raw and never count toward a stage
    breaker)."""
    if isinstance(exc, DeviceError):
        return type(exc)
    if isinstance(exc, torch.cuda.OutOfMemoryError):  # torch.OutOfMemoryError
        return DeviceOOM
    if not isinstance(exc, RuntimeError):
        return None
    msg = str(exc).lower()
    if any(p in msg for p in _OOM_PAT):
        return DeviceOOM
    if any(p in msg for p in _COMPILE_PAT):
        return CompileFailure
    m = _CUDA_CODE_RE.search(msg)
    if m is not None:
        code = int(m.group(1))
        if code == 2:  # cudaErrorMemoryAllocation
            return DeviceOOM
        return DeviceLost if code in _LOST_CODES else DeviceStateError
    if "cuda error" in msg or type(exc).__name__ == "AcceleratorError":
        # A CUDA runtime error we cannot place more precisely: the card
        # answered about ITS state, not a Python bug.
        return DeviceLost if any(p in msg for p in _LOST_PAT) else DeviceStateError
    if any(p in msg for p in _STATE_HOST_PAT):
        return DeviceStateError
    return None


# ---------------------------------------------------------------------------
# Stage registry + counters (the x/fault.py shape: thread-safe, cheap,
# counters survive everything short of reset_counters()).
# ---------------------------------------------------------------------------

_FAILURES = 5
_RESET_S = 10.0

_lock = threading.Lock()
_counters: Dict[str, int] = {}
_compiled: Dict[str, bool] = {}  # stage -> first device call done


def configure(failures: int | None = None,
              reset_s: float | None = None) -> None:
    """Config plumbing for the stage-breaker knobs.  Applies to stage
    breakers created AFTER the call (breaker_for create-time semantics)
    — run_node calls this before any guarded stage runs."""
    global _FAILURES, _RESET_S
    if failures is not None:
        _FAILURES = int(failures)
    if reset_s is not None:
        _RESET_S = float(reset_s)


def _bump(key: str, n: int = 1) -> None:
    with _lock:
        _counters[key] = _counters.get(key, 0) + n


def counters() -> Dict[str, int]:
    """Flat ``{"device.<stage>.calls": n, ".errors.<kind>": n}`` —
    mirrored onto /metrics by ``m3_tpu_torch.x.register_metrics``."""
    with _lock:
        return dict(_counters)


def reset_counters() -> None:
    with _lock:
        _counters.clear()


def reset_stages() -> None:
    """Test hygiene: forget per-stage compile markers and counters.
    (Stage breakers live in the x.breaker registry — reset that too
    for full isolation.)"""
    with _lock:
        _counters.clear()
        _compiled.clear()


def stage_breaker(stage: str):
    """The process-wide breaker for a guarded stage (shared via the
    x.breaker registry under ``stage:<name>``, kind="stage" — surfaces
    as ``breaker_state{kind="stage"}`` on /metrics)."""
    return breaker_for(f"stage:{stage}", failure_threshold=_FAILURES,
                       reset_timeout_s=_RESET_S, kind="stage")


def _fire_faultpoints(stage: str) -> None:
    """Evaluate the device faultpoints for one device call, raising the
    typed class a real failure at that boundary would classify to."""
    if not _compiled.get(stage):
        try:
            fault.fire("device.compile")
        except fault.FaultInjected as e:
            raise CompileFailure(stage, cause=e) from e
        with _lock:
            _compiled[stage] = True
    try:
        fault.fire("device.dispatch")
    except fault.FaultInjected as e:
        raise DeviceOOM(stage, cause=e) from e


def transfer_point(stage: str) -> None:
    """The ``device.transfer`` faultpoint: call at a declared
    device-to-host boundary INSIDE a guarded primary, so an injected
    transfer failure counts against the stage like any other device
    error."""
    try:
        fault.fire("device.transfer")
    except fault.FaultInjected as e:
        raise DeviceLost(stage, cause=e) from e


def run_guarded(stage: str, primary: Callable[[], object]):
    """``primary()`` behind the stage's device guard: the faultpoints
    fire and ``primary`` runs; a classified failure is counted as
    ``device.<stage>.errors.<kind>``, recorded on the stage breaker and
    raised typed (the cause chained); success is counted as
    ``device.<stage>.calls`` and closes the breaker.  Unclassified
    exceptions propagate raw and leave the breaker alone.  The
    reference's ``run_guarded(stage, primary, fallback=None)``."""
    br = stage_breaker(stage)
    try:
        _fire_faultpoints(stage)
        result = primary()
    except BaseException as e:
        cls = classify(e)
        if cls is None:
            raise
        err = e if isinstance(e, DeviceError) else cls(stage, cause=e)
        _bump(f"device.{stage}.errors.{err.kind}")
        br.record_failure()
        raise err from (e if err is not e else None)
    br.record_success()
    _bump(f"device.{stage}.calls")
    return result


def status() -> dict:
    """The /health ``device`` document: per-stage breaker state +
    counters (stages appear after their first guarded call)."""
    from m3_tpu_torch.x.breaker import all_breakers

    stages: Dict[str, dict] = {}
    for key, n in counters().items():
        # device.<stage>.<what...> — stage names themselves contain
        # dots (arena.ingest), so split on the KNOWN suffixes
        rest = key[len("device."):]
        if rest.endswith(".calls"):
            stages.setdefault(rest[:-len(".calls")], {})["calls"] = n
        else:
            st, _, kind = rest.rpartition(".errors.")
            if st:
                stages.setdefault(st, {}).setdefault("errors", {})[kind] = n
    for name, br in all_breakers().items():
        if name.startswith("stage:"):
            stages.setdefault(name[len("stage:"):], {})["breaker"] = br.state
    return {"stages": stages}
