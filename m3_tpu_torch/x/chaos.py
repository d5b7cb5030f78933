"""Deterministic chaos scheduler: a scripted fault timeline for soaks.
The port's copy of ``m3_tpu/x/chaos.py`` over the port's own fault
registry: the same timeline grammar, validation and event list for the
same ``(seed, timeline)``.

The fault substrate (x/fault faultpoints, process kills, fileset
corruption + quarantine, rolling replace) is armed point-by-point by
individual scenarios.  A soak needs the opposite
shape: ONE seeded script that drives *many* fault families against a
live cluster on a fixed clock, so two runs of the same seed produce the
same chaos and an SLO artifact is comparable run-over-run.

Two pieces:

* :class:`ChaosEvent` / :func:`parse_timeline` — the declarative
  timeline.  Each event fires at a fixed offset from scheduler start:

  =============  ==========================================================
  action         meaning (ops method called)
  =============  ==========================================================
  ``phase``      marks an SLO phase boundary (no cluster mutation); the
                 soak buckets latency between consecutive phase marks
  ``kill``       SIGKILL a node (``ops.kill(node)``)
  ``restart``    start a killed node (``ops.restart(node)``)
  ``wire_fault`` arm faultpoints on a LIVE node through its
                 ``POST /api/v1/debug/faults`` (``ops.arm_faults``);
                 ``arg`` is a faultpoint spec string (``x.fault``'s
                 grammar)
  ``device_fault``  arm DEVICE-boundary faultpoints (``device.compile``
                 / ``device.dispatch`` / ``device.transfer`` — the
                 x/devguard seam) on a live node, same endpoint and
                 grammar as ``wire_fault``; every point must be in the
                 ``device.`` namespace (eager-validated) so a timeline
                 cannot silently arm a wire point under the device
                 phase label.  Error-mode triggers surface as typed
                 DeviceOOM/CompileFailure/DeviceLost and trip the
                 per-stage breakers — no real device fault needed.
  ``sustained``  a burn-window-length fault as ONE entry: arm the
                 ``arg`` spec at ``at_s``, hold ``hold_s`` seconds,
                 auto-disarm.  Expanded by the scheduler into the
                 arm + ``clear_faults`` pair (wire or device arm is
                 inferred from the point namespaces; mixing the two
                 in one spec is rejected eagerly), so ops adapters
                 need no new verbs and the log still shows the exact
                 fault window.  This is the self-healing soak's
                 primitive: long enough to drive an SLO burn window,
                 gone again so recovery is provable.
  ``clear_faults``  disarm every faultpoint on a node (same endpoint)
  ``corrupt``    byte-flip a flushed fileset volume on a node's disk
                 (``ops.corrupt(node, seed)`` — quarantine/scrub must
                 recover it)
  ``replace``    rolling node replace: retire ``node``, bring in the
                 spare (``ops.replace(node)`` drives the admin
                 placement/replace verb + the migration path)
  ``disk_pressure``  ballast-fill a node's storage root until its free
                 ratio drops to ``arg`` (a float in (0, 1)); the node's
                 disk ledger must cross its watermarks, shed typed, and
                 keep serving (``ops.disk_fill(node, target)``).  With
                 ``hold_s`` the scheduler auto-appends the matching
                 ``disk_release`` — the sustained-window idiom.
  ``disk_release``  delete the ballast again
                 (``ops.disk_release(node)``) so relax-back is provable
  =============  ==========================================================

* :class:`ChaosScheduler` — executes the timeline against an *ops*
  adapter (the soak cluster; tests pass a fake) on an injectable
  clock/sleep, recording every execution (offset asked, offset fired,
  ok/error) into :attr:`log` — the artifact's chaos section is that log
  verbatim, so a reader can line fault windows up with SLO phases.

Determinism contract: the timeline is explicit (no random event
choices); the run ``seed`` namespaces whatever randomness the events
*use* — faultpoint specs without an explicit ``seed=`` get
``seed=<run_seed + index>`` appended, corruption byte offsets derive
from ``(seed, event index)``.  Same seed + same timeline = same chaos.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List

from m3_tpu_torch.x import fault

__all__ = ["ChaosEvent", "ChaosScheduler", "expand_sustained",
           "parse_timeline"]

ACTIONS = ("phase", "kill", "restart", "wire_fault", "device_fault",
           "sustained", "clear_faults", "corrupt", "replace",
           "disk_pressure", "disk_release")


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    at_s: float          # offset from scheduler start
    action: str          # one of ACTIONS
    node: int | None = None  # target node index (phase: None)
    arg: str = ""        # wire_fault: spec string; phase: phase label
    hold_s: float = 0.0  # sustained only: seconds armed before disarm

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(
                f"chaos action {self.action!r}: must be one of {ACTIONS}")
        if self.action == "phase" and not self.arg:
            raise ValueError("phase events need a label in 'arg'")
        if self.action != "phase" and self.node is None:
            raise ValueError(f"{self.action} event needs a 'node'")
        if self.action not in ("sustained", "disk_pressure") and self.hold_s:
            raise ValueError(
                f"{self.action} events take no 'hold_s' (sustained only)")
        if self.action == "wire_fault":
            fault.parse_faults(self.arg)  # validate at BUILD time
        if self.action == "device_fault":
            specs = fault.parse_faults(self.arg)  # eager, like wire_fault
            bad = [p for p, _, _ in specs if not p.startswith("device.")]
            if bad:
                raise ValueError(
                    f"device_fault event arms non-device points {bad}: "
                    "use wire_fault for wire-boundary points")
            if not specs:
                raise ValueError("device_fault events need a spec in 'arg'")
        if self.action == "sustained":
            if self.hold_s <= 0:
                raise ValueError("sustained events need 'hold_s' > 0")
            self._arm_action()  # eager: spec parses, namespaces uniform
        if self.action == "disk_pressure":
            # arg = target free RATIO after the fill; eager-validated so
            # a fat-fingered percentage (e.g. "15") fails at parse time.
            try:
                target = float(self.arg)
            except ValueError:
                raise ValueError(
                    "disk_pressure 'arg' must be a target free ratio, "
                    f"got {self.arg!r}") from None
            if not 0.0 < target < 1.0:
                raise ValueError(
                    "disk_pressure target free ratio must be in (0, 1), "
                    f"got {target}")

    def _arm_action(self) -> str:
        """The concrete arm verb a ``sustained`` event expands to,
        inferred from the spec's point namespaces (eager-validated:
        device and wire points cannot share one sustained window —
        their phase labels and mitigation paths differ)."""
        specs = fault.parse_faults(self.arg)
        if not specs:
            raise ValueError("sustained events need a spec in 'arg'")
        device = [p.startswith("device.") for p, _, _ in specs]
        if any(device) and not all(device):
            raise ValueError(
                "sustained event mixes device and wire points: "
                "use two events")
        return "device_fault" if all(device) else "wire_fault"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def parse_timeline(spec: dict) -> tuple[int, List[ChaosEvent]]:
    """``{"seed": N, "events": [{"at_s": ..., "action": ..., ...}]}``
    → ``(seed, events sorted by offset)``.  Validation is eager and
    total: a typo'd action or a malformed faultpoint spec fails at
    parse time, never mid-soak."""
    unknown = set(spec) - {"seed", "events"}
    if unknown:
        raise ValueError(f"chaos timeline: unknown keys {sorted(unknown)}")
    events = []
    for i, e in enumerate(spec.get("events", ())):
        bad = set(e) - {"at_s", "action", "node", "arg", "hold_s"}
        if bad:
            raise ValueError(f"chaos event #{i}: unknown keys {sorted(bad)}")
        events.append(ChaosEvent(
            at_s=float(e["at_s"]), action=e["action"],
            node=e.get("node"), arg=e.get("arg", ""),
            hold_s=float(e.get("hold_s", 0.0))))
    return int(spec.get("seed", 0)), sorted(events, key=lambda e: e.at_s)


def expand_sustained(events: List[ChaosEvent]) -> List[ChaosEvent]:
    """Replace every ``sustained`` event with its concrete
    arm + ``clear_faults`` pair (arm verb from the spec's namespaces,
    disarm at ``at_s + hold_s``), re-sorted.  Ops adapters therefore
    never see ``sustained`` — the scheduler applies this expansion, and
    the log records the exact armed window as two entries."""
    out: List[ChaosEvent] = []
    for ev in events:
        if ev.action == "sustained":
            out.append(ChaosEvent(at_s=ev.at_s, action=ev._arm_action(),
                                  node=ev.node, arg=ev.arg))
            out.append(ChaosEvent(at_s=ev.at_s + ev.hold_s,
                                  action="clear_faults", node=ev.node))
        elif ev.action == "disk_pressure" and ev.hold_s:
            # Same windowing idiom for disk pressure: fill now, release
            # at at_s + hold_s, so relax-back is part of the timeline.
            out.append(ChaosEvent(at_s=ev.at_s, action="disk_pressure",
                                  node=ev.node, arg=ev.arg))
            out.append(ChaosEvent(at_s=ev.at_s + ev.hold_s,
                                  action="disk_release", node=ev.node))
        else:
            out.append(ev)
    return sorted(out, key=lambda e: e.at_s)


def _seeded_spec(spec: str, seed: int) -> str:
    """Append ``seed=`` to every faultpoint entry that lacks one, so a
    timeline's wire faults replay identically under the run seed."""
    out = []
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        if not any(opt.startswith("seed=") for opt in entry.split(":")[1:]):
            entry = f"{entry}:seed={seed}"
        out.append(entry)
    return ";".join(out)


class ChaosScheduler:
    """Run a timeline against an ops adapter on a background thread.

    ``ops`` must provide ``kill(node)``, ``restart(node)``,
    ``arm_faults(node, spec)``, ``clear_faults(node)``,
    ``corrupt(node, seed)``, ``replace(node)``,
    ``disk_fill(node, target)``, ``disk_release(node)``, and
    ``phase(label)``.
    An event whose op RAISES is recorded in :attr:`log` with its error
    and the run continues — one failed injection must not silently
    cancel the rest of the chaos (the artifact shows exactly what
    fired).  ``clock``/``sleep`` are injectable so unit tests replay a
    timeline on a fake clock in microseconds.
    """

    def __init__(self, timeline: List[ChaosEvent], ops, seed: int = 0,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] | None = None):
        self.timeline = expand_sustained(
            sorted(timeline, key=lambda e: e.at_s))
        self.ops = ops
        self.seed = int(seed)
        self._clock = clock
        self._stop = threading.Event()
        # default sleep is interruptible via stop() — a soak teardown
        # must not wait out a multi-minute quiet window in the timeline
        self._sleep = sleep if sleep is not None else (
            lambda s: self._stop.wait(s))
        self._thread: threading.Thread | None = None
        self.log: List[dict] = []
        self._log_lock = threading.Lock()

    # -- execution ---------------------------------------------------------

    def run(self) -> List[dict]:
        """Execute synchronously (tests / in-thread callers)."""
        t0 = self._clock()
        for i, ev in enumerate(self.timeline):
            delay = ev.at_s - (self._clock() - t0)
            if delay > 0:
                self._sleep(delay)
            if self._stop.is_set():
                break
            self._fire(i, ev, t0)
        return self.log

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()

    def stop(self, timeout_s: float = 30.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout_s)

    def join(self, timeout_s: float | None = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout_s)

    @property
    def done(self) -> bool:
        return self._thread is not None and not self._thread.is_alive()

    def _fire(self, index: int, ev: ChaosEvent, t0: float) -> None:
        rec = dict(ev.to_dict(), fired_at_s=round(self._clock() - t0, 3),
                   ok=True)
        try:
            if ev.action == "phase":
                self.ops.phase(ev.arg)
            elif ev.action == "kill":
                self.ops.kill(ev.node)
            elif ev.action == "restart":
                self.ops.restart(ev.node)
            elif ev.action in ("wire_fault", "device_fault"):
                self.ops.arm_faults(
                    ev.node, _seeded_spec(ev.arg, self.seed + index))
            elif ev.action == "clear_faults":
                self.ops.clear_faults(ev.node)
            elif ev.action == "corrupt":
                self.ops.corrupt(ev.node, self.seed + index)
            elif ev.action == "replace":
                self.ops.replace(ev.node)
            elif ev.action == "disk_pressure":
                self.ops.disk_fill(ev.node, float(ev.arg))
            elif ev.action == "disk_release":
                self.ops.disk_release(ev.node)
        except Exception as e:  # noqa: BLE001 — recorded, run continues
            rec["ok"] = False
            rec["error"] = f"{type(e).__name__}: {e}"
        with self._log_lock:
            self.log.append(rec)
