"""SLO-burn-driven self-healing: the guarded control plane.  The port's
copy of ``m3_tpu/x/controller.py`` without the ``device_fallback``
actuator: the reference's ``devguard_fallback_actuator`` forces every
guarded stage onto its host fallback, and the port's device stages have
no fallback (``x/devguard``), so there is nothing for it to switch.

The node has sensors (selfmon burn-rate verdicts queryable in PromQL,
devguard stage breakers, membudget gauges) and actuators (admission
slots, ingest backoff, membudget budgets, the
TopologyWatcher/ShardMigrator path); without a wire between them a
sustained fault degraded the node until a human read ``/health`` and
turned a knob.  This module is that wire, built SRE-workbook style
(multi-window multi-burn-rate mitigation, the same framework
``query/slo.py``'s rules implement) with SALSA-style self-adjustment
(arXiv:2102.12531) as the precedent for state that resizes itself under
observed load.  Guardrails ARE the feature:

* **Typed actuators.**  Every mutable knob is an :class:`Actuator`
  with declared bounds — ``baseline`` (the configured resting value),
  ``shed_limit`` (the furthest mitigation may push it) and ``step``
  (one tick's movement).  Every application is clamped to
  ``[lo, hi] = sorted(baseline, shed_limit)``; nothing the controller
  does can leave the declared envelope, and the factories at the end
  of this module are the only mutation path (the placement-cas pattern
  for control state).
* **Hysteresis + hold.**  A binding fires only after ``fire_ticks``
  CONSECUTIVE firing verdicts and relaxes only after ``clear_ticks``
  consecutive ticks with burn at or below ``clear_burn`` (distinct
  thresholds: the SLO fires on ``factor x budget``, the controller
  clears strictly below it) AND after ``hold_ticks`` post-action hold
  — a flapping verdict moves nothing.
* **Rate limit.**  Each actuator moves at most once per
  ``min_interval_s`` (wall clock, injectable), shed or relax.
* **Unknown means HOLD.**  A rule whose verdict is missing, errored
  (``burn: None``) or NaN — the SLO evaluator's explicit unknown — freezes
  its binding exactly where it is: no shed, no relax, counted
  ``held_unknown``.  A controller acting on data it does not have is
  worse than no controller.
* **Half-open relax.**  Recovery is x/breaker's half-open discipline
  applied to levels: one probe step back toward baseline per qualifying
  tick; a re-firing verdict re-sheds immediately (the probe failed),
  a quiet one keeps stepping until every actuator rests at baseline.
* **Every decision is a series.**  Each action updates a
  ``controller_action{rule=,actuator=,action=}`` gauge (value = the
  level after the action), which the next selfmon scrape stores into
  ``_m3_selfmon`` — the controller's behavior is retro-queryable PromQL
  exactly like the SLOs that drive it.  Gauges are interned lazily on
  FIRST action, so a healthy run emits zero ``controller_action``
  series.

The controller reads verdicts from the node's own
:class:`~m3_tpu_torch.query.slo.SLOEvaluator` (fresh each pass: the mediator
runs the controller stage right after ``selfmon.tick``), and —
for bindings that demand SUSTAINED burn (the placement rebalance) —
re-reads the stored burn history through the ordinary PromQL engine
under an ``x/deadline`` budget (:class:`BurnHistory`).
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterable, Tuple

import numpy as np

from m3_tpu_torch.query.block import to_host
from m3_tpu_torch.x import deadline as xdeadline
from m3_tpu_torch.x.deadline import Deadline

__all__ = [
    "Actuator", "ActuatorRegistry", "Binding", "BurnHistory", "Controller",
    "admission_actuator", "ingest_backoff_actuator", "membudget_actuator",
    "checkpoint_actuator",
    "rebalance_actuator", "emergency_cleanup_actuator",
]


@dataclasses.dataclass
class Actuator:
    """One typed, bounds-clamped knob.

    ``apply(value)`` performs the mutation (the ONLY place the
    underlying limit/budget/flag is touched).  Level actuators step between ``baseline`` and
    ``shed_limit``; ``pulse`` actuators (checkpoint save, rebalance
    tick) fire ``apply`` as a one-shot on every shed and have nothing
    to relax — they always rest at baseline.
    """

    name: str
    kind: str                      # "admission"|"ingest"|"membudget"|...
    baseline: float
    shed_limit: float
    step: float
    apply: Callable[[float], None]
    pulse: bool = False
    unit: str = ""                 # for status()/docs readability

    def __post_init__(self):
        if not self.name:
            raise ValueError("actuator needs a name")
        if self.step <= 0:
            raise ValueError(f"actuator {self.name}: step must be > 0")
        self.lo = min(self.baseline, self.shed_limit)
        self.hi = max(self.baseline, self.shed_limit)
        self.value = float(self.baseline)
        self.sheds = 0
        self.relaxes = 0

    def clamp(self, v: float) -> float:
        return min(self.hi, max(self.lo, v))

    @property
    def at_baseline(self) -> bool:
        return self.pulse or self.value == self.baseline

    def _move(self, target: float) -> float | None:
        """One clamped step toward ``target``; returns the new value or
        None when already there (no mutation, no emission)."""
        if self.value == target:
            return None
        step = self.step if target > self.value else -self.step
        new = self.clamp(self.value + step)
        # overshoot lands exactly on the target bound
        if (step > 0) != (new <= target):
            new = target
        if new == self.value:
            return None
        self.apply(new)
        self.value = new
        return new

    def shed(self) -> float | None:
        """One step toward ``shed_limit`` (pulse: fire the one-shot).
        Returns the applied value, or None when nothing moved."""
        if self.pulse:
            self.apply(self.shed_limit)
            self.sheds += 1
            return self.shed_limit
        new = self._move(self.shed_limit)
        if new is not None:
            self.sheds += 1
        return new

    def relax(self) -> float | None:
        """One half-open probe step back toward ``baseline``."""
        if self.pulse:
            return None
        new = self._move(self.baseline)
        if new is not None:
            self.relaxes += 1
        return new

    def snapshot(self) -> dict:
        out = {
            "kind": self.kind,
            "baseline": self.baseline,
            "shed_limit": self.shed_limit,
            "step": self.step,
            "value": self.value,
            "at_baseline": self.at_baseline,
            "sheds": self.sheds,
            "relaxes": self.relaxes,
        }
        if self.pulse:
            out["pulse"] = True
        if self.unit:
            out["unit"] = self.unit
        return out


class ActuatorRegistry:
    """Name-keyed actuator set; the controller acts ONLY through it."""

    def __init__(self, actuators: Iterable[Actuator] = ()):
        self._acts: Dict[str, Actuator] = {}
        for a in actuators:
            self.register(a)

    def register(self, act: Actuator) -> Actuator:
        if act.name in self._acts:
            raise ValueError(f"duplicate actuator {act.name!r}")
        self._acts[act.name] = act
        return act

    def get(self, name: str) -> Actuator:
        return self._acts[name]

    def names(self) -> list:
        return sorted(self._acts)

    def __contains__(self, name: str) -> bool:
        return name in self._acts

    def snapshot(self) -> dict:
        return {n: a.snapshot() for n, a in sorted(self._acts.items())}


@dataclasses.dataclass(frozen=True)
class Binding:
    """One SLO rule wired to a set of actuators with its hysteresis."""

    rule: str                      # SLO rule name (query/slo.py)
    actuators: Tuple[str, ...]     # ActuatorRegistry names
    name: str = ""                 # unique; defaults to the rule name
    fire_ticks: int = 2            # consecutive firing verdicts to act
    clear_ticks: int = 3           # consecutive clear verdicts to relax
    clear_burn: float = 1.0        # burn multiple at/under which "clear"
    hold_ticks: int = 2            # post-shed ticks before relax starts
    # sustained-burn demand (the rebalance binding): shed additionally
    # requires min_over_time(burn[window]) >= sustain_burn from the
    # stored history — unknown history HOLDs like an unknown verdict
    sustain_window: str = ""
    sustain_burn: float = 0.0

    def __post_init__(self):
        if not self.rule:
            raise ValueError("binding needs a rule name")
        if not self.actuators:
            raise ValueError(f"binding {self.rule}: needs actuators")
        if self.fire_ticks < 1 or self.clear_ticks < 1:
            raise ValueError(
                f"binding {self.rule}: fire_ticks/clear_ticks must be >= 1")
        if self.hold_ticks < 0:
            raise ValueError(f"binding {self.rule}: hold_ticks must be >= 0")
        if self.clear_burn <= 0:
            raise ValueError(f"binding {self.rule}: clear_burn must be > 0")
        if not self.name:
            object.__setattr__(self, "name", self.rule)


class BurnHistory:
    """Sustained-burn reads over the STORED ``slo_burn`` history,
    through the ordinary PromQL engine under an ``x/deadline`` budget —
    the same retro-query an operator would issue.  Any failure (empty
    history, deadline, engine error) returns None: unknown, which the
    controller treats as HOLD."""

    def __init__(self, engine, metric: str = "m3tpu_slo_burn",
                 deadline_s: float = 1.0):
        self.engine = engine
        self.metric = metric
        self.deadline_s = float(deadline_s)

    def min_burn(self, rule: str, window: str,
                 now_nanos: int) -> float | None:
        """min-over-window burn for ``rule`` (worst instance): the
        burn multiple the rule NEVER dropped below across the window —
        the sustained-burn witness."""
        q = f'min_over_time({self.metric}{{rule="{rule}"}}[{window}])'
        try:
            with xdeadline.bind(Deadline(self.deadline_s)):
                block = self.engine.execute_instant(q, now_nanos)
            vals = to_host(block.values)
            if vals.size == 0:
                return None
            col = vals[:, -1]
            finite = col[~np.isnan(col)]
            if finite.size == 0:
                return None
            return float(finite.max())
        except Exception:  # noqa: BLE001 — unknown history means HOLD
            return None


class _BindingState:
    __slots__ = ("firing_streak", "clear_streak", "hold_left",
                 "held_unknown", "engaged")

    def __init__(self):
        self.firing_streak = 0
        self.clear_streak = 0
        self.hold_left = 0
        self.held_unknown = 0
        self.engaged = False


def _unknown(burn, firing) -> bool:
    return (firing is None or burn is None
            or (isinstance(burn, float) and math.isnan(burn)))


class Controller:
    """The mediator-tick control loop.

    ``burn_source()`` returns the SLO status document
    (``SLOEvaluator.status()``'s shape: ``{"rules": {name: {burn,
    firing, ...}}}``); ``clock`` is injectable for the fake-clock test
    matrix.  ``tick(now_nanos)`` runs one pass and returns its stats —
    the mediator records them like any other stage.  ``status()`` is
    the ``/health`` ``controller`` section (lock-cheap, no queries).
    """

    def __init__(self, registry: ActuatorRegistry,
                 bindings: Iterable[Binding],
                 burn_source: Callable[[], dict],
                 clock: Callable[[], float] = time.monotonic,
                 instrument=None, min_interval_s: float = 5.0,
                 history: BurnHistory | None = None):
        self.registry = registry
        self.bindings: Tuple[Binding, ...] = tuple(bindings)
        names = [b.name for b in self.bindings]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate binding names {names}")
        for b in self.bindings:
            for a in b.actuators:
                if a not in registry:
                    raise ValueError(
                        f"binding {b.name}: unknown actuator {a!r}")
        self.burn_source = burn_source
        self.min_interval_s = float(min_interval_s)
        self.history = history
        self._clock = clock
        self._scope = instrument
        self._gauges: dict = {}   # (rule, actuator, action) -> gauge,
        #                           interned lazily on FIRST action so a
        #                           quiet controller stores zero series
        self._lock = threading.Lock()
        self._states = {b.name: _BindingState() for b in self.bindings}
        self._last_action: Dict[str, float] = {}  # actuator -> clock()
        self.ticks = 0
        self.actions_total = 0
        self.held_unknown = 0
        self.rate_limited = 0
        self.actions = deque(maxlen=256)

    # -- emission ----------------------------------------------------------

    def _emit(self, rule: str, actuator: str, action: str,
              value: float) -> None:
        # reached only from tick(), which holds _lock for the whole pass
        self.actions_total += 1  # m3lint: disable=lock-discipline
        self.actions.append({
            "unix": round(time.time(), 3), "rule": rule,
            "actuator": actuator, "action": action,
            "value": round(float(value), 6),
        })
        if self._scope is None:
            return
        key = (rule, actuator, action)
        g = self._gauges.get(key)
        if g is None:
            # tag values are config-bounded (rules x actuators x two
            # verbs), never request-derived
            g = self._scope.tagged({
                "rule": rule, "actuator": actuator, "action": action,
            }).gauge("controller_action")
            self._gauges[key] = g
        g.update(float(value))

    def _allowed(self, actuator: str) -> bool:
        last = self._last_action.get(actuator)
        if last is not None and self._clock() - last < self.min_interval_s:
            # reached only from tick(), which holds _lock for the pass
            self.rate_limited += 1  # m3lint: disable=lock-discipline
            return False
        return True

    # -- the pass ----------------------------------------------------------

    def tick(self, now_nanos: int | None = None) -> dict:
        if now_nanos is None:
            now_nanos = time.time_ns()
        with self._lock:
            self.ticks += 1
            doc = self.burn_source() or {}
            rules = doc.get("rules", {}) or {}
            stats = {"sheds": 0, "relaxes": 0, "held_unknown": 0,
                     "rate_limited_before": self.rate_limited}
            for b in self.bindings:
                st = self._states[b.name]
                verdict = rules.get(b.rule)
                burn = verdict.get("burn") if verdict else None
                firing = verdict.get("firing") if verdict else None
                if _unknown(burn, firing):
                    # explicit-unknown contract: freeze the binding
                    st.held_unknown += 1
                    self.held_unknown += 1
                    stats["held_unknown"] += 1
                    continue
                if firing:
                    st.firing_streak += 1
                    st.clear_streak = 0
                    if st.firing_streak >= b.fire_ticks:
                        stats["sheds"] += self._shed(b, st, now_nanos)
                else:
                    st.firing_streak = 0
                    if burn <= b.clear_burn:
                        st.clear_streak += 1
                    else:
                        st.clear_streak = 0
                    if st.hold_left > 0:
                        st.hold_left -= 1
                    elif st.engaged and st.clear_streak >= b.clear_ticks:
                        stats["relaxes"] += self._relax(b, st)
                st.engaged = any(
                    not self.registry.get(a).at_baseline
                    for a in b.actuators)
            stats["rate_limited"] = (self.rate_limited
                                     - stats.pop("rate_limited_before"))
            return stats

    def _shed(self, b: Binding, st: _BindingState, now_nanos: int) -> int:
        if b.sustain_window:
            sustained = (self.history.min_burn(b.rule, b.sustain_window,
                                               now_nanos)
                         if self.history is not None else None)
            if sustained is None:
                # no queryable history yet: unknown, HOLD (reached only
                # from tick(), which holds _lock for the whole pass)
                st.held_unknown += 1
                self.held_unknown += 1  # m3lint: disable=lock-discipline
                return 0
            if sustained < b.sustain_burn:
                return 0
        moved = 0
        for name in b.actuators:
            if not self._allowed(name):
                continue
            new = self.registry.get(name).shed()
            if new is not None:
                self._last_action[name] = self._clock()
                self._emit(b.rule, name, "shed", new)
                moved += 1
        if moved:
            st.engaged = True
            st.hold_left = b.hold_ticks
        return moved

    def _relax(self, b: Binding, st: _BindingState) -> int:
        moved = 0
        for name in b.actuators:
            act = self.registry.get(name)
            if act.at_baseline or not self._allowed(name):
                continue
            new = act.relax()
            if new is not None:
                self._last_action[name] = self._clock()
                self._emit(b.rule, name, "relax", new)
                moved += 1
        return moved

    # -- read surface ------------------------------------------------------

    def status(self) -> dict:
        """The ``/health`` ``controller`` section: configuration,
        per-binding state, actuator envelope + positions, and the
        recent action tail (cheap: no queries, no engine)."""
        with self._lock:
            return {
                "enabled": True,
                "ticks": self.ticks,
                "actions_total": self.actions_total,
                "held_unknown": self.held_unknown,
                "rate_limited": self.rate_limited,
                "min_interval_s": self.min_interval_s,
                "bindings": {
                    b.name: {
                        "rule": b.rule,
                        "actuators": list(b.actuators),
                        "fire_ticks": b.fire_ticks,
                        "clear_ticks": b.clear_ticks,
                        "clear_burn": b.clear_burn,
                        "hold_ticks": b.hold_ticks,
                        **({"sustain_window": b.sustain_window,
                            "sustain_burn": b.sustain_burn}
                           if b.sustain_window else {}),
                        "firing_streak": self._states[b.name].firing_streak,
                        "clear_streak": self._states[b.name].clear_streak,
                        "hold_left": self._states[b.name].hold_left,
                        "held_unknown": self._states[b.name].held_unknown,
                        "engaged": self._states[b.name].engaged,
                    }
                    for b in self.bindings
                },
                "actuators": self.registry.snapshot(),
                "recent": list(self.actions)[-20:],
            }


# ---------------------------------------------------------------------------
# Actuator factories — the blessed mutation closures.  Every direct
# write to an admission limit / backoff hint / membudget budget lives
# HERE (x/controller.py).
# ---------------------------------------------------------------------------


def admission_actuator(admission, floor: int, step: int = 1,
                       name: str = "query_slots") -> Actuator:
    """Query-slot shedding: step ``max_concurrent`` down toward
    ``floor`` under query burn, back up to the configured baseline on
    recovery.  A baseline of 0 (gating off) sheds INTO gating — the
    controller imposes a temporary slot cap on an otherwise ungated
    node and removes it again at baseline."""
    return Actuator(
        name, "admission",
        baseline=float(admission.max_concurrent),
        shed_limit=float(floor), step=float(step), unit="slots",
        apply=lambda v: admission.resize(max_concurrent=int(v)))


def ingest_backoff_actuator(server, ceiling_ms: int, step_ms: int,
                            name: str = "ingest_backoff") -> Actuator:
    """Ingest shedding: raise the wire BACKOFF hint toward
    ``ceiling_ms`` under ingest burn so well-behaved clients slow down
    before the queue sheds for them."""
    def apply(v: float) -> None:
        server.backoff_hint_ms = int(v)

    return Actuator(
        name, "ingest", baseline=float(server.backoff_hint_ms),
        shed_limit=float(ceiling_ms), step=float(step_ms), unit="ms",
        apply=apply)


def membudget_actuator(floor_bytes: int, step_bytes: int,
                       name: str = "membudget") -> Actuator:
    """Device-memory tightening: step the admission budget down toward
    ``floor_bytes`` under device burn — NEW device structures admit
    against the tightened budget while existing reservations stand
    (membudget's shrink semantics)."""
    from m3_tpu_torch.x import membudget

    return Actuator(
        name, "membudget", baseline=float(membudget.budget()),
        shed_limit=float(floor_bytes), step=float(step_bytes),
        unit="bytes", apply=lambda v: membudget.set_budget(int(v)))


def checkpoint_actuator(checkpointer, name: str = "checkpoint") -> Actuator:
    """Pre-emptive durability pulse: save the aggregator checkpoint NOW
    (device burn often precedes device loss — the checkpoint is the
    recovery substrate)."""
    return Actuator(
        name, "checkpoint", baseline=0.0, shed_limit=1.0, step=1.0,
        pulse=True, apply=lambda v: checkpointer.save())


def rebalance_actuator(migrator, name: str = "rebalance") -> Actuator:
    """Placement pulse: run one shard-migration pass now (the
    TopologyWatcher/ShardMigrator seam; ``tick()`` is
    ``_tick_mu``-serialized against the mediator's own pass)."""
    return Actuator(
        name, "placement", baseline=0.0, shed_limit=1.0, step=1.0,
        pulse=True, apply=lambda v: migrator.tick())


def emergency_cleanup_actuator(fn: Callable[[], object],
                               name: str = "emergency_cleanup") -> Actuator:
    """Space-reclaim pulse for disk burn: run the cleanup machinery NOW
    (superseded volumes, stale snapshots, retention-aged quarantine,
    fully-flushed commitlog segments) instead of waiting for its
    mediator cadence — the controller's answer to a filling disk, fired
    alongside ingest backoff so reclaim and shed act together."""
    return Actuator(
        name, "disk", baseline=0.0, shed_limit=1.0, step=1.0,
        pulse=True, apply=lambda v: fn())
