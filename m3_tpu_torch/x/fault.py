"""Process-global fault-injection registry: named faultpoints at the
disk and read boundaries (``commitlog.flush``, ``fs.*``, ``query.fetch``)
armed with one of four modes:

* ``drop``    — the operation is lost (the SITE decides what a drop
  means; the commitlog flush site skips the fsync).
* ``delay``   — sleep ``ms`` before proceeding.
* ``error``   — raise :class:`FaultInjected` (an ``OSError`` subclass,
  so handlers treat it exactly like a real failure).
* ``corrupt`` — flip one byte of the payload passing through
  :func:`mangle` (checksum/torn-frame paths).

Every armed spec owns a :class:`random.Random` seeded by ``(seed, point
name, mode)`` as a string, so a scenario replays identically; a spec
fires at most ``n`` times, with probability ``p``, after skipping
``after`` passes.  Counters survive re-arming.

The port's copy of the parts of ``m3_tpu/x/fault.py`` that ``persist``
and the storage adapter use: no spec grammar, no environment arming and
no HTTP builders.  The registry is this package's own, apart from the
reference package's.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, List

__all__ = [
    "FaultInjected", "FaultSpec", "arm", "armed", "disarm", "fire",
    "mangle", "counters", "reset_counters",
]


class FaultInjected(ConnectionError):
    """Raised by error-mode faultpoints.  ``ConnectionError`` (hence
    ``OSError``) so socket sites' existing handlers and the retry
    classifier treat it as a genuine transport/disk failure."""


MODES = ("drop", "delay", "error", "corrupt")


class FaultSpec:
    """One armed behavior on one point; a point may hold several."""

    __slots__ = ("point", "mode", "p", "n", "after", "delay_s", "seed",
                 "_rng", "_passes", "triggers", "_lock")

    def __init__(self, point: str, mode: str, p: float = 1.0,
                 n: int | None = None, after: int = 0,
                 delay_ms: float = 0.0, seed: int = 0):
        if mode not in MODES:
            raise ValueError(f"fault mode {mode!r}: must be one of {MODES}")
        self.point = point
        self.mode = mode
        self.p = float(p)
        self.n = n
        self.after = int(after)
        self.delay_s = float(delay_ms) / 1000.0
        self.seed = int(seed)
        # String seeding is deterministic across processes (sha512 of
        # the string, no PYTHONHASHSEED involvement).
        self._rng = random.Random(f"{seed}:{point}:{mode}")
        self._passes = 0
        self.triggers = 0
        self._lock = threading.Lock()

    def should_trigger(self) -> bool:
        with self._lock:
            self._passes += 1
            if self._passes <= self.after:
                return False
            if self.n is not None and self.triggers >= self.n:
                return False
            if self.p < 1.0 and self._rng.random() >= self.p:
                return False
            self.triggers += 1
        # Trigger totals outlive the spec: scenarios disarm (the
        # `armed` context exits) BEFORE asserting counters.
        key = f"{self.point}.{self.mode}_triggers"
        with _lock:
            _trigger_totals[key] = _trigger_totals.get(key, 0) + 1
        return True


_lock = threading.Lock()
_points: Dict[str, List[FaultSpec]] = {}
_passes: Dict[str, int] = {}
_trigger_totals: Dict[str, int] = {}


def arm(point: str, mode: str, **kw) -> FaultSpec:
    """Arm one fault spec on ``point``; returns it (for its counter)."""
    spec = FaultSpec(point, mode, **kw)
    with _lock:
        _points.setdefault(point, []).append(spec)
    return spec


def disarm(point: str | None = None) -> None:
    """Disarm one point, or every point when ``point`` is None."""
    with _lock:
        if point is None:
            _points.clear()
        else:
            _points.pop(point, None)


class armed:
    """``with fault.armed("p", "drop", p=0.5):`` — arm for a scope and
    ALWAYS disarm that point on exit (test hygiene)."""

    def __init__(self, point: str, mode: str, **kw):
        self._args = (point, mode, kw)
        self.spec: FaultSpec | None = None

    def __enter__(self) -> FaultSpec:
        point, mode, kw = self._args
        self.spec = arm(point, mode, **kw)
        return self.spec

    def __exit__(self, *exc) -> None:
        point = self._args[0]
        with _lock:
            specs = _points.get(point)
            if specs is not None:
                try:
                    specs.remove(self.spec)
                except ValueError:
                    pass
                if not specs:
                    del _points[point]


def fire(point: str, sleep: Callable[[float], None] = time.sleep) -> str | None:
    """Evaluate the armed specs at ``point``.

    Returns ``"drop"`` when a drop-mode spec triggers (the SITE decides
    what a drop means at its boundary), ``None`` otherwise.  Delay-mode
    sleeps inline; error-mode raises :class:`FaultInjected`.  Corrupt
    specs are ignored here — byte-carrying sites use :func:`mangle`.
    """
    specs = _points.get(point)
    if not specs:
        return None
    with _lock:
        _passes[point] = _passes.get(point, 0) + 1
        snapshot = list(specs)
    action = None
    for spec in snapshot:
        if spec.mode == "corrupt" or not spec.should_trigger():
            continue
        if spec.mode == "delay":
            sleep(spec.delay_s)
        elif spec.mode == "error":
            raise FaultInjected(f"injected fault at {point}")
        elif spec.mode == "drop":
            action = "drop"
    return action


def mangle(point: str, data: bytes,
           sleep: Callable[[float], None] = time.sleep) -> tuple:
    """:func:`fire` for byte-carrying boundaries: evaluates corrupt
    specs too.  Returns ``(action, data)`` where a triggered corrupt
    spec has one byte flipped at a deterministic (seeded) offset."""
    specs = _points.get(point)
    if not specs:
        return None, data
    action = fire(point, sleep=sleep)
    with _lock:
        snapshot = list(specs)
    for spec in snapshot:
        if spec.mode != "corrupt" or not spec.should_trigger():
            continue
        if data:
            i = spec._rng.randrange(len(data))
            data = data[:i] + bytes([data[i] ^ 0xFF]) + data[i + 1:]
    return action, data


def counters() -> Dict[str, int]:
    """Flat ``{"<point>.passes": n, "<point>.<mode>_triggers": n}``.
    Trigger totals survive disarm — scenarios assert them after their
    ``armed`` context has exited."""
    with _lock:
        out: Dict[str, int] = dict(_trigger_totals)
        for point, n in _passes.items():
            out[f"{point}.passes"] = n
    return out


def reset_counters() -> None:
    with _lock:
        _passes.clear()
        _trigger_totals.clear()
        for specs in _points.values():
            for spec in specs:
                spec.triggers = 0
                spec._passes = 0
