"""Process-global fault-injection registry: named faultpoints at the
disk, read and wire boundaries (``commitlog.flush``, ``fs.*``,
``query.fetch``, and the aggregator tier's ``ingest_tcp.frame`` between
a frame's receipt and its decode and ``ingest_tcp.send`` before a
client's frame goes out) armed with one of four modes:

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

The port's copy of ``m3_tpu/x/fault.py`` without its environment arming
(``M3_FAULTPOINTS``): arm in code or through the node's
``/api/v1/debug/faults`` body, whose spec grammar (:func:`parse_faults`)
and builders (:func:`registry_response`, :func:`apply_request`) are
copies.  The registry is this package's own, apart from the
reference package's.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, List

__all__ = [
    "FaultInjected", "FaultSpec", "arm", "armed", "arm_many",
    "apply_request", "disarm", "fire", "mangle", "counters",
    "parse_faults", "registry_response", "reset_counters", "points",
    "snapshot",
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

    def to_dict(self) -> dict:
        """Wire shape of one armed spec (GET /api/v1/debug/faults)."""
        with self._lock:
            return {
                "point": self.point, "mode": self.mode, "p": self.p,
                "n": self.n, "after": self.after,
                "ms": self.delay_s * 1000.0, "seed": self.seed,
                "passes": self._passes, "triggers": self.triggers,
            }


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


def parse_faults(raw: str) -> List[tuple]:
    """Parse the fault-spec grammar into ``[(point, mode, kwargs)]``
    WITHOUT arming anything (validation happens before mutation — a
    half-armed malformed request would leave the node in a state the
    caller never asked for).

    Grammar: ``point=mode[:key=value]*`` joined by ``;``.  Keys:
    ``p`` (probability), ``n`` (max triggers), ``ms`` (delay),
    ``after`` (skip first k passes), ``seed``.  One grammar everywhere:
    the reference's ``M3_FAULTPOINTS`` env var and the
    ``/api/v1/debug/faults`` body mid-run parse through this exact
    function.  A malformed entry raises ValueError — a typo
    silently arming nothing would invalidate the scenario the flag
    exists for.
    """
    out: List[tuple] = []
    for entry in raw.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        head, *opts = entry.split(":")
        point, sep, mode = head.partition("=")
        if not sep or not point or not mode:
            raise ValueError(f"faultpoints entry {entry!r}: "
                             "expected point=mode[:key=value]*")
        if mode not in MODES:
            raise ValueError(f"faultpoints entry {entry!r}: mode {mode!r} "
                             f"must be one of {MODES}")
        kw: dict = {}
        for opt in opts:
            k, sep, v = opt.partition("=")
            if not sep:
                raise ValueError(f"faultpoints option {opt!r} in {entry!r}")
            if k == "p":
                kw["p"] = float(v)
            elif k == "n":
                kw["n"] = int(v)
            elif k == "ms":
                kw["delay_ms"] = float(v)
            elif k == "after":
                kw["after"] = int(v)
            elif k == "seed":
                kw["seed"] = int(v)
            else:
                raise ValueError(f"faultpoints key {k!r} in {entry!r}")
        out.append((point, mode, kw))
    return out


def arm_many(raw: str) -> int:
    """Parse-then-arm one spec string; returns the number of specs
    armed.  All-or-nothing: a grammar error arms NOTHING."""
    specs = parse_faults(raw)
    for point, mode, kw in specs:
        arm(point, mode, **kw)
    return len(specs)


def snapshot() -> List[dict]:
    """Every armed spec as a dict (point/mode/knobs + live pass/trigger
    counts), sorted by point then mode — the readable half of the
    runtime re-arm surface."""
    with _lock:
        specs = [s for lst in _points.values() for s in lst]
    return sorted((s.to_dict() for s in specs),
                  key=lambda d: (d["point"], d["mode"]))


# -- HTTP builders (admin + main API /api/v1/debug/faults) -------------------
#
# Served by server/http_api.py like tracing.traces_response.


def registry_response() -> dict:
    """GET body: armed specs + the process counters (passes survive
    disarm, trigger totals survive re-arm)."""
    return {"armed": snapshot(), "counters": counters()}


def apply_request(body: dict) -> dict:
    """POST body → mutate the registry, return the post-state.

    ``{"disarm": true | ["point", ...], "reset_counters": bool,
    "arm": "point=mode[:key=value]*;..."}`` — disarm applies FIRST so
    one request is a complete re-arm (the chaos scheduler's
    window-transition shape), and counters are PRESERVED unless
    ``reset_counters`` asks otherwise.  Unknown keys raise (a typo'd
    request must not silently no-op)."""
    unknown = set(body) - {"arm", "disarm", "reset_counters"}
    if unknown:
        raise ValueError(f"debug/faults: unknown keys {sorted(unknown)}")
    # validate BEFORE mutating: a bad arm spec must not leave the node
    # disarmed when the caller asked for an atomic re-arm
    specs = parse_faults(body.get("arm") or "")
    dis = body.get("disarm")
    # a bare string would iterate per CHARACTER and disarm nothing
    # (disarm() pops unknown points silently) — the silent no-op this
    # endpoint exists to prevent
    if not (dis is None or isinstance(dis, (bool, list, tuple))):
        raise ValueError(
            "debug/faults: 'disarm' must be true or a list of points")
    if dis is True:
        disarm()
    elif dis:
        for point in dis:
            disarm(str(point))
    if body.get("reset_counters"):
        reset_counters()
    for point, mode, kw in specs:
        arm(point, mode, **kw)
    out = registry_response()
    out["armed_count"] = len(specs)
    return out


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


def points() -> List[str]:
    with _lock:
        return sorted(_points)
