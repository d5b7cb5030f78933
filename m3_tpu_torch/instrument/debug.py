"""Debug bundles and condition-triggered profile capture.

Reference parity: `src/x/debug/debug.go` builds a zip of pprof profiles
(cpu/heap/goroutine/host info) served over HTTP, and
`src/x/debug/triggering_profile.go` auto-captures profiles when a
watched condition fires (e.g. a slow tick), rate-limited so a flapping
condition cannot fill the disk.  The Python-runtime equivalents:

* goroutine dump  -> per-thread stack traces (`sys._current_frames`);
* pprof cpu       -> a cross-thread SAMPLING capture over a short
  window (periodic `sys._current_frames` aggregation, py-spy style);
* pprof heap      -> `tracemalloc` snapshot top-stats when tracing is
  active, else a `gc` object-type census (always available);
* host info       -> process/runtime facts (pid, uptime, versions,
  thread count) plus the instrument registry snapshot when given.

Everything returns bytes/dicts — the HTTP layer (server/http_api.py
/debug/dump) only zips and ships.

The port's copy of ``m3_tpu/instrument/debug.py`` (it imports nothing of
``m3_tpu``): the same bundle members (``threads.txt``, ``cpu.txt``,
``heap.txt``, ``host.json``), and the same ``TriggeringProfiler``,
which the storage mediator feeds each tick's duration.
"""

from __future__ import annotations

import gc
import io
import json
import os
import sys
import threading
import time
import traceback
import zipfile
from collections import Counter
from pathlib import Path

_START_TIME = time.time()


def thread_dump() -> str:
    """Every live thread's stack (the goroutine-profile role)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in sys._current_frames().items():
        out.append(f"--- thread {names.get(ident, '?')} ({ident}) ---")
        out.extend(line.rstrip()
                   for line in traceback.format_stack(frame))
    return "\n".join(out) + "\n"


def cpu_profile(seconds: float = 1.0, hz: float = 100.0,
                top: int = 60) -> str:
    """Sampling profile of EVERY thread for ``seconds`` (the pprof-cpu
    role): periodically snapshot ``sys._current_frames`` — the same
    machinery as thread_dump — and aggregate (function, file:line)
    sample counts across threads, py-spy style.  cProfile would only
    instrument the CAPTURING thread (which merely sleeps between
    samples), so a tracing profiler here records pure noise; sampling
    sees the real cross-thread hotspots at ~zero overhead on them."""
    me = threading.get_ident()
    counts: Counter = Counter()
    samples = 0
    interval = 1.0 / max(1.0, hz)
    deadline = time.monotonic() + max(0.05, seconds)
    while time.monotonic() < deadline:
        for ident, frame in sys._current_frames().items():
            if ident == me:
                continue  # the sampler's own sleep loop is not signal
            samples += 1
            f = frame
            while f is not None:  # whole stack: cumulative-style counts
                code = f.f_code
                counts[(code.co_name,
                        f"{code.co_filename}:{f.f_lineno}")] += 1
                f = f.f_back
        time.sleep(interval)
    lines = [f"sampling profile: {samples} thread-samples @ ~{hz:.0f}Hz "
             f"over {seconds}s (counts are cumulative per stack frame)"]
    for (name, loc), n in counts.most_common(top):
        lines.append(f"{n:>8}  {name}  {loc}")
    return "\n".join(lines) + "\n"


def heap_profile(top: int = 50) -> str:
    """Heap view (the pprof-heap role): tracemalloc top allocations when
    tracing is on (start with PYTHONTRACEMALLOC=1 or
    tracemalloc.start()), else a gc object-type census."""
    try:
        import tracemalloc

        if tracemalloc.is_tracing():
            snap = tracemalloc.take_snapshot()
            lines = [str(s) for s in snap.statistics("lineno")[:top]]
            return "tracemalloc top allocations:\n" + "\n".join(lines) + "\n"
    except Exception:  # noqa: BLE001 — census fallback below
        pass
    census = Counter(type(o).__name__ for o in gc.get_objects())
    lines = [f"{n:>10}  {t}" for t, n in census.most_common(top)]
    return ("gc object census (tracemalloc not tracing):\n"
            + "\n".join(lines) + "\n")


def host_info(registry=None) -> dict:
    info = {
        "pid": os.getpid(),
        "uptime_s": round(time.time() - _START_TIME, 1),
        "python": sys.version,
        "threads": threading.active_count(),
        "argv": sys.argv,
    }
    try:
        info["rss_kb"] = int(
            next(l for l in open("/proc/self/status")
                 if l.startswith("VmRSS")).split()[1])
    except Exception:  # noqa: BLE001 — non-procfs platforms
        pass
    if registry is not None:
        info["metrics"] = registry.snapshot()
    return info


def debug_bundle(registry=None, cpu_seconds: float = 0.5) -> bytes:
    """The x/debug zip: one archive with every capture, built in memory
    (reference debug.go WriteZip)."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("threads.txt", thread_dump())
        z.writestr("cpu.txt", cpu_profile(cpu_seconds))
        z.writestr("heap.txt", heap_profile())
        z.writestr("host.json", json.dumps(host_info(registry), indent=2,
                                           default=str))
    return buf.getvalue()


class TriggeringProfiler:
    """Auto-capture a debug bundle when a condition fires (reference
    triggering_profile.go: e.g. profile automatically when a flush tick
    exceeds its deadline), rate-limited by ``min_interval_s`` and capped
    at ``max_captures`` files so a flapping condition cannot fill the
    disk.

    Hook it from the code that observes the condition::

        prof = TriggeringProfiler(dir, lambda d: d > 5.0)
        ...
        prof.observe(tick_duration_s)   # captures when the predicate fires
    """

    def __init__(self, out_dir: str, predicate, min_interval_s: float = 60.0,
                 max_captures: int = 10, registry=None,
                 cpu_seconds: float = 0.5, now=time.monotonic):
        self.out_dir = Path(out_dir)
        self.predicate = predicate
        self.min_interval_s = min_interval_s
        self.max_captures = max_captures
        self.registry = registry
        self.cpu_seconds = cpu_seconds
        self._now = now
        self._last = -1e18
        self._lock = threading.Lock()
        self.captures = 0

    def observe(self, value) -> Path | None:
        """Feed one observation; returns the bundle path when a capture
        happened.  Never raises (a broken profiler must not take down
        the observed path)."""
        try:
            if not self.predicate(value):
                return None
            with self._lock:
                t = self._now()
                if (self.captures >= self.max_captures
                        or t - self._last < self.min_interval_s):
                    return None
                self._last = t
                self.captures += 1
                n = self.captures
            self.out_dir.mkdir(parents=True, exist_ok=True)
            path = self.out_dir / f"triggered-{n:03d}.zip"
            path.write_bytes(
                debug_bundle(self.registry, cpu_seconds=self.cpu_seconds))
            return path
        except Exception:  # noqa: BLE001 — observation path stays safe
            return None
