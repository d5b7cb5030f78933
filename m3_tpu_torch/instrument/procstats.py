"""Process-level self-observation gauges for every node's /metrics.
The port's copy of ``m3_tpu/instrument/procstats.py``.

The reference exposes its runtime through tally's process collectors
(RSS, CPU, goroutines, FDs).  This module is a scrape-time collector
(the ``Registry.register_collector`` pattern the fault/retry mirrors
use) that refreshes a fixed set of gauges right before every
exposition:

* ``process_resident_memory_bytes`` — VmRSS from ``/proc/self/status``
* ``process_cpu_seconds_total``     — utime+stime via ``os.times()``
* ``process_threads``               — live Python threads
* ``process_open_fds``              — ``/proc/self/fd`` entry count
* ``process_uptime_seconds``        — wall seconds since process start

Gauges are interned ONCE at install (metric-hygiene: no per-scrape
name build), values that cannot be read on this platform (non-procfs)
simply keep their last value — the scrape stays strict-parse green
either way, which is the tier-1 gate this rides under.
"""

from __future__ import annotations

import os
import threading
import time

# process start, the reference's ``instrument/debug.py`` module clock
# (kept here: the debug bundle is not ported)
_START_TIME = time.time()

__all__ = ["ProcessCollector", "install_process_collector"]


def _rss_bytes() -> int | None:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) * 1024
    except OSError:
        return None
    return None


def _open_fds() -> int | None:
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return None


class ProcessCollector:
    """Scrape-time refresher for the process gauges (one per process;
    instruments interned at construction, never in the scrape loop)."""

    def __init__(self, scope):
        self._g_rss = scope.gauge("process_resident_memory_bytes")
        self._g_cpu = scope.gauge("process_cpu_seconds_total")
        self._g_threads = scope.gauge("process_threads")
        self._g_fds = scope.gauge("process_open_fds")
        self._g_uptime = scope.gauge("process_uptime_seconds")

    def __call__(self) -> None:
        rss = _rss_bytes()
        if rss is not None:
            self._g_rss.update(rss)
        t = os.times()
        self._g_cpu.update(t.user + t.system)
        self._g_threads.update(threading.active_count())
        fds = _open_fds()
        if fds is not None:
            self._g_fds.update(fds)
        self._g_uptime.update(time.time() - _START_TIME)


def install_process_collector(registry, scope) -> ProcessCollector:
    """Register the collector on ``registry`` (under ``scope``'s prefix)
    and prime the gauges once so the very first scrape already carries
    real values.  Returns the collector for unregister-on-shutdown."""
    c = ProcessCollector(scope)
    c()
    registry.register_collector(c)
    return c
