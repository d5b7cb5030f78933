"""Device-hop profiler: per-stage host↔device transfer, build and
dispatch accounting — the port's counterpart of ``m3_tpu/x/hopwatch.py``
and ``x/tracewatch``'s counting sibling.

While installed it counts every host↔device transfer (count and bytes),
every kernel-library build and every device dispatch, and attributes
each to the innermost named **hop** (``with hopwatch.hop("encode"):
...``); work outside any hop lands on ``"(unattributed)"``.
``tools/hops.py`` drives the pinned corpus through the node's hot path
(wire parse → arena ingest → window drain → encode → fileset write)
under it and reports the per-hop ledger.

What each counter means in the port (the seams are ``x/devseams``'s):

* **h2d / d2h** — every copy between the host and a device off the CPU,
  with the bytes it moves: ``.cpu()``, ``.to(...)``, ``.tolist()``, a
  cross-device ``copy_``, ``torch.tensor``/``torch.as_tensor`` of host
  data onto a device, an ndarray upload; every scalar read from such a
  device (``.item()``, ``int()``, ``bool()``); and the count an op whose
  output shape depends on the data copies to the host inside itself
  (``nonzero``, a boolean-mask index, ``masked_select``, ``unique``,
  ``repeat_interleave`` without ``output_size``).
* **compiles** — every build of a kernel library in the process: one
  ``nvcc`` run in ``parallel/_cuda.build`` or one ``g++`` run in
  ``native/_build.load_native``.  A library found built is not a build.
* **dispatches** — every device op (an aten op with an operand or a
  ``device=`` off the CPU, views and metadata queries not counted) plus
  every hand-kernel grid launched.

Arming is by code only: ``install()`` / ``uninstall()``.  The reference
also arms at import from ``M3_HOPWATCH``; the port reads no environment
to arm anything.

Differences from the reference, by design:

* A dispatch mode is per thread, so aten ops and transfers are counted
  in the thread that installed and in any thread inside a ``hop()``;
  work another thread does outside a hop is not counted.  Builds are
  counted in every thread.  (The reference patches modules and counts
  process-wide.)
* On the CPU nothing crosses a device boundary: a run on
  ``device="cpu"`` counts no transfers and no dispatches.
* Counting costs host time (each aten op passes through Python), so
  walls that are reported as walls are taken from passes not under
  ``install()``; a hop's own ``wall_s`` is taken under it.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass
from typing import Dict

from m3_tpu_torch.x import devseams

__all__ = [
    "HopStats", "install", "uninstall", "installed", "reset", "hop",
    "stats", "totals", "snapshot", "since", "current_hop", "seams",
]

_UNATTRIBUTED = "(unattributed)"

_mu = threading.Lock()
_installed = False
_install_thread = None
_tls = threading.local()


@dataclass
class HopStats:
    """One named hop's ledger (all counters process-lifetime while
    armed; wall_s accumulates over every ``hop()`` entry)."""

    wall_s: float = 0.0
    entries: int = 0
    h2d_count: int = 0
    h2d_bytes: int = 0
    d2h_count: int = 0
    d2h_bytes: int = 0
    compiles: int = 0
    dispatches: int = 0

    def to_dict(self) -> dict:
        return {
            "wall_s": round(self.wall_s, 6), "entries": self.entries,
            "h2d_count": self.h2d_count, "h2d_bytes": self.h2d_bytes,
            "d2h_count": self.d2h_count, "d2h_bytes": self.d2h_bytes,
            "compiles": self.compiles, "dispatches": self.dispatches,
        }


_hops: Dict[str, HopStats] = {}
_totals = HopStats()
# hop -> seam -> [count, bytes]: the ledger by seam (aten op, factory,
# ``kernel:<name>``, ``build:<source>``)
_seams: Dict[str, Dict[str, list]] = {}


def current_hop() -> str:
    stack = getattr(_tls, "hops", None)
    return stack[-1] if stack else _UNATTRIBUTED


def _stat(name: str) -> HopStats:
    # caller holds _mu
    st = _hops.get(name)
    if st is None:
        st = _hops[name] = HopStats()
    return st


def _count(kind: str, seam: str, n: int = 1, nbytes: int = 0) -> None:
    if not _installed:
        return
    name = current_hop()
    with _mu:
        for st in (_stat(name), _totals):
            if kind == "h2d":
                st.h2d_count += n
                st.h2d_bytes += nbytes
            elif kind == "d2h":
                st.d2h_count += n
                st.d2h_bytes += nbytes
            elif kind == "compile":
                st.compiles += n
            elif kind == "dispatch":
                st.dispatches += n
        row = _seams.setdefault(name, {}).setdefault(f"{kind}:{seam}", [0, 0])
        row[0] += n
        row[1] += nbytes


def _on_build(source: str, signature: str) -> None:
    _count("compile", source)


@contextlib.contextmanager
def hop(name: str):
    """Attribute everything in this thread to ``name`` for the scope
    (nestable: the innermost hop wins, like a span stack).  While
    installed, the thread is watched for the scope."""
    stack = getattr(_tls, "hops", None)
    if stack is None:
        stack = _tls.hops = []
    watched = _installed
    if watched:
        devseams.enter()
    stack.append(name)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        stack.pop()
        if watched:
            devseams.leave()
        with _mu:
            st = _stat(name)
            st.wall_s += dt
            st.entries += 1


# -- lifecycle ---------------------------------------------------------------


def install() -> None:
    """Arm the profiler (idempotent).  Counting starts at once in this
    thread; open ``hop()`` scopes to attribute, in this thread or any
    other.  Call ``uninstall`` from the same thread."""
    global _installed, _install_thread
    if _installed:
        return
    devseams.COUNTERS.append(_count)
    devseams.BUILD_HOOKS.append(_on_build)
    devseams.enter()
    _install_thread = threading.get_ident()
    _installed = True


def uninstall() -> None:
    """Disarm (ledgers survive for inspection; ``reset()`` clears
    them)."""
    global _installed
    if not _installed:
        return
    _installed = False
    devseams.COUNTERS.remove(_count)
    devseams.BUILD_HOOKS.remove(_on_build)
    if threading.get_ident() == _install_thread:
        devseams.leave()


def installed() -> bool:
    return _installed


def reset() -> None:
    global _totals
    with _mu:
        _hops.clear()
        _seams.clear()
        _totals = HopStats()


def stats() -> Dict[str, dict]:
    """Per-hop ledgers, as plain dicts (artifact-ready)."""
    with _mu:
        return {name: st.to_dict() for name, st in sorted(_hops.items())}


def seams() -> Dict[str, Dict[str, list]]:
    """The ledger by seam: hop -> ``"<kind>:<seam>"`` -> [count, bytes],
    kind one of h2d, d2h, dispatch, compile (a port addition: it names
    which op, factory or kernel each count came from)."""
    with _mu:
        return {h: {k: list(v) for k, v in sorted(rows.items())}
                for h, rows in sorted(_seams.items())}


def totals() -> dict:
    with _mu:
        return _totals.to_dict()


def snapshot() -> dict:
    """Opaque marker for :func:`since`."""
    return totals()


def since(snap: dict) -> dict:
    """Process-wide transfer/dispatch delta since ``snap`` (wall_s and
    entries excluded — they are hop-scoped)."""
    now = totals()
    return {k: now[k] - snap[k]
            for k in ("h2d_count", "h2d_bytes", "d2h_count", "d2h_bytes",
                      "compiles", "dispatches")}
