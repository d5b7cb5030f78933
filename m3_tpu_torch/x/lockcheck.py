"""Runtime lock-order sanitizer: the dynamic half of the race tier.

CPython has no ``-race``; ``tests/test_race.py`` asserts conservation
invariants but a latent lock-order inversion only trips when the
scheduler happens to interleave the two acquire chains — the classic
deadlock that survives a thousand green runs.  This module makes
ordering violations deterministic: while armed, every lock created via
``threading.Lock()``/``threading.RLock()`` is wrapped, each thread's
held-lock stack is tracked, and the cross-thread acquisition graph
(``A held while acquiring B`` ⇒ edge A→B) is checked on every NEW edge.
An edge that closes a cycle is an inversion: some execution acquired
A→B, this one acquires B→A, and the interleaving of the two deadlocks.
The report carries BOTH stacks — the recorded stack of the first
ordering and the live stack of the reversal — and fails fast
(:class:`LockOrderError`) in the acquiring thread *before* blocking.

Arming is by code only: ``lockcheck.install()`` / ``lockcheck.uninstall()``
(the threaded test files' autouse fixtures, ``chip_smoke.py`` phase 24).
The reference also arms at import from ``M3_LOCKCHECK``; the port reads
no environment to arm anything (``x/fault.py`` says the same of its
faultpoints), so a process arms the sanitizer itself.

The port's counterpart of ``m3_tpu/x/lockcheck.py``, which does not
touch JAX: the same graph, checks, findings and messages.

Scope and honesty notes:

* Only locks CREATED while armed are tracked (the factory is swapped,
  existing lock objects are untouched).  The fixture installs before
  the test body, so every lock the test constructs is covered; library
  singletons created at import time are not.
* Edges are keyed per lock *instance* — two different instance pairs
  acquired in opposite orders are different edges, so there are no
  false cycles from unrelated objects sharing a class.
* A lock acquired in one thread and released in another (legal, rare)
  leaves a stale held-stack entry; the release side ignores it.  If
  such a handoff ever produced a spurious edge, suppress by acquiring
  via the raw ``_thread`` primitives.
* Only unbounded blocking acquires participate in ordering checks:
  trylocks and timeout-bounded acquires cannot deadlock (they are
  often deliberate inversion-avoidance back-off) and record no edges.
* Wrapped locks keep working after ``uninstall()`` — bookkeeping
  beyond the held-stack push/pop is gated on the armed flag.
"""

from __future__ import annotations

import itertools
import threading
import traceback
import weakref
import _thread
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Set, Tuple

__all__ = [
    "LockOrderError", "LockInversion", "install", "uninstall", "reset",
    "installed", "findings", "sanitized_lock", "sanitized_rlock",
]

_ORIG_LOCK = threading.Lock
_ORIG_RLOCK = threading.RLock

_armed = False
_raise_on_cycle = True
_seq = itertools.count(1)

# registry state, guarded by a RAW lock (never a wrapped one)
_mu = _thread.allocate_lock()
_adj: Dict[int, Set[int]] = {}                  # a -> {b}: a held while acquiring b
_edge_stacks: Dict[Tuple[int, int], str] = {}   # (a, b) -> acquisition stack
_names: Dict[int, str] = {}                     # seq -> "kind @ file:line"
_findings: List["LockInversion"] = []
_reported: Set[tuple] = set()                   # dedup: cycle seq paths
# seqs of GC'd wrapper locks, drained under _mu.  The weakref finalizer
# appends WITHOUT taking _mu (deque.append is atomic): a finalizer can
# fire from an allocation made while _mu is already held by this very
# thread, and a raw lock is not reentrant.
_dead: deque = deque()

_tls = threading.local()


def _prune_dead_locked() -> None:
    """Drop registry entries for GC'd locks.  Caller holds _mu."""
    while _dead:
        seq = _dead.popleft()
        _names.pop(seq, None)
        _adj.pop(seq, None)
        for peers in _adj.values():
            peers.discard(seq)
        for key in [k for k in _edge_stacks if seq in k]:
            del _edge_stacks[key]


class LockOrderError(RuntimeError):
    """Raised in the acquiring thread when a new edge closes a cycle —
    BEFORE the real acquire, so the sanitizer reports instead of
    deadlocking."""


@dataclass
class LockInversion:
    """One detected inversion: this thread acquired ``cycle[0]`` while
    holding ``cycle[-1]``, and recorded edges already chain
    ``cycle[0]`` → ... → ``cycle[-1]``."""

    cycle: Tuple[str, ...]          # lock names along the existing path
    forward_stack: str              # stack that recorded the first edge
    reversal_stack: str             # live stack performing the reversal
    thread: str

    def __str__(self) -> str:
        chain = " -> ".join(self.cycle)
        return (
            f"lock-order inversion in {self.thread}: acquiring "
            f"{self.cycle[0]} while holding {self.cycle[-1]}, but the "
            f"order {chain} was already established\n"
            f"--- stack that established {self.cycle[0]} -> "
            f"{self.cycle[1]} ---\n{self.forward_stack}"
            f"--- stack performing the reversal ---\n{self.reversal_stack}"
        )


def _held() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _creation_site() -> str:
    # nearest frame outside this module and threading.py
    for frame in reversed(traceback.extract_stack(limit=12)[:-2]):
        fn = frame.filename
        if not (fn.endswith("lockcheck.py") or fn.endswith("threading.py")):
            return f"{fn}:{frame.lineno}"
    return "<unknown>"


def _find_path(src: int, dst: int) -> list | None:
    """DFS path src → dst over recorded edges (iterative; graphs are
    tiny — a handful of locks per scenario)."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        for nxt in _adj.get(node, ()):
            if nxt == dst:
                return path + [nxt]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _before_acquire(seq: int) -> None:
    """Record edges held→seq and fail fast on a cycle.  Runs BEFORE the
    real acquire so the inversion is reported, not deadlocked on."""
    held = _held()
    if not held or seq in held:
        return  # nothing held, or re-entrant RLock acquire
    cur_stack = None
    for holder in dict.fromkeys(held):  # preserve order, dedup
        if holder == seq:
            continue
        with _mu:
            _prune_dead_locked()
            if seq in _adj.get(holder, ()):
                continue  # known-good edge
            path = _find_path(seq, holder)
            if path is not None:
                key = tuple(path)
                if key in _reported:
                    if _raise_on_cycle:
                        raise LockOrderError(
                            f"lock-order inversion (repeat): "
                            f"{' -> '.join(_names.get(s, '?') for s in path)}")
                    continue  # record mode: one finding per cycle
                _reported.add(key)
                if cur_stack is None:
                    cur_stack = "".join(traceback.format_stack(limit=24)[:-2])
                inv = LockInversion(
                    cycle=tuple(_names.get(s, f"lock#{s}") for s in path),
                    forward_stack=_edge_stacks.get(
                        (path[0], path[1]), "<stack unavailable>"),
                    reversal_stack=cur_stack,
                    thread=threading.current_thread().name,
                )
                _findings.append(inv)
                if _raise_on_cycle:
                    raise LockOrderError(str(inv))
                continue
            if cur_stack is None:
                cur_stack = "".join(traceback.format_stack(limit=24)[:-2])
            _adj.setdefault(holder, set()).add(seq)
            _edge_stacks[(holder, seq)] = cur_stack


class _SanitizedLock:
    """Wrapper over a raw lock; ``_kind`` distinguishes Lock/RLock for
    the self-deadlock check.  Unknown attributes (``_is_owned``,
    ``_acquire_restore``...) forward to the inner lock so
    ``threading.Condition`` keeps its RLock fast paths."""

    _kind = "Lock"

    def __init__(self, inner):
        self._inner = inner
        self._seq = next(_seq)
        with _mu:
            _names[self._seq] = f"{self._kind}@{_creation_site()}"
        # registry entries die with the lock (long-lived armed processes
        # create locks per connection/thread forever); the finalizer only
        # touches the lock-free dead queue
        weakref.finalize(self, _dead.append, self._seq)

    def acquire(self, blocking=True, timeout=-1):
        # Only unbounded blocking acquires participate in ordering:
        # a trylock (blocking=False) or timeout-bounded acquire cannot
        # deadlock — it is often the back-off half of a deliberate
        # inversion-avoidance pattern, and recording its edges would
        # both false-positive here and poison the graph for later
        # legitimate blocking acquires.
        if _armed and blocking and timeout < 0:
            if self._kind == "Lock" and self._seq in _held():
                inv = LockInversion(
                    cycle=(_names.get(self._seq, "?"),) * 2,
                    forward_stack="<self-deadlock: same non-reentrant "
                                  "lock>\n",
                    reversal_stack="".join(
                        traceback.format_stack(limit=24)[:-1]),
                    thread=threading.current_thread().name,
                )
                with _mu:
                    _findings.append(inv)
                # ALWAYS raise, even in record mode: unlike an order
                # inversion (which only deadlocks under the adverse
                # interleaving), re-acquiring a held non-reentrant lock
                # hangs this thread with CERTAINTY — proceeding would
                # convert the report into the deadlock it reports.
                raise LockOrderError(str(inv))
            else:
                _before_acquire(self._seq)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _held().append(self._seq)
        return ok

    def release(self):
        self._inner.release()
        held = _held()
        # remove the most recent occurrence; tolerate cross-thread
        # releases (entry simply isn't in this thread's stack)
        for i in range(len(held) - 1, -1, -1):
            if held[i] == self._seq:
                del held[i]
                break

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def __repr__(self):
        return f"<sanitized {self._inner!r}>"

    def __getattr__(self, name):
        return getattr(self._inner, name)


class _SanitizedRLock(_SanitizedLock):
    _kind = "RLock"


def sanitized_lock():
    return _SanitizedLock(_ORIG_LOCK())


def sanitized_rlock():
    return _SanitizedRLock(_ORIG_RLOCK())


def install(raise_on_cycle: bool = True) -> None:
    """Swap the ``threading.Lock``/``RLock`` factories and start
    checking.  Idempotent."""
    global _armed, _raise_on_cycle
    _raise_on_cycle = raise_on_cycle
    threading.Lock = sanitized_lock
    threading.RLock = sanitized_rlock
    _armed = True


def uninstall() -> None:
    """Restore the factories and stop checking (already-wrapped locks
    keep working, unchecked)."""
    global _armed
    _armed = False
    threading.Lock = _ORIG_LOCK
    threading.RLock = _ORIG_RLOCK


def installed() -> bool:
    return _armed


def reset() -> None:
    """Clear the acquisition graph and findings (per-test hygiene: a
    fresh test's lock instances are fresh seqs, but module-singleton
    locks would otherwise accumulate edges across tests)."""
    with _mu:
        _adj.clear()
        _edge_stacks.clear()
        _findings.clear()
        _reported.clear()
        _prune_dead_locked()


def findings() -> List[LockInversion]:
    with _mu:
        return list(_findings)

