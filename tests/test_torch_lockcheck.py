"""The port's lock-order sanitizer (``m3_tpu_torch.x.lockcheck``) against
the JAX package's (``m3_tpu.x.lockcheck``) on the CPU.

Each scenario of ``tests/test_lockcheck.py`` runs once under each
package's sanitizer, from the same line, so the locks' creation sites
and the recorded stacks are the same: the findings, the exception types
and the messages are equal, but for the path of each package's own
module in the stacks.  The port arms by code only: no environment
variable arms it, in this process or in a child.
"""

import os
import queue
import subprocess
import sys
import threading
from pathlib import Path

import pytest

import m3_tpu.x.lockcheck as jlc
import m3_tpu_torch.x.lockcheck as tlc

ROOT = Path(__file__).resolve().parent.parent


def run_armed(lc, scenario, raise_on_cycle: bool):
    """``scenario(lc)`` with ``lc`` installed: (what it returned or the
    exception it raised, as type name and message; the findings as
    strings)."""
    lc.reset()
    lc.install(raise_on_cycle=raise_on_cycle)
    try:
        try:
            got = ("ok", scenario(lc))
        except Exception as e:  # noqa: BLE001 — the outcome is compared
            got = (type(e).__name__, str(e))
        found = [(type(f).__name__, str(f), f.cycle, f.thread) for f in lc.findings()]
    finally:
        lc.uninstall()
        lc.reset()
    return got, found


def _as_reference(x):
    """The port's outcome with its module's path written as the
    reference's (the stacks name the wrapper's ``__enter__``)."""
    if isinstance(x, str):
        return x.replace("m3_tpu_torch/x/lockcheck.py", "m3_tpu/x/lockcheck.py")
    if isinstance(x, (list, tuple)):
        return type(x)(_as_reference(v) for v in x)
    return x


def both(scenario, raise_on_cycle: bool = True):
    """The scenario under each package's sanitizer, from this one line;
    the outcomes and findings are equal but for the module's path in the
    stacks.  Returns the port's."""
    outs = [run_armed(lc, scenario, raise_on_cycle) for lc in (jlc, tlc)]
    assert _as_reference(outs[1]) == outs[0]
    return outs[1]


def ab_ba(lc):
    a, b = threading.Lock(), threading.Lock()
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    return "done"


def transitive(lc):
    a, b, c = (threading.Lock() for _ in range(3))
    with a:
        with b:
            pass
    with b:
        with c:
            pass
    with c:
        with a:
            pass
    return "done"


def across_threads(lc):
    a, b = threading.Lock(), threading.Lock()
    first = threading.Event()

    def t1():
        with a:
            with b:
                pass
        first.set()

    def t2():
        first.wait(5)
        with b:
            with a:
                pass

    th = [threading.Thread(target=t1, name="lc-t1"), threading.Thread(target=t2, name="lc-t2")]
    for t in th:
        t.start()
    for t in th:
        t.join(5)
    return [t.is_alive() for t in th]


def self_deadlock(lc):
    a = threading.Lock()
    with a:
        a.acquire()
    return "done"


def rlock_mixed_inversion(lc):
    r, a = threading.RLock(), threading.Lock()
    with r:
        with r:
            with a:
                pass
    with a:
        with r:
            pass
    return "done"


def clean(lc):
    a, b = threading.Lock(), threading.Lock()
    for _ in range(3):
        with a:
            with b:
                pass
    r = threading.RLock()
    with r:
        with r:
            r.acquire()
            r.release()
    with a:
        with b:
            pass
    with b:
        assert a.acquire(blocking=False)  # trylock: no edge, no raise
        a.release()
        assert a.acquire(timeout=0.5)  # bounded: the same
        a.release()
    with a:
        with b:
            pass
    ev = threading.Event()
    t = threading.Thread(target=ev.set)
    t.start()
    assert ev.wait(5)
    t.join(5)
    q = queue.Queue()
    q.put(42)
    assert q.get(timeout=5) == 42
    cond = threading.Condition()
    with cond:
        cond.notify_all()
    return "done"


@pytest.mark.parametrize("scenario", [ab_ba, transitive, self_deadlock,
                                      rlock_mixed_inversion])
def test_inversions_raise_alike(scenario):
    got, found = both(scenario)
    assert got[0] == "LockOrderError" and len(found) == 1
    assert found[0][0] == "LockInversion"


def test_ab_ba_message_carries_both_stacks():
    (_, msg), found = both(ab_ba)
    assert "stack that established" in msg and "stack performing the reversal" in msg
    assert msg.count("ab_ba") >= 2 and "Lock@" in found[0][2][0]


@pytest.mark.parametrize("scenario", [ab_ba, transitive, across_threads,
                                      rlock_mixed_inversion])
def test_record_mode_collects_alike(scenario):
    got, found = both(scenario, raise_on_cycle=False)
    assert got[0] == "ok" and len(found) == 1
    assert len(found[0][2]) >= 2


def test_self_deadlock_raises_even_in_record_mode_alike():
    got, found = both(self_deadlock, raise_on_cycle=False)
    assert got[0] == "LockOrderError" and len(found) == 1


def test_repeat_inversion_message_alike():
    def repeat(lc):
        a, b = threading.Lock(), threading.Lock()
        with a:
            with b:
                pass
        for _ in range(2):
            try:
                with b:
                    with a:
                        pass
            except lc.LockOrderError as e:
                last = str(e)
        return last

    got, found = both(repeat)
    assert got[1].startswith("lock-order inversion (repeat): ") and len(found) == 1


def test_clean_patterns_stay_silent_alike():
    assert both(clean) == (("ok", "done"), [])


def test_uninstall_restores_factories_and_locks_keep_working():
    for lc in (jlc, tlc):
        lc.reset()
        lc.install()
        assert lc.installed() and threading.Lock is not lc._ORIG_LOCK
        lk = threading.Lock()
        lc.uninstall()
        assert not lc.installed()
        assert threading.Lock is lc._ORIG_LOCK and threading.RLock is lc._ORIG_RLOCK
        with lk:
            pass
    assert tlc._ORIG_LOCK is jlc._ORIG_LOCK


def test_no_environment_arms_the_port():
    """``M3_LOCKCHECK`` arms the reference at import; the port reads no
    environment to arm anything (a stated difference)."""
    code = ("import sys\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "import m3_tpu_torch.x\n"
            "from m3_tpu_torch.x import lockcheck\n"
            "print('ARMED' if lockcheck.installed() else 'UNARMED')\n")
    env = dict(os.environ, M3_LOCKCHECK="1")
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "UNARMED"
    assert "os.environ" not in (ROOT / "m3_tpu_torch" / "x" / "lockcheck.py").read_text()
