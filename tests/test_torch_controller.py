"""m3_tpu_torch.x.controller against m3_tpu.x.controller on the CPU.

The same actuators (query slots over each package's
``AdmissionController``, the device budget, checkpoint, rebalance and
cleanup pulses), the same bindings, the same fake clock and the same
burn sequence — firing, clear, unknown (``None``/NaN), sustained-history
reads — give the same per-tick stats, the same actuator positions and
the same ``status()``, except for the one stated difference: the
reference's ``device_fallback`` actuator (``devguard.force_fallback``),
which the port does not have, so its device binding drives the
checkpoint and budget actuators only.  Exact comparisons (the recent
actions' wall-clock ``unix`` stamps aside).
"""

import pytest

from m3_tpu.x import admission as jadm
from m3_tpu.x import breaker as jbreaker
from m3_tpu.x import controller as jctl
from m3_tpu.x import devguard as jdg
from m3_tpu.x import membudget as jmb
from m3_tpu_torch.x import admission as tadm
from m3_tpu_torch.x import controller as tctl
from m3_tpu_torch.x import membudget as tmb

GIB = 1 << 30

# one tick's verdicts per rule: (burn, firing); None = no verdict
SEQ = [
    {"q": (0.0, False), "dev": (0.0, False), "node": (0.0, False)},
    {"q": (20.0, True), "dev": (2.0, False), "node": (3.0, True)},
    {"q": (20.0, True), "dev": (30.0, True), "node": (3.0, True)},
    {"q": (25.0, True), "dev": (30.0, True), "node": (3.0, True)},
    {"q": (None, None), "dev": (30.0, True), "node": (3.0, True)},
    {"q": (float("nan"), True), "dev": (0.5, False), "node": (0.2, False)},
    {"q": (18.0, True), "dev": (0.5, False), "node": (0.2, False)},
    {"q": (0.5, False), "dev": (0.5, False), "node": (0.2, False)},
] + [{"q": (0.5, False), "dev": (0.2, False), "node": None}] * 10 + [
    {"q": (20.0, True), "dev": (0.2, False), "node": (2.0, True)},
    {"q": (20.0, True), "dev": (0.2, False), "node": (2.0, True)},
] + [{"q": (0.1, False), "dev": (0.1, False), "node": (0.1, False)}] * 8

HISTORY = [None, 0.4, 1.5, 1.5, None, 2.0] * 10


class _Pulses:
    def __init__(self):
        self.saves = self.ticks = self.cleanups = 0

    def save(self):
        self.saves += 1

    def tick(self):
        self.ticks += 1

    def cleanup(self):
        self.cleanups += 1


class _History:
    def __init__(self):
        self.i = 0

    def min_burn(self, rule, window, now_nanos):
        v = HISTORY[self.i % len(HISTORY)]
        self.i += 1
        return v


def _run(ctl, adm, mb, with_fallback: bool):
    mb.set_budget(GIB)
    admission = adm.AdmissionController(max_concurrent=8, max_queue=4)
    pulses = _Pulses()
    reg = ctl.ActuatorRegistry()
    reg.register(ctl.admission_actuator(admission, floor=2, step=2))
    dev = []
    if with_fallback:
        dev.append(reg.register(ctl.devguard_fallback_actuator()).name)
    dev.append(reg.register(ctl.checkpoint_actuator(pulses)).name)
    dev.append(reg.register(ctl.membudget_actuator(
        floor_bytes=GIB // 2, step_bytes=GIB // 8)).name)
    reg.register(ctl.rebalance_actuator(pulses))
    reg.register(ctl.emergency_cleanup_actuator(pulses.cleanup))
    bindings = [
        ctl.Binding("q", ("query_slots",), name="query-burn", hold_ticks=1),
        ctl.Binding("dev", tuple(dev), name="device-burn", fire_ticks=1),
        ctl.Binding("node", ("rebalance",), name="node-burn",
                    sustain_window="2m", sustain_burn=1.0),
        ctl.Binding("node", ("emergency_cleanup",), name="disk-burn",
                    fire_ticks=3),
    ]
    clock = [0.0]
    tick_no = [0]

    def burn_source():
        doc = SEQ[tick_no[0]]
        return {"rules": {r: ({"burn": v[0], "firing": v[1]} if v else None)
                          for r, v in doc.items()}}

    c = ctl.Controller(reg, bindings, burn_source=burn_source,
                       clock=lambda: clock[0], min_interval_s=2.0,
                       history=_History())
    # the rate-limit refusals of device_fallback, counted a tick
    fb_limited = [0]
    allowed = c._allowed

    def counted(name):
        ok = allowed(name)
        fb_limited[0] += (not ok) and name == "device_fallback"
        return ok

    c._allowed = counted
    trace = []
    seen = 0
    for i in range(len(SEQ)):
        tick_no[0] = i
        clock[0] += 1.0
        fb_limited[0] = 0
        stats = c.tick(now_nanos=i * 10**9)
        actions = [{k: v for k, v in a.items() if k != "unix"}
                   for a in list(c.actions)[seen:]]
        seen = len(c.actions)
        stats["fallback_rate_limited"] = fb_limited[0]
        trace.append([stats, actions, admission.max_concurrent, mb.budget(),
                      pulses.saves, pulses.ticks, pulses.cleanups])
    status = c.status()
    for a in status["recent"]:
        a.pop("unix")
    return trace, status


def _without_fallback(trace, status):
    """The reference's run as it reads without the device_fallback
    actuator: its actions dropped from each tick (and from that tick's
    shed/relax counts), its rate-limit refusals from the rate-limited
    counts, its actions from the total and the recent tail, and its name
    from the device binding."""
    actions = []
    limited = 0
    for step in trace:
        stats, acts = step[0], step[1]
        limited += stats["fallback_rate_limited"]
        stats["rate_limited"] -= stats["fallback_rate_limited"]
        stats["fallback_rate_limited"] = 0
        for a in acts:
            if a["actuator"] == "device_fallback":
                stats[{"shed": "sheds", "relax": "relaxes"}[a["action"]]] -= 1
        step[1] = [a for a in acts if a["actuator"] != "device_fallback"]
        actions += step[1]
    fb = status["actuators"].pop("device_fallback")
    status["bindings"]["device-burn"]["actuators"].remove("device_fallback")
    status["actions_total"] = len(actions)
    status["rate_limited"] -= limited
    status["recent"] = actions[-20:]
    return fb


@pytest.fixture
def clean():
    yield
    for mb in (tmb, jmb):
        mb.set_budget(0)
    jdg.reset_stages()  # the reference's force_fallback flag
    jbreaker.reset_registry()


def test_same_burns_same_actions_but_device_fallback(clean):
    port_trace, port = _run(tctl, tadm, tmb, with_fallback=False)
    ref_trace, ref = _run(jctl, jadm, jmb, with_fallback=True)
    fb = _without_fallback(ref_trace, ref)
    assert fb["sheds"] > 0 and fb["kind"] == "devguard"
    assert port_trace == ref_trace
    assert port == ref
    # the sequence moved every kind of actuator and held on unknowns
    assert port["held_unknown"] > 0 and port["rate_limited"] > 0
    assert port["actuators"]["query_slots"]["sheds"] > 0
    assert port["actuators"]["query_slots"]["relaxes"] > 0
    assert port["actuators"]["membudget"]["sheds"] > 0
    assert port_trace[-1][2] == 8 and port_trace[-1][3] == GIB  # back at baseline


def test_binding_and_actuator_validation_equal():
    for kw in ({"rule": "", "actuators": ("a",)}, {"rule": "r", "actuators": ()},
               {"rule": "r", "actuators": ("a",), "fire_ticks": 0},
               {"rule": "r", "actuators": ("a",), "hold_ticks": -1},
               {"rule": "r", "actuators": ("a",), "clear_burn": 0.0}):
        with pytest.raises(ValueError) as te:
            tctl.Binding(**kw)
        with pytest.raises(ValueError) as je:
            jctl.Binding(**kw)
        assert str(te.value) == str(je.value)
    for step in (0.0, -1.0):
        with pytest.raises(ValueError) as te:
            tctl.Actuator("a", "k", 1.0, 0.0, step, lambda v: None)
        with pytest.raises(ValueError) as je:
            jctl.Actuator("a", "k", 1.0, 0.0, step, lambda v: None)
        assert str(te.value) == str(je.value)
