"""m3_tpu_torch.x.devguard against m3_tpu.x.devguard on the CPU.

``classify`` over the errors torch and the port's kernel wrappers raise
(and, where the JAX package's classifier sees the same shapes, the same
answer); the same faultpoint sequence through fallback-less stages of
both packages gives the same results, counters, breaker states and
``status()``; a port node under an armed ``device.dispatch`` refuses
writes (503), acknowledges none of them, and every acknowledged write
before and after reads back, also after a restart — where the JAX node,
staging on the host, acknowledges the same writes; and the reference's
fallback surface (``force_fallback``, ``fallback_forced``, the
``device_fallback`` actuator) is absent.  Exact comparisons.
"""

import inspect
import json
import time
import urllib.error
import urllib.request

import pytest
import torch

from m3_tpu.server import assembly as jasm
from m3_tpu.x import breaker as jbreaker
from m3_tpu.x import devguard as jdg
from m3_tpu.x import fault as jfault
from m3_tpu_torch.server import assembly as tasm
from m3_tpu_torch.x import breaker as tbreaker
from m3_tpu_torch.x import controller as tctl
from m3_tpu_torch.x import devguard as tdg
from m3_tpu_torch.x import fault as tfault

OOM_MSG = ("CUDA out of memory. Tried to allocate 80.00 GiB. GPU 0 has a "
           "total capacity of 79.19 GiB")

# (the error, the kind devguard.classify gives it; None = not a device error)
CLASSIFY = [
    (lambda: torch.OutOfMemoryError(OOM_MSG), "oom"),
    (lambda: RuntimeError("CUDA error: out of memory"), "oom"),
    (lambda: RuntimeError("place_words: CUDA error 2 (out of memory)"), "oom"),
    (lambda: RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                          "toolkit"), "compile"),
    (lambda: RuntimeError("CUDA kernel build failed:\nplace_words: nvcc "
                          "exited 1\nerror"), "compile"),
    (lambda: RuntimeError("CUDA error: an illegal memory access was "
                          "encountered"), "lost"),
    (lambda: RuntimeError("CUDA error: device-side assert triggered"), "lost"),
    (lambda: RuntimeError("CUDA error: unspecified launch failure"), "lost"),
    (lambda: RuntimeError("extract_fields64_t: CUDA error 700 (an illegal "
                          "memory access was encountered)"), "lost"),
    (lambda: RuntimeError("segment_ingest: CUDA error 710 (device-side "
                          "assert triggered)"), "lost"),
    (lambda: RuntimeError("segment_minmax: CUDA error 719 (unspecified "
                          "launch failure)"), "lost"),
    (lambda: RuntimeError("place_words: CUDA error 9 (invalid configuration "
                          "argument)"), "state"),
    (lambda: RuntimeError("CUDA error: invalid device ordinal"), "state"),
    (lambda: RuntimeError("packed counter arena overflow-pool error: overflow "
                          "pool exhausted"), "state"),
    (lambda: tdg.DeviceOOM("encode"), "oom"),
    (lambda: TypeError("unsupported operand"), None),
    (lambda: ValueError("shape mismatch"), None),
    (lambda: RuntimeError("a Python bug"), None),
    (lambda: KeyError("slot"), None),
]


@pytest.mark.parametrize("make,kind", CLASSIFY)
def test_classify_torch_and_kernel_errors(make, kind):
    cls = tdg.classify(make())
    assert (None if cls is None else cls.kind) == kind


def test_classify_agrees_with_the_reference_on_shared_shapes():
    # host-raised shapes both classifiers see the same way
    for exc in (TypeError("x"), ValueError("x"), KeyError("x"),
                RuntimeError("a Python bug"),
                RuntimeError("packed counter arena overflow-pool error: x")):
        got, want = tdg.classify(exc), jdg.classify(exc)
        assert (got and got.kind) == (want and want.kind)
    for kind in ("DeviceOOM", "CompileFailure", "DeviceLost", "DeviceStateError"):
        t, j = getattr(tdg, kind), getattr(jdg, kind)
        assert t.kind == j.kind and str(t("s", "m")) == str(j("s", "m"))


def _scenario(dg, fault, breaker, guarded) -> list:
    """One scripted faultpoint sequence through fallback-less stages;
    every step's outcome, then the counters and ``status()``."""
    breaker.reset_registry()
    dg.reset_stages()
    fault.disarm()
    dg.configure(failures=3, reset_s=3600.0)

    def transfer():
        dg.transfer_point("s.drain")
        return "drained"

    def bug():
        raise ValueError("shape mismatch")

    def poisoned():
        raise RuntimeError("packed counter arena overflow-pool error: full")

    steps = [("device.compile=error:n=1", "s.ingest", lambda: "ok"),
             (None, "s.ingest", lambda: "ok"),
             ("device.dispatch=error:n=4", "s.ingest", lambda: "ok")]
    steps += [(None, "s.ingest", lambda: "ok")] * 4
    steps += [("device.transfer=error:n=1", "s.drain", transfer),
              (None, "s.drain", transfer),
              (None, "s.drain", bug),
              (None, "s.drain", poisoned)]
    out = []
    try:
        for spec, stage, fn in steps:
            if spec:
                fault.apply_request({"arm": spec})
            try:
                got = ("ok", guarded(dg, stage, fn))
            except Exception as e:  # noqa: BLE001 — the outcome is the result
                got = (type(e).__name__, str(e))
            out.append((got, dg.stage_breaker(stage).state))
        out.append(dg.counters())
        out.append(dg.status())
    finally:
        fault.disarm()
        breaker.reset_registry()
        dg.reset_stages()
        dg.configure(failures=5, reset_s=10.0)
    return out


def test_counters_breakers_and_status_equal_the_reference():
    port = _scenario(tdg, tfault, tbreaker,
                     lambda dg, st, fn: dg.run_guarded(st, fn))
    ref = _scenario(jdg, jfault, jbreaker,
                    lambda dg, st, fn: dg.run_guarded(st, fn, None))
    assert port == ref
    kinds = [step[0][0] for step in port[:-2]]
    assert kinds == ["CompileFailure", "ok", "DeviceOOM", "DeviceOOM", "DeviceOOM",
                     "DeviceOOM", "ok", "DeviceLost", "ok", "ValueError",
                     "DeviceStateError"]
    assert port[4][1] == "open" and port[6][1] == "closed"


def test_no_fallback_surface():
    assert "fallback" not in inspect.signature(tdg.run_guarded).parameters
    for name in ("force_fallback", "fallback_forced"):
        assert hasattr(jdg, name) and not hasattr(tdg, name)
    assert not hasattr(tctl, "devguard_fallback_actuator")


# ---- a node under an armed device.dispatch --------------------------------

SEC = 10**9
T0 = 1_700_000_000 * SEC


def _call(port, path, body=None, method="GET"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _write(port, k: int):
    """Scrape k of 8 gauges, as one JSON write."""
    body = [{"tags": {"__name__": "g", "i": str(i)}, "timestamp": T0 + k * 10 * SEC,
             "value": float(100 * k + i)} for i in range(8)]
    return _call(port, "/api/v1/json/write", json.dumps(body).encode(), "POST")


def _reads(db) -> dict:
    return {i: db.read("default", b"g{i=%d}" % i, T0, T0 + 3600 * SEC)
            for i in range(8)}


def _config(root) -> str:
    return (f"db: {{root: {root}}}\ncoordinator: {{listen_port: 0}}\n"
            "mediator: {enabled: false}\n"
            "device: {breaker_failures: 2, breaker_reset: 50ms}\n")


@pytest.fixture
def clean_guard():
    for reg in (tbreaker, jbreaker):
        reg.reset_registry()
    tdg.reset_stages()
    jdg.reset_stages()
    yield
    for f in (tfault, jfault):
        f.disarm()
    for reg in (tbreaker, jbreaker):
        reg.reset_registry()
    tdg.reset_stages()
    jdg.reset_stages()
    tdg.configure(failures=5, reset_s=10.0)
    jdg.configure(failures=5, reset_s=10.0)


def test_refused_writes_are_never_acknowledged(tmp_path, clean_guard):
    asm = tasm.run_node(_config(tmp_path / "port"), device="cpu")
    jas = jasm.run_node(_config(tmp_path / "jax"))
    arm = json.dumps({"arm": "device.dispatch=error"}).encode()
    disarm = json.dumps({"disarm": ["device.dispatch"]}).encode()
    try:
        acked = {}
        for k in (0, 1):
            st, _ = _write(asm.port, k)
            assert st == 200
            acked[k] = True
        assert _call(asm.port, "/api/v1/debug/faults", arm, "POST")[0] == 200
        for k in (2, 3, 4):
            st, body = _write(asm.port, k)
            assert st == 503, body
            err = json.loads(body)["error"]
            assert err.startswith("device oom at stage 'storage.buffer_append'")
        health = json.loads(_call(asm.port, "/health")[1])
        stage = health["device"]["stages"]["storage.buffer_append"]
        assert stage["errors"] == {"oom": 3} and stage["breaker"] == "open"
        # the JAX node stages the same writes on the host and acknowledges
        assert _call(jas.port, "/api/v1/debug/faults", arm, "POST")[0] == 200
        assert [_write(jas.port, k)[0] for k in (2, 3, 4)] == [200] * 3

        assert _call(asm.port, "/api/v1/debug/faults", disarm, "POST")[0] == 200
        time.sleep(0.06)  # breaker_reset: the next call is the probe
        assert _write(asm.port, 5)[0] == 200
        acked[5] = True
        health = json.loads(_call(asm.port, "/health")[1])
        assert health["device"]["stages"]["storage.buffer_append"]["breaker"] == "closed"

        want = {i: [(T0 + k * 10 * SEC, float(100 * k + i)) for k in sorted(acked)]
                for i in range(8)}
        assert _reads(asm.db) == want
        root = asm.db.opts.root
        asm.close()
        asm = tasm.run_node(_config(root), device="cpu")  # commit-log replay
        assert _reads(asm.db) == want
    finally:
        asm.close()
        jas.close()


def test_refused_allocation_is_counted_and_released(monkeypatch, clean_guard):
    """The CPU form of a ring the card cannot hold: the allocation raises
    torch.OutOfMemoryError inside the append stage; the buffer raises
    DeviceOOM, the stage counts it and its breaker records it, and the
    reservation is released."""
    from m3_tpu_torch.storage import buffer as tbuf
    from m3_tpu_torch.x import membudget as tmb

    def refuse(*a, **kw):
        raise torch.OutOfMemoryError(OOM_MSG)

    monkeypatch.setattr(tbuf, "buffer_init", refuse)
    tdg.configure(failures=1, reset_s=3600.0)
    used = tmb.used()
    with pytest.raises(tdg.DeviceOOM) as e:
        tbuf.ShardBuffer(3600 * SEC, 2, 1 << 40, 1 << 20, device="cpu")
    assert isinstance(e.value.__cause__, torch.OutOfMemoryError)
    assert tmb.used() == used
    doc = tdg.status()["stages"]["storage.buffer_append"]
    assert doc == {"errors": {"oom": 1}, "breaker": "open"}


def test_carbon_batch_the_card_refuses_is_counted_and_the_connection_serves_on(
        tmp_path, clean_guard):
    """Carbon has no acknowledgement channel: a batch whose append the
    device refuses is counted on ``storage.buffer_append`` and dropped,
    and the same connection's later lines are stored (the reference
    stages the batch on the host and stores it: a stated difference)."""
    import socket

    asm = tasm.run_node(_config(tmp_path).replace(
        "{listen_port: 0}", "{listen_port: 0, carbon_listen_port: 0}"), device="cpu")
    paths = [b"m3.host%d.cpu" % i for i in range(8)]

    def lines(k):
        return b"".join(b"%s %d %d\n" % (p, 100 * k + i, (T0 + k * 10 * SEC) // SEC)
                        for i, p in enumerate(paths))

    def stored():
        return {p: asm.db.read("default", p, T0, T0 + 3600 * SEC) for p in paths}

    def stage():
        return tdg.status()["stages"].get("storage.buffer_append", {})

    def wait(pred):
        deadline = time.monotonic() + 30
        while not pred():
            assert time.monotonic() < deadline
            time.sleep(0.02)

    try:
        with socket.create_connection(("127.0.0.1", asm.carbon_port)) as s:
            s.sendall(lines(0))
            wait(lambda: all(stored().values()))
            tfault.arm("device.dispatch", "error")
            s.sendall(lines(1))
            wait(lambda: stage().get("errors"))
            tfault.disarm("device.dispatch")
            time.sleep(0.06)  # breaker_reset: the next append is the probe
            s.sendall(lines(2))
            wait(lambda: all(len(v) == 2 for v in stored().values()))
        assert stage()["errors"] == {"oom": 1}
        assert stored() == {p: [(T0 + k * 10 * SEC, float(100 * k + i)) for k in (0, 2)]
                            for i, p in enumerate(paths)}
        metrics = _call(asm.port, "/metrics")[1].decode()
        assert "m3tpu_carbon_samples 24" in metrics  # parsed and handed on
    finally:
        asm.close()
