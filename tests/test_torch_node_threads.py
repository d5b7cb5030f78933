"""The port's node under concurrent requests (``ThreadingHTTPServer``
runs each request on a thread of its own, the mediator loop on another).

Three properties, on the CPU and, marked ``gpu``, on a card:

* concurrent Prometheus remote writes and ``query_range`` requests while
  ``mediator.run_once`` runs on another thread leave the same fileset
  files and give the same answers as the same requests sent one at a
  time to a node on the CPU (the commit log and snapshots record arrival
  order, so they are not compared);
* a kernel's first load under concurrent first callers builds it once
  and every caller gets the same library (with a fake build here; with
  ``nvcc`` and kernel #1 on a card);
* ``Assembly.close()`` joins the mediator, with a pass in flight, before
  the database closes.

No thread of the port leaves work on a side stream: every kernel wrapper
launches on ``torch.cuda.current_stream`` and the port makes no stream
of its own, which the last test checks in the sources.

This file imports no JAX, so it runs on the card without the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_node_threads.py
"""

import hashlib
import json
import pathlib
import re
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from m3_tpu_torch.core.config import (
    CoordinatorConfig, DBConfig, MediatorConfig, NamespaceConfig, NodeConfig,
)
from m3_tpu_torch.parallel import _cuda
from m3_tpu_torch.parallel import encode_place as ep
from m3_tpu_torch.server import prom_remote as pr
from m3_tpu_torch.server.assembly import run_node
from m3_tpu_torch.x import lockcheck

SEC = 10**9
BLOCK = 2 * 3600 * SEC
START = (1_700_000_000 * SEC) // BLOCK * BLOCK
END = (START + 590 * SEC) // SEC
WRITERS = 8        # concurrent remote-write requests, 10 series each
QUERIERS = 2       # concurrent query_range requests, 2 each
REPO = pathlib.Path(__file__).resolve().parent.parent

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)]


@pytest.fixture(autouse=True)
def lock_order_sanitizer():
    """Every test here runs with the port's lock-order sanitizer armed in
    raise mode over every lock the test makes, and fails on any finding."""
    lockcheck.reset()
    lockcheck.install(raise_on_cycle=True)
    try:
        yield
        found = lockcheck.findings()
    finally:
        lockcheck.uninstall()
        lockcheck.reset()
    assert not found, "\n".join(map(str, found))


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    return name


def _config(root, tick="1h"):
    return NodeConfig(
        db=DBConfig(root=str(root), namespaces={"default": NamespaceConfig(
            num_shards=2, slot_capacity=1024, sample_capacity=8192)}),
        coordinator=CoordinatorConfig(listen_port=0),
        mediator=MediatorConfig(tick_interval=tick, snapshot_every=1, cleanup_every=1,
                                scrub_every=1, scrub_volumes=4))


def _call(port, path, body=None, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _write(port, body):
    return _call(port, "/api/v1/prom/remote/write", body,
                 {"Content-Encoding": "snappy"})[0]


def _body(name, w):
    """Request ``w``: 10 counters of its own, 60 scrapes at 10 s."""
    return pr.build_write_request([pr.PromTimeSeries(
        {b"__name__": name, b"host": b"h%d_%d" % (w, i)},
        [(START + k * 10 * SEC, float(w * 10_000 + i * 100 + k * (i + 1)))
         for k in range(60)]) for i in range(10)])


QUERIES = [f"/api/v1/query_range?query=reqs&start={START // SEC}&end={END}&step=10",
           f"/api/v1/query_range?query=max_over_time(reqs[1m])"
           f"&start={START // SEC + 60}&end={END}&step=30",
           f"/api/v1/series?start={START // SEC}&end={END}"]
PRE_QUERY = (f"/api/v1/query_range?query=max_over_time(pre[1m])"
             f"&start={START // SEC + 60}&end={END}&step=30")


def _answers(port) -> list:
    """The queries' statuses and bodies; ``/series`` lists the index in
    insertion order, which follows arrival, so its entries are sorted."""
    out = [_call(port, q) for q in QUERIES]
    st, body = out[-1]
    doc = json.loads(body)
    out[-1] = (st, sorted(json.dumps(d, sort_keys=True) for d in doc["data"]))
    return out


def _fileset_digests(root) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(pathlib.Path(root).rglob("*"))
            if p.is_file() and "fileset" in p.name}


def _serial(root):
    """The reference: every request one at a time, on the CPU."""
    asm = run_node(_config(root), device="cpu")
    try:
        assert _write(asm.port, _body(b"pre", 99)) == 204
        pre = _call(asm.port, PRE_QUERY)
        assert pre[0] == 200
        for w in range(WRITERS):
            assert _write(asm.port, _body(b"reqs", w)) == 204
        for _ in range(2):
            asm.mediator.run_once(START + 300 * SEC)
        asm.mediator.run_once(START + BLOCK + 11 * 60 * SEC)
        answers = _answers(asm.port)
    finally:
        asm.close()
    return pre, answers


@pytest.mark.parametrize("device", DEVICES)
def test_concurrent_requests_match_serial(tmp_path, device):
    dev = _device(device)
    pre, answers = _serial(tmp_path / "serial")
    root = tmp_path / "threads"
    asm = run_node(_config(root), device=dev)
    try:
        assert _write(asm.port, _body(b"pre", 99)) == 204
        bodies = [_body(b"reqs", w) for w in range(WRITERS)]
        go = threading.Barrier(WRITERS + QUERIERS + 1)
        got: dict = {}

        def writer(w):
            go.wait()
            got[("w", w)] = _write(asm.port, bodies[w])

        def querier(q):
            go.wait()
            got[("q", q)] = [_call(asm.port, PRE_QUERY) for _ in range(2)]

        def mediator():
            go.wait()
            got["m"] = [asm.mediator.run_once(START + 300 * SEC) for _ in range(2)]

        threads = ([threading.Thread(target=writer, args=(w,)) for w in range(WRITERS)]
                   + [threading.Thread(target=querier, args=(q,)) for q in range(QUERIERS)]
                   + [threading.Thread(target=mediator)])
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        assert [got[("w", w)] for w in range(WRITERS)] == [204] * WRITERS
        for q in range(QUERIERS):
            assert got[("q", q)] == [pre, pre]
        assert all(s["tick"]["default"]["warm_flushed"] == 0 for s in got["m"])

        before = ep.launches
        stats = asm.mediator.run_once(START + BLOCK + 11 * 60 * SEC)
        assert stats["tick"]["default"]["warm_flushed"] == (WRITERS + 1) * 10
        if dev == "cuda":
            assert ep.launches > before
        assert _answers(asm.port) == answers
        assert answers[0][0] == 200 and b'"h7_9"' in answers[0][1]
    finally:
        asm.close()
    ft, fs = _fileset_digests(root), _fileset_digests(tmp_path / "serial")
    assert ft == fs and any("-data.db" in k for k in ft)


def test_first_load_builds_once_under_threads(monkeypatch):
    """Concurrent first callers of ``_cuda.load``: one build, one library."""
    builds, made = [], []

    def slow_build(names):
        builds.append(list(names))
        time.sleep(0.2)                      # nvcc's seconds, shortened

    class FakeLib:
        def __init__(self, path):
            made.append(path)
            self.m3_error_string = type("F", (), {})()

    monkeypatch.setattr(_cuda, "_LIBS", {})
    monkeypatch.setattr(_cuda, "build", slow_build)
    monkeypatch.setattr(_cuda.ctypes, "CDLL", FakeLib)
    go = threading.Barrier(8)
    libs = [None] * 8

    def first(i):
        go.wait()
        libs[i] = _cuda.load(ep.KERNEL)

    threads = [threading.Thread(target=first, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert builds == [[ep.KERNEL]] and len(made) == 1
    assert all(lib is libs[0] for lib in libs)


@pytest.mark.gpu
def test_first_kernel_build_under_concurrent_launches(tmp_path, monkeypatch):
    """Kernel #1's first build, from an empty build directory, under four
    threads launching it at once: one ``nvcc``, and every launch's output
    equal to the plain version."""
    _device("cuda")
    runs = []
    popen = _cuda.subprocess.Popen

    def counting(cmd, *a, **kw):
        runs.append(cmd[-1])
        return popen(cmd, *a, **kw)

    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_cuda, "_LIBS", {})
    monkeypatch.setattr(_cuda.subprocess, "Popen", counting)
    # disjoint one-bit fragments within each key group, as an encode
    # pass gives them; the per-series offset puts some keys out of range
    S, F = 257, 1000
    f = torch.arange(F)
    keys = ((f // 64) * 2 + torch.arange(S)[:, None] % 5 - 2).to(torch.int32)
    frags = torch.ones((), dtype=torch.int64) << (f % 64)
    gen = torch.Generator().manual_seed(5)
    frags = torch.where(torch.rand((S, F), generator=gen) < 0.3, 0, frags)
    want = ep.place_words_plain(frags, keys, 16)
    go = threading.Barrier(4)
    outs = [None] * 4

    def launch(i):
        go.wait()
        outs[i] = ep.place_words(frags.cuda(), keys.cuda(), 16).cpu()

    threads = [threading.Thread(target=launch, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(runs) == 1 and runs[0].endswith(f"{ep.KERNEL}.cu")
    assert all(torch.equal(o, want) for o in outs)


@pytest.mark.parametrize("device", DEVICES)
def test_close_joins_mediator_before_database_closes(tmp_path, device):
    dev = _device(device)
    asm = run_node(_config(tmp_path / "root", tick="10ms"), device=dev)
    db, thread = asm.db, asm.mediator._thread
    entered, seen = threading.Event(), {}
    real_tick, real_close = db.tick, db.close

    def slow_tick(now):
        entered.set()
        time.sleep(0.3)                      # a pass in flight at close()
        out = real_tick(now)
        seen["tick_done"] = time.monotonic()
        return out

    def close():
        seen["close"] = time.monotonic()
        seen["mediator_alive"] = thread.is_alive()
        real_close()

    db.tick, db.close = slow_tick, close
    assert entered.wait(30)
    asm.close()
    assert seen["mediator_alive"] is False
    assert seen["tick_done"] <= seen["close"]


STREAM_USE = re.compile(r"torch\.cuda\.(Stream|stream|ExternalStream)\(|non_blocking\s*=\s*True")


def test_port_makes_no_side_stream():
    """Every launch goes to the calling thread's current stream (the
    default one), so a read on any thread orders after it."""
    hits = [f"{p.relative_to(REPO)}:{n}"
            for p in sorted((REPO / "m3_tpu_torch").rglob("*.py"))
            for n, line in enumerate(p.read_text().splitlines(), 1)
            if STREAM_USE.search(line)]
    assert hits == []
