"""m3_tpu_torch.storage.{mediator, scrub} and x.{admission, breaker,
retry} against the JAX package's on the CPU.

A JAX and a port ``Database`` (the port's with ``device="cpu"``), each
with an instrument scope, get the same writes and a ``Mediator`` each
driven by ``run_once`` on one clock: every pass's stats must be equal
(tick, snapshot, cleanup and scrub cadence; wall time excluded), and so
must the ``mediator``, ``db`` and ``scrub`` counters on each registry.
A byte flipped in one fileset volume of both roots must give the same
scrubber findings, the same quarantine inventory and the same reads
afterwards.  The same calls on both packages' admission controllers,
circuit breakers (on a fake clock) and retriers (seeded jitter, fake
sleep) must give the same outcomes, metrics and counters.
"""

import contextlib
import pathlib

import numpy as np
import pytest

import m3_tpu.index.doc as jdoc
import m3_tpu.instrument as jinst
import m3_tpu.storage.database as jdb
import m3_tpu.storage.mediator as jmed
import m3_tpu.storage.scrub as jscrub
from m3_tpu.x import admission as jadm
from m3_tpu.x import breaker as jbr
from m3_tpu.x import deadline as jdl
from m3_tpu.x import retry as jretry
import m3_tpu_torch.index.doc as tdoc
import m3_tpu_torch.instrument as tinst
import m3_tpu_torch.storage.database as tdb
import m3_tpu_torch.storage.mediator as tmed
import m3_tpu_torch.storage.scrub as tscrub
from m3_tpu_torch.x import admission as tadm
from m3_tpu_torch.x import breaker as tbr
from m3_tpu_torch.x import deadline as tdl
from m3_tpu_torch.x import retry as tretry

BLOCK = 2 * 3600 * 10**9
START = (1_700_000_000 * 10**9) // BLOCK * BLOCK
SEC = 10**9
MIN = 60 * SEC
NS = dict(num_shards=2, slot_capacity=512, sample_capacity=4096)


def _db(side, root):
    reg = (jinst if side == "jax" else tinst).new_registry()
    scope = reg.scope("m3tpu")
    if side == "jax":
        db = jdb.Database(jdb.DatabaseOptions(root=str(root)),
                          {"default": jdb.NamespaceOptions(**NS)}, instrument=scope)
    else:
        db = tdb.Database(tdb.DatabaseOptions(root=str(root)),
                          {"default": tdb.NamespaceOptions(**NS)}, instrument=scope,
                          device="cpu")
    return db, reg, scope


def _write(db, doc_mod, k0, k1, seed=3):
    rng = np.random.default_rng(seed + k0)
    docs, ts, vals = [], [], []
    for k in range(k0, k1):
        for i in range(20):
            tags = {b"__name__": b"load", b"host": b"h%02d" % i}
            docs.append(doc_mod.Document.from_tags(b"load{host=h%02d}" % i, tags))
            ts.append(START + k * 30 * SEC)
            vals.append(float(np.round(rng.normal(5, 1), 2)))
    return db.write_tagged_batch("default", docs, np.array(ts, np.int64),
                                 np.array(vals))


def _counters(reg, prefixes) -> dict:
    out = {}
    for line in reg.render_prometheus().splitlines():
        if line.startswith(prefixes) and "_seconds" not in line:
            name, v = line.rsplit(" ", 1)
            out[name] = float(v)
    return out


@pytest.fixture
def pair(tmp_path):
    made = []

    def make(name):
        sides = {}
        for side in ("jax", "torch"):
            db, reg, scope = _db(side, tmp_path / f"{name}-{side}")
            made.append(db)
            sides[side] = (db, reg, scope)
        return sides

    yield make
    for db in made:
        with contextlib.suppress(Exception):
            db.close()


CLOCK = [START + k * 5 * MIN for k in range(1, 5)] + \
    [START + BLOCK + 11 * MIN, START + BLOCK + 20 * MIN, START + 2 * BLOCK + 11 * MIN]


def test_run_once_stats_match_on_one_clock(pair):
    sides = pair("med")
    meds = {}
    for side, (db, reg, scope) in sides.items():
        mod, scrub = (jmed, jscrub) if side == "jax" else (tmed, tscrub)
        meds[side] = mod.Mediator(
            db, clock=lambda: 0, tick_interval_s=3600, snapshot_every=2,
            cleanup_every=3, scrubber=scrub.Scrubber(db, budget_volumes=1,
                                                     instrument=scope),
            scrub_every=2, instrument=scope)
    for step, now in enumerate(CLOCK):
        for side, (db, _, _) in sides.items():
            _write(db, jdoc if side == "jax" else tdoc, 2 * step, 2 * step + 2)
        got = {s: meds[s].run_once(now) for s in sides}
        for st in got.values():
            st.pop("duration_s")
        assert got["torch"] == got["jax"], (step, got)
    prefixes = ("m3tpu_mediator", "m3tpu_db", "m3tpu_scrub", "m3tpu_block_cache")
    ct = _counters(sides["torch"][1], prefixes)
    assert ct == _counters(sides["jax"][1], prefixes)
    assert ct["m3tpu_mediator_ticks"] == len(CLOCK)
    assert ct["m3tpu_mediator_warm_flushed"] > 0 and ct["m3tpu_scrub_sweeps"] == 3


def _flip_one_byte(root) -> pathlib.Path:
    data = sorted(pathlib.Path(root).rglob("fileset-*-data.db"))[0]
    b = bytearray(data.read_bytes())
    b[len(b) // 2] ^= 0xFF
    data.write_bytes(bytes(b))
    return data


def test_scrubber_findings_on_a_corrupt_volume_match(pair):
    sides = pair("scrub")
    found, inv, reads = {}, {}, {}
    for side, (db, reg, scope) in sides.items():
        doc_mod, scrub = (jdoc, jscrub) if side == "jax" else (tdoc, tscrub)
        _write(db, doc_mod, 0, 20)
        db.tick(START + BLOCK + 11 * MIN)
        _flip_one_byte(db.opts.root)
        s = scrub.Scrubber(db, instrument=scope)
        found[side] = (s.run_once(budget=0), s.run_once(budget=0, wait=False))
        inv[side] = sorted(
            tuple((k, e.get(k)) for k in ("kind", "label", "namespace", "shard",
                                           "block_start", "volume", "check",
                                           "error_type"))
            for e in db.quarantine_inventory())
        reads[side] = db.read_batch("default", [b"load{host=h%02d}" % i
                                                for i in range(20)],
                                    START, START + BLOCK)
        found[side] += (_counters(reg, ("m3tpu_scrub", "m3tpu_db_corruption")),)
    assert found["torch"] == found["jax"]
    assert found["torch"][0]["corrupt"] == 1
    assert found["torch"][1]["repair_async"] is False
    assert inv["torch"] == inv["jax"] and len(inv["torch"]) == 1
    assert reads["torch"] == reads["jax"]


class _RefusingPeer:
    """A replica that refuses every block-surface call (down, or the
    placement moved the shard off it)."""

    def __init__(self, err):
        self.err = err

    def __getattr__(self, name):
        def refuse(*a, **k):
            raise self.err
        return refuse


def test_scrubber_refuses_peers(pair):
    """Peers that refuse every call leave the quarantined hole open: the
    sweep completes, counts its repair attempts up to the cap, and the
    hole stays, in both packages alike."""
    sides = pair("refused")
    got = {}
    for side, (db, reg, scope) in sides.items():
        doc_mod, scrub, dbm = (jdoc, jscrub, jdb) if side == "jax" else (tdoc, tscrub, tdb)
        _write(db, doc_mod, 0, 20)
        db.tick(START + BLOCK + 11 * MIN)
        _flip_one_byte(db.opts.root)
        s = scrub.Scrubber(db, instrument=scope, peers=[
            _RefusingPeer(ConnectionError("down")),
            _RefusingPeer(dbm.ShardNotOwnedError("default", 0))])
        runs = [s.run_once(budget=0) for _ in range(scrub.Scrubber.REPAIR_ATTEMPT_CAP + 1)]
        got[side] = (runs, _counters(reg, ("m3tpu_scrub",)),
                     len(db.quarantine_inventory()))
    assert got["torch"] == got["jax"]
    runs, counters, holes = got["torch"]
    assert runs[0]["corrupt"] == 1 and runs[0]["repair_attempts"] == 1
    assert runs[-1]["repair_attempts"] == 0 and not any(r["repaired"] for r in runs)
    assert holes == 1


def _admission_run(adm_mod, dl_mod):
    a = adm_mod.AdmissionController(max_concurrent=2, max_queue=0,
                                    queue_timeout_s=0.01)
    outcomes = []
    with a.admit(deadline=dl_mod.Deadline(5.0)):
        with a.admit():
            try:
                with a.admit():
                    outcomes.append("admitted")
            except adm_mod.QueryShedError as e:
                outcomes.append(("shed", e.retry_after_s > 0))
        outcomes.append(a.metrics())
    a.resize(max_concurrent=1, max_queue=1)
    with a.admit():
        pass
    outcomes.append(a.metrics())
    return outcomes


def test_admission_matches():
    assert _admission_run(tadm, tdl) == _admission_run(jadm, jdl)


class _FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _breaker_run(br_mod, dl_mod):
    br_mod.reset_registry()
    br_mod.reset_counters()
    clock = _FakeClock()
    b = br_mod.CircuitBreaker("peer:x", failure_threshold=3, reset_timeout_s=5.0,
                              clock=clock)
    trail = []

    def fail():
        raise ConnectionError("down")

    def dead():
        raise dl_mod.DeadlineExceeded("late")

    def app_error():
        raise ValueError("answered")

    for fn in (fail, app_error, fail, fail, dead, fail, lambda: 1):
        try:
            trail.append(b.call(fn))
        except br_mod.BreakerOpenError as e:
            trail.append(("open", round(e.retry_in_s, 6)))
        except Exception as e:  # noqa: BLE001 — the outcome is the point
            trail.append(type(e).__name__)
        trail.append(b.state)
        clock.t += 1.0
    clock.t += 10.0
    trail.append(b.state)
    trail.append(b.call(lambda: "probe"))
    trail.append(b.state)
    b.force_open()
    trail.append((b.state, b.state_code))
    shared = br_mod.breaker_for("query:h:1", failure_threshold=1)
    shared.record_failure()
    trail.append(sorted((k, v.state) for k, v in br_mod.all_breakers().items()))
    trail.append(br_mod.counters())
    br_mod.reset_registry()
    br_mod.reset_counters()
    return trail


def test_breaker_matches():
    assert _breaker_run(tbr, tdl) == _breaker_run(jbr, jdl)


def _retry_run(mod):
    mod.reset_counters()
    slept = []
    opts = mod.RetryOptions(initial_backoff_s=0.01, max_attempts=4)
    r = mod.Retrier(opts, name="t", sleep=slept.append, seed=11)
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] % 3:
            raise ConnectionError("blip")
        return calls["n"]

    out = [r.run(flaky), r.run(flaky)]
    try:
        r.run(lambda: (_ for _ in ()).throw(ValueError("no")))
    except ValueError:
        out.append("not_retryable")
    try:
        r.run(lambda: (_ for _ in ()).throw(TimeoutError("t")))
    except TimeoutError:
        out.append("exhausted")
    budget = mod.RetryBudget(capacity=1, refill_per_s=0.0, clock=lambda: 0.0)
    rb = mod.Retrier(opts, name="b", budget=budget, sleep=slept.append, seed=2)
    try:
        rb.run(lambda: (_ for _ in ()).throw(OSError("x")))
    except OSError:
        out.append("budget")
    out += [slept, [r.backoff_for(i) for i in range(6)], mod.counters()]
    mod.reset_counters()
    return out


def test_retry_matches():
    assert _retry_run(tretry) == _retry_run(jretry)


@pytest.mark.parametrize("capacity,want", [("1M", "ok"), ("30K", "low"), ("20K", "critical")])
def test_diskbudget_ledger_matches(tmp_path, capacity, want):
    """The same root through both packages' disk ledgers: equal
    snapshots, levels, shedding and counters (the root's bytes are the
    two nodes' own files, so each ledger walks the same tree)."""
    from m3_tpu.persist.capacity import DiskCapacityError as JErr
    from m3_tpu.x import diskbudget as jdisk
    from m3_tpu_torch.persist.capacity import DiskCapacityError as TErr
    from m3_tpu_torch.x import diskbudget as tdisk

    root = tmp_path / "root"
    for sub, n in (("data/default/0", 9000), ("commitlogs", 4000), ("snapshots", 2000),
                   ("quarantine/x", 1000), ("checkpoint", 500), ("stray", 100)):
        (root / sub).mkdir(parents=True)
        (root / sub / "f.db").write_bytes(b"\0" * n)
    out = {}
    try:
        for mod, err in ((jdisk, JErr), (tdisk, TErr)):
            mod.configure(root, capacity=capacity, reserve="1K", low_ratio=0.5,
                          critical_ratio=0.2)
            snap = mod.refresh()
            shed = None
            try:
                mod.check_ingest()
            except err as e:
                shed = str(e)
            out[mod] = (snap, mod.snapshot(), mod.level(), mod.shedding(),
                        mod.components(), shed, mod.counters())
    finally:
        jdisk.reset()
        tdisk.reset()
    assert out[tdisk] == out[jdisk]
    assert out[tdisk][2] == want and (out[tdisk][5] is not None) == (want == "critical")
