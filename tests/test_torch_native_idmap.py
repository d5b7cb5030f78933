"""The port's native ID->slot resolver (``m3_tpu_torch/native/idmap.py``
over ``m3_tpu_torch/csrc/idmap.cc``, built with g++ at first use) against
its Python resolver and against ``m3_tpu.native.idmap``, on 10^5 ids:
the same slots for a seeded stream of batches with duplicates, the same
release and reuse order, the same all-or-nothing capacity exhaustion,
the same limiter rejections.  ``use_native=None`` takes the native path
here (g++ is present), ``use_native=True`` raises when the build cannot
run (a bad compiler path, in a subprocess), and ``None`` then falls back
to the Python resolver as the JAX package's does.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import m3_tpu.aggregator.engine as je
import m3_tpu.native.idmap as jidmap
import m3_tpu.storage.limits as jlim
import m3_tpu_torch.aggregator.engine as te
import m3_tpu_torch.native.idmap as tidmap
import m3_tpu_torch.storage.limits as tlim
from m3_tpu.metrics.aggregation import AggregationID as JAID
from m3_tpu.metrics.types import MetricType as JMT
from m3_tpu_torch.metrics.aggregation import AggregationID as TAID
from m3_tpu_torch.metrics.types import MetricType as TMT

N = 100_000
ROOT = Path(__file__).resolve().parent.parent


def _stream(seed, n_ids=N, batches=6, size=40_000):
    rng = np.random.default_rng(seed)
    pool = [b"svc.%d.req{host=h%d}" % (i % 97, i) for i in range(n_ids)]
    out = []
    for _ in range(batches):
        idx = rng.integers(0, n_ids, size)
        out.append([pool[i] for i in idx])
    return pool, out


def test_native_builds_here_and_is_the_default():
    assert tidmap.available()
    m = te.MetricMap(16)
    assert m.native
    assert not te.MetricMap(16, use_native=False).native
    assert te.MetricMap(16, use_native=True).native


def test_raw_native_resolver_matches_jax_binding():
    """The two bindings over their own copies of idmap.cc: same slots, new
    positions, lengths and release results for 10^5 ids."""
    if not jidmap.available():
        pytest.skip("the JAX package's native build is unavailable")
    pool, batches = _stream(1)
    a, b = jidmap.NativeIdMap(3 * N), tidmap.NativeIdMap(3 * N)
    for k, ids in enumerate(batches):
        mask = 1 << (k % 3)
        ja, jn = a.resolve(ids, mask)
        ta, tn = b.resolve(ids, mask)
        assert np.array_equal(ja, ta) and np.array_equal(jn, tn)
        assert len(a) == len(b)
        for sid in ids[:: 997]:
            assert a.release(sid, mask) == b.release(sid, mask)


@pytest.mark.parametrize("kind", ["native", "python"])
def test_metric_map_matches_jax_slots_release_reuse(kind):
    """Port MetricMap (each resolver) against the JAX MetricMap with the
    same resolver: slots of every batch, ids by slot, then a release of
    every 7th live slot and a batch of new ids that reuses them in the
    same order."""
    use = kind == "native"
    jm = je.MetricMap(N, use_native=use)
    tm = te.MetricMap(N, use_native=use)
    assert tm.native == use and (jm._native is not None) == use
    pool, batches = _stream(2, n_ids=N - 1000)
    for k, ids in enumerate(batches):
        aid_j, aid_t = JAID.DEFAULT, TAID.DEFAULT
        sj = jm.resolve(ids, aid_j, JMT.COUNTER)
        st = tm.resolve(ids, aid_t, TMT.COUNTER)
        assert np.array_equal(sj, st), k
    assert len(jm) == len(tm)
    live = sorted({int(s) for s in sj})
    for s in live[::7]:
        jm.release(s)
        tm.release(s)
    fresh = [b"fresh.%d" % i for i in range(len(live[::7]) + 500)]
    sj = jm.resolve(fresh, JAID.DEFAULT, JMT.GAUGE)
    st = tm.resolve(fresh, TAID.DEFAULT, TMT.GAUGE)
    assert np.array_equal(sj, st)
    assert all(jm.id_of(s) == tm.id_of(s) for s in range(0, N, 101))
    assert tm.to_entries() == jm.to_entries()


def test_native_and_python_resolvers_agree():
    """Within the port: the native and the Python resolver assign the same
    slots, release and reuse in the same order."""
    nat, py = te.MetricMap(N), te.MetricMap(N, use_native=False)
    pool, batches = _stream(3)
    for ids in batches:
        got = nat.resolve(ids, TAID.DEFAULT, TMT.COUNTER)
        assert np.array_equal(got, py.resolve(ids, TAID.DEFAULT, TMT.COUNTER))
    assert len(nat) == len(py)
    for s in sorted({int(x) for x in got})[::13]:
        nat.release(s)
        py.release(s)
    more = [b"more.%d" % i for i in range(9000)]
    assert np.array_equal(nat.resolve(more, TAID.DEFAULT, TMT.COUNTER),
                          py.resolve(more, TAID.DEFAULT, TMT.COUNTER))


@pytest.mark.parametrize("use_native", [True, False])
def test_capacity_exhaustion_is_all_or_nothing_as_jax(use_native):
    outs = []
    for eng, aid, mt in ((je, JAID, JMT), (te, TAID, TMT)):
        m = eng.MetricMap(1000, use_native=use_native)
        m.resolve([b"a%d" % i for i in range(900)], aid.DEFAULT, mt.COUNTER)
        with pytest.raises(RuntimeError, match="capacity 1000 exhausted"):
            m.resolve([b"a5"] + [b"b%d" % i for i in range(200)], aid.DEFAULT, mt.COUNTER)
        after = m.resolve([b"c%d" % i for i in range(100)], aid.DEFAULT, mt.COUNTER)
        outs.append((len(m), after.tolist(), m.to_entries()))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("use_native", [True, False])
def test_limiter_rejections_match_jax(use_native):
    outs = []
    for eng, aid, mt, lim in ((je, JAID, JMT, jlim), (te, TAID, TMT, tlim)):
        clock = [5.0]
        m = eng.MetricMap(N, use_native=use_native,
                          limiter=lim.NewSeriesLimiter(2000, now=lambda: clock[0]))
        got = []
        pool, batches = _stream(4, n_ids=20_000, batches=3, size=5000)
        for ids in batches:
            got.append(m.resolve(ids, aid.DEFAULT, mt.COUNTER).tolist())
            clock[0] += 0.5
        outs.append((got, m.to_entries()))
    assert outs[0] == outs[1]
    assert any(s < 0 for s in outs[1][0][0])


def _run_py(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=120)


def test_use_native_true_raises_when_the_build_cannot_run(tmp_path):
    r = _run_py(f"""
        import sys
        sys.modules['jax'] = None
        sys.modules['m3_tpu'] = None
        from pathlib import Path
        import m3_tpu_torch.native._build as b
        b.CXX = {str(tmp_path / 'no-such-compiler')!r}
        b.BUILD_DIR = Path({str(tmp_path / 'build')!r})
        from m3_tpu_torch.aggregator.engine import MetricMap
        assert not MetricMap(8).native          # None: the Python resolver
        try:
            MetricMap(8, use_native=True)
        except RuntimeError as e:
            print('raised:', e)
        else:
            raise SystemExit('use_native=True did not raise')
        """)
    assert r.returncode == 0, r.stderr
    assert "raised: native idmap unavailable" in r.stdout
