"""The encode scan (``m3_tpu_torch.parallel.encode_scan``), on the CPU.

* The wrapper's plain version against the JAX package's
  ``lax.scan(jax.vmap(_encode_step))`` from ``m3tsz_jax._encode_carry0``
  (``m3_tpu.encoding.m3tsz_jax``): the lane values, the widths and the
  final 13-row carry, bit for bit, in all four sub-minute time units,
  over one seeded batch that reaches every path of the step: int diffs
  that grow and shrink (the sig tracker fires after five lower steps),
  decimals with multipliers 1-6, raw floats with contained and
  uncontained XOR, repeats, int/float switches, NaN, +-Inf, -0.0,
  subnormals, |v| >= 2^63, |val| > 2^53 (the precision fallback), a
  delta-of-delta outside 32 bits (the overflow fallback), deltas off the
  unit grid, unaligned starts, counts shorter than T.
* The host build of the kernel's per-step logic (``csrc/encode_scan.cuh``
  through ``csrc/encode_scan_host.cc``, built with g++) against the plain
  version on that batch, at T = 1 and at an S that is no multiple of the
  kernel's block, on random 64-bit value patterns and timestamps, and
  with a default unit other than the unit (which the JAX contract does
  not have).
* The wrapper's checks, and its routing.
* On a card (``gpu`` marker; each test decides inside whether there is
  one): the kernel against its plain version on the same batches, and
  ``encode_batch`` on the card against the pinned encode digest.

The module imports no JAX (the JAX tests import it inside), so the
``gpu`` tests run on the card's machine without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_encode_scan.py
"""

import ctypes
import functools
import hashlib

import numpy as np
import pytest
import torch

from m3_tpu_torch.core.xtime import Unit
from m3_tpu_torch.encoding import m3tsz_torch as mt
from m3_tpu_torch.native._build import load_native
from m3_tpu_torch.parallel import encode_scan as esc

SEC = 10**9
START = 1_600_000_000 * SEC
UNITS = [Unit.SECOND, Unit.MILLISECOND, Unit.MICROSECOND, Unit.NANOSECOND]
# tests/test_torch_m3tsz.py's PINNED_ENCODE_DIGEST, repeated here so that
# the gpu test needs no JAX (test_the_pinned_digest_is_the_suites holds
# the two equal)
PINNED_ENCODE_DIGEST = (
    "27ea67c4b75585a1e2bffa6cfeae5e5faeefbaca75de4d5c4c559f15d89ccc18")


def _family(i: int, rng, T: int) -> np.ndarray:
    """Series ``i``'s values: one of twelve families."""
    k = np.arange(T)
    fam = i % 12
    if fam == 0:  # ints, diffs that grow then shrink: five lower-sig steps fire
        d = np.where(k < T // 3, rng.integers(-(1 << 20), 1 << 20, T),
                     rng.integers(-3, 4, T))
        return np.cumsum(d).astype(np.float64)
    if fam == 1:  # decimals with multipliers 1-6
        return np.round(rng.normal(0, 50, T), 1 + i % 6)
    if fam == 2:  # raw floats: contained and uncontained XOR
        return rng.normal(0, 1, T) * np.where(k % 9 == 0, 1e6, 1.0)
    if fam == 3:  # repeats
        return np.full(T, float(rng.integers(-5, 5)))
    if fam == 4:  # int <-> float switches
        return np.where(k % 3 == 0, rng.normal(0, 1, T), k * 1.0)
    if fam == 5:  # specials
        v = np.round(rng.normal(10, 2, T), 2)
        v[k % 7 == 1] = np.nan
        v[k % 11 == 2] = np.inf
        v[k % 13 == 3] = -np.inf
        v[k % 5 == 4] = -0.0
        return v
    if fam == 6:  # subnormals and the smallest normals
        return np.where(k % 2 == 0, 5e-324 * (k + 1), 2.2e-308 * (k % 5))
    if fam == 7:  # |v| >= 2^63, and |val| > 2^53 (the precision fallback)
        return np.where(k % 4 == 0, 2.0 ** 63 * (1 + k % 3), 2.0 ** 53 + 2 * k)
    if fam == 8:  # decimals that need the multiplier to grow along the series
        return np.array([round(x, 1 + (j // 20) % 6) for j, x in enumerate(rng.normal(0, 5, T))])
    if fam == 9:  # near 1e13 and near-decimal doubles
        return np.where(k % 2 == 0, 9.999999e12 + k, 0.1 + 0.2 * k)
    if fam == 10:  # negative ints and decimals, mixed
        return np.where(k % 4 < 2, -k * 3.0, -np.round(rng.normal(7, 1, T), 3))
    v = rng.normal(0, 1, T)  # floats, then ints (a float -> int switch)
    v[T // 2:] = np.arange(T - T // 2)
    return v


@functools.lru_cache(maxsize=None)
def _batch(S: int = 67, T: int = 120, seed: int = 0):
    """(ts, value bits, valid, starts) numpy arrays of the mixed batch."""
    rng = np.random.default_rng(seed)
    step = rng.integers(1, 40, (S, T)) * SEC
    step[:, ::29] += 5000 * SEC                    # the default bucket
    step[:, 11::37] += 150 * SEC                   # the 9-bit bucket
    step[:, 17::41] += 1000 * SEC                  # the 12-bit bucket
    step[3::17, T // 2] = (1 << 31) * SEC          # a dod outside 32 bits (SECOND)
    step[5::19, 7 % T] += 7                        # off every grid but NANOSECOND
    step[6::23, 9 % T] += 7_000                    # off SECOND and MILLISECOND
    starts = np.full(S, START, np.int64)
    starts[1::5] -= 123                            # unaligned: a time-unit marker
    starts[2::7] -= 5 * SEC                        # aligned to SECOND only
    ts = starts[:, None] + np.cumsum(step, axis=1)
    vals = np.stack([_family(i, rng, T) for i in range(S)])
    valid = np.ones((S, T), bool)
    for i in range(4, S, 9):                       # counts shorter than T
        valid[i, int(rng.integers(0, T)):] = False
    valid[7::31] = False                           # empty series
    vb = np.ascontiguousarray(vals).view(np.int64).copy()
    return ts.astype(np.int64), vb, valid, starts


def _random_batch(seed: int, S: int = 40, T: int = 60):
    """Random 64-bit value patterns and timestamps, random masks."""
    rng = np.random.default_rng(seed + 100)
    ts = rng.integers(-(1 << 62), 1 << 62, (S, T), dtype=np.int64)
    ts[: S // 2] = np.sort(ts[: S // 2], axis=1)
    vb = rng.integers(-(1 << 63), (1 << 63) - 1, (S, T), dtype=np.int64)
    exp = rng.integers(1000, 1100, (len(vb[::3]), T)).astype(np.int64) << 52
    vb[::3] = (vb[::3] & ~np.int64(0x7FF << 52)) | exp  # magnitudes near 1
    valid = rng.random((S, T)) < 0.9
    starts = rng.integers(-(1 << 62), 1 << 62, S, dtype=np.int64)
    return ts, vb, valid, starts


def _inputs(ts, vb, valid, starts, unit, default_unit=None, dev="cpu"):
    """The scan's inputs as ``_encode_batch_device`` makes them."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    carry0 = mt._encode_carry0(ts.shape[0], t(starts), int(unit),
                               int(unit if default_unit is None else default_unit))
    return (t(ts.T), t(vb.T), t(valid.T), carry0, int(unit),
            Unit(unit) in (Unit.SECOND, Unit.MILLISECOND))


def _np(result):
    """(lv, lw, carry) -> a flat list of int64 numpy arrays."""
    lv, lw, carry = result
    return [lv.cpu().numpy(), lw.cpu().numpy().astype(np.int64)] + [
        c.cpu().numpy().astype(np.int64) for c in carry]


def _assert_same(got, want, what):
    names = ["lv", "lw"] + [f"carry[{k}]" for k in range(esc.CARRY_ROWS)]
    assert len(got) == len(want) == len(names), what
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, (what, name, g.shape, w.shape)
        bad = np.argwhere(g != w)
        assert bad.size == 0, f"{what} {name}: first differing lane {bad[0]} of {len(bad)}"


@functools.lru_cache(maxsize=None)
def _plain(unit: int, shape=(67, 120)):
    return _np(esc.encode_scan_plain(*_inputs(*_batch(*shape), unit)))


def _jax_scan(ts, vb, valid, starts, unit):
    """The reference's scan as its ``_encode_batch_device`` runs it:
    (lv, lw, carry) as int64 numpy arrays."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from m3_tpu.encoding import m3tsz_jax as mj

    step = functools.partial(mj._encode_step, unit=int(unit),
                             default_unit_is_32bit=Unit(unit) in (Unit.SECOND, Unit.MILLISECOND))
    vstep = jax.vmap(step)

    def scan_fn(carry, xs):
        c2, (t0, t1, v0, v1, n0, n1, n2, n3) = vstep(carry, xs)
        return c2, (jnp.stack([t0, t1, v0, v1]), jnp.stack([n0, n1, n2, n3]))

    carry0 = mj._encode_carry0(ts.shape[0], jnp.asarray(starts), int(unit))
    xs = (jnp.asarray(ts.T), jnp.asarray(vb.T.view(np.uint64)), jnp.asarray(valid.T))
    carry, (lv, lw) = jax.jit(lambda c, x: lax.scan(scan_fn, c, x))(carry0, xs)

    def i64(a):
        a = np.asarray(a)
        if a.dtype in (np.uint32, np.uint64):
            a = a.view({4: np.int32, 8: np.int64}[a.itemsize])
        return a.astype(np.int64)

    return [i64(lv), i64(lw)] + [i64(c) for c in carry]


# ---------------------------------------------------------------------------
# the plain scan against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("unit", UNITS, ids=lambda u: u.name)
def test_plain_scan_matches_the_jax_scan(unit):
    got = _plain(int(unit))
    _assert_same(got, _jax_scan(*_batch(), unit), f"plain vs JAX ({unit.name})")
    fallback, first = got[2 + 12], got[2 + 11]
    assert fallback.any() and not fallback.all()
    assert first.any()  # a series with no valid point stays first


def test_the_batch_reaches_every_path():
    """The batch's lanes show each control path of the step at SECOND."""
    lv, lw = _plain(int(Unit.SECOND))[:2]
    v0, n_v0, n_t0, n_t1 = lv[:, 2], lw[:, 2], lw[:, 0], lw[:, 1]
    assert (n_t0 == 19).any()                       # the time-unit marker
    assert {1, 9, 12, 16, 36} <= set(np.unique(n_t0[n_t0 > 0]))  # every dod bucket
    assert (n_t1 == 64).any()                       # the marker's 64-bit dod
    assert (n_v0 == 15).any()                       # uncontained XOR
    assert ((n_v0 == 3) & (v0 == 6)).any()          # contained XOR
    assert ((n_v0 == 3) & (v0 == 1)).any()          # int -> float
    assert ((n_v0 == 2) & (v0 == 1)).any()          # a repeat
    assert (n_v0 > 8).any() and (lw[:, 3] > 53).any()


def test_the_pinned_digest_is_the_suites():
    from tests.test_torch_m3tsz import PINNED_ENCODE_DIGEST as suites

    assert PINNED_ENCODE_DIGEST == suites


# ---------------------------------------------------------------------------
# the host build of csrc/encode_scan.cuh (test-only: no wrapper calls it)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _host_lib():
    lib = load_native("encode_scan_host.cc", ("-std=c++17",))
    if lib is None:
        raise RuntimeError("csrc/encode_scan_host.cc did not build (g++)")
    fn = lib.m3_encode_scan_host
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _host_scan(ts_t, vb_t, valid_t, carry0, unit, default32):
    """The kernel's arithmetic on the host, shaped as the wrapper's result."""
    T, S = ts_t.shape
    lv = torch.zeros((T, 4, S), dtype=torch.int64)
    lw = torch.zeros((T, 4, S), dtype=torch.int32)
    c0 = torch.stack([c.to(torch.int64) for c in carry0])
    carry = torch.zeros((esc.CARRY_ROWS, S), dtype=torch.int64)
    assert _host_lib().m3_encode_scan_host(
        ts_t.data_ptr(), vb_t.data_ptr(), valid_t.data_ptr(), c0.data_ptr(), T, S, unit,
        Unit(unit).nanos(), int(default32), lv.data_ptr(), lw.data_ptr(),
        carry.data_ptr()) == 0
    return _np((lv, lw, carry.unbind(0)))


SHAPES = [pytest.param((67, 120), id="67x120"), pytest.param((130, 1), id="T1"),
          pytest.param((3, 9), id="3x9")]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("unit", UNITS, ids=lambda u: u.name)
def test_host_build_of_the_kernel_logic_matches_plain(unit, shape):
    got = _host_scan(*_inputs(*_batch(*shape), unit))
    _assert_same(got, _plain(int(unit), shape), f"host vs plain ({unit.name}, {shape})")


OTHER_DEFAULT = [pytest.param(u, d, id=f"{u.name}-default-{d.name}") for u in UNITS
                 for d in (Unit.SECOND, Unit.MILLISECOND, Unit.NANOSECOND) if d != u]


@pytest.mark.parametrize("unit,default_unit", OTHER_DEFAULT)
def test_host_build_matches_plain_with_another_default_unit(unit, default_unit):
    args = _inputs(*_batch(30, 50, 3), unit, default_unit)
    _assert_same(_host_scan(*args), _np(esc.encode_scan_plain(*args)),
                 f"host vs plain ({unit.name}, default {default_unit.name})")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("unit", [Unit.SECOND, Unit.NANOSECOND], ids=lambda u: u.name)
def test_host_build_matches_plain_on_random_patterns(unit, seed):
    args = _inputs(*_random_batch(seed), unit)
    _assert_same(_host_scan(*args), _np(esc.encode_scan_plain(*args)),
                 f"host vs plain on random patterns ({unit.name}, seed {seed})")


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


def test_wrapper_routes_cpu_tensors_to_plain():
    args = _inputs(*_batch(8, 30, 1), Unit.SECOND)
    before = esc.launches
    lv, lw, carry = esc.encode_scan(*args)
    _assert_same(_np((lv, lw, carry)), _np(esc.encode_scan_plain(*args)), "wrapper")
    assert (lv.dtype, lw.dtype) == (torch.int64, torch.int32)
    assert [c.dtype for c in carry] == [torch.bool if k in (2, 5, 11, 12) else torch.int64
                                        for k in range(esc.CARRY_ROWS)]
    assert esc.launches == before  # the plain path is not a launch


def test_encode_batch_device_goes_through_the_wrapper(monkeypatch):
    seen = []

    def spy(*a):
        seen.append(a[0].shape)
        return esc.encode_scan_plain(*a)

    monkeypatch.setattr(mt, "encode_scan", spy)
    ts, vb, valid, starts = _batch(8, 30, 1)
    mt._encode_batch_device(ts, vb, starts, valid, device="cpu")
    assert seen == [(30, 8)]


def _bad_inputs():
    ts, vb, valid, carry0, unit, d32 = _inputs(*_batch(3, 5, 2), Unit.SECOND)
    c = list(carry0)
    return {
        "ts dtype": ((ts.int(), vb, valid, carry0, unit, d32), TypeError),
        "mask dtype": ((ts, vb, valid.long(), carry0, unit, d32), TypeError),
        "value shape": ((ts, vb[:, :2], valid, carry0, unit, d32), ValueError),
        "one dim": ((ts[0], vb[0], valid[0], carry0, unit, d32), ValueError),
        "carry rows": ((ts, vb, valid, carry0[:12], unit, d32), ValueError),
        "carry row shape": ((ts, vb, valid, tuple(c[:3] + [c[3][:2]] + c[4:]), unit, d32),
                            ValueError),
        "carry flag dtype": ((ts, vb, valid, tuple(c[:2] + [c[2].long()] + c[3:]), unit,
                              d32), TypeError),
        "unit": ((ts, vb, valid, carry0, 0, d32), ValueError),
        "devices": ((ts.to("meta"), vb, valid, carry0, unit, d32), ValueError),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_wrapper_checks(case):
    args, exc = _bad_inputs()[case]
    with pytest.raises(exc):
        esc.encode_scan(*args)


def test_wrapper_raises_on_a_device_without_a_kernel():
    ts, vb, valid, carry0, unit, d32 = _inputs(*_batch(3, 5, 2), Unit.SECOND)
    meta = [x.to("meta") for x in (ts, vb, valid)]
    with pytest.raises(ValueError, match="no kernel"):
        esc.encode_scan(*meta, tuple(c.to("meta") for c in carry0), unit, d32)


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    return torch.device("cuda")


def _kernel_vs_plain(args):
    before = esc.launches
    got = esc.encode_scan(*args)
    assert esc.launches == before + 1
    want = esc.encode_scan_plain(*args)
    for a, b in zip(got[:2] + tuple(got[2]), want[:2] + tuple(want[2])):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("unit", UNITS, ids=lambda u: u.name)
def test_scan_kernel_matches_plain_on_the_card(unit):
    dev = _cuda_or_skip()
    for shape in ((67, 120), (130, 1), (3, 9)):
        _kernel_vs_plain(_inputs(*_batch(*shape), unit, dev=dev))
    _kernel_vs_plain(_inputs(*_batch(30, 50, 3), unit, Unit.SECOND, dev=dev))
    for seed in (0, 1):
        _kernel_vs_plain(_inputs(*_random_batch(seed), unit, dev=dev))


@pytest.mark.gpu
def test_pinned_encode_digest_on_the_card():
    dev = _cuda_or_skip()
    S, T = 8, 64
    i = np.arange(S, dtype=np.int64)[:, None]
    j = np.arange(T, dtype=np.int64)[None, :]
    ts = START + np.cumsum(((i * 37 + j * 11) % 29 + 1) * SEC, axis=1)
    vals = ((i * 131 + j * 17) % 4001 - 2000) / 8.0
    vals[2] = np.float64((j[0] * 7) % 1000)
    vals[5, 10:] = vals[5, 9]
    before = esc.launches
    streams, fb = mt.encode_batch(ts, vals, np.full(S, START, np.int64), out_words=200,
                                  device=dev)
    assert esc.launches == before + 1 and not fb.any()
    words, nbits = mt.pack_streams(streams)
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(words).tobytes())
    h.update(np.ascontiguousarray(nbits).tobytes())
    assert h.hexdigest() == PINNED_ENCODE_DIGEST
