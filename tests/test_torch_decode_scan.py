"""The decode scan (``m3_tpu_torch.parallel.decode_scan``) and kernel #2's
edge cases, on the CPU.

* The wrapper's plain version against the JAX package's
  ``lax.scan(_decode_step)`` (``m3_tpu.encoding.m3tsz_jax``): the four
  lane tables (gather form) or the decoded points (fused form) and the
  final carry, bit for bit, over one mixed batch: seeded numpy corpora,
  the Go golden streams, the pinned decode corpus (annotations, a
  time-unit change, NaN/Inf), int/float switches, first-point
  annotations, unaligned starts, truncated and corrupt streams, and
  ``max_points`` cuts (one of them exactly at the seeded streams' EOS).
* The host build of the kernel's per-step logic (``csrc/decode_scan.cuh``
  through ``csrc/decode_scan_host.cc``, built with g++) against the plain
  version on the same batch and on random words.
* The wrapper's checks, and its routing.
* ``extract_fields64_t``'s edge cases (random, non-monotone, negative and
  past-W offsets, every width class) against its plain version and the
  JAX package's ``extract_fields64_t``.
* On a card (``gpu`` marker; each test decides inside whether there is
  one): the scan kernel and kernel #2 against their plain versions.

The module imports no JAX (the JAX tests import it inside), and its
streams come from the port's own encoder, byte-equal to the reference's
(``tests/test_torch_m3tsz.py``), so the ``gpu`` tests run on the card's
machine without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_decode_scan.py
"""

import base64
import ctypes
import functools
import json
import pathlib

import numpy as np
import pytest
import torch

from m3_tpu_torch._bits import torch_to_u64, u64_to_torch
from m3_tpu_torch.encoding import m3tsz_torch as mt
from m3_tpu_torch.native._build import load_native
from m3_tpu_torch.parallel import decode_gather as dg
from m3_tpu_torch.parallel import decode_scan as dsc

DATA_DIR = pathlib.Path(__file__).resolve().parent / "data"
SEC = 10**9
START = 1_600_000_000 * SEC
FUZZ_T = 120  # the seeded streams' points: the "eos" cut sits at their EOS


def _encode(ts, vals, starts, **kw):
    streams, _ = mt.encode_batch(ts, vals + 0.0, starts, device="cpu", **kw)
    return [s for s in streams if s]


def _seeded(seed: int, S: int, T: int):
    """Series families that reach different control paths: int diffs,
    decimals (multipliers), raw floats (XOR), constants (repeats),
    spikes (uncontained XOR), NaN/Inf; whole-second jittered cadence
    (every dod bucket)."""
    rng = np.random.default_rng(seed)
    ts = START + np.cumsum(rng.integers(1, 40, (S, T)) * SEC, axis=1)
    ts[:, ::29] += 5000 * SEC
    vals = np.empty((S, T))
    for i in range(S):
        fam = i % 6
        if fam == 0:
            vals[i] = np.cumsum(rng.integers(-100, 100, T))
        elif fam == 1:
            vals[i] = np.round(rng.normal(0, 50, T), int(rng.integers(0, 5)))
        elif fam == 2:
            vals[i] = rng.normal(0, 1, T)
        elif fam == 3:
            vals[i] = float(rng.integers(-5, 5))
        elif fam == 4:
            vals[i] = np.where(rng.random(T) < 0.05, 1e8, 7.25)
        else:
            v = np.round(rng.normal(10, 2, T), 2)
            v[rng.random(T) < 0.05] = np.nan
            v[rng.random(T) < 0.02] = np.inf
            vals[i] = v
    return ts.astype(np.int64), vals


def _switch_streams():
    """Ints, decimals and raw floats alternating inside each series (the
    int/float mode switches and the sig/mult cascade)."""
    rng = np.random.default_rng(7)
    T = 60
    ts = np.tile(START + np.arange(1, T + 1) * 10 * SEC, (4, 1)).astype(np.int64)
    vals = np.empty((4, T))
    vals[0] = np.where(np.arange(T) % 3 == 0, rng.normal(0, 1, T), np.arange(T))
    vals[1] = np.where(np.arange(T) % 5 < 2, np.round(rng.normal(9, 3, T), 3),
                       rng.integers(-9, 9, T) * 1000.0)
    vals[2] = np.where(np.arange(T) % 7 == 3, 2.0 ** 40, np.round(rng.normal(1, 1, T), 1))
    vals[3] = np.where(np.arange(T) % 2 == 0, 1e-7 * np.arange(T), -np.arange(T) * 0.5)
    return _encode(ts, vals, np.full(4, START, np.int64), out_words=160)


@functools.lru_cache(maxsize=None)
def _batch():
    """One mixed batch of streams (see the module docstring)."""
    with open(DATA_DIR / "decode_corpus.json") as f:
        streams = [base64.b64decode(s) for s in json.load(f)["streams"]]
    with open(DATA_DIR / "m3tsz_sample_series.json") as f:
        streams += [base64.b64decode(s) for s in json.load(f)]
    for seed in (0, 1):
        ts, vals = _seeded(seed, 6, FUZZ_T)
        # seed 1 starts unaligned: a time-unit marker first
        streams += _encode(ts, vals, np.full(6, START - 123 * seed, np.int64), fit_words=True)
    streams += _switch_streams()
    T = 24
    ts = np.tile(START + np.arange(1, T + 1) * SEC, (2, 1)).astype(np.int64)
    streams += _encode(ts, np.round(ts / SEC % 97 * 0.5, 1), np.full(2, START, np.int64),
                       out_words=128, annotations=[b"schema-A", b"x" * 200])
    rng = np.random.default_rng(11)
    good = [s for s in streams if len(s) > 40]
    streams += [s[: len(s) // 2] for s in good[:4]]           # truncated
    for s in good[4:8]:                                        # bit flips
        b = bytearray(s)
        for i in rng.integers(8, len(b), 3):
            b[i] ^= 1 << int(rng.integers(0, 8))
        streams.append(bytes(b))
    streams += [START.to_bytes(8, "big") + rng.bytes(int(n)) for n in (3, 40, 300)]
    streams += [b"", b"\x00" * 9]
    words, nbits = mt.pack_streams(streams)
    return words, nbits


def _max_points(cut: str) -> int:
    return {"full": 740, "eos": FUZZ_T, "short": 17}[cut]


def _torch_inputs(words, nbits, default_unit=1):
    """The scan's inputs as ``_decode_batch_device`` makes them."""
    w = torch.from_numpy(np.ascontiguousarray(words).view(np.int64))
    wpad = torch.nn.functional.pad(w, (0, mt._PAD_WORDS))
    aligned = (wpad[:, 0] % 10**9) == 0
    unit0 = torch.where(aligned, default_unit, 0).to(torch.int64)
    return (wpad, torch.from_numpy(nbits.astype(np.int64)), unit0,
            mt.value_ctrl_table(torch.device("cpu")))


def _jax_scan(words, nbits, max_points: int, fused: bool, default_unit=1):
    """The reference's scan, as its ``_decode_batch_device`` runs it, with
    its EOS peek folded into done: (lanes, carry) as numpy int64."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from m3_tpu.encoding import m3tsz_jax as mj

    S = words.shape[0]
    wpad = jnp.pad(jnp.asarray(words), ((0, 0), (0, mj._PAD_WORDS)))
    nbits32 = jnp.asarray(nbits).astype(jnp.int32)
    aligned = lax.rem(wpad[:, 0].astype(jnp.int64),
                      jnp.asarray(10**9, jnp.int64)) == 0
    unit0 = jnp.where(aligned, jnp.int32(default_unit), jnp.int32(0))
    carry0 = mj._decode_carry0(S, wpad[:, 0].astype(jnp.int64) if fused else None)
    step = functools.partial(mj._decode_step, words=wpad, nbits=nbits32, unit0=unit0,
                             ctrl_tbl=mj.value_ctrl_table(), emit_chains=fused)
    carry, lanes = jax.jit(lambda c: lax.scan(step, c, None, length=max_points))(carry0)
    cursor, done = carry[0], carry[1]
    peek11 = jax.vmap(lambda w, c: mj._peek(w, c, mj._c(11, jnp.int32)))(wpad, cursor)
    eos_tail = (((cursor + 11) <= nbits32) & ((peek11 >> 2) == 0x100)
                & ((peek11 & 3) == 0))
    _jax_scan.peeked = int((eos_tail & ~done).sum())  # done only through the peek
    carry = (cursor, done | eos_tail) + tuple(carry[2:])

    def i64(a):
        a = np.asarray(a)
        if a.dtype in (np.uint32, np.uint64):
            a = a.view({4: np.int32, 8: np.int64}[a.itemsize])
        return a.astype(np.int64)

    return [i64(x) for x in lanes], [i64(x) for x in carry]


def _np(xs):
    return [x.numpy().astype(np.int64) for x in xs]


def _assert_same(got, want, what):
    assert len(got) == len(want), what
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        bad = np.argwhere(g != w)
        assert bad.size == 0, f"{what}[{k}]: first differing lane {bad[0]} of {len(bad)}"


@functools.lru_cache(maxsize=None)
def _plain(max_points: int, fused: bool):
    words, nbits = _batch()
    lanes, carry = dsc.decode_scan_plain(*_torch_inputs(words, nbits), max_points, fused)
    return _np(lanes), _np(carry)


# ---------------------------------------------------------------------------
# the host build of csrc/decode_scan.cuh (test-only: no wrapper calls it)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _host_lib():
    lib = load_native("decode_scan_host.cc", ("-std=c++17",))
    if lib is None:
        raise RuntimeError("csrc/decode_scan_host.cc did not build (g++)")
    fn = lib.m3_decode_scan_host
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _host_scan(wpad, nbits, unit0, tbl, max_points: int, fused: bool):
    """The kernel's arithmetic on the host, shaped as the wrapper's result."""
    S, Wp = wpad.shape
    dts = (torch.int64, torch.int64, torch.uint8) if fused else (torch.int32,) * 4
    lanes = [torch.zeros((max_points, S), dtype=dt) for dt in dts]
    carry = torch.zeros((dsc.CARRY_ROWS[fused], S), dtype=torch.int64)
    ptrs = [t.data_ptr() for t in lanes] + [0] * (4 - len(lanes))
    assert _host_lib().m3_decode_scan_host(
        wpad.data_ptr(), Wp, nbits.data_ptr(), unit0.data_ptr(), tbl.data_ptr(),
        max_points, S, int(fused), *ptrs, carry.data_ptr()) == 0
    return _np(lanes), _np(list(carry.unbind(0)))


FORMS = [pytest.param(False, id="gather"), pytest.param(True, id="fused")]
CUTS = ["full", "eos", "short"]


@pytest.mark.parametrize("cut", CUTS)
@pytest.mark.parametrize("fused", FORMS)
def test_plain_scan_matches_the_jax_scan(fused, cut):
    words, nbits = _batch()
    P = _max_points(cut)
    lanes, carry = _plain(P, fused)
    want_lanes, want_carry = _jax_scan(words, nbits, P, fused)
    _assert_same(lanes, want_lanes, "lanes")
    _assert_same(carry, want_carry, "carry")
    if cut == "eos":  # the seeded streams end exactly at max_points
        assert _jax_scan.peeked >= 6
    if cut == "full":  # the batch reaches every path the scan has
        assert carry[5].any() and carry[2].any() and (carry[1] == 1).sum() > 20


@pytest.mark.parametrize("cut", CUTS)
@pytest.mark.parametrize("fused", FORMS)
def test_host_build_of_the_kernel_logic_matches_plain(fused, cut):
    words, nbits = _batch()
    P = _max_points(cut)
    got = _host_scan(*_torch_inputs(words, nbits), P, fused)
    want = _plain(P, fused)
    _assert_same(got[0], want[0], "lanes")
    _assert_same(got[1], want[1], "carry")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fused", FORMS)
def test_host_build_matches_plain_on_random_words(fused, seed):
    """Garbage words (markers, annotations and unit bytes at random), bit
    lengths inside the words: every read stays in the zero pad."""
    rng = np.random.default_rng(seed)
    S, W = 64, 24
    words = rng.integers(0, 1 << 64, (S, W), dtype=np.uint64)
    words[:, 0] = np.uint64(START) + rng.integers(0, 2, S).astype(np.uint64)
    words[::4, 1] = np.uint64(0x8040000000000000)  # an annotation marker up front
    nbits = rng.integers(64, W * 64, S).astype(np.int64)
    args = _torch_inputs(words, nbits)
    lanes, carry = dsc.decode_scan_plain(*args, 40, fused)
    got = _host_scan(*args, 40, fused)
    _assert_same(got[0], _np(lanes), "lanes")
    _assert_same(got[1], _np(carry), "carry")


def test_wrapper_routes_cpu_tensors_to_plain():
    words, nbits = _batch()
    args = _torch_inputs(words[:8], nbits[:8])
    before = dsc.launches
    lanes, carry = dsc.decode_scan(*args, 30, fused=False)
    want = dsc.decode_scan_plain(*args, 30, False)
    _assert_same(_np(lanes), _np(want[0]), "lanes")
    _assert_same(_np(carry), _np(want[1]), "carry")
    assert [t.dtype for t in lanes] == [torch.int32] * 4
    assert [t.dtype for t in carry] == [torch.int64] + [torch.bool] * 5 \
        + [torch.int64] * 3 + [torch.bool] + [torch.int64] * 2
    assert dsc.launches == before  # the plain path is not a launch


def _bad_inputs():
    w = torch.zeros((3, 20), dtype=torch.int64)
    n = torch.zeros(3, dtype=torch.int64)
    u = torch.zeros(3, dtype=torch.int64)
    t = torch.zeros(dsc.CTRL_ENTRIES, dtype=torch.int32)
    return {
        "words dtype": ((w.int(), n, u, t, 4), TypeError),
        "table dtype": ((w, n, u, t.long(), 4), TypeError),
        "nbits shape": ((w, n[:2], u, t, 4), ValueError),
        "table shape": ((w, n, u, t[:10], 4), ValueError),
        "one word": ((w[:, :1], n, u, t, 4), ValueError),
        "max_points": ((w, n, u, t, -1), ValueError),
        "devices": ((w.to("meta"), n, u, t, 4), ValueError),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_wrapper_checks(case):
    args, exc = _bad_inputs()[case]
    with pytest.raises(exc):
        dsc.decode_scan(*args)


def test_wrapper_raises_on_a_device_without_a_kernel():
    meta = [torch.zeros((3, 20), dtype=torch.int64, device="meta"),
            torch.zeros(3, dtype=torch.int64, device="meta"),
            torch.zeros(3, dtype=torch.int64, device="meta"),
            torch.zeros(dsc.CTRL_ENTRIES, dtype=torch.int32, device="meta")]
    with pytest.raises(ValueError, match="no kernel"):
        dsc.decode_scan(*meta, 4)


# ---------------------------------------------------------------------------
# kernel #2's edge cases
# ---------------------------------------------------------------------------


def _extract_edges(S: int, W: int, seed: int = 0):
    """(W, S) words with bit 63 set here and there and a zero tail, and
    (F, S) lanes: per series monotone runs (the decoder's halves), a
    non-monotone stretch, negative and past-W offsets, and every width
    class (0, 1..63, 64, outside [0, 64])."""
    rng = np.random.default_rng(seed + S + 7 * W)
    words = rng.integers(0, 1 << 64, (W, S), dtype=np.uint64)
    words[-1:] = 0
    F = 96
    steps = rng.integers(0, 90, (F, S))
    offs = np.cumsum(steps, axis=0) - 50                  # rising, from below 0
    offs[F // 2:] = np.cumsum(steps[F // 2:], axis=0)     # the second half restarts
    offs[10:20] = rng.integers(-300, W * 64 + 300, (10, S))  # non-monotone
    offs[-3:] = W * 64 + rng.integers(0, 500, (3, S))     # past W
    widths = rng.integers(-3, 68, (F, S))
    widths[0], widths[1], widths[2] = 0, 64, 1
    return words, offs.astype(np.int32), widths.astype(np.int32)


EXTRACT_SHAPES = [(1, 2), (31, 2), (33, 2), (1000, 2), (1, 70), (31, 70), (33, 70),
                  (1000, 70)]


@pytest.mark.parametrize("S,W", EXTRACT_SHAPES)
def test_extract_edges_match_plain_and_jax(S, W):
    import jax.numpy as jnp

    from m3_tpu.parallel import pallas_decode as pd

    words, offs, widths = _extract_edges(S, W)
    got = dg.extract_fields64_t(u64_to_torch(words), torch.from_numpy(offs),
                                torch.from_numpy(widths))
    assert torch.equal(got, dg.extract_fields64_t_plain(
        u64_to_torch(words), torch.from_numpy(offs), torch.from_numpy(widths)))
    want = pd.extract_fields64_t(jnp.asarray(words), jnp.asarray(offs), jnp.asarray(widths))
    assert np.array_equal(torch_to_u64(got), np.asarray(want))


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("fused", FORMS)
def test_scan_kernel_matches_plain_on_the_card(fused):
    dev = _cuda_or_skip()
    words, nbits = _batch()
    args = [a.to(dev) for a in _torch_inputs(words, nbits)]
    for P in (_max_points(c) for c in CUTS):
        before = dsc.launches
        lanes, carry = dsc.decode_scan(*args, P, fused=fused)
        assert dsc.launches == before + 1
        want = dsc.decode_scan_plain(*args, P, fused)
        for a, b in zip(lanes + carry, want[0] + want[1]):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("S,W", EXTRACT_SHAPES)
def test_extract_kernel_edges_on_the_card(S, W):
    dev = _cuda_or_skip()
    words, offs, widths = _extract_edges(S, W)
    words = u64_to_torch(words, dev)
    offs, widths = torch.from_numpy(offs).to(dev), torch.from_numpy(widths).to(dev)
    before = dg.launches
    got = dg.extract_fields64_t(words, offs, widths)
    assert dg.launches == before + 1
    assert torch.equal(got, dg.extract_fields64_t_plain(words, offs, widths))
