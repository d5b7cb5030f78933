"""tools/card_bisect: each stage's CPU outputs held against the JAX
package's on the same corpus and operands — the primitives both packages
have bit for bit, the encode's words bit-equal, decoded timestamps,
payloads and meta exact, the int -> float bits exact — and the
bisector's own verdicts (CPU against CPU: every stage equal; no card:
exit 2).  All comparisons are exact (bits, no tolerance)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from m3_tpu.encoding import f64_emul as jfe
from m3_tpu.encoding import m3tsz_jax as mj
from m3_tpu_torch.encoding import m3tsz_torch as mt
from m3_tpu_torch.tools import card_bisect as cb

S, T = 48, 40
CPU = torch.device("cpu")
U64 = jnp.uint64

# the primitives both packages have: the JAX form on the same operands
# (u64 as uint64; the port carries them on int64)
JAX_PRIMITIVES = {
    "u64_shl": lambda a, s: a.astype(U64) << s.astype(U64),
    "u64_shr": lambda a, s: a.astype(U64) >> s.astype(U64),
    "u64_div": lambda a, d: a.astype(U64) // d.astype(U64),
    "u64_mod": lambda a, d: a.astype(U64) % d.astype(U64),
    "u64_mul": lambda a, d: a.astype(U64) * d.astype(U64),
    "i64_clz": lambda a: jax.lax.clz(a),
    "uint_to_f64_bits": lambda a: jfe.uint_to_f64_bits(a.astype(U64)),
    "mul_pow10": lambda b, k: jfe.mul_pow10(b.astype(U64), k.astype(jnp.int32)),
    "int_div_pow10": lambda i, k: jfe.int_div_pow10(i, k),
    "u64_scatter_add": lambda v, i: jnp.zeros(64, U64).at[i].add(v.astype(U64)),
}


@pytest.fixture(scope="module")
def corpus():
    return cb.make_corpus(S, T)


@pytest.mark.parametrize("name", sorted(JAX_PRIMITIVES))
def test_primitive_equals_the_references(name):
    cases = {n: (f, args) for n, f, args in cb.primitive_cases()}
    f, args = cases[name]
    ours = cb._on(CPU, f, *args)
    ref = np.asarray(jax.jit(JAX_PRIMITIVES[name])(*[jnp.asarray(a) for a in args]))
    assert ref.dtype.itemsize == 8 and ours.shape == ref.shape
    assert np.array_equal(ours.view(np.uint64), ref.view(np.uint64))


def test_every_primitive_runs():
    for name, f, args in cb.primitive_cases():
        out = cb._on(CPU, f, *args)
        assert all(np.asarray(o).size for o in (out if isinstance(out, list) else [out])), name


@pytest.fixture(scope="module")
def encoded(corpus):
    ts, vals, starts = corpus
    ow = T * 40 // 64 + 8
    ours = cb.encode_on(CPU, ts, vals, starts, ow)
    ref = {k: np.asarray(v) for k, v in mj.encode_batch_device(
        jnp.asarray(ts), jnp.asarray(vals.view(np.uint64)), jnp.asarray(starts),
        jnp.ones((S, T), bool), unit=1, out_words=ow).items()}
    return ours, ref


def test_encode_words_bit_equal(encoded):
    ours, ref = encoded
    assert np.array_equal(ours["words"].view(np.uint64), ref["words"])
    assert np.array_equal(ours["total_bits"], ref["total_bits"])
    assert np.array_equal(ours["fallback"], ref["fallback"])
    assert not ours["fallback"].all()


def test_decode_and_values_exact(corpus, encoded):
    ts, vals, _ = corpus
    ours, ref = encoded
    streams = mt.finalize_streams(ours["words"], ours["total_bits"])
    assert streams == mj.finalize_streams(ref["words"], ref["total_bits"])
    words, nbits = mt.pack_streams(streams)
    dc = cb.decode_on(CPU, words, nbits, T + 1)
    dr = [np.asarray(x) for x in mj.decode_batch_device(jnp.asarray(words),
                                                        jnp.asarray(nbits), max_points=T + 1)]
    for i, name in enumerate(("ts", "payload", "meta", "err", "prec", "ann")):
        a, b = dc[i], dr[i]
        if name == "payload":
            a, b = a.view(np.uint64), b.astype(np.uint64)
        assert np.array_equal(a, b.astype(a.dtype)), name
    # stage 5: the port's device conversion against the reference's
    bits = cb._on(CPU, cb.to_bits, dc[1], dc[2])
    isf = (dr[2] & 8) != 0
    ref_bits = np.asarray(jnp.where(
        isf, jnp.asarray(dr[1]).astype(U64),
        jfe.int_div_pow10(jnp.asarray(dr[1]).astype(jnp.int64),
                          jnp.asarray(dr[2] & 7).astype(jnp.int64))))
    assert np.array_equal(bits.view(np.uint64), ref_bits)
    ok = ~(ours["fallback"] | dc[3] | dc[4])
    assert ok.sum() > S // 2
    assert np.array_equal(dc[0][ok, :T], ts[ok])
    assert np.array_equal(bits[ok, :T], vals.view(np.int64)[ok])


def test_bisect_cpu_against_cpu_is_equal():
    res = cb.bisect(CPU, CPU, 16, 24)
    assert res == {"bad": [], "f64_output_equal": True}


def test_diff_report_names_the_first_element(capsys):
    a = np.arange(6, dtype=np.int64).reshape(2, 3)
    b = a.copy()
    b[1, 2] = -1
    assert cb._diff_report("x", a, b)
    assert "DIFF at (1, 2) (1 of 6 elements)" in capsys.readouterr().err
    assert not cb._diff_report("y", a, a.copy())


@pytest.mark.skipif(torch.cuda.is_available(), reason="the no-card exit")
def test_main_without_a_card_exits_2():
    assert cb.main(["-S", "4", "-T", "4"]) == 2
