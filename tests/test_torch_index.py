"""m3_tpu_torch.index against m3_tpu.index on the CPU.

* the bitset ops (``bs_*``) on random words, ``num_docs % 64`` zero or
  not, exactly (u64 words as their bits; popcounts as integers);
* segments, the boolean search (host path and device bitset path) and
  ``NamespaceIndex``: the cases of ``tests/test_index.py``, each run
  through both packages, with equal postings, equal documents and
  byte-identical segment files.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import m3_tpu.index.doc as jdoc
import m3_tpu.index.namespace_index as jnsi
import m3_tpu.index.postings as jps
import m3_tpu.index.search as jsearch
import m3_tpu.index.segment as jseg
import m3_tpu_torch.index.doc as tdoc
import m3_tpu_torch.index.namespace_index as tnsi
import m3_tpu_torch.index.postings as tps
import m3_tpu_torch.index.search as tsearch
import m3_tpu_torch.index.segment as tseg
from m3_tpu_torch._bits import torch_to_u64, u64_to_torch

BLOCK = 2 * 3600 * 10**9
START = (1_700_000_000 * 10**9) // BLOCK * BLOCK

J = types.SimpleNamespace(doc=jdoc, seg=jseg, search=jsearch, ps=jps,
                          index=lambda *a: jnsi.NamespaceIndex(*a))
T = types.SimpleNamespace(doc=tdoc, seg=tseg, search=tsearch, ps=tps,
                          index=lambda *a: tnsi.NamespaceIndex(*a, device="cpu"))
PKGS = {"jax": J, "port": T}


# -- bitset ops -------------------------------------------------------------

def _words(rng, shape):
    return rng.integers(0, 1 << 64, shape, dtype=np.uint64, endpoint=False)


@pytest.mark.parametrize("num_docs", [1, 63, 64, 65, 1000, 4096, 4097])
def test_bitset_ops_match_jax(num_docs):
    rng = np.random.default_rng(num_docs)
    nw = (num_docs + 63) // 64
    a, b = _words(rng, nw), _words(rng, nw)
    a[0] |= np.uint64(1 << 63)  # the sign bit of the int64 carrier
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = u64_to_torch(a), u64_to_torch(b)
    for name in ("bs_and", "bs_or", "bs_andnot"):
        np.testing.assert_array_equal(
            np.asarray(getattr(jps, name)(ja, jb)),
            torch_to_u64(getattr(tps, name)(ta, tb)), err_msg=name)
    np.testing.assert_array_equal(np.asarray(jps.bs_not(ja, num_docs)),
                                  torch_to_u64(tps.bs_not(ta, num_docs)))
    # the complement holds exactly the ids below num_docs not in a
    got = tps.from_bitset(torch_to_u64(tps.bs_not(ta, num_docs)), None)
    want = np.setdiff1d(np.arange(num_docs), tps.from_bitset(a, num_docs))
    np.testing.assert_array_equal(got, want)
    assert int(jps.bs_count(ja)) == int(tps.bs_count(ta))


def test_bitset_count_and_any_and_rows():
    rng = np.random.default_rng(2)
    q = _words(rng, (9, 17))
    q[3] = 0
    q[4] = np.uint64((1 << 64) - 1)
    q[5, :] = np.uint64(1 << 63)
    tgt = _words(rng, 17)
    tgt[::2] = 0
    np.testing.assert_array_equal(
        np.asarray(jps.bs_count(jnp.asarray(q))).astype(np.int64),
        tps.bs_count(u64_to_torch(q)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jps.bs_any_and(jnp.asarray(q), jnp.asarray(tgt))),
        tps.bs_any_and(u64_to_torch(q), u64_to_torch(tgt)).numpy())
    assert int(tps.bs_count(u64_to_torch(q[4]))) == 64 * 17


def test_postings_roundtrip_and_ops():
    """``test_index.py``'s postings case, through the port."""
    a = np.asarray(sorted(np.random.default_rng(0).choice(1000, 200, False)), np.int32)
    b = np.asarray(sorted(np.random.default_rng(1).choice(1000, 300, False)), np.int32)
    wa, wb = tps.to_bitset(a, 1000), tps.to_bitset(b, 1000)
    np.testing.assert_array_equal(wa, jps.to_bitset(a, 1000))
    np.testing.assert_array_equal(tps.from_bitset(wa, 1000), a)
    got_and = tps.from_bitset(torch_to_u64(tps.bs_and(u64_to_torch(wa), u64_to_torch(wb))), 1000)
    np.testing.assert_array_equal(got_and, np.intersect1d(a, b))
    got_not = tps.from_bitset(torch_to_u64(tps.bs_not(u64_to_torch(wa), 1000)), 1000)
    np.testing.assert_array_equal(got_not, np.setdiff1d(np.arange(1000), a))


# -- segments and search ----------------------------------------------------

def _docs(P, n=100):
    return [
        P.doc.Document.from_tags(
            f"cpu.util.host{i:03d}".encode(),
            {
                b"__name__": b"cpu_util",
                b"host": f"host{i:03d}".encode(),
                b"dc": b"us-east" if i % 2 == 0 else b"eu-west",
                b"role": b"db" if i % 10 == 0 else b"web",
            },
        )
        for i in range(n)
    ]


def _queries(S):
    return {
        "term": S.Term(b"dc", b"us-east"),
        "term_missing": S.Term(b"nope", b"x"),
        "conjunction": S.Conjunction(S.Term(b"dc", b"us-east"), S.Term(b"role", b"db")),
        "disjunction": S.Disjunction(S.Term(b"role", b"db"), S.Term(b"dc", b"eu-west")),
        "negation": S.Negation(S.Term(b"dc", b"eu-west")),
        "conj_negation": S.Conjunction(S.Term(b"role", b"web"),
                                       S.Negation(S.Regexp(b"host", b"host0[0-4].*"))),
        "regexp": S.Regexp(b"host", b"host00.*"),
        "field_exists": S.FieldExists(b"host"),
        "all": S.All(),
        "empty_conj": S.Conjunction(),
        "empty_disj": S.Disjunction(),
        "nested": S.Disjunction(S.Conjunction(S.Term(b"dc", b"eu-west"),
                                              S.Negation(S.All())),
                                S.Negation(S.Disjunction(S.Term(b"role", b"web")))),
    }


def _sealed(P, n=100):
    m = P.seg.MutableSegment()
    m.insert_batch(_docs(P, n))
    return m.seal()


@pytest.mark.parametrize("qname", sorted(_queries(jsearch)))
def test_search_matches_jax(qname):
    """Each query on the 100-doc segment: the port's host path, the
    port's device bitset path and JAX's host and bitset paths give the
    same postings."""
    js, ts_ = _sealed(J), _sealed(T)
    assert js.to_bytes() == ts_.to_bytes()
    jq, tq = _queries(jsearch)[qname], _queries(tsearch)[qname]
    want = jsearch._exec_host(js, jq)
    np.testing.assert_array_equal(tsearch.execute_segment(ts_, tq, "cpu"), want)
    jbits = np.asarray(jsearch._exec_bitset(js, jq, js.num_docs))
    tbits = tsearch._exec_bitset(ts_, tq, ts_.num_docs, torch.device("cpu"))
    np.testing.assert_array_equal(torch_to_u64(tbits), jbits)
    np.testing.assert_array_equal(tps.from_bitset(torch_to_u64(tbits), ts_.num_docs), want)


def test_bitset_path_matches_host_path_above_threshold():
    """Cross 2^16 docs: ``execute_segment`` takes the device bitset path
    (the JAX package's too), equal to the host path."""
    n = tsearch.DEVICE_BITSET_THRESHOLD + 10
    assert n == jsearch.DEVICE_BITSET_THRESHOLD + 10
    segs = []
    for P in (J, T):
        m = P.seg.MutableSegment()
        for i in range(n):
            m.insert(P.doc.Document.from_tags(
                f"id{i}".encode(), {b"p": b"even" if i % 2 == 0 else b"odd"}))
        segs.append(m.seal())
    qj = jsearch.Conjunction(jsearch.Term(b"p", b"even"),
                             jsearch.Negation(jsearch.Regexp(b"p", b"od.")))
    qt = tsearch.Conjunction(tsearch.Term(b"p", b"even"),
                             tsearch.Negation(tsearch.Regexp(b"p", b"od.")))
    got = tsearch.execute_segment(segs[1], qt, "cpu")
    np.testing.assert_array_equal(got, tsearch._exec_host(segs[1], qt))
    np.testing.assert_array_equal(got, jsearch.execute_segment(segs[0], qj))
    assert len(got) == (n + 1) // 2


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_segment_cases(pkg):
    """``test_index.py``'s segment cases, in each package."""
    P = PKGS[pkg]
    sealed = _sealed(P)
    assert len(sealed.postings_term(b"dc", b"us-east")) == 50
    assert sealed.postings_term(b"dc", b"nope").size == 0
    m = P.seg.MutableSegment()
    d = _docs(P, 1)[0]
    assert m.insert(d) == m.insert(d) == 0 and len(m) == 1
    back = P.seg.SealedSegment.from_bytes(sealed.to_bytes())
    assert back.num_docs == sealed.num_docs and back.fields() == sealed.fields()
    assert back.doc(3).tags() == sealed.doc(3).tags()
    m2 = P.seg.MutableSegment()
    m2.insert_batch(_docs(P, 150))
    merged = P.seg.merge_segments([sealed, m2.seal()])
    assert merged.num_docs == 150


def test_merged_segments_byte_identical():
    outs = []
    for P in (J, T):
        m2 = P.seg.MutableSegment()
        m2.insert_batch(_docs(P, 150)[::-1])
        outs.append(P.seg.merge_segments([_sealed(P), m2.seal()]).to_bytes())
    assert outs[0] == outs[1]


# -- namespace index --------------------------------------------------------

def _files(root):
    import pathlib
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(pathlib.Path(root).rglob("*")) if p.is_file()}


def _ids(docs):
    return sorted(d.id for d in docs)


def _ns_blocked(P, root):
    idx = P.index(BLOCK, root, "ns")
    docs = _docs(P, 20)
    idx.write_batch(docs, np.full(20, START + 10**10, np.int64))
    out = [_ids(idx.query(P.search.Term(b"role", b"db"), START, START + BLOCK))]
    idx.seal_block(START)
    idx2 = P.index(BLOCK, root, "ns")
    out.append(_ids(idx2.query(P.search.Term(b"role", b"db"), START, START + BLOCK)))
    out.append(_ids(idx2.query(P.search.All(), START + BLOCK, START + 2 * BLOCK)))
    return out


def _ns_churn(P, root):
    idx = P.index(BLOCK, root, "churn")
    alive: set[int] = set()
    rng = np.random.default_rng(9)
    out = []
    for round_no in range(12):
        born = set(range(round_no * 100, round_no * 100 + 100))
        dead = (set(rng.choice(sorted(alive), size=len(alive) // 2).tolist())
                if alive else set())
        alive = (alive - dead) | born
        if dead:
            idx.delete_series(START, [b"churn.%04d" % i for i in dead])
        docs = [P.doc.Document.from_tags(b"churn.%04d" % i,
                                         {b"__name__": b"churn", b"gen": b"g%d" % (i % 7)})
                for i in sorted(born)]
        idx.write_batch(docs, np.full(len(docs), START + 10**10, np.int64))
        idx.seal_block(START)
        idx.compact()
        counts = idx.segment_counts
        assert all(c <= tnsi.MAX_SEGMENTS for c in counts.values()), counts
        got = _ids(idx.query(P.search.Term(b"__name__", b"churn"), START, START + BLOCK))
        assert got == sorted(b"churn.%04d" % i for i in alive)
        out.append((got, dict(counts)))
    return out


def _ns_tombstones(P, root):
    idx = P.index(BLOCK, None, "t")
    docs = _docs(P, 10)
    idx.write_batch(docs, np.full(10, START + 10**10, np.int64))
    idx.seal_block(START)
    idx.delete_series(START, [docs[0].id])
    out = [_ids(idx.query(P.search.All(), START, START + BLOCK))]
    idx.compact_block(START)
    out.append(_ids(idx.query(P.search.All(), START, START + BLOCK)))
    out.append(sum(len(s) for s in idx.sealed[START]))
    # a re-created series clears its tombstone
    idx.delete_series(START, [docs[1].id])
    idx.write_batch([docs[1]], np.full(1, START + 2 * 10**10, np.int64))
    out.append(_ids(idx.query(P.search.All(), START, START + BLOCK)))
    return out


def _ns_multi_segment(P, root):
    idx = P.index(BLOCK, root, "p")
    for r in range(3):
        docs = [P.doc.Document.from_tags(b"p.%d.%d" % (r, i), {b"__name__": b"p"})
                for i in range(5)]
        idx.write_batch(docs, np.full(5, START + 10**10, np.int64))
        idx.seal_block(START)
    idx2 = P.index(BLOCK, root, "p")
    return [idx.segment_counts[START], idx2.segment_counts[START],
            _ids(idx2.query(P.search.Term(b"__name__", b"p"), START, START + BLOCK))]


def _ns_mutable_tombstone(P, root):
    idx = P.index(BLOCK, None, "t")
    d_a = P.doc.Document.from_tags(b"a", {b"k": b"v"})
    d_b = P.doc.Document.from_tags(b"b", {b"k": b"v"})
    bs = START // BLOCK * BLOCK
    idx.write_batch([d_b], np.full(1, START, np.int64))
    idx.seal_block(bs)
    idx.write_batch([d_a], np.full(1, START, np.int64))
    idx.delete_series(bs, [b"a"])
    q = P.search.Term(b"k", b"v")
    out = [_ids(idx.query(q, START - BLOCK, START + BLOCK))]
    idx.compact()
    out.append(_ids(idx.query(q, START - BLOCK, START + BLOCK)))
    idx.seal_block(bs)
    idx.compact()
    out.append(bs in idx.tombstones)
    out.append(_ids(idx.query(q, START - BLOCK, START + BLOCK)))
    return out


def _ns_snapshot(P, root):
    idx = P.index(BLOCK, root, "s")
    idx.write_batch(_docs(P, 30), START + np.arange(30, dtype=np.int64) * 10**11)
    snap = root + "/snap"
    n = idx.snapshot_mutable(snap)
    idx2 = P.index(BLOCK, None, "s")
    m = idx2.restore_snapshot(snap)
    return [n, m, _ids(idx2.query(P.search.Term(b"dc", b"eu-west"), START, START + 2 * BLOCK))]


NS_CASES = {f.__name__[4:]: f for f in (_ns_blocked, _ns_churn, _ns_tombstones,
                                         _ns_multi_segment, _ns_mutable_tombstone,
                                         _ns_snapshot)}


@pytest.mark.parametrize("case", sorted(NS_CASES))
def test_namespace_index_matches_jax(case, tmp_path):
    """``test_index.py``'s namespace-index cases through both packages:
    equal answers at every step and byte-identical files on disk."""
    got = {}
    for name, P in PKGS.items():
        root = str(tmp_path / name)
        got[name] = (NS_CASES[case](P, root), _files(root))
    assert got["jax"][0] == got["port"][0]
    assert got["jax"][1] == got["port"][1]


def test_namespace_index_needs_a_device_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: None resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnsi.NamespaceIndex(BLOCK, None, "x")
