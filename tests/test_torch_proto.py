"""The port's proto value codec and descriptor bridge
(``m3_tpu_torch.encoding.proto_codec`` / ``proto_schema``) against the JAX
package's on the CPU.

Streams are byte-identical both ways (the port encodes and the reference
decodes, and the reverse) for all four field kinds, the bytes fields'
LRU dict with its evictions, unchanged fields, int deltas below -2**63,
NaN, ±inf and -0.0; errors have the same types and messages.  The cases
of ``tests/test_proto_codec.py``, ``tests/test_proto_schema.py`` (the
schema annotation through the port's batched encoder included) and the
proto replay model of ``tests/test_property.py`` run against the port,
the replay model under hypothesis with a fixed seed.  ``proto_schema``
imports, and packs and unpacks annotations, without ``google.protobuf``.
"""

import math
import random
import re
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, seed, settings
from hypothesis import strategies as st

import m3_tpu.encoding.proto_codec as jpc
import m3_tpu.encoding.proto_schema as jps
import m3_tpu_torch.encoding.proto_codec as tpc
import m3_tpu_torch.encoding.proto_schema as tps

ROOT = Path(__file__).resolve().parent.parent
START = 1_700_000_000 * 10**9
FIELDS = (("latency", "FLOAT"), ("count", "INT"), ("endpoint", "BYTES"), ("healthy", "BOOL"))


def schemas(fields=FIELDS):
    """The same schema in both packages."""
    return (jpc.Schema(tuple((n, jpc.FieldKind[k]) for n, k in fields)),
            tpc.Schema(tuple((n, tpc.FieldKind[k]) for n, k in fields)))


def bits(v):
    return struct.pack("<d", v) if isinstance(v, float) else v


def same_messages(a, b):
    """Decoded message lists equal, floats by their bits (NaN, -0.0)."""
    assert len(a) == len(b)
    for (ta, ma), (tb, mb) in zip(a, b):
        assert ta == tb and ma.keys() == mb.keys()
        for k in ma:
            assert type(ma[k]) is type(mb[k]) and bits(ma[k]) == bits(mb[k]), (k, ma[k], mb[k])


def both_ways(fields, msgs, start=START):
    """Encode in each package; the bytes are equal and each package
    decodes the other's stream to the same messages."""
    js, ts = schemas(fields)
    jb = jpc.encode_proto_series(js, msgs, start)
    tb = tpc.encode_proto_series(ts, msgs, start)
    assert tb == jb
    port_of_jax = tpc.decode_proto_series(ts, jb)
    jax_of_port = jpc.decode_proto_series(js, tb)
    same_messages(port_of_jax, jax_of_port)
    same_messages(port_of_jax, jpc.decode_proto_series(js, jb))
    return tb, port_of_jax


def _messages(n=50, s=3):
    """``tests/test_proto_codec.py``'s generator."""
    rng = random.Random(s)
    msgs = []
    endpoints = [b"/api/a", b"/api/b", b"/api/c"]
    count = 0
    for i in range(n):
        count += rng.randrange(0, 100)
        msgs.append((START + i * 10**10 + rng.randrange(0, 10**6),
                     {"latency": round(rng.uniform(0, 1), 3), "count": count,
                      "endpoint": rng.choice(endpoints), "healthy": rng.random() > 0.1}))
    return msgs


# ---- bytes both ways ----------------------------------------------------------


@pytest.mark.parametrize("s", [3, 4, 5])
def test_full_messages_bytes_both_ways(s):
    msgs = _messages(s=s)
    _, out = both_ways(FIELDS, msgs)
    assert out == msgs


def test_each_kind_alone_bytes_both_ways():
    cases = {
        "INT": [0, -1, 2**40, -(2**40), 17, 17, -5, 2**62, -(2**62) - 1, 2**62],
        "FLOAT": [1.5, 1.5, float("inf"), -0.0, 1e-300, float("-inf"), float("nan"),
                  0.0, -0.0, 5e-324, 1.7976931348623157e308],
        "BYTES": [b"", b"x", b"hello" * 40, b"x", b"", b"\x00\xff" * 300],
        "BOOL": [True, False, False, True, True],
    }
    for kind, vals in cases.items():
        msgs = [(START + i * 10**9, {"v": v}) for i, v in enumerate(vals)]
        both_ways((("v", kind),), msgs)


def test_int_deltas_below_int64_min_both_ways():
    # delta -(2**63)-1, then +2**63+1: a 64-bit zigzag would truncate them
    vals = [2**62, -(2**62) - 1, 2**62, -(2**63), 2**63 - 1, -(2**63)]
    msgs = [(START + i * 10**9, {"v": v}) for i, v in enumerate(vals)]
    _, out = both_ways((("v", "INT"),), msgs)
    assert [m["v"] for _, m in out] == vals


def test_lru_dict_eviction_both_ways():
    # five values cycle through the 4-entry dict: each reuse after four
    # others is a literal again, a reuse within four a dict hit
    cyc = [b"/a", b"/b", b"/c", b"/d", b"/e"]
    order = [0, 1, 2, 3, 0, 4, 1, 0, 2, 4, 3, 3, 0, 1, 2, 3, 4, 0, 4, 2]
    msgs = [(START + i * 10**9, {"ep": cyc[k]}) for i, k in enumerate(order)]
    tb, out = both_ways((("ep", "BYTES"),), msgs)
    assert [m["ep"] for _, m in out] == [cyc[k] for k in order]
    # hits are 3 bits, literals carry their bytes: the stream proves both
    ts = schemas((("ep", "BYTES"),))[1]
    assert len(tb) < len(tpc.encode_proto_series(
        ts, [(t, {"ep": m["ep"] + b"-%d" % i}) for i, (t, m) in enumerate(msgs)], START))


def test_unchanged_and_sparse_fields_both_ways():
    msgs = [
        (START + 1, {"latency": 0.5, "count": 1, "endpoint": b"/x", "healthy": True}),
        (START + 2, {"count": 2}),
        (START + 3, {"latency": 0.7}),
        (START + 4, {}),
        (START + 4, {"latency": 0.7, "count": 2}),  # equal values: unchanged bits
        (START - 10**12, {"healthy": False}),  # time going backwards
    ]
    _, out = both_ways(FIELDS, msgs)
    assert out[3][1] == out[2][1] == {"latency": 0.7, "count": 2, "endpoint": b"/x",
                                      "healthy": True}


def test_empty_stream_and_negative_start_both_ways():
    both_ways(FIELDS, [])
    both_ways(FIELDS, [(-5, {"count": 1}), (7, {"count": -3})], start=-(2**62))


def test_encoder_snapshot_mid_stream_matches():
    js, ts = schemas()
    je, te = jpc.ProtoEncoder(js, START), tpc.ProtoEncoder(ts, START)
    for i, (t, m) in enumerate(_messages(20)):
        je.encode(t, m)
        te.encode(t, m)
        if i % 7 == 0:
            assert te.stream() == je.stream()
    assert te.num_encoded == je.num_encoded == 20
    assert te.stream() == je.stream()


# ---- errors -------------------------------------------------------------------


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("fields", [(), (("a", "INT"), ("a", "BYTES")),
                                    (("a", "INT"), ("b", "FLOAT"), ("a", "INT"))])
def test_schema_errors_match(fields):
    j = _outcome(lambda: jpc.Schema(tuple((n, jpc.FieldKind[k]) for n, k in fields)))
    t = _outcome(lambda: tpc.Schema(tuple((n, tpc.FieldKind[k]) for n, k in fields)))
    assert j == t and j[0] == "ValueError"


@pytest.mark.parametrize("values", [{"nope": 1}, {"count": 1, "zz": 2, "aa": 3}])
def test_unknown_field_errors_match(values):
    js, ts = schemas()
    j = _outcome(lambda: jpc.ProtoEncoder(js, START).encode(START + 1, values))
    t = _outcome(lambda: tpc.ProtoEncoder(ts, START).encode(START + 1, values))
    assert j == t and "not in schema" in j[1]


@pytest.mark.parametrize("cut", [0, 4, 8, 9, 12, -1])
def test_truncated_stream_errors_match(cut):
    js, ts = schemas()
    blob = jpc.encode_proto_series(js, _messages(10), START)
    raw = blob[:cut] if cut >= 0 else blob[:-1]
    j = _outcome(lambda: jpc.decode_proto_series(js, raw))
    t = _outcome(lambda: tpc.decode_proto_series(ts, raw))
    if j[0] == "ok":
        assert t[0] == "ok"
        same_messages(j[1], t[1])
    else:
        assert t == j


# ---- tests/test_proto_codec.py against the port -----------------------------------


class TestCodecCases:
    def setup_method(self):
        self.schema = schemas()[1]

    def test_roundtrip(self):
        msgs = _messages()
        assert tpc.decode_proto_series(self.schema, tpc.encode_proto_series(
            self.schema, msgs, START)) == msgs

    def test_float_specials(self):
        schema = tpc.Schema((("v", tpc.FieldKind.FLOAT),))
        vals = [1.5, 1.5, float("inf"), -0.0, 1e-300]
        msgs = [(START + i * 10**9, {"v": v}) for i, v in enumerate(vals)]
        out = tpc.decode_proto_series(schema, tpc.encode_proto_series(schema, msgs, START))
        assert [m[1]["v"] for m in out] == vals
        assert math.copysign(1.0, out[3][1]["v"]) == -1.0

    def test_unchanged_fields_cost_one_bit(self):
        schema = tpc.Schema((("count", tpc.FieldKind.INT), ("pad", tpc.FieldKind.BYTES)))
        msgs = [(START + i * 10**9, {"count": 7}) for i in range(100)]
        assert len(tpc.encode_proto_series(schema, msgs, START)) < 200

    def test_bytes_lru_dict_hits(self):
        schema = tpc.Schema((("ep", tpc.FieldKind.BYTES),))
        cyc = [b"/very/long/endpoint/a", b"/very/long/endpoint/b"]
        msgs = [(START + i * 10**9, {"ep": cyc[i % 2]}) for i in range(40)]
        blob = tpc.encode_proto_series(schema, msgs, START)
        assert len(blob) < sum(len(m["ep"]) for _, m in msgs) / 4

    def test_delta_ints_beat_raw(self):
        schema = tpc.Schema((("v", tpc.FieldKind.INT),))
        msgs = [(START + i * 10**9, {"v": 10**12 + i}) for i in range(200)]
        assert len(tpc.encode_proto_series(schema, msgs, START)) < 200 * 4


# ---- the proto replay model of tests/test_property.py, under hypothesis ---------


def _replay_streams():
    update = st.fixed_dictionaries({}, optional={
        "f": st.one_of(st.floats(allow_nan=True, allow_infinity=True),
                       st.sampled_from([0.0, -0.0])),
        "i": st.integers(-(2**70), 2**70),
        "b": st.one_of(st.sampled_from([b"", b"x", b"hello" * 10]), st.binary(max_size=40)),
        "o": st.booleans(),
    })
    return st.lists(st.tuples(st.integers(-(10**10), 10**10), update), max_size=60)


@seed(1500)
@settings(max_examples=60, deadline=None, derandomize=True)
@given(_replay_streams())
def test_random_message_streams_replay_model(steps):
    """Each decoded message is the replay model's state after its update,
    and both packages write the same bytes and read each other's.  The
    model is the codec's: a field changes when its new value ``!=`` the
    current one, so -0.0 after 0.0 keeps 0.0 and a NaN always changes."""
    fields = (("f", "FLOAT"), ("i", "INT"), ("b", "BYTES"), ("o", "BOOL"))
    msgs = []
    t = START
    for dt, upd in steps:
        t += dt
        msgs.append((t, dict(upd)))
    _, out = both_ways(fields, msgs)
    cur = {"f": 0.0, "i": 0, "b": b"", "o": False}
    for (t, upd), (dt, m) in zip(msgs, out):
        cur.update({k: v for k, v in upd.items() if v != cur[k]})
        assert dt == t
        same_messages([(t, m)], [(t, dict(cur))])


# ---- the descriptor bridge --------------------------------------------------------


def _build_pool():
    """``tests/test_proto_schema.py``'s VehicleUpdate with a nested
    Position, built with protobuf."""
    from google.protobuf import descriptor_pb2, descriptor_pool

    f = descriptor_pb2.FileDescriptorProto()
    f.name, f.package, f.syntax = "telemetry.proto", "m3test", "proto3"
    FD = descriptor_pb2.FieldDescriptorProto
    inner = f.message_type.add()
    inner.name = "Position"
    for i, name in enumerate(("latitude", "longitude"), 1):
        fd = inner.field.add()
        fd.name, fd.number, fd.type, fd.label = name, i, FD.TYPE_DOUBLE, FD.LABEL_OPTIONAL
    outer = f.message_type.add()
    outer.name = "VehicleUpdate"
    for i, (name, t, tn) in enumerate([
            ("fuel_percent", FD.TYPE_DOUBLE, None), ("odometer", FD.TYPE_INT64, None),
            ("status", FD.TYPE_STRING, None), ("moving", FD.TYPE_BOOL, None),
            ("position", FD.TYPE_MESSAGE, ".m3test.Position")], 1):
        fd = outer.field.add()
        fd.name, fd.number, fd.type, fd.label = name, i, t, FD.LABEL_OPTIONAL
        if tn:
            fd.type_name = tn
    pool = descriptor_pool.DescriptorPool()
    pool.Add(f)
    fds = descriptor_pb2.FileDescriptorSet()
    fds.file.add().CopyFrom(f)
    return pool, fds.SerializeToString()


def _fancy_pool():
    """Repeated, map, real oneof, proto3 optional and a message-valued
    map in one message."""
    from google.protobuf import descriptor_pb2, descriptor_pool

    FD = descriptor_pb2.FieldDescriptorProto
    f = descriptor_pb2.FileDescriptorProto()
    f.name, f.package, f.syntax = "fancy.proto", "m3fancy", "proto3"
    sub = f.message_type.add()
    sub.name = "Sub"
    sf = sub.field.add()
    sf.name, sf.number, sf.type, sf.label = "x", 1, FD.TYPE_INT64, FD.LABEL_OPTIONAL
    m = f.message_type.add()
    m.name = "Fancy"
    fd = m.field.add()
    fd.name, fd.number, fd.type, fd.label = "xs", 1, FD.TYPE_INT64, FD.LABEL_REPEATED
    for ename, vtype, vname in (("CountsEntry", FD.TYPE_INT64, None),
                                ("SubsEntry", FD.TYPE_MESSAGE, ".m3fancy.Sub")):
        entry = m.nested_type.add()
        entry.name = ename
        entry.options.map_entry = True
        k = entry.field.add()
        k.name, k.number, k.type, k.label = "key", 1, FD.TYPE_STRING, FD.LABEL_OPTIONAL
        v = entry.field.add()
        v.name, v.number, v.type, v.label = "value", 2, vtype, FD.LABEL_OPTIONAL
        if vname:
            v.type_name = vname
    for num, name, ename in ((2, "counts", "CountsEntry"), (3, "subs", "SubsEntry")):
        fd = m.field.add()
        fd.name, fd.number, fd.type, fd.label = name, num, FD.TYPE_MESSAGE, FD.LABEL_REPEATED
        fd.type_name = f".m3fancy.Fancy.{ename}"
    oo = m.oneof_decl.add()
    oo.name = "choice"
    for i, (nm, t) in enumerate((("a", FD.TYPE_INT64), ("b", FD.TYPE_STRING)), 4):
        fdo = m.field.add()
        fdo.name, fdo.number, fdo.type, fdo.label = nm, i, t, FD.LABEL_OPTIONAL
        fdo.oneof_index = 0
    fd = m.field.add()
    fd.name, fd.number, fd.type, fd.label = "maybe", 6, FD.TYPE_INT64, FD.LABEL_OPTIONAL
    fd.proto3_optional = True
    m.oneof_decl.add().name = "_maybe"
    fd.oneof_index = 1
    fd = m.field.add()
    fd.name, fd.number, fd.type, fd.label = "sub", 7, FD.TYPE_MESSAGE, FD.LABEL_OPTIONAL
    fd.type_name = ".m3fancy.Sub"
    pool = descriptor_pool.DescriptorPool()
    pool.Add(f)
    return pool


def _kinds(schema):
    return tuple((n, k.name) for n, k in schema.fields)


def test_schema_from_descriptor_matches():
    pool, _ = _build_pool()
    for name, p in (("m3test.VehicleUpdate", pool), ("m3fancy.Fancy", _fancy_pool())):
        desc = p.FindMessageTypeByName(name)
        assert _kinds(tps.schema_from_descriptor(desc)) == _kinds(jps.schema_from_descriptor(desc))
    desc = pool.FindMessageTypeByName("m3test.VehicleUpdate")
    assert _kinds(tps.schema_from_descriptor(desc)) == (
        ("fuel_percent", "FLOAT"), ("odometer", "INT"), ("status", "BYTES"),
        ("moving", "BOOL"), ("position.latitude", "FLOAT"), ("position.longitude", "FLOAT"))


def test_fancy_columns_match_and_round_trip():
    desc = _fancy_pool().FindMessageTypeByName("m3fancy.Fancy")
    cls = tps.message_class_for(desc)
    assert cls is jps.message_class_for(desc)
    msg = cls()
    msg.xs.extend([5, -2, 7])
    msg.counts["db"] = 9
    msg.counts["api"] = 3
    msg.subs["a"].x = 7
    msg.subs["b"].x = -3
    msg.b = "branch-b"
    msg.maybe = 0
    msg.sub.x = 11
    cols = tps.message_to_columns(msg)
    assert cols == jps.message_to_columns(msg)
    back = tps.columns_to_message(cls(), cols)
    assert back == msg and back.HasField("maybe") and back.WhichOneof("choice") == "b"
    assert back == jps.columns_to_message(cls(), cols)
    empty = tps.columns_to_message(cls(), tps.message_to_columns(cls()))
    assert empty.WhichOneof("choice") is None and not empty.HasField("maybe")
    # the columns through both codecs: the same stream
    ts, js = tps.schema_from_descriptor(desc), jps.schema_from_descriptor(desc)
    rows = [(START + k * 10**9, cols) for k in range(3)]
    assert tpc.encode_proto_series(ts, rows, START) == jpc.encode_proto_series(js, rows, START)


def test_real_messages_through_both_codecs():
    pool, _ = _build_pool()
    desc = pool.FindMessageTypeByName("m3test.VehicleUpdate")
    cls = tps.message_class_for(desc)
    ts, js = tps.schema_from_descriptor(desc), jps.schema_from_descriptor(desc)
    msgs = []
    for k in range(40):
        m = cls()
        m.fuel_percent = 75.0 - k * 0.25
        m.odometer = 100_000 + k * 7
        m.status = "cruising" if k % 5 else "stopped"
        m.moving = bool(k % 5)
        m.position.latitude = 47.6 + k * 1e-4
        m.position.longitude = -122.3 - k * 1e-4
        msgs.append(m)
    te, je = tpc.ProtoEncoder(ts, START), jpc.ProtoEncoder(js, START)
    for k, m in enumerate(msgs):
        te.encode(START + (k + 1) * 10**9, tps.message_to_columns(m))
        je.encode(START + (k + 1) * 10**9, jps.message_to_columns(m))
    assert te.stream() == je.stream()
    out = list(tpc.ProtoDecoder(ts, je.stream()))
    for k, (t, cols) in enumerate(out):
        assert t == START + (k + 1) * 10**9
        assert tps.columns_to_message(cls(), cols) == msgs[k]


def test_unsupported_field_errors_match():
    from google.protobuf import descriptor_pb2, descriptor_pool

    FD = descriptor_pb2.FieldDescriptorProto
    f = descriptor_pb2.FileDescriptorProto()
    f.name, f.package, f.syntax = "grp.proto", "m3grp", "proto2"
    m = f.message_type.add()
    m.name = "G"
    g = m.nested_type.add()
    g.name = "Inner"
    fd = m.field.add()
    fd.name, fd.number, fd.type, fd.label = "inner", 1, FD.TYPE_GROUP, FD.LABEL_OPTIONAL
    fd.type_name = ".m3grp.G.Inner"
    pool = descriptor_pool.DescriptorPool()
    pool.Add(f)
    desc = pool.FindMessageTypeByName("m3grp.G")
    for mod in (jps, tps):
        assert issubclass(mod.UnsupportedFieldError, ValueError)
    field = desc.fields_by_name["inner"]
    j = _outcome(lambda: jps._kind_for(field))
    t = _outcome(lambda: tps._kind_for(field))
    assert j == t and j[0] == "UnsupportedFieldError"


def test_nesting_too_deep_errors_match():
    from google.protobuf import descriptor_pb2, descriptor_pool

    FD = descriptor_pb2.FieldDescriptorProto
    f = descriptor_pb2.FileDescriptorProto()
    f.name, f.package, f.syntax = "deep.proto", "m3deep", "proto3"
    m = f.message_type.add()
    m.name = "Node"
    fd = m.field.add()
    fd.name, fd.number, fd.type, fd.label = "child", 1, FD.TYPE_MESSAGE, FD.LABEL_OPTIONAL
    fd.type_name = ".m3deep.Node"
    pool = descriptor_pool.DescriptorPool()
    pool.Add(f)
    desc = pool.FindMessageTypeByName("m3deep.Node")
    j = _outcome(lambda: jps.schema_from_descriptor(desc))
    t = _outcome(lambda: tps.schema_from_descriptor(desc))
    assert j == t == ("UnsupportedFieldError", "message nesting too deep")


def test_schema_annotation_bytes_match_and_rebuild():
    pool, fds = _build_pool()
    ann = tps.pack_schema_annotation(fds, "m3test.VehicleUpdate")
    assert ann == jps.pack_schema_annotation(fds, "m3test.VehicleUpdate")
    assert ann.startswith(b"m3ps")
    assert tps.unpack_schema_annotation(ann) == jps.unpack_schema_annotation(ann) == (
        fds, "m3test.VehicleUpdate")
    for raw in (b"not a schema", b"", b"m3p"):
        assert tps.unpack_schema_annotation(raw) is None
    assert _outcome(lambda: tps.descriptor_from_annotation(b"xx")) == \
        _outcome(lambda: jps.descriptor_from_annotation(b"xx")) == \
        ("ValueError", "not a schema annotation")
    desc = tps.descriptor_from_annotation(ann)
    assert desc.full_name == "m3test.VehicleUpdate"
    assert _kinds(tps.schema_from_descriptor(desc))[0] == ("fuel_percent", "FLOAT")


def test_annotation_rides_the_port_batched_encoder():
    """The schema annotation on every series' first datapoint through the
    port's ``encode_batch`` (kernel #1's plain version here): the streams
    equal the JAX package's ``encode_batch`` with the same annotations,
    and the scalar decoder gives back the annotation and the points."""
    from m3_tpu.encoding.m3tsz import decode_series as jdecode
    from m3_tpu.encoding.m3tsz_jax import encode_batch as jencode
    from m3_tpu_torch.encoding.m3tsz import decode_series
    from m3_tpu_torch.encoding.m3tsz_torch import encode_batch

    _, fds = _build_pool()
    ann = tps.pack_schema_annotation(fds, "m3test.VehicleUpdate")
    S, T = 5, 10
    rng = np.random.default_rng(15)
    ts = (START + np.cumsum(rng.integers(1, 20, (S, T)), axis=1) * 10**9).astype(np.int64)
    vals = np.round(rng.normal(0, 50, (S, T)), 1)
    anns = [ann, None, b"m3ps\x00\x00", ann, b"x" * 300]
    starts = np.full(S, START, np.int64)
    t_streams, t_fb = encode_batch(ts, vals, starts, out_words=120, annotations=anns,
                                   device="cpu")
    j_streams, j_fb = jencode(ts, vals, starts, out_words=120, annotations=anns)
    assert not t_fb.any() and np.array_equal(t_fb, np.asarray(j_fb))
    assert t_streams == list(j_streams)
    for i in range(S):
        pts = decode_series(t_streams[i])
        assert pts[0].annotation == (anns[i] or b"")
        assert [p.timestamp for p in pts] == ts[i].tolist()
        assert [p.value for p in pts] == vals[i].tolist()
        assert [(p.timestamp, p.value, p.annotation) for p in jdecode(t_streams[i])] == \
            [(p.timestamp, p.value, p.annotation) for p in pts]
    assert tps.descriptor_from_annotation(
        decode_series(t_streams[0])[0].annotation).full_name == "m3test.VehicleUpdate"


def test_chip_smoke_descriptor_is_the_test_descriptor():
    """``chip_smoke.py`` phase 24 (d) packs fixed descriptor bytes (the
    card's machine has no protobuf): they are this file's descriptor set."""
    src = (ROOT / "chip_smoke.py").read_text()
    m = re.search(r'PROTO_FDS = base64\.b64decode\(\n((?:\s+"[A-Za-z0-9+/=]+"\n?)+)\s*\)', src)
    assert m, "PROTO_FDS not found"
    import base64

    raw = base64.b64decode("".join(re.findall(r'"([A-Za-z0-9+/=]+)"', m.group(1))))
    assert raw == _build_pool()[1]
    assert 'PROTO_MESSAGE = "m3test.VehicleUpdate"' in src


def test_proto_schema_needs_no_protobuf_to_import_and_pack():
    code = (
        "import sys\n"
        "sys.modules['google'] = None\n"
        "sys.modules['google.protobuf'] = None\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from m3_tpu_torch.encoding import proto_schema as ps\n"
        "a = ps.pack_schema_annotation(b'\\x01\\x02', 'pkg.M')\n"
        "assert ps.unpack_schema_annotation(a) == (b'\\x01\\x02', 'pkg.M')\n"
        "try:\n"
        "    ps.descriptor_from_annotation(a)\n"
        "except ImportError:\n"
        "    print('NO-PROTOBUF')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert "NO-PROTOBUF" in r.stdout
