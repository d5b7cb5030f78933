"""The port's message bus (``m3_tpu_torch/msg/bus.py``) and its socket
transport (``msg/transport.py``) against the JAX package's.

The bus is driven through the same publish / poll / ack / retry
sequence in both packages and compared after every step: what each
consumer receives (ids, shards, payloads, retry counts), the unacked
counts and the acked and published totals.  Topics stored in a KV read
back in the other package.  Over sockets, every pairing of the two
packages' producer, server and consumer delivers, acks and redelivers
alike — the wire is one protocol.
"""

import time

import pytest

import m3_tpu.cluster.kv as jkv
import m3_tpu.msg.bus as jbus
import m3_tpu.msg.transport as jtr
import m3_tpu_torch.cluster.kv as tkv
import m3_tpu_torch.msg.bus as tbus
import m3_tpu_torch.msg.transport as ttr

PKGS = {"jax": (jbus, jkv, jtr), "port": (tbus, tkv, ttr)}


def topic(B, name="aggregated_metrics"):
    return B.Topic(name, 4, (
        B.ConsumerService("coordinator", B.ConsumptionType.SHARED),
        B.ConsumerService("mirror", B.ConsumptionType.REPLICATED),
    ))


def msgs(ms):
    return [(m.id, m.shard, m.payload, m.retries, m.enqueued_at) for m in ms]


def drive(B):
    """One scripted sequence over the in-process bus; returns every
    observation in order."""
    bus = B.MessageBus(topic(B), retry_after_s=5.0)
    c1, c2 = bus.register("coordinator", "c1"), bus.register("coordinator", "c2")
    r1, r2 = bus.register("mirror", "r1"), bus.register("mirror", "r2")
    seen = []
    for i in range(10):
        seen.append(bus.publish(i % 4, b"m%d" % i, now_s=float(i)))
    g1, g2 = c1.poll(6), c2.poll(100)
    seen += [msgs(g1), msgs(g2), msgs(r1.poll(3)), msgs(r2.poll(100)), msgs(r1.poll(100))]
    for m in g1[:4]:
        c1.ack(m)
    seen.append((bus.unacked("coordinator"), bus.acked, bus.published))
    seen.append(bus.process_retries(now_s=6.0))   # m4, m5 (published at 4, 5) not yet due
    seen.append(bus.process_retries(now_s=20.0))  # the rest of the unacked requeue
    again = c2.poll(100)
    seen.append(msgs(again))
    c1.ack(g1[4])  # an ack of a message the sweep requeued still settles it
    c1.ack(g1[4])  # a second ack changes nothing
    seen.append((bus.unacked("coordinator"), bus.acked))
    for m in again:
        c2.ack(m)
    seen.append((bus.unacked("coordinator"), bus.acked, bus.unacked("mirror")))
    bus.publish(1, b"late", now_s=30.0)
    seen.append(msgs(r2.poll(100)))
    return seen


def test_bus_delivery_semantics_match():
    got = {k: drive(B) for k, (B, _, _) in PKGS.items()}
    assert got["port"] == got["jax"]
    assert got["port"][-2] == (0, 10, 0)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_topic_kv_roundtrip_across_packages(writer, reader, tmp_path):
    Bw, KVw, _ = PKGS[writer]
    Br, KVr, _ = PKGS[reader]
    Bw.TopicService(KVw.KVStore(str(tmp_path))).set(topic(Bw))
    t = Br.TopicService(KVr.KVStore(str(tmp_path))).get("aggregated_metrics")
    assert t == topic(Br)
    assert t.to_json() == topic(Bw).to_json()
    assert Br.TopicService(KVr.KVStore(str(tmp_path))).get("absent") is None


def _wait(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


PAIRS = [(p, s, c) for p in PKGS for s in PKGS for c in PKGS]


@pytest.mark.parametrize("prod_pkg,srv_pkg,cons_pkg", PAIRS)
def test_publish_deliver_ack_over_sockets(prod_pkg, srv_pkg, cons_pkg):
    B = PKGS[srv_pkg][0]
    bus = B.MessageBus(B.Topic("agg_out", 4, (
        B.ConsumerService("coordinator", B.ConsumptionType.SHARED),)), retry_after_s=0.2)
    srv = PKGS[srv_pkg][2].serve_bus_background(bus)
    prod = PKGS[prod_pkg][2].RemoteBusProducer(("127.0.0.1", srv.port))
    cons = PKGS[cons_pkg][2].RemoteBusConsumer(("127.0.0.1", srv.port), "coordinator", "c1")
    try:
        for i in range(5):
            prod.publish(i % 4, b"payload-%d" % i + bytes(i * 1000))
        got = {}
        deadline = time.monotonic() + 5
        while len(got) < 5 and time.monotonic() < deadline:
            for mid, shard, payload in cons.poll(timeout_s=0.3):
                got[mid] = (shard, payload)
                cons.ack(mid)
        assert sorted(got.values()) == sorted(
            (i % 4, b"payload-%d" % i + bytes(i * 1000)) for i in range(5))
        assert _wait(lambda: bus.acked == 5)
        assert bus.unacked("coordinator") == 0 and bus.published == 5
    finally:
        prod.close()
        cons.close()
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("srv_pkg,cons_pkg", [("port", "port"), ("port", "jax"),
                                              ("jax", "port")])
def test_unacked_messages_redelivered_over_sockets(srv_pkg, cons_pkg):
    B = PKGS[srv_pkg][0]
    bus = B.MessageBus(B.Topic("agg_out", 4, (
        B.ConsumerService("coordinator", B.ConsumptionType.SHARED),)), retry_after_s=0.15)
    srv = PKGS[srv_pkg][2].serve_bus_background(bus)
    prod = PKGS["port"][2].RemoteBusProducer(("127.0.0.1", srv.port))
    cons = PKGS[cons_pkg][2].RemoteBusConsumer(("127.0.0.1", srv.port), "coordinator", "c1")
    try:
        prod.publish(0, b"m1")
        first = cons.poll(timeout_s=2.0, max_messages=1)
        assert len(first) == 1 and first[0][2] == b"m1"
        again = []
        deadline = time.monotonic() + 5
        while not again and time.monotonic() < deadline:
            again = cons.poll(timeout_s=0.5, max_messages=1)
        assert again and again[0][0] == first[0][0] and again[0][2] == b"m1"
        cons.ack(again[0][0])
        deadline = time.monotonic() + 3
        while bus.unacked("coordinator") > 0 and time.monotonic() < deadline:
            cons.poll(timeout_s=0.1)
        assert bus.unacked("coordinator") == 0 and bus.acked >= 1
    finally:
        prod.close()
        cons.close()
        srv.shutdown()
        srv.server_close()


def test_replicated_service_over_sockets_reaches_every_instance():
    B, _, T = PKGS["port"]
    bus = B.MessageBus(B.Topic("t", 2, (
        B.ConsumerService("mirror", B.ConsumptionType.REPLICATED),)))
    srv = T.serve_bus_background(bus)
    consumers = [T.RemoteBusConsumer(("127.0.0.1", srv.port), "mirror", f"r{k}")
                 for k in range(2)]
    prod = T.RemoteBusProducer(("127.0.0.1", srv.port))
    try:
        assert _wait(lambda: len(bus._consumers["mirror"]) == 2)
        for i in range(4):
            prod.publish(i % 2, b"x%d" % i)
        for c in consumers:
            got = []
            deadline = time.monotonic() + 5
            while len(got) < 4 and time.monotonic() < deadline:
                got += [p for _, _, p in c.poll(timeout_s=0.3)]
            assert got == [b"x%d" % i for i in range(4)]
    finally:
        prod.close()
        for c in consumers:
            c.close()
        srv.shutdown()
        srv.server_close()
