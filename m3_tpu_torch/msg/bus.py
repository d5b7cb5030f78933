"""Message bus: at-least-once, partitioned, acked delivery.

The port's copy of ``m3_tpu/msg/bus.py``, over the port's ``cluster/kv.py``.

Reference parity: `src/msg` — a producer publishes ref-counted messages to
every consumer service subscribed to a topic (`msg/README.md:5-16`), each
consumer service consuming either **shared** (any instance takes a
message) or **replicated** (every instance gets every message)
(`topic/consumption_type.go:31-36`); per-shard message writers keep
ack/retry queues and redeliver unacked messages; topics live in KV.

The reference frames protobuf over TCP; deployment here is in-process /
single-host, so "connections" are queues, but the delivery semantics
(acks, retries, ref-counting across services, shard routing) are the
contract the aggregator→coordinator path runs on, and a socket transport
can wrap `Consumer.poll`/`ack` without changing producers.
"""

from __future__ import annotations

import enum
import itertools
import json
from collections import deque
from dataclasses import dataclass, field

from m3_tpu_torch.cluster.kv import KVStore


class ConsumptionType(enum.Enum):
    SHARED = "shared"
    REPLICATED = "replicated"


@dataclass(frozen=True)
class ConsumerService:
    name: str
    consumption: ConsumptionType = ConsumptionType.SHARED


@dataclass
class Topic:
    """reference src/msg/topic: name + shards + consumer services,
    versioned in KV."""

    name: str
    num_shards: int
    consumer_services: tuple = ()

    def to_json(self) -> bytes:
        return json.dumps({
            "name": self.name,
            "num_shards": self.num_shards,
            "consumer_services": [
                [c.name, c.consumption.value] for c in self.consumer_services
            ],
        }).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "Topic":
        d = json.loads(raw)
        return cls(
            d["name"], d["num_shards"],
            tuple(ConsumerService(n, ConsumptionType(c))
                  for n, c in d["consumer_services"]),
        )


class TopicService:
    def __init__(self, kv: KVStore):
        self.kv = kv

    def set(self, t: Topic) -> None:
        self.kv.set(f"_topic/{t.name}", t.to_json())

    def get(self, name: str) -> Topic | None:
        v = self.kv.get(f"_topic/{name}")
        return Topic.from_json(v.data) if v else None


@dataclass
class Message:
    id: int
    shard: int
    payload: bytes
    enqueued_at: float = 0.0
    retries: int = 0


class Consumer:
    """One consumer instance of a consumer service."""

    def __init__(self, service: str, instance_id: str, bus: "MessageBus"):
        self.service = service
        self.instance_id = instance_id
        self._bus = bus

    def poll(self, max_messages: int = 128) -> list[Message]:
        return self._bus._poll(self.service, self.instance_id, max_messages)

    def ack(self, msg: Message) -> None:
        self._bus._ack(self.service, msg.id)


class MessageBus:
    """Producer + per-consumer-service ack/retry queues (reference
    msg/producer/writer: consumer-service writers → shard writers →
    message writers with ack/retry)."""

    def __init__(self, topic: Topic, retry_after_s: float = 5.0):
        self.topic = topic
        self.retry_after_s = retry_after_s
        self._next_id = itertools.count(1)
        # service -> pending deque of Message (shared) — delivered but
        # unacked live in inflight until acked or retried.
        self._pending: dict[str, deque] = {
            c.name: deque() for c in topic.consumer_services
        }
        self._inflight: dict[str, dict[int, Message]] = {
            c.name: {} for c in topic.consumer_services
        }
        self._consumers: dict[str, list[str]] = {
            c.name: [] for c in topic.consumer_services
        }
        # replicated delivery cursors: (service, instance) -> deque
        self._replicated: dict[tuple, deque] = {}
        self._ctypes = {c.name: c.consumption for c in topic.consumer_services}
        self.acked = 0
        self.published = 0

    # -- membership --------------------------------------------------------

    def register(self, service: str, instance_id: str) -> Consumer:
        self._consumers[service].append(instance_id)
        if self._ctypes[service] == ConsumptionType.REPLICATED:
            self._replicated[(service, instance_id)] = deque()
        return Consumer(service, instance_id, self)

    # -- produce -----------------------------------------------------------

    def publish(self, shard: int, payload: bytes, now_s: float = 0.0) -> int:
        """Fan out to every consumer service (the reference ref-counts
        one buffer across services; queues share the payload object)."""
        mid = next(self._next_id)
        self.published += 1
        for c in self.topic.consumer_services:
            m = Message(mid, shard, payload, now_s)
            if c.consumption == ConsumptionType.SHARED:
                self._pending[c.name].append(m)
            else:
                for inst in self._consumers[c.name]:
                    self._replicated[(c.name, inst)].append(
                        Message(mid, shard, payload, now_s)
                    )
        return mid

    # -- consume (bus-internal, via Consumer) ------------------------------

    def _poll(self, service: str, instance_id: str, max_messages: int):
        ctype = self._ctypes[service]
        out = []
        if ctype == ConsumptionType.SHARED:
            q = self._pending[service]
            while q and len(out) < max_messages:
                m = q.popleft()
                self._inflight[service][m.id] = m
                out.append(m)
        else:
            q = self._replicated[(service, instance_id)]
            while q and len(out) < max_messages:
                out.append(q.popleft())
        return out

    def _ack(self, service: str, mid: int) -> None:
        if self._inflight[service].pop(mid, None) is not None:
            self.acked += 1
            return
        # The message may have been requeued by the retry sweep while the
        # ack was in flight — an ack by id still settles it (the
        # reference acks by message metadata, clearing retry queues too).
        q = self._pending[service]
        for m in q:
            if m.id == mid:
                q.remove(m)
                self.acked += 1
                return

    # -- retry loop --------------------------------------------------------

    def process_retries(self, now_s: float) -> int:
        """Requeue unacked shared messages past the retry deadline
        (reference message writer retry queues)."""
        requeued = 0
        for service, inflight in self._inflight.items():
            expired = [
                m for m in inflight.values()
                if now_s - m.enqueued_at >= self.retry_after_s
            ]
            for m in expired:
                del inflight[m.id]
                m.retries += 1
                m.enqueued_at = now_s
                self._pending[service].append(m)
                requeued += 1
        return requeued

    def unacked(self, service: str) -> int:
        return len(self._inflight[service]) + len(self._pending[service])
