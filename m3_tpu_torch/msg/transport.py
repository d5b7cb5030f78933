"""Socket transport for the message bus: m3msg over TCP.

The port's copy of ``m3_tpu/msg/transport.py``.

Equivalent of the reference's m3msg wire path: producers write
size-prefixed messages to consumer connections and consumers ack them
back on the same connection (`src/msg/protocol/proto/encoder.go:49-52`,
consumer ack flushes `src/msg/consumer/consumer.go`).  The in-process
`MessageBus` (bus.py) keeps the routing/ack/retry semantics; this module
puts real sockets on both edges:

  producer edge   RemoteBusProducer --BUS_PUBLISH--> BusServer.publish
  consumer edge   BusServer --BUS_DELIVER--> RemoteBusConsumer
                  RemoteBusConsumer --BUS_ACK--> BusServer.ack

A consumer connection introduces itself with BUS_HELLO (service,
instance) — the transport analogue of consumer-service registration in
the topic (topic/consumption_type.go).
"""

from __future__ import annotations

import socket
import socketserver
import threading
import time

from m3_tpu_torch.msg import protocol as wire
from m3_tpu_torch.msg.bus import MessageBus


class _BusConnHandler(socketserver.BaseRequestHandler):
    def handle(self):
        srv: BusServer = self.server
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            first = wire.recv_frame(sock)
        except (wire.ProtocolError, OSError):
            return
        if first is None:
            return
        ftype, payload = first
        if ftype == wire.BUS_PUBLISH:
            self._producer_loop(srv, sock, payload)
        elif ftype == wire.BUS_HELLO:
            service, instance = wire.decode_bus_hello(payload)
            self._consumer_loop(srv, sock, service, instance)
        else:
            # Explicit default: a connection
            # may only open with PUBLISH (producer) or HELLO (consumer).
            # BUS_DELIVER/BUS_ACK as a FIRST frame is a confused peer —
            # drop the connection rather than silently ignoring it.
            return

    def _producer_loop(self, srv, sock, first_payload):
        payload = first_payload
        while True:
            shard, body = wire.decode_bus_publish(payload)
            with srv.lock:
                srv.bus.publish(shard, body, now_s=time.monotonic())
            try:
                frame = wire.recv_frame(sock)
            except (wire.ProtocolError, OSError):
                return
            if frame is None or frame[0] != wire.BUS_PUBLISH:
                return
            payload = frame[1]

    def _consumer_loop(self, srv, sock, service: str, instance: str):
        with srv.lock:
            consumer = srv.bus.register(service, instance)
        stop = threading.Event()

        def read_acks():
            while not stop.is_set():
                try:
                    frame = wire.recv_frame(sock)
                except (wire.ProtocolError, OSError):
                    break
                if frame is None:
                    break
                if frame[0] != wire.BUS_ACK:
                    # Explicit default: the
                    # consumer edge only ever sends acks; anything else
                    # is protocol confusion — kill the connection.
                    break
                mid = wire.decode_bus_ack(frame[1])
                with srv.lock:
                    srv.bus._ack(service, mid)
            stop.set()

        t = threading.Thread(target=read_acks, daemon=True)
        t.start()
        try:
            while not stop.is_set():
                with srv.lock:
                    msgs = consumer.poll(max_messages=128)
                if not msgs:
                    time.sleep(srv.poll_interval_s)
                    continue
                for m in msgs:
                    wire.send_frame(
                        sock, wire.BUS_DELIVER,
                        wire.encode_bus_deliver(m.id, m.shard, m.payload),
                    )
        except OSError:
            pass
        finally:
            stop.set()


class BusServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, bus: MessageBus, host: str = "127.0.0.1", port: int = 0,
                 poll_interval_s: float = 0.02):
        self.bus = bus
        self.lock = threading.Lock()
        self.poll_interval_s = poll_interval_s
        super().__init__((host, port), _BusConnHandler)
        # redelivery sweep (reference message-writer retry queues)
        self._retry_stop = threading.Event()

        def sweep():
            while not self._retry_stop.wait(bus.retry_after_s / 2):
                with self.lock:
                    bus.process_retries(time.monotonic())

        threading.Thread(target=sweep, daemon=True).start()

    def shutdown(self):
        self._retry_stop.set()
        super().shutdown()

    @property
    def port(self) -> int:
        return self.server_address[1]


def serve_bus_background(bus: MessageBus, host: str = "127.0.0.1",
                         port: int = 0) -> BusServer:
    srv = BusServer(bus, host, port)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv


class RemoteBusProducer:
    """Producer edge: publish(shard, payload) over one connection."""

    def __init__(self, address):
        self._lock = threading.Lock()
        self._sock = wire.connect(address)

    def publish(self, shard: int, payload: bytes) -> None:
        with self._lock:
            wire.send_frame(
                self._sock, wire.BUS_PUBLISH,
                wire.encode_bus_publish(shard, payload),
            )

    def close(self) -> None:
        self._sock.close()


class RemoteBusConsumer:
    """Consumer edge: hello, then poll deliveries / send acks."""

    def __init__(self, address, service: str, instance_id: str):
        self._lock = threading.Lock()
        self._sock = wire.connect(address)
        try:
            wire.send_frame(
                self._sock, wire.BUS_HELLO,
                wire.encode_bus_hello(service, instance_id),
            )
        except BaseException:
            # a failed HELLO discards the object — close the socket it
            # half-owns
            self._sock.close()
            raise

    def poll(self, timeout_s: float = 1.0, max_messages: int = 128):
        """Blocking read of up to max_messages deliveries within
        timeout_s; returns list of (mid, shard, payload)."""
        out = []
        deadline = time.monotonic() + timeout_s
        self._sock.settimeout(timeout_s)
        while len(out) < max_messages:
            remain = deadline - time.monotonic()
            if remain <= 0:
                break
            self._sock.settimeout(remain)
            try:
                frame = wire.recv_frame(self._sock)
            except (socket.timeout, TimeoutError):
                break
            if frame is None:
                break
            if frame[0] == wire.BUS_DELIVER:
                out.append(wire.decode_bus_deliver(frame[1]))
        return out

    def ack(self, mid: int) -> None:
        with self._lock:
            wire.send_frame(self._sock, wire.BUS_ACK, wire.encode_bus_ack(mid))

    def close(self) -> None:
        self._sock.close()
