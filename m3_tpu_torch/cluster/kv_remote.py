"""External coordination binding: the KV control plane as a service.
The port's counterpart of ``m3_tpu/cluster/kv_remote.py``, frame for
frame, over the port's ``cluster/kv.py`` and ``msg/protocol.py``.

Equivalent of the reference's etcd layer (`src/cluster/kv` over
`src/cluster/client/etcd/client.go`): placements, namespaces, topics,
rules and elections live in a store that SURVIVES the nodes — every
node process dials it instead of owning a file-backed copy.  etcd
itself collapses to the framework's own framed-TCP service around the
existing ``KVStore`` (versioned values, CAS, watches):

* ``KVServer`` — hosts one authoritative ``KVStore`` (file-backed for
  durability) behind the msg/protocol framing.
* ``RemoteKVStore`` — implements the exact ``KVStore`` method surface
  (get/set/set_if_not_exists/check_and_set/delete/keys/watch) over a
  connection, so ``PlacementService``, ``NamespaceRegistry``,
  ``TopicService``, ``RuntimeOptionsManager`` and ``LeaderElection``
  work unchanged against the remote plane — CAS conflicts raise the
  same ValueError/KeyError the local store raises.
* watches poll on a short interval over a dedicated connection (the
  reference's etcd watch channels; polling keeps the protocol
  request/response only).

Cross-process leader election follows for free: ``LeaderElection``'s
TTL-lease CAS runs against the shared remote store, so aggregator
leader/follower pairs in different processes elect exactly one emitter.
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
from typing import Callable, Tuple

from m3_tpu_torch.cluster.kv import KVStore, VersionedValue
from m3_tpu_torch.msg.protocol import (
    ProtocolError, connect as wire_connect, recv_frame, send_frame,
)
from m3_tpu_torch.x import fault
from m3_tpu_torch.x.retry import Retrier, RetryOptions

KV_REQ = 24
KV_OK = 25
KV_ERR = 26

M_GET = 1
M_SET = 2
M_SET_NX = 3
M_CAS = 4
M_DELETE = 5
M_KEYS = 6


def _pack(b: bytes) -> bytes:
    return struct.pack("<I", len(b)) + b


def _unpack(raw: bytes, pos: int):
    (n,) = struct.unpack_from("<I", raw, pos)
    return raw[pos + 4 : pos + 4 + n], pos + 4 + n


class _KVHandler(socketserver.BaseRequestHandler):
    def handle(self):
        srv: KVServer = self.server
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        while True:
            try:
                frame = recv_frame(sock)
            except (ProtocolError, OSError):
                return
            if frame is None or frame[0] != KV_REQ:
                return
            payload = frame[1]
            try:
                if not payload:
                    raise ProtocolError("empty kv request")
                resp = self._dispatch(srv.store, payload[0], payload[1:])
                send_frame(sock, KV_OK, resp)
            except Exception as e:  # typed error frame, conn survives
                try:
                    send_frame(
                        sock, KV_ERR,
                        f"{type(e).__name__}\x00{e}".encode()[:4096])
                except OSError:
                    return

    def _dispatch(self, store: KVStore, method: int, raw: bytes) -> bytes:
        if method == M_GET:
            key, _ = _unpack(raw, 0)
            v = store.get(key.decode())
            if v is None:
                return b"\x00"
            return b"\x01" + struct.pack("<q", v.version) + v.data
        if method == M_SET:
            key, pos = _unpack(raw, 0)
            data, _ = _unpack(raw, pos)
            return struct.pack("<q", store.set(key.decode(), data))
        if method == M_SET_NX:
            key, pos = _unpack(raw, 0)
            data, _ = _unpack(raw, pos)
            return struct.pack("<q", store.set_if_not_exists(key.decode(), data))
        if method == M_CAS:
            key, pos = _unpack(raw, 0)
            (expect,) = struct.unpack_from("<q", raw, pos)
            data, _ = _unpack(raw, pos + 8)
            return struct.pack(
                "<q", store.check_and_set(key.decode(), expect, data))
        if method == M_DELETE:
            key, _ = _unpack(raw, 0)
            return b"\x01" if store.delete(key.decode()) else b"\x00"
        if method == M_KEYS:
            keys = store.keys()
            return struct.pack("<I", len(keys)) + b"".join(
                _pack(k.encode()) for k in keys)
        raise ProtocolError(f"unknown kv method {method}")


class KVServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, store: KVStore | None = None, root: str | None = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.store = store if store is not None else KVStore(root)
        super().__init__((host, port), _KVHandler)

    @property
    def port(self) -> int:
        return self.server_address[1]


def serve_kv_background(root: str | None = None, host: str = "127.0.0.1",
                        port: int = 0, store: KVStore | None = None) -> KVServer:
    srv = KVServer(store=store, root=root, host=host, port=port)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


class RemoteKVStore:
    """KVStore-shaped client over one connection (+ one watch poller).

    Errors raised by the authoritative store come back typed: CAS
    conflicts re-raise as ValueError, set_if_not_exists duplicates as
    KeyError — identical to the local store so callers (elections,
    placement CAS loops) are transport-agnostic."""

    _RERAISE = {"ValueError": ValueError, "KeyError": KeyError}

    def __init__(self, address: Tuple[str, int], timeout_s: float = 30.0,
                 watch_poll_s: float = 2.0,
                 retry_options: RetryOptions | None = None):
        # watch_poll_s: control-plane objects change rarely; every
        # watched key costs one round-trip per tick, so the default
        # favors low idle load (tests pass a small value).
        self.address = tuple(address)
        self.timeout_s = timeout_s
        # Every control-plane call retries transport failures (x/retry
        # adoption): a flapping KV server heals inside one call instead
        # of surfacing ConnectionError to every placement/election
        # caller.  Application errors (CAS ValueError etc.) never retry.
        self.retrier = Retrier(
            retry_options or RetryOptions(
                initial_backoff_s=0.05, max_backoff_s=2.0, max_attempts=4),
            name="kv_remote",
            # Interruptible backoff: close() wakes every sleeper.
            sleep=lambda s: self._closed.wait(s),
        )
        self._sock: socket.socket | None = None
        self._mu = threading.Lock()       # connection
        self._wmu = threading.Lock()      # watcher registry
        self._watch_poll_s = watch_poll_s
        self._watchers: dict[str, list[Callable]] = {}
        self._watch_seen: dict[str, int] = {}
        # Watchers owed a re-delivery: registration raced the poll loop,
        # the reconciling re-read failed, and the watcher was fired with
        # a value older than _watch_seen — the poll loop re-delivers the
        # current value to these on its next tick even when the version
        # has not advanced past seen.
        self._watch_pending: dict[str, set] = {}
        self._watch_thread: threading.Thread | None = None
        self._closed = threading.Event()

    def _call(self, method: int, body: bytes) -> bytes:
        # abort: a deliberately closed client must not wait out the
        # backoff schedule against a server that is gone on purpose.
        return self.retrier.run(
            lambda: self._call_once(method, body),
            abort=self._closed.is_set)

    def _drop_sock(self) -> None:
        # Caller holds self._mu (rpc.py's RemoteDatabase._drop shape).
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None  # m3lint: disable=lock-discipline

    def _call_once(self, method: int, body: bytes) -> bytes:
        if self._closed.is_set():
            raise ConnectionError(f"kv {self.address}: store closed")
        with self._mu:
            try:
                # Socket-boundary faultpoint: drop (request lost on the
                # wire) and error both surface as the transport failure
                # the retrier exists for; delay models a slow peer.
                if fault.fire("kv_remote.call") == "drop":
                    raise fault.FaultInjected(
                        "kv_remote.call: request dropped")
                if self._sock is None:
                    self._sock = wire_connect(
                        self.address, timeout=self.timeout_s)
                send_frame(self._sock, KV_REQ, bytes([method]) + body)
                frame = recv_frame(self._sock)
            except (OSError, ProtocolError) as e:
                self._drop_sock()
                raise ConnectionError(f"kv {self.address}: {e}") from e
        if frame is None:
            raise ConnectionError(f"kv {self.address}: closed")
        ftype, payload = frame
        if ftype == KV_ERR:
            tname, _, msg = payload.decode(errors="replace").partition("\x00")
            raise self._RERAISE.get(tname, RuntimeError)(msg)
        if ftype != KV_OK:
            # Protocol confusion: the reply stream is desynced — drop
            # the connection rather than treating an arbitrary frame as
            # a success payload (m3lint wire-exhaustive).
            with self._mu:
                self._drop_sock()
            raise ConnectionError(f"kv {self.address}: bad frame {ftype}")
        return payload

    # -- KVStore surface --

    @staticmethod
    def _parse_get(raw: bytes) -> VersionedValue | None:
        if raw[0] == 0:
            return None
        (version,) = struct.unpack_from("<q", raw, 1)
        return VersionedValue(version, raw[9:])

    def get(self, key: str) -> VersionedValue | None:
        return self._parse_get(self._call(M_GET, _pack(key.encode())))

    def _get_once(self, key: str) -> VersionedValue | None:
        """Single-attempt get for the watch poll loop: the loop has its
        OWN backoff-between-rounds schedule, so running the full
        in-call retry ladder per key would multiply a dead server's
        stall time by max_attempts for every watched key."""
        return self._parse_get(self._call_once(M_GET, _pack(key.encode())))

    def set(self, key: str, data: bytes) -> int:
        raw = self._call(M_SET, _pack(key.encode()) + _pack(data))
        return struct.unpack("<q", raw)[0]

    def set_if_not_exists(self, key: str, data: bytes) -> int:
        raw = self._call(M_SET_NX, _pack(key.encode()) + _pack(data))
        return struct.unpack("<q", raw)[0]

    def check_and_set(self, key: str, expect_version: int, data: bytes) -> int:
        raw = self._call(
            M_CAS,
            _pack(key.encode()) + struct.pack("<q", expect_version) + _pack(data),
        )
        return struct.unpack("<q", raw)[0]

    def delete(self, key: str) -> bool:
        return self._call(M_DELETE, _pack(key.encode())) == b"\x01"

    def keys(self) -> list:
        raw = self._call(M_KEYS, b"")
        (n,) = struct.unpack_from("<I", raw, 0)
        pos = 4
        out = []
        for _ in range(n):
            k, pos = _unpack(raw, pos)
            out.append(k.decode())
        return out

    def watch(self, key: str, fn: Callable[[VersionedValue], None]) -> None:
        """Fire on every observed version change (etcd watch channel
        role, implemented as a version poll).

        ``_watch_seen`` updates and the initial-fire decision happen
        under ``_wmu`` so registration and the poll loop agree on the
        last-seen version: without it a poll tick racing a registration
        could double-fire or swallow one version change.  Callbacks fire
        outside the lock (they may re-enter the store)."""
        cur = self.get(key)
        with self._wmu:
            self._watchers.setdefault(key, []).append(fn)
            start = self._watch_thread is None
            if start:
                self._watch_thread = threading.Thread(
                    target=self._watch_loop, daemon=True)
            fire = self._decide_locked(key, fn, cur)
        if fire is None:
            # Pre-lock read lost a race with the poll loop (cur older
            # than what it delivered).  Re-read OUTSIDE the lock —
            # network I/O under _wmu would stall every watcher — then
            # reconcile; if the re-read fails too, deliver what we have
            # rather than nothing.
            try:
                cur = self.get(key) or cur
            except (ConnectionError, RuntimeError):
                pass
            with self._wmu:
                fire = self._decide_locked(key, fn, cur)
                if fire is None:
                    # Still stale after the re-read (or the re-read
                    # failed): mark this watcher pending so the next
                    # poll tick delivers the current value instead of
                    # waiting for the key to change again.  Do NOT fire
                    # the stale value here — an unlocked stale fire can
                    # race the poll tick's re-delivery and land AFTER
                    # it, regressing the watcher's view until the next
                    # version change.
                    self._watch_pending.setdefault(key, set()).add(fn)
                    fire = []
        for f in fire:
            self._fire(f, cur)
        if start:
            self._watch_thread.start()

    def _decide_locked(self, key, fn, cur):
        """Under _wmu: advance _watch_seen for ``cur`` and return the
        callbacks to fire.  When ``cur`` moved past the loop's last
        delivery — including the key-creation case where watchers
        registered while the key was absent — EVERY watcher fires, or
        the poll loop (which compares against the now-advanced seen)
        would swallow that change for the others.  Returns None when
        ``cur`` is older than seen: the caller re-reads outside the
        lock (versions are monotonic per key)."""
        if cur is None:
            return []
        seen = self._watch_seen.get(key)
        if seen is None or cur.version > seen:
            self._watch_seen[key] = cur.version
            # Every watcher (including any parked pending) receives
            # this delivery — clear the owed re-deliveries or the next
            # poll tick would double-fire them with the same version.
            self._watch_pending.pop(key, None)
            return list(self._watchers[key])
        if cur.version == seen:
            pend = self._watch_pending.get(key)
            if pend is not None:
                pend.discard(fn)
                if not pend:
                    del self._watch_pending[key]
            return [fn]  # initial fire for the new watcher only
        return None

    @staticmethod
    def _fire(fn, cur) -> None:
        """Deliver one watch callback; a raising callback must never
        kill the shared poll thread or starve its sibling watchers."""
        try:
            fn(cur)
        except Exception:  # noqa: BLE001 — isolate watcher faults
            import logging

            logging.getLogger("m3_tpu_torch.cluster.kv_remote").exception(
                "kv watch callback raised")

    def _watch_loop(self) -> None:
        # Reconnect loop with backoff: a dead KV server must not be
        # hammered at the poll cadence forever — consecutive failed
        # rounds stretch the wait along the retrier's schedule (capped
        # at its max backoff), and one healthy round snaps it back.
        failed_rounds = 0
        while True:
            wait_s = self._watch_poll_s
            if failed_rounds:
                wait_s = max(wait_s, self.retrier.backoff_for(failed_rounds))
            if self._closed.wait(wait_s):
                return
            round_failed = False
            with self._wmu:
                keys = list(self._watchers)
            for key in keys:
                try:
                    cur = self._get_once(key)
                except (ConnectionError, RuntimeError):
                    round_failed = True
                    continue
                if cur is None:
                    continue
                with self._wmu:
                    changed = cur.version != self._watch_seen.get(key)
                    if changed:
                        self._watch_seen[key] = cur.version
                        fns = list(self._watchers.get(key, ()))
                        # A full delivery covers any owed re-delivery.
                        self._watch_pending.pop(key, None)
                    else:
                        pend = self._watch_pending.pop(key, None)
                        live = self._watchers.get(key, ())
                        fns = [f for f in pend if f in live] if pend else []
                for fn in fns:
                    self._fire(fn, cur)
            failed_rounds = failed_rounds + 1 if round_failed else 0

    def close(self) -> None:
        self._closed.set()
        with self._mu:
            self._drop_sock()
