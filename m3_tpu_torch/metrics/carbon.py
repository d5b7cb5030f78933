"""Carbon (Graphite) line protocol: parser + tag translation.

Equivalent of `src/metrics/carbon` (line parser `parser.go`) and the
coordinator's carbon ingester path
(`src/cmd/services/m3coordinator/ingest/carbon`), which translates
dotted Graphite paths into indexed tag documents the same way the
Graphite storage adapter does (`src/query/graphite/storage` — path
component i becomes tag `__g{i}__`).

Line form:  <dotted.metric.path> <value> <unix-seconds>\n
Invalid lines are skipped, counted, never fatal (carbon servers are
fed by UDP-ish best-effort pipelines).

The port's copy of ``m3_tpu/metrics/carbon.py``: the same accept and
reject rules, tag convention and listener counters; the sink gets host
numpy arrays.
"""

from __future__ import annotations

import math
import socketserver
import threading
from dataclasses import dataclass

import numpy as np

from m3_tpu_torch.index.doc import Document


@dataclass(frozen=True)
class CarbonSample:
    path: bytes
    value: float
    timestamp_nanos: int


def parse_line(line: bytes, now_nanos: int = 0) -> CarbonSample | None:
    """One line → sample; None if malformed (reference parser.go Parse).
    A timestamp of -1 (carbon's "now") resolves to `now_nanos`."""
    line = line.strip()
    if not line or line.startswith(b"#"):
        return None
    parts = line.split()
    if len(parts) != 3:
        return None
    path, raw_val, raw_ts = parts
    if not path or path.startswith(b".") or path.endswith(b".") or b".." in path:
        return None
    try:
        value = float(raw_val)
        ts = float(raw_ts)
    except ValueError:
        return None
    if math.isnan(value):
        return None
    if ts == -1:
        ts_nanos = now_nanos
    else:
        # Non-finite or out-of-int64-range timestamps must be skipped,
        # not crash the connection handler ("never fatal" contract).
        if not math.isfinite(ts) or not (0 <= ts < 2**63 / 1e9):
            return None
        ts_nanos = int(ts * 1e9)
    return CarbonSample(path, value, ts_nanos)


def parse_lines(data: bytes, now_nanos: int = 0) -> tuple[list[CarbonSample], int]:
    """(samples, malformed_count) from a buffer of newline-separated
    lines."""
    out, bad = [], 0
    for line in data.split(b"\n"):
        if not line.strip():
            continue
        s = parse_line(line, now_nanos)
        if s is None:
            bad += 1
        else:
            out.append(s)
    return out, bad


def path_to_document(path: bytes) -> Document:
    """Dotted path → tag document: component i ⇒ tag `__g{i}__`
    (reference graphite storage `__g0__` convention), so Graphite
    metrics live in the same inverted index as Prometheus ones."""
    tags = {
        b"__g%d__" % i: part for i, part in enumerate(path.split(b"."))
    }
    return Document.from_tags(path, tags)


def document_to_path(doc: Document) -> bytes | None:
    """Inverse translation for the Graphite read path; None if the doc
    is not carbon-shaped."""
    parts = []
    tags = doc.tags()
    for i in range(len(tags)):
        v = tags.get(b"__g%d__" % i)
        if v is None:
            return None
        parts.append(v)
    return b".".join(parts) if parts else None


# -- TCP ingest (plaintext carbon listener) ---------------------------------


MAX_LINE = 1 << 16  # a valid carbon line is tiny; anything bigger is abuse


class _CarbonHandler(socketserver.StreamRequestHandler):
    def handle(self):
        srv = self.server
        buf = b""
        while True:
            chunk = self.request.recv(65536)
            if not chunk:
                break
            buf += chunk
            *lines, buf = buf.split(b"\n")
            self._ingest(b"\n".join(lines))
            if len(buf) > MAX_LINE:
                # a newline-free stream must not grow the buffer without
                # bound — drop the connection (never fatal to the server)
                if srv.scope is not None:
                    srv.scope.counter("oversized_lines").inc()
                return
        if buf.strip():
            self._ingest(buf)

    def _ingest(self, data: bytes) -> None:
        srv = self.server
        samples, bad = parse_lines(data, srv.now_nanos())
        if srv.scope is not None and bad:
            srv.scope.counter("malformed").inc(bad)
        if not samples:
            return
        docs = [path_to_document(s.path) for s in samples]
        ts = np.asarray([s.timestamp_nanos for s in samples], np.int64)
        vals = np.asarray([s.value for s in samples], np.float64)
        srv.sink(docs, ts, vals)
        if srv.scope is not None:
            srv.scope.counter("samples").inc(len(samples))


class CarbonServer(socketserver.ThreadingTCPServer):
    """Plaintext carbon listener (reference coordinator carbon ingester
    server).  sink(docs, ts, vals) is typically
    `lambda d, t, v: db.write_tagged_batch(ns, d, t, v)`."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, sink, host: str = "127.0.0.1", port: int = 0,
                 instrument=None, now_nanos=None):
        import time

        self.sink = sink
        self.scope = instrument.scope("carbon") if instrument is not None else None
        self.now_nanos = now_nanos or time.time_ns
        super().__init__((host, port), _CarbonHandler)

    @property
    def port(self) -> int:
        return self.server_address[1]


def serve_carbon_background(sink, host: str = "127.0.0.1", port: int = 0,
                            instrument=None, now_nanos=None) -> CarbonServer:
    srv = CarbonServer(sink, host, port, instrument, now_nanos)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv
