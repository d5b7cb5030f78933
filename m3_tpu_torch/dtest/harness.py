"""dtest: drive real node processes through destructive scenarios.
The port's counterpart of ``m3_tpu/dtest/harness.py``.

Equivalent of the reference's m3em agent + dtest harness
(`src/m3em/agent` — gRPC process lifecycle: setup/start/stop/heartbeat;
`src/cmd/tools/dtest` — node add/remove/seed scenarios driving it).
The gRPC agent collapses to direct subprocess management on one host —
the scenarios (kill -9 mid-write, restart, verify recovery) are the
point, not the transport.

`NodeProcess` owns one `m3_tpu_torch.server.node_main` subprocess:
spawn, wait-healthy (polls the /health endpoint through the node.json
status file), graceful stop (SIGTERM → drain), hard kill (SIGKILL — the
crash case bootstrap must recover from), restart.  The node runs on the
CUDA card unless ``device`` names another (the CPU tests pass
``"cpu"``); ``drain_timeout_s`` bounds SIGTERM's wait for LEAVING shards
(``node_main --drain-timeout``: the reference's ``M3_DRAIN_TIMEOUT_S``,
which the port does not read).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path


class NodeProcess:
    def __init__(self, config_path: str, root: str, env: dict | None = None,
                 device=None, drain_timeout_s: float = 60.0):
        self.config_path = str(config_path)
        self.root = Path(root)
        # the child inherits this process's environment, plus ``env``;
        # the port's node reads none of it
        self.env = None if env is None else dict(os.environ, **env)
        self.device = None if device is None else str(device)
        self.drain_timeout_s = float(drain_timeout_s)
        self.proc: subprocess.Popen | None = None
        self.port: int | None = None

    @property
    def status_path(self) -> Path:
        return self.root / "node.json"

    # -- lifecycle (m3em operator Setup/Start/Stop/Teardown) --------------

    @property
    def log_path(self) -> Path:
        return self.root / "node.log"

    def argv(self) -> list:
        """The node's command line."""
        argv = [sys.executable, "-m", "m3_tpu_torch.server.node_main",
                self.config_path, "--drain-timeout", repr(self.drain_timeout_s)]
        if self.device is not None:
            argv += ["--device", self.device]
        return argv

    def start(self, timeout_s: float = 120.0) -> None:
        if self.proc is not None and self.proc.poll() is None:
            raise RuntimeError("node already running")
        self.status_path.unlink(missing_ok=True)
        # stderr goes to a FILE, never a pipe: a node logging >64KB
        # would block on a full pipe buffer mid-request otherwise
        log_f = open(self.log_path, "ab")
        try:
            self.proc = subprocess.Popen(
                self.argv(),
                env=self.env,
                stdout=subprocess.DEVNULL,
                stderr=log_f,
            )
        finally:
            log_f.close()  # the child holds its own descriptor
        self.wait_healthy(timeout_s)

    def _log_tail(self, nbytes: int = 2000) -> str:
        if self.log_path.exists():
            return self.log_path.read_bytes()[-nbytes:].decode(
                errors="replace")
        return "<no log file>"

    def wait_healthy(self, timeout_s: float) -> None:
        """Heartbeat-until-ready (m3em agent heartbeats).

        On timeout, the raised error CARRIES the diagnosis: the tail of
        the node's log file and the last /health payload (or the error
        fetching it), so a wedged node fails with its reason, not a
        bare TimeoutError."""
        deadline = time.monotonic() + timeout_s
        last_health: object = "<never reached /health>"
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise RuntimeError(
                    f"node died during startup (rc={self.proc.returncode}): "
                    f"{self._log_tail()}"
                )
            if self.status_path.exists():
                try:
                    status = json.loads(self.status_path.read_text())
                except json.JSONDecodeError:
                    time.sleep(0.05)
                    continue
                self.port = status["port"]
                try:
                    with urllib.request.urlopen(
                        f"http://127.0.0.1:{self.port}/health", timeout=2
                    ) as r:
                        if r.status == 200:
                            return
                except urllib.error.HTTPError as e:
                    # non-200: the BODY is the diagnosis (urlopen raises
                    # HTTPError rather than returning the response)
                    body = (e.read() or b"")[:2000].decode(errors="replace")
                    last_health = f"<health {e.code}: {body}>"
                except OSError as e:
                    last_health = f"<health fetch failed: {e}>"
            time.sleep(0.1)
        raise TimeoutError(
            f"node did not become healthy within {timeout_s:.0f}s; "
            f"last /health: {last_health!r}; log tail:\n{self._log_tail()}")

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def stop(self, timeout_s: float = 30.0) -> int:
        """Graceful: SIGTERM → drain (final flush, snapshot, handoff)."""
        if not self.alive():
            return self.proc.returncode if self.proc else -1
        self.proc.send_signal(signal.SIGTERM)
        self.proc.wait(timeout=timeout_s)
        return self.proc.returncode

    def kill(self) -> None:
        """The crash scenario: SIGKILL, no cleanup, no flush."""
        if self.alive():
            self.proc.kill()
            self.proc.wait(timeout=30)

    def restart(self, timeout_s: float = 120.0) -> None:
        self.kill()  # no-op when already dead
        self.start(timeout_s)

    # -- client helpers ----------------------------------------------------

    def write_json(self, samples: list) -> int:
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.port}/api/v1/json/write",
            data=json.dumps(samples).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.load(r)["written"]

    def query_range(self, query: str, start_s: int, end_s: int,
                    step: str = "10s") -> list:
        url = (f"http://127.0.0.1:{self.port}/api/v1/query_range?"
               f"query={urllib.request.quote(query)}&start={start_s}"
               f"&end={end_s}&step={step}")
        with urllib.request.urlopen(url, timeout=60) as r:
            out = json.load(r)
        if out.get("status") != "success":
            raise RuntimeError(out)
        return out["data"]["result"]


# -- cross-process observability collection ---------------------------------
#
# The read side of the tracing/histogram substrate: pull every process's
# span ring / metric scrape over HTTP and join them, so a scenario can
# assert on ONE stitched trace or ONE fleet-merged p99 instead of
# per-process fragments.


def collect_traces(ports, local_spans=None, timeout_s: float = 30.0):
    """Fetch every node's span ring (``/api/v1/debug/traces``) and join
    with any in-test spans (``Span.to_dict`` rows, e.g. from the
    driving process's own Tracer) → {trace_id: [span dicts]}, each
    trace parent-before-child.  ``ports`` are HTTP (or admin) ports on
    127.0.0.1."""
    from m3_tpu_torch.instrument.tracing import join_traces

    spans = list(local_spans or [])
    for port in ports:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/api/v1/debug/traces",
                timeout=timeout_s) as r:
            spans.extend(json.load(r)["data"])
    return join_traces(spans)


def scrape_fleet(ports, timeout_s: float = 10.0):
    """Strict-parse every node's /metrics, TOLERATING dead nodes:
    ``{port: [Sample] | None}`` — None marks an unreachable node (the
    soak scrapes mid-SIGKILL, so this is a normal outcome, not an
    error).  A scrape that ARRIVES but fails the strict parser still
    raises: a live node emitting malformed exposition is a bug, not a
    fault window."""
    from m3_tpu_torch.instrument import exposition

    out = {}
    for port in ports:
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics",
                    timeout=timeout_s) as r:
                text = r.read().decode()
        except OSError:
            out[port] = None
            continue
        out[port] = exposition.parse_text(text)
    return out


def merged_histogram(ports, base: str, timeout_s: float = 30.0):
    """Scrape every node's /metrics, strict-parse, and vector-add one
    histogram's bucket lanes across the fleet.  Returns the merged
    {le: cumulative count} map — feed it to
    ``exposition.merged_quantile(merged, q)`` for fleet p50/p99.
    Exact because every Histogram shares instrument.HISTOGRAM_BOUNDS."""
    from m3_tpu_torch.instrument import exposition

    scrapes = []
    for port in ports:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=timeout_s) as r:
            scrapes.append(exposition.parse_text(r.read().decode()))
    return exposition.merge_histograms(scrapes, base)
