"""m3em-style process agent: remote node lifecycle over HTTP.
The port's counterpart of ``m3_tpu/dtest/agent.py``.

Equivalent of `src/m3em/agent` (gRPC operator: Setup/Start/Stop/
Teardown + heartbeats, proto `m3em/generated/proto/m3em/operator.proto`)
— the piece that lets the dtest harness drive node processes on OTHER
hosts instead of only its own.  gRPC collapses to a small JSON/HTTP
surface (the framework's admin-plane convention):

    POST /setup      {"name", "config_yaml"}   write config under the
                                               agent's workdir
    POST /start      {"name"}                  spawn node_main, wait
                                               healthy
    POST /stop       {"name"}                  SIGTERM (graceful)
    POST /kill       {"name"}                  SIGKILL (crash scenario)
    POST /teardown   {"name"}                  kill + delete workdir
    GET  /status                               heartbeat: every node's
                                               {alive, pid, ports}
    GET  /logs?name=n&tail=N                   last N bytes of node log

The agent reuses the local ``NodeProcess`` harness for the actual
lifecycle, so scenarios behave identically whether driven in-process
(tests) or through an agent (multi-host dtests).  Every node it starts
runs on the agent's ``device`` (None = the CUDA card; the CPU tests pass
``"cpu"``).  ``AgentClient`` mirrors the server surface 1:1.
"""

from __future__ import annotations

import json
import shutil
import threading
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

from m3_tpu_torch.dtest.harness import NodeProcess


class Agent:
    """Owns the node processes on one host."""

    def __init__(self, workdir: str, device=None):
        self.workdir = Path(workdir)
        self.device = device
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.nodes: dict[str, NodeProcess] = {}
        self._mu = threading.Lock()

    # -- operator verbs (m3em operator.proto Setup/Start/Stop/Teardown) --

    @staticmethod
    def _check_name(name: str) -> str:
        """Node names become filesystem paths under the workdir (and
        teardown rmtree's them); anything that could escape is rejected
        — the agent serves remote drivers over HTTP."""
        if (not name or len(name) > 64
                or not all(c.isalnum() or c in "-_." for c in name)
                or name in (".", "..")):
            raise ValueError(f"invalid node name {name!r}")
        return name

    def setup(self, name: str, config_yaml: str) -> dict:
        name = self._check_name(name)
        with self._mu:
            if name in self.nodes and self.nodes[name].alive():
                raise ValueError(f"node {name!r} is running; stop it first")
            root = self.workdir / name / "data"
            root.mkdir(parents=True, exist_ok=True)
            cfg = self.workdir / name / "node.yaml"
            cfg.write_text(config_yaml)
            self.nodes[name] = NodeProcess(str(cfg), str(root), device=self.device)
            return {"name": name, "root": str(root)}

    def _node(self, name: str) -> NodeProcess:
        with self._mu:
            node = self.nodes.get(name)
        if node is None:
            raise KeyError(f"unknown node {name!r}; setup first")
        return node

    def start(self, name: str, timeout_s: float = 120.0) -> dict:
        node = self._node(name)
        node.start(timeout_s)
        return self.status()["nodes"][name]

    def stop(self, name: str) -> dict:
        rc = self._node(name).stop()
        return {"name": name, "rc": rc}

    def kill(self, name: str) -> dict:
        self._node(name).kill()
        return {"name": name, "killed": True}

    def teardown(self, name: str) -> dict:
        name = self._check_name(name)
        with self._mu:
            node = self.nodes.pop(name, None)
        if node is not None:
            node.kill()
        shutil.rmtree(self.workdir / name, ignore_errors=True)
        return {"name": name, "torn_down": True}

    def status(self) -> dict:
        """The heartbeat payload (m3em agent heartbeats carry process
        liveness the same way)."""
        with self._mu:
            snapshot = list(self.nodes.items())
        out = {}
        for name, node in snapshot:
            st = {"alive": node.alive(), "port": node.port}
            if node.status_path.exists():
                try:
                    st.update(json.loads(node.status_path.read_text()))
                except json.JSONDecodeError:
                    pass
            out[name] = st
        return {"nodes": out}

    def logs(self, name: str, tail: int = 4096) -> bytes:
        node = self._node(name)
        if not node.log_path.exists():
            return b""
        data = node.log_path.read_bytes()
        return data[-tail:]

    def close(self) -> None:
        with self._mu:
            nodes = list(self.nodes.values())
        for node in nodes:
            node.kill()


class _AgentHandler(BaseHTTPRequestHandler):
    agent: Agent = None

    def log_message(self, fmt, *args):
        pass

    def _json(self, code: int, obj) -> None:
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        u = urllib.parse.urlparse(self.path)
        try:
            if u.path == "/status":
                return self._json(200, self.agent.status())
            if u.path == "/logs":
                q = urllib.parse.parse_qs(u.query)
                data = self.agent.logs(q["name"][0],
                                       int(q.get("tail", ["4096"])[0]))
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            return self._json(404, {"error": f"unknown path {u.path}"})
        except (KeyError, ValueError) as e:
            return self._json(400, {"error": str(e)})

    def do_POST(self):
        path = self.path.rstrip("/")
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n)) if n else {}
            if not isinstance(body, dict):
                raise ValueError("request body must be a JSON object")
            if path == "/setup":
                return self._json(200, self.agent.setup(
                    body["name"], body["config_yaml"]))
            if path == "/start":
                return self._json(200, self.agent.start(
                    body["name"], float(body.get("timeout_s", 120.0))))
            if path == "/stop":
                return self._json(200, self.agent.stop(body["name"]))
            if path == "/kill":
                return self._json(200, self.agent.kill(body["name"]))
            if path == "/teardown":
                return self._json(200, self.agent.teardown(body["name"]))
            return self._json(404, {"error": f"unknown path {path}"})
        except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
            return self._json(400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — never drop the socket
            return self._json(500, {"error": f"{type(e).__name__}: {e}"})


def serve_agent_background(workdir: str, host: str = "127.0.0.1",
                           port: int = 0, device=None):
    agent = Agent(workdir, device=device)
    handler = type("_Bound", (_AgentHandler,), {"agent": agent})
    srv = ThreadingHTTPServer((host, port), handler)
    srv.agent = agent
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


class AgentClient:
    """Driver-side handle to one agent (dtest's view of m3em)."""

    def __init__(self, address: tuple[str, int], timeout_s: float = 150.0):
        self.base = f"http://{address[0]}:{address[1]}"
        self.timeout_s = timeout_s

    def _post(self, path: str, body: dict) -> dict:
        req = urllib.request.Request(
            self.base + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            return json.load(r)

    def setup(self, name: str, config_yaml: str) -> dict:
        return self._post("/setup", {"name": name, "config_yaml": config_yaml})

    def start(self, name: str) -> dict:
        return self._post("/start", {"name": name})

    def stop(self, name: str) -> dict:
        return self._post("/stop", {"name": name})

    def kill(self, name: str) -> dict:
        return self._post("/kill", {"name": name})

    def teardown(self, name: str) -> dict:
        return self._post("/teardown", {"name": name})

    def status(self) -> dict:
        with urllib.request.urlopen(self.base + "/status",
                                    timeout=self.timeout_s) as r:
            return json.load(r)

    def logs(self, name: str, tail: int = 4096) -> bytes:
        with urllib.request.urlopen(
            f"{self.base}/logs?name={urllib.parse.quote(name)}&tail={tail}",
            timeout=self.timeout_s,
        ) as r:
            return r.read()
