"""Node entry point: ``python -m m3_tpu_torch.server.node_main <config>``.
The port's counterpart of ``m3_tpu/server/node_main.py``.

Equivalent of the reference's service mains
(`src/cmd/services/m3dbnode/main/main.go` — parse config, server.Run,
block on signals).  Writes a `<root>/node.json` status file (pid, HTTP,
RPC and admin ports) once serving, so harnesses can discover the ephemeral port;
SIGTERM drains (final flush + snapshot, then a bounded wait for LEAVING
shards to cut over) and exits 0.  ``--drain-timeout S`` bounds that wait
(60 s by default): the reference reads ``M3_DRAIN_TIMEOUT_S`` from the
environment, and the port reads no environment, so it is an argument.

The node runs on the CUDA card and raises without one; ``--device cpu``
asks for the CPU (the tests do).  The config is YAML, or JSON where
PyYAML is not installed.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m m3_tpu_torch.server.node_main",
        description="Run one m3_tpu_torch node from a config file.")
    ap.add_argument("config", help="node config (YAML, or JSON)")
    ap.add_argument("--device", default=None,
                    help="torch device of the node (default: CUDA)")
    ap.add_argument("--drain-timeout", type=float, default=60.0,
                    dest="drain_timeout",
                    help="seconds SIGTERM's drain waits for LEAVING shards "
                         "to cut over (default 60)")
    args = ap.parse_args(argv)

    from m3_tpu_torch.core.config import load_config
    from m3_tpu_torch.instrument import logger
    from m3_tpu_torch.server.assembly import run_node

    log = logger("node_main")
    cfg = load_config(args.config)
    asm = run_node(cfg, device=args.device)
    status = {
        "pid": os.getpid(),
        "port": asm.port,
        "rpc_port": asm.rpc_port,
        "admin_port": asm.admin_port,
        "root": cfg.db.root,
        "device": str(asm.db.device),
    }
    status_path = Path(cfg.db.root) / "node.json"
    status_path.write_text(json.dumps(status))
    log.info("node up: %s", status)

    stop = threading.Event()

    def _term(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    stop.wait()
    # SIGTERM is a drain, not a fast exit: stop the front door,
    # flush/snapshot everything persistable, then close.
    log.info("node draining")
    asm.drain(handoff_timeout_s=args.drain_timeout)
    log.info("node shut down")
    status_path.unlink(missing_ok=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
