"""Instrumentation: the port's logger shim (stdlib ``logging``, one
format, configured once) in place of ``m3_tpu.instrument.logger``."""

from __future__ import annotations

import logging


def logger(name: str) -> logging.Logger:
    log = logging.getLogger(f"m3_tpu_torch.{name}" if name else "m3_tpu_torch")
    root = logging.getLogger("m3_tpu_torch")
    if not root.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s %(message)s"))
        root.addHandler(h)
        root.setLevel(logging.INFO)
        root.propagate = False
    return log
