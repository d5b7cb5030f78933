"""Dynamic runtime options: live tuning through KV watches.  The port's
counterpart of ``m3_tpu/core/runtime_options.py`` (the same keys and
JSON values), over the port's ``cluster/kv.py``.

Equivalent of the reference's RuntimeOptionsManager
(`src/dbnode/runtime/runtime_options_manager.go` + the KV key registry
`src/dbnode/kvconfig/keys.go`): named options whose current values are
backed by watched KV keys, so operators retune a live node (write
limits, bootstrap consistency, cache sizes) without restarts.  Every
subsystem reads through a handle; updates propagate via the KV watch
and optional on-change callbacks.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Callable, Dict

from m3_tpu_torch.cluster.kv import KVStore

# the key registry (kvconfig/keys.go role): name -> default
DEFAULT_OPTIONS: Dict[str, Any] = {
    "write_new_series_limit_per_sec": 0,      # 0 = unlimited
    "max_docs_matched": 0,
    "max_series_read": 0,
    "max_bytes_read": 0,
    "bootstrap_consistency": "majority",
    "block_cache_max_bytes": 64 << 20,
    "mediator_tick_interval_s": 10.0,
}

KEY_PREFIX = "runtime/"


class RuntimeOptionsManager:
    """Watches `runtime/<name>` KV keys; get() always returns the live
    value; set() writes through KV so every watcher (local or another
    process sharing the KV file) converges."""

    def __init__(self, kv: KVStore, defaults: Dict[str, Any] | None = None):
        self.kv = kv
        self._defaults = dict(DEFAULT_OPTIONS)
        if defaults:
            self._defaults.update(defaults)
        self._values: Dict[str, Any] = dict(self._defaults)
        self._listeners: Dict[str, list] = {}
        self._lock = threading.Lock()
        for name in self._defaults:
            self.kv.watch(KEY_PREFIX + name, self._make_watcher(name))

    def _make_watcher(self, name: str) -> Callable:
        def on_change(vv) -> None:
            try:
                value = json.loads(vv.data)
            except (ValueError, TypeError):
                return  # malformed writes never poison the live value
            with self._lock:
                self._values[name] = value
                listeners = list(self._listeners.get(name, ()))
            for fn in listeners:
                try:
                    fn(value)
                except Exception:  # noqa: BLE001 — listeners are isolated
                    from m3_tpu_torch.instrument import logger

                    logger("runtime_options").exception(
                        "runtime option %r listener failed", name
                    )
        return on_change

    def get(self, name: str) -> Any:
        with self._lock:
            if name not in self._values:
                raise KeyError(f"unknown runtime option {name!r}")
            return self._values[name]

    def validate(self, name: str, value: Any) -> None:
        """Unknown names and wrong-typed values are rejected up front —
        a type error discovered inside a change listener would be
        swallowed and the option would read as applied while the
        subsystem still runs on the old value."""
        if name not in self._defaults:
            raise KeyError(f"unknown runtime option {name!r}")
        default = self._defaults[name]
        if isinstance(default, bool):
            ok = isinstance(value, bool)
        elif isinstance(default, (int, float)):
            ok = isinstance(value, (int, float)) and not isinstance(value, bool)
        else:
            ok = isinstance(value, type(default))
        if not ok:
            raise KeyError(
                f"runtime option {name!r} wants {type(default).__name__}, "
                f"got {type(value).__name__}"
            )

    def set(self, name: str, value: Any) -> None:
        """Write-through: the KV set triggers the watch, which updates
        the live value (one code path for local and remote updates)."""
        self.validate(name, value)
        self.kv.set(KEY_PREFIX + name, json.dumps(value).encode())

    def on_change(self, name: str, fn: Callable[[Any], None]) -> None:
        if name not in self._defaults:
            raise KeyError(f"unknown runtime option {name!r}")
        with self._lock:
            self._listeners.setdefault(name, []).append(fn)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._values)
