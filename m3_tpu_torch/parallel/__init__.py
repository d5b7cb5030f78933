"""The mesh and the sharded aggregator step, as ``m3_tpu.parallel``
exports them.  The names resolve on first use: ``aggregator.arena``
imports this package's kernel wrappers, and the sharded step imports the
arenas."""

import importlib

_EXPORTS = {
    "MeshTopology": "mesh",
    "make_mesh": "mesh",
    "ShardedAggregatorState": "sharded_agg",
    "sharded_init": "sharded_agg",
    "sharded_ingest_consume": "sharded_agg",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
