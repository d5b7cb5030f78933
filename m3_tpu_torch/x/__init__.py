"""Cross-cutting substrate (the reference's ``src/x`` tree), the port's
counterpart of ``m3_tpu/x/__init__.py``.

* ``fault`` — process-global fault-injection registry (this package's
  own, apart from the reference package's).
* ``retry`` — exponential backoff + jitter + attempt caps + a shared
  retry budget.
* ``deadline`` — end-to-end query deadlines + cooperative cancellation.
* ``admission`` — bounded concurrent-query slots + wait queue.
* ``breaker`` — per-peer circuit breakers in one process registry.
* ``diskbudget`` — the per-root disk ledger with watermarks.

``register_metrics(registry)`` mirrors the fault, retry, deadline,
breaker and disk counters into an instrument registry at scrape time,
so a node's ``/metrics`` exposes them.  The reference's device-boundary
gauges (``devguard``, ``membudget``) and its XLA-only env seams
(``lockcheck``, ``tracewatch``, ``hopwatch``) have no port yet and are
not mirrored.
"""

from __future__ import annotations

from m3_tpu_torch.x import breaker, deadline, fault, retry


def register_metrics(registry, prefix: str = "") -> object:
    """Register a scrape-time collector mirroring the fault, retry,
    deadline, breaker and disk counters into ``registry`` gauges (tagged
    by point/retrier/peer/component name).  Returns the collector so
    callers with a shutdown path can ``registry.unregister_collector``
    it."""
    scope = registry.scope(prefix)

    def collect() -> None:
        for name, value in fault.counters().items():
            point, _, key = name.rpartition(".")
            scope.tagged({"point": point}).gauge(f"fault.{key}").update(value)
        for name, value in retry.counters().items():
            rname, _, key = name.rpartition(".")
            scope.tagged({"retrier": rname}).gauge(f"retry.{key}").update(value)
        dl = deadline.counters()
        scope.gauge("query_deadline_exceeded_total").update(
            dl.get("deadline.exceeded", 0))
        scope.gauge("query_cancelled_total").update(
            dl.get("deadline.cancelled", 0))
        for peer, br in breaker.all_breakers().items():
            scope.tagged({"peer": peer, "kind": br.kind}).gauge(
                "breaker_state").update(br.state_code)
        for name, value in breaker.counters().items():
            peer, _, key = name.rpartition(".")
            scope.tagged({"peer": peer}).gauge(f"breaker.{key}").update(value)
        # disk ledger + typed-capacity counters (lazy: diskbudget pulls
        # persist.capacity in, and most registry users never touch disk)
        from m3_tpu_torch.persist import capacity
        from m3_tpu_torch.x import diskbudget
        db = diskbudget.snapshot()
        if db["enabled"]:
            scope.gauge("disk_total_bytes").update(db["total_bytes"])
            scope.gauge("disk_used_bytes").update(db["used_bytes"])
            scope.gauge("disk_free_bytes").update(db["free_bytes"])
            scope.gauge("disk_free_ratio").update(db["free_ratio"])
            scope.gauge("disk_reserve_bytes").update(db["reserve_bytes"])
            scope.gauge("disk_level").update(db["level_value"])
            scope.gauge("disk_ingest_shed_total").update(db["shed_total"])
            for comp, nbytes in db["components"].items():
                scope.tagged({"component": comp}).gauge(
                    "disk_component_bytes").update(nbytes)
        for name, value in capacity.counters().items():
            comp, _, _key = name.rpartition(".")
            scope.tagged({"component": comp}).gauge(
                "disk_capacity_errors_total").update(value)

    registry.register_collector(collect)
    return collect
