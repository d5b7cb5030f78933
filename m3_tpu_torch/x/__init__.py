"""Cross-cutting substrate (the reference's ``src/x`` tree), the port's
counterpart of ``m3_tpu/x/__init__.py``.

* ``fault`` — process-global fault-injection registry (this package's
  own, apart from the reference package's).
* ``retry`` — exponential backoff + jitter + attempt caps + a shared
  retry budget.
* ``deadline`` — end-to-end query deadlines + cooperative cancellation.
* ``admission`` — bounded concurrent-query slots + wait queue.
* ``breaker`` — per-peer circuit breakers in one process registry.
* ``devguard`` — the device-boundary seam: typed ``DeviceError``
  classification over torch/CUDA errors, per-stage counters and
  breakers (``run_guarded``, no fallback), and the
  ``device.compile``/``device.dispatch``/``device.transfer`` faultpoints.
* ``membudget`` — the process's device-memory ledger: arenas, series
  buffers and big transient stage buffers reserve bytes BEFORE they
  allocate; over ``device.mem_budget`` rejects typed.
* ``diskbudget`` — membudget's disk twin: the per-root disk ledger with
  watermarks.
* ``controller``, ``chaos`` — the SLO-burn control loop and the seeded
  fault timeline (imported by their users, not here).
* ``lockcheck``, ``hopwatch``, ``tracewatch`` — the runtime instruments:
  the lock-order sanitizer, the per-hop ledger of transfers, builds and
  dispatches, and the transfer guard with the build budget, over the
  device boundary's seams in ``devseams`` (imported by their users, not
  here).  Each is armed by code only: unlike the reference's, none reads
  an environment variable.

``register_metrics(registry)`` mirrors the fault, retry, deadline,
breaker, device-guard, device-memory and disk counters into an
instrument registry at scrape time, so a node's ``/metrics`` exposes
them.  The runtime instruments are test and profiling tools, not
mirrored.
"""

from __future__ import annotations

from m3_tpu_torch.x import breaker, deadline, fault, retry
from m3_tpu_torch.x import devguard, membudget  # noqa: F401  (device guard)


def register_metrics(registry, prefix: str = "") -> object:
    """Register a scrape-time collector mirroring the fault, retry,
    deadline, breaker, device and disk counters into ``registry`` gauges
    (tagged by point/retrier/peer/stage/component name).  Returns the collector so
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
        # device-guard stage counters: device.<stage>.calls /
        # .errors.<kind> (stage names contain dots — split on the known
        # suffixes, the devguard.status() rule)
        for name, value in devguard.counters().items():
            rest = name[len("device."):]
            if rest.endswith(".calls"):
                scope.tagged({"stage": rest[:-len(".calls")]}).gauge(
                    "device_guard_calls").update(value)
            else:
                st, _, kind = rest.rpartition(".errors.")
                if st:
                    scope.tagged({"stage": st, "kind": kind}).gauge(
                        "device_error_total").update(value)
        mb = membudget.snapshot()
        scope.gauge("device_mem_budget_bytes").update(mb["budget_bytes"])
        scope.gauge("device_mem_used_bytes").update(mb["used_bytes"])
        scope.gauge("device_mem_peak_bytes").update(mb["peak_bytes"])
        scope.gauge("device_mem_rejected_total").update(
            mb["rejected_total"])
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
