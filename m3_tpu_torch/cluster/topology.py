"""TopologyWatcher: a node's live view of the placement it serves in.
The port's counterpart of ``m3_tpu/cluster/topology.py``.

Reference parity: `src/dbnode/topology` — the dbnode side of the
cluster story.  `topology/dynamic.go` watches the placement key in the
cluster KV and turns every new version into an immutable topology map;
`storage/database.go` + `shard.go` consume those maps to assign/close
shards.  Here the watcher is deliberately *thin*: it owns the KV watch,
version filtering, and an immutable per-version snapshot of THIS
instance's shard assignment — all the side effects (ownership install,
block streaming, cutover CAS, shard drops) live in
``m3_tpu_torch.storage.migration.ShardMigrator``, which reads snapshots from
this class on the mediator tick.

Thread model: KV watches fire inline from arbitrary threads (the local
store's set path, or the remote store's poller thread).  The callback
only swaps one attribute under a lock and notifies listeners; listeners
must be cheap and non-blocking (the migrator's listener just records
"something changed" — the heavy work happens on its own tick).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from m3_tpu_torch.cluster.placement import (
    Placement, ShardAssignment, ShardState,
)
from m3_tpu_torch.instrument import logger

_LOG = logger("cluster.topology")


@dataclass(frozen=True)
class TopologyView:
    """One immutable observation of the placement, pre-digested for the
    instance the watcher serves.

    ``my_shards`` is this instance's shard map (empty when the
    placement exists but does not list the instance — a removed or
    not-yet-added node owns nothing).  ``placement`` is None only
    before any placement has been created, in which case the node keeps
    the own-everything default (single-node bring-up order: nodes boot
    first, the operator inits the placement after)."""

    placement: Optional[Placement]
    version: int
    instance_id: str

    @property
    def in_placement(self) -> bool:
        return (self.placement is not None
                and self.instance_id in self.placement.instances)

    @property
    def my_shards(self) -> Dict[int, ShardAssignment]:
        if not self.in_placement:
            return {}
        return dict(self.placement.instances[self.instance_id].shards)

    def shards_in_state(self, state: ShardState) -> list[int]:
        return sorted(s for s, a in self.my_shards.items()
                      if a.state == state)

    def owned_shards(self) -> Optional[frozenset]:
        """The shard set this node serves (writes AND reads):
        INITIALIZING (new data lands while history streams), AVAILABLE,
        and LEAVING (keep serving both paths until the newcomer cuts
        over).  None = no placement yet = own everything."""
        if self.placement is None:
            return None
        return frozenset(self.my_shards)

    def donor_for(self, shard: int) -> Optional[str]:
        """Source instance id for one of my INITIALIZING shards."""
        a = self.my_shards.get(shard)
        return a.source_id if a is not None else None

    def available_replicas(self, shard: int) -> list:
        """Other instances serving the shard AVAILABLE right now — the
        streaming fallback when an INITIALIZING shard's named donor is
        unreachable (replace-a-dead-node: the donor never answers)."""
        if self.placement is None:
            return []
        return [
            inst for inst in self.placement.instances_for_shard(shard)
            if inst.id != self.instance_id
            and inst.shards[shard].state == ShardState.AVAILABLE
        ]


class TopologyWatcher:
    """Watches the placement KV key on behalf of one instance id.

    ``on_change(view)`` listeners fire on every newly observed version
    (monotonic: stale versions are dropped, exactly like the session's
    dynamic watch).  ``view()`` returns the latest snapshot at any
    time.  ``close()`` detaches from the KV watch."""

    def __init__(self, kv, instance_id: str, key: str = "placement"):
        self.kv = kv
        self.key = key
        self.instance_id = instance_id
        self._mu = threading.Lock()
        self._listeners: list[Callable[[TopologyView], None]] = []
        self._view = TopologyView(None, 0, instance_id)
        self._closed = False

        def _watch_cb(vv) -> None:
            self._observe(vv)

        self._watch_cb = _watch_cb
        kv.watch(key, _watch_cb)

    def _observe(self, vv) -> None:
        try:
            p = Placement.from_json(vv.data)
        except Exception:  # noqa: BLE001 — a malformed placement must
            # not kill the watch (the control plane may be mid-repair);
            # the previous good view keeps serving.
            _LOG.exception("ignoring malformed placement at version %d",
                           vv.version)
            return
        with self._mu:
            if self._closed or vv.version <= self._view.version:
                return
            view = TopologyView(p, vv.version, self.instance_id)
            self._view = view
            listeners = list(self._listeners)
        _LOG.info(
            "placement v%d: instance %s shards I=%d A=%d L=%d",
            vv.version, self.instance_id,
            len(view.shards_in_state(ShardState.INITIALIZING)),
            len(view.shards_in_state(ShardState.AVAILABLE)),
            len(view.shards_in_state(ShardState.LEAVING)),
        )
        for fn in listeners:
            try:
                fn(view)
            except Exception:  # noqa: BLE001 — one listener must not
                # starve the rest (watch callbacks share the KV
                # notification path)
                _LOG.exception("topology listener raised")

    def view(self) -> TopologyView:
        with self._mu:
            return self._view

    def on_change(self, fn: Callable[[TopologyView], None]) -> None:
        with self._mu:
            self._listeners.append(fn)
            view = self._view
        if view.placement is not None:
            fn(view)  # replay the current state to the new listener

    def close(self) -> None:
        with self._mu:
            self._closed = True
            self._listeners.clear()
        if hasattr(self.kv, "unwatch"):
            self.kv.unwatch(self.key, self._watch_cb)
