"""Placements: shard ↔ instance assignment with staged shard states.

The port's copy of ``m3_tpu/cluster/placement.py``, over the port's
``cluster/kv.py``: the same JSON form in the KV and the same
assignments for the same inputs.

Reference parity: `src/cluster/placement` — instances carrying shards in
Initializing/Available/Leaving states, the sharded add/remove/replace
algorithm (`algo/sharded.go:39,93-148`), isolation-group-aware balancing,
and versioned storage in KV (`placement/storage`).  A placement names
which host owns each logical shard; shard movement = staged handoff
(Initializing streams from the Leaving source, then both flip) exactly
as dbnode does topology changes.
"""

from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field

from m3_tpu_torch.cluster.kv import KVStore


class ShardState(enum.Enum):
    INITIALIZING = "I"
    AVAILABLE = "A"
    LEAVING = "L"


@dataclass(frozen=True)
class ShardAssignment:
    shard: int
    state: ShardState
    source_id: str | None = None  # Initializing: who streams the data


@dataclass
class Instance:
    id: str
    isolation_group: str = ""
    weight: int = 1
    shards: dict = field(default_factory=dict)  # shard id -> ShardAssignment
    shard_set_id: int = 0  # mirrored placements: same set id => same shards
    # Data-plane RPC address ("host:port") other nodes dial to stream
    # this instance's blocks (the reference placement instance's
    # endpoint field); empty when unknown (in-process tests resolve by
    # id instead).
    endpoint: str = ""

    def owned(self) -> list[int]:
        return sorted(self.shards)

    def available(self) -> list[int]:
        return sorted(
            s for s, a in self.shards.items() if a.state == ShardState.AVAILABLE
        )


@dataclass
class Placement:
    instances: dict  # id -> Instance
    num_shards: int
    replica_factor: int
    version: int = 0
    is_mirrored: bool = False

    # -- queries -----------------------------------------------------------

    def instances_for_shard(self, shard: int) -> list[Instance]:
        return [
            inst for inst in self.instances.values() if shard in inst.shards
        ]

    def validate(self) -> None:
        """Every shard has exactly RF non-Leaving owners; Initializing
        shards name a Leaving source (reference placement.Validate)."""
        for s in range(self.num_shards):
            owners = [
                i for i in self.instances.values()
                if s in i.shards and i.shards[s].state != ShardState.LEAVING
            ]
            if len(owners) != self.replica_factor:
                raise ValueError(
                    f"shard {s} has {len(owners)} owners, want {self.replica_factor}"
                )

    # -- serialization -----------------------------------------------------

    def to_json(self) -> bytes:
        return json.dumps({
            "num_shards": self.num_shards,
            "replica_factor": self.replica_factor,
            "version": self.version,
            "is_mirrored": self.is_mirrored,
            "instances": {
                iid: {
                    "isolation_group": inst.isolation_group,
                    "weight": inst.weight,
                    "shard_set_id": inst.shard_set_id,
                    "endpoint": inst.endpoint,
                    "shards": {
                        str(s): [a.state.value, a.source_id]
                        for s, a in inst.shards.items()
                    },
                }
                for iid, inst in self.instances.items()
            },
        }).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "Placement":
        d = json.loads(raw)
        insts = {}
        for iid, idata in d["instances"].items():
            shards = {
                int(s): ShardAssignment(int(s), ShardState(v[0]), v[1])
                for s, v in idata["shards"].items()
            }
            insts[iid] = Instance(iid, idata["isolation_group"],
                                  idata["weight"], shards,
                                  idata.get("shard_set_id", 0),
                                  idata.get("endpoint", ""))
        return cls(insts, d["num_shards"], d["replica_factor"], d["version"],
                   d.get("is_mirrored", False))


def _copy_instances(p: Placement) -> dict:
    """Deep-enough copy for the staged mutation algorithms: fresh
    Instance objects with fresh shard dicts, every identity field
    (isolation group, weight, shard set, endpoint) preserved."""
    return {
        iid: Instance(i.id, i.isolation_group, i.weight, dict(i.shards),
                      i.shard_set_id, i.endpoint)
        for iid, i in p.instances.items()
    }


def _least_loaded(instances: list[Instance], shard: int,
                  taken_groups: set[str]) -> Instance:
    """Pick the least-loaded candidate, preferring new isolation groups
    (the reference's isolation-group constraint, algo/sharded.go)."""
    def key(inst: Instance):
        return (
            inst.isolation_group in taken_groups,
            len(inst.shards) / max(inst.weight, 1),
            inst.id,
        )
    candidates = [i for i in instances if shard not in i.shards]
    if not candidates:
        raise ValueError(f"no candidate instance for shard {shard}")
    return min(candidates, key=key)


def initial_placement(instances: list[Instance], num_shards: int,
                      rf: int) -> Placement:
    """reference algo/sharded.go InitialPlacement: spread each shard's RF
    replicas across isolation groups onto the least-loaded instances."""
    insts = {i.id: Instance(i.id, i.isolation_group, i.weight, {},
                            i.shard_set_id, i.endpoint) for i in instances}
    for s in range(num_shards):
        groups: set[str] = set()
        for _ in range(rf):
            inst = _least_loaded(list(insts.values()), s, groups)
            inst.shards[s] = ShardAssignment(s, ShardState.AVAILABLE)
            groups.add(inst.isolation_group)
    p = Placement(insts, num_shards, rf, version=1)
    p.validate()
    return p


def add_instance(p: Placement, new: Instance) -> Placement:
    """reference algo/sharded.go AddInstance: steal shards from the most
    loaded instances; stolen shards go Initializing on the new instance
    with the donor as source (donor keeps serving until cutover)."""
    insts = _copy_instances(p)
    newcomer = Instance(new.id, new.isolation_group, new.weight, {},
                        new.shard_set_id, new.endpoint)
    insts[new.id] = newcomer
    target = p.num_shards * p.replica_factor // len(insts)
    while len(newcomer.shards) < target:
        donor = max(
            (i for i in insts.values() if i.id != new.id),
            key=lambda i: len([a for a in i.shards.values()
                               if a.state == ShardState.AVAILABLE]),
        )
        movable = [s for s, a in donor.shards.items()
                   if a.state == ShardState.AVAILABLE and s not in newcomer.shards]
        if not movable:
            break
        s = movable[0]
        donor.shards[s] = ShardAssignment(s, ShardState.LEAVING)
        newcomer.shards[s] = ShardAssignment(s, ShardState.INITIALIZING, donor.id)
    return Placement(insts, p.num_shards, p.replica_factor, p.version + 1,
                     p.is_mirrored)


def remove_instance(p: Placement, instance_id: str) -> Placement:
    """reference algo/sharded.go RemoveInstance: the leaver's shards go
    Initializing on the least-loaded survivors."""
    insts = _copy_instances(p)
    leaver = insts[instance_id]
    for s in list(leaver.shards):
        a = leaver.shards[s]
        leaver.shards[s] = ShardAssignment(s, ShardState.LEAVING, None)
        groups = {i.isolation_group for i in insts.values()
                  if s in i.shards and i.id != instance_id}
        dest = _least_loaded(
            [i for i in insts.values() if i.id != instance_id], s, groups
        )
        dest.shards[s] = ShardAssignment(s, ShardState.INITIALIZING, instance_id)
    return Placement(insts, p.num_shards, p.replica_factor, p.version + 1,
                     p.is_mirrored)


def replace_instance(p: Placement, leaving_id: str, new: Instance) -> Placement:
    """reference algo/sharded.go ReplaceInstances: the replacement takes
    exactly the leaver's shards."""
    insts = _copy_instances(p)
    leaver = insts[leaving_id]
    newcomer = Instance(new.id, new.isolation_group, new.weight, {},
                        new.shard_set_id, new.endpoint)
    insts[new.id] = newcomer
    for s, a in list(leaver.shards.items()):
        leaver.shards[s] = ShardAssignment(s, ShardState.LEAVING)
        newcomer.shards[s] = ShardAssignment(s, ShardState.INITIALIZING, leaving_id)
    return Placement(insts, p.num_shards, p.replica_factor, p.version + 1,
                     p.is_mirrored)


def mark_available(p: Placement, instance_id: str, shard: int) -> Placement:
    """Cutover: Initializing→Available on the target, and the matching
    Leaving shard disappears from its source (reference
    MarkShardsAvailable)."""
    insts = _copy_instances(p)
    inst = insts[instance_id]
    a = inst.shards.get(shard)
    if a is None or a.state != ShardState.INITIALIZING:
        raise ValueError(f"shard {shard} not initializing on {instance_id}")
    inst.shards[shard] = ShardAssignment(shard, ShardState.AVAILABLE)
    if a.source_id and a.source_id in insts:
        src = insts[a.source_id]
        if shard in src.shards and src.shards[shard].state == ShardState.LEAVING:
            del src.shards[shard]
    return Placement(insts, p.num_shards, p.replica_factor, p.version + 1,
                     p.is_mirrored)


def forget_instance(p: Placement, instance_id: str) -> Placement:
    """Drop an instance's entry outright (no staged handoff) — the
    operator's final delete of a drained/dead instance whose shards are
    all gone (or a dead leaver whose shards already re-initialized
    elsewhere via remove_instance).  Refuses while the instance still
    carries non-Leaving shards: those owners must be moved first."""
    inst = p.instances.get(instance_id)
    if inst is None:
        raise KeyError(f"no instance {instance_id} in placement")
    live = [s for s, a in inst.shards.items()
            if a.state != ShardState.LEAVING]
    if live:
        raise ValueError(
            f"instance {instance_id} still owns shards {sorted(live)}; "
            "remove_instance/replace_instance first"
        )
    insts = _copy_instances(p)
    del insts[instance_id]
    return Placement(insts, p.num_shards, p.replica_factor, p.version + 1,
                     p.is_mirrored)


class PlacementService:
    """Versioned placement storage over KV (reference
    placement/service + placement/storage).

    Every mutation of the placement key goes through this class:
    ``update()`` is the get→mutate→CAS loop with bounded retry on
    version conflicts, so two concurrent mutations (or a mutation racing
    a node's ``mark_available`` cutover) serialize instead of one
    failing."""

    #: bounded CAS retries: placement churn is operator-paced, so a
    #: handful of re-reads always wins unless something is spinning.
    CAS_ATTEMPTS = 5

    def __init__(self, kv: KVStore, key: str = "placement"):
        self.kv = kv
        self.key = key

    def get(self) -> Placement | None:
        v = self.kv.get(self.key)
        return Placement.from_json(v.data) if v else None

    def set(self, p: Placement) -> None:
        cur = self.kv.get(self.key)
        self.kv.check_and_set(self.key, cur.version if cur else 0, p.to_json())

    def update(self, mutate, max_attempts: int | None = None) -> Placement:
        """Apply ``mutate(placement | None) -> Placement`` atomically:
        re-read + re-mutate + CAS, retrying (bounded) when another
        writer moved the version between our get and our set.  Only the
        CAS conflict retries — errors raised by ``mutate`` itself
        (validation, unknown instance...) surface immediately."""
        attempts = self.CAS_ATTEMPTS if max_attempts is None else max_attempts
        last: Exception | None = None
        for _ in range(max(1, attempts)):
            cur = self.kv.get(self.key)
            p2 = mutate(Placement.from_json(cur.data) if cur else None)
            try:
                self.kv.check_and_set(
                    self.key, cur.version if cur else 0, p2.to_json())
                return p2
            except ValueError as e:
                if "version conflict" not in str(e):
                    raise
                last = e  # another writer won: re-read and re-apply
        raise last
