"""Mirrored placements: replica groups that share identical shard sets.

The port's copy of ``m3_tpu/cluster/placement_mirrored.py``.

Reference parity: `src/cluster/placement/algo/mirrored.go` — the
aggregator's HA placement.  Instances carry a ``shard_set_id``; every
instance in a shard set holds EXACTLY the same shards (they mirror each
other), so leader/follower pairs see identical traffic and a follower
can take over flushing without any shard movement
(`aggregator/aggregator/election_mgr.go` elects within the pair).

The algorithm treats each shard set as one logical node of weight =
group weight and runs the sharded balancing over groups:

* ``mirrored_initial_placement`` — groups of exactly RF instances
  (distinct isolation groups within a set preferred by construction:
  the caller builds the sets), each shard assigned to one group.
* ``mirrored_add_group`` / ``mirrored_remove_group`` — whole groups
  join/leave; shards move group-to-group with per-member source pairing
  (member k of the new set streams from member k of the donor set).
* ``mirrored_replace_instance`` — a new instance takes over a dead
  member's slot in its shard set, streaming from the SURVIVING mirror
  (not the leaver — that is the point of mirroring).

All functions return new Placement objects with version+1 and
``is_mirrored=True``; ``validate_mirrored`` checks the mirror invariant
on top of the base RF validation.
"""

from __future__ import annotations

from collections import defaultdict

from m3_tpu_torch.cluster.placement import (
    Instance,
    Placement,
    ShardAssignment,
    ShardState,
)


def _groups(p_or_insts) -> dict[int, list[Instance]]:
    insts = (p_or_insts.instances.values()
             if isinstance(p_or_insts, Placement) else p_or_insts)
    out: dict[int, list[Instance]] = defaultdict(list)
    for i in insts:
        out[i.shard_set_id].append(i)
    for members in out.values():
        members.sort(key=lambda i: i.id)
    return dict(out)


def validate_mirrored(p: Placement) -> None:
    """Base validation + the mirror invariant: every shard set has
    exactly RF members with identical shard assignments (states may
    differ only in source pairing during migration)."""
    p.validate()
    for ssid, members in _groups(p).items():
        if len(members) != p.replica_factor:
            raise ValueError(
                f"shard set {ssid} has {len(members)} members, "
                f"want RF={p.replica_factor}"
            )
        shard_sets = {frozenset(m.shards) for m in members}
        if len(shard_sets) != 1:
            raise ValueError(f"shard set {ssid} members own differing shards")
        for s in members[0].shards:
            states = {m.shards[s].state for m in members}
            if len(states) != 1:
                raise ValueError(
                    f"shard set {ssid} shard {s} states differ: {states}"
                )


def _group_load(members: list[Instance]) -> float:
    w = sum(max(m.weight, 1) for m in members) / len(members)
    return len(members[0].shards) / w


def mirrored_initial_placement(instances: list[Instance], num_shards: int,
                               rf: int) -> Placement:
    """Each shard lands on exactly one shard set (whose RF members all
    carry it), balanced by group load (algo/mirrored.go InitialPlacement
    via the grouped sharded algorithm)."""
    groups = _groups([
        Instance(i.id, i.isolation_group, i.weight, {}, i.shard_set_id,
                 i.endpoint)
        for i in instances
    ])
    if not groups:
        raise ValueError("no instances")
    for ssid, members in groups.items():
        if len(members) != rf:
            raise ValueError(
                f"shard set {ssid} has {len(members)} instances, want RF={rf}"
            )
    for s in range(num_shards):
        members = min(groups.values(), key=lambda g: (_group_load(g), g[0].id))
        for m in members:
            m.shards[s] = ShardAssignment(s, ShardState.AVAILABLE)
    insts = {m.id: m for members in groups.values() for m in members}
    p = Placement(insts, num_shards, rf, version=1, is_mirrored=True)
    validate_mirrored(p)
    return p


def _copy(p: Placement) -> dict[str, Instance]:
    return {
        iid: Instance(i.id, i.isolation_group, i.weight, dict(i.shards),
                      i.shard_set_id, i.endpoint)
        for iid, i in p.instances.items()
    }


def mirrored_add_group(p: Placement, new_members: list[Instance]) -> Placement:
    """A whole new shard set joins; it steals shards group-to-group from
    the most loaded sets.  Member k of the new set initializes from
    member k of the donor set (deterministic mirror pairing)."""
    if len(new_members) != p.replica_factor:
        raise ValueError(
            f"need RF={p.replica_factor} instances, got {len(new_members)}"
        )
    ssids = {i.shard_set_id for i in new_members}
    if len(ssids) != 1:
        raise ValueError("new members must share one shard_set_id")
    ssid = ssids.pop()
    insts = _copy(p)
    if ssid in {i.shard_set_id for i in insts.values()}:
        raise ValueError(f"shard set {ssid} already present")
    newcomers = [
        Instance(i.id, i.isolation_group, i.weight, {}, ssid, i.endpoint)
        for i in sorted(new_members, key=lambda i: i.id)
    ]
    for m in newcomers:
        insts[m.id] = m
    groups = _groups(insts.values())
    target = p.num_shards // len(groups)
    while len(newcomers[0].shards) < target:
        donors = max(
            (g for sid, g in groups.items() if sid != ssid),
            key=lambda g: len([a for a in g[0].shards.values()
                               if a.state == ShardState.AVAILABLE]),
        )
        movable = [s for s, a in donors[0].shards.items()
                   if a.state == ShardState.AVAILABLE
                   and s not in newcomers[0].shards]
        if not movable:
            break
        s = movable[0]
        for donor, taker in zip(donors, newcomers):
            donor.shards[s] = ShardAssignment(s, ShardState.LEAVING)
            taker.shards[s] = ShardAssignment(
                s, ShardState.INITIALIZING, donor.id
            )
    return Placement(insts, p.num_shards, p.replica_factor, p.version + 1,
                     is_mirrored=True)


def mirrored_remove_group(p: Placement, shard_set_id: int) -> Placement:
    """A whole shard set leaves; its shards move group-to-group onto the
    least loaded surviving sets with mirror pairing."""
    insts = _copy(p)
    groups = _groups(insts.values())
    if shard_set_id not in groups:
        raise ValueError(f"no shard set {shard_set_id}")
    leavers = groups.pop(shard_set_id)
    if not groups:
        raise ValueError("cannot remove the last shard set")
    for s in sorted(leavers[0].shards):
        dest = min(
            (g for g in groups.values() if s not in g[0].shards),
            key=lambda g: (_group_load(g), g[0].id),
            default=None,
        )
        if dest is None:
            raise ValueError(f"no destination shard set for shard {s}")
        for leaver, taker in zip(leavers, dest):
            leaver.shards[s] = ShardAssignment(s, ShardState.LEAVING)
            taker.shards[s] = ShardAssignment(
                s, ShardState.INITIALIZING, leaver.id
            )
    return Placement(insts, p.num_shards, p.replica_factor, p.version + 1,
                     is_mirrored=True)


def mirrored_replace_instance(p: Placement, leaving_id: str,
                              new: Instance) -> Placement:
    """A new instance takes a dead/retiring member's place within its
    shard set, streaming every shard from the surviving mirror peer
    (mirrored.go ReplaceInstances: replacements stay within the set)."""
    insts = _copy(p)
    leaver = insts[leaving_id]
    ssid = leaver.shard_set_id
    peers = [i for i in insts.values()
             if i.shard_set_id == ssid and i.id != leaving_id]
    newcomer = Instance(new.id, new.isolation_group, new.weight, {}, ssid,
                        new.endpoint)
    insts[new.id] = newcomer
    for s, a in list(leaver.shards.items()):
        leaver.shards[s] = ShardAssignment(s, ShardState.LEAVING)
        src = next(
            (pi.id for pi in peers
             if pi.shards.get(s, None) is not None
             and pi.shards[s].state == ShardState.AVAILABLE),
            leaving_id,
        )
        newcomer.shards[s] = ShardAssignment(s, ShardState.INITIALIZING, src)
    return Placement(insts, p.num_shards, p.replica_factor, p.version + 1,
                     is_mirrored=True)


def mirrored_mark_available(p: Placement, instance_id: str,
                            shard: int) -> Placement:
    """Cutover for mirrored moves: flips the Initializing shard on the
    target and clears the matching Leaving shard.  For group moves the
    Leaving holder IS the pairing source; for replacements the source is
    the surviving mirror (AVAILABLE there), so the Leaving shard is
    found on the retiring same-shard-set member instead."""
    insts = _copy(p)
    inst = insts[instance_id]
    a = inst.shards.get(shard)
    if a is None or a.state != ShardState.INITIALIZING:
        raise ValueError(f"shard {shard} not initializing on {instance_id}")
    inst.shards[shard] = ShardAssignment(shard, ShardState.AVAILABLE)
    cleared = False
    if a.source_id and a.source_id in insts:
        src = insts[a.source_id]
        if (shard in src.shards
                and src.shards[shard].state == ShardState.LEAVING):
            del src.shards[shard]
            cleared = True
    if not cleared:
        for i in insts.values():
            if (i.shard_set_id == inst.shard_set_id
                    and i.id != instance_id
                    and i.shards.get(shard) is not None
                    and i.shards[shard].state == ShardState.LEAVING):
                del i.shards[shard]
                break
    # A fully drained leaver (replacement/removal complete) exits the
    # placement — the reference drops instances with no shards left.
    for iid in [i.id for i in insts.values()
                if not i.shards and iid_all_leaving(p, i.id)]:
        del insts[iid]
    return Placement(insts, p.num_shards, p.replica_factor, p.version + 1,
                     is_mirrored=True)


def iid_all_leaving(p: Placement, iid: str) -> bool:
    """True when the instance's shards in the PRIOR placement were all
    Leaving — i.e. it was on its way out, not a zero-shard newcomer."""
    prior = p.instances.get(iid)
    return bool(prior and prior.shards) and all(
        a.state == ShardState.LEAVING for a in prior.shards.values()
    )
