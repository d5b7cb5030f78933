"""Anti-entropy repair + peers bootstrap across replica databases.
The port's counterpart of ``m3_tpu/storage/repair.py``.  Divergent
series merge through the scalar host codec (``encoding/m3tsz.py``), as
in the reference: repair streams host bytes and does not touch the
device.

Reference parity:

* `src/dbnode/storage/repair.go:115-246` — shardRepairer fetches block
  metadata (per-series checksums) from every replica, compares with
  `ReplicaMetadataComparer` (`repair.go:162`), and streams differing
  blocks, loading merged data back into the shard (`repair.go:348`).
* `src/dbnode/storage/bootstrap/bootstrapper/peers/source.go` — a node
  whose local filesets are missing (new node, wiped disk, placement
  add/replace) streams whole blocks from replica peers and persists
  them locally.

Replicas are *handles* exposing the block-level replication surface
(``list_block_filesets`` / ``block_metadata`` / ``read_block`` /
``write_block``): either local ``Database`` objects or
``server.rpc.RemoteDatabase`` connections to other node processes —
repair and peers bootstrap stream blocks over the wire exactly like the
reference's peer block streaming (`client/peer.go`,
`stream_blocks_*`), never by reading a peer's filesystem.  Metadata
compare is a dict diff over per-series adler32 digests — the digest the
reference filesets already carry (`src/dbnode/digest/digest.go:24-37`).
The device-side analogue (checksum compare across the replica mesh axis
over the replica devices) lives in ``m3_tpu_torch/parallel/replication.py``.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

from m3_tpu_torch.encoding.m3tsz import decode_series, encode_series
from m3_tpu_torch.persist.corruption import CorruptionError
from m3_tpu_torch.persist.digest import digest as checksum
from m3_tpu_torch.server.rpc import RemoteError
from m3_tpu_torch.storage.database import ShardNotOwnedError

# A replica is skipped/demoted on transport failure (ConnectionError),
# on application-level failure it reports (RemoteError: RPC_ERR frames
# — a remote replica's CorruptionError arrives as one of these), on a
# LOCAL handle's typed CorruptionError (a corrupt block under this very
# process), AND on the typed ShardNotOwnedError (the placement moved
# the shard off that replica — writing the merged block there would
# resurrect decommissioned data) — one bad replica must never abort the
# anti-entropy sweep, matching the reference's per-host fetch failure
# handling (src/dbnode/storage/repair.go:115-246).  The scrubber
# quarantines the local corruption separately; repair's job is only to
# keep sweeping.
_REPLICA_FAILURE = (ConnectionError, RemoteError, CorruptionError,
                    ShardNotOwnedError)


class RepairReport(dict):
    @property
    def converged(self) -> bool:
        return self["series_diff"] == 0 and self["blocks_missing"] == 0


def repair_shard_block(
    dbs: List[object], namespace: str, shard: int, block_start: int,
) -> RepairReport:
    """Compare one (shard, block) across replica handles; merge + rewrite
    where they diverge (repair.go:115-246 + the load at :348).

    Divergent replicas get a new fileset volume holding the union of all
    replicas' points (last-writer-wins per timestamp is unnecessary: the
    merge is per-timestamp first-seen, matching the session's read
    de-dup).  Returns counts; a second call reports convergence.
    Unreachable replicas are skipped (counted as blocks_missing) like
    the reference's per-host metadata fetch failures; a REACHABLE
    replica that merely lacks the fileset gets the merged block written
    so repair alone converges a blockless replica (the old behavior —
    peers bootstrap is only the startup fast path).
    """
    metas = []   # dict | None (reachable, no fileset) | DOWN
    DOWN = object()
    for db in dbs:
        try:
            metas.append(db.block_metadata(namespace, shard, block_start))
        except _REPLICA_FAILURE:
            metas.append(DOWN)
    present = [m for m in metas if m is not None and m is not DOWN]
    report = RepairReport(
        replicas=len(dbs),
        blocks_missing=sum(1 for m in metas if m is None or m is DOWN),
        series_checked=len(set().union(*present)) if present else 0,
        series_diff=0,
        repaired_replicas=0,
    )
    if not present:
        return report

    # Diff: any series whose checksum isn't identical on every replica
    # (missing counts as different) — ReplicaMetadataComparer semantics.
    # A series missing from one present replica yields {None, <ck>} here,
    # so missing-vs-present and checksum-mismatch are both caught.
    all_sids = sorted(set().union(*present))
    divergent = [
        sid
        for sid in all_sids
        if len({m.get(sid) for m in present}) > 1
    ]
    report["series_diff"] = len(divergent)
    # Stream + merge only when something repairable exists: a divergent
    # series, or a REACHABLE replica missing the block.  DOWN replicas
    # keep blocks_missing non-zero (convergence honestly unknown) but
    # cannot be written, so they must not trigger the expensive merge.
    reachable_missing = any(m is None for m in metas)
    if not divergent and not reachable_missing:
        return report

    # Merge pass: union every replica's points for the whole block
    # (streaming just the divergent series would also work; whole-block
    # union keeps the rewrite one volume bump, like the cold-flush merge).
    # A replica dying between metadata and streaming is demoted to DOWN.
    merged: Dict[bytes, Dict[int, float]] = {}
    for i, (db, meta) in enumerate(zip(dbs, metas)):
        if meta is None or meta is DOWN:
            continue
        try:
            block = db.read_block(namespace, shard, block_start)
        except _REPLICA_FAILURE:
            metas[i] = DOWN
            report["blocks_missing"] += 1
            continue
        for sid, seg in block:
            tgt = merged.setdefault(sid, {})
            for d in decode_series(seg):
                tgt.setdefault(d.timestamp, d.value)
    if not any(m is not None and m is not DOWN for m in metas):
        return report

    series = [
        (sid, encode_series(sorted(pts.items()), start=block_start))
        for sid, pts in sorted(merged.items())
    ]
    merged_ck = {sid: checksum(seg) for sid, seg in series}
    for db, meta in zip(dbs, metas):
        if meta is DOWN:
            continue  # unreachable: next sweep, after it rejoins
        if meta == merged_ck:
            continue  # already converged replica: no rewrite
        try:
            db.write_block(namespace, shard, block_start, series)
            report["repaired_replicas"] += 1
        except _REPLICA_FAILURE:
            continue
    return report


def repair_namespace(dbs: List[object], namespace: str,
                     num_shards: int | None = None) -> RepairReport:
    """Repair every flushed (shard, block) seen on any reachable replica.

    ``num_shards`` must be given when every handle is remote; otherwise
    it is read off the first local Database in ``dbs``."""
    if num_shards is None:
        num_shards = next(
            (db.namespaces[namespace].opts.num_shards
             for db in dbs if hasattr(db, "namespaces")), None,
        )
        if num_shards is None:
            raise ValueError(
                "repair_namespace: num_shards is required when every "
                "replica handle is remote"
            )
    total = RepairReport(
        replicas=len(dbs), blocks_missing=0, series_checked=0,
        series_diff=0, repaired_replicas=0,
    )
    for shard in range(num_shards):
        blocks = set()
        for db in dbs:
            try:
                blocks.update(
                    bs for bs, _ in db.list_block_filesets(namespace, shard)
                )
            except _REPLICA_FAILURE:
                continue
        for bs in sorted(blocks):
            rep = repair_shard_block(dbs, namespace, shard, bs)
            for k in ("blocks_missing", "series_checked", "series_diff",
                      "repaired_replicas"):
                total[k] += rep[k]
    return total


def peers_bootstrap(
    db, peers: List[object], namespace: str, num_shards: int | None = None,
    shards: "Iterable[int] | None" = None,
) -> Dict[str, int]:
    """Fill every (shard, block) fileset missing locally from a replica
    peer (bootstrapper/peers/source.go: stream blocks from peers and
    persist, used on node add/replace and after data loss).

    ``db`` is the local ``Database``; ``peers`` are replica handles
    (local or ``RemoteDatabase``).  Streams the peer's encoded segments
    verbatim — bit-identical blocks, so a follow-up repair pass reports
    convergence immediately.  Unreachable peers are skipped.

    Scope: only PLACEMENT-OWNED shards are copied.  ``shards`` names
    them explicitly; when None, the namespace's installed ownership
    (``Namespace.owned``) applies — a restarting node pulls exactly its
    shards, never every peer's full dataset (the reference's peers
    bootstrapper walks the topology's shard set for this node, not the
    shard space).  A namespace with no ownership installed (single-node
    / no placement) keeps the copy-everything behavior.
    """
    ns = db.namespaces[namespace]
    total = num_shards if num_shards is not None else ns.opts.num_shards
    if shards is None:
        shards = range(total) if ns.owned is None else sorted(ns.owned)
    copied_blocks = copied_series = 0
    for shard in sorted(shards):
        local = dict(db.list_block_filesets(namespace, shard))
        for peer in peers:
            if peer is None or peer is db:
                continue
            try:
                peer_blocks = peer.list_block_filesets(namespace, shard)
            except _REPLICA_FAILURE:
                continue
            for bs, _vol in peer_blocks:
                if bs in local:
                    continue
                try:
                    series = peer.read_block(namespace, shard, bs)
                except _REPLICA_FAILURE:
                    continue
                db.write_block(namespace, shard, bs, series)
                local[bs] = 0
                copied_blocks += 1
                copied_series += len(series)
    return {"blocks": copied_blocks, "series": copied_series}


def block_metadata(db, namespace: str, shard: int, block_start: int):
    """Back-compat shim over the handle method (old free-function API)."""
    return db.block_metadata(namespace, shard, block_start)
