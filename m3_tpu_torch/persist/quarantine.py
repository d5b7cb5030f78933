"""Quarantine: pull corrupt artifacts out of the live tree, atomically.

The reference deletes or re-fetches corrupt filesets; operators of real
clusters want the evidence kept (what rotted, when, which check caught
it) for postmortems and hardware triage.  A quarantined fileset volume
moves to::

    <root>/quarantine/<label>/<namespace>/<shard>/<block_start>-<volume>[-k]/
        fileset-...-checkpoint.db        (moved first: visibility gate)
        fileset-...-digest.db
        fileset-...-{info,index,data,summaries,bloom}.db
        reason.json                      (written last: entry commit)

``label`` is ``data`` for live filesets or ``snapshot-<seq>`` for
snapshot filesets.  The *checkpoint moves first*, mirroring
``remove_fileset``'s delete order: the instant it is gone the fileset
is invisible to ``list_filesets``, so a crash mid-quarantine leaves an
invisible (never half-readable) volume — the same atomicity story as
flush.  Moves are same-filesystem ``os.replace`` renames.

``reason.json`` carries the typed-error detail
(:meth:`CorruptionError.describe`) plus the coordinates, so the
``/health`` inventory and the scrubber's repair pass can enumerate
holes without re-verifying anything.

The port's copy of ``m3_tpu/persist/quarantine.py`` (it imports nothing of ``m3_tpu``).
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

from m3_tpu_torch.persist.capacity import capacity_guard
from m3_tpu_torch.persist.corruption import CorruptionError
from m3_tpu_torch.persist.fs import FILE_TYPES, fileset_path

REASON_FILE = "reason.json"


def quarantine_root(root) -> Path:
    return Path(root) / "quarantine"


def _unique_dir(base: Path) -> Path:
    """First non-existing ``base``[, ``base-2``, ``base-3``...] — the
    same (block, volume) can rot, heal via repair, and rot again."""
    if not base.exists():
        return base
    k = 2
    while (d := base.with_name(f"{base.name}-{k}")).exists():
        k += 1
    return d


def _reason(err, extra: dict) -> dict:
    detail = (err.describe() if isinstance(err, CorruptionError)
              else {"error_type": type(err).__name__, "error": str(err)}
              if err is not None else {})
    detail.update(extra)
    detail["quarantined_at"] = time.time()
    return detail


def quarantine_fileset(src_root, namespace: str, shard: int, block_start: int,
                       volume: int, err=None, *, qroot=None,
                       label: str = "data") -> Path | None:
    """Move one fileset volume into the quarantine tree; returns the
    quarantine directory, or None when no files existed to move.

    ``src_root`` is where the fileset lives (the data root, or a
    snapshot's data root); ``qroot`` is the database root owning the
    quarantine tree (defaults to ``src_root``)."""
    qdir = _unique_dir(
        quarantine_root(qroot if qroot is not None else src_root)
        / label / namespace / str(shard) / f"{block_start}-{volume}"
    )
    moved: list[str] = []
    # Checkpoint FIRST: once it is gone the volume is invisible, so a
    # crash mid-move can never leave a half-readable fileset behind.
    # Renames are same-filesystem (no new data blocks) but the reason
    # file is a fresh write, and directory entries cost metadata blocks
    # — on a truly full disk even these classify as capacity errors.
    with capacity_guard(path=qdir, component="quarantine", op="move"):
        for t in ("checkpoint", "digest") + FILE_TYPES:
            src = fileset_path(src_root, namespace, shard, block_start,
                               volume, t)
            if src.exists():
                qdir.mkdir(parents=True, exist_ok=True)
                os.replace(src, qdir / src.name)
                moved.append(src.name)
        if not moved:
            return None
        reason = _reason(err, {
            "kind": "fileset", "label": label, "namespace": namespace,
            "shard": shard, "block_start": block_start, "volume": volume,
            "files": moved,
        })
        (qdir / REASON_FILE).write_text(json.dumps(reason, indent=1))
    return qdir


def quarantine_snapshot(root, seq: int, err=None) -> Path | None:
    """Move one snapshot (meta file + data dir) into the quarantine
    tree — the META moves first, the snapshot's atomic visibility gate
    (mirror of the checkpoint-first fileset move).  Corrupt-meta
    snapshots keep their (possibly intact) data filesets as evidence
    instead of being destroyed; returns the quarantine dir or None when
    nothing existed."""
    meta = Path(root) / "snapshots" / f"meta-{seq}.db"
    data = Path(root) / "snapshots" / str(seq)
    qdir = _unique_dir(quarantine_root(root) / "snapshots" / str(seq))
    moved: list[str] = []
    with capacity_guard(path=qdir, component="quarantine", op="move"):
        for src in (meta, data):
            if src.exists():
                qdir.mkdir(parents=True, exist_ok=True)
                os.replace(src, qdir / src.name)
                moved.append(src.name)
        if not moved:
            return None
        reason = _reason(err, {"kind": "snapshot", "seq": seq, "files": moved})
        (qdir / REASON_FILE).write_text(json.dumps(reason, indent=1))
    return qdir


def list_quarantined(root) -> list[dict]:
    """Every quarantine entry's reason dict (plus its ``dir``), sorted
    by directory — the ``/health`` inventory and the scrubber's
    repair-pass worklist."""
    q = quarantine_root(root)
    if not q.exists():
        return []
    out = []
    for rf in sorted(q.rglob(REASON_FILE)):
        try:
            reason = json.loads(rf.read_text())
        except (OSError, json.JSONDecodeError):
            reason = {"kind": "unreadable-reason"}
        reason["dir"] = str(rf.parent)
        out.append(reason)
    return out
