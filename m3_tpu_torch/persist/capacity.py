"""Typed disk-capacity errors for every persisted artifact.

The reference runs ``storage/cleanup.go`` and commitlog retention
precisely because a dbnode that fills its disk dies mid-flush
(`src/dbnode/storage/cleanup.go`, `src/dbnode/persist/fs/write.go`
error paths).  Before this module an ENOSPC anywhere in ``persist/``
surfaced as a raw ``OSError`` that killed whatever flush, snapshot,
WAL append, or checkpoint hit it — indistinguishable from a permission
error, invisible to the shed/reclaim machinery, and prone to leaving a
half-written ``*.tmp`` file beside the real artifact.

:class:`DiskCapacityError` subclasses ``OSError`` ON PURPOSE: every
existing ``except OSError`` site keeps working, and the RPC server's
application-error mapping (``server/rpc.py`` → ``RPC_ERR`` frame →
``RemoteError`` on the client) is unchanged — a replica out of disk
still surfaces as a per-replica failure the consistency level absorbs.
What changes is that *local* handlers can now catch exactly the
capacity class and route it to the disk-pressure machinery
(``x/diskbudget.py``) instead of letting it abort a tick.

Use :func:`capacity_guard` around a write/fsync/rename site: it
classifies ENOSPC/EDQUOT into the typed error, unlinks the atomic-write
temp file so the error path never litters, and bumps a per-component
counter mirrored onto /metrics.  :func:`sweep_temp_files` removes any
survivors (hard kill between write and classify) at bootstrap.

The m3lint ``enospc-typed`` rule makes this permanent: a write/fsync/
rename site under ``m3_tpu/persist/`` (or the aggregator checkpoint)
outside a ``capacity_guard`` block is a gate failure.

The port's copy of ``m3_tpu/persist/capacity.py`` (it imports nothing of ``m3_tpu``).
"""

from __future__ import annotations

import contextlib
import errno
import os
import threading
from pathlib import Path

from m3_tpu_torch.x import fault

__all__ = [
    "CAPACITY_ERRNOS",
    "DiskCapacityError",
    "capacity_guard",
    "counters",
    "inject",
    "reset",
    "sweep_temp_files",
]

# The two "disk is full" errnos: no space on the filesystem, and the
# (user or project) quota exceeded.  Everything else an OSError can
# carry (EACCES, EIO, ...) is NOT a capacity problem and must keep its
# original type — shedding ingest will not fix a dying disk.
CAPACITY_ERRNOS = (errno.ENOSPC, errno.EDQUOT)

_lock = threading.Lock()
_by_component: dict[str, int] = {}


class DiskCapacityError(OSError):
    """A write to persistent storage failed because the disk is full.

    ``path`` is the file being written (when known), ``component`` the
    artifact family (``fileset`` / ``snapshot`` / ``commitlog`` /
    ``checkpoint`` / ``quarantine``), and ``op`` the operation that hit
    the wall (``write`` / ``fsync`` / ``rename``) — enough for a log
    line or /health entry to say *what* ran out of room without a
    stack trace.
    """

    def __init__(self, message: str, *, path=None, component: str | None = None,
                 op: str | None = None, err: int = errno.ENOSPC):
        super().__init__(err, message)
        self.path = str(path) if path is not None else None
        self.component = component
        self.op = op

    def describe(self) -> dict:
        """JSON-ready detail for logs / the /health disk section."""
        return {
            "error_type": type(self).__name__,
            "error": str(self),
            "errno": self.errno,
            "path": self.path,
            "component": self.component,
            "op": self.op,
        }


@contextlib.contextmanager
def capacity_guard(path=None, component: str | None = None,
                   op: str | None = None, cleanup=()):
    """Classify ENOSPC/EDQUOT from the wrapped write site.

    On a capacity errno: unlink every path in ``cleanup`` (the atomic-
    write temp files — best effort, so the error path never litters),
    bump the per-component counter, and re-raise as
    :class:`DiskCapacityError` chained to the original.  Any other
    ``OSError`` (and an already-typed capacity error from a nested
    guard) passes through untouched.
    """
    try:
        yield
    except DiskCapacityError:
        raise
    except OSError as e:
        if e.errno not in CAPACITY_ERRNOS:
            raise
        for p in cleanup:
            try:
                os.unlink(p)
            except OSError:
                pass
        with _lock:
            key = component or "unknown"
            _by_component[key] = _by_component.get(key, 0) + 1
        where = f" ({path})" if path is not None else ""
        raise DiskCapacityError(
            f"disk capacity exhausted during {component or 'write'}"
            f" {op or 'write'}{where}: {e.strerror or e}",
            path=path, component=component, op=op, err=e.errno,
        ) from e


def inject(point: str) -> None:
    """Blessed faultpoint → ENOSPC bridge for the torn-write matrix.

    ``fault.fire`` raises :class:`~m3_tpu_torch.x.fault.FaultInjected` (a
    ``ConnectionError``) in error mode; persistence call sites need a
    *capacity* fault instead, flowing through the same ``except
    OSError`` classification as a real full disk.  Call this inside a
    ``capacity_guard`` block, before the real write.
    """
    try:
        fault.fire(point)
    except fault.FaultInjected:
        raise OSError(  # noqa: TRY003 — classified by the enclosing guard
            errno.ENOSPC, f"injected by faultpoint {point}: no space left"
        ) from None


def counters() -> dict:
    """Flat counter dict for /metrics mirroring: ``<component>.enospc``."""
    with _lock:
        return {f"{k}.enospc": v for k, v in sorted(_by_component.items())}


def reset() -> None:
    """Test hook: zero the per-component counters."""
    with _lock:
        _by_component.clear()


# Directories under a node root that atomic writers put temp files in.
# data/ holds fileset volumes + digests, snapshots/ the snapshot metas,
# checkpoint/ the aggregator arena (mkstemp names: ``<name>.tmpXXXXXX``),
# commitlogs/ is append-only today but swept for future-proofing.
_SWEEP_DIRS = ("data", "snapshots", "commitlogs", "checkpoint")


def sweep_temp_files(root) -> list[str]:
    """Remove atomic-write temp files left by a crash mid-write.

    Both temp shapes are covered: ``fs._write_atomic``'s fixed
    ``<name>.tmp`` suffix and the aggregator checkpoint's
    ``mkstemp``-randomized ``<name>.tmpXXXXXX``.  A temp file is dead
    by construction — the ``os.replace`` that would have published it
    never ran — so unconditional removal is safe.  Returns the removed
    paths (for the bootstrap log line).
    """
    removed: list[str] = []
    root = Path(root)
    for sub in _SWEEP_DIRS:
        base = root / sub
        if not base.is_dir():
            continue
        for tmp in sorted(base.rglob("*.tmp*")):
            if not tmp.is_file():
                continue
            try:
                tmp.unlink()
                removed.append(str(tmp))
            except OSError:
                pass
    return removed
