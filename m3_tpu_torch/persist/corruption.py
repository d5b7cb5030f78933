"""Typed corruption errors for every persisted artifact.

The reference treats on-disk corruption as an *expected, recoverable*
event: filesets are checksum-verified on read and a failed verify is
handled (skip + repair from peers), never a process abort
(`src/dbnode/persist/fs/read.go` digest verification,
`src/dbnode/storage/repair.go`).  Before this module every verify site
in ``persist/`` raised a bare ``ValueError``, indistinguishable from an
argument error — callers could not tell "this volume is bit-rotted,
quarantine it and fall back" from "you passed garbage".

:class:`CorruptionError` subclasses ``ValueError`` ON PURPOSE: every
existing ``except ValueError`` site keeps working, and the RPC server's
application-error mapping (``server/rpc.py`` → ``RPC_ERR`` frame →
``RemoteError`` on the client) is unchanged — a remote replica serving
a corrupt block still surfaces as a ``RemoteError`` the repair sweep
demotes.  What changes is that *local* handlers can now catch exactly
the corruption class and route it to quarantine
(``persist/quarantine.py``) instead of letting it abort a bootstrap or
fail a query.

The m3lint ``corruption-typed`` rule makes this permanent: a
digest/checksum/magic verify under ``m3_tpu/persist/`` raising a bare
``ValueError`` is a gate failure.

The port's copy of ``m3_tpu/persist/corruption.py`` (it imports nothing of ``m3_tpu``).
"""

from __future__ import annotations

__all__ = ["CorruptionError", "ChecksumMismatch", "FormatCorruption"]


class CorruptionError(ValueError):
    """A persisted artifact failed an integrity check.

    ``path`` is the offending file (when known), ``component`` the
    artifact family (``fileset`` / ``snapshot.meta`` / ``commitlog`` /
    ``bloom``), and ``check`` the specific verification that failed
    (``checkpoint``, ``digest:data``, ``segment-checksum``,
    ``info-magic``, ...) — enough for a quarantine reason file to say
    *why* a volume was pulled without re-running the verify.
    """

    def __init__(self, message: str, *, path=None, component: str | None = None,
                 check: str | None = None):
        super().__init__(message)
        self.path = str(path) if path is not None else None
        self.component = component
        self.check = check

    def describe(self) -> dict:
        """JSON-ready detail for quarantine reason files / logs."""
        return {
            "error_type": type(self).__name__,
            "error": str(self),
            "path": self.path,
            "component": self.component,
            "check": self.check,
        }


class ChecksumMismatch(CorruptionError):
    """Stored digest/checksum does not match the bytes on disk (bit
    rot, torn write past the checkpoint, or an injected corrupt
    fault)."""


class FormatCorruption(CorruptionError):
    """The artifact's framing is invalid: wrong magic, unsupported
    version, or a truncated/torn structure."""
