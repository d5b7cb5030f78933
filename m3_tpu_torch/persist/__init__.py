"""Durable artifacts: filesets, commitlog, snapshots, digests.

Corruption contract (this package's robustness story): every integrity
check raises a typed :class:`~m3_tpu_torch.persist.corruption.CorruptionError`
(a ``ValueError`` subclass) carrying path/component/check, the storage
layer routes it to :mod:`m3_tpu_torch.persist.quarantine`, and the scrubber +
peer repair re-converge the hole — enforced statically by m3lint's
``corruption-typed`` rule.

The port's copy of ``m3_tpu/persist/__init__.py`` (it imports nothing of ``m3_tpu``).
"""

from m3_tpu_torch.persist.corruption import (
    ChecksumMismatch, CorruptionError, FormatCorruption,
)

__all__ = ["ChecksumMismatch", "CorruptionError", "FormatCorruption"]
