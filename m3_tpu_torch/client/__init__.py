"""Clients: the replicated dbnode session (reference `src/dbnode/client`)
and the aggregator tier's client (reference `src/aggregator/client`)."""

from m3_tpu_torch.client.session import (
    ConsistencyError,
    ConsistencyLevel,
    ReplicatedSession,
)

__all__ = ["ConsistencyError", "ConsistencyLevel", "ReplicatedSession"]
