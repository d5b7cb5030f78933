"""Columnar block model: the unit of data between storage and functions.
The counterpart of ``m3_tpu/query/block.py``.

A block is a (series x step) matrix of float64 samples on a regular step
grid, plus per-series metadata (tags); NaN marks a missing sample
(Prometheus staleness semantics).  ``RawBlock`` carries the irregular
raw datapoints (padded (S, P) with counts) that the temporal functions
read.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SeriesMeta:
    """Tags for one series (reference block.SeriesMeta)."""

    tags: tuple[tuple[bytes, bytes], ...]

    @classmethod
    def from_dict(cls, d: dict[bytes, bytes]) -> "SeriesMeta":
        return cls(tuple(sorted(d.items())))

    def as_dict(self) -> dict[bytes, bytes]:
        return dict(self.tags)

    def drop(self, names: set[bytes]) -> "SeriesMeta":
        return SeriesMeta(tuple((n, v) for n, v in self.tags if n not in names))

    def keep(self, names: set[bytes]) -> "SeriesMeta":
        return SeriesMeta(tuple((n, v) for n, v in self.tags if n in names))

    def drop_name(self) -> "SeriesMeta":
        return self.drop({b"__name__"})


def to_host(x) -> np.ndarray:
    """A tensor (on any device) or array as host numpy: the explicit
    device -> host copy that host code inside the engine makes once per
    block, never per row."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class Block:
    """Step-aligned block: values[s, t] at step_times[t] (NaN = no sample).

    ``values`` is a numpy array or a torch tensor.  The engine keeps
    blocks on its device between pipeline stages and makes one copy to
    host numpy at the query boundary (``materialized``)."""

    step_times: np.ndarray  # (T,) int64 UnixNanos
    values: np.ndarray | torch.Tensor  # (S, T) float64
    series: list[SeriesMeta]

    @property
    def num_series(self) -> int:
        return self.values.shape[0]

    @property
    def num_steps(self) -> int:
        return self.values.shape[1]

    def with_values(self, values, series: list[SeriesMeta] | None = None) -> "Block":
        return Block(self.step_times, values,
                     series if series is not None else self.series)

    def materialized(self) -> "Block":
        """Values as contiguous host float64 (the query-boundary sync)."""
        return Block(self.step_times,
                     np.ascontiguousarray(to_host(self.values), np.float64),
                     self.series)


@dataclasses.dataclass
class RawBlock:
    """Irregular raw datapoints per series, time-sorted and right-padded."""

    ts: np.ndarray  # (S, P) int64; padded tail = i64 max
    values: np.ndarray  # (S, P) float64
    counts: np.ndarray  # (S,) int64 real points per series
    series: list[SeriesMeta]

    @classmethod
    def from_lists(cls, pts: list[list[tuple[int, float]]],
                   series: list[SeriesMeta]) -> "RawBlock":
        S = len(pts)
        P = max((len(p) for p in pts), default=0)
        P = max(P, 1)
        ts = np.full((S, P), np.iinfo(np.int64).max, np.int64)
        vals = np.full((S, P), np.nan)
        counts = np.zeros(S, np.int64)
        for i, p in enumerate(pts):
            counts[i] = len(p)
            if p:
                ts[i, : len(p)] = [t for t, _ in p]
                vals[i, : len(p)] = [v for _, v in p]
        return cls(ts, vals, counts, series)
