"""Query fanout: multi-namespace, resolution-aware fetch + merge.

Reference parity: `src/query/storage/fanout/storage.go:50,110,540` (fan
queries across local namespaces and remote stores, merge results) and
the namespace resolution logic of `src/query/storage/m3/storage.go:215-225`
(pick, per query window, which retention/resolution namespaces must be
consulted; consolidate multi-resolution data).

Selection rule (resolveClusterNamespacesForQuery distilled):

* Sources are (storage, resolution, retention) triples — e.g. the raw
  10s/2d namespace plus downsampled 1m/30d and 1h/1y namespaces the
  coordinator's rollup rules populate.
* The finest-resolution source whose retention covers the whole query
  window serves it alone (fast path — no merge cost).
* Otherwise the window is partitioned into disjoint time bands, one per
  source: the finest source serves the most recent band (everything its
  retention covers), each coarser source serves only the strictly older
  band beyond the next-finer source's retention.  Bands never overlap,
  so coarse aggregate samples can never interleave with raw samples
  over the same interval — the consolidation-by-coverage the reference
  does when mixing resolutions.

Overload contract: multi-source fetches run **concurrently**, each
bounded by the query's shared deadline (x/deadline; workers re-bind the
context since threads do not inherit it), so total fetch wall-clock is
the slowest source, never the sum.  Partial-result policy mirrors the
reference's fanout warnings: a **required** source that fails or misses
the deadline fails the query (typed :class:`PartialResultError`, or the
underlying ``DeadlineExceeded``); a non-required source (a remote
region, a coarse historical namespace) degrades to a ``warnings`` entry
on the bound deadline, surfaced through the HTTP response.

The port's copy of ``m3_tpu/query/fanout.py`` (host code over the port's
``RawBlock``, ``series_merge`` and ``x/deadline``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Sequence

from m3_tpu_torch.query.block import RawBlock, SeriesMeta
from m3_tpu_torch.storage.series_merge import merge_point_sources
from m3_tpu_torch.x import deadline as xdeadline
from m3_tpu_torch.x.deadline import DeadlineExceeded


class PartialResultError(RuntimeError):
    """A REQUIRED fanout source failed or missed the deadline — the
    merged result would silently be missing data the caller considers
    load-bearing.  Carries the per-source failures."""

    def __init__(self, failures: Dict[str, Exception]):
        detail = "; ".join(f"{k}: {v}" for k, v in sorted(failures.items()))
        super().__init__(f"partial result: {detail}")
        self.failures = failures


def _failure_error(failures: Dict[str, Exception]) -> Exception:
    """The exception for a set of load-bearing source failures.  A LONE
    overload-typed error stays itself (``DeadlineExceeded`` → 504,
    ``QueryLimitExceeded`` → 429); everything else — transport errors,
    open breakers, multi-source mixes — wraps in
    :class:`PartialResultError` so the API maps it as a server-side
    condition (502/504/429), never a 400."""
    if len(failures) == 1:
        from m3_tpu_torch.storage.limits import QueryLimitExceeded

        only = next(iter(failures.values()))
        if isinstance(only, (DeadlineExceeded, QueryLimitExceeded)):
            return only
    return PartialResultError(failures)


@dataclasses.dataclass(frozen=True)
class FanoutSource:
    """One queryable namespace (or remote store) + its storage policy.
    ``required=False`` sources (remote regions, historical coarse
    namespaces) degrade to a warning instead of failing the query."""

    storage: object  # fetch_raw(name, matchers, start, end) -> RawBlock
    resolution_nanos: int
    retention_nanos: int
    required: bool = True
    name: str = ""

    def label(self, i: int) -> str:
        return self.name or f"source[{i}]"


def _accumulate_block(blk: RawBlock, per_series: Dict[tuple, List[List[tuple]]]) -> None:
    """Unpack one RawBlock's series into the shared (tags -> point-list
    sources) accumulator both fanout shapes merge from."""
    for i, meta in enumerate(blk.series):
        c = int(blk.counts[i])
        pts = list(zip(blk.ts[i, :c].tolist(), blk.values[i, :c].tolist()))
        per_series.setdefault(meta.tags, []).append(pts)


def _merged_block(per_series: Dict[tuple, List[List[tuple]]]) -> RawBlock:
    keys = sorted(per_series)
    pts_out = [merge_point_sources(per_series[k]) for k in keys]
    return RawBlock.from_lists(pts_out, [SeriesMeta(k) for k in keys])


def _fetch_concurrent(jobs: List[tuple]) -> List:
    """Run ``(label, fn)`` jobs concurrently under the caller's bound
    deadline.  Returns a parallel list of results/exceptions.  Join
    waits are deadline-bounded: a worker still running once the budget
    is spent is recorded as ``DeadlineExceeded`` (its wire call carries
    its own deadline-derived socket timeout, so the thread itself
    unwinds cooperatively rather than leaking forever)."""
    dl = xdeadline.current()
    if len(jobs) == 1:
        label, fn = jobs[0]
        try:
            return [fn()]
        except Exception as e:  # noqa: BLE001 — classified by caller
            return [e]
    out: List = [None] * len(jobs)
    # Slot protocol: once the main thread gives up on a straggler and
    # claims its slot as DeadlineExceeded, the still-running worker must
    # never overwrite it (the caller is already classifying `out`); a
    # worker that lands BEFORE the claim keeps its real result.
    done = [False] * len(jobs)
    claimed = [False] * len(jobs)
    mu = threading.Lock()

    def run(i: int, fn: Callable[[], RawBlock]) -> None:
        # threads do NOT inherit contextvars: re-bind the shared
        # deadline so every source's wire hops stay budget-bounded
        try:
            with xdeadline.bind(dl):
                r: object = fn()
        except Exception as e:  # noqa: BLE001 — classified by caller
            r = e
        with mu:
            if not claimed[i]:
                out[i] = r
                done[i] = True

    threads = [
        threading.Thread(target=run, args=(i, fn), daemon=True,
                         name=f"fanout-{label}")
        for i, (label, fn) in enumerate(jobs)
    ]
    for t in threads:
        t.start()
    for i, t in enumerate(threads):
        if dl is None:
            t.join()
            continue
        t.join(max(dl.remaining(), 0.0))
        if t.is_alive():
            # cooperative: the worker's own socket timeout/check will
            # unwind it; the QUERY must answer now (dl.exceeded so N
            # stragglers still count as ONE blown deadline)
            with mu:
                if not done[i]:
                    claimed[i] = True
                    out[i] = dl.exceeded(
                        f"fanout source {jobs[i][0]}: deadline exceeded")
    return out


class FanoutStorage:
    """Engine-facing Storage over multiple namespaces/remotes."""

    def __init__(
        self,
        sources: Sequence[FanoutSource],
        now_fn: Callable[[], int] = time.time_ns,
    ):
        if not sources:
            raise ValueError("fanout needs at least one source")
        # finest resolution first
        self.sources = sorted(sources, key=lambda s: s.resolution_nanos)
        # Retention is measured from wall-clock now, NOT the query end:
        # a short window queried far in the past would otherwise look
        # "covered" by the raw namespace that retains nothing that old.
        self.now_fn = now_fn

    def _select(
        self, start_nanos: int, end_nanos: int, now_nanos: int
    ) -> List[FanoutSource]:
        """Sources needed for the query window: the finest source serves
        alone when its retention covers the whole window; otherwise all
        overlapping sources, band-partitioned in fetch_raw (each range
        gets the finest data available for it; sources whose band comes
        out empty are skipped there, so no spurious coarse fetches)."""
        finest = self.sources[0]
        if now_nanos - finest.retention_nanos <= start_nanos:
            return [finest]
        return [
            s
            for s in self.sources
            if now_nanos - s.retention_nanos < end_nanos
        ]

    def fetch_raw(
        self,
        name,
        matchers,
        start_nanos: int,
        end_nanos: int,
        now_nanos: int | None = None,
    ) -> RawBlock:
        now = self.now_fn() if now_nanos is None else now_nanos
        chosen = self._select(start_nanos, end_nanos, now)
        if len(chosen) == 1:
            # Same failure policy as the fanned path: required sources
            # fail typed (never a client-error mapping), best-effort
            # sources degrade to a warning + empty result.
            src = chosen[0]
            try:
                return src.storage.fetch_raw(
                    name, matchers, start_nanos, end_nanos
                )
            except Exception as e:  # noqa: BLE001 — classified below
                if src.required:
                    raise _failure_error({src.label(0): e})
                dl = xdeadline.current()
                if dl is not None:
                    dl.add_warning(
                        f"fanout source {src.label(0)} skipped: {e}")
                return _merged_block({})
        # Band partition: finest source serves its whole covered range;
        # each coarser source only the strictly older remainder.  Bands
        # are disjoint, so no cross-resolution interleaving can occur.
        jobs: List[tuple] = []
        bands: List[FanoutSource] = []
        hi = end_nanos
        for i, src in enumerate(chosen):  # finest → coarsest
            lo = max(start_nanos, now - src.retention_nanos)
            if lo < hi:
                jobs.append((
                    src.label(i),
                    (lambda s=src, a=lo, b=hi:
                     s.storage.fetch_raw(name, matchers, a, b)),
                ))
                bands.append(src)
            hi = min(hi, lo)
            if hi <= start_nanos:
                break
        per_series: Dict[tuple, List[List[tuple]]] = {}
        failures: Dict[str, Exception] = {}
        dl = xdeadline.current()
        for (label, _), src, result in zip(jobs, bands,
                                           _fetch_concurrent(jobs)):
            if isinstance(result, Exception):
                if src.required:
                    failures[label] = result
                elif dl is not None:
                    dl.add_warning(f"fanout source {label} skipped: {result}")
                continue
            _accumulate_block(result, per_series)
        if failures:
            raise _failure_error(failures)
        return _merged_block(per_series)


class FederatedStorage:
    """Cross-region union: query EVERY store and merge same-ID series.

    The band-partitioned FanoutStorage above divides a window between
    resolutions of the SAME data; federation is the other axis — each
    store (the local fanout + remote coordinators, `query/remote`) holds
    DIFFERENT series, with possible overlap deduplicated point-wise
    (reference `fanout/storage.go` merging local clusters with remote
    stores).  Stores are queried CONCURRENTLY under the bound deadline.
    A store that fails is skipped (best-effort federation, like the
    reference's partial-result handling, with a ``warnings`` entry on
    the bound deadline) unless every store fails — except stores listed
    in ``required`` (by index), whose failure is load-bearing and
    raises :class:`PartialResultError`."""

    def __init__(self, stores: Sequence[object],
                 required: Sequence[int] = ()):
        if not stores:
            raise ValueError("federation needs at least one store")
        self.stores = list(stores)
        self.required = frozenset(required)

    @staticmethod
    def _store_label(i: int, st: object) -> str:
        peer = getattr(st, "peer", None)
        return f"store[{i}]({peer})" if peer else f"store[{i}]"

    def fetch_raw(self, name, matchers, start_nanos, end_nanos) -> RawBlock:
        jobs = [
            (self._store_label(i, st),
             (lambda s=st: s.fetch_raw(name, matchers, start_nanos,
                                       end_nanos)))
            for i, st in enumerate(self.stores)
        ]
        results = _fetch_concurrent(jobs)
        per_series: Dict[tuple, List[List[tuple]]] = {}
        all_failures: Dict[str, Exception] = {}
        required_failures: Dict[str, Exception] = {}
        dl = xdeadline.current()
        for i, ((label, _), result) in enumerate(zip(jobs, results)):
            if isinstance(result, Exception):
                all_failures[label] = result
                if i in self.required:
                    required_failures[label] = result
                elif dl is not None:
                    dl.add_warning(
                        f"federated store {label} skipped: {result}")
                continue
            _accumulate_block(result, per_series)
        if required_failures:
            raise _failure_error(required_failures)
        if all_failures and len(all_failures) == len(self.stores):
            # EVERY store failed: nothing merged, surface typed too
            raise _failure_error(all_failures)
        return _merged_block(per_series)
