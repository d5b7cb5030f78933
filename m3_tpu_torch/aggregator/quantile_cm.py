"""Host-side Cormode–Muthukrishnan biased-quantile stream, faithful to the
reference (``src/aggregator/aggregation/quantile/cm/stream.go``).

The device path (arena.TimerArena) computes **exact** window quantiles via
sort — always within the CM eps bound — so this implementation exists as
(a) the parity oracle for tests comparing device quantiles against
reference-algorithm outputs, and (b) the fallback for host-only deploys.

Algorithm parity points:
* two buffers (bufLess/bufMore) around an insertion cursor, swapped on
  cursor reset (stream.go:96-116,428-432);
* insert walks the sample list forward, inserting each pending value v
  before the first sample >= v with (numRanks=1, delta=rank spread)
  (stream.go:280-338);
* compress walks backward merging samples whose combined rank span stays
  under the biased threshold (stream.go:342-401);
* quantile computation scans for the first sample whose maxRank exceeds
  rank+threshold/2 and returns the previous sample (stream.go:231-277).

Defaults mirror cm/options.go: eps=1e-3, insertAndCompressEvery=1024.

The port's copy of ``m3_tpu/aggregator/quantile_cm.py`` (pure Python):
the host parity oracle for the port's timer quantiles.
"""

from __future__ import annotations

import heapq
import math
from typing import List, Sequence

_MIN_SAMPLES_TO_COMPRESS = 3
DEFAULT_EPS = 1e-3
DEFAULT_INSERT_AND_COMPRESS_EVERY = 1024


class _Sample:
    __slots__ = ("value", "num_ranks", "delta", "prev", "next")

    def __init__(self, value: float = 0.0, num_ranks: int = 0, delta: int = 0):
        self.value = value
        self.num_ranks = num_ranks
        self.delta = delta
        self.prev: _Sample | None = None
        self.next: _Sample | None = None


class _SampleList:
    """Doubly-linked sample list (reference cm/list.go)."""

    __slots__ = ("head", "tail", "length")

    def __init__(self):
        self.head: _Sample | None = None
        self.tail: _Sample | None = None
        self.length = 0

    def push_back(self, s: _Sample) -> None:
        s.prev, s.next = self.tail, None
        if self.tail is not None:
            self.tail.next = s
        else:
            self.head = s
        self.tail = s
        self.length += 1

    def insert_before(self, s: _Sample, at: _Sample) -> None:
        prev = at.prev
        s.prev, s.next = prev, at
        at.prev = s
        if prev is not None:
            prev.next = s
        else:
            self.head = s
        self.length += 1

    def remove(self, s: _Sample) -> None:
        if s.prev is not None:
            s.prev.next = s.next
        else:
            self.head = s.next
        if s.next is not None:
            s.next.prev = s.prev
        else:
            self.tail = s.prev
        s.prev = s.next = None
        self.length -= 1


class Stream:
    """CM biased-quantile stream (reference cm/stream.go:41-59)."""

    def __init__(
        self,
        quantiles: Sequence[float],
        eps: float = DEFAULT_EPS,
        insert_and_compress_every: int = DEFAULT_INSERT_AND_COMPRESS_EVERY,
    ):
        self.quantiles = list(quantiles)
        self.eps = eps
        self.insert_and_compress_every = insert_and_compress_every
        self.samples = _SampleList()
        self.buf_less: List[float] = []  # min-heaps, as in cm/heap.go
        self.buf_more: List[float] = []
        self.insert_cursor: _Sample | None = None
        self.compress_cursor: _Sample | None = None
        self.compress_min_rank = 0
        self.num_values = 0
        self.insert_and_compress_counter = 0
        self.computed_quantiles = [math.nan] * len(self.quantiles)
        self.flushed = False

    # -- ingestion (stream.go:77-116) ------------------------------------

    def add(self, value: float) -> None:
        self.add_batch([value])

    def add_batch(self, values: Sequence[float]) -> None:
        self.flushed = False
        if not values:
            return
        i = 0
        if self.samples.length == 0:
            s = _Sample(values[0], 1, 0)
            self.samples.push_back(s)
            self.insert_cursor = self.samples.head
            self.num_values += 1
            i = 1

        insert_point_value = self.insert_cursor.value
        counter = self.insert_and_compress_counter
        for value in values[i:]:
            if value < insert_point_value:
                heapq.heappush(self.buf_less, value)
            else:
                heapq.heappush(self.buf_more, value)
            if counter == self.insert_and_compress_every:
                self._insert()
                self._compress()
                counter = 0
            counter += 1
        self.insert_and_compress_counter = counter

    # -- flush / query (stream.go:123-171) -------------------------------

    def flush(self) -> None:
        if self.flushed:
            return
        while self.buf_less or self.buf_more:
            if not self.buf_more:
                self._reset_insert_cursor()
            self._insert()
            self._compress()
        self._calc_quantiles()
        self.flushed = True

    def min(self) -> float:
        return self.quantile(0.0)

    def max(self) -> float:
        return self.quantile(1.0)

    def quantile(self, q: float) -> float:
        if q < 0.0 or q > 1.0:
            return math.nan
        if self.samples.length == 0:
            return 0.0
        if q == 0.0:
            return self.samples.head.value
        if q == 1.0:
            return self.samples.tail.value
        for i, qt in enumerate(self.quantiles):
            if qt >= q:
                return self.computed_quantiles[i]
        return math.nan

    # -- internals --------------------------------------------------------

    def _calc_quantiles(self) -> None:
        """stream.go:231-277."""
        if not self.quantiles or self.num_values == 0:
            return
        if self.num_values <= _MIN_SAMPLES_TO_COMPRESS:
            buf = []
            curr = self.samples.head
            while curr is not None:
                buf.append(curr.value)
                curr = curr.next
            n = len(buf)
            for i, q in enumerate(self.quantiles):
                idx = min(int(q * n), n - 1)
                self.computed_quantiles[i] = buf[idx]
            return

        thresholds = []
        for q in self.quantiles:
            rank = math.ceil(q * self.num_values)
            thresholds.append((rank, math.ceil(self._threshold(rank) / 2.0)))

        min_rank = 0
        max_rank = 0
        idx = 0
        curr = self.samples.head
        prev = self.samples.head
        while curr is not None and idx < len(self.computed_quantiles):
            max_rank = min_rank + curr.num_ranks + curr.delta
            rank, threshold = thresholds[idx]
            if max_rank > rank + threshold or min_rank > rank:
                self.computed_quantiles[idx] = prev.value
                idx += 1
            min_rank += curr.num_ranks
            prev = curr
            curr = curr.next

        for i in range(idx, len(thresholds)):
            rank, threshold = thresholds[i]
            if max_rank >= rank + threshold or min_rank > rank:
                self.computed_quantiles[i] = prev.value

    def _insert(self) -> None:
        """stream.go:280-338."""
        comp_value = (
            self.compress_cursor.value if self.compress_cursor is not None else math.nan
        )
        # Reference sorts bufMore descending and consumes from the end
        # (ascending); an ascending sort consumed front-to-back matches.
        vals = sorted(self.buf_more)
        pos = 0
        n = len(vals)

        while self.insert_cursor is not None and pos < n:
            curr = self.insert_cursor
            insert_point_value = curr.value
            while pos < n and vals[pos] <= insert_point_value:
                val = vals[pos]
                pos += 1
                s = _Sample(val, 1, curr.num_ranks + curr.delta - 1)
                self.samples.insert_before(s, curr)
                if comp_value >= val:  # NaN compare false, as in Go
                    self.compress_min_rank += 1
                self.num_values += 1
            self.insert_cursor = self.insert_cursor.next

        if self.insert_cursor is None and pos < n:
            back = self.samples.tail
            while pos < n and vals[pos] >= back.value:
                val = vals[pos]
                pos += 1
                s = _Sample(val, 1, 0)
                self.samples.push_back(s)
                back = self.samples.tail
                self.num_values += 1

        self.buf_more = []
        self._reset_insert_cursor()

    def _compress(self) -> None:
        """stream.go:342-397."""
        if self.samples.length < _MIN_SAMPLES_TO_COMPRESS:
            return
        if self.compress_cursor is None:
            self.compress_cursor = self.samples.tail.prev
            self.compress_min_rank = (
                self.num_values - 1 - self.compress_cursor.num_ranks
            )
            self.compress_cursor = self.compress_cursor.prev

        num_vals = self.num_values
        eps2 = 2.0 * self.eps
        while self.compress_cursor is not None and self.compress_cursor is not self.samples.head:
            curr = self.compress_cursor
            nxt = curr.next
            prev = curr.prev
            max_rank = self.compress_min_rank + curr.num_ranks + curr.delta

            threshold = None
            for q in self.quantiles:
                if max_rank >= int(q * num_vals):
                    quantile_min = int(eps2 * max_rank / q)
                else:
                    quantile_min = int(eps2 * (num_vals - max_rank) / (1.0 - q))
                if threshold is None or quantile_min < threshold:
                    threshold = quantile_min

            self.compress_min_rank -= curr.num_ranks
            test_val = curr.num_ranks + nxt.num_ranks + nxt.delta
            if threshold is not None and test_val <= threshold:
                if self.insert_cursor is curr:
                    self.insert_cursor = nxt
                nxt.num_ranks += curr.num_ranks
                self.samples.remove(curr)
            self.compress_cursor = prev

        if self.compress_cursor is self.samples.head:
            self.compress_cursor = None

    def _threshold(self, rank: int) -> int:
        """stream.go:403-423."""
        min_val = None
        eps2 = 2.0 * self.eps
        for q in self.quantiles:
            if rank >= int(q * self.num_values):
                quantile_min = int(eps2 * rank / q)
            else:
                quantile_min = int(eps2 * (self.num_values - rank) / (1.0 - q))
            if min_val is None or quantile_min < min_val:
                min_val = quantile_min
        return min_val if min_val is not None else 0

    def _reset_insert_cursor(self) -> None:
        self.buf_less, self.buf_more = self.buf_more, self.buf_less
        self.insert_cursor = self.samples.head
