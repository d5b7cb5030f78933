"""Strict Prometheus text-exposition parser + histogram merge helpers.
The port's copy of ``m3_tpu/instrument/exposition.py`` (it imports
nothing of ``m3_tpu``): the same grammar, so a port node's ``/metrics``
parses as the reference's does.

Two jobs, one grammar:

* **CI gate** — ``parse_text`` accepts exactly the text format a
  Prometheus scraper accepts (metric-name/label grammar, quoted+escaped
  label values, float samples) and additionally REJECTS what a lenient
  scraper would silently mis-ingest: duplicate series (same name +
  label set twice in one scrape) and malformed histograms (``_bucket``
  lanes whose ``le`` does not parse, are unordered, decrease, or lack
  the ``+Inf`` lane matching ``_count``).  A node's /metrics runs
  through it in the tests, so a new instrument that renders badly
  fails the day it lands, not when a dashboard goes blank.
* **Cross-node merge** — histograms share one fixed bucket ladder
  (instrument.HISTOGRAM_BOUNDS), so merging N nodes' scrapes is a
  vector add of bucket counts per ``le``: ``merge_histograms`` does
  exactly that and ``merged_quantile`` answers p50/p99 over the fleet —
  the source of merged latency SLOs across nodes.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Tuple

__all__ = [
    "ExpositionError", "Sample", "parse_text", "histogram_series",
    "merge_histograms", "merged_quantile", "delta_histogram",
    "fleet_summary", "counter_value",
]

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")
_LABEL_NAME_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*")
# one escaped label value: anything but raw backslash/quote/newline,
# or a recognized escape
_VALUE_CHUNK_RE = re.compile(r'(?:[^"\\\n]|\\\\|\\"|\\n)*')


class ExpositionError(ValueError):
    """The scrape violates the text exposition contract (bad grammar,
    duplicate series, malformed histogram)."""

    def __init__(self, lineno: int, msg: str):
        super().__init__(f"line {lineno}: {msg}")
        self.lineno = lineno


@dataclass(frozen=True)
class Sample:
    name: str
    labels: Tuple[Tuple[str, str], ...]  # sorted (name, unescaped value)
    value: float
    # Optional Prometheus sample timestamp (milliseconds since epoch):
    # the text format allows ``name{labels} value [timestamp_ms]``, and
    # the selfmon fleet scrape needs scrape-time stamping to survive a
    # slow/queued peer fetch — None when the line carried no timestamp
    # (our own /metrics never emits one).
    timestamp_ms: int | None = None

    def label(self, name: str, default: str | None = None) -> str | None:
        for k, v in self.labels:
            if k == name:
                return v
        return default


_UNESCAPE_RE = re.compile(r'\\(n|"|\\)')
_UNESCAPES = {"n": "\n", '"': '"', "\\": "\\"}


def _unescape(v: str) -> str:
    # single-pass, left-to-right: sequential str.replace corrupts a
    # literal backslash followed by 'n' ('C:\\network' escapes to
    # 'C:\\\\network'; replacing '\\n' first would cut a newline into
    # the middle of it)
    return _UNESCAPE_RE.sub(lambda m: _UNESCAPES[m.group(1)], v)


def _parse_labels(body: str, lineno: int) -> Tuple[Tuple[str, str], ...]:
    out: List[Tuple[str, str]] = []
    pos = 0
    while True:
        m = _LABEL_NAME_RE.match(body, pos)
        if not m:
            raise ExpositionError(lineno, f"bad label name at {body[pos:]!r}")
        lname = m.group(0)
        pos = m.end()
        if not body.startswith('="', pos):
            raise ExpositionError(lineno, f"label {lname}: expected =\"")
        pos += 2
        mv = _VALUE_CHUNK_RE.match(body, pos)
        pos = mv.end()
        if pos >= len(body) or body[pos] != '"':
            raise ExpositionError(
                lineno, f"label {lname}: unterminated/unescaped value")
        out.append((lname, _unescape(mv.group(0))))
        pos += 1
        if pos == len(body):
            return tuple(sorted(out))
        if body[pos] != ",":
            raise ExpositionError(lineno, f"junk after label {lname}")
        pos += 1


def _parse_value(text: str, lineno: int) -> float:
    t = text.strip()
    if t in ("+Inf", "Inf"):
        return math.inf
    if t == "-Inf":
        return -math.inf
    try:
        return float(t)
    except ValueError:
        raise ExpositionError(lineno, f"bad sample value {text!r}") from None


def parse_text(text: str) -> List[Sample]:
    """Parse one scrape strictly; raises :class:`ExpositionError` on any
    grammar violation, duplicate series, or malformed histogram."""
    samples: List[Sample] = []
    seen: set = set()
    for lineno, raw in enumerate(text.splitlines(), start=1):
        if not raw.strip() or raw.startswith("#"):
            continue
        if raw != raw.rstrip():
            raise ExpositionError(lineno, "trailing whitespace")
        line = raw
        m = _NAME_RE.match(line)
        if not m:
            raise ExpositionError(lineno, f"bad metric name: {line!r}")
        name = m.group(0)
        rest = line[m.end():]
        labels: Tuple[Tuple[str, str], ...] = ()
        if rest.startswith("{"):
            end = rest.rfind("}")
            if end < 0:
                raise ExpositionError(lineno, "unterminated label set")
            labels = _parse_labels(rest[1:end], lineno)
            rest = rest[end + 1:]
        if not rest.startswith(" "):
            raise ExpositionError(lineno, "expected space before value")
        # "<value>" or "<value> <timestamp_ms>" (Prometheus text format:
        # the optional trailing integer is milliseconds since epoch).
        # More than two fields is junk, and a malformed timestamp is a
        # typed rejection — a lenient scraper would mis-ingest it as
        # part of the value.
        fields = rest[1:].split()
        if not fields or len(fields) > 2:
            raise ExpositionError(
                lineno, f"expected 'value [timestamp_ms]', got {rest[1:]!r}")
        value = _parse_value(fields[0], lineno)
        timestamp_ms: int | None = None
        if len(fields) == 2:
            try:
                timestamp_ms = int(fields[1])
            except ValueError:
                raise ExpositionError(
                    lineno, f"bad sample timestamp {fields[1]!r} "
                            "(want integer milliseconds)") from None
        key = (name, labels)
        if key in seen:
            raise ExpositionError(
                lineno, f"duplicate series {name}{dict(labels)}")
        seen.add(key)
        samples.append(Sample(name, labels, value, timestamp_ms))
    _check_histograms(samples)
    return samples


def _strip_le(labels) -> Tuple[Tuple[str, str], ...]:
    return tuple((k, v) for k, v in labels if k != "le")


def _check_histograms(samples: List[Sample]) -> None:
    """Per (base name, non-le label set): le parses, lanes are strictly
    increasing in le, cumulative counts never decrease, +Inf exists and
    equals the series' _count."""
    buckets: Dict[tuple, List[Tuple[float, float, int]]] = {}
    counts: Dict[tuple, float] = {}
    for s in samples:
        if s.name.endswith("_bucket"):
            le_raw = s.label("le")
            if le_raw is None:
                raise ExpositionError(0, f"{s.name}: _bucket without le")
            le = _parse_value(le_raw, 0)
            key = (s.name[:-len("_bucket")], _strip_le(s.labels))
            buckets.setdefault(key, []).append((le, s.value, 0))
        elif s.name.endswith("_count"):
            counts[(s.name[:-len("_count")], s.labels)] = s.value
    for (base, labels), lanes in buckets.items():
        les = [le for le, _, _ in lanes]
        if len(set(les)) != len(les):
            raise ExpositionError(0, f"{base}: duplicate le lanes")
        ordered = sorted(lanes)
        if [c for _, c, _ in ordered] != sorted(c for _, c, _ in ordered):
            raise ExpositionError(
                0, f"{base}{dict(labels)}: bucket counts decrease with le")
        if not math.isinf(ordered[-1][0]):
            raise ExpositionError(0, f"{base}{dict(labels)}: no +Inf lane")
        total = counts.get((base, labels))
        if total is not None and total != ordered[-1][1]:
            raise ExpositionError(
                0, f"{base}{dict(labels)}: +Inf lane {ordered[-1][1]} "
                   f"!= _count {total}")


# -- cross-node histogram merge ---------------------------------------------


def histogram_series(samples: Iterable[Sample], base: str,
                     ) -> Dict[tuple, Dict[float, float]]:
    """``{non-le labelset: {le: cumulative count}}`` for one histogram
    base name out of a parsed scrape."""
    out: Dict[tuple, Dict[float, float]] = {}
    suffix = base + "_bucket"
    for s in samples:
        if s.name != suffix:
            continue
        le = _parse_value(s.label("le", "nan"), 0)
        out.setdefault(_strip_le(s.labels), {})[le] = s.value
    return out


def merge_histograms(scrapes: Iterable[List[Sample]], base: str,
                     ) -> Dict[float, float]:
    """Vector-add one histogram's cumulative ``le`` lanes across N
    parsed scrapes (all label sets of the base name folded together).
    Valid because every Histogram shares HISTOGRAM_BOUNDS — merge IS
    addition, no rebinning."""
    merged: Dict[float, float] = {}
    for samples in scrapes:
        for lanes in histogram_series(samples, base).values():
            for le, c in lanes.items():
                merged[le] = merged.get(le, 0.0) + c
    return merged


def merged_quantile(merged: Dict[float, float], q: float) -> float:
    """Quantile over merged cumulative lanes ({le: cumulative count})."""
    from m3_tpu_torch.instrument import quantile_from_buckets

    les = sorted(merged)
    noncum, prev = [], 0.0
    for le in les:
        noncum.append(max(0.0, merged[le] - prev))
        prev = merged[le]
    finite = [le for le in les if not math.isinf(le)]
    return quantile_from_buckets(noncum, q, bounds=tuple(finite))


# -- fleet scrapes under failure + phase windows -----------------------------
#
# The soak harness scrapes the fleet at PHASE boundaries — including
# mid-SIGKILL windows where a node is down, and post-restart windows
# where its cumulative counters went back to zero.  These helpers make
# both facts first-class instead of exceptions: a missing scrape yields
# a merged summary honestly flagged ``partial`` over the reachable
# majority, and a counter that went backwards is a detected restart
# (delta from zero), never a negative rate.


def delta_histogram(before: Dict[float, float] | None,
                    after: Dict[float, float]) -> tuple:
    """Phase delta of one node's cumulative lanes: ``after - before``
    per ``le``.  Returns ``(lanes, reset)`` — when any lane decreased
    the process restarted between scrapes, so the whole 'before' is
    discarded (the new process started from zero) and ``reset=True``
    tells the caller the window undercounts the pre-crash tail."""
    if before is None:
        return dict(after), False
    if any(after.get(le, 0.0) < c for le, c in before.items()):
        return dict(after), True
    return {le: c - before.get(le, 0.0) for le, c in after.items()}, False


def counter_value(samples: List[Sample] | None, name: str,
                  labels: Dict[str, str] | None = None) -> float:
    """Sum of one metric's samples across label sets (optionally
    filtered by a label subset) — 0.0 for a missing metric or a failed
    scrape, so counter-delta arithmetic stays total."""
    if samples is None:
        return 0.0
    total = 0.0
    for s in samples:
        if s.name != name:
            continue
        if labels and any(s.label(k) != v for k, v in labels.items()):
            continue
        total += s.value
    return total


def fleet_summary(scrapes: Dict[object, List[Sample] | None], base: str,
                  before: Dict[object, List[Sample] | None] | None = None,
                  quantiles: Iterable[float] = (0.5, 0.99)) -> dict:
    """Fleet-merged histogram summary that SURVIVES partial scrapes.

    ``scrapes`` maps a node key to its parsed scrape, or ``None`` when
    the node was unreachable (mid-SIGKILL / mid-restart — the soak
    scrapes during fault windows, so this path is hot).  With
    ``before`` (the previous phase boundary), per-node lanes are
    DELTA'd first (restart-aware via :func:`delta_histogram`) so the
    summary covers one phase, not the whole run.  Returns::

        {"count", "quantiles": {"p50": s, ...}, "partial": bool,
         "reachable": [keys], "unreachable": [keys], "resets": [keys]}

    Never raises on a down node and never merges a guess: an
    unreachable node simply contributes nothing, flagged."""
    merged: Dict[float, float] = {}
    reachable, unreachable, resets = [], [], []
    for key in sorted(scrapes, key=str):
        samples = scrapes[key]
        if samples is None:
            unreachable.append(key)
            continue
        reachable.append(key)
        prev = (before or {}).get(key)
        prev_lanes: Dict[float, float] = {}
        if prev is not None:
            for lanes in histogram_series(prev, base).values():
                for le, c in lanes.items():
                    prev_lanes[le] = prev_lanes.get(le, 0.0) + c
        node_lanes: Dict[float, float] = {}
        for lanes in histogram_series(samples, base).values():
            for le, c in lanes.items():
                node_lanes[le] = node_lanes.get(le, 0.0) + c
        lanes, reset = delta_histogram(prev_lanes if prev is not None else None,
                                       node_lanes)
        if reset:
            resets.append(key)
        for le, c in lanes.items():
            merged[le] = merged.get(le, 0.0) + c
    count = max((c for le, c in merged.items() if math.isinf(le)),
                default=0.0)
    out = {
        "count": count,
        "quantiles": {},
        "partial": bool(unreachable),
        "reachable": reachable,
        "unreachable": unreachable,
        "resets": resets,
    }
    for q in quantiles:
        out["quantiles"][f"p{int(q * 100)}"] = (
            merged_quantile(merged, q) if count > 0 else None)
    return out
