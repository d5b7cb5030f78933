"""Multi-window multi-burn-rate SLO rules over self-monitored series.
The port's copy of ``m3_tpu/query/slo.py``: the rules, windows and
verdict documents are the reference's, and each window's ratio runs
through the port's ``Engine`` on the engine's device.

The Google SRE-workbook alerting shape (chapter 5): an SLO with
objective ``o`` has an error budget ``1 - o``; a rule fires when the
measured bad-event ratio burns that budget faster than a threshold
``factor`` over BOTH a long window (sustained, low false-positive) and
a short window (still happening, fast reset).  Classic pairs:
``(1h, 5m, 14.4x)`` pages, ``(6h, 30m, 6x)`` tickets.

Rules here are declarative and PromQL-native: ``ratio`` is a PromQL
expression template computing the bad-event FRACTION over a window,
with the literal token ``{window}`` substituted per evaluation (plain
``str.replace`` — label matchers' braces are untouched, unlike
``str.format``).  The evaluator runs every rule's window queries
through the ordinary :class:`~m3_tpu_torch.query.engine.Engine` instant path
over the ``_m3_selfmon`` namespace under ONE ``x/deadline`` budget —
a slow/expensive rule set degrades to a typed partial verdict, never a
stalled mediator tick.  Verdicts are cached for ``/health``'s ``slo``
section and mirrored as ``slo_burn{rule=...}`` gauges, which the next
selfmon scrape writes BACK into storage — burn history is itself one
PromQL query away (``max_over_time(m3tpu_slo_burn[1h])``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Iterable, List, Tuple

import numpy as np

from m3_tpu_torch.core.config import ConfigError, parse_duration
from m3_tpu_torch.query.block import to_host
from m3_tpu_torch.x import deadline as xdeadline
from m3_tpu_torch.x.deadline import Deadline, DeadlineExceeded

__all__ = ["BurnWindow", "SLORule", "SLOEvaluator", "rule_from_dict",
           "default_rules", "latency_ratio"]

_WINDOW_TOKEN = "{window}"


@dataclasses.dataclass(frozen=True)
class BurnWindow:
    """One (long, short, factor) pair: the rule fires on this pair when
    the ratio over BOTH windows is at least ``factor x error budget``."""

    long: str            # e.g. "1h"
    short: str           # e.g. "5m"
    factor: float        # burn-rate threshold (x budget)

    def __post_init__(self):
        for f in ("long", "short"):
            try:
                parse_duration(getattr(self, f))
            except ConfigError as e:
                raise ValueError(f"burn window {f}: {e}") from None
        if parse_duration(self.short) > parse_duration(self.long):
            raise ValueError(
                f"burn window short {self.short!r} exceeds long {self.long!r}")
        if self.factor <= 0:
            raise ValueError("burn window factor must be > 0")


# The SRE-workbook default ladder: page on fast burn, ticket on slow.
DEFAULT_WINDOWS: Tuple[BurnWindow, ...] = (
    BurnWindow("1h", "5m", 14.4),
    BurnWindow("6h", "30m", 6.0),
)


@dataclasses.dataclass(frozen=True)
class SLORule:
    """One burn-rate rule: ``ratio`` computes the bad-event fraction
    over a ``{window}``; the objective fixes the budget it burns."""

    name: str
    objective: float                       # e.g. 0.999
    ratio: str                             # PromQL template with {window}
    windows: Tuple[BurnWindow, ...] = DEFAULT_WINDOWS

    def __post_init__(self):
        if not self.name:
            raise ValueError("SLO rule needs a name")
        if not (0.0 < self.objective < 1.0):
            raise ValueError(
                f"rule {self.name}: objective must be in (0, 1), "
                f"got {self.objective}")
        if _WINDOW_TOKEN not in self.ratio:
            raise ValueError(
                f"rule {self.name}: ratio template must contain "
                f"'{_WINDOW_TOKEN}'")
        if not self.windows:
            raise ValueError(f"rule {self.name}: at least one burn window")

    @property
    def budget(self) -> float:
        return 1.0 - self.objective

    def query(self, window: str) -> str:
        return self.ratio.replace(_WINDOW_TOKEN, window)


def rule_from_dict(d: dict) -> SLORule:
    """Config-dict → rule (the ``selfmon.rules`` entries).  Eager and
    total like the chaos-timeline parser: a typo'd key or malformed
    window fails at config-validate time, never mid-tick."""
    unknown = set(d) - {"name", "objective", "ratio", "windows"}
    if unknown:
        raise ValueError(f"SLO rule: unknown keys {sorted(unknown)}")
    windows: Tuple[BurnWindow, ...] = DEFAULT_WINDOWS
    if "windows" in d:
        ws = []
        for i, w in enumerate(d["windows"]):
            bad = set(w) - {"long", "short", "factor"}
            if bad:
                raise ValueError(
                    f"SLO rule window #{i}: unknown keys {sorted(bad)}")
            missing = {"long", "short", "factor"} - set(w)
            if missing:
                # ValueError, not KeyError: config validation aggregates
                # ValueErrors into ONE ConfigError naming every bad field
                raise ValueError(
                    f"SLO rule window #{i}: missing keys {sorted(missing)}")
            ws.append(BurnWindow(str(w["long"]), str(w["short"]),
                                 float(w["factor"])))
        windows = tuple(ws)
    try:
        return SLORule(name=str(d.get("name", "")),
                       objective=float(d.get("objective", 0.0)),
                       ratio=str(d.get("ratio", "")), windows=windows)
    except ValueError as e:
        raise ValueError(f"SLO rule {d.get('name', '?')!r}: {e}") from None


def latency_ratio(base: str, le: str) -> str:
    """Bad-event fraction for a latency SLO over a fixed log-2 bucket
    histogram: the share of events SLOWER than ``le`` seconds.  The
    denominator is clamped so an idle window reads 0.0, not 0/0."""
    return (f"(sum(rate({base}_count[{_WINDOW_TOKEN}])) - "
            f"sum(rate({base}_bucket{{le=\"{le}\"}}[{_WINDOW_TOKEN}]))) / "
            f"clamp_min(sum(rate({base}_count[{_WINDOW_TOKEN}])), 0.001)")


def default_rules(prefix: str = "m3tpu") -> List[SLORule]:
    """The built-in rule set over series every node self-stores:
    ingest and query latency burn against fixed bucket bounds (0.25s
    and 1.0s are exact HISTOGRAM_BOUNDS lanes, so the ratio is
    bucket-exact, not interpolated)."""
    p = prefix
    return [
        SLORule("ingest-latency", 0.999,
                latency_ratio(f"{p}_db_write_batch_seconds", "0.25")),
        SLORule("query-latency", 0.99,
                latency_ratio(f"{p}_query_seconds", "1.0")),
    ]


class SLOEvaluator:
    """Evaluate a rule set against a PromQL engine on a tick cadence.

    One :class:`~m3_tpu_torch.x.deadline.Deadline` bounds the WHOLE pass
    (``deadline_s``): rules evaluated after the budget is spent are
    reported ``"error": "deadline ..."`` instead of stalling the
    mediator.  A single rule whose query raises (bad series name, empty
    namespace) degrades to a per-rule error — one rotten rule must not
    silence the rest.  A rule that stops evaluating exports
    ``slo_burn = NaN`` — explicit "unknown", never its stale last-good
    value masquerading as current (NaN samples are absent to the
    temporal kernels, so ``max_over_time`` over stored burn history
    skips the outage instead of freezing it).  ``evaluate()`` is
    serialized by ``_eval_lock`` (the mediator tick and an
    admin-triggered pass must not interleave) while ``status()`` takes
    only the cheap state lock — the ``/health`` read path never waits
    behind an in-flight evaluation.
    """

    def __init__(self, engine, rules: Iterable[SLORule],
                 deadline_s: float = 2.0, scope=None):
        self.engine = engine
        self._rules: Tuple[SLORule, ...] = tuple(rules)
        self.deadline_s = float(deadline_s)
        # _eval_lock serializes evaluation passes (engine queries, up
        # to deadline_s); _lock guards ONLY the cached verdicts, so
        # /health reads never block behind a slow pass.
        self._eval_lock = threading.Lock()
        self._lock = threading.Lock()
        self._last: dict = {"rules": {}, "evaluated_unix": None,
                            "deadline_s": self.deadline_s}
        # slo_burn{rule=...} gauges, interned ONCE here: the tag set is
        # bounded by the configured rule set (config-literal, not
        # request-derived), and priming them to 0 now means the very
        # first selfmon scrape already stores one burn series per rule
        # — the series count is constant from cycle one (the
        # amplification-guard constancy test pins exactly that).
        self._gauges = {}
        if scope is not None:
            for r in self._rules:
                g = scope.tagged({"rule": r.name}).gauge("slo_burn")  # m3lint: disable=metric-hygiene — interned once per configured rule at construction; rule names are config-bounded, never request-derived
                g.update(0.0)
                self._gauges[r.name] = g

    # -- evaluation --------------------------------------------------------

    def _ratio(self, rule: SLORule, window: str, now_nanos: int) -> float:
        """One window's bad-event fraction: instant-evaluate the
        rule's query; an empty result (no data yet) is 0.0 burn, NaN
        rows are ignored, multiple series collapse by max (an
        aggregated ratio query yields one row; a per-instance one
        answers for the worst instance)."""
        block = self.engine.execute_instant(rule.query(window), now_nanos)
        vals = to_host(block.values)
        if vals.size == 0:
            return 0.0
        col = vals[:, -1]
        finite = col[~np.isnan(col)]
        if finite.size == 0:
            return 0.0
        return float(finite.max())

    def evaluate(self, now_nanos: int | None = None) -> dict:
        if now_nanos is None:
            now_nanos = time.time_ns()
        with self._eval_lock:
            dl = Deadline(self.deadline_s)
            rules_out: dict = {}
            spent = False
            with xdeadline.bind(dl):
                for rule in self._rules:
                    doc: dict = {"objective": rule.objective,
                                 "budget": round(rule.budget, 9)}
                    if spent:
                        doc["error"] = "deadline: evaluation budget spent"
                        doc["burn"], doc["firing"] = None, None
                        rules_out[rule.name] = doc
                        g = self._gauges.get(rule.name)
                        if g is not None:
                            g.update(float("nan"))  # unevaluated ≠ last-good
                        continue
                    try:
                        windows = []
                        burn = 0.0
                        firing = False
                        for w in rule.windows:
                            lr = self._ratio(rule, w.long, now_nanos)
                            sr = self._ratio(rule, w.short, now_nanos)
                            thr = w.factor * rule.budget
                            w_firing = lr >= thr and sr >= thr
                            firing = firing or w_firing
                            burn = max(burn, lr / rule.budget)
                            windows.append({
                                "long": w.long, "short": w.short,
                                "factor": w.factor,
                                "long_ratio": round(lr, 9),
                                "short_ratio": round(sr, 9),
                                "firing": w_firing,
                            })
                        doc.update(burn=round(burn, 6), firing=firing,
                                   windows=windows)
                    except DeadlineExceeded as e:
                        doc["error"] = f"deadline: {e}"
                        doc["burn"], doc["firing"] = None, None
                        spent = True
                    except Exception as e:  # noqa: BLE001 — one rotten
                        # rule degrades alone; the tick and the other
                        # rules keep going
                        doc["error"] = f"{type(e).__name__}: {e}"
                        doc["burn"], doc["firing"] = None, None
                    rules_out[rule.name] = doc
                    g = self._gauges.get(rule.name)
                    if g is not None:
                        # errored rules export NaN (unknown), never the
                        # stale last-good burn — see class docstring
                        g.update(doc["burn"] if doc.get("burn") is not None
                                 else float("nan"))
            last = {
                "rules": rules_out,
                "evaluated_unix": round(time.time(), 3),
                "deadline_s": self.deadline_s,
                "elapsed_s": round(dl.elapsed(), 4),
                "firing": sorted(n for n, d in rules_out.items()
                                 if d.get("firing")),
            }
            with self._lock:
                self._last = last
            return last

    def rules(self) -> dict:
        """Static rule metadata keyed by name — consumers (the
        x/controller's bindings, operators reading ``/health``) bind to
        rules by NAME through this accessor instead of re-parsing the
        selfmon config.  Pure configuration: no queries, no verdicts."""
        return {
            r.name: {
                "objective": r.objective,
                "budget": round(r.budget, 9),
                "windows": [
                    {"long": w.long, "short": w.short, "factor": w.factor}
                    for w in r.windows
                ],
            }
            for r in self._rules
        }

    def status(self) -> dict:
        """The cached last evaluation (the /health ``slo`` document) —
        no queries run on the health path.  ``rule_set`` carries the
        static rule metadata, so the configured objectives/windows are
        readable even before (or without) a completed evaluation."""
        with self._lock:
            out = dict(self._last)
        out["rule_set"] = self.rules()
        return out

    @property
    def firing(self) -> List[str]:
        with self._lock:
            return list(self._last.get("firing", ()))
