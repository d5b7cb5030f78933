"""Query engine: parse -> evaluate -> step-aligned block.  The
counterpart of ``m3_tpu/query/engine.py``.

The evaluator walks the AST depth first; leaves fetch raw series through
a ``Storage`` and every interior node is a whole-block tensor program
(``temporal.py``, ``functions.py``).  Blocks stay on the engine's device
between stages: every ``Block`` that ``_eval`` returns holds a tensor on
that device, and ``execute_range`` copies the result to host numpy once.
Host work is the reference's host work (parsing, tag grouping, gather
plans, the window pad, subquery rows, set operators, date parts), each
with one explicit copy of a block, never one per row.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Protocol

import numpy as np
import torch

from m3_tpu_torch import resolve_device
from m3_tpu_torch.instrument.tracing import NOOP_TRACER, Tracepoint
from m3_tpu_torch.query import functions as fn
from m3_tpu_torch.query import precision
from m3_tpu_torch.query import temporal as tp
from m3_tpu_torch.query.block import Block, RawBlock, SeriesMeta, to_host
from m3_tpu_torch.query.promql import (
    Aggregation, BinaryOp, Call, Expr, LabelMatcher, NumberLiteral,
    StringLiteral, Subquery, Unary, VectorSelector, parse,
)
from m3_tpu_torch.x import deadline as xdeadline

LOOKBACK_NANOS = 5 * 60 * 10**9  # Prometheus default lookback delta
F64 = torch.float64
NAN = float("nan")

_TEMPORAL_SUM = {"sum_over_time", "count_over_time", "avg_over_time",
                 "stddev_over_time", "stdvar_over_time"}
_TEMPORAL_MINMAXQ = {"min_over_time", "max_over_time", "quantile_over_time"}
_TEMPORAL_RATE = {"rate", "increase", "delta", "irate", "idelta"}
_TEMPORAL_REG = {"deriv", "predict_linear"}
_TEMPORAL_TRANS = {"resets", "changes"}
_TEMPORAL_ALL = (_TEMPORAL_SUM | _TEMPORAL_MINMAXQ | _TEMPORAL_RATE
                 | _TEMPORAL_REG | _TEMPORAL_TRANS
                 | {"last_over_time", "present_over_time",
                    "absent_over_time", "holt_winters"})


class Storage(Protocol):
    def fetch_raw(self, name: bytes | None, matchers: tuple[LabelMatcher, ...],
                  start_nanos: int, end_nanos: int) -> RawBlock: ...


@dataclass
class _Scalar:
    """A PromQL scalar: a float, or a per-step (T,) array or tensor
    (scalar(), time()).  Binary ops broadcast it across the series
    axis."""

    value: float | np.ndarray | torch.Tensor


def _host_scalar(v):
    return to_host(v) if isinstance(v, torch.Tensor) else v


class Engine:
    """reference ``executor/engine.go:47 NewEngine``.  ``device=None``
    means CUDA (raises without a card); the CPU runs only when asked."""

    def __init__(self, storage: Storage, lookback_nanos: int = LOOKBACK_NANOS,
                 tracer=None, device=None):
        self.storage = storage
        self.lookback = lookback_nanos
        self.tracer = tracer if tracer is not None else NOOP_TRACER
        self.device = resolve_device(device)
        # Per-query (start, end) for @ start()/end(): they always refer
        # to the top-level query parameters, never an inner subquery
        # grid.  Thread-local because one engine serves concurrent
        # requests.
        self._query_bounds = threading.local()

    # -- public API --------------------------------------------------------

    def execute_range(self, query: str, start_nanos: int, end_nanos: int,
                      step_nanos: int, deadline=None) -> Block:
        """PromQL range query.  ``deadline`` (an ``x/deadline.Deadline``)
        bounds the whole evaluation: checked between eval nodes and inside
        per-row host loops."""
        with self.tracer.start_span(Tracepoint.ENGINE_EXECUTE,
                                    {"query": query}):
            with xdeadline.bind(deadline if deadline is not None
                                else xdeadline.current()):
                return self._execute_range(query, start_nanos, end_nanos,
                                           step_nanos)

    def _execute_range(self, query: str, start_nanos: int, end_nanos: int,
                       step_nanos: int) -> Block:
        ast = parse(query)
        steps = np.arange(start_nanos, end_nanos + 1, step_nanos, dtype=np.int64)
        self._query_bounds.range = (start_nanos, end_nanos)
        try:
            out = self._eval(ast, steps)
        finally:
            del self._query_bounds.range
        if isinstance(out, _Scalar):
            vals = np.broadcast_to(
                np.asarray(_host_scalar(out.value), np.float64), (1, len(steps))
            ).copy()
            return Block(steps, vals, [SeriesMeta(())])
        # the one device -> host copy
        return out.materialized()

    def execute_instant(self, query: str, time_nanos: int,
                        deadline=None) -> Block:
        return self.execute_range(query, time_nanos, time_nanos, 10**9,
                                  deadline=deadline)

    # -- device helpers ----------------------------------------------------

    def _dev(self, x, dtype=None) -> torch.Tensor:
        """A host array (or a tensor) on the engine's device."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype)
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=self.device)

    def _row_block(self, steps: np.ndarray, row) -> Block:
        """One anonymous series over ``steps`` on the device."""
        row = np.array(row, np.float64)  # a writable copy of a broadcast row
        return Block(steps, self._dev(row).reshape(1, len(steps)), [SeriesMeta(())])

    # -- evaluation --------------------------------------------------------

    def _eval(self, e: Expr, steps: np.ndarray):
        # cooperative cancellation point between eval nodes
        xdeadline.check_current("query eval")
        if isinstance(e, NumberLiteral):
            return _Scalar(e.value)
        if isinstance(e, StringLiteral):
            return e.value
        if isinstance(e, Unary):
            v = self._eval(e.expr, steps)
            if e.op == "+":
                return v
            if isinstance(v, _Scalar):
                return _Scalar(-v.value)
            return v.with_values(-v.values)
        if isinstance(e, VectorSelector):
            if e.range_nanos:
                raise ValueError("range selector outside temporal function")
            return self._eval_instant_selector(e, steps)
        if isinstance(e, Call):
            return self._eval_call(e, steps)
        if isinstance(e, Aggregation):
            return self._eval_aggregation(e, steps)
        if isinstance(e, BinaryOp):
            return self._eval_binary(e, steps)
        raise ValueError(f"cannot evaluate {e}")

    def _resolve_at(self, node, steps: np.ndarray) -> int | None:
        """The @ modifier's fixed evaluation time, or None.  start()/end()
        resolve to the top-level query range, even inside a subquery."""
        if node.at_edge in ("start", "end"):
            bounds = getattr(self._query_bounds, "range",
                             (int(steps[0]), int(steps[-1])))
            return bounds[0] if node.at_edge == "start" else bounds[1]
        return node.at_nanos

    def _fetch(self, sel: VectorSelector, steps: np.ndarray, range_nanos: int):
        at = self._resolve_at(sel, steps)
        if at is not None:
            # pinned evaluation computes one column; callers broadcast it
            eval_steps = np.asarray([at - sel.offset_nanos], np.int64)
        else:
            eval_steps = steps - sel.offset_nanos
        start = int(eval_steps[0]) - range_nanos
        # +1: storage reads are end-exclusive, but a sample exactly at
        # the final evaluation step belongs to it ((t-range, t] windows)
        end = int(eval_steps[-1]) + 1
        raw = self.storage.fetch_raw(sel.name, sel.matchers, start, end)
        return raw, eval_steps

    def _eval_subquery(self, sub: Subquery, steps: np.ndarray):
        """``expr[range:step]``: the inner instant expression on the
        subquery's absolute-aligned step grid, handed to the temporal
        functions like fetched raw datapoints (NaN results are stale and
        yield no sample)."""
        step = sub.step_nanos
        if step == 0:
            # default resolution: the outer query's step, 60 s for a
            # single-step evaluation (resolved before @ pinning)
            step = (int(steps[1] - steps[0]) if len(steps) > 1
                    else 60 * 10**9)
        at = self._resolve_at(sub, steps)
        if at is not None:
            steps = np.asarray([at], np.int64)  # single pinned column
        end = int(steps[-1]) - sub.offset_nanos
        start = int(steps[0]) - sub.range_nanos - sub.offset_nanos
        first = -(-start // step) * step  # absolute alignment (ceil)
        inner = np.arange(first, end + 1, step, dtype=np.int64)
        if len(inner) == 0:
            inner = np.asarray([end], np.int64)
        b = self._eval(sub.expr, inner)
        if isinstance(b, _Scalar):
            # scalar-valued inner exprs broadcast to one anonymous series
            vals = np.broadcast_to(
                np.asarray(_host_scalar(b.value), np.float64), (len(inner),))
            b = Block(inner, vals[None, :].copy(), [SeriesMeta(())])
        bvals = to_host(b.values)  # one copy, not one per row
        pts = []
        for i, row in enumerate(bvals):
            if i % 256 == 0:  # per-row host loop over the inner grid
                xdeadline.check_current("subquery rows")
            pts.append([(int(t), float(v)) for t, v in zip(inner, row)
                        if not math.isnan(v)])
        raw = RawBlock.from_lists(pts, b.series)
        return raw, steps - sub.offset_nanos

    def _eval_instant_selector(self, sel: VectorSelector, steps: np.ndarray) -> Block:
        raw, eval_steps = self._fetch(sel, steps, self.lookback)
        vals = tp.last_over_time(self._dev(raw.ts, torch.int64),
                                 self._dev(raw.values, F64),
                                 self._dev(eval_steps), self.lookback)
        if vals.shape[1] != len(steps):  # @-pinned single column
            vals = vals.expand(vals.shape[0], len(steps))
        return Block(steps, vals, raw.series)

    def _eval_call(self, call: Call, steps: np.ndarray):
        f = call.func
        if f in _TEMPORAL_ALL:
            return self._eval_temporal(call, steps)
        if f == "histogram_quantile":
            q = self._scalar_arg(call.args[0], steps)
            block = self._eval(call.args[1], steps)
            return fn.histogram_quantile(block, q)
        if f in fn._UNARY:
            return fn.unary_math(self._eval(call.args[0], steps), f)
        if f == "pi":
            return _Scalar(math.pi)
        if f in fn._DATE_FNS:
            # date parts of the argument's unix-seconds values; the
            # argument defaults to vector(time()) as in Prometheus
            if call.args:
                b = self._eval(call.args[0], steps)
            else:
                b = self._row_block(steps, steps.astype(np.float64) / 1e9)
            if isinstance(b, _Scalar):
                b = self._row_block(steps, np.broadcast_to(
                    np.asarray(_host_scalar(b.value), np.float64), (len(steps),)))
            return fn.date_fn(b, f)
        if f == "round":
            nearest = (self._scalar_arg(call.args[1], steps)
                       if len(call.args) > 1 else 1.0)
            return fn.round_fn(self._eval(call.args[0], steps), nearest)
        if f == "clamp":
            return fn.clamp(self._eval(call.args[0], steps),
                            self._scalar_arg(call.args[1], steps),
                            self._scalar_arg(call.args[2], steps))
        if f == "clamp_min":
            return fn.clamp(self._eval(call.args[0], steps),
                            lo=self._scalar_arg(call.args[1], steps))
        if f == "clamp_max":
            return fn.clamp(self._eval(call.args[0], steps),
                            hi=self._scalar_arg(call.args[1], steps))
        if f == "scalar":
            b = self._eval(call.args[0], steps)
            if isinstance(b, _Scalar):
                return b
            if b.num_series == 1:
                return _Scalar(b.values[0].clone())
            return _Scalar(np.full(len(steps), np.nan))
        if f == "vector":
            v = self._eval(call.args[0], steps)
            if not isinstance(v, _Scalar):
                raise ValueError("vector() expects a scalar argument")
            # per-step scalars stay per-step (vector(time()))
            return self._row_block(steps, np.broadcast_to(
                np.asarray(_host_scalar(v.value), np.float64), (len(steps),)))
        if f == "absent":
            b = self._eval(call.args[0], steps)
            if b.num_series:
                present = (~torch.isnan(b.values)).any(dim=0)
            else:
                present = torch.zeros(len(steps), dtype=torch.bool, device=self.device)
            return Block(steps, torch.where(present, NAN, 1.0)[None, :].to(F64),
                         [SeriesMeta(())])
        if f == "label_replace":
            return self._label_replace(call, steps)
        if f == "label_join":
            return self._label_join(call, steps)
        if f == "timestamp":
            b = self._eval(call.args[0], steps)
            tvals = self._dev(steps.astype(np.float64) / 1e9).expand(b.values.shape)
            return b.with_values(torch.where(torch.isnan(b.values), NAN, tvals),
                                 [m.drop_name() for m in b.series])
        if f == "time":
            return _Scalar(steps.astype(np.float64) / 1e9)
        if f in ("sort", "sort_desc"):
            # by value at the final step (stable for ties, NaNs last)
            b = self._eval(call.args[0], steps)
            if isinstance(b, _Scalar):
                raise ValueError(f"{f} expects an instant vector")
            if b.num_series <= 1:
                return b
            key = to_host(b.values[:, -1])
            key = np.where(np.isnan(key), np.inf if f == "sort" else -np.inf,
                           key)
            order = np.argsort(key if f == "sort" else -key, kind="stable")
            return Block(steps, b.values[self._dev(order)],
                         [b.series[i] for i in order])
        raise ValueError(f"unsupported function {f!r}")

    def _eval_temporal(self, call: Call, steps: np.ndarray) -> Block:
        f = call.func
        q = 0.0
        sel_arg = call.args[-1]
        extra = 0.0
        if f == "quantile_over_time":
            q = self._scalar_arg(call.args[0], steps)
            sel_arg = call.args[1]
        elif f == "predict_linear":
            sel_arg = call.args[0]
            extra = self._scalar_arg(call.args[1], steps)
        elif f == "holt_winters":
            sel_arg = call.args[0]
        if isinstance(sel_arg, Subquery):
            raw, eval_steps = self._eval_subquery(sel_arg, steps)
        elif (not isinstance(sel_arg, VectorSelector)
                or sel_arg.range_nanos == 0):
            raise ValueError(f"{f} requires a range selector or subquery")
        else:
            raw, eval_steps = self._fetch(sel_arg, steps, sel_arg.range_nanos)
        if len(raw.series) == 0:
            if f == "absent_over_time":
                # nothing matched: one empty-labelled series of 1s
                return self._row_block(steps, np.ones(len(steps)))
            # no matched series: an empty instant vector
            return Block(steps, torch.empty((0, len(steps)), dtype=F64,
                                            device=self.device), [])
        narrow = precision.compute_dtype() == np.float32
        ts_j = self._dev(raw.ts, torch.int64)
        # The policy dtype rides the value tensor, except for the rate
        # family (differences cumulative counters in f64 and narrows
        # inside) and the regression (f64 always).  nan_to_num runs on
        # the f64 values before the cast, as in the reference (there on
        # the host), so under f32 +-inf stays +-inf.
        narrow_vals = f not in _TEMPORAL_RATE and f not in _TEMPORAL_REG
        vals_j = torch.nan_to_num(self._dev(raw.values, F64)).to(
            precision.compute_torch_dtype() if narrow_vals else F64)
        st_j = self._dev(eval_steps)
        rng = sel_arg.range_nanos
        if f in _TEMPORAL_SUM:
            out = tp.sum_count_family(ts_j, vals_j, st_j, rng, f)
        elif f in _TEMPORAL_MINMAXQ:
            W = tp.window_pad_for(raw.counts, raw.ts, rng)
            out = tp.minmax_quantile_family(ts_j, vals_j, st_j, rng, f, W, q)
        elif f in _TEMPORAL_RATE:
            out = tp.rate_family(ts_j, vals_j, st_j, rng, f, narrow=narrow)
        elif f in _TEMPORAL_REG:
            out = tp.regression_family(ts_j, vals_j, st_j, rng, f, extra)
        elif f in _TEMPORAL_TRANS:
            out = tp.transitions_family(ts_j, vals_j, st_j, rng, f)
        elif f == "holt_winters":
            sfv = float(self._scalar_arg(call.args[1], steps))
            tfv = float(self._scalar_arg(call.args[2], steps))
            # Prometheus funcHoltWinters: sf in (0, 1), tf in (0, 1]
            if not (0.0 < sfv < 1.0) or not (0.0 < tfv <= 1.0):
                raise ValueError(
                    "holt_winters smoothing factor must be in (0, 1) "
                    "and trend factor in (0, 1]")
            W = tp.window_pad_for(raw.counts, raw.ts, rng)
            out = tp.holt_winters(ts_j, vals_j, st_j, rng, max(W, 2), sfv, tfv)
        elif f == "last_over_time":
            out = tp.last_over_time(ts_j, vals_j, st_j, rng)
        elif f == "absent_over_time":
            # 1 at every step where no matched series has a sample in
            # the window
            cnt = tp.sum_count_family(ts_j, vals_j, st_j, rng, "count_over_time")
            any_present = (~torch.isnan(cnt) & (cnt > 0)).any(dim=0)
            out = torch.where(any_present, NAN, 1.0)[None, :].to(F64)
            return Block(steps, out.expand(1, len(steps)), [SeriesMeta(())])
        else:  # present_over_time
            out = tp.sum_count_family(ts_j, vals_j, st_j, rng, "count_over_time")
            out = torch.where(torch.isnan(out), out, torch.clamp_max(out, 1.0))
        metas = [m.drop_name() for m in raw.series]
        # blocks stay f64 whatever the compute policy, cast on the device
        out = out.to(F64)
        if out.shape[1] != len(steps):
            # @-pinned: one computed column broadcast across steps
            out = out.expand(out.shape[0], len(steps))
        return Block(steps, out, metas)

    def _label_replace(self, call: Call, steps: np.ndarray) -> Block:
        import re as _re

        b = self._eval(call.args[0], steps)
        dst = self._string_arg(call.args[1]).encode()
        repl = self._string_arg(call.args[2])
        src = self._string_arg(call.args[3]).encode()
        regex = _re.compile(self._string_arg(call.args[4]))
        metas = []
        for m in b.series:
            tags = m.as_dict()
            val = tags.get(src, b"").decode()
            mm = regex.fullmatch(val)
            if mm:
                new = mm.expand(repl.replace("$", "\\")).encode()
                if new:
                    tags[dst] = new
                else:
                    tags.pop(dst, None)
            metas.append(SeriesMeta.from_dict(tags))
        return Block(b.step_times, b.values, metas)

    def _label_join(self, call: Call, steps: np.ndarray) -> Block:
        b = self._eval(call.args[0], steps)
        dst = self._string_arg(call.args[1]).encode()
        sep = self._string_arg(call.args[2]).encode()
        srcs = [self._string_arg(a).encode() for a in call.args[3:]]
        metas = []
        for m in b.series:
            tags = m.as_dict()
            joined = sep.join(tags.get(s, b"") for s in srcs)
            if joined:
                tags[dst] = joined
            else:
                tags.pop(dst, None)
            metas.append(SeriesMeta.from_dict(tags))
        return Block(b.step_times, b.values, metas)

    def _eval_aggregation(self, agg: Aggregation, steps: np.ndarray) -> Block:
        block = self._eval(agg.expr, steps)
        by = set(agg.by) if agg.by is not None else None
        without = set(agg.without) if agg.without is not None else None
        if agg.op in ("topk", "bottomk"):
            k = int(self._scalar_arg(agg.param, steps))
            return fn.topk_bottomk(block, k, agg.op, by, without)
        if agg.op == "quantile":
            q = self._scalar_arg(agg.param, steps)
            return fn.aggregate(block, "quantile", by, without, q)
        if agg.op == "group":
            out = fn.aggregate(block, "count", by, without)
            return out.with_values(torch.where(torch.isnan(out.values), NAN, 1.0))
        return fn.aggregate(block, agg.op, by, without)

    def _eval_binary(self, b: BinaryOp, steps: np.ndarray):
        lhs = self._eval(b.lhs, steps)
        rhs = self._eval(b.rhs, steps)
        sl, sr = isinstance(lhs, _Scalar), isinstance(rhs, _Scalar)
        if b.op in ("and", "or", "unless"):
            return self._set_op(b, lhs, rhs)
        if sl and sr:
            with np.errstate(all="ignore"):
                v = fn._BINOPS[b.op](_host_scalar(lhs.value), _host_scalar(rhs.value))
            if b.op in fn._COMPARISONS:
                v = np.asarray(v, np.float64) if isinstance(v, np.ndarray) \
                    else (1.0 if v else 0.0)
            return _Scalar(v if isinstance(v, np.ndarray) else float(v))
        if sr:
            return fn.scalar_binary(lhs, b.op, rhs.value, False, b.bool_mode)
        if sl:
            return fn.scalar_binary(rhs, b.op, lhs.value, True, b.bool_mode)
        return fn.vector_binary(
            lhs, rhs, b.op,
            set(b.on) if b.on is not None else None,
            set(b.ignoring) if b.ignoring is not None else None,
            b.bool_mode,
        )

    def _set_op(self, b: BinaryOp, lhs: Block, rhs: Block) -> Block:
        on = set(b.on) if b.on is not None else None
        ig = set(b.ignoring) if b.ignoring is not None else None
        # host row matching: one copy of each side up front, one copy of
        # the result back
        lvals = to_host(lhs.values)
        rvals = to_host(rhs.values)
        rkeys = {fn._match_key(m, on, ig): i for i, m in enumerate(rhs.series)}
        if b.op == "or":
            lkeys = {fn._match_key(x, on, ig) for x in lhs.series}
            extra_rows = [i for i, m in enumerate(rhs.series)
                          if fn._match_key(m, on, ig) not in lkeys]
            vals = np.concatenate([lvals, rvals[extra_rows]]) if extra_rows \
                else lvals
            metas = lhs.series + [rhs.series[i] for i in extra_rows]
            return Block(lhs.step_times, self._dev(vals, F64), metas)
        out = np.full_like(lvals, np.nan)
        for i, m in enumerate(lhs.series):
            if i % 256 == 0:  # per-series host loop: cancellable
                xdeadline.check_current("set-op rows")
            j = rkeys.get(fn._match_key(m, on, ig))
            if b.op == "and":
                if j is not None:
                    out[i] = np.where(~np.isnan(rvals[j]), lvals[i], np.nan)
            else:  # unless
                if j is None:
                    out[i] = lvals[i]
                else:
                    out[i] = np.where(np.isnan(rvals[j]), lvals[i], np.nan)
        return lhs.with_values(self._dev(out, F64))

    # -- helpers -----------------------------------------------------------

    def _scalar_arg(self, e: Expr, steps: np.ndarray) -> float:
        """A static float parameter (topk k, quantile q, clamp bounds...).
        Per-step scalars collapse to their first finite value."""
        v = self._eval(e, steps)
        if isinstance(v, _Scalar):
            if getattr(v.value, "ndim", 0):
                arr = np.asarray(_host_scalar(v.value))
                finite = arr[np.isfinite(arr)]
                return float(finite[0]) if len(finite) else float("nan")
            return v.value
        raise ValueError("expected scalar argument")

    def _string_arg(self, e: Expr) -> str:
        if isinstance(e, StringLiteral):
            return e.value
        raise ValueError("expected string argument")
