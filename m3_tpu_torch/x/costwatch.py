"""Per-stage dispatch fingerprints of the port's hot-path programs: the
counterpart of ``m3_tpu/x/costwatch.py``.

The reference fingerprints each hot-path device program from XLA's
compile-time analyses at pinned shapes.  The port runs eagerly, so it
cannot lower without running: a stage's fingerprint comes from **one
eager run on seeded data** under the **census** — every aten op the run
dispatches (on any device, the CPU included, through ``x/devseams``'s
``OPS`` seam), every hand-kernel launch and its grids, every host↔device
transfer with its bytes — after one uncounted warm-up run of the same
call (the lazy device state a first call makes, the decoder's control
table for one, is not the stage's).  The fingerprint holds:

* ``dispatches`` in total and by ``x/optext`` class (``ops``), with the
  element types of the ops' results (``types``, and ``width64``, the
  64-bit width census);
* ``kernels``: hand-kernel launches and grids by kernel (none on the
  CPU, where every wrapper takes its plain version);
* ``transfers``: uploads and downloads with their bytes (none on the
  CPU), and the uploads of at least :data:`CONSTANT_BYTES` (``constants``);
* ``memory``: ``argument_bytes`` (the stage's tensor arguments, resident
  tables included), ``output_bytes`` (results that alias no argument),
  ``alias_bytes`` and, on the card only, ``peak_bytes``: the growth of
  ``torch.cuda.max_memory_allocated()`` over the counted run after
  ``reset_peak_memory_stats``, with Python's cyclic collector held off
  (``None`` on the CPU, not a guess);
* ``op_output_bytes``, the bytes the ops wrote, and per-datapoint
  normalisations of it, of the dispatches and of the peak.

No XLA cost-model field (flops, transcendentals) is kept: the port has
no cost model, and a census of a run is not one.

Fingerprints are pinned per (platform, device name, torch version, CUDA
version), and ``tools/costs.check_artifact`` refuses to compare across
them, as the reference refuses across (platform, jax version).  The
census counts in its own thread only (a dispatch mode is per thread).
"""

from __future__ import annotations

import contextlib
import functools
import gc
import threading
import time
from collections import Counter
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from m3_tpu_torch import resolve_device
from m3_tpu_torch.x import devseams, optext

__all__ = [
    "CANONICAL", "CONSTANT_BYTES", "DOCUMENTED_CARD_OPS_PER_DP", "DOCUMENTED_OPS_PER_DP",
    "GATED_METRICS", "EXACT_METRICS", "STAGES", "STAGE_MAP", "STAGE_KERNELS", "Census",
    "Stage", "CountedStage", "bench_corpus", "census", "clear_stage_cache",
    "count_step_ops", "counted_stage", "counted_stages", "counting", "decode_step_ops",
    "encode_step_ops",
    "fingerprint_call", "platform_config", "quiet_heap", "run_stages", "stage_names",
    "step_ops_crosscheck", "uncounted",
]


# ---------------------------------------------------------------------------
# Canonical shapes: the reference's, unchanged.  CHANGING ANY OF THESE
# IS A RE-BASELINE.
# ---------------------------------------------------------------------------

CANONICAL = {
    "S": 256,           # codec series axis
    "T": 128,           # codec datapoints per series
    "W": 4,             # arena window ring
    "C": 4096,          # arena slot capacity
    "SCAP": 16384,      # timer sample capacity
    "N": 8192,          # arena ingest batch size
    "QUANTILES": (0.5, 0.95, 0.99),   # engine default
    "SHARD_DEVICES": 2,  # sharded-wrapper mesh width (one device repeated)
}

SEED = 42  # the registry's data

# Dispatches of one phase-1 step at S = CANONICAL["S"], counted by the
# census (:func:`step_ops_crosscheck` holds the live counts to them): the
# decoder's gather-tail step and the encoder's lane-emission step.  The
# port's own counts, not the reference's jaxpr equation counts.  On the
# CPU each step is ``_decode_step``'s or ``_encode_step``'s tensor ops;
# on a card every step of each scan runs inside one launch of its scan
# kernel, so one step there is that launch at one step with its
# wrapper's ops (:func:`decode_step_ops`, :func:`encode_step_ops`).
DOCUMENTED_OPS_PER_DP = {
    "decode_step": 444,
    "encode_step": 1326,
}
DOCUMENTED_CARD_OPS_PER_DP = {"decode_step": 12, "encode_step": 13}

# Per-stage metrics the ratchet gates, in either direction.  The census
# is exact, so counts gate exactly (EXACT_METRICS: one dispatch more is a
# change); bytes gate within the check's tolerance.  argument/output
# bytes move only when the stage's interface moves, which is the
# constant class: the decoder's control table sliding from an argument
# into a per-call upload shows here first (and in ``transfers``).
EXACT_METRICS = (
    "dispatches", *(f"ops.{c}" for c in optext.OP_CLASSES), "width64",
    "kernel_launches", "kernel_grids", "transfers.uploads",
    "transfers.upload_bytes", "transfers.downloads", "transfers.download_bytes",
)
GATED_METRICS = EXACT_METRICS + (
    "op_output_bytes", "memory.argument_bytes", "memory.output_bytes",
    "memory.peak_bytes",
)

CONSTANT_BYTES = 1 << 16  # an upload this large in a stage is a table


# ---------------------------------------------------------------------------
# The census
# ---------------------------------------------------------------------------


class Census:
    """One counted run's records (see the module docstring)."""

    def __init__(self):
        self.ops: Counter = Counter()        # aten op name -> dispatches
        self.op_output_bytes = 0
        self.kernels: Dict[str, list] = {}   # kernel -> [launches, grids]
        self.uploads: list = []              # (seam, bytes) of each upload
        self.op_types: Counter = Counter()   # (op, result dtype) -> results
        self.seams: Dict[str, list] = {}     # "kind:seam" -> [count, bytes]

    @property
    def dispatches(self) -> int:
        return sum(self.ops.values())

    @property
    def transfers(self) -> Dict[str, list]:
        """[count, bytes] by direction (``h2d``, ``d2h``)."""
        out = {"h2d": [0, 0], "d2h": [0, 0]}
        for key, (n, nbytes) in self.seams.items():
            row = out[key.split(":", 1)[0]]
            row[0] += n
            row[1] += nbytes
        return out

    @property
    def types(self) -> Counter:
        """Results by element type."""
        out: Counter = Counter()
        for (_, dtype), n in self.op_types.items():
            out[dtype] += n
        return out

    def summary(self) -> dict:
        types = optext.type_census(self.types)
        return {
            "dispatches": self.dispatches,
            "ops": optext.op_histogram(self.ops),
            "types": types,
            "width64": optext.wide_count(types),
            "kernels": {k: {"launches": v[0], "grids": v[1]}
                        for k, v in sorted(self.kernels.items())},
            "kernel_launches": sum(v[0] for v in self.kernels.values()),
            "kernel_grids": sum(v[1] for v in self.kernels.values()),
            "transfers": {"uploads": self.transfers["h2d"][0],
                          "upload_bytes": self.transfers["h2d"][1],
                          "downloads": self.transfers["d2h"][0],
                          "download_bytes": self.transfers["d2h"][1]},
            "constants": optext.uploaded_constants(self.uploads, CONSTANT_BYTES),
            "op_output_bytes": self.op_output_bytes,
        }

    def records(self) -> dict:
        """The run's records by name, which the fingerprint reduces to
        classes: dispatches by op, results by (dtype, op) for the 64-bit
        types, and transfers by ``kind:seam`` (``x/irlint`` reads them)."""
        wide: Dict[str, Dict[str, int]] = {}
        for (op, dtype), n in sorted(self.op_types.items()):
            if dtype in optext.WIDE_TYPES:
                wide.setdefault(dtype, {})[op] = int(n)
        return {"ops": dict(sorted(self.ops.items())), "wide_results": wide,
                "transfers": {k: list(v) for k, v in sorted(self.seams.items())}}


_tls = threading.local()  # stack: the open censuses of this thread
_mu = threading.Lock()
_users = 0


def _top():
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def _results(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            if isinstance(o, torch.Tensor):
                yield o


def _on_op(name, args, kwargs, out) -> None:
    c = _top()
    if c is None:
        return
    c.ops[name] += 1
    for t in _results(out):
        c.op_types[(name, str(t.dtype).removeprefix("torch."))] += 1
        c.op_output_bytes += t.numel() * t.element_size()


def _on_count(kind, seam, n, nbytes) -> None:
    c = _top()
    if c is None:
        return
    if kind in ("h2d", "d2h"):
        row = c.seams.setdefault(f"{kind}:{seam}", [0, 0])
        row[0] += n
        row[1] += nbytes
        if kind == "h2d":
            c.uploads.append((seam, nbytes))
    elif kind == "dispatch" and seam.startswith("kernel:"):
        row = c.kernels.setdefault(seam.split(":", 1)[1], [0, 0])
        row[0] += 1
        row[1] += n


@contextlib.contextmanager
def census():
    """Within, this thread's ops, launches and transfers are counted into
    the yielded :class:`Census` (the innermost open one)."""
    global _users
    with _mu:
        _users += 1
        if _users == 1:
            devseams.OPS.append(_on_op)
            devseams.COUNTERS.append(_on_count)
    c = Census()
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(c)
    devseams.enter()
    try:
        yield c
    finally:
        devseams.leave()
        stack.pop()
        with _mu:
            _users -= 1
            if _users == 0:
                devseams.OPS.remove(_on_op)
                devseams.COUNTERS.remove(_on_count)


def counting() -> bool:
    """Whether this thread's ops go into an open census now."""
    return _top() is not None


@contextlib.contextmanager
def uncounted():
    """Within, this thread's ops, launches and transfers go uncounted by
    any open census (a checker's own work inside a counted run)."""
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(None)
    try:
        yield
    finally:
        stack.pop()


def count_step_ops(step: Callable, *args, **kwargs) -> int:
    """Dispatches of one call of ``step`` (aten ops on any device plus
    hand-kernel grids): the one home of the per-step counter that
    ``tools/decode_profile`` imports, the counterpart of the reference's
    ``count_jaxpr_ops`` (a drifted second copy would let the profile's
    counts and the artifact's disagree silently)."""
    with census() as c:
        step(*args, **kwargs)
    return c.dispatches + sum(v[1] for v in c.kernels.values())


# ---------------------------------------------------------------------------
# Fingerprints
# ---------------------------------------------------------------------------


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)


def _distinct_bytes(ts, skip=frozenset()) -> int:
    seen = set(skip)
    n = 0
    for t in ts:
        key = (t.untyped_storage().data_ptr(), t.device)
        if key in seen:
            continue
        seen.add(key)
        n += t.numel() * t.element_size()
    return n


def _storages(ts) -> set:
    return {(t.untyped_storage().data_ptr(), t.device) for t in ts}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def quiet_heap():
    """Within, Python's cyclic collector does not run (it is run once
    before): a collection inside a measured region frees other code's
    device tensors and hides the region's own growth of
    ``memory_allocated``."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def fingerprint_call(fn: Callable, args: tuple, datapoints: int, device) -> dict:
    """Fingerprint ``fn(*args)`` on ``device``: an uncounted warm-up call,
    then one counted call (see the module docstring for the fields)."""
    return _fingerprint(fn, args, datapoints, device)[0]


def _fingerprint(fn: Callable, args: tuple, datapoints: int, device):
    """(the fingerprint, the counted run's :class:`Census`)."""
    dev = torch.device(device)
    fn(*args)
    _sync(dev)
    arg_ts = list(_tensors(args))
    base = None
    with quiet_heap():
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        with census() as c:
            out = fn(*args)
        _sync(dev)
        peak = None if base is None else torch.cuda.max_memory_allocated(dev) - base
    out_ts = list(_tensors(out))
    arg_keys = _storages(arg_ts)
    alias = _distinct_bytes([t for t in out_ts if
                             (t.untyped_storage().data_ptr(), t.device) in arg_keys])
    fp = c.summary()
    dp = max(int(datapoints), 1)
    fp.update(
        datapoints=int(datapoints),
        dispatches_per_dp=round(fp["dispatches"] / dp, 4),
        bytes_per_dp=round(fp["op_output_bytes"] / dp, 4),
        memory={"argument_bytes": _distinct_bytes(arg_ts),
                "output_bytes": _distinct_bytes(out_ts, skip=arg_keys),
                "alias_bytes": alias, "peak_bytes": peak},
        peak_bytes_per_dp=None if peak is None else round(peak / dp, 2),
    )
    return fp, c


def platform_config(device) -> dict:
    """What a fingerprint is pinned to: (platform, device name, torch
    version, CUDA version); the CUDA version is None on the CPU."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    return {
        "platform": dev.type,
        "device_name": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "torch": torch.__version__,
        "cuda": torch.version.cuda if cuda else None,
    }


# ---------------------------------------------------------------------------
# The stage registry
# ---------------------------------------------------------------------------


class Stage(NamedTuple):
    """One named hot-path program at the canonical shapes.  ``build(dev)``
    returns ``(fn, args, datapoints, config)``: the call to count, its
    seeded arguments on ``dev``, the per-datapoint divisor and the config
    the check pins (shapes and statics)."""

    name: str
    build: Callable[[torch.device], tuple]


def bench_corpus(S: int, T: int, seed: int = SEED):
    """The bench corpus (``bench.py``'s ``_make_corpus``, the port's own
    copy): 10 s samples of two-decimal gauges, regular timestamps.
    Returns (ts (S, T) int64, values (S, T) float64, starts (S,) int64)."""
    start = 1_600_000_000 * 10**9
    rng = np.random.default_rng(seed)
    ts = np.tile(start + np.arange(1, T + 1) * 10 * 10**9, (S, 1)).astype(np.int64)
    base = rng.uniform(10, 1000, (S, 1))
    vals = np.round(base + rng.normal(0, base * 0.05, (S, T)), 2)
    return ts, vals, np.full(S, start, np.int64)


def _out_words(T: int) -> int:
    return T * 16 // 64 + 4  # the reference's stage shape


@functools.lru_cache(maxsize=None)
def _streams(S: int, T: int):
    """The corpus's streams (encoded once on the CPU, host data): packed
    (S, W) words as int64 and (S,) bit lengths."""
    from m3_tpu_torch.encoding import m3tsz_torch as mt

    ts, vals, starts = bench_corpus(S, T)
    res = mt._encode_batch_device(torch.from_numpy(ts),
                                  torch.from_numpy(vals.view(np.int64)),
                                  torch.from_numpy(starts),
                                  torch.ones((S, T), dtype=torch.bool),
                                  fit_words=True, device="cpu")
    streams = mt.finalize_streams(res["words"].numpy().view(np.uint64),
                                  res["total_bits"].numpy())
    words, nbits = mt.pack_streams(streams)
    return words.view(np.int64), nbits.astype(np.int64)


def _build_decode(chains: str, dev):
    from m3_tpu_torch.encoding import m3tsz_torch as mt

    S, T = CANONICAL["S"], CANONICAL["T"]
    words, nbits = _streams(S, T)
    args = (torch.from_numpy(words).to(dev), torch.from_numpy(nbits).to(dev),
            mt.value_ctrl_table(dev))

    def fn(w, n, tbl):
        return mt._decode_batch_device(w, n, T + 1, default_unit=1, device=dev,
                                       chains=chains, scan_major=True, ctrl_tbl=tbl)

    cfg = {"S": S, "T": T, "max_points": T + 1, "stream_words": int(words.shape[1]),
           "chains": chains, "scan_major": True}
    return fn, args, S * T, cfg


def _shard_devices(dev) -> list:
    return [dev] * CANONICAL["SHARD_DEVICES"]


def _build_decode_sharded(dev):
    from m3_tpu_torch.parallel import sharded_decode

    S, T = CANONICAL["S"], CANONICAL["T"]
    words, nbits = _streams(S, T)
    args = (torch.from_numpy(words).to(dev), torch.from_numpy(nbits).to(dev))

    def fn(w, n):
        return sharded_decode.decode_batch_device_sharded(
            w, n, T + 1, chains="gather", scan_major=True, devices=_shard_devices(dev))

    cfg = {"S": S, "T": T, "max_points": T + 1, "stream_words": int(words.shape[1]),
           "chains": "gather", "devices": CANONICAL["SHARD_DEVICES"]}
    return fn, args, S * T, cfg


def _codec_args(dev):
    S, T = CANONICAL["S"], CANONICAL["T"]
    ts, vals, starts = bench_corpus(S, T)
    return (torch.from_numpy(ts).to(dev), torch.from_numpy(vals.view(np.int64)).to(dev),
            torch.from_numpy(starts).to(dev),
            torch.ones((S, T), dtype=torch.bool, device=dev))


def _build_encode(dev):
    from m3_tpu_torch.encoding import m3tsz_torch as mt

    S, T = CANONICAL["S"], CANONICAL["T"]
    ow = _out_words(T)

    def fn(ts, vb, start, valid):
        return mt._encode_batch_device(ts, vb, start, valid, unit=1, out_words=ow,
                                       device=dev)

    return fn, _codec_args(dev), S * T, {"S": S, "T": T, "out_words": ow}


def _build_encode_sharded(dev):
    from m3_tpu_torch.parallel import sharded_encode

    S, T = CANONICAL["S"], CANONICAL["T"]
    ow = _out_words(T)

    def fn(ts, vb, start, valid):
        return sharded_encode.encode_batch_device_sharded(
            ts, vb, start, valid, unit=1, out_words=ow, devices=_shard_devices(dev))

    return fn, _codec_args(dev), S * T, {"S": S, "T": T, "out_words": ow,
                                         "devices": CANONICAL["SHARD_DEVICES"]}


def _arena_batch(dev) -> dict:
    """The seeded ingest batch: N points over every window and slot, some
    lanes hit twice, some points out of range (dropped)."""
    W, C, N = CANONICAL["W"], CANONICAL["C"], CANONICAL["N"]
    rng = np.random.default_rng(SEED)
    windows = rng.integers(0, W, N).astype(np.int32)
    slots = rng.integers(0, C, N).astype(np.int32)
    slots[::97] = C  # out of range: drops
    idx = np.where(slots < C, windows.astype(np.int64) * C + slots, W * C)
    fvals = np.round(rng.normal(50, 10, N), 2)
    fvals[::211] = np.nan
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return {"windows": t(windows), "slots": t(slots), "idx": t(idx),
            "ivals": t(rng.integers(0, 1000, N).astype(np.int64)), "fvals": t(fvals),
            "times": t(1_700_000_000 * 10**9 + rng.integers(0, 60, N) * 10**9)}


def _arena_cfg(**extra) -> dict:
    cfg = {"W": CANONICAL["W"], "C": CANONICAL["C"], "N": CANONICAL["N"]}
    cfg.update(extra)
    return cfg


def _build_rollup_ingest_packed(dev):
    from m3_tpu_torch.aggregator import packed

    W, C = CANONICAL["W"], CANONICAL["C"]
    a = _arena_batch(dev)
    args = (packed.counter_init(W, C, device=dev), packed.gauge_init(W, C, device=dev),
            a["idx"], a["ivals"], a["fvals"], a["times"])

    def fn(cs, gs, idx, iv, fv, times):
        return packed.rollup_ingest(cs, gs, idx, iv, fv, times, num_windows=W, capacity=C)

    return fn, args, CANONICAL["N"], _arena_cfg(layout="packed", op="rollup_ingest")


def _arena_state(kind: str, layout: str, dev):
    """A (kind, layout) arena state holding the seeded batch."""
    from m3_tpu_torch.aggregator import arena, packed

    W, C, SCAP = CANONICAL["W"], CANONICAL["C"], CANONICAL["SCAP"]
    a = _arena_batch(dev)
    if layout == "f64":
        if kind == "counter":
            return arena.counter_ingest(arena.counter_init(W, C, device=dev), a["idx"],
                                        a["slots"], a["ivals"], a["times"])
        if kind == "gauge":
            return arena.gauge_ingest(arena.gauge_init(W, C, device=dev), a["idx"],
                                      a["slots"], a["fvals"], a["times"])
        return arena.timer_ingest(arena.timer_init(W, C, SCAP, device=dev), a["windows"],
                                  a["slots"], a["fvals"], a["times"], capacity=C)
    if kind == "counter":
        cs, _ = packed.rollup_ingest(packed.counter_init(W, C, device=dev),
                                     packed.gauge_init(W, C, device=dev), a["idx"],
                                     a["ivals"], a["fvals"], a["times"], num_windows=W,
                                     capacity=C)
        return cs
    if kind == "gauge":
        _, gs = packed.rollup_ingest(packed.counter_init(W, C, device=dev),
                                     packed.gauge_init(W, C, device=dev), a["idx"],
                                     a["ivals"], a["fvals"], a["times"], num_windows=W,
                                     capacity=C)
        return gs
    return packed.timer_ingest(packed.timer_init(W, C, SCAP, device=dev), a["windows"],
                               a["slots"], a["fvals"], a["times"], capacity=C)


def _build_ingest_f64(kind: str, dev):
    from m3_tpu_torch.aggregator import arena

    W, C, SCAP = CANONICAL["W"], CANONICAL["C"], CANONICAL["SCAP"]
    a = _arena_batch(dev)
    if kind == "counter":
        args = (arena.counter_init(W, C, device=dev), a["idx"], a["slots"], a["ivals"],
                a["times"])
        fn = arena.counter_ingest
    elif kind == "gauge":
        args = (arena.gauge_init(W, C, device=dev), a["idx"], a["slots"], a["fvals"],
                a["times"])
        fn = arena.gauge_ingest
    else:
        args = (arena.timer_init(W, C, SCAP, device=dev), a["windows"], a["slots"],
                a["fvals"], a["times"])
        fn = functools.partial(arena.timer_ingest, capacity=C)
    cfg = _arena_cfg(layout="f64", op=f"{kind}_ingest")
    if kind == "timer":
        cfg["SCAP"] = SCAP
    return fn, args, CANONICAL["N"], cfg


def _build_timer_ingest_packed(dev):
    from m3_tpu_torch.aggregator import packed

    W, C, SCAP = CANONICAL["W"], CANONICAL["C"], CANONICAL["SCAP"]
    a = _arena_batch(dev)
    args = (packed.timer_init(W, C, SCAP, device=dev), a["windows"], a["slots"],
            a["fvals"], a["times"])
    return (functools.partial(packed.timer_ingest, capacity=C), args, CANONICAL["N"],
            _arena_cfg(layout="packed", op="timer_ingest", SCAP=SCAP))


def _build_consume(kind: str, layout: str, dev):
    from m3_tpu_torch.aggregator import arena, packed

    C, SCAP = CANONICAL["C"], CANONICAL["SCAP"]
    mod = arena if layout == "f64" else packed
    st = _arena_state(kind, layout, dev)
    consume = getattr(mod, f"{kind}_consume")
    cfg = _arena_cfg(layout=layout, op=f"{kind}_consume")
    if kind == "timer":
        q = CANONICAL["QUANTILES"]
        fn = functools.partial(consume, window=1, capacity=C, quantiles=q)
        cfg.update(SCAP=SCAP, quantiles=list(q))
    else:
        fn = functools.partial(consume, window=1, capacity=C)
    return fn, (st,), SCAP if kind == "timer" else C, cfg


# Every hot-path program, by name (the reference's names where the port
# has the program; see STAGE_MAP).  Order is the reference's.
STAGES: tuple = (
    Stage("decode/fused", functools.partial(_build_decode, "fused")),
    Stage("decode/gather", functools.partial(_build_decode, "gather")),
    Stage("decode/sharded", _build_decode_sharded),
    Stage("encode", _build_encode),
    Stage("encode/sharded", _build_encode_sharded),
    Stage("arena/rollup_ingest_packed", _build_rollup_ingest_packed),
    Stage("arena/counter_ingest_f64", functools.partial(_build_ingest_f64, "counter")),
    Stage("arena/gauge_ingest_f64", functools.partial(_build_ingest_f64, "gauge")),
    Stage("arena/counter_consume_packed",
          functools.partial(_build_consume, "counter", "packed")),
    Stage("arena/counter_consume_f64", functools.partial(_build_consume, "counter", "f64")),
    Stage("arena/gauge_consume_packed",
          functools.partial(_build_consume, "gauge", "packed")),
    Stage("arena/gauge_consume_f64", functools.partial(_build_consume, "gauge", "f64")),
    Stage("timer/ingest_packed", _build_timer_ingest_packed),
    Stage("timer/ingest_f64", functools.partial(_build_ingest_f64, "timer")),
    Stage("timer/consume_packed", functools.partial(_build_consume, "timer", "packed")),
    Stage("timer/consume_f64", functools.partial(_build_consume, "timer", "f64")),
)

# The reference's stage -> the port's.  Where the reference registers
# several tails of one program and the port has one path, that path
# stands under the counterpart's name: both extraction impls of the
# gather tail are kernel #2 on the card (its plain version on the CPU),
# and all three placement tails of the encode are kernel #1.
STAGE_MAP = {
    "decode/fused": "decode/fused",
    "decode/gather": "decode/gather",
    "decode/gather_pallas": "decode/gather",
    "decode/sharded": "decode/sharded",
    "encode/gather": "encode",
    "encode/scatter": "encode",
    "encode/pallas": "encode",
    "encode/sharded": "encode/sharded",
    **{n: n for n in (
        "arena/rollup_ingest_packed", "arena/counter_ingest_f64",
        "arena/gauge_ingest_f64", "arena/counter_consume_packed",
        "arena/counter_consume_f64", "arena/gauge_consume_packed",
        "arena/gauge_consume_f64", "timer/ingest_packed", "timer/ingest_f64",
        "timer/consume_packed", "timer/consume_f64")},
}

# The hand kernels each stage launches on the card, by the wrappers'
# kernel names (``devseams.launched``); every other stage launches none.
STAGE_KERNELS = {
    "decode/fused": ("decode_scan",),
    "decode/gather": ("decode_scan", "extract_fields"),
    "decode/sharded": ("decode_scan", "extract_fields"),
    "encode": ("encode_scan", "place_words"),
    "encode/sharded": ("encode_scan", "place_words"),
    "arena/counter_ingest_f64": ("segment_ingest", "segment_minmax"),
    "arena/gauge_ingest_f64": ("segment_ingest", "segment_minmax"),
    "timer/ingest_f64": ("segment_ingest",),
}


def stage_names() -> tuple:
    return tuple(s.name for s in STAGES)


# ---------------------------------------------------------------------------
# The stage cache: ONE counted run per stage per device per process.
# ---------------------------------------------------------------------------


class CountedStage(NamedTuple):
    """One registry stage, run and counted once on one device."""

    name: str
    device: str
    fingerprint: dict
    datapoints: int
    config: dict
    records: dict  # Census.records() of the counted run


_STAGE_CACHE: Dict[tuple, CountedStage] = {}


def clear_stage_cache() -> None:
    """Drop every cached fingerprint (a second build in one process)."""
    _STAGE_CACHE.clear()


def _unknown(names) -> KeyError:
    return KeyError(f"unknown costwatch stage(s): {sorted(names)}; "
                    f"known: {list(stage_names())}")


def counted_stage(name: str, device=None) -> CountedStage:
    """The cached :class:`CountedStage` of one stage on ``device`` (None =
    CUDA), built, warmed and counted on first use."""
    dev = resolve_device(device)
    key = (name, str(dev))
    cs = _STAGE_CACHE.get(key)
    if cs is not None:
        return cs
    by_name = {s.name: s for s in STAGES}
    if name not in by_name:
        raise _unknown([name])
    fn, args, datapoints, cfg = by_name[name].build(dev)
    fp, c = _fingerprint(fn, args, datapoints, dev)
    cs = CountedStage(name=name, device=str(dev), fingerprint=fp,
                      datapoints=int(datapoints), config=dict(cfg), records=c.records())
    _STAGE_CACHE[key] = cs
    return cs


def counted_stages(names=None, device=None, on_stage=None) -> Dict[str, CountedStage]:
    """Cached :class:`CountedStage` map in registry order (or a subset);
    unknown names fail before any run.  ``on_stage(name, seconds)``
    reports each stage's wall in THIS call (near zero on a cache hit)."""
    want = set(names) if names is not None else None
    if want is not None and want - set(stage_names()):
        raise _unknown(want - set(stage_names()))
    out: Dict[str, CountedStage] = {}
    for stage in STAGES:
        if want is not None and stage.name not in want:
            continue
        t0 = time.perf_counter()
        out[stage.name] = counted_stage(stage.name, device)
        if on_stage is not None:
            on_stage(stage.name, time.perf_counter() - t0)
    return out


def run_stages(names=None, device=None, on_stage=None) -> Dict[str, dict]:
    """Fingerprint the registry (or a subset) on ``device``: stage name ->
    fingerprint with its ``config``."""
    return {name: dict(cs.fingerprint, config=dict(cs.config))
            for name, cs in counted_stages(names, device, on_stage).items()}


# ---------------------------------------------------------------------------
# ops/dp cross-check: the census's live per-step counts against the
# documented ones.
# ---------------------------------------------------------------------------


def decode_step_ops(wpad, nbits, unit0, tbl) -> int:
    """Dispatches of one decode step as the tensors' device runs it (the
    decoder's padded words, bit lengths, initial units and control
    table): ``_decode_step``'s ops on the CPU; on a card, one slot of the
    scan kernel (``decode_scan`` at ``max_points=1``: the launch and its
    wrapper's ops).  Warmed first."""
    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.parallel import decode_scan

    if wpad.device.type == "cuda":
        step = functools.partial(decode_scan.decode_scan, wpad, nbits, unit0, tbl, 1)
        step()  # warm: the kernel's build and load
        return count_step_ops(step)
    carry = mt._decode_carry0(wpad.shape[0], wpad.device)
    mt._decode_step(carry, wpad, nbits, unit0, tbl)  # warm
    return count_step_ops(mt._decode_step, carry, wpad, nbits, unit0, tbl)


def _decode_step_ops(dev) -> int:
    from m3_tpu_torch.encoding import m3tsz_torch as mt

    S = CANONICAL["S"]
    words, nbits = _streams(S, CANONICAL["T"])
    wpad = torch.nn.functional.pad(torch.from_numpy(words).to(dev), (0, mt._PAD_WORDS))
    nb = torch.from_numpy(nbits).to(dev)
    unit0 = torch.ones(S, dtype=torch.int64, device=dev)
    return decode_step_ops(wpad, nb, unit0, mt.value_ctrl_table(dev))


def encode_step_ops(ts, vb, start, valid) -> int:
    """Dispatches of one encode step (unit SECOND) as the tensors' device
    runs it (the encoder's (S, T) timestamps, value bits and mask and its
    (S,) starts): ``_encode_step``'s ops on the CPU; on a card, one step
    of the scan kernel (``encode_scan`` at T = 1: the launch and its
    wrapper's ops).  Warmed first."""
    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.parallel import encode_scan

    carry = mt._encode_carry0(ts.shape[0], start, 1, 1)
    if ts.device.type == "cuda":
        cols = [x[:, :1].t().contiguous() for x in (ts, vb, valid)]
        step = functools.partial(encode_scan.encode_scan, *cols, carry, 1, True)
        step()  # warm: the kernel's build and load
        return count_step_ops(step)
    step = functools.partial(mt._encode_step, unit=1, default_unit_is_32bit=True)
    step(carry, ts[:, 0], vb[:, 0], valid[:, 0])  # warm
    return count_step_ops(step, carry, ts[:, 0], vb[:, 0], valid[:, 0])


def _encode_step_ops(dev) -> int:
    return encode_step_ops(*_codec_args(dev))


def step_ops_crosscheck(stage_fps: Dict[str, dict], device=None) -> dict:
    """The documented per-step counts against the live ones, with the
    stages' dispatches per datapoint beside them.  A step's count does
    not depend on S or on the data (the step is branchless), so the
    documented number stays true until the formulation moves."""
    dev = resolve_device(device)
    out: dict = {}
    for key, live_fn, stage in (("decode", _decode_step_ops, "decode/gather"),
                                ("encode", _encode_step_ops, "encode")):
        doc = (DOCUMENTED_CARD_OPS_PER_DP if dev.type == "cuda"
               else DOCUMENTED_OPS_PER_DP)[f"{key}_step"]
        live = live_fn(dev)
        rec = {"documented_ops_per_dp": doc, "census_step_ops": live,
               "census_vs_documented": round(live / doc, 3)}
        fp = stage_fps.get(stage)
        if fp:
            rec["stage_dispatches_per_dp"] = fp["dispatches_per_dp"]
            rec["stage_vs_step"] = round(fp["dispatches_per_dp"] * CANONICAL["S"]
                                         / max(live, 1), 4)
        out[key] = rec
    out["explanation"] = (
        "census_step_ops counts every aten op of one phase-1 step for all S "
        "series at once (the eager loop runs one step per datapoint; on a card "
        "each scan's step is one slot of its scan kernel, the launch and its "
        "wrapper's ops); a "
        "stage's dispatches_per_dp divides the whole pass's dispatches by S*T, "
        "so stage_vs_step near 1.0 says phase 1 is the pass, and the rest is "
        "phase 2 and the set-up.  Both come from the same census.")
    return out
