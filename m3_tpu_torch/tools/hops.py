"""Profile the aggregator node's ingest pipeline hop by hop, on the card.

The port's counterpart of ``m3_tpu/tools/hops.py``: the same pinned
synthetic gauge corpus through the same hops —

    wire parse → arena ingest → window drain → encode → fileset bytes

— frames decoded off their wire bytes (``msg/protocol``), batches
ingested into the aggregator's arenas a window at a time, each closed
window drained, the drained LAST values encoded (kernel #1 on the card)
and written as one fileset volume.  The volume is byte-identical to the
one ``m3_tpu.tools.hops.run_pipeline(root=...)`` writes for the same
corpus.

Three passes over the corpus, each writing its own volume:

1. ``cold``, under ``x/hopwatch``: the cold ledger (the kernels' builds,
   the first loads and lazy initialisations);
2. ``steady``, not counted: the walls (each hop's ends in
   ``torch.cuda.synchronize()`` on a CUDA device), each hop's share of
   the steady wall and samples/s — counting costs host time, so no wall
   of the report but a ledger's own ``wall_s`` is taken under it;
3. ``ledger``, under ``x/hopwatch``: the steady ledger.

Each hop's ledger (``steady``, ``cold``) has the reference's keys:
transfers host→device and device→host with their bytes, builds
(``compiles``) and dispatches (device ops plus hand-kernel grids), and
``transfers``, ``bytes_moved`` and ``dispatches`` from the steady one.
``seams`` breaks both ledgers down by the op, factory or kernel each
count came from (``x/hopwatch.seams``).
On ``device="cpu"`` nothing crosses a device boundary, so the ledger
counts no transfer and no dispatch.

    python -m m3_tpu_torch.tools.hops [--S 1024] [--T 320] [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import tempfile
import time
from pathlib import Path

import numpy as np

HOPS = ("wire_parse", "arena_ingest", "window_drain", "encode",
        "fileset_write")

# pinned corpus geometry (the reference's): S series x T 1s-spaced
# samples, 10s windows -> T/10 drains
S_DEFAULT = 1024
T_DEFAULT = 320
RESOLUTION_S = 10
BLOCK_NANOS = 2 * 3600 * 10**9
START = (1_700_000_000 * 10**9) // BLOCK_NANOS * BLOCK_NANOS

# sha256 of the pinned corpus's volume (``volume_digest``), as the JAX
# package's ``run_pipeline`` writes it (tests/test_torch_hops_pinned.py
# derives it from that package)
PINNED_VOLUME_SHA256 = (
    "ed52859a25cd0dcad9eda465ea4955d81e8218dd552641d955b2e156446bcf01")


def _corpus(S: int, T: int, seed: int = 42):
    """Gauge rows: one wire frame per timestamp (all S series sampled
    together — the common scrape shape)."""
    rng = np.random.default_rng(seed)
    ids = [b"hop-series-%06d" % i for i in range(S)]
    base = rng.uniform(10, 1000, S)
    ts = START + np.arange(1, T + 1, dtype=np.int64) * 10**9
    vals = np.round(base[None, :] + rng.normal(0, base * 0.05, (T, S)), 2)
    return ids, ts, vals


def _encode_frames(ids, ts, vals):
    """Pre-encode the wire payloads (client-side work, never part of
    the server pipeline being profiled)."""
    from m3_tpu_torch.msg import protocol as wire

    T, S = vals.shape
    mts = np.full(S, 3, np.uint8)  # MetricType.GAUGE
    return [wire.encode_metric_batch(wire.MetricBatch(
        mts, ids, vals[t].astype(np.float64), np.full(S, ts[t], np.int64)))
        for t in range(T)]


def window_matrix(ids: list, times: np.ndarray, values: np.ndarray):
    """Flushed rows (one id, time and value each) → the encoder's input:
    ids in byte order, each row's points in time order, padded with its
    last point.  Returns (sids, tmat, vmat, counts).  Each id holds one
    row a window, so time order is a total order within an id."""
    sids = sorted(set(ids))
    rank = {sid: r for r, sid in enumerate(sids)}
    row = np.fromiter((rank[i] for i in ids), np.int64, len(ids))
    order = np.lexsort((values, times, row))
    times, values = times[order], values[order]
    counts = np.bincount(row, minlength=len(sids)).astype(np.int64)
    W = int(counts.max()) if len(sids) else 0
    first = np.zeros(len(sids), np.int64)
    np.cumsum(counts[:-1], out=first[1:])
    src = first[:, None] + np.minimum(np.arange(W)[None, :], counts[:, None] - 1)
    return sids, times[src].astype(np.int64), values[src].astype(np.float64), counts


def flushed_rows(agg, flushed, policy):
    """The (id, time, value) rows of ``flushed`` (one list's batches)."""
    from m3_tpu_torch.metrics.types import MetricType

    ml = agg.shards[0].lists[policy]
    id_of = ml.maps[MetricType.GAUGE].id_of
    ids, ts, vs = [], [], []
    for fm in flushed:
        ids.extend(id_of(int(s)) for s in fm.slots.tolist())
        ts.append(np.full(len(fm.slots), fm.timestamp_nanos, np.int64))
        vs.append(np.asarray(fm.values, np.float64))
    return (ids, np.concatenate(ts) if ts else np.zeros(0, np.int64),
            np.concatenate(vs) if vs else np.zeros(0, np.float64))


def write_volume(sids, tmat, vmat, counts, root, device, namespace: str = "default",
                 block_start: int = START, block_size: int = BLOCK_NANOS,
                 timings: dict | None = None):
    """The tail of the path: ``encode_batch`` (kernel #1 on the card),
    then ``DataFileSetWriter`` (shard 0, volume 0) — the reference's
    encode and fileset hops, with its ``out_words``.  Returns the
    fallback mask."""
    from m3_tpu_torch.encoding.m3tsz_torch import encode_batch
    from m3_tpu_torch.persist.fs import DataFileSetWriter

    W = tmat.shape[1]
    with _hop(timings, "encode", device):
        streams, fallback = encode_batch(
            tmat, vmat, np.full(len(sids), block_start, np.int64), counts=counts,
            out_words=max(16, W * 40 // 64 + 8), device=device)
    with _hop(timings, "fileset_write", device):
        out = [(sid, streams[r]) for r, sid in enumerate(sids) if not fallback[r]]
        DataFileSetWriter(str(root), namespace, 0, block_start, block_size,
                          volume=0).write_all(out)
    return fallback


def volume_digest(root) -> str:
    """sha256 over a pass's files: each file's path relative to
    ``root``, then its bytes, in path order."""
    root = Path(root)
    h = hashlib.sha256()
    for p in sorted(root.rglob("*")):
        if p.is_file():
            h.update(p.relative_to(root).as_posix().encode())
            h.update(p.read_bytes())
    return h.hexdigest()


@contextlib.contextmanager
def _hop(stats: dict | None, name: str, device):
    """A hop's scope: its wall into ``stats`` (ending in a synchronize on
    a CUDA device), and, while ``x/hopwatch`` is installed, its ledger."""
    from m3_tpu_torch.x import hopwatch

    with hopwatch.hop(name) if hopwatch.installed() else contextlib.nullcontext():
        t0 = time.perf_counter()
        yield
        if stats is not None:
            if device is not None and device.type == "cuda":
                import torch

                torch.cuda.synchronize(device)
            stats[name] = stats.get(name, 0.0) + time.perf_counter() - t0


def _run_pass(frames, policy, opts, root: Path, device):
    """One full wire→fileset pass; returns (hop walls, samples).  Under
    ``x/hopwatch``, each hop's ledger too."""
    from m3_tpu_torch.aggregator.engine import Aggregator
    from m3_tpu_torch.metrics.types import MetricType
    from m3_tpu_torch.msg import protocol as wire

    res_nanos = RESOLUTION_S * 10**9
    agg = Aggregator(num_shards=1, opts=opts, device=device)
    walls: dict = {}
    n_samples = 0
    flushed = []
    rows_per_window = RESOLUTION_S  # 1s spacing
    for lo in range(0, len(frames), rows_per_window):
        with _hop(walls, "wire_parse", device):
            batches = [wire.decode_metric_batch(p)
                       for p in frames[lo:lo + rows_per_window]]
        with _hop(walls, "arena_ingest", device):
            for b in batches:
                agg.add_untimed_batch(MetricType.GAUGE, b.ids, b.values, b.times)
                n_samples += len(b.ids)
        last_t = int(batches[-1].times[0])
        with _hop(walls, "window_drain", device):
            flushed.extend(agg.consume(
                (last_t // res_nanos) * res_nanos + res_nanos))
    # the reshape sits outside the hops, as in the reference
    sids, tmat, vmat, counts = window_matrix(*flushed_rows(agg, flushed, policy))
    write_volume(sids, tmat, vmat, counts, root, device, timings=walls)
    return walls, n_samples


def ledger_pass(frames, policy, opts, root: Path, device):
    """One pass under ``x/hopwatch``: (the per-hop ledgers, the ledger by
    seam, samples).  Installs the profiler for the pass unless it is
    installed, and resets it first."""
    from m3_tpu_torch.x import hopwatch

    was = hopwatch.installed()
    hopwatch.install()
    try:
        hopwatch.reset()
        _, n = _run_pass(frames, policy, opts, root, device)
        return hopwatch.stats(), hopwatch.seams(), n
    finally:
        if not was:
            hopwatch.uninstall()


def pipeline_inputs(S: int = S_DEFAULT, T: int = T_DEFAULT):
    """(frames, policy, aggregator options) of the corpus at S x T."""
    from m3_tpu_torch.aggregator.engine import AggregatorOptions
    from m3_tpu_torch.metrics.policy import StoragePolicy

    policy = StoragePolicy.parse(f"{RESOLUTION_S}s:2d")
    opts = AggregatorOptions(
        capacity=1 << max(10, (S - 1).bit_length()), num_windows=4,
        storage_policies=(policy,))
    return _encode_frames(*_corpus(S, T)), policy, opts


def run_pipeline(S: int = S_DEFAULT, T: int = T_DEFAULT,
                 root: str | None = None, device=None) -> dict:
    """Three-pass profile on ``device`` (None = CUDA); returns the report.
    The volumes land under ``root`` (``cold/``, ``steady/`` and
    ``ledger/``), or in a temporary directory."""
    import torch

    from m3_tpu_torch import resolve_device

    dev = resolve_device(device)
    frames, policy, opts = pipeline_inputs(S, T)
    with tempfile.TemporaryDirectory() as tmp:
        base = Path(root) if root else Path(tmp)
        cold, cold_seams, n = ledger_pass(frames, policy, opts, base / "cold", dev)
        # _run_pass is host-synced by construction: each hop ends in
        # torch.cuda.synchronize() on a card, the drain pulls lanes to numpy
        # and the fileset writer consumes host bytes before returning, so
        # the wall pair measures completed work, not an async enqueue.
        # m3lint: disable=transfer-hygiene
        t0 = time.perf_counter()
        walls, _ = _run_pass(frames, policy, opts, base / "steady", dev)
        steady_wall = time.perf_counter() - t0
        steady, steady_seams, _ = ledger_pass(frames, policy, opts, base / "ledger", dev)
        digests = {p: volume_digest(base / p) for p in ("cold", "steady", "ledger")}
    total = sum(walls.get(h, 0.0) for h in HOPS)
    hops = {}
    for h in HOPS:
        st = steady.get(h, {})
        hops[h] = {
            "steady": st, "cold": cold.get(h, {}),
            "steady_wall_s": walls.get(h, 0.0),
            "host_time_fraction": walls.get(h, 0.0) / total if total else 0.0,
            "transfers": st.get("h2d_count", 0) + st.get("d2h_count", 0),
            "bytes_moved": st.get("h2d_bytes", 0) + st.get("d2h_bytes", 0),
            "dispatches": st.get("dispatches", 0),
        }
    return {
        "artifact": "PIPELINE",
        "generated_by": "python -m m3_tpu_torch.tools.hops",
        "config": {
            "S": S, "T": T, "resolution_s": RESOLUTION_S, "samples": n,
            "wire_bytes": sum(len(f) for f in frames), "device": str(dev),
            "device_name": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
        },
        "passes": {
            "cold": "pass 1, under x/hopwatch: the hops' cold ledgers",
            "steady": "pass 2, not counted: every wall, share and rate",
            "ledger": "pass 3, under x/hopwatch: the hops' steady ledgers",
        },
        "hops": hops,
        "pipeline": {
            "wall_steady_s": steady_wall,
            "samples_per_s_wire_to_bytes": n / steady_wall if steady_wall else 0.0,
            "transfer_bytes_steady": sum(v["bytes_moved"] for v in hops.values()),
            "transfers_steady": sum(v["transfers"] for v in hops.values()),
            "dispatches_steady": sum(v["dispatches"] for v in hops.values()),
            "compiles_cold": sum(v["cold"].get("compiles", 0) for v in hops.values()),
            "compiles_steady": sum(v["steady"].get("compiles", 0) for v in hops.values()),
        },
        "seams": {"cold": cold_seams, "steady": steady_seams},
        "volume_sha256": digests["steady"],
        "cold_volume_sha256": digests["cold"],
        "ledger_volume_sha256": digests["ledger"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--S", type=int, default=S_DEFAULT)
    ap.add_argument("--T", type=int, default=T_DEFAULT)
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    ap.add_argument("--root", default=None, help="keep the volumes here")
    args = ap.parse_args(argv)
    doc = run_pipeline(args.S, args.T, args.root, args.device)
    print(json.dumps(doc, indent=2))
    digests = {doc["volume_sha256"], doc["cold_volume_sha256"], doc["ledger_volume_sha256"]}
    pinned = (args.S, args.T) == (S_DEFAULT, T_DEFAULT)
    return 1 if len(digests) > 1 or (pinned and doc["volume_sha256"] != PINNED_VOLUME_SHA256) else 0


if __name__ == "__main__":
    raise SystemExit(main())
