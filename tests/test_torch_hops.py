"""The port's HOPS pipeline (``m3_tpu_torch/tools/hops.py``) against the
JAX package's ``m3_tpu.tools.hops.run_pipeline``.

On a reduced corpus (the pinned generator at fewer series and seconds)
both packages write their cold and steady volumes; every file is
byte-identical and the volumes' sha256 digests equal.  The port's report
carries the reference's per-hop ledger (``steady``, ``cold``,
``transfers``, ``bytes_moved``, ``dispatches``) with the reference's
keys and hop entries; on the CPU it counts no transfer or dispatch.  The pinned corpus
(1,024 series x 320 s) takes the JAX package about 90 s a pass on a CPU,
so its digest is pinned as a constant (``PINNED_VOLUME_SHA256``), derived
from the JAX package's volume in ``test_torch_hops_pinned.py`` and held
on the card by ``chip_smoke.py`` phase 19 (a); here the constant is
checked to be the one the script holds.  The reshape between drain and encode is held against the
reference's per-row loop on ragged input.
"""

import re
from pathlib import Path

import numpy as np
import pytest

import m3_tpu.tools.hops as jhops
import m3_tpu_torch.tools.hops as thops

ROOT = Path(__file__).resolve().parent.parent


def files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(Path(root).rglob("*")) if p.is_file()}


@pytest.mark.parametrize("S,T", [(48, 20), (7, 31)])
def test_volume_equals_the_jax_pipeline(S, T, tmp_path):
    jdoc = jhops.run_pipeline(S, T, root=str(tmp_path / "jax"))
    tdoc = thops.run_pipeline(S, T, root=str(tmp_path / "port"), device="cpu")
    for p in ("cold", "steady"):
        j, t = files(tmp_path / "jax" / p), files(tmp_path / "port" / p)
        assert t == j and any(k.endswith("-data.db") for k in t)
        assert thops.volume_digest(tmp_path / "port" / p) == \
            thops.volume_digest(tmp_path / "jax" / p)
    assert tdoc["volume_sha256"] == tdoc["cold_volume_sha256"] == \
        thops.volume_digest(tmp_path / "jax" / "steady")
    assert tdoc["config"]["samples"] == jdoc["config"]["samples"] == S * T
    assert tdoc["config"]["wire_bytes"] == jdoc["config"]["wire_bytes"]
    assert set(tdoc["hops"]) == set(jdoc["hops"]) == set(thops.HOPS)
    shares = [h["host_time_fraction"] for h in tdoc["hops"].values()]
    assert abs(sum(shares) - 1.0) < 1e-9 and min(shares) >= 0
    # the per-hop ledger, with the reference's keys and entries; on the
    # CPU nothing crosses a device boundary (the card's ledger is held
    # against torch.profiler by chip_smoke.py phase 24)
    assert "not_measured" not in tdoc
    for h in thops.HOPS:
        t, j = tdoc["hops"][h], jdoc["hops"][h]
        assert {"steady", "cold", "transfers", "bytes_moved", "dispatches"} <= set(t)
        for led in ("steady", "cold"):
            assert set(t[led]) == set(j[led])
            assert t[led]["entries"] == j[led]["entries"] > 0
            assert (t[led]["h2d_count"], t[led]["d2h_count"], t[led]["dispatches"],
                    t[led]["compiles"]) == (0, 0, 0, 0)
        assert (t["transfers"], t["bytes_moved"], t["dispatches"]) == (0, 0, 0)
    for k in ("transfer_bytes_steady", "transfers_steady", "dispatches_steady",
              "compiles_cold", "compiles_steady"):
        assert tdoc["pipeline"][k] == 0 and k in jdoc["pipeline"]
    assert tdoc["ledger_volume_sha256"] == tdoc["volume_sha256"]


def test_frames_are_the_jax_frames():
    ids, ts, vals = thops._corpus(33, 12)
    jids, jts, jvals = jhops._corpus(33, 12)
    assert ids == jids and np.array_equal(ts, jts) and np.array_equal(vals, jvals)
    assert thops._encode_frames(ids, ts, vals) == jhops._encode_frames(jids, jts, jvals)


def _reference_reshape(ids, times, values):
    """``m3_tpu/tools/hops.py``'s reshape loop, over rows."""
    series = {}
    for sid, t, v in zip(ids, times.tolist(), values.tolist()):
        series.setdefault(sid, []).append((t, v))
    sids = sorted(series)
    W = max(len(p) for p in series.values())
    tmat = np.zeros((len(sids), W), np.int64)
    vmat = np.zeros((len(sids), W), np.float64)
    counts = np.zeros(len(sids), np.int64)
    for r, sid in enumerate(sids):
        pts = sorted(series[sid])
        counts[r] = len(pts)
        tmat[r, :len(pts)] = [t for t, _ in pts]
        vmat[r, :len(pts)] = [v for _, v in pts]
        if len(pts) < W:
            tmat[r, len(pts):] = tmat[r, len(pts) - 1]
            vmat[r, len(pts):] = vmat[r, len(pts) - 1]
    return sids, tmat, vmat, counts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_window_matrix_equals_the_reference_reshape(seed):
    rng = np.random.default_rng(seed)
    n_ids, n_win = 200, 9
    rows = [(b"s%04d" % rng.integers(0, 10_000), w) for w in range(n_win)
            for _ in range(n_ids)]
    rows = list({r: None for r in rows})  # one row an (id, window)
    order = rng.permutation(len(rows))
    ids = [rows[i][0] for i in order]
    times = np.array([10**12 + rows[i][1] * 10**10 for i in order], np.int64)
    values = np.round(rng.normal(0, 100, len(order)), 3)
    got = thops.window_matrix(ids, times, values)
    want = _reference_reshape(ids, times, values)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert len(set(got[3].tolist())) > 1  # ragged


def test_pinned_digest_is_the_one_chip_smoke_holds():
    src = (ROOT / "chip_smoke.py").read_text()
    m = re.search(r'HOPS_PINNED_SHA256 = \(\s*"([0-9a-f]{64})"\)', src)
    assert m and m.group(1) == thops.PINNED_VOLUME_SHA256


def test_cli_runs_a_reduced_corpus_on_the_cpu(tmp_path, capsys):
    assert thops.main(["--S", "5", "--T", "12", "--device", "cpu",
                       "--root", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert '"artifact": "PIPELINE"' in out and (tmp_path / "steady").is_dir()
