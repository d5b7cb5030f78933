"""The port's device-hop profiler (``m3_tpu_torch.x.hopwatch``) against
the JAX package's (``m3_tpu.x.hopwatch``) on the CPU.

The same scripted transfers give the same per-hop transfer counts and
bytes and the same hop entries: the JAX side moves numpy arrays with
``jax.device_put`` and ``jax.device_get``; the port moves them onto and
off the ``meta`` device, its stand-in for a device off the CPU, through
each of its seams (``torch.as_tensor``, ``torch.tensor``, an ndarray's
``.to``, ``.cpu()``, ``.to("cpu")``, ``.tolist()``, a cross-device
``copy_``).  The meta device holds no data, so a download raises after
the seam has counted it, as the reference counts before ``device_get``
runs.  Nesting, ``"(unattributed)"`` and ``snapshot``/``since`` behave
as the reference's; a native build counts one compile, a library found
built none; compute on the device counts dispatches and no transfer;
and CPU tensors cross no boundary.
"""

import threading

import numpy as np
import pytest
import torch

import m3_tpu.x.hopwatch as jhw
import m3_tpu_torch.x.hopwatch as thw
from m3_tpu_torch.x import devseams

KEYS = ("entries", "h2d_count", "h2d_bytes", "d2h_count", "d2h_bytes")


@pytest.fixture()
def port():
    thw.install()
    thw.reset()
    try:
        yield thw
    finally:
        thw.uninstall()
        thw.reset()


def jax_script():
    import jax

    jhw.install()
    jhw.reset()
    try:
        jax.device_put(np.arange(8, dtype=np.int64))
        with jhw.hop("upload"):
            a = jax.device_put(np.arange(16, dtype=np.float32))
            b = jax.device_put(np.zeros((4, 4), np.float64))
            jax.device_put(np.ones(3, np.int32))
            jax.device_put(np.arange(5, dtype=np.int16))
        with jhw.hop("outer"):
            with jhw.hop("inner"):
                jax.device_put(np.ones(6, np.float64))
            jax.device_get(a)
        with jhw.hop("download"):
            jax.device_get(b)
            jax.device_get(a)
        snap = jhw.snapshot()
        with jhw.hop("download"):
            jax.device_get(b)
            jax.device_put(np.zeros(2, np.int64))
        delta = jhw.since(snap)
        return jhw.stats(), jhw.totals(), delta
    finally:
        jhw.uninstall()
        jhw.reset()


def down(t, how):
    """A download off the meta device: the seam counts it, then the copy
    raises (the device holds no data)."""
    with pytest.raises(NotImplementedError):
        how(t)


def port_script():
    thw.install()
    thw.reset()
    try:
        torch.as_tensor(np.arange(8, dtype=np.int64), device="meta")
        with thw.hop("upload"):
            a = torch.as_tensor(np.arange(16, dtype=np.float32), device="meta")
            b = torch.from_numpy(np.zeros((4, 4), np.float64)).to("meta")
            torch.tensor([1, 1, 1], dtype=torch.int32, device="meta")
            torch.empty(5, dtype=torch.int16, device="meta").copy_(
                torch.arange(5, dtype=torch.int16))
        with thw.hop("outer"):
            with thw.hop("inner"):
                torch.as_tensor([1.0] * 6, dtype=torch.float64, device="meta")
            down(a, lambda t: t.cpu())
        with thw.hop("download"):
            down(b, lambda t: t.to("cpu"))
            down(a, lambda t: t.tolist())
        snap = thw.snapshot()
        with thw.hop("download"):
            down(b, lambda t: torch.empty((4, 4), dtype=torch.float64).copy_(t))
            torch.zeros(2, dtype=torch.int64).to("meta")
        delta = thw.since(snap)
        return thw.stats(), thw.totals(), delta
    finally:
        thw.uninstall()
        thw.reset()


def test_scripted_transfers_match_the_jax_hopwatch():
    jst, jtot, jdelta = jax_script()
    tst, ttot, tdelta = port_script()
    assert set(tst) == set(jst) == {"(unattributed)", "upload", "outer", "inner", "download"}
    for hop in jst:
        assert {k: tst[hop][k] for k in KEYS} == {k: jst[hop][k] for k in KEYS}, hop
        assert set(tst[hop]) == set(jst[hop])
    assert {k: ttot[k] for k in KEYS[1:]} == {k: jtot[k] for k in KEYS[1:]}
    for k in ("h2d_count", "h2d_bytes", "d2h_count", "d2h_bytes"):
        assert tdelta[k] == jdelta[k], k
    assert set(tdelta) == set(jdelta)
    # spot values: the upload hop's four uploads, the inner hop's one
    assert tst["upload"]["h2d_bytes"] == 64 + 128 + 12 + 10
    assert tst["inner"]["h2d_count"] == 1 and tst["outer"]["d2h_bytes"] == 64


def test_seams_name_what_was_counted(port):
    with port.hop("h"):
        x = torch.as_tensor(np.arange(8, dtype=np.int64), device="meta")
        y = (x * 2).sum()
        x.view(2, 4)
        down(x, lambda t: t.cpu())
    rows = port.seams()["h"]
    assert rows["h2d:torch.as_tensor"] == [1, 64]
    assert rows["d2h:aten::_to_copy"] == [1, 64]
    assert rows["dispatch:aten::mul"] == [1, 0] and rows["dispatch:aten::sum"] == [1, 0]
    assert not any("view" in k for k in rows)  # views are no dispatch
    st = port.stats()["h"]
    assert st["dispatches"] == 3 and st["h2d_count"] == 1 and st["d2h_count"] == 1
    assert y.device.type == "meta"


def test_device_compute_counts_dispatches_and_no_transfer(port):
    x = torch.zeros(16, device="meta")
    with port.hop("compute"):
        (x + 1).cumsum(0)
        torch.arange(4, device="meta")
    st = port.stats()["compute"]
    assert st["dispatches"] == 3 and st["h2d_count"] == st["d2h_count"] == 0


def test_cpu_tensors_cross_no_boundary(port):
    with port.hop("cpu"):
        t = torch.as_tensor(np.arange(8), device="cpu")
        (t * 2).cpu().tolist()
        torch.tensor([1, 2])[1].item()
    st = port.stats()["cpu"]
    assert (st["h2d_count"], st["d2h_count"], st["dispatches"]) == (0, 0, 0)


def test_hand_kernel_launches_count_on_the_innermost_hop(port):
    with port.hop("encode"):
        with port.hop("inner"):
            devseams.launched("place_words", 1)
        devseams.launched("segment_ingest", 5)
    rows = port.seams()
    assert rows["inner"] == {"dispatch:kernel:place_words": [1, 0]}
    assert rows["encode"] == {"dispatch:kernel:segment_ingest": [5, 0]}
    assert port.stats()["encode"]["dispatches"] == 5


def test_unattributed_and_threads(port):
    """Work in the installing thread outside a hop is unattributed; a
    hop in another thread counts there; another thread's work outside a
    hop is not seen (a dispatch mode is per thread)."""
    torch.as_tensor(np.zeros(2, np.int64), device="meta")

    def worker():
        with thw.hop("worker"):
            torch.as_tensor(np.zeros(4, np.int64), device="meta")
        torch.as_tensor(np.zeros(8, np.int64), device="meta")

    t = threading.Thread(target=worker)
    t.start()
    t.join(30)
    assert not t.is_alive()
    st = port.stats()
    assert st["(unattributed)"]["h2d_bytes"] == 16
    assert st["worker"]["h2d_bytes"] == 32 and st["worker"]["entries"] == 1
    assert port.totals()["h2d_bytes"] == 48


def test_uninstall_stops_counting_and_restores_the_factories():
    before = (torch.tensor, torch.as_tensor)
    thw.install()
    assert (torch.tensor, torch.as_tensor) != before and thw.installed()
    thw.uninstall()
    assert (torch.tensor, torch.as_tensor) == before and not thw.installed()
    thw.reset()
    with thw.hop("after"):
        torch.as_tensor(np.zeros(2), device="meta")
    assert thw.stats()["after"]["h2d_count"] == 0 and thw.totals()["h2d_count"] == 0
    thw.reset()


def test_native_build_counts_one_compile(tmp_path, monkeypatch, port):
    from m3_tpu_torch.native import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_cache", {})
    with port.hop("build"):
        assert _build.load_native("idmap.cc", ("-std=c++20",)) is not None
    with port.hop("build"):  # cached in the process
        assert _build.load_native("idmap.cc", ("-std=c++20",)) is not None
    monkeypatch.setattr(_build, "_cache", {})
    with port.hop("build"):  # found built on disk
        assert _build.load_native("idmap.cc", ("-std=c++20",)) is not None
    st = port.stats()["build"]
    assert st["compiles"] == 1 and st["entries"] == 3
    assert list(port.seams()["build"]) == ["compile:idmap.cc"]
    assert port.totals()["compiles"] == 1
