"""The port's build/transfer sanitizer (``m3_tpu_torch.x.tracewatch``) on
the CPU.

The five ``TestTransferGuard`` cases of ``tests/test_tracewatch.py``, in
their port form on the ``meta`` device (the stand-in for a device off
the CPU): a download inside ``no_transfers()`` raises ``TransferError``
naming ``int64`` and ``[8]``, and the seam is open again outside; every
download and upload seam raises; ``allow_transfers()`` escapes the
guard; compute on the device is allowed inside it; and the guard works
without ``install()``.  Then the build half: each kernel source may build
once a process, a second build raises ``RetraceError`` before the
compiler runs, record mode keeps it as a finding, and the signatures are
the source's content hash and the flags.
"""

import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from m3_tpu_torch.native import _build
from m3_tpu_torch.x import devseams, tracewatch

ROOT = Path(__file__).resolve().parent.parent
FLAGS = ("-std=c++20",)


@pytest.fixture()
def armed():
    was = tracewatch.installed()
    tracewatch.reset()
    tracewatch.install(raise_on_violation=True)
    try:
        yield tracewatch
    finally:
        if not was:
            tracewatch.uninstall()
        tracewatch.reset()


def _meta(n=8):
    return torch.arange(n, dtype=torch.int64, device="meta")


class TestTransferGuard:
    def test_download_blocked_in_guarded_region(self, armed):
        x = _meta()
        with tracewatch.no_transfers():
            with pytest.raises(tracewatch.TransferError) as ei:
                x.cpu()
        assert "int64" in str(ei.value) and "[8]" in str(ei.value)
        # outside the region the seam is open again: the copy itself
        # runs (and fails only because the meta device holds no data)
        with pytest.raises(NotImplementedError):
            x.cpu()

    @pytest.mark.parametrize("seam", [
        ".cpu()", '.to("cpu")', ".tolist()", "copy_ to the host", "copy_ to the device",
        "torch.tensor(list)", "torch.as_tensor(list)", "torch.as_tensor(ndarray)",
        "ndarray .to", "torch.tensor(ndarray)", "nonzero", "boolean-mask index",
        "masked_select", "unique", "repeat_interleave"])
    def test_every_seam_raises(self, armed, seam):
        x = _meta()
        arr = np.arange(8, dtype=np.int64)
        fn = {
            ".cpu()": lambda: x.cpu(),
            '.to("cpu")': lambda: x.to("cpu"),
            ".tolist()": lambda: x.tolist(),
            "copy_ to the host": lambda: torch.empty(8, dtype=torch.int64).copy_(x),
            "copy_ to the device": lambda: x.copy_(torch.from_numpy(arr)),
            "torch.tensor(list)": lambda: torch.tensor(arr.tolist(), device="meta"),
            "torch.as_tensor(list)": lambda: torch.as_tensor(arr.tolist(), device="meta"),
            "torch.as_tensor(ndarray)": lambda: torch.as_tensor(arr, device="meta"),
            "ndarray .to": lambda: torch.from_numpy(arr).to("meta"),
            "torch.tensor(ndarray)": lambda: torch.tensor(arr, device="meta"),
            "nonzero": lambda: torch.nonzero(x),
            "boolean-mask index": lambda: x[x > 3],
            "masked_select": lambda: torch.masked_select(x, x > 3),
            "unique": lambda: torch.unique(x),
            "repeat_interleave": lambda: torch.repeat_interleave(x),
        }[seam]
        with tracewatch.no_transfers():
            with pytest.raises(tracewatch.TransferError) as ei:
                fn()
        if seam in (".cpu()", '.to("cpu")', ".tolist()", "copy_ to the host",
                    "copy_ to the device", "torch.tensor(list)", "torch.as_tensor(list)",
                    "torch.as_tensor(ndarray)", "ndarray .to", "torch.tensor(ndarray)"):
            assert "int64[8]" in str(ei.value), str(ei.value)

    def test_allow_transfers_escape(self, armed):
        arr = np.arange(4, dtype=np.int64)
        with tracewatch.no_transfers():
            with tracewatch.allow_transfers():
                y = torch.as_tensor(arr, device="meta")
                assert y.shape == (4,)
                with pytest.raises(NotImplementedError):
                    y.cpu()  # not the guard: the meta device has no data
            with pytest.raises(tracewatch.TransferError):
                torch.as_tensor(arr, device="meta")

    def test_device_compute_allowed_in_region(self, armed):
        x = _meta(1024)
        with tracewatch.no_transfers():
            y = (x * 2).sum()
            z = torch.zeros(4, device="meta") + torch.arange(4, device="meta")
            x.view(32, 32).t().contiguous()
        assert y.shape == () and z.shape == (4,)

    def test_guard_without_install(self):
        was = tracewatch.installed()
        if was:
            tracewatch.uninstall()
        try:
            x = _meta(3)
            with tracewatch.no_transfers():
                with pytest.raises(tracewatch.TransferError):
                    x.cpu()
            with pytest.raises(NotImplementedError):
                x.cpu()
        finally:
            if was:
                tracewatch.install()


def test_guard_is_per_thread_and_nests():
    x = _meta()
    seen = []

    def other():
        try:
            torch.as_tensor(np.arange(2), device="meta")
            seen.append("passed")
        except tracewatch.TransferError:
            seen.append("raised")

    with tracewatch.no_transfers():
        with tracewatch.no_transfers():
            with pytest.raises(tracewatch.TransferError):
                x.cpu()
        with pytest.raises(tracewatch.TransferError):
            x.cpu()
        t = threading.Thread(target=other)
        t.start()
        t.join(30)
    assert seen == ["passed"]


def test_implicit_syncs_only_where_the_op_copies_a_count(armed):
    """A boolean-mask store of a host scalar is a masked fill (no count
    copied; on a CUDA tensor ``y[mask] = 0`` makes its scalar on the
    host); of a device tensor it copies the mask's count;
    ``repeat_interleave`` with ``output_size`` copies nothing; ``histc``
    with its range given copies nothing (the card's profiler shows which
    copy, phase 24)."""
    x = _meta()
    with tracewatch.no_transfers():
        y = x.clone()
        y.index_put_((x > 3,), torch.tensor(0))
        y.masked_fill_(x > 3, 1)
        torch.repeat_interleave(x, output_size=28)
        torch.histc(x.double(), bins=4, min=0, max=8)
        with pytest.raises(tracewatch.TransferError):
            y[x > 3] = torch.zeros(4, dtype=torch.int64, device="meta")
        with pytest.raises(tracewatch.TransferError):
            torch.histc(x.double(), bins=4)
        with pytest.raises(tracewatch.TransferError):
            torch.bincount(x)


def test_cpu_tensors_are_not_transfers():
    t = torch.arange(8)
    with tracewatch.no_transfers():
        assert t.cpu().tolist() == list(range(8))
        assert torch.as_tensor(np.arange(3), device="cpu").sum().item() == 3
        assert torch.nonzero(t).shape == (7, 1)


# ---- the build half ----------------------------------------------------------


def _fresh_build_dir(monkeypatch, path):
    monkeypatch.setattr(_build, "BUILD_DIR", path)
    monkeypatch.setattr(_build, "_cache", {})


def test_one_build_a_source_then_retrace_error(tmp_path, monkeypatch, armed):
    _fresh_build_dir(monkeypatch, tmp_path / "a")
    snap = tracewatch.snapshot()
    assert _build.load_native("idmap.cc", FLAGS) is not None
    assert tracewatch.compiles() == {"idmap.cc": 1}
    assert tracewatch.retraces_since(snap) == 1
    src = (_build.SRC_DIR / "idmap.cc").read_bytes()
    sig = tracewatch.compile_signatures()["idmap.cc"]
    assert sig == [f"sha256:{hashlib.sha256(src).hexdigest()} -O2 -std=c++20 -shared -fPIC"]
    # found built, in the process and on disk: no build
    snap = tracewatch.snapshot()
    assert _build.load_native("idmap.cc", FLAGS) is not None
    monkeypatch.setattr(_build, "_cache", {})
    assert _build.load_native("idmap.cc", FLAGS) is not None
    assert tracewatch.retraces_since(snap) == 0
    # a second build of the source in this process: refused before the compiler runs
    _fresh_build_dir(monkeypatch, tmp_path / "b")
    with pytest.raises(tracewatch.RetraceError) as ei:
        _build.load_native("idmap.cc", FLAGS)
    msg = str(ei.value)
    assert "idmap.cc built 2x (budget 1)" in msg and sig[0] in msg
    assert not (tmp_path / "b").exists() or not any((tmp_path / "b").iterdir())
    assert [f.count for f in tracewatch.findings()] == [2]


def test_record_mode_collects_findings(tmp_path, monkeypatch):
    was = tracewatch.installed()
    tracewatch.reset()
    tracewatch.install(raise_on_violation=False)
    try:
        for d in ("a", "b", "c"):
            _fresh_build_dir(monkeypatch, tmp_path / d)
            assert _build.load_native("idmap.cc", FLAGS) is not None
        found = tracewatch.findings()
        assert [f.count for f in found] == [2, 3] and found[-1].name == "idmap.cc"
        assert found[-1].budget == tracewatch.BUILD_BUDGET == 1
        assert tracewatch.total_compiles() == 3
    finally:
        if not was:
            tracewatch.uninstall()
        tracewatch.reset()


def test_cuda_builds_are_announced_before_nvcc(tmp_path, monkeypatch, armed):
    """``parallel/_cuda.build`` announces each missing library before any
    compiler starts, so a refused build starts none."""
    from m3_tpu_torch.parallel import _cuda

    started = []
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_cuda, "_nvcc", lambda: started.append(1) or "nvcc-not-here")
    devseams.building("place_words.cu", b"an earlier source", ())  # built once already
    with pytest.raises(tracewatch.RetraceError):
        _cuda.build(["place_words"])
    assert not started
    sigs = tracewatch.compile_signatures()["place_words.cu"]
    src = (_cuda.SRC_DIR / "place_words.cu").read_bytes()
    assert sigs == [f"sha256:{hashlib.sha256(b'an earlier source').hexdigest()} ",
                    f"sha256:{hashlib.sha256(src).hexdigest()} " + " ".join(_cuda.NVCC_FLAGS)]


def test_uninstalled_counts_nothing(tmp_path, monkeypatch):
    was = tracewatch.installed()
    if was:
        tracewatch.uninstall()
    tracewatch.reset()
    try:
        _fresh_build_dir(monkeypatch, tmp_path)
        assert _build.load_native("idmap.cc", FLAGS) is not None
        assert tracewatch.total_compiles() == 0
    finally:
        if was:
            tracewatch.install()


def test_not_ported_and_no_environment_arming():
    """``retrace_budget`` and the jit factory wrapping are not ported, and
    ``M3_TRACEWATCH`` arms nothing (stated differences)."""
    assert not hasattr(tracewatch, "retrace_budget")
    code = ("import sys\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "import m3_tpu_torch.x\n"
            "from m3_tpu_torch.x import tracewatch, hopwatch\n"
            "print(tracewatch.installed(), hopwatch.installed())\n")
    env = dict(os.environ, M3_TRACEWATCH="1", M3_HOPWATCH="1")
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "False False"
