"""Builds and loads the port's CUDA kernels (``m3_tpu_torch/csrc/*.cu``).

Each source compiles on first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, which ``ctypes`` loads.  The
library's name carries a hash of its source (with the ``csrc/*.cuh``
headers it includes) and flags, so a library is rebuilt only when one of
them changes.  Libraries and the compiler's
``-Xptxas -v`` report go to ``build/m3_tpu_torch/`` under the checkout
(listed in ``.gitignore``).  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from m3_tpu_torch.x import devseams

SRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "m3_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    path = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if not path:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _paths(name: str) -> tuple[Path, Path, Path]:
    src = SRC_DIR / f"{name}.cu"
    code = src.read_bytes()
    # the headers of csrc/ that the source includes count as its source
    deps = [p.read_bytes() for p in sorted(SRC_DIR.glob("*.cuh"))
            if f'#include "{p.name}"'.encode() in code]
    h = hashlib.sha256(b"".join([code, *deps]) + " ".join(NVCC_FLAGS).encode())
    stem = f"{name}-{h.hexdigest()[:16]}"
    return src, BUILD_DIR / f"{stem}.so", BUILD_DIR / f"{stem}.ptxas.txt"


def build(names) -> None:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together (each build is announced to
    ``x/devseams`` first).  Raises with the compiler's output if any
    build fails."""
    todo = [(name, *_paths(name)) for name in names]
    todo = [t for t in todo if not t[2].exists()]
    for name, src, _, _ in todo:  # before any compiler starts: a hook may refuse
        devseams.building(f"{name}.cu", src.read_bytes(), NVCC_FLAGS)
    jobs = []
    for name, src, so, log in todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((name, proc, tmp, so, log))
    failed = []
    for name, proc, tmp, so, log in jobs:
        out, _ = proc.communicate()
        log.write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` output of the named kernel's build."""
    build([name])
    return _paths(name)[2].read_text()


def load(name: str) -> ctypes.CDLL:
    """The named kernel's library, built if needed, loaded once."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_paths(name)[1]))
            lib.m3_error_string.argtypes = [ctypes.c_int]
            lib.m3_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.m3_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
