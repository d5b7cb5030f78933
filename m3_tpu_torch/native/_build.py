"""Build-on-demand loader for the port's host C++ sources: the
counterpart of ``m3_tpu/native/_build.py``.

Each source in ``m3_tpu_torch/csrc`` compiles on first use with ``g++``
into ``build/m3_tpu_torch/`` under the checkout (listed in
``.gitignore``); the library's name carries a hash of the source and the
flags, so it is rebuilt only when either changes.  ``load_native``
returns a loaded CDLL, or None when the toolchain or the artifact is
unusable — the JAX package's contract, which lets ``MetricMap`` keep its
``use_native=None`` semantics.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

from m3_tpu_torch.x import devseams

SRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "m3_tpu_torch"
CXX = "g++"

_cache: dict[str, object] = {}
_lock = threading.Lock()


def load_native(src_name: str, extra_flags: tuple = ()):
    """CDLL for ``csrc/<src_name>``, built if needed, or None when it
    cannot be built or loaded.  Results, failures included, are cached
    per source."""
    with _lock:
        if src_name in _cache:
            return _cache[src_name]
        src = SRC_DIR / src_name
        code = src.read_bytes()
        flags = ("-O2", *extra_flags, "-shared", "-fPIC")
        h = hashlib.sha256(code + " ".join(flags).encode())
        so = BUILD_DIR / f"{Path(src_name).stem}-{h.hexdigest()[:16]}.so"
        if not so.exists():  # announced before the cache entry: a hook may refuse
            devseams.building(src_name, code, flags)
        _cache[src_name] = None
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # a unique temp name renamed into place: processes sharing the
            # checkout may build at once, and dlopen of a half-written
            # library would cache a failure
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            try:
                subprocess.run([CXX, *flags, "-o", str(tmp), str(src)],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)
            except (subprocess.SubprocessError, OSError):
                tmp.unlink(missing_ok=True)
                return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        _cache[src_name] = lib
        return lib
