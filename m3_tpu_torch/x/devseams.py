"""The device boundary's seams: where the port's runtime instruments see
host↔device transfers, device ops, hand-kernel launches and kernel
builds.

``x/hopwatch`` counts what passes these seams and ``x/tracewatch``
guards them; this module holds the one interception both read, so a
thread under both pays for one.  The seams:

* **aten ops** — a ``TorchDispatchMode`` (``_BoundaryMode``) sees every
  aten op after autograd and the composite decompositions.  An op with a
  tensor operand off the CPU, or a ``device=`` off the CPU, is a *device
  op*; views and metadata queries are not counted as ops.  Among device
  ops the transfers are: ``aten::_to_copy`` and ``aten::copy_`` between
  the CPU and another device (``.cpu()``, ``.to(...)``, ``.tolist()``,
  an ndarray upload through ``torch.from_numpy``/``as_tensor``, a
  cross-device ``copy_``), ``aten::_local_scalar_dense`` (``.item()``,
  ``int()``, ``bool()`` of a device tensor), and the ops whose output
  shape depends on the data, which copy a count to the host inside the
  op (``_implicit``).
* **the factories** — ``torch.tensor`` and ``torch.as_tensor`` of Python
  data reach no aten op that a mode sees, so while a thread watches, the
  two module functions are wrapped (process-wide, delegating untouched
  outside watching threads).
* **hand kernels** — launched through ``ctypes``, they never reach
  aten: each wrapper calls :func:`launched` with its grids.
* **builds** — ``parallel/_cuda.build`` (``nvcc``) and
  ``native/_build.load_native`` (``g++``) call :func:`building` before a
  compiler runs; a library found built is not a build.
* **op names** — listeners in :data:`OPS` receive every aten op a
  watching thread dispatches, on any device, the CPU included (views and
  metadata queries not), with its operands and its result, after it ran:
  ``x/costwatch``'s census reads them, and ``x/optext`` classes them.

A dispatch mode is per thread.  A thread *watches* between
:func:`enter` and :func:`leave` (nested; ``hopwatch.install`` and
``hopwatch.hop`` enter, as does ``tracewatch.no_transfers``); transfers,
device ops and launches are seen in watching threads only.  Builds are
seen in every thread.  The bytes of a transfer are the bytes its copy
moves: the destination's dtype where a blocking upload converts on the
host first, the source's where a download converts after the copy.
"""

from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["TransferError", "enter", "leave", "watching", "guard", "launched",
           "building", "COUNTERS", "BUILD_HOOKS", "OPS"]


class TransferError(RuntimeError):
    """A host↔device transfer inside a ``tracewatch.no_transfers()``
    region, raised before the copy runs."""


# callables(kind, seam, n, nbytes), kind in {"h2d", "d2h", "dispatch"},
# called in the watching thread; hopwatch's while it is installed
COUNTERS: list = []
# callables(source, signature) called before a compiler runs; hopwatch's
# and tracewatch's while installed (tracewatch's may raise)
BUILD_HOOKS: list = []
# callables(name, args, kwargs, out) called in the watching thread after
# every aten op on any device (views and metadata queries not);
# costwatch's census while one is open
OPS: list = []

_tls = threading.local()  # depth, mode, quiet (inside a factory seam), guard
_mu = threading.Lock()
_factory_users = 0
_FACTORIES: dict = {}
_MODE: list = []  # the mode class, made on first use (torch's dispatch module
# is imported only by a process that watches)

# ops that only read metadata (views are known by their schema)
_METADATA = frozenset((
    "aten::sym_size", "aten::sym_stride", "aten::sym_numel",
    "aten::sym_storage_offset", "aten::size", "aten::stride", "aten::numel",
    "aten::dim", "aten::is_contiguous", "aten::is_same_size",
    "aten::is_complex", "aten::is_floating_point", "prim::device",
    "prim::layout",
))

# ops that copy a count or a flag to the host inside the op on a CUDA
# device: op -> (memcpys, bytes) of those copies, as torch.profiler
# records them on the H100 with torch 2.11 (``chip_smoke.py`` phase 24
# (a)'s seam catalogue holds each against the trace)
_IMPLICIT_D2H = {
    "aten::nonzero": (1, 4),
    "aten::masked_select": (1, 4),
    "aten::_unique2": (1, 8),
    "aten::_unique": (1, 8),
    "aten::unique_consecutive": (1, 8),
    "aten::unique_dim": (1, 4),
    "aten::allclose": (1, 1),
}
_BOOL_INDEX = (1, 4)  # a boolean mask's count, as nonzero copies it


def _implicit(name: str, args, kwargs):
    """(memcpys, bytes) an op copies to the host inside itself, else None."""
    hit = _IMPLICIT_D2H.get(name)
    if hit is not None:
        return hit
    if name in ("aten::index", "aten::index_put_", "aten::_index_put_impl_"):
        idx = args[1] if len(args) > 1 else kwargs.get("indices", ())
        if not any(i is not None and i.dtype in (torch.bool, torch.uint8) for i in idx):
            return None
        if name != "aten::index":
            value = args[2] if len(args) > 2 else kwargs.get("values")
            if value.numel() == 1 and value.device.type == "cpu":
                return None  # a host scalar: a masked fill, no count
        return _BOOL_INDEX
    if name == "aten::repeat_interleave":
        # the output's length and the repeats' sign check
        if isinstance(args[0], torch.Tensor) and kwargs.get("output_size") is None:
            return (2, 9)
        return None
    if name == "aten::equal":
        a, b = args[0], args[1]
        return None if a.shape != b.shape or a.is_set_to(b) else (1, 1)
    if name == "aten::bincount":  # the input's min and max
        return (2, 2 * args[0].element_size())
    if name == "aten::histc":
        lo = args[2] if len(args) > 2 else kwargs.get("min", 0)
        hi = args[3] if len(args) > 3 else kwargs.get("max", 0)
        return (2, 2 * args[0].element_size()) if lo == hi else None
    return None


def _off_cpu(dev) -> bool:
    return dev is not None and torch.device(dev).type != "cpu"


def _tensors(args, kwargs):
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            for b in a:
                if isinstance(b, torch.Tensor):
                    yield b


def _describe(t) -> str:
    """``int64[8]``: a tensor's dtype and shape, as the guard's message
    names them."""
    return f"{str(t.dtype).removeprefix('torch.')}{list(t.shape)}"


def _copy_bytes(src, dst_dtype, numel: int, upload: bool, non_blocking: bool) -> int:
    # a blocking copy converts on the host: an upload moves the
    # destination's dtype, a download the source's; a non-blocking one
    # converts on the device, the other way round
    on_dst = upload != bool(non_blocking)
    return numel * (dst_dtype.itemsize if on_dst else src.element_size())


def _transfer(name: str, args, kwargs):
    """(direction, memcpys, bytes, tensor) of a transfer op, else None."""
    if name == "aten::_to_copy":
        src = args[0]
        dst = kwargs.get("device")
        if dst is None or (src.device.type == "cpu") == (torch.device(dst).type == "cpu"):
            return None
        if not src.numel():
            return None
        upload = src.device.type == "cpu"
        nb = _copy_bytes(src, kwargs.get("dtype") or src.dtype, src.numel(), upload,
                         kwargs.get("non_blocking", False))
        return ("h2d" if upload else "d2h", 1, nb, src)
    if name == "aten::copy_":
        dst, src = args[0], args[1]
        if (dst.device.type == "cpu") == (src.device.type == "cpu") or not dst.numel():
            return None
        upload = src.device.type == "cpu"
        non_blocking = args[2] if len(args) > 2 else kwargs.get("non_blocking", False)
        return ("h2d" if upload else "d2h", 1,
                _copy_bytes(src, dst.dtype, dst.numel(), upload, non_blocking), src)
    if name == "aten::_local_scalar_dense":
        return ("d2h", 1, args[0].element_size(), args[0])
    hit = _implicit(name, args, kwargs)
    return None if hit is None else ("d2h", *hit, args[0])


def _count(kind: str, seam: str, n: int, nbytes: int) -> None:
    for fn in list(COUNTERS):
        fn(kind, seam, n, nbytes)


def _counted(func, name: str) -> bool:
    """Whether an op counts as a dispatch (views and metadata queries
    do not)."""
    return not (func.is_view or name in _METADATA)


def _observe(func, args, kwargs) -> None:
    name = func._schema.name
    if not (any(t.device.type != "cpu" for t in _tensors(args, kwargs))
            or _off_cpu(kwargs.get("device"))):
        return
    xfer = _transfer(name, args, kwargs)
    if xfer is not None:
        direction, n, nbytes, t = xfer
        if getattr(_tls, "guard", 0) > 0:
            raise TransferError(
                f"{'host->device' if direction == 'h2d' else 'device->host'} "
                f"transfer ({name}) of {_describe(t)} on {t.device} inside a "
                f"no_transfers() region — move it out of the guarded section "
                f"or wrap the host boundary in tracewatch.allow_transfers()")
        _count(direction, name, n, nbytes)
    if _counted(func, name):
        _count("dispatch", name, 1, 0)


def _mode_class():
    if not _MODE:
        from torch.utils._python_dispatch import TorchDispatchMode

        class _BoundaryMode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                quiet = getattr(_tls, "quiet", False)
                if not quiet:
                    _observe(func, args, kwargs)
                out = func(*args, **kwargs)
                if OPS and not quiet and _counted(func, func._schema.name):
                    for fn in list(OPS):
                        fn(func._schema.name, args, kwargs, out)
                return out

        _MODE.append(_BoundaryMode)
    return _MODE[0]


def _factory(orig, seam: str, device_pos: int | None):
    """``torch.tensor``/``torch.as_tensor``: Python data (or an ndarray)
    onto a device is one upload of the result's bytes."""

    def wrapped(data, *a, **kw):
        if not watching() or isinstance(data, torch.Tensor):
            return orig(data, *a, **kw)
        dev = kw.get("device")
        if dev is None and device_pos is not None and len(a) > device_pos:
            dev = a[device_pos]
        if dev is None:
            dev = torch.get_default_device()
        if not _off_cpu(dev):
            return orig(data, *a, **kw)
        if getattr(_tls, "guard", 0) > 0:
            host = {k: v for k, v in kw.items() if k != "device"}
            t = orig(data, *a[:device_pos], **host) if device_pos is not None \
                else orig(data, **host)
            raise TransferError(
                f"host->device transfer ({seam}) of {_describe(t)} onto {dev} inside "
                f"a no_transfers() region — move it out of the guarded section "
                f"or wrap the host boundary in tracewatch.allow_transfers()")
        _tls.quiet = True  # the ndarray path's own _to_copy is this upload
        try:
            out = orig(data, *a, **kw)
        finally:
            _tls.quiet = False
        if out.numel():
            _count("h2d", seam, 1, out.numel() * out.element_size())
        return out

    wrapped.__wrapped__ = orig
    wrapped.__name__ = getattr(orig, "__name__", seam)
    return wrapped


def _patch_factories() -> None:
    global _factory_users
    with _mu:
        _factory_users += 1
        if _factory_users > 1:
            return
        for attr, pos in (("tensor", None), ("as_tensor", 1)):
            orig = getattr(torch, attr)
            _FACTORIES[attr] = orig
            setattr(torch, attr, _factory(orig, f"torch.{attr}", pos))


def _unpatch_factories() -> None:
    global _factory_users
    with _mu:
        _factory_users -= 1
        if _factory_users:
            return
        for attr, orig in _FACTORIES.items():
            setattr(torch, attr, orig)
        _FACTORIES.clear()


def watching() -> bool:
    """Whether this thread is between :func:`enter` and :func:`leave`."""
    return getattr(_tls, "depth", 0) > 0


def enter() -> None:
    """Start (or nest) watching this thread: the first entry pushes the
    boundary mode and wraps the factories."""
    depth = getattr(_tls, "depth", 0)
    if depth == 0:
        _patch_factories()
        _tls.mode = _mode_class()()
        _tls.mode.__enter__()
    _tls.depth = depth + 1


def leave() -> None:
    """End one :func:`enter`; the last pops the mode."""
    _tls.depth -= 1
    if _tls.depth == 0:
        mode, _tls.mode = _tls.mode, None
        mode.__exit__(None, None, None)
        _unpatch_factories()


@contextlib.contextmanager
def guard(on: bool):
    """Within, transfers in this thread raise :class:`TransferError`
    (``on``, nesting) or pass (not ``on``: ``allow_transfers``); the
    thread watches for the scope."""
    prev = getattr(_tls, "guard", 0)
    _tls.guard = prev + 1 if on else 0
    enter()
    try:
        yield
    finally:
        leave()
        _tls.guard = prev


def launched(kernel: str, grids: int) -> None:
    """A hand kernel's wrapper launched ``grids`` grids (seam
    ``kernel:<name>``)."""
    if grids and watching():
        _count("dispatch", f"kernel:{kernel}", grids, 0)


def building(source: str, code: bytes, flags) -> None:
    """A compiler is about to build ``source`` from ``code`` with
    ``flags``; the hooks get its signature, the content hash and the
    flags."""
    import hashlib

    signature = f"sha256:{hashlib.sha256(code).hexdigest()} {' '.join(flags)}"
    for fn in list(BUILD_HOOKS):
        fn(source, signature)
