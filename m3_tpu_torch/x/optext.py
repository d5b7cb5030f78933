"""One parsing home for the port's dispatch records: the counterpart of
``m3_tpu/x/hlotext.py``, renamed because the port has no XLA program
text.

What the port's gates read is what ``x/devseams`` sees while a thread
watches: the aten op names its dispatch mode passes to ``OPS``
listeners (``aten::scatter_add_``), the seams of the per-hop ledger
(``dispatch:aten::add``, ``h2d:torch.as_tensor``,
``dispatch:kernel:place_words``, ``build:place_words.cu``), the hand
kernels' launches and grids, the transfers with their bytes, and the
element types of the ops' results.  ``x/costwatch`` fingerprints stages
from them and ``tools/hops.py`` reports them by hop; a drifted second
copy of the grammar or of the op classes would let the two disagree
about the same run, so both live here.

Nothing in this module imports torch: inputs are names, dtype strings
(``"int64"``, as ``str(t.dtype)`` gives them without ``torch.``) and
counts.

Grammar notes (pinned by tests, revisit on a torch upgrade):

* an op name is ``namespace::base`` with an optional trailing ``_`` for
  the in-place form (``aten::add_``); dunder names (``aten::__lshift__``,
  ``aten::__ilshift__``) are whole bases, never in-place by the suffix;
* a ledger seam key is ``kind:seam`` with kind one of ``h2d``, ``d2h``,
  ``dispatch``, ``build``; a hand kernel's seam is ``kernel:<name>``;
* composite ops (``torch.stack``, ``Tensor.contiguous``) reach the mode
  decomposed, so only the ops they decompose into are ever classed.

The op classes, the counterpart of the reference's opcode classes:
``scatter`` (writes at computed indices: the reference's scatter
census), ``gather`` (reads at computed indices, masks included),
``reduction`` (reductions, scans and sorts), ``copy`` (copies, dtype
casts, concatenations and host↔device transfers), ``factory`` (fresh
tensors), ``elementwise`` and ``other`` (anything not listed; pinned by
tests so that a new op shows).  Hand-kernel launches are the eighth
class, ``kernel``, counted from their own seam.

Across the classes, :data:`HOST_SYNC_OPS` names the ops that read a
value back to the host inside the op on a card: a scalar read
(``_local_scalar_dense``: ``.item()``, ``int()``, ``bool()`` of a
tensor) and the ops whose output shape depends on the data, which copy
a count to the host before they can allocate (``nonzero``,
``masked_select``, ``unique``, ``repeat_interleave``, ``bincount``...).
``x/irlint``'s ``transfer-free`` rule counts them by name in a stage's
run, on the CPU as on the card; a boolean-mask ``index`` syncs too, but
only its operands tell, so it is counted from the card's transfers.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Mapping, Tuple

__all__ = [
    "OP_RE", "SEAM_RE", "OP_CLASSES", "WIDE_TYPES", "op_class", "parse_op",
    "parse_seam", "op_histogram", "type_census", "wide_count",
    "kernel_census", "uploaded_constants", "HOST_SYNC_OPS", "host_syncs",
]

# `namespace::base` with an optional in-place `_`; group 3 is that `_`
# (dunder names end in `__` and match as a whole base).
OP_RE = re.compile(r"^([a-z_][a-z0-9_]*)::(__\w+__|\w+?)(_?)$")

# A per-hop ledger key: `kind:seam`.
SEAM_RE = re.compile(r"^(h2d|d2h|dispatch|build):(.+)$")

OP_CLASSES = ("scatter", "gather", "reduction", "copy", "factory",
              "elementwise", "other")

# element types 64 bits wide: the reference's 64-bit width census
WIDE_TYPES = frozenset(("int64", "uint64", "float64", "complex64"))

_SCATTER = frozenset((
    "scatter", "scatter_add", "scatter_reduce", "index_put", "_index_put_impl",
    "index_add", "index_copy", "index_fill", "index_reduce", "masked_scatter",
    "put",
))
_GATHER = frozenset((
    "gather", "index", "_unsafe_index", "index_select", "take", "take_along_dim",
    "masked_select", "nonzero", "embedding",
))
_REDUCTION = frozenset((
    "sum", "prod", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
    "any", "all", "cumsum", "cumprod", "cummax", "cummin", "logcumsumexp",
    "sort", "argsort", "topk", "kthvalue", "median", "nanmedian", "_unique",
    "_unique2", "unique_consecutive", "unique_dim", "bincount", "histc",
    "count_nonzero", "std", "var", "var_mean", "std_mean", "norm",
    "linalg_vector_norm", "logsumexp", "searchsorted", "equal", "allclose",
    "aminmax", "nansum", "quantile",
))
_COPY = frozenset((
    "copy", "_to_copy", "clone", "_copy_from", "_copy_from_and_resize",
    "_local_scalar_dense", "cat", "stack", "flip", "roll", "repeat",
    "repeat_interleave", "constant_pad_nd", "lift_fresh", "lift_fresh_copy",
    "_unsafe_view_copy", "tril", "triu",
))
_FACTORY = frozenset((
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "zeros", "zeros_like", "new_zeros", "ones", "ones_like", "new_ones", "full",
    "full_like", "new_full", "arange", "linspace", "scalar_tensor", "eye",
    "rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
    "randperm",
))
_ELEMENTWISE = frozenset((
    "add", "sub", "rsub", "mul", "div", "floor_divide", "remainder", "fmod",
    "neg", "abs", "sign", "pow", "sqrt", "rsqrt", "exp", "exp2", "log", "log2",
    "log10", "log1p", "expm1", "floor", "ceil", "round", "trunc", "frac",
    "maximum", "minimum", "fmax", "fmin", "clamp", "clamp_min", "clamp_max",
    "where", "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "bitwise_left_shift", "bitwise_right_shift", "__lshift__", "__rshift__",
    "__ilshift__", "__irshift__", "__and__", "__or__", "__xor__", "__iand__",
    "__ior__", "__ixor__", "logical_and", "logical_or", "logical_xor",
    "logical_not", "eq", "ne", "lt", "le", "gt", "ge", "isnan", "isinf",
    "isfinite", "isneginf", "isposinf", "signbit", "nan_to_num", "fill",
    "zero", "masked_fill", "lerp", "addcmul", "addcdiv", "reciprocal",
    "sigmoid", "tanh", "sin", "cos", "erf", "hypot", "copysign", "nextafter",
    "square", "relu", "heaviside", "gcd", "lcm", "xlogy", "mvlgamma",
    "logaddexp", "isin",
))
_CLASS_OF: Dict[str, str] = {}
for _cls, _names in (("scatter", _SCATTER), ("gather", _GATHER),
                     ("reduction", _REDUCTION), ("copy", _COPY),
                     ("factory", _FACTORY), ("elementwise", _ELEMENTWISE)):
    for _n in _names:
        _CLASS_OF[_n] = _cls


def parse_op(name: str) -> Tuple[str, str, bool]:
    """``"aten::add_"`` -> ``("aten", "add", True)``; a name outside the
    grammar raises ``ValueError``."""
    m = OP_RE.match(name)
    if m is None:
        raise ValueError(f"not an op name: {name!r}")
    return m.group(1), m.group(2), m.group(3) == "_"


def op_class(name: str) -> str:
    """The op class of one aten op name (see the module docstring)."""
    _, base, _ = parse_op(name)
    return _CLASS_OF.get(base, "other")


def parse_seam(key: str) -> Tuple[str, str]:
    """``"dispatch:kernel:place_words"`` -> ``("dispatch",
    "kernel:place_words")``."""
    m = SEAM_RE.match(key)
    if m is None:
        raise ValueError(f"not a ledger seam: {key!r}")
    return m.group(1), m.group(2)


def op_histogram(ops: Mapping[str, int] | Iterable[str]) -> Dict[str, int]:
    """Op-class histogram of a run's ops (a name -> count mapping, or the
    names one per dispatch), every class present, in ``OP_CLASSES``
    order: the op-mix fingerprint that catches "the same work, a worse
    formulation" (an elementwise chain turning into a scatter)."""
    items = ops.items() if isinstance(ops, Mapping) else ((n, 1) for n in ops)
    hist = dict.fromkeys(OP_CLASSES, 0)
    for name, n in items:
        hist[op_class(name)] += int(n)
    return hist


def type_census(types: Mapping[str, int]) -> Dict[str, int]:
    """Element-type census of a run's op results (dtype string ->
    results), sorted: a silent int32 -> int64 promotion moves it even
    where the op count does not."""
    return {k: int(v) for k, v in sorted(types.items())}


def wide_count(types: Mapping[str, int]) -> int:
    """Op results of a 64-bit element type (the 64-bit width census)."""
    return sum(int(n) for t, n in types.items() if t in WIDE_TYPES)


def kernel_census(seams: Mapping[str, Iterable[int]]) -> Dict[str, int]:
    """Hand-kernel grids by kernel from ledger rows (seam key ->
    (count, bytes)): the ``dispatch:kernel:<name>`` rows."""
    out: Dict[str, int] = {}
    for key, row in seams.items():
        kind, seam = parse_seam(key)
        if kind == "dispatch" and seam.startswith("kernel:"):
            out[seam.split(":", 1)[1]] = int(list(row)[0])
    return dict(sorted(out.items()))


def uploaded_constants(uploads: Iterable[Tuple[str, int]],
                       min_bytes: int) -> List[dict]:
    """Per-call uploads of at least ``min_bytes`` (seam, bytes) — host
    tables a stage re-sends every call instead of keeping them on the
    device, the class the reference finds as constants folded into its
    program — largest first."""
    out = [{"seam": seam, "bytes": int(nb)} for seam, nb in uploads
           if int(nb) >= min_bytes]
    out.sort(key=lambda c: (-c["bytes"], c["seam"]))
    return out


# ops that read a value back to the host inside the op on a card (see the
# module docstring), by base name
HOST_SYNC_OPS = frozenset((
    "_local_scalar_dense", "is_nonzero", "nonzero", "masked_select", "_unique",
    "_unique2", "unique_consecutive", "unique_dim", "repeat_interleave",
    "bincount", "histc", "equal", "allclose",
))


def host_syncs(ops: Mapping[str, int]) -> Dict[str, int]:
    """The host-syncing ops of a run's ops (name -> count), by name."""
    out = {}
    for name, n in ops.items():
        if parse_op(name)[1] in HOST_SYNC_OPS and int(n):
            out[name] = int(n)
    return dict(sorted(out.items()))
