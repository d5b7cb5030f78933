"""Rule family 2 — device-program purity and dtype discipline, restated
for torch.  The counterpart of ``m3_tpu/x/lint/purity.py``.

``jit-purity``: the reference flags impure calls in functions reached
from jit/shard_map callsites, which run once under a tracer.  The port
has no tracer; its device programs are the hand-kernel wrappers (a def
that reports a launch through ``devseams.launched``), their plain
versions (``*_plain``) and the primaries passed to
``devguard.run_guarded``, with every function they reach in the same
file.  Each must be a pure function of its tensor arguments: the kernel
and its plain version are held bit for bit against each other, and the
census counts a stage's run as its fingerprint, so a clock read, a draw
from the global random state (a ``torch.rand*``/``randint``/``randperm``
or an in-place random fill without ``generator=``, ``torch.manual_seed``,
``np.random.<fn>``), a lock, a socket or a file opened there makes two
runs of one program differ or ties it to host state.  Reachability
propagates through the module-level call graph as the reference's
``jit_reachable`` does.

``explicit-dtype``: in the bit-exactness modules (``encoding/``,
``parallel/``, ``aggregator/``) every ``torch.tensor/zeros/ones/empty/
full/arange`` passes ``dtype=``, and every ``np.array/zeros/ones/full/
empty/arange`` a dtype (keyword or positional, as in the reference).
torch's defaults are float32 for Python floats and ``full``'s fill, and
int64 for Python ints: a width decided by a default, not by the code,
is a bit-exactness bug waiting for a changed default.  ``as_tensor``,
``asarray`` and ``*_like`` keep their input's dtype and are exempt.
"""

from __future__ import annotations

import ast
from typing import List

from m3_tpu_torch.x.lint.core import Context, FileUnit, Finding, dotted

# dotted calls that must not run in a device program, with the why
_IMPURE = {
    "time.time": "a host clock read",
    "time.time_ns": "a host clock read",
    "time.monotonic": "a host clock read",
    "time.perf_counter": "a host clock read",
    "time.sleep": "a host sleep",
    "threading.Lock": "a lock made per call",
    "threading.RLock": "a lock made per call",
    "threading.Condition": "a lock made per call",
    "socket.socket": "socket I/O",
    "socket.create_connection": "socket I/O",
    "os.fsync": "file I/O",
    "open": "file I/O",
    "os.urandom": "host randomness",
    "torch.manual_seed": "reseeds the global random state",
    "torch.seed": "reseeds the global random state",
    "torch.cuda.manual_seed": "reseeds the global random state",
    "torch.cuda.manual_seed_all": "reseeds the global random state",
}
_IMPURE_PREFIXES = {
    "random.": "host randomness",
    "np.random.": "host randomness",
    "numpy.random.": "host randomness",
}
# draws from torch's global random state unless a generator= is given
_TORCH_RANDOM = frozenset((
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "bernoulli", "multinomial", "normal", "poisson",
))
_RANDOM_FILLS = frozenset((
    "random_", "uniform_", "normal_", "bernoulli_", "exponential_",
    "geometric_", "cauchy_", "log_normal_",
))
_SEAM_CALLS = ("devguard.run_guarded", "run_guarded")
# the hand-kernel wrappers and the entry points that route to them
# (``parallel/encode_place``, ``encode_scan``, ``decode_gather``,
# ``decode_scan``, ``segment_ingest``): a call of one is card work (device-guard,
# transfer-hygiene's timed regions); tests hold the table to the defs
# that report a launch
KERNEL_WRAPPERS = frozenset((
    "place_words", "encode_scan", "extract_fields64_t", "decode_scan", "segment_ingest_into",
    "segment_minmax_into", "segment_ingest", "segment_minmax",
    "pallas_segment_ingest", "pallas_segment_moments", "pallas_segment_minmax",
    "segment_ingest_chunked", "segment_moments_chunked", "segment_minmax_chunked",
))
_LAUNCH_CALLS = ("devseams.launched", "launched")


def _last_attr(name: str) -> str:
    return name.rpartition(".")[2]


def _has_kw(call: ast.Call, name: str) -> bool:
    return any(k.arg == name for k in call.keywords)


def _is_wrapper(fn: ast.AST) -> bool:
    """A hand-kernel wrapper: its body reports a launch."""
    return any(isinstance(n, ast.Call) and dotted(n.func) in _LAUNCH_CALLS
               for n in ast.walk(fn))


def _annotated_static(arg: ast.arg) -> bool:
    ann = arg.annotation
    return isinstance(ann, ast.Name) and ann.id in ("int", "bool", "str", "float")


def static_params(fn: ast.AST) -> frozenset:
    """Parameters that are not tensors: annotated ``int``/``bool``/
    ``str``/``float``, or defaulting to a constant (the counterpart of a
    jit's static arguments)."""
    args = getattr(fn, "args", None)
    if args is None:
        return frozenset()
    out = set()
    pos = list(args.posonlyargs) + list(args.args)
    for a, d in zip(pos[len(pos) - len(args.defaults):], args.defaults):
        if isinstance(d, ast.Constant):
            out.add(a.arg)
    for a, d in zip(args.kwonlyargs, args.kw_defaults):
        if d is None or isinstance(d, ast.Constant):
            out.add(a.arg)
    for a in pos + list(args.kwonlyargs):
        if _annotated_static(a):
            out.add(a.arg)
    return frozenset(out)


def _seeds(tree: ast.AST):
    """(def or lambda nodes, names): the wrappers, the plain versions and
    the primaries passed to run_guarded (a Lambda, or a Name resolved in
    the module)."""
    seed_defs, seed_names = [], set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.name.endswith("_plain") or _is_wrapper(node):
                seed_defs.append(node)
        elif isinstance(node, ast.Call) and dotted(node.func) in _SEAM_CALLS:
            for arg in list(node.args[1:]) + [k.value for k in node.keywords]:
                if isinstance(arg, ast.Name):
                    seed_names.add(arg.id)
                elif isinstance(arg, ast.Lambda):
                    seed_defs.append(arg)
    return seed_defs, seed_names


def _called_names(fn: ast.AST, include_partial_args: bool = False) -> set:
    out = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Name):
            out.add(node.func.id)
        if include_partial_args:
            # functools.partial(helper, ...): the Name args are functions
            # that run in the same program
            callee = dotted(node.func)
            if callee is not None and _last_attr(callee) == "partial":
                for arg in list(node.args) + [k.value for k in node.keywords]:
                    if isinstance(arg, ast.Name):
                        out.add(arg.id)
    return out


def device_reachable(tree: ast.AST, include_partial_args: bool = False):
    """Every function of the module that runs in a device program, by
    call-graph propagation from the seeds (see the module docstring).

    Returns ``[(fn_node, statics, direct)]``: ``statics`` is the seed's
    non-tensor parameters (:func:`static_params`) for a direct seed, and
    ``None`` for a function reached through the call graph, whose
    parameters may be anything its caller passes."""
    module_defs: dict = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            module_defs.setdefault(node.name, node)
    seed_defs, seed_names = _seeds(tree)
    entries: dict = {}
    frontier = []
    for d in seed_defs + [module_defs[n] for n in sorted(seed_names)
                          if n in module_defs]:
        if id(d) not in entries:
            entries[id(d)] = (d, static_params(d), True)
            frontier.append(d)
    while frontier:
        fn = frontier.pop()
        for name in _called_names(fn, include_partial_args):
            d = module_defs.get(name)
            if d is not None and id(d) not in entries:
                entries[id(d)] = (d, None, False)
                frontier.append(d)
    return list(entries.values())


def _impurity(node: ast.Call) -> tuple | None:
    """(callee, why) of an impure call, else None."""
    callee = dotted(node.func)
    if callee is not None:
        why = _IMPURE.get(callee)
        if why is not None:
            return callee, why
        for prefix, pwhy in _IMPURE_PREFIXES.items():
            if callee.startswith(prefix):
                return callee, pwhy
        if (callee.startswith("torch.") and _last_attr(callee) in _TORCH_RANDOM
                and callee.count(".") == 1 and not _has_kw(node, "generator")):
            return callee, "a draw from the global random state"
    if (isinstance(node.func, ast.Attribute) and node.func.attr in _RANDOM_FILLS
            and not _has_kw(node, "generator")):
        return f".{node.func.attr}", "a draw from the global random state"
    return None


def check_jit_purity(unit: FileUnit, ctx: Context) -> List[Finding]:
    findings: List[Finding] = []
    seen = set()
    for fn, _statics, _direct in device_reachable(unit.tree):
        fname = getattr(fn, "name", "<lambda>")
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            hit = _impurity(node)
            if hit is None:
                continue
            callee, why = hit
            key = (fname, callee, node.lineno)
            if key in seen:
                continue
            seen.add(key)
            findings.append(Finding(
                "jit-purity", unit.path, node.lineno,
                f"{fname}() runs in a device program (a hand-kernel wrapper, "
                f"its plain version or a run_guarded primary) but calls "
                f"{callee} ({why}): a device program is a pure function of "
                f"its tensor arguments"))
    return findings


# -- explicit-dtype ----------------------------------------------------------

# numpy constructor -> index of the positional dtype slot
_NP_CTORS = {"zeros": 1, "ones": 1, "empty": 1, "full": 2, "array": 1,
             "arange": 3}
_NP_MODULES = {"np", "numpy"}
# torch constructors: dtype is keyword-only
_TORCH_CTORS = frozenset(("tensor", "zeros", "ones", "empty", "full", "arange"))


def check_explicit_dtype(unit: FileUnit, ctx: Context) -> List[Finding]:
    if not ctx.wants_dtype(unit.path):
        return []
    findings: List[Finding] = []
    for node in ast.walk(unit.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        mod = dotted(node.func.value)
        ctor = node.func.attr
        if _has_kw(node, "dtype"):
            continue
        if mod == "torch" and ctor in _TORCH_CTORS:
            pass
        elif mod in _NP_MODULES and ctor in _NP_CTORS:
            if len(node.args) > _NP_CTORS[ctor]:
                continue  # dtype passed positionally
        else:
            continue
        findings.append(Finding(
            "explicit-dtype", unit.path, node.lineno,
            f"{mod}.{ctor}(...) without an explicit dtype= in a "
            f"bit-exactness module (a default dtype is a setting, not a "
            f"contract)"))
    return findings


EXPLAIN = {
    "jit-purity": {
        "why": (
            "The port's device programs (hand-kernel wrappers, their plain "
            "versions, the primaries passed to run_guarded, and what they "
            "call in the file) must be pure functions of their tensor "
            "arguments: the kernel and its plain version are held bit for "
            "bit against each other and the census counts one run as the "
            "stage's fingerprint.  A clock read, a global random draw, a "
            "lock, a socket or a file there makes two runs differ or ties "
            "the program to host state."),
        "bad": ("def place_plain(frags, keys, out_words: int):\n"
                "    noise = torch.rand(frags.shape)   # global random state\n"
                "    return frags + noise\n"),
        "good": ("def place_plain(frags, keys, out_words: int, gen):\n"
                 "    noise = torch.rand(frags.shape, generator=gen)\n"
                 "    return frags + noise\n"),
    },
    "explicit-dtype": {
        "why": (
            "The M3TSZ and arena contracts are defined over int64/uint64/"
            "float64 BIT PATTERNS.  torch.tensor(1.5) is float32 and "
            "torch.full(n, 0.0) follows the default dtype: a width picked "
            "by a default is a bit-exactness bug waiting for a changed "
            "default.  as_tensor, asarray and *_like keep their input's "
            "dtype and are exempt."),
        "bad": "a = torch.zeros(n)                  # width decided by a default\n",
        "good": "a = torch.zeros(n, dtype=torch.int64)  # width decided by the code\n",
    },
}
