"""Rule families 10-13 — host syncs, transfers, dtype seams and table
uploads in the port's device programs.  The counterpart of
``m3_tpu/x/lint/jaxlint.py``, renamed because the port has no jit: the
families keep the reference's names where the contract is the same, and
are restated for eager torch on a card, where a host read is a sync
and a table is uploaded by whoever converts it.

Reachability is ``purity.device_reachable`` (the hand-kernel wrappers,
their plain versions, the primaries passed to ``run_guarded``, and
whatever they call in the file, through ``functools.partial`` too).

* ``retrace-risk`` — the reference's trace-time hazards become host
  syncs: Python ``if``/``while`` on a tensor argument of a device
  program (a direct seed's parameters that are not annotated
  ``int``/``bool``/``str``/``float`` nor default to a constant), and
  ``int()``/``bool()``/``float()`` of such an argument or of a tensor
  reduction, and ``.item()``, anywhere in a device program: each is a
  device->host read that stalls the stream every call.  And any
  environment read (``os.environ``, ``os.getenv``) anywhere in the
  package: the port has no env seams, so a setting is an argument or a
  config field, never the environment.
* ``transfer-hygiene`` — ``.cpu()``/``.numpy()``/``.tolist()``/
  ``print`` in a device program; ``.cpu()``/``.numpy()`` anywhere in a
  device module outside the declared host boundary (device modules
  return tensors; the boundary owns the copy); and timed regions
  (functions pairing ``time.perf_counter()`` around torch work or a
  hand-kernel call) in the
  timed modules with no ``torch.cuda.synchronize``, ``.synchronize()``
  or CUDA event: the card runs asynchronously, so such a region times
  the launch, not the work.
* ``dtype-stability`` — in the bit-exactness modules: same-kind
  narrowing round trips (``.to(torch.int32).to(torch.int64)``,
  ``.int().long()``), narrowing shorthand casts (``.float()``, ``.int()``,
  ``.half()``, ``.short()``, ``.char()``, ``.bfloat16()``), a Python
  literal made a tensor without ``dtype=`` (``torch.tensor(1.5)`` is
  float32, torch's default), and float literals in bitwise or shift
  arithmetic.
* ``constant-bloat`` — a module-level numpy array of >= 4096 elements
  (sized by folding its constructor's shape, through one module
  function that makes it), or a name in ``Context.large_constants``, made a tensor
  (``torch.as_tensor``/``tensor``/``from_numpy``) inside a function that
  is not cached (``functools.lru_cache``/``cache``): on the card that is
  one upload of the table per call, the class the reference finds as a
  constant folded into every compilation.
"""

from __future__ import annotations

import ast
from typing import List

from m3_tpu_torch.x.lint.core import Context, FileUnit, Finding, dotted
from m3_tpu_torch.x.lint.purity import KERNEL_WRAPPERS, _last_attr, device_reachable

# -- shared helpers ----------------------------------------------------------

_STRUCTURAL_ATTRS = frozenset(("shape", "ndim", "dtype", "device", "is_cuda",
                               "is_meta", "layout", "requires_grad"))
_STRUCTURAL_CALLS = frozenset(("numel", "dim", "size", "stride", "element_size",
                               "is_contiguous", "nelement", "get_device"))
_REDUCTIONS = frozenset(("max", "min", "sum", "any", "all", "amax", "amin",
                         "prod", "mean", "count_nonzero", "argmax", "argmin",
                         "item", "nonzero"))


def _param_names(fn: ast.AST) -> set:
    args = getattr(fn, "args", None)
    if args is None:
        return set()
    out = {a.arg for a in list(args.posonlyargs) + list(args.args)
           + list(args.kwonlyargs)}
    if args.vararg:
        out.add(args.vararg.arg)
    if args.kwarg:
        out.add(args.kwarg.arg)
    return out


def _own_statements(fn: ast.AST):
    """Walk fn's body WITHOUT descending into nested function/lambda
    bodies (their parameters shadow)."""
    body = getattr(fn, "body", [])
    stack = list(body) if isinstance(body, list) else [body]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            stack.append(child)


def _tensor_names_in(test: ast.AST, dyn: set) -> set:
    """Tensor parameter names a test reads by value, excluding
    structural uses: ``x is None``, ``x.shape``/``.dtype``/``.device``
    reads and ``x.numel()``/``x.dim()``/``x.size()`` calls."""
    skip: set = set()
    for node in ast.walk(test):
        if isinstance(node, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            for side in [node.left] + list(node.comparators):
                if isinstance(side, ast.Name):
                    skip.add(id(side))
        elif (isinstance(node, ast.Attribute) and node.attr in _STRUCTURAL_ATTRS
              and isinstance(node.value, ast.Name)):
            skip.add(id(node.value))
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr in _STRUCTURAL_CALLS
              and isinstance(node.func.value, ast.Name)):
            skip.add(id(node.func.value))
    return {node.id for node in ast.walk(test)
            if isinstance(node, ast.Name) and node.id in dyn and id(node) not in skip}


def _reads_tensor(expr: ast.AST, dyn: set) -> bool:
    """Whether a coerced expression holds a tensor by the evidence a
    source shows: a tensor parameter read by value, a reduction method
    (``x.max()``, ``x.any()``) or a ``torch.*`` call."""
    if _tensor_names_in(expr, dyn):
        return True
    for node in ast.walk(expr):
        if isinstance(node, ast.Call):
            callee = dotted(node.func) or ""
            if callee.startswith("torch."):
                return True
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _REDUCTIONS):
                return True
    return False


# -- retrace-risk ------------------------------------------------------------

_COERCIONS = ("int", "bool", "float")
_ENV_CALLS = ("os.environ.get", "os.getenv", "os.environ.setdefault",
              "os.environ.pop", "os.environ.items", "os.environ.keys",
              "os.environ.copy")


def _env_reads(tree: ast.AST):
    """Line numbers of every environment read in a module."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and dotted(node.func) in _ENV_CALLS:
            yield node.lineno, dotted(node.func)
        elif (isinstance(node, ast.Subscript)
              and dotted(node.value) == "os.environ"):
            yield node.lineno, "os.environ[...]"
        elif isinstance(node, ast.Compare) and any(
                dotted(c) == "os.environ" for c in node.comparators):
            yield node.lineno, "... in os.environ"


def check_retrace(unit: FileUnit, ctx: Context) -> List[Finding]:
    findings: List[Finding] = []
    for line, what in sorted(set(_env_reads(unit.tree))):
        findings.append(Finding(
            "retrace-risk", unit.path, line,
            f"reads the environment ({what}): the port has no env seams — "
            f"take the setting as an argument or a config field"))

    for fn, statics, direct in device_reachable(unit.tree, include_partial_args=True):
        fname = getattr(fn, "name", "<lambda>")
        dyn = _param_names(fn) - statics if direct else set()
        if direct:
            for node in _own_statements(fn):
                if not isinstance(node, (ast.If, ast.While)):
                    continue
                hits = _tensor_names_in(node.test, dyn)
                if hits:
                    findings.append(Finding(
                        "retrace-risk", unit.path, node.lineno,
                        f"{fname}() branches on tensor argument(s) "
                        f"{sorted(hits)} in Python control flow: a device->host "
                        f"read (a sync) every call on the card; use "
                        f"torch.where, or take the decision as a non-tensor "
                        f"argument"))
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "item" and not node.args):
                findings.append(Finding(
                    "retrace-risk", unit.path, node.lineno,
                    f"{fname}() calls .item() in a device program: a "
                    f"device->host read (a sync) every call"))
                continue
            callee = dotted(node.func)
            if (callee in _COERCIONS and node.args
                    and _reads_tensor(node.args[0], dyn)):
                findings.append(Finding(
                    "retrace-risk", unit.path, node.lineno,
                    f"{fname}() coerces a tensor with {callee}() in a device "
                    f"program: a device->host read (a sync) every call"))
    return findings


# -- transfer-hygiene --------------------------------------------------------

_HOST_METHODS = ("cpu", "numpy", "tolist")
_SYNCS = ("torch.cuda.synchronize", "torch.cuda.Event", "torch.cuda.current_stream")


def _after_cpu(node: ast.Call) -> bool:
    """``x.cpu().numpy()``'s ``.numpy()``: one copy, reported once (at
    its ``.cpu()``)."""
    inner = node.func.value
    return (node.func.attr == "numpy" and isinstance(inner, ast.Call)
            and isinstance(inner.func, ast.Attribute) and inner.func.attr == "cpu")


def check_transfer(unit: FileUnit, ctx: Context) -> List[Finding]:
    findings: List[Finding] = []
    tree = unit.tree
    reached = device_reachable(tree, include_partial_args=True)
    reached_ids = set()
    for fn, _statics, _direct in reached:
        fname = getattr(fn, "name", "<lambda>")
        for node in ast.walk(fn):
            reached_ids.add(id(node))
            if not isinstance(node, ast.Call):
                continue
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _HOST_METHODS and not node.args):
                findings.append(Finding(
                    "transfer-hygiene", unit.path, node.lineno,
                    f"{fname}() calls .{node.func.attr}() in a device program: "
                    f"a device->host copy every call"))
            elif dotted(node.func) == "print":
                findings.append(Finding(
                    "transfer-hygiene", unit.path, node.lineno,
                    f"{fname}() calls print() in a device program: printing a "
                    f"tensor copies it to the host"))

    # device modules reach the host through the declared boundary
    if ctx.wants_torch(unit.path) and not ctx.is_host_boundary(unit.path):
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call) and id(node) not in reached_ids
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("cpu", "numpy") and not node.args
                    and not _after_cpu(node)):
                findings.append(Finding(
                    "transfer-hygiene", unit.path, node.lineno,
                    f".{node.func.attr}() in a device module outside the "
                    f"declared host boundary ({', '.join(ctx.host_boundary)}): "
                    f"device modules return tensors; the boundary owns the copy"))

    # timed regions must synchronize what they time
    if ctx.wants_timed(unit.path):
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            perf_lines, has_sync, has_torch = [], False, False
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Call):
                    continue
                callee = dotted(sub.func) or ""
                if callee == "time.perf_counter":
                    perf_lines.append(sub.lineno)
                    continue
                if callee in _SYNCS or callee.endswith(".synchronize") \
                        or callee.endswith("elapsed_time"):
                    has_sync = True
                if callee.startswith("torch.") or _last_attr(callee) in KERNEL_WRAPPERS:
                    has_torch = True
            if len(perf_lines) >= 2 and has_torch and not has_sync:
                findings.append(Finding(
                    "transfer-hygiene", unit.path, min(perf_lines),
                    f"{node.name}() times torch work between perf_counter() "
                    f"calls with no synchronize or CUDA event: the card runs "
                    f"asynchronously, so this measures the launch, not the "
                    f"work"))
    return findings


# -- dtype-stability ---------------------------------------------------------

# dtype token -> (kind, bit width): torch and numpy spellings and the
# port's module aliases (I32/I64/F32/F64)
_DTYPE_TOKENS = {}
for _k, _pfx in (("i", "int"), ("u", "uint"), ("f", "float")):
    for _w in (8, 16, 32, 64):
        _DTYPE_TOKENS[f"{_pfx}{_w}"] = (_k, _w)
for _alias, _tok in (("I32", ("i", 32)), ("I64", ("i", 64)), ("U32", ("u", 32)),
                     ("U64", ("u", 64)), ("F32", ("f", 32)), ("F64", ("f", 64)),
                     ("long", ("i", 64)), ("int", ("i", 32)), ("short", ("i", 16)),
                     ("double", ("f", 64)), ("float", ("f", 32)),
                     ("half", ("f", 16)), ("bfloat16", ("f", 16))):
    _DTYPE_TOKENS[_alias] = _tok
# shorthand cast methods -> the dtype they cast to
_SHORTHAND = {"long": ("i", 64), "int": ("i", 32), "short": ("i", 16),
              "char": ("i", 8), "double": ("f", 64), "float": ("f", 32),
              "half": ("f", 16), "bfloat16": ("f", 16)}
_NARROWING = ("int", "short", "char", "float", "half", "bfloat16")


def _dtype_of(node: ast.AST):
    d = dotted(node)
    if d is None:
        return None
    return _DTYPE_TOKENS.get(_last_attr(d)) or _DTYPE_TOKENS.get(d)


def _cast_target(call: ast.AST):
    """(kind, width) a cast call casts to: ``.to(<dtype>)``,
    ``.to(dtype=...)``, ``.type(<dtype>)``, or a shorthand method."""
    if not (isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute)):
        return None
    attr = call.func.attr
    if attr in _SHORTHAND and not call.args and not call.keywords:
        return _SHORTHAND[attr]
    if attr in ("to", "type"):
        for k in call.keywords:
            if k.arg == "dtype":
                return _dtype_of(k.value)
        for a in call.args:
            t = _dtype_of(a)
            if t is not None:
                return t
    return None


def _is_literal_scalar(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return isinstance(node.value, (int, float)) and not isinstance(node.value, bool)
    if isinstance(node, ast.UnaryOp):
        return _is_literal_scalar(node.operand)
    if isinstance(node, ast.BinOp):
        return _is_literal_scalar(node.left) and _is_literal_scalar(node.right)
    return False


def check_dtype_stability(unit: FileUnit, ctx: Context) -> List[Finding]:
    if not ctx.wants_dtype(unit.path):
        return []
    findings: List[Finding] = []
    for node in ast.walk(unit.tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            outer = _cast_target(node)
            inner = _cast_target(node.func.value)
            attr = node.func.attr
            if (outer is not None and inner is not None
                    and inner[0] == outer[0] and inner[1] < outer[1]):
                findings.append(Finding(
                    "dtype-stability", unit.path, node.lineno,
                    f"cast round trip narrows to {inner[0]}{inner[1]} then "
                    f"widens to {outer[0]}{outer[1]}: the high bits are "
                    f"already gone — cast once to the wide type"))
            elif attr in _NARROWING and not node.args and not node.keywords:
                k, w = _SHORTHAND[attr]
                findings.append(Finding(
                    "dtype-stability", unit.path, node.lineno,
                    f"narrowing shorthand cast .{attr}() (to {k}{w}) in a "
                    f"bit-exactness module: cast with .to(<dtype>) where "
                    f"narrowing is the contract"))
            mod = dotted(node.func.value)
            if (mod == "torch" and attr in ("tensor", "as_tensor", "scalar_tensor")
                    and node.args and _is_literal_scalar(node.args[0])
                    and not any(k.arg == "dtype" for k in node.keywords)):
                findings.append(Finding(
                    "dtype-stability", unit.path, node.lineno,
                    f"torch.{attr}(<literal>) without dtype= in a bit-exactness "
                    f"module: the width is torch's default (float32 for a "
                    f"Python float), not the code's"))
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.LShift, ast.RShift, ast.BitAnd, ast.BitOr,
                          ast.BitXor)):
            for side in (node.left, node.right):
                if isinstance(side, ast.Constant) and isinstance(side.value, float):
                    findings.append(Finding(
                        "dtype-stability", unit.path, node.lineno,
                        "float literal in bitwise/shift arithmetic: the word "
                        "and lane paths are integer by contract"))
    return findings


# -- constant-bloat ----------------------------------------------------------

_BLOAT_ELEMENTS = 4096
_NP_CTORS = ("zeros", "ones", "empty", "full", "arange")
_TO_TENSOR = ("torch.as_tensor", "torch.tensor", "torch.from_numpy")
_CACHES = ("functools.lru_cache", "lru_cache", "functools.cache", "cache")


def _const_int(node: ast.AST):
    """Constant folding of int expressions (literals, +-*//, <<, **)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = _const_int(node.operand)
        return -v if v is not None else None
    if isinstance(node, ast.BinOp):
        a, b = _const_int(node.left), _const_int(node.right)
        if a is None or b is None:
            return None
        try:
            if isinstance(node.op, ast.Add):
                return a + b
            if isinstance(node.op, ast.Sub):
                return a - b
            if isinstance(node.op, ast.Mult):
                return a * b
            if isinstance(node.op, ast.FloorDiv):
                return a // b if b else None
            if isinstance(node.op, ast.LShift):
                return a << b if 0 <= b < 64 else None
            if isinstance(node.op, ast.Pow):
                return a ** b if 0 <= b < 64 else None
        except (OverflowError, ValueError):
            return None
    return None


def _ctor_elements(call: ast.Call):
    fn = dotted(call.func)
    if fn is None or _last_attr(fn) not in _NP_CTORS:
        return None
    if not fn.startswith(("np.", "numpy.")) or not call.args:
        return None
    shape = call.args[0]
    dims = shape.elts if isinstance(shape, (ast.Tuple, ast.List)) else [shape]
    total = 1
    for d in dims:
        v = _const_int(d)
        if v is None:
            return None
        total *= max(v, 0)
    return total


def _large_module_arrays(tree: ast.AST) -> dict:
    """{name: estimated elements} for module-level assignments whose RHS
    is (or makes, through one module function) a numpy array of
    >= _BLOAT_ELEMENTS elements."""
    makers: dict = {}
    for node in getattr(tree, "body", []):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            worst = 0
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    worst = max(worst, _ctor_elements(sub) or 0)
            makers[node.name] = worst
    out: dict = {}
    for node in getattr(tree, "body", []):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Call)):
            continue
        est = _ctor_elements(node.value)
        if est is None:
            est = makers.get(dotted(node.value.func))
        if est is not None and est >= _BLOAT_ELEMENTS:
            out[node.targets[0].id] = est
    return out


def _cached(fn: ast.AST) -> bool:
    for d in getattr(fn, "decorator_list", []):
        target = d.func if isinstance(d, ast.Call) else d
        if dotted(target) in _CACHES:
            return True
    return False


def check_constant_bloat(unit: FileUnit, ctx: Context) -> List[Finding]:
    tree = unit.tree
    large = _large_module_arrays(tree)
    known = set(ctx.large_constants)
    if not large and not known:
        return []
    findings: List[Finding] = []
    funcs = [n for n in ast.walk(tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    enclosing: dict = {}
    for fn in funcs:  # innermost def wins (ast.walk is breadth-first)
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                enclosing[id(node)] = fn
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and dotted(node.func) in _TO_TENSOR
                and node.args):
            continue
        fn = enclosing.get(id(node))
        if fn is None or _cached(fn):
            continue  # module level or cached: once per process (or device)
        for sub in ast.walk(node.args[0]):
            name = est = None
            if isinstance(sub, ast.Name) and sub.id in large:
                name, est = sub.id, large[sub.id]
            elif isinstance(sub, ast.Name) and sub.id in known:
                name = sub.id
            elif isinstance(sub, ast.Attribute) and sub.attr in known:
                name = sub.attr
            if name is None:
                continue
            size = f"~{est} elements" if est else "a registered large table"
            findings.append(Finding(
                "constant-bloat", unit.path, node.lineno,
                f"{fn.name}() makes module-level array {name} ({size}) a tensor "
                f"every call: on the card one upload of the table per call — "
                f"make it once (a cached function per device) and pass it as an argument"))
            break
    return findings


# -- rationale + examples ----------------------------------------------------

EXPLAIN = {
    "retrace-risk": {
        "why": (
            "The reference's trace-time hazards are host syncs in eager "
            "torch: Python control flow on a tensor, int()/bool()/float() "
            "of one, and .item() each read the card's result back and "
            "stall its stream, every call.  And the reference's trace-"
            "frozen env seams have no counterpart: the port reads no "
            "environment at all, so a setting is an argument or a config "
            "field (x/tracewatch counts what slips through at run time)."),
        "bad": ("def segment_plain(slots, values, capacity: int):\n"
                "    if values.isnan().any():     # a sync every call\n"
                "        values = values.nan_to_num()\n"
                "    return values\n"),
        "good": ("def segment_plain(slots, values, capacity: int):\n"
                 "    return torch.where(values.isnan(), 0.0, values)\n"),
    },
    "transfer-hygiene": {
        "why": (
            ".cpu()/.numpy()/.tolist() in a device program copies to the "
            "host every call; device modules return tensors and the "
            "declared host boundary owns the copy.  A perf_counter pair "
            "around card work with no synchronize or CUDA event times the "
            "launch: the card runs asynchronously.  Runtime twin: "
            "tracewatch.no_transfers() raises on a copy inside a guarded "
            "region."),
        "bad": ("def time_place(frags, keys, w):\n"
                "    t0 = time.perf_counter()\n"
                "    place_words(frags, keys, w)   # enqueued, not done\n"
                "    return time.perf_counter() - t0\n"),
        "good": ("def time_place(frags, keys, w):\n"
                 "    t0 = time.perf_counter()\n"
                 "    place_words(frags, keys, w)\n"
                 "    torch.cuda.synchronize()\n"
                 "    return time.perf_counter() - t0\n"),
    },
    "dtype-stability": {
        "why": (
            "The codec and arena contracts are exact 64-bit patterns.  "
            "torch.tensor(1.5) is float32 by default, .int()/.float() "
            "narrow silently to 32 bits, a narrowing round trip hides the "
            "bits it destroyed, and a float literal in word arithmetic "
            "promotes an integer lane: each corrupts a lane without a test "
            "failing until a value needs the bits."),
        "bad": ("x = torch.tensor(1.5)                  # float32\n"
                "y = v.to(torch.int32).to(torch.int64)  # bits gone\n"),
        "good": ("x = torch.tensor(1.5, dtype=torch.float64)\n"
                 "y = v.to(torch.int64)\n"),
    },
    "constant-bloat": {
        "why": (
            "A large host table made a tensor inside a per-call function "
            "is uploaded to the card every call (the reference's constant "
            "folded into every compilation).  Make it once, in a cached "
            "function per device, and hand it in as an argument; the census "
            "then counts it in the stage's argument bytes, not as a "
            "per-call upload."),
        "bad": ("TBL = np.arange(1 << 18)\n"
                "def lookup(i):\n"
                "    return torch.as_tensor(TBL, device=i.device)[i]  # per call\n"),
        "good": ("@functools.lru_cache(maxsize=None)\n"
                 "def table(dev):\n"
                 "    return torch.as_tensor(TBL, device=dev)\n"
                 "def lookup(tbl, i):\n"
                 "    return tbl[i]\n"),
    },
}
