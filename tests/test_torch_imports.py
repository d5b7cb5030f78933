"""m3_tpu_torch stands alone: it imports neither JAX nor anything of
m3_tpu, so it runs where JAX is not installed."""

import ast
import pathlib
import re
import subprocess
import sys

import pytest

PKG = pathlib.Path(__file__).resolve().parent.parent / "m3_tpu_torch"
REF = PKG.parent / "m3_tpu"

# the reference's modules the port carries under another name: the codec
# scans (each scan a kernel of its own), the three Pallas kernel files (each a wrapper module beside its
# hand-written kernels), the IR text classifier (the port has no XLA text:
# it classes aten dispatch records), the TPU bisector (card against CPU)
# and the jax lint family
RENAMED = {
    "encoding/m3tsz_jax.py": ["encoding/m3tsz_torch.py", "parallel/decode_scan.py",
                              "csrc/decode_scan.cu", "parallel/encode_scan.py",
                              "csrc/encode_scan.cu"],
    "parallel/pallas_encode.py": ["parallel/encode_place.py", "csrc/place_words.cu"],
    "parallel/pallas_decode.py": ["parallel/decode_gather.py", "csrc/extract_fields.cu"],
    "parallel/pallas_ingest.py": ["parallel/segment_ingest.py", "csrc/segment_ingest.cu",
                                  "csrc/segment_minmax.cu"],
    "x/hlotext.py": ["x/optext.py"],
    "tools/tpu_bisect.py": ["tools/card_bisect.py"],
    "x/lint/jaxlint.py": ["x/lint/torchlint.py"],
}


def _modules():
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_every_module_imports_with_jax_blocked():
    mods = list(_modules())
    assert "m3_tpu_torch.encoding.m3tsz_torch" in mods
    assert "m3_tpu_torch.aggregator.engine" in mods
    # the node: config, instruments, substrate, mediator, front door
    for m in ("core.config", "instrument", "instrument.procstats", "x",
              "x.admission", "x.breaker", "x.diskbudget", "x.retry",
              "storage.mediator", "storage.scrub", "server.snappy",
              "server.prom_remote", "server.influx", "server.http_api",
              "server.assembly", "server.node_main",
              # the aggregator tier: wire, ingest, client, placements, bus
              "msg.protocol", "msg.bus", "msg.transport", "server.ingest_tcp",
              "client.aggregator_client", "cluster.placement",
              "cluster.placement_mirrored", "collector.reporter", "tools.hops",
              # the mesh: topology, replicas, the sharded step, codec and query
              "parallel", "parallel.mesh", "parallel.replication", "parallel.sharded_agg",
              "parallel.sharded_encode", "parallel.sharded_decode",
              "parallel.sharded_query",
              # the replicated storage cluster: RPC, session, KV service,
              # topology, namespaces, runtime options, repair, migration, admin
              "server.rpc", "client", "client.session", "cluster.kv_remote",
              "cluster.topology", "cluster.namespace_registry",
              "core.runtime_options", "storage.repair", "storage.migration",
              "server.admin_api",
              # the device boundary and the control plane
              "x.devguard", "x.membudget", "instrument.exposition",
              "query.slo", "instrument.selfmon", "instrument.debug",
              "x.controller", "x.chaos", "ctl", "ctl.r2",
              # query federation and the Graphite front door
              "metrics.carbon", "query.graphite", "query.fanout", "query.remote",
              # the proto value codec and the runtime instruments
              "encoding.proto_codec", "encoding.proto_schema", "x.lockcheck",
              "x.devseams", "x.hopwatch", "x.tracewatch",
              # the measuring tools
              "x.optext", "x.costwatch", "tools.costs", "tools.decode_profile",
              "tools.card_bisect", "native.aggproxy", "comparator",
              "comparator.naive_promql", "comparator.harness",
              # the static and IR gates
              "x.lint", "x.lint.core", "x.lint.locks", "x.lint.wirecheck",
              "x.lint.faultcov", "x.lint.resources", "x.lint.corruption",
              "x.lint.placement", "x.lint.deadline_aware", "x.lint.metrics_rule",
              "x.lint.actuator_rule", "x.lint.capacity_rule", "x.lint.purity",
              "x.lint.torchlint", "x.lint.devguard_rule", "x.lint.registry_rule",
              "x.irlint",
              # the ops CLI and the distributed tests
              "tools.cli", "dtest", "dtest.harness", "dtest.agent", "dtest.soak",
              # the host codec
              "native"):
        assert f"m3_tpu_torch.{m}" in mods, m
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['m3_tpu'] = None\n"
            f"sys.path.insert(0, {str(PKG.parent)!r})\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith('jax.') or k == 'm3_tpu'"
            " or k.startswith('m3_tpu.') for k, v in sys.modules.items()"
            " if v is not None)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_sources_name_no_jax_or_reference_package():
    bad = re.compile(r"^\s*(import|from)\s+(jax\b|m3_tpu\b(?!_torch))", re.M)
    for p in list(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py"]:
        assert not bad.search(p.read_text()), p


def test_every_reference_module_has_its_counterpart():
    """Every module of ``m3_tpu/`` has a file at the same path in
    ``m3_tpu_torch/``, or its listed rename: the port does all that the
    JAX package does."""
    missing = []
    for p in sorted(REF.rglob("*.py")):
        rel = p.relative_to(REF).as_posix()
        want = RENAMED.get(rel, [rel])
        missing += [f"{rel} -> {w}" for w in want if not (PKG / w).is_file()]
    assert not missing, missing
    # a rename whose reference module is gone would hide a stale entry
    assert all((REF / rel).is_file() for rel in RENAMED)
    assert not any((PKG / rel).exists() for rel in RENAMED)


# -- the public surface, name by name ---------------------------------------

_JAX = "JAX/XLA/Pallas machinery the port has no counterpart of"
_DTYPE = "a jnp dtype alias; the port carries u64 on int64 (m3_tpu_torch._bits)"
_TILE = "a Pallas tile constant; the CUDA kernel picks its own grid"
_INTERPRET = ("Pallas interpret-mode routing; the port's wrapper routes by the "
              "tensor's device instead")
_ENV = "an env seam; the port reads no environment (ROADMAP Queue C)"
_FALLBACK = "a fallback step-down; the port's stages have no fallback (ROADMAP Queue C)"
_U32 = "the u32 extraction form; kernel #2 takes u64 words (decode_gather.extract_fields64_t)"
_EMUL = ("an f64 emulation helper off the port's path: the port converts int to "
         "float with the card's own f64 (card_bisect stage 5) and needs only "
         "split, mul_pow10 and floor_parts")
_HLO = "XLA/StableHLO text; the port classes aten dispatch records (x/optext.py)"
_COMPILED = "a compile fingerprint; the port counts eager dispatches (x/costwatch.py)"
_RETRACE = "a retrace budget; the port has no jit (ROADMAP Queue C)"

# (reference module, name) -> why the port has no counterpart of that name
NOT_PORTED = {
    **{("aggregator/arena.py", n): _ENV for n in (
        "INGEST_IMPLS", "arena_layout", "ingest_impl", "resolved_arena_layout",
        "resolved_ingest_impl", "set_arena_layout", "set_ingest_impl")},
    ("aggregator/arena.py", "raw"): _JAX + ": jit plumbing",
    ("aggregator/arena.py", "register_ingest_consumer"): _JAX + ": jit plumbing",
    ("encoding/f64_emul.py", "I64"): _DTYPE,
    ("encoding/f64_emul.py", "U64"): _DTYPE,
    ("encoding/f64_emul.py", "POW10_U64"): "the port's POW10 (int64 carriers)",
    **{("encoding/f64_emul.py", n): _EMUL for n in (
        "abs_bits", "int_div_pow10", "is_nan", "mul10", "neg_bits",
        "uint_to_f64_bits")},
    ("encoding/m3tsz_jax.py", "MASK64"): _DTYPE,
    ("encoding/m3tsz_jax.py", "U64"): _DTYPE,
    ("encoding/m3tsz_jax.py", "fallback_chains"): _FALLBACK,
    ("encoding/m3tsz_jax.py", "fallback_place"): _FALLBACK,
    ("encoding/m3tsz_jax.py", "resolved_place"): (
        _ENV + "; the port has one placement, kernel #1"),
    ("parallel/mesh.py", "MeshTopology.replicated"): _JAX + ": a NamedSharding",
    ("parallel/mesh.py", "MeshTopology.sharded"): _JAX + ": a NamedSharding",
    ("parallel/mesh.py", "enable_cpu_core_devices"): _JAX + ": an XLA host-device flag",
    ("parallel/mesh.py", "shard_map_compat"): _JAX + ": shard_map",
    **{("parallel/pallas_decode.py", n): _DTYPE for n in ("I32", "U32", "U64")},
    **{("parallel/pallas_decode.py", n): _TILE for n in ("PT", "WT")},
    ("parallel/pallas_decode.py", "HAVE_PALLAS"): _JAX,
    ("parallel/pallas_decode.py", "auto_interpret"): _INTERPRET,
    ("parallel/pallas_decode.py", "configured_impl"): _ENV,
    ("parallel/pallas_decode.py", "resolved_impl"): _ENV,
    ("parallel/pallas_decode.py", "extract_fields"): _U32,
    ("parallel/pallas_decode.py", "extract_fields_t"): _U32,
    **{("parallel/pallas_encode.py", n): _DTYPE for n in ("I32", "U32", "U64")},
    **{("parallel/pallas_encode.py", n): _TILE for n in ("FT", "WT")},
    ("parallel/pallas_encode.py", "HAVE_PALLAS"): _JAX,
    ("parallel/pallas_encode.py", "auto_interpret"): _INTERPRET,
    ("parallel/pallas_encode.py", "place_words_jnp"): (
        "the jnp plain version; the port's is place_words_plain"),
    **{("parallel/pallas_ingest.py", n): _TILE for n in ("SLAB", "TILE")},
    ("parallel/pallas_ingest.py", "HAVE_PALLAS"): _JAX,
    ("parallel/pallas_ingest.py", "auto_interpret"): _INTERPRET,
    ("tools/cli.py", "tpu_backlog"): (
        "drives the JAX system's bench.py over a TPU relay (ROADMAP Queue C)"),
    ("tools/decode_profile.py", "U64"): _DTYPE,
    ("x/controller.py", "devguard_fallback_actuator"): _FALLBACK,
    **{("x/costwatch.py", n): _COMPILED for n in (
        "CompiledStage", "compiled_stage", "compiled_stages", "count_jaxpr_ops",
        "fingerprint_compiled", "fingerprint_lowered", "hlo_op_histogram")},
    ("x/devguard.py", "fallback_forced"): _FALLBACK,
    ("x/devguard.py", "force_fallback"): _FALLBACK,
    ("x/fault.py", "arm_from_env"): _ENV,
    **{("x/hlotext.py", n): _HLO for n in (
        "HLO_INSTR_RE", "HLO_SHAPE_RE", "STABLEHLO_TENSOR_RE",
        "custom_call_targets", "folded_constants", "shape_elements",
        "stablehlo_custom_call_targets", "stablehlo_op_count",
        "stablehlo_type_census")},
    ("x/irlint.py", "CONST_BLOAT_MIN_ELEMENTS"): (
        _HLO + "; the port's bound is costwatch.CONSTANT_BYTES"),
    ("x/irlint.py", "DEVICE_DIRECTIVE_TARGETS"): _HLO + ": custom-call targets",
    ("x/irlint.py", "ProgramIR"): (
        "lowered IR texts; the port lints a counted run, irlint.Program"),
    ("x/irlint.py", "program_ir"): (
        "lowers and compiles a jit; the port's counterpart is irlint.program"),
    ("x/irlint.py", "Seam"): (
        "a seam with a compile probe; the port's SEAMS are (name, producer, "
        "consumer) tuples measured from a recorded ledger pass"),
    ("x/lint/core.py", "Context.wants_jax"): (
        _JAX + "; the port's Context has torch_prefixes"),
    ("x/lint/purity.py", "jit_reachable"): _JAX + ": jit reachability",
    ("x/lint/purity.py", "jit_static_params"): _JAX + ": jit static arguments",
    ("x/tracewatch.py", "DEFAULT_BUDGET"): _RETRACE,
    ("x/tracewatch.py", "retrace_budget"): _RETRACE,
    ("x/tracewatch.py", "set_budget"): _RETRACE,
}


def _defined(node, out, with_imports):
    """Add the public names one top-level statement binds to ``out``."""
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        if not node.name.startswith("_"):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out.update(f"{node.name}.{m.name}" for m in node.body
                           if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                           and not m.name.startswith("_"))
    elif isinstance(node, (ast.Assign, ast.AnnAssign)):
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        out.update(n.id for t in targets for n in ast.walk(t)
                   if isinstance(n, ast.Name) and not n.id.startswith("_"))
    elif isinstance(node, (ast.Import, ast.ImportFrom)):
        if with_imports:  # a re-export is the port's name too
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    elif isinstance(node, (ast.If, ast.Try)):
        for body in (node.body, node.orelse, getattr(node, "finalbody", []),
                     *(h.body for h in getattr(node, "handlers", []))):
            for sub in body:
                _defined(sub, out, with_imports)


def _public(path: pathlib.Path, with_imports: bool) -> set:
    out: set = set()
    for node in ast.parse(path.read_text()).body:
        _defined(node, out, with_imports)
    return out


def _counterpart(rel: str) -> pathlib.Path:
    return PKG / RENAMED.get(rel, [rel])[0]


REF_MODULES = sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py"))


@pytest.mark.parametrize("rel", REF_MODULES)
def test_every_public_name_has_its_counterpart(rel):
    """Every public top-level name and public method a reference module
    defines exists in its counterpart, or stands in ``NOT_PORTED`` with
    its reason.  The check walks the source and imports nothing."""
    ref = _public(REF / rel, with_imports=False)
    ours = _public(_counterpart(rel), with_imports=True)
    excluded = {n for (m, n) in NOT_PORTED if m == rel}
    assert sorted(ref - ours - excluded) == []
    # an exclusion the port has since gained, or the reference lost, is stale
    assert sorted(excluded - (ref - ours)) == []


def test_every_exclusion_names_a_reference_module_and_a_reason():
    assert {m for (m, _) in NOT_PORTED} <= set(REF_MODULES)
    assert all(isinstance(r, str) and r for r in NOT_PORTED.values())
